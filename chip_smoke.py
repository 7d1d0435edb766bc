"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each printing its own line and each fatal on failure:

1. env      torch / CUDA versions, the card's name and power limit, TF32 off.
2. build    nvcc builds the port's kernels (src/repro_torch/kernels/csrc).
3. kernels  K1 (streaming assign) and K2 (batch x center dots) against their
            plain torch versions on the card, at the main-path shape and at
            ragged shapes for gaussian / linear / polynomial, plus a
            zero-coefficient padding case; timed with CUDA events beside
            the plain version, the composed torch chain and the f32 bound.
4. fit      KernelKMeans on the mnist-like proxy (n=70000, d=784, k=10,
            b=4096, tau=200), which must run through K1 twice per step.
5. step     one fitted state and batch through the fused step (K1), the
            composed step with use_pallas (K2) and the plain composed step.
6. serve    predict / transform / score, save + load + predict, partial_fit.

Prints the kernels' JSON line, then, as its last line,
{"ok": true, "device": {...}}.  Exits nonzero, printing no result, when
CUDA is unavailable or any phase fails.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

# the card's published peaks (NVIDIA H100 SXM data sheet): f32 outside the
# tensor cores, and HBM bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
TOL = 2e-5


def phase(name, **kv):
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def require(cond, msg):
    if not cond:
        fail(msg)


def time_ms(fn, runs=25, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def bound_ms(b, k, w, d, out_bytes):
    """The least time for one pass: 2*b*k*W*(d+1) f32 operations (cross
    products + coefficient contraction) over the f32 peak, or each input
    byte read once and each output byte written once over HBM bandwidth,
    whichever is larger."""
    ops = 2.0 * b * k * w * (d + 1)
    nbytes = 4.0 * (b * d + k * w * d + k * w + k + b) + out_bytes
    t_ops, t_bytes = ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), \
        ("operations" if t_ops >= t_bytes else "bytes")


def kernel_inputs(x, b, k, w, seed, kern):
    """A realistic K1/K2 input: batch rows and support windows drawn from
    the data, positive coefficients summing to 1 per center, exact
    center norms."""
    import torch

    from repro_torch.core.kernel_fns import diag_of
    from repro_torch.kernels.fused_step import streamed_sqnorm

    g = torch.Generator().manual_seed(seed)
    n = x.shape[0]
    bidx = torch.randint(0, n, (b,), generator=g).to(x.device)
    idx = torch.randint(0, n, (k, w), generator=g).to(x.device)
    coef = torch.rand((k, w), generator=g).to(x.device)
    coef = coef / coef.sum(dim=1, keepdim=True)
    xb = x[bidx].contiguous()
    sup = x[idx.reshape(-1)].reshape(k, w, -1).contiguous()
    sqnorm = streamed_sqnorm(kern, x, idx, coef)
    return xb, sup, coef, sqnorm, diag_of(kern, xb)


def check_kernels(kern, xb, sup, coef, sqnorm, diag_b, label):
    """K1 and K2 against their plain versions on the same inputs; returns
    the max abs errors."""
    import torch

    from repro_torch.kernels import fused_assign, fused_step, ref

    k, w, d = sup.shape
    params = _params(kern)
    best, assign = fused_step.streaming_assign_cuda(
        xb, sup, coef, sqnorm, diag_b, **params)
    p = fused_assign.fused_batch_center_dots_cuda(xb, sup, coef, **params)
    torch.cuda.synchronize()
    best_ref, assign_ref = ref.streaming_assign_ref(
        kern, xb, sup.reshape(k * w, d), coef, sqnorm, diag_b)
    p_ref = ref.batch_center_dots(kern, xb, sup, coef)
    torch.cuda.synchronize()
    require(torch.isfinite(best).all() and torch.isfinite(p).all(),
            f"{label}: non-finite kernel output")
    require(torch.allclose(best, best_ref, rtol=TOL, atol=TOL),
            f"{label}: K1 distances off by "
            f"{(best - best_ref).abs().max().item():.3e}")
    require(torch.allclose(p, p_ref, rtol=TOL, atol=TOL),
            f"{label}: K2 dots off by {(p - p_ref).abs().max().item():.3e}")
    agree = (assign == assign_ref).float().mean().item()
    require(agree >= 0.99, f"{label}: K1 argmin agreement {agree:.4f}")
    dists = diag_b[:, None] - 2.0 * p_ref + sqnorm[None, :]
    top2 = torch.topk(dists, min(2, k), dim=1, largest=False).values
    bad = assign != assign_ref
    if bad.any():
        gap = (top2[bad, -1] - top2[bad, 0]).abs()
        lim = TOL + TOL * top2[bad, 0].abs()
        require(bool((gap <= lim).all()),
                f"{label}: K1 argmin differs at a row with a clear best")
    err1 = (best - best_ref).abs().max().item()
    err2 = (p - p_ref).abs().max().item()
    phase("kernels", case=label, k1_max_abs_err=f"{err1:.3e}",
          k2_max_abs_err=f"{err2:.3e}", argmin_agree=f"{agree:.5f}")
    return err1, err2


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a "
             "CUDA card")
    from repro_torch.api import KernelKMeans, SolverConfig
    from repro_torch.api import keys as api_keys
    from repro_torch.core.kernel_fns import (
        Gaussian, Linear, Polynomial, kernel_cross, median_sq_dist_heuristic,
    )
    from repro_torch.core.metrics import adjusted_rand_index
    from repro_torch.core.minibatch import make_step, sample_batch
    from repro_torch.data import make_dataset
    from repro_torch.kernels import _build, fused_assign, fused_step, ref
    from repro_torch.kernels.fused_step import streamed_sqnorm

    # ---- 1. env --------------------------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    require(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmul is on")
    require(not torch.backends.cudnn.allow_tf32, "TF32 cuDNN is on")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    phase("env", torch=torch.__version__, cuda=torch.version.cuda,
          device=repr(torch.cuda.get_device_name(0)),
          count=torch.cuda.device_count(), tf32="off")

    # ---- 2. build ------------------------------------------------------
    t0 = time.perf_counter()
    _build.lib()
    phase("build", seconds=f"{time.perf_counter() - t0:.1f}",
          nvcc_seconds=f"{_build.BUILD_INFO['seconds']:.1f}",
          library=os.path.basename(_build.BUILD_INFO["path"]))
    for line in _build.BUILD_INFO["log"].splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip(), flush=True)

    # ---- 3. kernels ----------------------------------------------------
    x_np, y_np = make_dataset("mnist-like", seed=0)
    x = torch.as_tensor(x_np, device=dev)
    kappa = float(median_sq_dist_heuristic(x))
    gauss = Gaussian(kappa=kappa)
    b, k, tau = 4096, 10, 200
    w = b + tau
    d = x.shape[1]
    xb, sup, coef, sqnorm, diag_b = kernel_inputs(x, b, k, w, 1, gauss)
    err1, err2 = check_kernels(gauss, xb, sup, coef, sqnorm, diag_b,
                               "main/gaussian")
    g = torch.Generator().manual_seed(3)
    for kname, kern in (("gaussian", Gaussian(kappa=7.0)),
                        ("linear", Linear()),
                        ("polynomial", Polynomial(bias=1.0, scale=33.0,
                                                  degree=2))):
        xr = torch.randn((500, 33), generator=g).to(dev)
        ins = kernel_inputs(xr, 100, 7, 45, 4, kern)
        check_kernels(kern, *ins, f"ragged/{kname}")
        # zero-coefficient padding: 19 extra slots of real rows, coef 0
        rxb, rsup, rcoef, rsq, rdiag = ins
        psup = torch.cat([rsup, rsup[:, :19]], dim=1).contiguous()
        pcoef = torch.cat([rcoef, torch.zeros_like(rcoef[:, :19])],
                          dim=1).contiguous()
        pb, pa = fused_step.streaming_assign_cuda(
            rxb, psup, pcoef, rsq, rdiag, **_params(kern))
        ub, ua = fused_step.streaming_assign_cuda(
            rxb, rsup, rcoef, rsq, rdiag, **_params(kern))
        pp = fused_assign.fused_batch_center_dots_cuda(rxb, psup, pcoef,
                                                       **_params(kern))
        up = fused_assign.fused_batch_center_dots_cuda(rxb, rsup, rcoef,
                                                       **_params(kern))
        torch.cuda.synchronize()
        require(torch.allclose(pb, ub, rtol=TOL, atol=TOL)
                and torch.equal(pa, ua)
                and torch.allclose(pp, up, rtol=TOL, atol=TOL),
                f"padding/{kname}: zero-coefficient slots changed results")
        phase("kernels", case=f"padding/{kname}", ok=True)

    params = _params(gauss)
    sup_flat = sup.reshape(k * w, d)
    k1_ms = time_ms(lambda: fused_step.streaming_assign_cuda(
        xb, sup, coef, sqnorm, diag_b, **params))
    k1_plain = time_ms(lambda: ref.streaming_assign_ref(
        gauss, xb, sup_flat, coef, sqnorm, diag_b), runs=20)

    def k1_chain():
        cross = kernel_cross(gauss, xb, sup_flat)
        pp = torch.einsum("bkw,kw->bk", cross.reshape(b, k, w), coef)
        dd = diag_b[:, None] - 2.0 * pp + sqnorm[None, :]
        return torch.min(dd, dim=1).values, torch.argmin(dd, dim=1)

    k1_chain_ms = time_ms(k1_chain, runs=20)
    k2_ms = time_ms(lambda: fused_assign.fused_batch_center_dots_cuda(
        xb, sup, coef, **params))
    k2_plain = time_ms(lambda: ref.batch_center_dots(gauss, xb, sup, coef),
                       runs=20)

    def k2_chain():
        cross = kernel_cross(gauss, xb, sup_flat)
        return torch.einsum("bkw,kw->bk", cross.reshape(b, k, w), coef)

    k2_chain_ms = time_ms(k2_chain, runs=20)
    k1_bound, k1_by = bound_ms(b, k, w, d, out_bytes=8 * b)
    k2_bound, k2_by = bound_ms(b, k, w, d, out_bytes=4 * b * k)
    phase("kernels", case="timing", shape=f"b={b},k={k},W={w},d={d}",
          card=repr(card), k1_ms=f"{k1_ms:.3f}",
          k1_plain_ms=f"{k1_plain:.3f}", k1_chain_ms=f"{k1_chain_ms:.3f}",
          k1_bound_ms=f"{k1_bound:.3f}", k2_ms=f"{k2_ms:.3f}",
          k2_plain_ms=f"{k2_plain:.3f}", k2_chain_ms=f"{k2_chain_ms:.3f}",
          k2_bound_ms=f"{k2_bound:.3f}")
    del xb, sup, sup_flat, coef, sqnorm, diag_b
    torch.cuda.empty_cache()

    # ---- 4. fit (the main path) ----------------------------------------
    cfg = SolverConfig(k=k, batch_size=b, tau=tau, cache="none",
                       distribution="single", restarts=1, kernel="rbf",
                       kernel_params={"kappa": kappa}, max_iters=50)
    est = KernelKMeans(cfg)
    fused_step.launches.reset()
    fused_assign.launches.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    est.fit(x, key=0)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    k1_launches = fused_step.launches.n
    iters = int(est.iters_)
    require(est.plan_.name == "single", f"plan {est.plan_.name!r}")
    require(est.plan_.config.step == "fused",
            f"step resolved to {est.plan_.config.step!r}")
    require(iters >= 1 and k1_launches == 2 * iters,
            f"K1 launched {k1_launches} times in {iters} iterations")
    hist = est.history_
    require(all(np.isfinite([h["f_before"], h["f_after"]]).all()
                for h in hist), "non-finite objective in the history")
    labels = est.predict(x).cpu().numpy()
    ari = adjusted_rand_index(y_np, labels)
    phase("fit", n=x.shape[0], d=d, k=k, b=b, tau=tau,
          kappa=f"{kappa:.4f}", iters=iters, k1_launches=k1_launches,
          k2_launches=fused_assign.launches.n, fit_s=f"{fit_s:.3f}",
          ms_per_iter=f"{1e3 * fit_s / iters:.2f}",
          f_first=f"{hist[0]['f_before']:.6f}",
          f_last=f"{hist[-1]['f_after']:.6f}", ari=f"{ari:.4f}")

    # ---- 5. step cross-check -------------------------------------------
    state = est.state_
    bidx = sample_batch(api_keys.as_key(11), x.shape[0], b).to(dev)
    mb = cfg.mb_config(dev)
    outs = {}
    for name, mbv in (("fused", mb._replace(step="fused")),
                      ("pallas", mb._replace(step="composed",
                                             use_pallas=True)),
                      ("plain", mb._replace(step="composed"))):
        fused_step.launches.reset()
        fused_assign.launches.reset()
        new_state, info = make_step(gauss, mbv)(state, x, bidx)
        torch.cuda.synchronize()
        outs[name] = (float(info.f_before), float(info.f_after),
                      info.assignments, fused_step.launches.n,
                      fused_assign.launches.n)
    k2_launches = outs["pallas"][4]
    require(outs["fused"][3] == 2 and k2_launches == 2,
            f"step launches: fused K1={outs['fused'][3]}, "
            f"use_pallas K2={k2_launches}")
    fb, fa = outs["plain"][0], outs["plain"][1]
    for name in ("fused", "pallas"):
        for got, want in ((outs[name][0], fb), (outs[name][1], fa)):
            require(abs(got - want) <= TOL + TOL * abs(want),
                    f"step/{name}: objective {got} vs plain {want}")
        agree = (outs[name][2] == outs["plain"][2]).float().mean().item()
        require(agree >= 0.99, f"step/{name}: assignment agreement {agree}")
    # where one fused step's time goes: the whole step, and its sqnorm
    # recompute (the rest is two K1 passes, timed in phase 3, plus glue)
    fused = make_step(gauss, mb._replace(step="fused"))
    step_ms = time_ms(lambda: fused(state, x, bidx), runs=10, warmup=2)
    sqnorm_ms = time_ms(lambda: streamed_sqnorm(gauss, x, state.idx,
                                                state.coef),
                        runs=10, warmup=2)
    phase("step", f_before=f"{fb:.6f}", f_after=f"{fa:.6f}",
          fused=f"{outs['fused'][0]:.6f}/{outs['fused'][1]:.6f}",
          pallas=f"{outs['pallas'][0]:.6f}/{outs['pallas'][1]:.6f}",
          k2_launches=k2_launches, fused_step_ms=f"{step_ms:.3f}",
          sqnorm_ms=f"{sqnorm_ms:.3f}")

    # ---- 6. serve ------------------------------------------------------
    t0 = time.perf_counter()
    lab = est.predict(x)
    torch.cuda.synchronize()
    predict_s = time.perf_counter() - t0
    dist = est.transform(x[:8192])
    score = est.score(x[:8192])
    require(tuple(lab.shape) == (x.shape[0],) and lab.dtype == torch.int32,
            "predict shape/dtype")
    require(tuple(dist.shape) == (8192, k) and bool(
        torch.isfinite(dist).all()) and np.isfinite(score),
            "transform/score")
    with tempfile.TemporaryDirectory() as tmp:
        path = est.save_atomic(os.path.join(tmp, "model.npz"))
        lab2 = KernelKMeans.load(path).predict(x)
    require(torch.equal(lab, lab2), "labels differ after save/load")
    est.partial_fit(x, iters=3)
    require(len(est.history_) == iters + 3, "partial_fit(iters=3)")
    phase("serve", predict_rows=x.shape[0],
          predict_s=f"{predict_s:.3f}", score=f"{score:.6f}",
          save_load_labels_equal=True, partial_fit_iters=3)

    kernels = [
        dict(name="streaming_assign", route="cuda",
             source="src/repro_torch/kernels/csrc/center_dots.cu",
             replaces="src/repro/kernels/fused_step.py:306",
             launches=k1_launches, max_abs_err=err1, ms=k1_ms,
             plain_ms=k1_plain, bound_ms=k1_bound, bound_by=k1_by,
             library_ms=None, chain_ms=k1_chain_ms),
        dict(name="batch_center_dots", route="cuda",
             source="src/repro_torch/kernels/csrc/center_dots.cu",
             replaces="src/repro/kernels/fused_assign.py:64",
             launches=k2_launches, max_abs_err=err2, ms=k2_ms,
             plain_ms=k2_plain, bound_ms=k2_bound, bound_by=k2_by,
             library_ms=None, chain_ms=k2_chain_ms),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def _params(kern):
    from repro_torch.kernels import ops

    return ops._params(ops._dispatch(kern))


if __name__ == "__main__":
    main()
