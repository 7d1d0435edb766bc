"""The port's Algorithm-2 step (``repro_torch.core.minibatch.make_step``)
against the JAX package's composed step, teacher-forced: every step takes
the reference's state (carried across through ``state_from_numpy``) and the
same numpy batch indices.  Integer state must be equal, float state within
1e-5.  Inside the port, the fused, composed and ``use_pallas`` steps agree
bit for bit on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kernel_fns as jk
from repro.core import minibatch as jmb
from repro.core.state import CenterState as JState
from repro.core.state import init_state as jinit_state
from repro.data import blobs
from repro_torch.core import kernel_fns as tk
from repro_torch.core import minibatch as tmb
from repro_torch.core.state import (
    init_state, state_from_numpy, state_to_numpy,
)

KERNELS = {
    "rbf": (jk.Gaussian(kappa=jnp.float32(1.5)), tk.Gaussian(kappa=1.5)),
    "polynomial": (jk.Polynomial(bias=jnp.float32(1.0),
                                 scale=jnp.float32(8.0), degree=2),
                   tk.Polynomial(bias=1.0, scale=8.0, degree=2)),
    "laplacian": (jk.Laplacian(kappa=jnp.float32(3.0)), tk.Laplacian(3.0)),
}
K, B, TAU, N, D = 4, 32, 16, 256, 8
STEPS = 5


def _setup(seed=0):
    x, _ = blobs(n=N, d=D, k=K, seed=seed)
    rng = np.random.default_rng(seed)
    init = rng.choice(N, K, replace=False).astype(np.int32)
    batches = [rng.integers(0, N, B).astype(np.int32) for _ in range(STEPS)]
    return x, init, batches


def _cfg(rate, **kw):
    return dict(k=K, batch_size=B, tau=TAU, rate=rate, **kw)


def _assert_state_close(got, want):
    got = state_to_numpy(got)
    for f in ("idx", "head", "counts", "step"):
        np.testing.assert_array_equal(getattr(got, f),
                                      np.asarray(getattr(want, f)), err_msg=f)
    for f in ("coef", "sqnorm"):
        np.testing.assert_allclose(getattr(got, f),
                                   np.asarray(getattr(want, f)),
                                   rtol=1e-5, atol=1e-5, err_msg=f)
    for f in JState._fields:
        assert getattr(got, f).dtype == np.asarray(getattr(want, f)).dtype, f


@pytest.mark.parametrize("kname,rate", [("rbf", "beta"), ("rbf", "sklearn"),
                                        ("polynomial", "beta"),
                                        ("laplacian", "beta")])
def test_teacher_forced_steps_match_jax_composed(kname, rate):
    jkern, tkern = KERNELS[kname]
    x, init, batches = _setup()
    jstep = jax.jit(jmb.make_step(jkern, jmb.MBConfig(**_cfg(rate))))
    tsteps = {name: tmb.make_step(tkern, tmb.MBConfig(**_cfg(rate, **kw)))
              for name, kw in (("composed", {}), ("fused", {"step": "fused"}),
                               ("pallas", {"use_pallas": True}))}
    xj, xt = jnp.asarray(x), torch.tensor(x)
    jstate = jinit_state(xj, jnp.asarray(init), jkern, B + TAU)
    _assert_state_close(init_state(xt, torch.tensor(init), tkern, B + TAU),
                        jstate)
    for bidx in batches:
        want, winfo = jstep(jstate, xj, jnp.asarray(bidx))
        for name, step in tsteps.items():
            got, info = step(state_from_numpy(jstate), xt, bidx)
            _assert_state_close(got, want)
            np.testing.assert_array_equal(info.assignments.numpy(),
                                          np.asarray(winfo.assignments))
            np.testing.assert_array_equal(info.batch_counts.numpy(),
                                          np.asarray(winfo.batch_counts))
            for f in ("f_before", "f_after", "improvement"):
                np.testing.assert_allclose(float(getattr(info, f)),
                                           float(getattr(winfo, f)),
                                           rtol=1e-5, atol=1e-5)
        jstate = want


@pytest.mark.parametrize("kname", list(KERNELS))
def test_fused_and_pallas_steps_equal_composed_bitwise_on_cpu(kname):
    _, tkern = KERNELS[kname]
    x, init, batches = _setup(1)
    xt = torch.tensor(x)
    states = {}
    for name, kw in (("composed", {}), ("fused", {"step": "fused"}),
                     ("pallas", {"use_pallas": True})):
        step = tmb.make_step(tkern, tmb.MBConfig(**_cfg("beta", **kw)))
        st = init_state(xt, torch.tensor(init), tkern, B + TAU)
        fs = []
        for bidx in batches:
            st, info = step(st, xt, torch.tensor(bidx))
            fs.append((float(info.f_before), float(info.f_after)))
        states[name] = (st, fs)
    ref_state, ref_fs = states["composed"]
    for name in ("fused", "pallas"):
        st, fs = states[name]
        assert fs == ref_fs, name
        for a, b in zip(st, ref_state):
            assert torch.equal(a, b), name


def test_append_to_windows_matches_jax_with_wraparound():
    rng = np.random.default_rng(3)
    k, w, b = 3, 10, 6
    idx = rng.integers(0, 50, (k, w)).astype(np.int32)
    coef = rng.random((k, w)).astype(np.float32)
    head = np.array([0, 7, 9], np.int32)         # 7 and 9 wrap around
    assign = rng.integers(0, k, b)
    onehot = np.eye(k, dtype=np.float32)[assign]
    bj = onehot.sum(axis=0)
    alpha = np.sqrt(bj / b).astype(np.float32)
    batch_idx = rng.integers(0, 50, b).astype(np.int32)
    want = jmb._append_to_windows(*(jnp.asarray(a) for a in (
        idx, coef, head, alpha, bj, onehot, batch_idx)))
    got = tmb._append_to_windows(*(torch.tensor(a) for a in (
        idx, coef, head, alpha, bj, onehot, batch_idx)))
    for g, wv in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wv))
        assert g.dtype == getattr(torch, str(np.asarray(wv).dtype))


def test_batch_objective_and_predict_match_jax():
    jkern, tkern = KERNELS["rbf"]
    x, init, batches = _setup(2)
    xj, xt = jnp.asarray(x), torch.tensor(x)
    jstate = jinit_state(xj, jnp.asarray(init), jkern, B + TAU)
    jstate, _ = jax.jit(jmb.make_step(jkern, jmb.MBConfig(**_cfg("beta"))))(
        jstate, xj, jnp.asarray(batches[0]))
    tstate = state_from_numpy(jstate)
    np.testing.assert_allclose(
        float(tmb.batch_objective(tkern, tstate, xt, batches[1])),
        float(jmb.batch_objective(jkern, jstate, xj,
                                  jnp.asarray(batches[1]))),
        rtol=1e-5, atol=1e-5)
    want = np.asarray(jmb.predict(jstate, xj, xj, jkern, chunk=64))
    got = tmb.predict(tstate, xt, xt, tkern, chunk=100).numpy()
    np.testing.assert_array_equal(got, want)
    sup = xt[tstate.idx.reshape(-1).long()]
    dists = tmb.center_distances_chunked(tkern, tstate.coef, tstate.sqnorm,
                                         sup, xt, chunk=77)
    jd = np.asarray(jmb.center_distances_chunked(
        jkern, jstate.coef, jstate.sqnorm, xj[jstate.idx.reshape(-1)], xj,
        chunk=64))
    np.testing.assert_allclose(dists.numpy(), jd, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("field,value", [("sqnorm_mode", "incremental"),
                                         ("eval_mode", "delta"),
                                         ("compute_dtype", "bfloat16")])
def test_unported_step_modes_raise(field, value):
    cfg = tmb.MBConfig(**_cfg("beta", **{field: value}))
    with pytest.raises(NotImplementedError):
        tmb.make_step(tk.Gaussian(1.0), cfg)
