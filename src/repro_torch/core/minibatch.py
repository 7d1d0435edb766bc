"""Algorithm 2 — truncated mini-batch kernel k-means, over torch tensors.

One iteration (Theorem 1(1): O(k (tau+b)^2) kernel evaluations):

1. sample a batch B of b points uniformly with replacement;
2. assign each batch point to the nearest truncated center
   (d(x, C_j) = K(x,x) - 2 <phi(x), C_j> + <C_j, C_j>, where
   <phi(x), C_j> = sum_w coef[j,w] K(x, X[idx[j,w]]));
3. per-center learning rate alpha_j (beta or sklearn, rates.py);
4. decay existing coefficients by (1 - alpha_j) and append the assigned
   batch points with coefficient alpha_j / b_j into the ring window;
5. recompute <C_j, C_j> (the paper-faithful O(k W^2) recompute);
6. early stopping when the batch objective improves by less than epsilon.

``make_step`` closes over the static config and returns a step function:
``step="composed"`` (the op chain, optionally with kernel K2 for the
contraction under ``use_pallas``) or ``step="fused"`` (kernel K1 for both
batch x window passes).  On the CPU both run plain torch and agree bit for
bit.  Only ``sqnorm_mode="recompute"`` / ``eval_mode="direct"`` are ported.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.api import keys as api_keys
from repro_torch.core.kernel_fns import (
    KernelFn, diag_of, kernel_cross, to_tensor,
)
from repro_torch.core.loop import drive_fit_loop, precision_plan
from repro_torch.core.rates import get_rate
from repro_torch.core.state import CenterState


class MBConfig(NamedTuple):
    """Static configuration for Algorithm 2."""

    k: int
    batch_size: int
    tau: int
    rate: str = "beta"              # 'beta' (paper theory) | 'sklearn'
    sqnorm_mode: str = "recompute"  # only 'recompute' is ported
    eval_mode: str = "direct"       # only 'direct' is ported
    epsilon: float = 1e-4
    max_iters: int = 200
    use_pallas: bool = False        # kernel K2 for the contraction (the
    #                                 reference's Pallas switch, same name)
    compute_dtype: str = "float32"  # only float32 is ported
    step: str = "composed"          # 'fused': kernel K1 streaming passes
    compress: Optional[tuple] = None  # not ported: must be None


class StepInfo(NamedTuple):
    f_before: torch.Tensor     # f_B(C_i)      — batch objective at entry
    f_after: torch.Tensor      # f_B(C_{i+1})  — batch objective after
    improvement: torch.Tensor  # f_before - f_after (early stop: < epsilon)
    batch_counts: torch.Tensor  # (k,) b_i^j
    assignments: torch.Tensor   # (b,) int32


def _long(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int64)


def _batch_center_dots(kernel: KernelFn, xb: torch.Tensor, x: torch.Tensor,
                       idx: torch.Tensor, coef: torch.Tensor,
                       use_pallas: bool) -> torch.Tensor:
    """P[x, j] = <phi(x), C_j> for batch xb against windowed centers."""
    k, w = idx.shape
    sup = x[_long(idx.reshape(-1))]                       # (k*W, d)
    if use_pallas:
        from repro_torch.kernels import ops as kops
        return kops.fused_batch_center_dots(kernel, xb, sup, coef)
    cross = kernel_cross(kernel, xb, sup)                 # (b, k*W)
    return torch.einsum("bkw,kw->bk", cross.reshape(xb.shape[0], k, w),
                        coef)


def _append_to_windows(idx, coef, head, alpha, bj, onehot, batch_idx):
    """Masked ring-buffer append.  Returns new (idx, coef, head) plus the
    (post-decay) index/coefficient of every evicted slot.  b_j <= b <= W,
    so within one iteration the write positions never collide.

    The reference's per-center ``vmap`` is written out over the center
    axis: a scatter into a (k, W+1) buffer whose last column takes the
    dropped writes of unassigned batch slots (and reads as 0, the
    reference's gather fill)."""
    k, w = idx.shape
    b = batch_idx.shape[0]
    mask = onehot.T.to(torch.bool)                              # (k, b)
    pos = torch.cumsum(mask.to(torch.int32), dim=1) - 1         # (k, b)
    slot = (head[:, None] + pos) % w
    slot = _long(torch.where(mask, slot, torch.full_like(slot, w)))
    coef_buf = torch.cat([coef, coef.new_zeros((k, 1))], dim=1)
    idx_buf = torch.cat([idx, idx.new_zeros((k, 1))], dim=1)
    evict_coef = torch.gather(coef_buf, 1, slot)
    evict_idx = torch.gather(idx_buf, 1, slot)
    newc = alpha / torch.clamp(bj, min=1.0)                     # (k,)
    coef_buf.scatter_(1, slot, newc[:, None].expand(k, b).contiguous())
    idx_buf.scatter_(1, slot, batch_idx.to(idx.dtype)[None, :]
                     .expand(k, b).contiguous())
    head_new = (head + bj.to(torch.int32)) % w
    return (idx_buf[:, :w].contiguous(), coef_buf[:, :w].contiguous(),
            head_new, evict_idx, evict_coef)


def _sqnorm_recompute(kernel, x, idx, coef):
    """Paper-faithful <C_j, C_j>: per-center W x W Gram quadratic form,
    all centers in one batch.  Empty slots (coef 0) contribute nothing."""
    from repro_torch.kernels.fused_step import gram_quadform
    return gram_quadform(kernel, x, idx, coef)


def _check_ported(cfg: MBConfig):
    if cfg.sqnorm_mode != "recompute":
        raise NotImplementedError(
            f"sqnorm_mode={cfg.sqnorm_mode!r} is not ported yet (only "
            "'recompute'; ROADMAP Queue 1 item 3)")
    if cfg.eval_mode != "direct":
        raise NotImplementedError(
            f"eval_mode={cfg.eval_mode!r} is not ported yet (only 'direct';"
            " ROADMAP Queue 1 item 3)")
    if cfg.compress is not None:
        raise NotImplementedError("the compress axis is not ported yet "
                                  "(ROADMAP Queue 1 item 8)")


def _make_fused_step(kernel: KernelFn, cfg: MBConfig):
    """The ``step="fused"`` iteration: both batch x window passes
    (assignment and the post-update objective) stream through kernel K1;
    the rates, the ring append and the sqnorm recompute are the composed
    step's.  Index-data kernels take the composed passes."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.fused_step import streamed_sqnorm

    rate_fn = get_rate(cfg.rate)
    b = cfg.batch_size
    index_data = precision_plan(kernel, cfg).index_data

    def step(state: CenterState, x: torch.Tensor, batch_idx):
        k, w = state.idx.shape
        batch_idx = to_tensor(batch_idx, device=x.device)
        xb = x[_long(batch_idx)]                                   # (b, d)
        diag_b = diag_of(kernel, xb)                               # (b,)

        # ---- (2) streaming assignment: online argmin over centers -------
        if index_data:
            p = _batch_center_dots(kernel, xb, x, state.idx, state.coef,
                                   cfg.use_pallas)
            dists = diag_b[:, None] - 2.0 * p + state.sqnorm[None, :]
            best = torch.min(dists, dim=1).values
            assign = torch.argmin(dists, dim=1).to(torch.int32)
        else:
            best, assign = kops.streaming_assign(
                kernel, xb, x[_long(state.idx.reshape(-1))], state.coef,
                state.sqnorm, diag_b)
        f_before = torch.mean(best)
        onehot = torch.nn.functional.one_hot(_long(assign), k) \
            .to(torch.float32)                                     # (b, k)
        bj = torch.sum(onehot, dim=0)                              # (k,)

        # ---- (3)/(4) rates + ring append: shared with the composed step -
        alpha = rate_fn(bj, state.counts, b)
        coef_scaled = state.coef * (1.0 - alpha)[:, None]
        new_idx, new_coef, new_head, _, _ = _append_to_windows(
            state.idx, coef_scaled, state.head, alpha, bj, onehot,
            batch_idx)

        # ---- (5) center squared norms (paper-faithful recompute) --------
        if index_data:
            new_sqnorm = _sqnorm_recompute(kernel, x, new_idx, new_coef)
        else:
            new_sqnorm = streamed_sqnorm(kernel, x, new_idx, new_coef)

        # ---- (6) streaming objective on the NEW centers -----------------
        if index_data:
            p_new = _batch_center_dots(kernel, xb, x, new_idx, new_coef,
                                       cfg.use_pallas)
            d_new = diag_b[:, None] - 2.0 * p_new + new_sqnorm[None, :]
            best2 = torch.min(d_new, dim=1).values
        else:
            best2 = kops.streaming_min(
                kernel, xb, x[_long(new_idx.reshape(-1))], new_coef,
                new_sqnorm, diag_b)
        f_after = torch.mean(best2)

        new_state = CenterState(
            idx=new_idx, coef=new_coef, head=new_head, sqnorm=new_sqnorm,
            counts=state.counts + bj, step=state.step + 1)
        info = StepInfo(f_before=f_before, f_after=f_after,
                        improvement=f_before - f_after,
                        batch_counts=bj, assignments=assign)
        return new_state, info

    return step


def make_step(kernel: KernelFn, cfg: MBConfig):
    """Returns step(state, x, batch_idx) -> (state, StepInfo): one
    Algorithm-2 iteration, with x passed explicitly.  ``cfg.step`` selects
    'composed' or 'fused' (:func:`_make_fused_step`)."""
    _check_ported(cfg)
    precision_plan(kernel, cfg)           # raises on an unported precision
    if cfg.step == "fused":
        return _make_fused_step(kernel, cfg)
    if cfg.step != "composed":
        raise ValueError(f"step={cfg.step!r} (expected 'composed' or "
                         "'fused')")
    rate_fn = get_rate(cfg.rate)
    b = cfg.batch_size

    def step(state: CenterState, x: torch.Tensor, batch_idx):
        k, w = state.idx.shape
        batch_idx = to_tensor(batch_idx, device=x.device)
        xb = x[_long(batch_idx)]                                   # (b, d)
        diag_b = diag_of(kernel, xb)                               # (b,)

        # ---- (2) assignment against current truncated centers -----------
        p = _batch_center_dots(kernel, xb, x, state.idx, state.coef,
                               cfg.use_pallas)                     # (b, k)
        dists = diag_b[:, None] - 2.0 * p + state.sqnorm[None, :]
        f_before = torch.mean(torch.min(dists, dim=1).values)
        assign = torch.argmin(dists, dim=1).to(torch.int32)
        onehot = torch.nn.functional.one_hot(_long(assign), k) \
            .to(torch.float32)                                     # (b, k)
        bj = torch.sum(onehot, dim=0)                              # (k,)

        # ---- (3) learning rate ------------------------------------------
        alpha = rate_fn(bj, state.counts, b)                       # (k,)
        decay = 1.0 - alpha

        # ---- (4) decay + ring append ------------------------------------
        coef_scaled = state.coef * decay[:, None]
        new_idx, new_coef, new_head, _, _ = _append_to_windows(
            state.idx, coef_scaled, state.head, alpha, bj, onehot,
            batch_idx)

        # ---- (5) center squared norms -----------------------------------
        new_sqnorm = _sqnorm_recompute(kernel, x, new_idx, new_coef)

        # ---- (6) batch objective on the NEW centers (early stopping) ----
        p_new = _batch_center_dots(kernel, xb, x, new_idx, new_coef,
                                   cfg.use_pallas)
        d_new = diag_b[:, None] - 2.0 * p_new + new_sqnorm[None, :]
        f_after = torch.mean(torch.min(d_new, dim=1).values)

        new_state = CenterState(
            idx=new_idx, coef=new_coef, head=new_head, sqnorm=new_sqnorm,
            counts=state.counts + bj, step=state.step + 1)
        info = StepInfo(f_before=f_before, f_after=f_after,
                        improvement=f_before - f_after,
                        batch_counts=bj, assignments=assign)
        return new_state, info

    return step


def batch_objective(kernel: KernelFn, state: CenterState, x: torch.Tensor,
                    batch_idx, use_pallas: bool = False) -> torch.Tensor:
    """f_B(C) = mean min_j d(x, C_j) on an explicit batch."""
    xb = x[_long(to_tensor(batch_idx, device=x.device))]
    diag_b = diag_of(kernel, xb)
    p = _batch_center_dots(kernel, xb, x, state.idx, state.coef, use_pallas)
    dists = diag_b[:, None] - 2.0 * p + state.sqnorm[None, :]
    return torch.mean(torch.min(dists, dim=1).values)


def sample_batch(kb: torch.Generator, n: int, b: int) -> torch.Tensor:
    """Uniform with replacement (paper's sampling model); (b,) int32 on the
    CPU."""
    return torch.randint(0, n, (b,), generator=kb, dtype=torch.int32)


def sample_batch_weighted(kb: torch.Generator, probs: torch.Tensor,
                          b: int) -> torch.Tensor:
    """Sampling x with probability proportional to w_x (paper footnote 1);
    (b,) int32 on the CPU."""
    return torch.multinomial(probs.detach().to("cpu", torch.float64), b,
                             replacement=True, generator=kb) \
        .to(torch.int32)


def host_fit_loop(step, n: int, cfg: MBConfig, state, key: torch.Generator,
                  probs: Optional[torch.Tensor] = None,
                  early_stop: bool = True, step0: int = 0,
                  prefetch: bool = False, device=None):
    """The host-driven early-stopped driver of the single-device fit: per
    iteration draw the batch indices from the key stream
    (:mod:`repro_torch.api.keys`), apply
    ``step(state, batch_idx) -> (state, StepInfo)``, and stop when the
    improvement drops below epsilon.  ``prefetch`` stages the next draw on
    ``device`` while the current step runs.  Returns
    ``(state, history, key)``; the carried key resumes the stream exactly.
    """
    def draw(key, i):
        key, kb = api_keys.next_batch_key(key)
        return key, (sample_batch(kb, n, cfg.batch_size) if probs is None
                     else sample_batch_weighted(kb, probs, cfg.batch_size))

    def dispatch(bidx):
        nonlocal state
        state, info = step(state, bidx)
        return info

    def stage(bidx):
        return bidx.to(device, non_blocking=True) if device is not None \
            else bidx

    history, key = drive_fit_loop(
        dispatch, draw, key, max_iters=cfg.max_iters, epsilon=cfg.epsilon,
        early_stop=early_stop, prefetch=prefetch, step0=step0, stage=stage)
    return state, history, key


def assign_chunked(kernel: KernelFn, coef: torch.Tensor,
                   sqnorm: torch.Tensor, sup: torch.Tensor, xq: torch.Tensor,
                   chunk: int) -> torch.Tensor:
    """Chunked nearest-center assignment against explicit (k*W, d) support
    points — the serving scan behind ``predict``.  Support-side squared
    norms are hoisted out of the chunk loop (:func:`cross_fixed_y`)."""
    from repro_torch.core.kernel_fns import cross_fixed_y

    k, w = coef.shape
    cross_fn = cross_fixed_y(kernel, sup)
    out = []
    for c0 in range(0, xq.shape[0], chunk):
        xc = xq[c0:c0 + chunk]
        cross = cross_fn(xc).reshape(xc.shape[0], k, w)
        p = torch.einsum("bkw,kw->bk", cross, coef)
        d = diag_of(kernel, xc)[:, None] - 2.0 * p + sqnorm[None, :]
        out.append(torch.argmin(d, dim=1).to(torch.int32))
    if not out:
        return torch.zeros((0,), dtype=torch.int32, device=xq.device)
    return torch.cat(out)


def center_distances_chunked(kernel: KernelFn, coef: torch.Tensor,
                             sqnorm: torch.Tensor, sup: torch.Tensor,
                             xq: torch.Tensor, chunk: int) -> torch.Tensor:
    """Chunked feature-space distances d(x, C_j), (nq, k) — the
    ``transform`` / ``score`` scan; same distance expression as
    :func:`assign_chunked`."""
    from repro_torch.core.kernel_fns import cross_fixed_y

    k, w = coef.shape
    cross_fn = cross_fixed_y(kernel, sup)
    out = []
    for c0 in range(0, xq.shape[0], chunk):
        xc = xq[c0:c0 + chunk]
        cross = cross_fn(xc).reshape(xc.shape[0], k, w)
        p = torch.einsum("bkw,kw->bk", cross, coef)
        out.append(diag_of(kernel, xc)[:, None] - 2.0 * p
                   + sqnorm[None, :])
    if not out:
        return torch.zeros((0, k), dtype=torch.float32, device=xq.device)
    return torch.cat(out)


def predict(state: CenterState, x: torch.Tensor, xq: torch.Tensor,
            kernel: KernelFn, chunk: int = 4096) -> torch.Tensor:
    """Assign arbitrary points to the fitted (truncated) centers."""
    sup = x[_long(state.idx.reshape(-1))]
    return assign_chunked(kernel, state.coef, state.sqnorm, sup, xq, chunk)
