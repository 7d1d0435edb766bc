"""Kernel K1, the streaming fused assignment, and the streamed <C_j, C_j>
recompute — the port of the JAX package's ``repro.kernels.fused_step``.

* :func:`streaming_assign_cuda` — per batch row, the running min distance
  and argmin over all centers without the (b, k*W) cross strip or the
  (b, k) distances ever reaching device memory (``rk_streaming_assign`` in
  ``csrc/center_dots.cu``).  A CPU tensor takes the plain version
  (:func:`repro_torch.kernels.ref.streaming_assign_ref`); a CUDA tensor
  launches the kernel or raises.
* :func:`streamed_sqnorm` — the paper-faithful <C_j, C_j> recompute over
  center chunks in batched torch ops (XLA in the reference, so plain torch
  here): one (kc, W, W) Gram slab live at a time.
"""
from __future__ import annotations

import torch

from repro_torch.core.kernel_fns import (
    Gaussian, KernelFn, Linear, Polynomial, kernel_cross,
)
from repro_torch.kernels import _build
from repro_torch.kernels.ref import (  # noqa: F401  (center_chunks lives
    # beside the plain passes it chunks; re-exported as in the reference)
    STREAM_CHUNK, center_chunks, kernel_of, streaming_assign_ref,
)

launches = _build.LaunchCounter("streaming_assign")


def streaming_assign_cuda(xb: torch.Tensor, sup: torch.Tensor,
                          coef: torch.Tensor, sqnorm: torch.Tensor,
                          diag_b: torch.Tensor, *, kind: str = "gaussian",
                          p0: float = 1.0, p1: float = 1.0, p2: int = 2):
    """xb (b, d); sup (k, W, d); coef (k, W); sqnorm (k,); diag_b (b,), all
    f32 -> (best (b,) f32, assign (b,) int32); ties keep the first
    center."""
    b, d = xb.shape
    k, w, _ = sup.shape
    if xb.device.type == "cpu":
        return streaming_assign_ref(kernel_of(kind, p0, p1, p2), xb,
                                    sup.reshape(k * w, d), coef, sqnorm,
                                    diag_b)
    xsq, supsq = _build.operands("streaming_assign_cuda", xb, sup, coef,
                                 (sqnorm, "sqnorm", (k,)),
                                 (diag_b, "diag_b", (b,)))
    code = _build.kind_code(kind, p2)
    lib = _build.lib()
    with torch.cuda.device(xb.device):
        best = torch.empty((b,), dtype=torch.float32, device=xb.device)
        assign = torch.empty((b,), dtype=torch.int32, device=xb.device)
        rc = lib.rk_streaming_assign(
            xb.data_ptr(), xsq.data_ptr(), diag_b.data_ptr(), sup.data_ptr(),
            supsq.data_ptr(), coef.data_ptr(), sqnorm.data_ptr(), b, k, w, d,
            code, float(p0), float(p1), int(p2), best.data_ptr(),
            assign.data_ptr(), torch.cuda.current_stream().cuda_stream)
        launches.n += 1
    _build.check(rc, "rk_streaming_assign")
    return best, assign


def _batched_cross(kernel: KernelFn, pts: torch.Tensor) -> torch.Tensor:
    """(kk, W, W) Gram blocks K(pts[c], pts[c]) for a (kk, W, d) stack —
    per center the op sequence of ``kernel_cross``, with the center axis
    written out as a batch dimension of ``bmm``."""
    if isinstance(kernel, Gaussian):
        sq = torch.sum(pts * pts, dim=-1)
        xy = torch.bmm(pts, pts.transpose(1, 2))
        d2 = torch.clamp(sq[:, :, None] + sq[:, None, :] - 2.0 * xy, min=0.0)
        return torch.exp(-d2 / kernel.kappa)
    if isinstance(kernel, Linear):
        return torch.bmm(pts, pts.transpose(1, 2))
    if isinstance(kernel, Polynomial):
        xy = torch.bmm(pts, pts.transpose(1, 2))
        return (xy / kernel.scale + kernel.bias) ** kernel.degree
    return torch.stack([kernel_cross(kernel, p, p) for p in pts])


def gram_quadform(kernel: KernelFn, x: torch.Tensor, idx: torch.Tensor,
                  coef: torch.Tensor) -> torch.Tensor:
    """coef_j @ K(X[idx_j], X[idx_j]) @ coef_j for each center row j of
    ``idx`` / ``coef`` (kk, W) -> (kk,).  Empty slots (coef 0) contribute
    nothing."""
    pts = x[idx.to(torch.int64)]                           # (kk, W, d)
    g = _batched_cross(kernel, pts)                        # (kk, W, W)
    gc = torch.bmm(g, coef[:, :, None])                    # (kk, W, 1)
    return torch.bmm(coef[:, None, :], gc).reshape(-1)


def streamed_sqnorm(kernel: KernelFn, x: torch.Tensor, idx: torch.Tensor,
                    coef: torch.Tensor, *,
                    kc: int = STREAM_CHUNK) -> torch.Tensor:
    """<C_j, C_j> over index windows, center-chunked: the per-center ops of
    ``minibatch._sqnorm_recompute`` with only one (kc, W, W) Gram slab
    live instead of the full (k, W, W) stack."""
    return torch.cat([gram_quadform(kernel, x, idx[j0:j0 + kk],
                                    coef[j0:j0 + kk])
                      for j0, kk in center_chunks(idx.shape[0], kc)])
