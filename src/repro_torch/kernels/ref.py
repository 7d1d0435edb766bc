"""Plain torch versions of the port's CUDA kernels — what a wrapper runs for
a tensor on the CPU, what the CPU tests hold against the JAX package, and
what ``chip_smoke.py`` holds each kernel against on the card.

* :func:`batch_center_dots` — kernel K2's function, exactly the JAX
  package's ``repro.kernels.ref.batch_center_dots``.
* :func:`streaming_assign_ref` / :func:`streaming_min_ref` — kernel K1's
  function: the composed step's arithmetic on center chunks of at least two
  centers, folded into a running min / argmin with a strict ``<`` (ties
  keep the first center, as ``torch.argmin`` does).  Every chunk repeats the
  composed op sequence, so on the CPU the fused step built on these is
  bit-identical to the composed step.
"""
from __future__ import annotations

import torch

from repro_torch.core.kernel_fns import (
    Gaussian, KernelFn, Linear, Polynomial, kernel_cross,
)

# Center-chunk width of the plain streaming passes: one (b, kc*W) slab live
# at a time, never narrower than 2 centers.
STREAM_CHUNK = 8
_MIN_CHUNK = 2


def center_chunks(k: int, kc: int = STREAM_CHUNK):
    """Static (start, width) chunking of k centers with no width-1 chunk
    (a trailing remainder of 1 is merged into the previous chunk)."""
    kc = max(kc, _MIN_CHUNK)
    if k <= kc:
        return [(0, k)]
    chunks = []
    j0 = 0
    while j0 < k:
        kk = min(kc, k - j0)
        if k - (j0 + kk) == 1:          # never leave a width-1 remainder
            kk += 1
        chunks.append((j0, kk))
        j0 += kk
    return chunks


def kernel_of(kind: str, p0: float, p1: float, p2: int) -> KernelFn:
    """The kernel a CUDA kernel's ``(kind, p0, p1, p2)`` parameters name
    (the inverse of ``ops._dispatch``)."""
    if kind == "gaussian":
        return Gaussian(kappa=p0)
    if kind == "linear":
        return Linear()
    if kind == "polynomial":
        return Polynomial(bias=p0, scale=p1, degree=p2)
    raise ValueError(f"kind={kind!r} (expected gaussian, linear or "
                     "polynomial)")


def batch_center_dots(kernel: KernelFn, xb: torch.Tensor, sup: torch.Tensor,
                      coef: torch.Tensor) -> torch.Tensor:
    """P[i, j] = sum_w coef[j, w] * K(xb[i], sup[j, w]).

    xb: (b, d); sup: (k, W, d); coef: (k, W) -> (b, k) float32."""
    b = xb.shape[0]
    k, w, d = sup.shape
    cross = kernel_cross(kernel, xb, sup.reshape(k * w, d))
    return torch.einsum("bkw,kw->bk", cross.reshape(b, k, w), coef)


def _chunk_dists(kernel, xb, sup_flat, coef, sqnorm, diag_b, j0, kk):
    """The composed step's distance block for centers [j0, j0+kk)."""
    b = xb.shape[0]
    k, w = coef.shape
    sup_c = sup_flat.reshape(k, w, -1)[j0:j0 + kk].reshape(kk * w, -1)
    cross = kernel_cross(kernel, xb, sup_c)
    p = torch.einsum("bkw,kw->bk", cross.reshape(b, kk, w),
                     coef[j0:j0 + kk])
    return diag_b[:, None] - 2.0 * p + sqnorm[None, j0:j0 + kk]


def streaming_assign_ref(kernel: KernelFn, xb: torch.Tensor,
                         sup_flat: torch.Tensor, coef: torch.Tensor,
                         sqnorm: torch.Tensor, diag_b: torch.Tensor, *,
                         kc: int = STREAM_CHUNK):
    """(best, assign): running min distance (b,) f32 and argmin center
    (b,) int32 over all k centers, one (b, kc*W) slab at a time.
    ``sup_flat``: (k*W, d)."""
    k, _ = coef.shape
    best = bidx = None
    for j0, kk in center_chunks(k, kc):
        dd = _chunk_dists(kernel, xb, sup_flat, coef, sqnorm, diag_b, j0, kk)
        cmin = torch.min(dd, dim=1).values
        cidx = torch.argmin(dd, dim=1).to(torch.int32) + j0
        if best is None:
            best, bidx = cmin, cidx
        else:
            upd = cmin < best                  # strict: first-min ties
            best = torch.where(upd, cmin, best)
            bidx = torch.where(upd, cidx, bidx)
    return best, bidx


def streaming_min_ref(kernel: KernelFn, xb: torch.Tensor,
                      sup_flat: torch.Tensor, coef: torch.Tensor,
                      sqnorm: torch.Tensor, diag_b: torch.Tensor, *,
                      kc: int = STREAM_CHUNK) -> torch.Tensor:
    """Running min distance only — the post-update objective pass."""
    k, _ = coef.shape
    best = None
    for j0, kk in center_chunks(k, kc):
        dd = _chunk_dists(kernel, xb, sup_flat, coef, sqnorm, diag_b, j0, kk)
        cmin = torch.min(dd, dim=1).values
        best = cmin if best is None else torch.minimum(best, cmin)
    return best
