"""Public entry points of the port's kernels, with the JAX package's
dispatch (``repro.kernels.ops``).

Kernels with a matmul form (gaussian / linear / polynomial) go to the CUDA
kernel wrappers, which launch on a CUDA tensor and take the plain version
on a CPU tensor.  Kernels without one (Laplacian's L1 distance, Precomputed
gathers) take the plain torch chain on every device — the reference routes
them the same way; it is the design, not a fallback on failure.
"""
from __future__ import annotations

import torch

from repro_torch.core.kernel_fns import Gaussian, KernelFn, Linear, Polynomial
from repro_torch.kernels import fused_assign, fused_step, ref


def _dispatch(kernel: KernelFn):
    """-> (kind, p0, p1, p2) or None when no CUDA form exists."""
    if isinstance(kernel, Gaussian):
        return "gaussian", float(kernel.kappa), 1.0, 2
    if isinstance(kernel, Linear):
        return "linear", 0.0, 1.0, 2
    if isinstance(kernel, Polynomial):
        return ("polynomial", float(kernel.bias), float(kernel.scale),
                int(kernel.degree))
    return None


def _params(disp):
    kind, p0, p1, p2 = disp
    return dict(kind=kind, p0=p0, p1=p1, p2=p2)


def fused_batch_center_dots(kernel: KernelFn, xb: torch.Tensor,
                            sup_flat: torch.Tensor,
                            coef: torch.Tensor) -> torch.Tensor:
    """P[i,j] = sum_w coef[j,w] K(xb[i], sup[j,w]);  sup_flat: (k*W, d)."""
    k, w = coef.shape
    sup = sup_flat.reshape(k, w, sup_flat.shape[-1])
    disp = _dispatch(kernel)
    if disp is None:
        return ref.batch_center_dots(kernel, xb, sup, coef)
    return fused_assign.fused_batch_center_dots_cuda(xb, sup, coef,
                                                     **_params(disp))


def streaming_assign(kernel: KernelFn, xb: torch.Tensor,
                     sup_flat: torch.Tensor, coef: torch.Tensor,
                     sqnorm: torch.Tensor, diag_b: torch.Tensor):
    """Streaming fused assignment: (best_dist (b,), assign (b,) int32) over
    all k centers — the ``step="fused"`` hot pass.  ``sup_flat``: (k*W, d)
    support rows."""
    k, w = coef.shape
    disp = _dispatch(kernel)
    if disp is None:
        return ref.streaming_assign_ref(kernel, xb, sup_flat, coef, sqnorm,
                                        diag_b)
    return fused_step.streaming_assign_cuda(
        xb, sup_flat.reshape(k, w, sup_flat.shape[-1]), coef, sqnorm, diag_b,
        **_params(disp))


def streaming_min(kernel: KernelFn, xb: torch.Tensor, sup_flat: torch.Tensor,
                  coef: torch.Tensor, sqnorm: torch.Tensor,
                  diag_b: torch.Tensor) -> torch.Tensor:
    """Streaming min distance (b,) only — the fused step's post-update
    objective pass (K1 with its index dropped)."""
    k, w = coef.shape
    disp = _dispatch(kernel)
    if disp is None:
        return ref.streaming_min_ref(kernel, xb, sup_flat, coef, sqnorm,
                                     diag_b)
    best, _ = fused_step.streaming_assign_cuda(
        xb, sup_flat.reshape(k, w, sup_flat.shape[-1]), coef, sqnorm, diag_b,
        **_params(disp))
    return best
