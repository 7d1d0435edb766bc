"""Kernel K2, the fused kernel-evaluation x coefficient contraction — the
port of the JAX package's ``repro.kernels.fused_assign``.

Computes P[i, j] = sum_w coef[j, w] * K(xb[i], sup[j, w]) without the
(b, k*W) cross-kernel matrix in device memory (``rk_batch_center_dots`` in
``csrc/center_dots.cu``, which shares its device routine with K1).  A CPU
tensor takes the plain version (:func:`repro_torch.kernels.ref
.batch_center_dots`); a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import batch_center_dots, kernel_of

launches = _build.LaunchCounter("batch_center_dots")


def fused_batch_center_dots_cuda(xb: torch.Tensor, sup: torch.Tensor,
                                 coef: torch.Tensor, *,
                                 kind: str = "gaussian", p0: float = 1.0,
                                 p1: float = 1.0,
                                 p2: int = 2) -> torch.Tensor:
    """xb (b, d); sup (k, W, d); coef (k, W), all f32 -> P (b, k) f32."""
    b, d = xb.shape
    k, w, _ = sup.shape
    if xb.device.type == "cpu":
        return batch_center_dots(kernel_of(kind, p0, p1, p2), xb, sup, coef)
    xsq, supsq = _build.operands("fused_batch_center_dots_cuda", xb, sup,
                                 coef)
    if k > 65535:
        raise ValueError(f"fused_batch_center_dots_cuda: k={k} exceeds the "
                         "grid's y extent (65535)")
    code = _build.kind_code(kind, p2)
    lib = _build.lib()
    with torch.cuda.device(xb.device):
        out = torch.empty((b, k), dtype=torch.float32, device=xb.device)
        rc = lib.rk_batch_center_dots(
            xb.data_ptr(), xsq.data_ptr(), sup.data_ptr(), supsq.data_ptr(),
            coef.data_ptr(), b, k, w, d, code, float(p0), float(p1), int(p2),
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        launches.n += 1
    _build.check(rc, "rk_batch_center_dots")
    return out
