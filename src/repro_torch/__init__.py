"""repro_torch — the PyTorch + CUDA port of the mini-batch kernel k-means
package ``repro``, for an NVIDIA H100 (sm_90a).

The front door is :class:`repro_torch.api.KernelKMeans`; it runs on a CUDA
device unless the caller passes ``device="cpu"``.  The hot pass of a fit
step runs in hand-written CUDA C++ kernels (``kernels/csrc``), built with
``nvcc`` at first use.  The package imports torch and numpy, never JAX and
nothing of ``repro``.
"""
from repro_torch.api import KernelKMeans, SolverConfig  # noqa: F401

__all__ = ["KernelKMeans", "SolverConfig"]
