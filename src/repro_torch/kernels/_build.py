"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, named after a hash of the sources and
flags, under ``build/repro_torch_kernels/`` at the root of the checkout, and
loaded with ``ctypes``.  The build happens at the first launch of a kernel
(or an explicit :func:`build`), never at import, so the package imports on
machines without CUDA.  A finished library is reused by later processes.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures of the entry points (csrc/center_dots.cu)
_SIGNATURES = {
    "rk_streaming_assign": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                            _I, _F, _F, _I, _P, _P, _P],
    "rk_batch_center_dots": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                             _F, _I, _P, _P],
}

_LIB = None
BUILD_INFO: dict = {}       # seconds, library path and nvcc's log of the
#                             build this process ran or reused


class LaunchCounter:
    """A plain count of one kernel's launches: its wrapper adds one where
    it launches the kernel and nowhere else."""

    def __init__(self, name: str):
        self.name = name
        self.n = 0

    def reset(self) -> None:
        self.n = 0


def _sources():
    return sorted(list(_CSRC.glob("*.cu")) + list(_CSRC.glob("*.cuh")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (put the CUDA toolkit's bin on PATH "
                       "or set CUDA_HOME); the port's CUDA kernels are "
                       "built from csrc/ at first use")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"librepro_torch_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless a library of the same hash exists; returns
    its path.  ``BUILD_INFO`` records the seconds and nvcc's log."""
    out = library_path()
    if out.exists():
        BUILD_INFO.update(path=str(out), seconds=0.0, log="(reused)")
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(s) for s in _sources() if s.suffix == ".cu"]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)       # atomic: concurrent builders never see half
    BUILD_INFO.update(path=str(out), seconds=secs,
                      log=proc.stdout + proc.stderr)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built at first call), with ``argtypes``
    and ``restype`` of every entry point set."""
    global _LIB
    if _LIB is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        handle.rk_error_string.argtypes = [ctypes.c_int]
        handle.rk_error_string.restype = ctypes.c_char_p
        _LIB = handle
    return _LIB


def require(t, name: str, shape: tuple, dtype, device) -> None:
    """Raise unless ``t`` is a contiguous tensor of ``shape`` and ``dtype``
    on ``device`` — what a kernel takes through a raw pointer."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def operands(what: str, xb, sup, coef, *extra):
    """The checks and operands K1 and K2 share.  Raise unless ``xb`` (b, d),
    ``sup`` (k, W, d), ``coef`` (k, W) and each ``(tensor, name, shape)`` of
    ``extra`` are contiguous f32 on ``xb``'s CUDA device with no empty
    extent; return the row norms (xsq (b,), supsq (k, W)) the kernel takes,
    computed in torch as the Pallas wrappers compute them in XLA."""
    import torch

    dev, f32 = xb.device, torch.float32
    if dev.type != "cuda":
        raise ValueError(f"{what}: device {dev} is neither cpu nor cuda")
    b, d = xb.shape
    k, w, _ = sup.shape
    for t, name, shape in ((xb, "xb", (b, d)), (sup, "sup", (k, w, d)),
                           (coef, "coef", (k, w)), *extra):
        require(t, name, shape, f32, dev)
    if 0 in (b, k, w, d):
        raise ValueError(f"{what}: empty shape b={b} k={k} W={w} d={d}")
    with torch.cuda.device(dev):
        return torch.sum(xb * xb, dim=-1), torch.sum(sup * sup, dim=-1)


def kind_code(kind: str, p2: int) -> int:
    """The C enum of a kernel kind (csrc/center_dots.cu)."""
    codes = {"gaussian": 0, "linear": 1, "polynomial": 2}
    if kind not in codes:
        raise ValueError(f"kind={kind!r} (expected one of {list(codes)})")
    if kind == "polynomial" and p2 < 0:
        raise ValueError(f"polynomial degree {p2} < 0 is not supported")
    return codes[kind]


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if rc != 0:
        msg = lib().rk_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
