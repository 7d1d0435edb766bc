"""Kernel functions K(x, y) = <phi(x), phi(y)> over torch tensors.

Every kernel is a frozen dataclass of Python scalars, dispatched through
``kernel_cross`` / ``kernel_diag``.  Data is always an ``(n, d)`` float
tensor; for :class:`Precomputed` kernels (k-nn / heat graphs) the "data" is
an ``(n, 1)`` tensor of row indices into the precomputed Gram matrix, which
keeps every algorithm in :mod:`repro_torch.core` agnostic to the kernel
type.  Names and params of the registry match the JAX package's, so a saved
``(name, params)`` spec resolves to the same kernel in either package.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Union

import numpy as np
import torch


@dataclass(frozen=True)
class Gaussian:
    """K(x, y) = exp(-||x - y||^2 / kappa).  Normalized: gamma = 1."""

    kappa: float


@dataclass(frozen=True)
class Laplacian:
    """K(x, y) = exp(-||x - y||_1 / kappa).  Normalized: gamma = 1."""

    kappa: float


@dataclass(frozen=True)
class Polynomial:
    """K(x, y) = (x . y / scale + bias)^degree, integer degree."""

    bias: float
    scale: float
    degree: int


@dataclass(frozen=True)
class Linear:
    """K(x, y) = x . y  (plain k-means in disguise when used everywhere)."""


@dataclass(frozen=True, eq=False)
class Precomputed:
    """Explicit Gram matrix (e.g. k-nn kernel D^-1 A D^-1, heat kernel).

    Data rows are (float) indices into ``gram``."""

    gram: torch.Tensor  # (n, n)


def to_tensor(v, **kw) -> torch.Tensor:
    """``v`` as a tensor (``kw``: device / dtype): tensors are moved, other
    array-likes copied — ``torch.as_tensor`` warns on the read-only numpy
    views that JAX arrays give."""
    if isinstance(v, torch.Tensor):
        return v.to(**kw)
    return torch.tensor(np.asarray(v), **kw)


KernelFn = Union[Gaussian, Laplacian, Polynomial, Linear, Precomputed]

# Name registry: ``SolverConfig(kernel="rbf")`` strings resolve to kernel
# instances through these factories.
_KERNEL_FACTORIES: dict = {}


def register_kernel_factory(name: str, factory, *,
                            overwrite: bool = False) -> None:
    """Register a kernel *name* -> factory.  Duplicate names are an error
    unless ``overwrite``."""
    key = name.lower()
    if key in _KERNEL_FACTORIES and not overwrite:
        raise ValueError(
            f"kernel name {name!r} is already registered "
            f"(registered names: {', '.join(list_kernels())}); pick a "
            "distinct name or pass overwrite=True to replace it")
    _KERNEL_FACTORIES[key] = factory


def list_kernels() -> list:
    """Sorted names accepted by :func:`make_kernel`."""
    return sorted(_KERNEL_FACTORIES)


def make_kernel(spec, **params):
    """Resolve a kernel spec: a string name goes through the factory
    registry (with ``params`` forwarded); a kernel instance passes through
    unchanged (``params`` must then be empty)."""
    if not isinstance(spec, str):
        if params:
            raise ValueError("kernel_params given with an already-built "
                             f"kernel instance ({type(spec).__name__})")
        return spec
    try:
        factory = _KERNEL_FACTORIES[spec.lower()]
    except KeyError:
        raise ValueError(f"unknown kernel {spec!r}; registered kernels: "
                         f"{list_kernels()}") from None
    return factory(**params)


def _f32(v) -> float:
    """A scalar param rounded to float32, as the reference stores it."""
    return float(np.float32(v))


def kernel_spec(k: KernelFn):
    """``(name, params)`` round-trippable through :func:`make_kernel` — the
    serialization hook ``KernelKMeans.save`` uses.  Data-carrying kernels
    (Precomputed) raise."""
    if isinstance(k, Gaussian):
        return "rbf", {"kappa": _f32(k.kappa)}
    if isinstance(k, Laplacian):
        return "laplacian", {"kappa": _f32(k.kappa)}
    if isinstance(k, Polynomial):
        return "polynomial", {"bias": _f32(k.bias), "scale": _f32(k.scale),
                              "degree": int(k.degree)}
    if isinstance(k, Linear):
        return "linear", {}
    raise ValueError(f"kernel {type(k).__name__} has no serializable spec "
                     "(data-carrying kernels cannot be saved by name)")


def _sq_dists(x: torch.Tensor, y: torch.Tensor, yy=None) -> torch.Tensor:
    """Pairwise squared Euclidean distances, (m, d) x (n, d) -> (m, n),
    by the |x|^2 + |y|^2 - 2 x.y expansion, clamped at zero against
    round-off.  ``yy``: optionally precomputed ``sum(y*y)[None, :]``."""
    xx = torch.sum(x * x, dim=-1)[:, None]
    if yy is None:
        yy = torch.sum(y * y, dim=-1)[None, :]
    xy = x @ y.T
    return torch.clamp(xx + yy - 2.0 * xy, min=0.0)


def _rows(k: Precomputed, x: torch.Tensor) -> torch.Tensor:
    return x[:, 0].to(torch.int64)


def kernel_cross(k: KernelFn, x: torch.Tensor, y: torch.Tensor):
    """Full cross-kernel matrix K(x_i, y_j), shape (m, n)."""
    if isinstance(k, Gaussian):
        return torch.exp(-_sq_dists(x, y) / k.kappa)
    if isinstance(k, Laplacian):
        l1 = torch.sum(torch.abs(x[:, None, :] - y[None, :, :]), dim=-1)
        return torch.exp(-l1 / k.kappa)
    if isinstance(k, Polynomial):
        return (x @ y.T / k.scale + k.bias) ** k.degree
    if isinstance(k, Linear):
        return x @ y.T
    if isinstance(k, Precomputed):
        return k.gram[_rows(k, x)][:, _rows(k, y)]
    raise TypeError(f"unknown kernel {type(k)}")


def kernel_diag(k: KernelFn, x: torch.Tensor) -> torch.Tensor:
    """K(x_i, x_i), shape (m,) — never forms the cross matrix."""
    if isinstance(k, (Gaussian, Laplacian)):
        return torch.ones(x.shape[0], dtype=x.dtype, device=x.device)
    if isinstance(k, Polynomial):
        return (torch.sum(x * x, dim=-1) / k.scale + k.bias) ** k.degree
    if isinstance(k, Linear):
        return torch.sum(x * x, dim=-1)
    if isinstance(k, Precomputed):
        xi = _rows(k, x)
        return k.gram[xi, xi]
    raise TypeError(f"unknown kernel {type(k)}")


def diag_is_one(k: KernelFn) -> bool:
    """Does this kernel advertise K(x, x) == 1 for all x?  True for the
    normalized kernels (Gaussian / Laplacian)."""
    return isinstance(k, (Gaussian, Laplacian))


def diag_of(k: KernelFn, x: torch.Tensor) -> torch.Tensor:
    """:func:`kernel_diag` with the normalized-kernel fast path."""
    if diag_is_one(k):
        return torch.ones(x.shape[0], dtype=x.dtype, device=x.device)
    return kernel_diag(k, x)


def is_index_data(k: KernelFn) -> bool:
    """Does this kernel consume (n, 1) row-INDEX data instead of
    coordinates?"""
    return isinstance(k, Precomputed)


def cross_fixed_y(k: KernelFn, y: torch.Tensor):
    """``cross(x) == kernel_cross(k, x, y)`` with the y-side squared norms
    hoisted out of chunk scans; same ops on the same data, so results are
    bit-identical to the unhoisted path."""
    if isinstance(k, Gaussian):
        yy = torch.sum(y * y, dim=-1)[None, :]
        return lambda x: torch.exp(-_sq_dists(x, y, yy=yy) / k.kappa)
    return lambda x: kernel_cross(k, x, y)


def gamma_of(k: KernelFn, x: torch.Tensor) -> torch.Tensor:
    """gamma = max_x ||phi(x)|| = sqrt(max_x K(x, x)) — Theorem 1's
    parameter."""
    return torch.sqrt(torch.max(kernel_diag(k, x)))


# Built-in kernels under their config names ("rbf" is the sklearn-style
# alias for the paper's normalized Gaussian); scalar params are float32
# values, as in the reference, so specs round-trip to the same numbers.
register_kernel_factory("rbf", lambda kappa=1.0: Gaussian(kappa=_f32(kappa)))
register_kernel_factory("gaussian",
                        lambda kappa=1.0: Gaussian(kappa=_f32(kappa)))
register_kernel_factory("laplacian",
                        lambda kappa=1.0: Laplacian(kappa=_f32(kappa)))
register_kernel_factory("polynomial", lambda bias=1.0, scale=1.0, degree=3:
                        Polynomial(bias=_f32(bias), scale=_f32(scale),
                                   degree=int(degree)))
register_kernel_factory("linear", lambda: Linear())
register_kernel_factory("precomputed", lambda gram: Precomputed(
    gram=to_tensor(gram)))


def median_sq_dist_heuristic(x: torch.Tensor,
                             sample: int = 1024) -> torch.Tensor:
    """kappa heuristic of Wang et al. (2019): median pairwise squared
    distance over a subsample, the zero diagonal excluded.  The count of
    off-diagonal entries is even, so the median is the mean of the two
    middle values (``jnp.nanmedian``'s convention); ``torch.nanmedian``
    would return the lower one, so this takes the linear 0.5-quantile."""
    s = x[: min(sample, x.shape[0])]
    d2 = _sq_dists(s, s)
    m = d2 + torch.diag(torch.full((s.shape[0],), float("nan"),
                                   dtype=d2.dtype, device=d2.device))
    return torch.nanquantile(m.reshape(-1), 0.5)
