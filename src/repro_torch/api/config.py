"""``SolverConfig`` — one frozen dataclass of orthogonal execution axes.

The fields, their order and their defaults are exactly those of the JAX
package's ``repro.api.config.SolverConfig``, so a config saved by either
package loads in the other.  Axis points that the port does not run yet are
accepted here and refused by the plan resolver (``api/plan.py``) or the
step builder, each naming the ROADMAP item that ports it.

The device is not a config field (the saved config must stay loadable by
the JAX package): ``KernelKMeans(..., device=...)`` holds it, and
``resolve`` / ``resolved_step`` / ``mb_config`` take it as an argument,
``None`` meaning ``"cuda"`` as in the estimator.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional, Tuple

from repro_torch.core.kernel_fns import KernelFn, Precomputed, make_kernel
from repro_torch.core.minibatch import MBConfig

_CACHE_VALUES = ("none", "lru", "precomputed", "auto")
_DISTRIBUTION_VALUES = ("single", "sharded", "auto")
_SAMPLER_VALUES = ("iid", "nested")
_STEP_VALUES = ("composed", "fused", "auto")
_PRECISION_VALUES = ("f32", "bf16")

# cache='auto' precomputes the full Gram while n^2 stays under this many
# elements (f32: 64 MB), as in the reference.
PRECOMPUTED_AUTO_MAX_ELEMS = 16 * 2 ** 20


def _device_type(device) -> str:
    """``None`` means ``"cuda"``, as everywhere in the port."""
    if device is None:
        return "cuda"
    return device.type if hasattr(device, "type") else \
        str(device).split(":")[0]


@dataclass(frozen=True)
class SolverConfig:
    """Everything a :class:`repro_torch.api.KernelKMeans` fit needs."""

    # ---- Algorithm 2 statics (mirrors core.minibatch.MBConfig) ----------
    k: int = 8
    batch_size: int = 256
    tau: int = 128
    rate: str = "beta"
    sqnorm_mode: str = "recompute"
    eval_mode: str = "direct"
    epsilon: float = 1e-4
    max_iters: int = 200
    use_pallas: bool = False
    compute_dtype: str = "float32"

    # ---- kernel ---------------------------------------------------------
    kernel: Any = "rbf"                  # registry name or kernel instance
    kernel_params: Any = ()              # mapping / item-tuple for names

    # ---- fit behaviour --------------------------------------------------
    init: str = "kmeans++"               # 'kmeans++' | 'random'
    early_stop: bool = True

    # ---- execution axes -------------------------------------------------
    cache: str = "auto"
    distribution: str = "auto"
    restarts: int = 1
    sampler: str = "iid"
    jit: bool = True
    step: str = "auto"
    precision: str = "f32"
    prefetch: bool = True

    # ---- cache knobs ----------------------------------------------------
    cache_tile: int = 256
    cache_capacity: int = 16
    cache_dtype: str = "float32"

    # ---- nested-sampler knobs -------------------------------------------
    reuse: float = 0.5
    refresh: int = 8

    # ---- distribution knobs ---------------------------------------------
    data_axes: Tuple[str, ...] = ("data",)
    model_axis: str = "model"

    # ---- multi-restart knobs --------------------------------------------
    restart_axis: Optional[str] = None
    eval_batch_size: Optional[int] = None
    share_eval_gram: Optional[bool] = None

    # ---- landmark compression axis: only "off" is ported ----------------
    compress: Any = "off"

    def __post_init__(self):
        if self.cache not in _CACHE_VALUES:
            raise ValueError(f"cache={self.cache!r} not in {_CACHE_VALUES}")
        if self.distribution not in _DISTRIBUTION_VALUES:
            raise ValueError(f"distribution={self.distribution!r} not in "
                             f"{_DISTRIBUTION_VALUES}")
        if self.sampler not in _SAMPLER_VALUES:
            raise ValueError(f"sampler={self.sampler!r} not in "
                             f"{_SAMPLER_VALUES}")
        if self.step not in _STEP_VALUES:
            raise ValueError(f"step={self.step!r} not in {_STEP_VALUES}")
        if self.precision not in _PRECISION_VALUES:
            raise ValueError(f"precision={self.precision!r} not in "
                             f"{_PRECISION_VALUES}")
        if self.restarts < 1:
            raise ValueError("restarts must be >= 1")
        if self.init not in ("kmeans++", "random"):
            raise ValueError(f"init={self.init!r} (expected 'kmeans++' or "
                             "'random')")
        kp = self.kernel_params
        if not isinstance(kp, tuple):
            kp = tuple(sorted(dict(kp).items()))
        object.__setattr__(self, "kernel_params", kp)
        object.__setattr__(self, "data_axes", tuple(self.data_axes))
        if self.compress is None or self.compress == () or \
                self.compress == "off":
            object.__setattr__(self, "compress", "off")
        else:
            raise NotImplementedError(
                f"compress={self.compress!r}: the landmark-compression axis "
                "is not ported yet (only 'off'; ROADMAP Queue 1 item 8)")

    # ------------------------------------------------------------------ --
    def replace(self, **changes) -> "SolverConfig":
        return dataclasses.replace(self, **changes)

    def resolved_step(self, device=None) -> str:
        """The concrete step implementation.  ``step='auto'`` picks the
        streaming fused step where its kernel runs natively — a CUDA device
        — under the paper-faithful recompute/direct modes; the composed
        chain everywhere else."""
        if self.step != "auto":
            return self.step
        if self.sqnorm_mode != "recompute" or self.eval_mode != "direct":
            return "composed"
        return "fused" if _device_type(device) == "cuda" else "composed"

    def mb_config(self, device=None) -> MBConfig:
        """The Algorithm-2 static config this point runs with.  The bf16
        precision axis is not ported yet and raises."""
        if self.precision == "bf16" or self.compute_dtype != "float32":
            raise NotImplementedError(
                f"precision={self.precision!r} / compute_dtype="
                f"{self.compute_dtype!r}: the port runs f32 only so far "
                "(ROADMAP Queue 1 item 8)")
        return MBConfig(k=self.k, batch_size=self.batch_size, tau=self.tau,
                        rate=self.rate, sqnorm_mode=self.sqnorm_mode,
                        eval_mode=self.eval_mode, epsilon=self.epsilon,
                        max_iters=self.max_iters,
                        use_pallas=self.use_pallas,
                        compute_dtype=self.compute_dtype,
                        step=self.resolved_step(device),
                        compress=None)

    def make_kernel_fn(self) -> KernelFn:
        """Resolve the kernel axis to a kernel instance."""
        return make_kernel(self.kernel, **dict(self.kernel_params))

    def resolve(self, n: Optional[int] = None, mesh=None,
                device=None) -> "SolverConfig":
        """Pin the ``auto`` axes for a concrete dataset size / mesh /
        device, as the reference does.  Idempotent."""
        changes = {}
        if self.distribution == "auto":
            sharded = (mesh is not None
                       and self.model_axis in getattr(mesh, "axis_names", ()))
            changes["distribution"] = "sharded" if sharded else "single"
        if self.cache == "auto":
            dist = changes.get("distribution", self.distribution)
            index_data = (not isinstance(self.kernel, str)
                          and isinstance(self.kernel, Precomputed))
            if index_data:
                changes["cache"] = "none"
            elif (dist == "single" and self.restarts == 1 and n is not None
                    and n * n <= PRECOMPUTED_AUTO_MAX_ELEMS):
                changes["cache"] = "precomputed"
            elif dist == "single" and self.restarts == 1 \
                    and self.sampler == "nested":
                changes["cache"] = "lru"
            else:
                changes["cache"] = "none"
        if self.restart_axis is None and self.restarts > 1 and \
                changes.get("distribution", self.distribution) == "sharded":
            changes["restart_axis"] = "restart"
        if self.step == "auto":
            changes["step"] = self.resolved_step(device)
        return self.replace(**changes) if changes else self

    def axes_repr(self) -> str:
        """Compact human string of the execution point."""
        return (f"cache={self.cache!r} distribution={self.distribution!r} "
                f"restarts={self.restarts} sampler={self.sampler!r} "
                f"jit={self.jit} step={self.step!r} "
                f"precision={self.precision!r}")


def field_names() -> Tuple[str, ...]:
    """Ordered SolverConfig field names (equal to the reference's)."""
    return tuple(f.name for f in dataclasses.fields(SolverConfig))
