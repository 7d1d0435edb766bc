"""repro_torch.api — the front door of the port: one estimator
(:class:`KernelKMeans`) configured by one :class:`SolverConfig` whose fields
are the JAX package's.  Public names resolve lazily (PEP 562) so
``repro_torch.core`` can import :mod:`repro_torch.api.keys` without a
cycle."""
from __future__ import annotations

__all__ = [
    "KernelKMeans",
    "SolverConfig",
    "FitOutcome",
    "Plan",
    "SolverSpec",
    "register_solver",
    "list_solvers",
    "resolve_plan",
    "list_kernels",
    "make_kernel",
    "register_kernel_factory",
    "keys",
]

_EXPORTS = {
    "KernelKMeans": "repro_torch.api.estimator",
    "SolverConfig": "repro_torch.api.config",
    "FitOutcome": "repro_torch.core.loop",
    "Plan": "repro_torch.api.plan",
    "SolverSpec": "repro_torch.api.plan",
    "register_solver": "repro_torch.api.plan",
    "list_solvers": "repro_torch.api.plan",
    "resolve_plan": "repro_torch.api.plan",
    "list_kernels": "repro_torch.core.kernel_fns",
    "make_kernel": "repro_torch.core.kernel_fns",
    "register_kernel_factory": "repro_torch.core.kernel_fns",
    "keys": "repro_torch.api.keys",
}


def __getattr__(name: str):
    try:
        modname = _EXPORTS[name]
    except KeyError:
        raise AttributeError(f"module 'repro_torch.api' has no attribute "
                             f"{name!r}") from None
    import importlib

    if name == "keys":
        value = importlib.import_module(modname)
    else:
        value = getattr(importlib.import_module(modname), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
