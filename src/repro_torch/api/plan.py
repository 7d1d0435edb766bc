"""Solver-plan registry: map a resolved :class:`SolverConfig` point to an
executor.  Only ``"single"`` is registered in the port so far; every other
resolved point raises ``NotImplementedError`` naming the ROADMAP item that
ports it, and never runs another plan in its place.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

from repro_torch.api import executors as _ex
from repro_torch.api.config import SolverConfig


@dataclass(frozen=True)
class SolverSpec:
    """A registered execution strategy."""

    name: str
    matches: Callable[[SolverConfig], bool]
    build: Callable[..., "_ex.Executor"]     # (config, device) -> executor
    description: str = ""


class Plan(NamedTuple):
    """A resolved execution plan: the concrete config point (no ``auto``
    axes left) and the executor that runs it."""

    name: str
    config: SolverConfig
    executor: "_ex.Executor"


_REGISTRY: dict = {}

# resolved points the reference runs and the port does not yet, in the
# order they are checked: (predicate, what, ROADMAP item)
_NOT_PORTED = (
    (lambda c: c.distribution == "sharded", "the sharded plans",
     "Queue 1 item 12"),
    (lambda c: c.restarts > 1, "the multi-restart engine",
     "Queue 1 item 11"),
    (lambda c: c.cache == "precomputed", "the precomputed-Gram plan",
     "Queue 1 item 7"),
    (lambda c: c.cache == "lru", "the Gram tile cache plan",
     "Queue 1 item 9"),
)


def register_solver(name: str, *, matches, build, description: str = "",
                    overwrite: bool = False) -> None:
    """Register an execution strategy under ``name``."""
    if name in _REGISTRY and not overwrite:
        raise ValueError(f"solver {name!r} is already registered "
                         f"(registered: {list_solvers()})")
    _REGISTRY[name] = SolverSpec(name=name, matches=matches, build=build,
                                 description=description)


def list_solvers() -> list:
    """Registered solver names, in registration order."""
    return list(_REGISTRY)


def resolve_plan(config: SolverConfig, *, n: Optional[int] = None,
                 mesh=None, device="cuda",
                 solver: Optional[str] = None) -> Plan:
    """Resolve ``config``'s ``auto`` axes for (n, mesh, device) and build
    the executor of the matching registered solver (or of ``solver``, by
    name)."""
    resolved = config.resolve(n=n, mesh=mesh, device=device)
    if solver is not None:
        try:
            spec = _REGISTRY[solver]
        except KeyError:
            raise ValueError(f"unknown solver {solver!r} "
                             f"(registered: {list_solvers()})") from None
    else:
        matching = [s for s in _REGISTRY.values() if s.matches(resolved)]
        if not matching:
            for pred, what, item in _NOT_PORTED:
                if pred(resolved):
                    raise NotImplementedError(
                        f"{resolved.axes_repr()} resolves to {what}, which "
                        f"is not ported yet (ROADMAP {item})")
            raise NotImplementedError(
                f"no solver plan matches {resolved.axes_repr()}; "
                f"registered solvers: {list_solvers()}")
        spec = matching[-1]
    return Plan(name=spec.name, config=resolved,
                executor=spec.build(resolved, device))


register_solver(
    "single",
    matches=lambda c: (c.distribution == "single" and c.cache == "none"
                       and c.restarts == 1),
    build=_ex.SingleExecutor,
    description="plain Algorithm-2 fit, host-driven loop")
