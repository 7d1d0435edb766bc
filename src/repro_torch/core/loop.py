"""The fit-loop core: what a fit produced (:class:`FitOutcome`), the
resumable part of it (:class:`FitCarry`), the precision axis, and the
host-driven early-stopped driver with its one-deep prefetch — the port of
the JAX package's ``repro.core.loop``.

The reference also has an on-device driver (one compiled
``lax.while_loop``); its counterpart, a CUDA graph of the step, is not
ported yet, so every plan here runs :func:`drive_fit_loop`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, NamedTuple, Optional

import torch


@dataclasses.dataclass
class FitOutcome:
    """What a plan's ``fit`` produced."""

    state: Any                              # CenterState
    iters: int
    history: Optional[List[dict]] = None    # host-driven plans
    key: Optional[torch.Generator] = None   # carried fit-stream key
    steps: int = 0                          # completed host-loop steps


class FitCarry(NamedTuple):
    """The resumable part of a fit — everything ``partial_fit`` needs to
    continue the batch stream exactly, and so everything
    ``KernelKMeans.save`` round-trips."""

    state: Any                    # CenterState
    key: torch.Generator          # carried fit-stream key
    steps: Optional[int]          # host-loop cursor
    iters: int


def carry_of(outcome: Optional[FitOutcome]) -> Optional[FitCarry]:
    """The resume carry of an outcome, or None when it cannot resume (no
    carried key)."""
    if outcome is None or outcome.key is None:
        return None
    return FitCarry(state=outcome.state, key=outcome.key,
                    steps=outcome.steps, iters=int(outcome.iters))


def outcome_from_carry(carry: FitCarry) -> FitOutcome:
    """Rehydrate a deserialized carry into a resumable outcome."""
    return FitOutcome(state=carry.state, iters=carry.iters, key=carry.key,
                      steps=carry.steps)


def loop_config(mb, early_stop: bool, max_iters=None):
    """The MBConfig an early-stopped loop runs with: ``early_stop=False``
    lowers to an epsilon no improvement can undercut."""
    if max_iters is not None:
        mb = mb._replace(max_iters=max_iters)
    if not early_stop:
        mb = mb._replace(epsilon=float("-inf"))
    return mb


class PrecisionPlan(NamedTuple):
    """Resolved kernel-eval precision for one (kernel, config) point.  This
    slice is f32 only: ``cdt`` is always None (the identity)."""

    cdt: Any
    index_data: bool
    tag: str


def precision_plan(kernel, cfg) -> PrecisionPlan:
    """The precision-axis site every step builder resolves through.  The
    bf16 axis is not ported yet and raises."""
    from repro_torch.core.kernel_fns import is_index_data

    if cfg.compute_dtype != "float32":
        raise NotImplementedError(
            f"compute_dtype={cfg.compute_dtype!r}: the port runs f32 only "
            "so far (bf16 kernel evaluations are a later slice, ROADMAP "
            "Queue 1 item 8)")
    return PrecisionPlan(cdt=None, index_data=is_index_data(kernel),
                         tag="f32")


def drive_fit_loop(dispatch, draw, cursor, *, max_iters: int,
                   epsilon: float, early_stop: bool = True,
                   prefetch: bool = False, step0: int = 0,
                   stage=lambda item: item):
    """The host-driven early-stopped fit loop.

    Per iteration: ``draw(cursor, i) -> (cursor', item)`` produces the next
    batch (``item=None`` ends the loop); ``dispatch(item) -> StepInfo``
    issues the device step (asynchronous — state threads through the
    caller's closure); the loop then blocks on ``float(info.improvement)``
    and stops early when it drops below ``epsilon``.  ``step0`` offsets the
    iteration counter (``partial_fit`` resumption).  Returns
    ``(history, cursor)``.

    ``prefetch``: iteration i+1's item is drawn (and staged on the device by
    ``stage``) after dispatching step i but before blocking on its
    improvement, so the draw and the copy overlap the device step.  The
    drawn values and the returned cursor are those of the blocking path:
    an early stop discards the prefetched item without advancing the
    cursor.  Results are bit-identical either way."""
    history = []
    end = step0 + max_iters
    pending = None
    for i in range(step0, end):
        cur, item = pending if pending is not None else draw(cursor, i)
        pending = None
        if item is None:
            break
        info = dispatch(item)                 # async dispatch
        if prefetch and i + 1 < end:
            nxt_cur, nxt = draw(cur, i + 1)   # overlaps the device step
            if nxt is not None:
                pending = (nxt_cur, stage(nxt))
        imp = float(info.improvement)         # host sync point
        cursor = cur
        history.append(dict(step=i, f_before=float(info.f_before),
                            f_after=float(info.f_after), improvement=imp))
        if early_stop and imp < epsilon:
            break
    return history, cursor
