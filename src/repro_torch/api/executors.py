"""Solver executors — the plan lowerings onto the fit-loop core
(:mod:`repro_torch.core.loop`).  Only the ``single`` family is ported: the
paper's plain Algorithm-2 fit on one device.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.api import keys as api_keys
from repro_torch.api.config import SolverConfig
from repro_torch.core import init as init_lib
from repro_torch.core.kernel_fns import to_tensor
from repro_torch.core.loop import (  # noqa: F401  (re-exported as in the
    # reference's executors module)
    FitCarry, FitOutcome, carry_of, outcome_from_carry,
)
from repro_torch.core.minibatch import (
    assign_chunked, center_distances_chunked, host_fit_loop, make_step,
)
from repro_torch.core.state import init_state, window_size


class Executor:
    """Base class: holds (config, device), resolves the kernel and the
    Algorithm-2 statics once, and provides the serving side (predict /
    distances from the support-point view of the fitted state)."""

    name = "?"
    supports_partial_fit = False

    def __init__(self, config: SolverConfig, device):
        self.config = config
        self.device = torch.device(device)
        self.kernel = config.make_kernel_fn()
        self.mb = config.mb_config(self.device)

    def fit(self, x, key, init_idx=None, sample_weight=None,
            always_split: bool = True, **kw) -> FitOutcome:
        raise NotImplementedError

    def resume(self, x, outcome: FitOutcome, iters: int) -> FitOutcome:
        raise NotImplementedError(
            f"plan {self.name!r} does not support partial_fit resumption")

    def serving_tuple(self, outcome: FitOutcome, x):
        """``(kernel, sup, coef, sqnorm)`` with ``sup`` the (k*W, d)
        support coordinates."""
        state = outcome.state
        sup = x[state.idx.reshape(-1).to(torch.int64)]
        return self.kernel, sup, state.coef, state.sqnorm

    def predict(self, outcome: FitOutcome, x, xq, chunk: int = 4096):
        kern, sup, coef, sqnorm = self.serving_tuple(outcome, x)
        return assign_chunked(kern, coef, sqnorm, sup, xq, chunk)

    def distances(self, outcome: FitOutcome, x, xq, chunk: int = 4096):
        kern, sup, coef, sqnorm = self.serving_tuple(outcome, x)
        return center_distances_chunked(kern, coef, sqnorm, sup, xq, chunk)


class SingleExecutor(Executor):
    """cache='none', distribution='single', restarts=1 — the paper's plain
    Algorithm-2 fit, driven from the host.  ``jit=True`` has no on-device
    counterpart yet (a CUDA graph of the step), so it runs the same host
    loop and fills ``history``."""

    name = "single"
    supports_partial_fit = True

    def __init__(self, config: SolverConfig, device):
        super().__init__(config, device)
        if config.sampler != "iid":
            raise NotImplementedError(
                f"sampler={config.sampler!r} is not ported yet (only 'iid'; "
                "the nested sampler is ROADMAP Queue 1 item 9)")
        self._step = make_step(self.kernel, self.mb)

    def _loop(self, x, mb, state, key, probs=None, step0=0):
        step = self._step
        return host_fit_loop(
            lambda st, bidx: step(st, x, bidx), x.shape[0], mb, state, key,
            probs=probs, early_stop=self.config.early_stop, step0=step0,
            prefetch=self.config.prefetch, device=x.device)

    def fit(self, x, key, init_idx=None, sample_weight=None,
            always_split: bool = True, max_iters: Optional[int] = None,
            **kw) -> FitOutcome:
        mb = self.mb if max_iters is None \
            else self.mb._replace(max_iters=max_iters)
        init_key, fit_key = api_keys.derive_fit_keys(
            key, init_idx is not None, always_split)
        if init_idx is None:
            init_idx = init_lib.draw_init(init_key, x, mb.k, self.kernel,
                                          self.config.init)
        init_idx = to_tensor(init_idx, device=x.device)
        probs = None
        if sample_weight is not None:
            probs = to_tensor(sample_weight, dtype=torch.float32)
            probs = probs / torch.sum(probs)
        state0 = init_state(x, init_idx, self.kernel,
                            window_size(mb.batch_size, mb.tau))
        state, history, out_key = self._loop(x, mb, state0, fit_key, probs)
        return FitOutcome(state=state, iters=len(history), history=history,
                          key=out_key, steps=len(history))

    def resume(self, x, outcome: FitOutcome, iters: int) -> FitOutcome:
        if outcome.key is None:
            raise ValueError("outcome carries no fit key; cannot resume")
        prev = outcome.steps if outcome.steps is not None \
            else int(outcome.iters)
        state, history, out_key = self._loop(
            x, self.mb._replace(max_iters=iters), outcome.state, outcome.key,
            step0=prev)
        return FitOutcome(state=state, iters=len(history), history=history,
                          key=out_key, steps=prev + len(history))
