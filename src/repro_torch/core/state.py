"""Fixed-shape truncated-center state for Algorithm 2.

Each center owns a ring buffer of W = tau + b point slots (see the JAX
package's ``repro.core.state`` for the paper's argument).  Invariants:

* a slot with ``coef == 0`` is empty; its ``idx`` is 0 (a valid gather
  index — the zero coefficient nullifies the contribution);
* ``sqnorm[j] == <C_j, C_j>`` in feature space at all times.

Field names and dtypes are the JAX package's, so a state crosses between
the two packages as numpy arrays (:func:`state_from_numpy` /
:func:`state_to_numpy`) and through save format 3.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.kernel_fns import KernelFn, kernel_diag, to_tensor

_DTYPES = dict(idx=torch.int32, coef=torch.float32, head=torch.int32,
               sqnorm=torch.float32, counts=torch.float32, step=torch.int32)


class CenterState(NamedTuple):
    idx: torch.Tensor      # (k, W) int32 — indices into the dataset
    coef: torch.Tensor     # (k, W) f32   — coefficient on phi(X[idx])
    head: torch.Tensor     # (k,)   int32 — next ring write position
    sqnorm: torch.Tensor   # (k,)   f32   — <C_j, C_j>
    counts: torch.Tensor   # (k,)   f32   — lifetime #points assigned
    step: torch.Tensor     # ()     int32

    @property
    def k(self) -> int:
        return self.idx.shape[0]

    @property
    def window(self) -> int:
        return self.idx.shape[1]


def init_state(x: torch.Tensor, center_idx: torch.Tensor, kernel: KernelFn,
               window: int) -> CenterState:
    """Centers start as single data points (k-means++ / random init picks
    indices), occupying slot 0 with coefficient 1."""
    k = center_idx.shape[0]
    dev = x.device
    idx = torch.zeros((k, window), dtype=torch.int32, device=dev)
    idx[:, 0] = center_idx.to(device=dev, dtype=torch.int32)
    coef = torch.zeros((k, window), dtype=torch.float32, device=dev)
    coef[:, 0] = 1.0
    rows = x[center_idx.to(device=dev, dtype=torch.int64)]
    return CenterState(
        idx=idx,
        coef=coef,
        head=torch.ones((k,), dtype=torch.int32, device=dev),
        sqnorm=kernel_diag(kernel, rows).to(torch.float32),
        counts=torch.zeros((k,), dtype=torch.float32, device=dev),
        step=torch.zeros((), dtype=torch.int32, device=dev),
    )


def window_size(batch_size: int, tau: int) -> int:
    """W = tau + b: a full ring always retains >= tau points newer than any
    evicted point (Lemma 3's requirement)."""
    return tau + batch_size


def state_from_numpy(arrays, device="cpu") -> CenterState:
    """A :class:`CenterState` on ``device`` from the JAX package's state (a
    ``CenterState`` of numpy / JAX arrays, or any mapping or sequence of
    its six fields in order), with the reference dtypes enforced."""
    if isinstance(arrays, dict):
        vals = [arrays[f] for f in CenterState._fields]
    else:
        vals = list(arrays)
    return CenterState(*(
        to_tensor(v, device=device, dtype=_DTYPES[f])
        for f, v in zip(CenterState._fields, vals)))


def state_to_numpy(state: CenterState) -> CenterState:
    """The state as host numpy arrays of the reference dtypes — what the
    JAX package's ``CenterState(*...)`` takes."""
    return CenterState(*(v.detach().cpu().numpy() for v in state))
