"""Learning-rate schedules for mini-batch (kernel) k-means.

``beta``    — Schwartzman (2023): alpha_i^j = sqrt(b_i^j / b).  Does NOT
              decay to zero; the paper's theory (Theorem 1) requires it.
``sklearn`` — Sculley (2010) / sklearn running means:
              alpha_i^j = b_i^j / (c_j + b_i^j).
"""
from __future__ import annotations

import torch


def beta_rate(batch_counts: torch.Tensor, total_counts: torch.Tensor,
              batch_size: int) -> torch.Tensor:
    del total_counts
    return torch.sqrt(batch_counts.to(torch.float32) / batch_size)


def sklearn_rate(batch_counts: torch.Tensor, total_counts: torch.Tensor,
                 batch_size: int) -> torch.Tensor:
    del batch_size
    bc = batch_counts.to(torch.float32)
    denom = torch.clamp(total_counts.to(torch.float32) + bc, min=1.0)
    return bc / denom


RATES = {"beta": beta_rate, "sklearn": sklearn_rate}


def get_rate(name: str):
    try:
        return RATES[name]
    except KeyError:
        raise ValueError(
            f"unknown learning rate {name!r}; options {list(RATES)}") from None
