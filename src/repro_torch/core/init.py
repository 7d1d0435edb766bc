"""Center initialization over a ``torch.Generator``.

Kernel k-means++ (Arthur & Vassilvitskii 2007, run in feature space): pick
the first center uniformly, then sample each next center with probability
proportional to the squared feature-space distance to the closest chosen
center, d^2(x, c) = K(x,x) + K(c,c) - 2 K(x,c).  All functions return
(k,) int32 center INDICES into x.  Random draws are made on the CPU from
the generator; distances are computed on x's device.
"""
from __future__ import annotations

import torch

from repro_torch.core.kernel_fns import KernelFn, kernel_cross, kernel_diag


def d2_probabilities(mind: torch.Tensor) -> torch.Tensor:
    """The D^2 sampling distribution over n points, with the reference's
    guard against an all-zero distance vector (duplicate data): uniform."""
    n = mind.shape[0]
    total = torch.sum(mind)
    return torch.where(total > 0, mind / torch.clamp(total, min=1e-30),
                       torch.full_like(mind, 1.0 / n))


def _d2_steps(x: torch.Tensor, k: int, kernel: KernelFn, first: int, pick):
    """The k-means++ loop with the next-center draw left to
    ``pick(p) -> index``: returns the (k,) int32 chosen indices."""
    diag = kernel_diag(kernel, x)                       # (n,) = K(x,x)

    def dist_to(i):
        cross = kernel_cross(kernel, x, x[i:i + 1])[:, 0]
        return torch.clamp(diag + diag[i] - 2.0 * cross, min=0.0)

    chosen = [first]
    mind = dist_to(first)
    for _ in range(1, k):
        nxt = int(pick(d2_probabilities(mind)))
        chosen.append(nxt)
        mind = torch.minimum(mind, dist_to(nxt))
    return torch.tensor(chosen, dtype=torch.int32, device=x.device)


def kmeans_plus_plus(gen: torch.Generator, x: torch.Tensor, k: int,
                     kernel: KernelFn) -> torch.Tensor:
    """D^2-sampling in feature space; returns (k,) int32 indices into x."""
    n = x.shape[0]
    first = int(torch.randint(0, n, (), generator=gen))

    def pick(p):
        return torch.multinomial(p.detach().to("cpu", torch.float64), 1,
                                 generator=gen)[0]

    return _d2_steps(x, k, kernel, first, pick)


def random_init(gen: torch.Generator, n: int, k: int,
                device=None) -> torch.Tensor:
    """k distinct indices drawn uniformly."""
    return torch.randperm(n, generator=gen)[:k].to(device=device,
                                                   dtype=torch.int32)


def draw_init(gen: torch.Generator, x: torch.Tensor, k: int,
              kernel: KernelFn, method: str = "kmeans++") -> torch.Tensor:
    """The one init-drawing entry every fit path shares: dispatch on the
    method name, return (k,) int32 indices into ``x``."""
    if method == "kmeans++":
        return kmeans_plus_plus(gen, x, k, kernel)
    if method == "random":
        return random_init(gen, x.shape[0], k, device=x.device)
    raise ValueError(f"unknown init method {method!r} "
                     "(expected 'kmeans++' or 'random')")
