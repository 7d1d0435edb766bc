"""One derivation tree for every random draw of a fit, over
``torch.Generator``s — the JAX package's ``repro.api.keys`` tree with
generators in place of threefry keys:

    root key  (``as_key(seed_or_key)``)
      |
      └─ single-restart plans:
            (init_key, fit_key) = split(root)          -- split_init
            step t:  (fit_key, kb_t) = split(fit_key)  -- next_batch_key

A "key" here is a CPU ``torch.Generator`` treated as an immutable value:
``split`` clones its state and draws child seeds from the clone, so the
generator passed in is never advanced.  That keeps the reference's
semantics — the same key always splits the same way, a discarded draw (the
prefetch of an early-stopped loop) consumes nothing, and a carried key
resumes the stream exactly.  An int seed ``s`` becomes
``torch.Generator().manual_seed(s)``; ``split`` draws ``num`` int64 seeds
in [0, 2**62) from a clone of it, and each child is a generator seeded with
one of them.  The init generator is the first child of the root, the fit
generator the second.  Draws are made on the CPU and the results moved to
the data's device, so a seed gives the same batch indices on every device.

The streams differ from JAX's threefry streams; tests that compare the two
packages hand the reference's draws to the port.
"""
from __future__ import annotations

from typing import Tuple, Union

import torch

KeyOrSeed = Union[int, torch.Generator]


def as_key(seed_or_key: KeyOrSeed) -> torch.Generator:
    """Coerce an int seed (or pass through an existing generator)."""
    if isinstance(seed_or_key, torch.Generator):
        return seed_or_key
    if isinstance(seed_or_key, bool) or not isinstance(seed_or_key, int):
        raise TypeError(f"key must be an int seed or a torch.Generator, got "
                        f"{type(seed_or_key).__name__}")
    return torch.Generator().manual_seed(seed_or_key)


def clone(key: torch.Generator) -> torch.Generator:
    """An independent generator in the same state as ``key``."""
    g = torch.Generator()
    g.set_state(key.get_state())
    return g


def split(key: torch.Generator, num: int = 2):
    """``num`` child generators of ``key``; ``key`` itself is untouched."""
    seeds = torch.randint(0, 2 ** 62, (num,), generator=clone(key),
                          dtype=torch.int64)
    return tuple(torch.Generator().manual_seed(int(s)) for s in seeds)


def split_init(key: torch.Generator) -> Tuple[torch.Generator,
                                                 torch.Generator]:
    """``(init_key, fit_key)`` — the one split every single-restart plan
    performs before touching data."""
    init_key, fit_key = split(key)
    return init_key, fit_key


def next_batch_key(key: torch.Generator) -> Tuple[torch.Generator,
                                                     torch.Generator]:
    """Advance the fit stream one step: ``(fit_key', kb)``; ``kb`` draws
    iteration t's batch and ``fit_key'`` carries to t+1."""
    key, kb = split(key)
    return key, kb


def derive_fit_keys(key: torch.Generator, init_given: bool,
                    always_split: bool = True):
    """``(init_key, fit_key)`` at fit entry, as in the reference: with no
    explicit init the init draw takes the first split; with one given, the
    estimator still burns that split (``always_split``) so the batch stream
    does not depend on who drew the init."""
    if not init_given:
        return split_init(key)
    if always_split:
        return None, split_init(key)[1]
    return None, key


__all__ = ["as_key", "clone", "split", "split_init", "next_batch_key",
           "derive_fit_keys"]
