"""Synthetic clustering datasets.

The paper evaluates on MNIST / PenDigits / Letters / HAR, none of which are
available offline here.  These generators produce the two regimes the paper's
claims rely on:

* linearly separable mixtures (``blobs``, ``anisotropic``) where plain
  k-means already works, and
* non-linearly-separable manifolds (``circles``, ``moons``) where kernel
  k-means succeeds and plain k-means provably cannot (the paper's motivation).

All generators are deterministic in ``seed`` and return ``(X, y)`` float32 /
int32 numpy arrays.
"""
from __future__ import annotations

import numpy as np


def blobs(n: int = 2000, d: int = 16, k: int = 8, spread: float = 0.15,
          seed: int = 0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    y = rng.integers(0, k, size=n)
    x = centers[y] + spread * rng.normal(size=(n, d))
    return x.astype(np.float32), y.astype(np.int32)


def anisotropic(n: int = 2000, d: int = 8, k: int = 4, seed: int = 0):
    x, y = blobs(n, d, k, spread=0.4, seed=seed)
    rng = np.random.default_rng(seed + 1)
    transform = np.eye(d) + 0.6 * rng.normal(size=(d, d)) / np.sqrt(d)
    return (x @ transform).astype(np.float32), y


def circles(n: int = 2000, noise: float = 0.05, factor: float = 0.45,
            seed: int = 0):
    """Two concentric circles — the canonical kernel-k-means win."""
    rng = np.random.default_rng(seed)
    n_out = n // 2
    n_in = n - n_out
    t_out = rng.uniform(0, 2 * np.pi, n_out)
    t_in = rng.uniform(0, 2 * np.pi, n_in)
    x = np.concatenate([
        np.stack([np.cos(t_out), np.sin(t_out)], axis=1),
        factor * np.stack([np.cos(t_in), np.sin(t_in)], axis=1),
    ])
    x += noise * rng.normal(size=x.shape)
    y = np.concatenate([np.zeros(n_out), np.ones(n_in)])
    perm = rng.permutation(n)
    return x[perm].astype(np.float32), y[perm].astype(np.int32)


def moons(n: int = 2000, noise: float = 0.06, seed: int = 0):
    rng = np.random.default_rng(seed)
    n_a = n // 2
    n_b = n - n_a
    ta = rng.uniform(0, np.pi, n_a)
    tb = rng.uniform(0, np.pi, n_b)
    a = np.stack([np.cos(ta), np.sin(ta)], axis=1)
    b = np.stack([1.0 - np.cos(tb), 0.5 - np.sin(tb)], axis=1)
    x = np.concatenate([a, b]) + noise * rng.normal(size=(n, 2))
    y = np.concatenate([np.zeros(n_a), np.ones(n_b)])
    perm = rng.permutation(n)
    return x[perm].astype(np.float32), y[perm].astype(np.int32)


_REGISTRY = {
    "blobs": blobs,
    "anisotropic": anisotropic,
    "circles": circles,
    "moons": moons,
}


def make_dataset(name: str, **kw):
    """Paper-dataset stand-ins with matched (n, d, k):

    mnist-like   -> blobs(n=70000, d=784, k=10)  [shape proxy]
    pendigits-like -> blobs(n=10992, d=16, k=10)
    letters-like -> blobs(n=20000, d=16, k=26)
    har-like     -> blobs(n=10299, d=561, k=6)
    """
    proxies = {
        "mnist-like": dict(fn=blobs, n=70000, d=784, k=10),
        "pendigits-like": dict(fn=blobs, n=10992, d=16, k=10),
        "letters-like": dict(fn=blobs, n=20000, d=16, k=26),
        "har-like": dict(fn=blobs, n=10299, d=561, k=6),
    }
    if name in proxies:
        spec = dict(proxies[name])
        fn = spec.pop("fn")
        spec.update(kw)
        return fn(**spec)
    return _REGISTRY[name](**kw)
