"""Clustering quality metrics (ARI, NMI) — self-contained numpy
implementations, a copy of the JAX package's, matching sklearn's
definitions (NMI uses the 'arithmetic' average, sklearn's default)."""
from __future__ import annotations

import numpy as np


def _contingency(labels_true: np.ndarray, labels_pred: np.ndarray) -> np.ndarray:
    lt = np.asarray(labels_true).ravel()
    lp = np.asarray(labels_pred).ravel()
    _, ti = np.unique(lt, return_inverse=True)
    _, pi = np.unique(lp, return_inverse=True)
    nt = ti.max() + 1
    npred = pi.max() + 1
    cm = np.zeros((nt, npred), dtype=np.int64)
    np.add.at(cm, (ti, pi), 1)
    return cm


def adjusted_rand_index(labels_true, labels_pred) -> float:
    """ARI (Rand 1971; Hubert & Arabie correction) — as used in the paper."""
    cm = _contingency(labels_true, labels_pred)
    n = cm.sum()
    if n <= 1:
        return 1.0
    sum_comb_c = (cm * (cm - 1) // 2).sum()
    a = cm.sum(axis=1)
    b = cm.sum(axis=0)
    sum_comb_a = (a * (a - 1) // 2).sum()
    sum_comb_b = (b * (b - 1) // 2).sum()
    total = n * (n - 1) // 2
    expected = sum_comb_a * sum_comb_b / total
    max_index = (sum_comb_a + sum_comb_b) / 2.0
    if max_index == expected:
        return 1.0
    return float((sum_comb_c - expected) / (max_index - expected))


def _entropy(counts: np.ndarray) -> float:
    p = counts[counts > 0].astype(np.float64)
    p = p / p.sum()
    return float(-(p * np.log(p)).sum())


def normalized_mutual_info(labels_true, labels_pred) -> float:
    """NMI with arithmetic-mean normalization (sklearn default)."""
    cm = _contingency(labels_true, labels_pred).astype(np.float64)
    n = cm.sum()
    if n == 0:
        return 0.0
    pi = cm.sum(axis=1)
    pj = cm.sum(axis=0)
    nz = cm > 0
    outer = np.outer(pi, pj)
    mi = (cm[nz] / n * (np.log(cm[nz] * n) - np.log(outer[nz]))).sum()
    hi, hj = _entropy(pi), _entropy(pj)
    denom = 0.5 * (hi + hj)
    if denom <= 0:
        return 1.0 if mi == 0 else 0.0
    return float(max(mi, 0.0) / denom)
