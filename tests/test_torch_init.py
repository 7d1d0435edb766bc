"""The port's k-means++ (``repro_torch.core.init``) against the JAX package.

torch cannot reproduce JAX's threefry draws, so the comparison is
teacher-forced: given the indices the JAX ``kmeans_plus_plus`` chose, the
port's D^2 probability vector at every step must match the reference's
arithmetic (``repro.core.kernel_fns`` + the guard of ``init.py``) within
1e-6.  The port's own sampler is checked against the exact D^2
distribution on a tiny dataset.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import init as jinit
from repro.core import kernel_fns as jk
from repro.data import blobs
from repro_torch.api import keys as tkeys
from repro_torch.core import init as tinit
from repro_torch.core import kernel_fns as tk

KERNELS = {
    "rbf": (jk.Gaussian(kappa=jnp.float32(0.8)), tk.Gaussian(kappa=0.8)),
    "polynomial": (jk.Polynomial(bias=jnp.float32(1.0),
                                 scale=jnp.float32(8.0), degree=2),
                   tk.Polynomial(bias=1.0, scale=8.0, degree=2)),
    "laplacian": (jk.Laplacian(kappa=jnp.float32(3.0)), tk.Laplacian(3.0)),
}


def _jax_d2_probs(jkern, x, chosen):
    """The reference's p at every step of its fori_loop, for the given
    chosen indices (init.py's dist_to and all-zero guard, in jnp)."""
    n = x.shape[0]
    diag = jk.kernel_diag(jkern, x)

    def dist_to(i):
        cross = jk.kernel_cross(jkern, x, x[i][None, :])[:, 0]
        return jnp.maximum(diag + diag[i] - 2.0 * cross, 0.0)

    mind = dist_to(chosen[0])
    out = []
    for t in range(1, len(chosen)):
        total = jnp.sum(mind)
        out.append(np.asarray(jnp.where(
            total > 0, mind / jnp.maximum(total, 1e-30),
            jnp.full_like(mind, 1.0 / n))))
        mind = jnp.minimum(mind, dist_to(chosen[t]))
    return out


@pytest.mark.parametrize("kname", list(KERNELS))
@pytest.mark.parametrize("seed", [0, 1])
def test_d2_probabilities_match_jax_given_its_choices(kname, seed):
    jkern, tkern = KERNELS[kname]
    x, _ = blobs(n=300, d=6, k=5, seed=seed)
    chosen = np.asarray(jinit.kmeans_plus_plus(
        jax.random.PRNGKey(seed), jnp.asarray(x), 6, jkern))
    want = _jax_d2_probs(jkern, jnp.asarray(x), chosen)
    got = []

    def pick(p):
        got.append(p.numpy().copy())
        return int(chosen[len(got)])

    out = tinit._d2_steps(torch.tensor(x), 6, tkern, int(chosen[0]), pick)
    np.testing.assert_array_equal(out.numpy(), chosen)
    assert out.dtype == torch.int32
    assert len(got) == len(want) == 5
    for p_t, p_j, nxt in zip(got, want, chosen[1:]):
        np.testing.assert_allclose(p_t, p_j, rtol=1e-6, atol=1e-6)
        assert p_t[nxt] > 0      # the reference's choice is possible here


def test_all_zero_distances_fall_back_to_uniform():
    p = tinit.d2_probabilities(torch.zeros(7))
    np.testing.assert_allclose(p.numpy(), np.full(7, 1 / 7), rtol=1e-7)
    x = np.ones((5, 3), np.float32)           # duplicate data
    idx = tinit.kmeans_plus_plus(tkeys.as_key(0), torch.tensor(x), 3,
                                 tk.Gaussian(1.0))
    assert idx.shape == (3,) and bool(((idx >= 0) & (idx < 5)).all())


def test_port_sampler_follows_the_exact_d2_distribution():
    """k=2 on 5 points: P(first=i, second=j) = 1/n * d2(i,j)/sum_l d2(i,l).
    2000 seeded draws; every pair frequency within 0.03 of its exact
    probability (about 5 standard deviations at the largest cell)."""
    x = np.array([[0.0], [0.1], [1.0], [1.2], [3.0]], np.float32)
    kern = tk.Linear()            # d2 = (xi - xj)^2 in feature space
    n = x.shape[0]
    d2 = (x - x.T) ** 2
    exact = d2 / d2.sum(axis=1, keepdims=True) / n
    counts = np.zeros((n, n))
    xt = torch.tensor(x)
    for s in range(2000):
        i, j = tinit.kmeans_plus_plus(tkeys.as_key(s), xt, 2, kern).tolist()
        counts[i, j] += 1
    freq = counts / counts.sum()
    assert np.all(np.diag(counts) == 0)
    np.testing.assert_allclose(freq, exact, atol=0.03)


def test_kmeans_plus_plus_is_a_function_of_the_seed():
    x, _ = blobs(n=200, d=4, k=4, seed=3)
    xt = torch.tensor(x)
    a = tinit.kmeans_plus_plus(tkeys.as_key(5), xt, 4, tk.Gaussian(1.0))
    b = tinit.kmeans_plus_plus(tkeys.as_key(5), xt, 4, tk.Gaussian(1.0))
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert len(set(a.tolist())) == 4


@pytest.mark.parametrize("n,k", [(10, 3), (50, 50)])
def test_random_init_draws_distinct_indices(n, k):
    idx = tinit.draw_init(tkeys.as_key(1), torch.zeros((n, 2)), k,
                          tk.Linear(), method="random")
    assert idx.dtype == torch.int32 and idx.shape == (k,)
    assert len(set(idx.tolist())) == k
    assert all(0 <= i < n for i in idx.tolist())


def test_draw_init_rejects_unknown_methods():
    with pytest.raises(ValueError):
        tinit.draw_init(tkeys.as_key(0), torch.zeros((4, 2)), 2,
                        tk.Linear(), method="forgy")


def test_key_tree_is_pure_and_deterministic():
    """Splitting never advances the key it splits; the same seed gives the
    same streams; the two children differ."""
    root = tkeys.as_key(7)
    state = root.get_state().clone()
    a_init, a_fit = tkeys.split_init(root)
    assert torch.equal(root.get_state(), state)
    b_init, b_fit = tkeys.split_init(tkeys.as_key(7))
    draws = [torch.randint(0, 1 << 30, (4,), generator=g)
             for g in (a_init, a_fit, b_init, b_fit)]
    assert torch.equal(draws[0], draws[2])
    assert torch.equal(draws[1], draws[3])
    assert not torch.equal(draws[0], draws[1])
    k1, kb1 = tkeys.next_batch_key(a_fit)
    k2, kb2 = tkeys.next_batch_key(b_fit)
    assert torch.equal(k1.get_state(), k2.get_state())
    assert torch.equal(kb1.get_state(), kb2.get_state())
    with pytest.raises(TypeError):
        tkeys.as_key(1.5)
