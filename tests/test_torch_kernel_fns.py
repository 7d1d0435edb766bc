"""The port's kernel functions (``repro_torch.core.kernel_fns``) against the
JAX package's, on the same numpy inputs.  Tolerance 1e-6 (rtol and atol):
the two frameworks take the f32 sums in another order."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kernel_fns as jk
from repro_torch.core import kernel_fns as tk

TOL = dict(rtol=1e-6, atol=1e-6)

SPECS = [
    ("rbf", {"kappa": 1.7}),
    ("laplacian", {"kappa": 2.5}),
    ("polynomial", {"bias": 1.0, "scale": 4.0, "degree": 3}),
    ("linear", {}),
]


def _data(m, d, seed, scale=0.5):
    return (np.random.default_rng(seed).normal(size=(m, d)) * scale) \
        .astype(np.float32)


def _pair(name, params):
    return jk.make_kernel(name, **params), tk.make_kernel(name, **params)


def _precomputed(n=12):
    g = _data(n, n, 7)
    g = (g @ g.T).astype(np.float32)
    idx = np.random.default_rng(8).integers(0, n, (9, 1)).astype(np.float32)
    idy = np.random.default_rng(9).integers(0, n, (5, 1)).astype(np.float32)
    return (jk.Precomputed(gram=jnp.asarray(g)),
            tk.Precomputed(gram=torch.tensor(g)), idx, idy)


def _t(a):
    return torch.tensor(a)


@pytest.mark.parametrize("name,params", SPECS)
def test_kernel_cross_diag_diag_of_match_jax(name, params):
    jkern, tkern = _pair(name, params)
    x, y = _data(9, 6, 0), _data(13, 6, 1)
    np.testing.assert_allclose(
        tk.kernel_cross(tkern, _t(x), _t(y)).numpy(),
        np.asarray(jk.kernel_cross(jkern, x, y)), **TOL)
    np.testing.assert_allclose(tk.kernel_diag(tkern, _t(x)).numpy(),
                               np.asarray(jk.kernel_diag(jkern, x)), **TOL)
    np.testing.assert_allclose(tk.diag_of(tkern, _t(x)).numpy(),
                               np.asarray(jk.diag_of(jkern, x)), **TOL)
    np.testing.assert_allclose(
        tk.cross_fixed_y(tkern, _t(y))(_t(x)).numpy(),
        np.asarray(jk.cross_fixed_y(jkern, y)(x)), **TOL)
    np.testing.assert_allclose(float(tk.gamma_of(tkern, _t(x))),
                               float(jk.gamma_of(jkern, x)), **TOL)
    assert tk.diag_is_one(tkern) == jk.diag_is_one(jkern)
    assert tk.is_index_data(tkern) == jk.is_index_data(jkern)


def test_precomputed_kernel_matches_jax():
    jkern, tkern, idx, idy = _precomputed()
    np.testing.assert_allclose(
        tk.kernel_cross(tkern, _t(idx), _t(idy)).numpy(),
        np.asarray(jk.kernel_cross(jkern, idx, idy)), **TOL)
    np.testing.assert_allclose(tk.kernel_diag(tkern, _t(idx)).numpy(),
                               np.asarray(jk.kernel_diag(jkern, idx)), **TOL)
    np.testing.assert_allclose(tk.diag_of(tkern, _t(idx)).numpy(),
                               np.asarray(jk.diag_of(jkern, idx)), **TOL)
    np.testing.assert_allclose(
        tk.cross_fixed_y(tkern, _t(idy))(_t(idx)).numpy(),
        np.asarray(jk.cross_fixed_y(jkern, idy)(idx)), **TOL)
    assert tk.is_index_data(tkern) and jk.is_index_data(jkern)
    with pytest.raises(ValueError):
        tk.kernel_spec(tkern)


@pytest.mark.parametrize("n", [40, 301])
def test_median_sq_dist_heuristic_matches_jax(n):
    """An even count of off-diagonal entries: the median is the mean of the
    two middle values, as jnp.nanmedian takes it."""
    x = _data(n, 5, n, scale=1.0)
    got = float(tk.median_sq_dist_heuristic(_t(x), sample=256))
    want = float(jk.median_sq_dist_heuristic(jnp.asarray(x), sample=256))
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("name,params", SPECS + [("gaussian", {"kappa": 3.0})])
def test_kernel_spec_and_registry_match_jax(name, params):
    jkern, tkern = _pair(name, params)
    assert tk.kernel_spec(tkern) == jk.kernel_spec(jkern)
    rname, rparams = tk.kernel_spec(tkern)
    assert tk.make_kernel(rname, **rparams) == tkern


def test_registry_names_and_errors():
    assert tk.list_kernels() == jk.list_kernels()
    with pytest.raises(ValueError):
        tk.make_kernel("no-such-kernel")
    with pytest.raises(ValueError):
        tk.make_kernel(tk.Linear(), kappa=1.0)
    with pytest.raises(ValueError):
        tk.register_kernel_factory("rbf", lambda: tk.Linear())
