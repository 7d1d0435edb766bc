"""Kernels K1 (streaming assign) and K2 (batch x center dots) of the port.

On the CPU a wrapper takes its plain version; these tests hold that plain
version against the JAX package's Pallas kernels in interpret mode and its
``ref.batch_center_dots``, at the shapes of the reference's own streaming
tests, with the reference's bar: distances within rtol = atol = 2e-5 and at
least 99% argmin agreement.  The CUDA kernels themselves are held against
these plain versions on a card by tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kernel_fns as jk
from repro.core.minibatch import _sqnorm_recompute as jax_sqnorm_recompute
from repro.kernels import fused_step as jfs
from repro.kernels import ref as jref
from repro.kernels.fused_assign import fused_batch_center_dots_pallas
from repro_torch.core import kernel_fns as tk
from repro_torch.kernels import _build, fused_assign, fused_step, ops

TOL = dict(rtol=2e-5, atol=2e-5)

KINDS = {
    "gaussian": (jk.Gaussian(kappa=jnp.float32(1.3)), tk.Gaussian(kappa=1.3),
                 dict(kind="gaussian", p0=1.3)),
    "linear": (jk.Linear(), tk.Linear(), dict(kind="linear")),
    "polynomial": (jk.Polynomial(bias=jnp.float32(1.0),
                                 scale=jnp.float32(2.0), degree=2),
                   tk.Polynomial(bias=1.0, scale=2.0, degree=2),
                   dict(kind="polynomial", p0=1.0, p1=2.0, p2=2)),
}
# (b, k, W, d, bt, st) of the reference's streaming-kernel sweep
SHAPES = [
    (32, 4, 48, 8, 8, 8),
    (17, 3, 21, 5, 8, 24),
    (64, 8, 40, 16, 16, 16),
]


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale) \
        .astype(np.float32)


def _inputs(b, k, w, d, jkern):
    xb = _rand((b, d), 0)
    sup = _rand((k, w, d), 1, 0.6)
    coef = _rand((k, w), 2, 0.1)
    sq = np.abs(_rand((k,), 3))
    diag_b = np.asarray(jk.diag_of(jkern, xb))
    return xb, sup, coef, sq, diag_b


def _t(*arrays):
    return [torch.tensor(a) for a in arrays]


@pytest.mark.parametrize("kname", list(KINDS))
@pytest.mark.parametrize("b,k,w,d,bt,st", SHAPES)
def test_plain_k1_matches_pallas_interpret(kname, b, k, w, d, bt, st):
    jkern, _, kw = KINDS[kname]
    xb, sup, coef, sq, diag_b = _inputs(b, k, w, d, jkern)
    want_min, want_idx = jfs.streaming_assign_pallas(
        xb, sup, coef, sq, diag_b, bt=bt, st=st, interpret=True, **kw)
    n0 = fused_step.launches.n
    got_min, got_idx = fused_step.streaming_assign_cuda(*_t(
        xb, sup, coef, sq, diag_b), **kw)
    assert fused_step.launches.n == n0          # CPU: the plain version
    assert got_idx.dtype == torch.int32
    np.testing.assert_allclose(got_min.numpy(), np.asarray(want_min), **TOL)
    agree = np.mean(got_idx.numpy() == np.asarray(want_idx))
    assert agree >= 0.99, agree


@pytest.mark.parametrize("kname", list(KINDS))
@pytest.mark.parametrize("b,k,w,d,bt,st", SHAPES)
def test_plain_k2_matches_pallas_interpret_and_ref(kname, b, k, w, d, bt,
                                                   st):
    jkern, _, kw = KINDS[kname]
    xb, sup, coef, _, _ = _inputs(b, k, w, d, jkern)
    want = np.asarray(fused_batch_center_dots_pallas(
        xb, sup, coef, bt=bt, st=st, interpret=True, **kw))
    want_ref = np.asarray(jref.batch_center_dots(jkern, xb, sup, coef))
    n0 = fused_assign.launches.n
    got = fused_assign.fused_batch_center_dots_cuda(*_t(xb, sup, coef),
                                                    **kw).numpy()
    assert fused_assign.launches.n == n0
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, want_ref, **TOL)


@pytest.mark.parametrize("kname", list(KINDS))
def test_ops_dispatch_matches_reference_ops_on_the_cpu(kname):
    """The port's ops entry points against the reference's plain chain
    (``ref.batch_center_dots`` + distance + argmin) at one shape."""
    jkern, tkern, _ = KINDS[kname]
    b, k, w, d = 24, 5, 30, 7
    xb, sup, coef, sq, diag_b = _inputs(b, k, w, d, jkern)
    p = np.asarray(jref.batch_center_dots(jkern, xb, sup, coef))
    dist = diag_b[:, None] - 2.0 * p + sq[None, :]
    txb, tsup, tcoef, tsq, tdiag = _t(xb, sup.reshape(k * w, d), coef, sq,
                                      diag_b)
    best, assign = ops.streaming_assign(tkern, txb, tsup, tcoef, tsq, tdiag)
    np.testing.assert_allclose(best.numpy(), dist.min(axis=1), **TOL)
    assert np.mean(assign.numpy() == dist.argmin(axis=1)) >= 0.99
    np.testing.assert_array_equal(
        ops.streaming_min(tkern, txb, tsup, tcoef, tsq, tdiag).numpy(),
        best.numpy())
    np.testing.assert_allclose(
        ops.fused_batch_center_dots(tkern, txb, tsup, tcoef).numpy(), p,
        **TOL)


def test_laplacian_takes_the_plain_chain():
    """No matmul form: the dispatch runs the plain torch chain and never
    reaches a kernel wrapper."""
    jkern, tkern = jk.Laplacian(kappa=jnp.float32(2.0)), tk.Laplacian(2.0)
    xb, sup, coef, sq, diag_b = _inputs(16, 3, 12, 4, jkern)
    assert ops._dispatch(tkern) is None
    p = np.asarray(jref.batch_center_dots(jkern, xb, sup, coef))
    got = ops.fused_batch_center_dots(tkern, *_t(xb, sup.reshape(36, 4),
                                                  coef))
    np.testing.assert_allclose(got.numpy(), p, **TOL)


@pytest.mark.parametrize("kname", list(KINDS))
def test_zero_coefficient_padding_is_invariant(kname):
    """Extra window slots with zero coefficients (here holding real rows,
    not zeros) contribute nothing."""
    jkern, _, kw = KINDS[kname]
    xb, sup, coef, sq, diag_b = _inputs(20, 4, 18, 6, jkern)
    psup = np.concatenate([sup, sup[:, :7]], axis=1)
    pcoef = np.concatenate([coef, np.zeros_like(coef[:, :7])], axis=1)
    b0, a0 = fused_step.streaming_assign_cuda(*_t(xb, sup, coef, sq, diag_b),
                                              **kw)
    b1, a1 = fused_step.streaming_assign_cuda(
        *_t(xb, psup, pcoef, sq, diag_b), **kw)
    np.testing.assert_allclose(b1.numpy(), b0.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(a1.numpy(), a0.numpy())
    p0 = fused_assign.fused_batch_center_dots_cuda(*_t(xb, sup, coef), **kw)
    p1 = fused_assign.fused_batch_center_dots_cuda(*_t(xb, psup, pcoef),
                                                   **kw)
    np.testing.assert_allclose(p1.numpy(), p0.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("k", [1, 2, 3, 8, 9, 10, 17, 25])
@pytest.mark.parametrize("kc", [1, 2, 4, 8])
def test_center_chunks_equal_jax(k, kc):
    assert fused_step.center_chunks(k, kc) == jfs.center_chunks(k, kc)


@pytest.mark.parametrize("kname", list(KINDS))
def test_streamed_sqnorm_matches_jax_recompute(kname):
    jkern, tkern, _ = KINDS[kname]
    x = _rand((96, 6), 5, 0.5)
    k, w = 7, 21
    idx = np.random.default_rng(6).integers(0, 96, (k, w)).astype(np.int32)
    coef = np.abs(_rand((k, w), 7, 0.05))
    want = np.asarray(jax_sqnorm_recompute(jkern, jnp.asarray(x),
                                           jnp.asarray(idx),
                                           jnp.asarray(coef)))
    tx, tidx, tcoef = _t(x, idx, coef)
    for kc in (2, 4, 8):
        got = fused_step.streamed_sqnorm(tkern, tx, tidx, tcoef, kc=kc)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_wrappers_refuse_other_devices_and_bad_kinds():
    xb = torch.zeros((4, 3), device="meta")
    sup = torch.zeros((2, 5, 3), device="meta")
    coef = torch.zeros((2, 5), device="meta")
    with pytest.raises(ValueError, match="neither cpu nor cuda"):
        fused_assign.fused_batch_center_dots_cuda(xb, sup, coef)
    with pytest.raises(ValueError, match="neither cpu nor cuda"):
        fused_step.streaming_assign_cuda(xb, sup, coef, coef[:, 0], xb[:, 0])
    with pytest.raises(ValueError):
        _build.kind_code("laplacian", 2)
    with pytest.raises(ValueError):
        _build.kind_code("polynomial", -1)


def test_library_path_names_a_hash_of_the_sources_under_build():
    p = _build.library_path()
    assert p == _build.library_path()
    assert p.parent.name == "repro_torch_kernels"
    assert p.parent.parent.name == "build"
    assert p.name.startswith("librepro_torch_kernels_")
