"""The port's estimator and fit loop against the JAX package, end to end.

* The same data, the same ``init_idx`` and the reference's own batch draws
  (``repro.api.keys`` + ``sample_batch``) replayed through the port's
  ``drive_fit_loop``: final states within 1e-5, labels equal on at least
  99.9% of rows.  The blobs are well separated, so no row sits near a tie.
  The same holds on 1500 rows of the mnist-like proxy at the
  median-heuristic kappa, where both packages collapse into one cluster.
* Save format 3 crosses in both directions.
* ``fit; save; load; partial_fit`` is bit-identical to ``fit; partial_fit``
  inside the port.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import KernelKMeans as JKMeans
from repro.api import SolverConfig as JConfig
from repro.api import keys as jkeys
from repro.api.config import field_names as jfield_names
from repro.core import kernel_fns as jkf
from repro.core import minibatch as jmb
from repro.data import make_dataset
from repro_torch.api import KernelKMeans, SolverConfig
from repro_torch.api.config import field_names
from repro_torch.core import kernel_fns as tk
from repro_torch.core import minibatch as tmb
from repro_torch.core.loop import drive_fit_loop
from repro_torch.core.metrics import adjusted_rand_index
from repro_torch.core.state import init_state, state_to_numpy

K, B, TAU, ITERS, KAPPA = 4, 32, 16, 8, 1.5
SMALL = dict(k=K, batch_size=B, tau=TAU, cache="none",
             distribution="single", kernel="rbf",
             kernel_params={"kappa": KAPPA})


def _data(n=240, seed=0):
    x, y = make_dataset("blobs", n=n, d=8, k=K, spread=0.05, seed=seed)
    init = np.array([int(np.flatnonzero(y == c)[0]) for c in range(K)],
                    np.int32)
    return x, y, init


def _jax_draws(seed, n, iters):
    """The reference estimator's batch stream for an int seed with an
    explicit init: split_init burns the init key, then one next_batch_key
    per step."""
    _, key = jkeys.derive_fit_keys(jkeys.as_key(seed), True)
    out = []
    for _ in range(iters):
        key, kb = jkeys.next_batch_key(key)
        out.append(np.asarray(jmb.sample_batch(kb, n, B)))
    return out


@pytest.mark.parametrize("step", ["composed", "fused"])
def test_end_to_end_replayed_draws_match_jax(step):
    x, _, init = _data()
    n = x.shape[0]
    jest = JKMeans(JConfig(**SMALL, jit=False, step="composed",
                           prefetch=False, max_iters=ITERS, epsilon=-1.0))
    jest.fit(x, key=3, init_idx=init)
    draws = _jax_draws(3, n, ITERS)

    tkern = tk.Gaussian(kappa=KAPPA)
    xt = torch.tensor(x)
    stepf = tmb.make_step(tkern, tmb.MBConfig(k=K, batch_size=B, tau=TAU,
                                              step=step))
    state = init_state(xt, torch.tensor(init), tkern, B + TAU)

    def dispatch(bidx):
        nonlocal state
        state, info = stepf(state, xt, bidx)
        return info

    history, cursor = drive_fit_loop(
        dispatch, lambda c, i: (c + 1, torch.tensor(draws[c])), 0,
        max_iters=ITERS, epsilon=-1.0)
    assert cursor == ITERS and len(history) == len(jest.history_) == ITERS
    got, want = state_to_numpy(state), jest.state_
    np.testing.assert_array_equal(got.idx, np.asarray(want.idx))
    np.testing.assert_array_equal(got.head, np.asarray(want.head))
    np.testing.assert_array_equal(got.counts, np.asarray(want.counts))
    np.testing.assert_allclose(got.coef, np.asarray(want.coef), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got.sqnorm, np.asarray(want.sqnorm),
                               rtol=1e-5, atol=1e-5)
    for h, jh in zip(history, jest.history_):
        np.testing.assert_allclose(h["f_after"], jh["f_after"], rtol=1e-5,
                                   atol=1e-5)
    labels = tmb.predict(state, xt, xt, tkern).numpy()
    assert np.mean(labels == np.asarray(jest.predict(x))) >= 0.999


def test_mnist_like_proxy_collapses_in_both_packages():
    """The card's main-path data (the mnist-like proxy, d=784, at the
    median-heuristic kappa) at 1500 rows: the reference fit, and the port's
    fused step on its draws, put every row but the other centers' seeds in
    one cluster (ARI ~ 0).  The collapse is the data's, not the port's:
    the states agree as on the separated blobs."""
    n, k, b, tau, iters = 1500, 10, 256, 64, 6
    x, y = make_dataset("mnist-like", n=n)
    kappa = float(jkf.median_sq_dist_heuristic(jnp.asarray(x)))
    assert float(tk.median_sq_dist_heuristic(torch.tensor(x))) == \
        pytest.approx(kappa, rel=1e-6)
    init = np.sort(np.random.default_rng(0).choice(n, k, replace=False))
    init = init.astype(np.int32)
    jest = JKMeans(JConfig(k=k, batch_size=b, tau=tau, cache="none",
                           distribution="single", kernel="rbf",
                           kernel_params={"kappa": kappa}, jit=False,
                           step="composed", prefetch=False, max_iters=iters,
                           epsilon=-1.0)).fit(x, key=3, init_idx=init)
    _, key = jkeys.derive_fit_keys(jkeys.as_key(3), True)
    tkern, xt = tk.Gaussian(kappa=kappa), torch.tensor(x)
    stepf = tmb.make_step(tkern, tmb.MBConfig(k=k, batch_size=b, tau=tau,
                                              step="fused"))
    state = init_state(xt, torch.tensor(init), tkern, b + tau)
    for _ in range(iters):
        key, kb = jkeys.next_batch_key(key)
        state, _ = stepf(state, xt,
                         torch.tensor(np.asarray(jmb.sample_batch(kb, n, b))))
    got, want = state_to_numpy(state), jest.state_
    np.testing.assert_array_equal(got.idx, np.asarray(want.idx))
    np.testing.assert_allclose(got.coef, np.asarray(want.coef), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got.sqnorm, np.asarray(want.sqnorm),
                               rtol=1e-5, atol=1e-5)
    labels = tmb.predict(state, xt, xt, tkern).numpy()
    jlabels = np.asarray(jest.predict(x))
    assert np.mean(labels == jlabels) >= 0.999
    for lab in (labels, jlabels):
        assert np.bincount(lab, minlength=k).max() >= n - k
        assert abs(adjusted_rand_index(y, lab)) < 0.01


def test_port_fit_clusters_blobs_on_its_own_stream():
    x, y, _ = _data(seed=1)
    est = KernelKMeans(SolverConfig(**SMALL, max_iters=20), device="cpu")
    labels = est.fit_predict(x, key=0).numpy()
    assert est.plan_.name == "single"
    assert est.plan_.config.step == "composed"       # CPU: composed
    assert adjusted_rand_index(y, labels) > 0.95
    d = est.transform(x).numpy()
    assert d.shape == (x.shape[0], K) and np.isfinite(d).all()
    np.testing.assert_array_equal(d.argmin(axis=1), labels)
    assert est.score(x) == pytest.approx(-float(d.min(axis=1).mean()),
                                         rel=1e-6)


def test_jax_snapshot_loads_in_the_port(tmp_path):
    x, _, init = _data(seed=2)
    jest = JKMeans(JConfig(**SMALL, jit=False, step="composed",
                           max_iters=6)).fit(x, key=1, init_idx=init)
    path = str(tmp_path / "jax.npz")
    jest.save(path)
    est = KernelKMeans.load(path, device="cpu")
    np.testing.assert_array_equal(est.predict(x).numpy(),
                                  np.asarray(jest.predict(x)))
    np.testing.assert_array_equal(est.state_.idx.numpy(),
                                  np.asarray(jest.state_.idx))
    assert est.state_.idx.dtype == torch.int32
    with pytest.raises(NotImplementedError, match="threefry"):
        est.partial_fit(x, iters=2)


def test_port_snapshot_loads_in_jax(tmp_path):
    x, _, _ = _data(seed=3)
    est = KernelKMeans(SolverConfig(**SMALL, max_iters=6),
                       device="cpu").fit(x, key=2)
    path = str(tmp_path / "port.npz")
    est.save_atomic(path)
    jest = JKMeans.load(path)
    np.testing.assert_array_equal(np.asarray(jest.predict(x)),
                                  est.predict(x).numpy())
    assert jest.config.k == K and jest.config.batch_size == B


def test_save_load_partial_fit_is_bit_identical(tmp_path):
    x, _, _ = _data(seed=4)
    cfg = SolverConfig(**SMALL, max_iters=3, epsilon=-1.0)
    a = KernelKMeans(cfg, device="cpu").fit(x, key=5)
    path = str(tmp_path / "a.npz")
    a.save(path)
    b = KernelKMeans.load(path, device="cpu")
    a.partial_fit(x, iters=4)
    b.partial_fit(x, iters=4)
    c = KernelKMeans(cfg.replace(max_iters=7), device="cpu").fit(x, key=5)
    for other in (b, c):
        for f, u, v in zip(a.state_._fields, a.state_, other.state_):
            assert torch.equal(u, v), f
    assert [h["f_after"] for h in a.history_] == \
        [h["f_after"] for h in c.history_]
    assert [h["step"] for h in b.history_] == [3, 4, 5, 6]


def test_prefetch_is_bit_identical():
    x, _, _ = _data(seed=5)
    runs = [KernelKMeans(SolverConfig(**SMALL, max_iters=5, prefetch=p),
                         device="cpu").fit(x, key=9) for p in (True, False)]
    for u, v in zip(runs[0].state_, runs[1].state_):
        assert torch.equal(u, v)


def test_config_fields_equal_jax():
    assert field_names() == jfield_names()
    for f in field_names():
        assert getattr(SolverConfig(), f) == getattr(JConfig(), f), f


def test_resolved_step_follows_the_device():
    cfg = SolverConfig()
    assert cfg.resolved_step("cuda") == "fused"
    assert cfg.resolved_step(torch.device("cuda", 0)) == "fused"
    assert cfg.resolved_step("cpu") == "composed"
    # no device means the card, as KernelKMeans(device=None) does
    assert cfg.resolved_step() == "fused"
    assert cfg.mb_config().step == "fused"
    assert cfg.resolve(n=10 ** 6).step == "fused"
    assert cfg.mb_config("cpu").step == "composed"
    assert cfg.replace(step="fused").resolved_step("cpu") == "fused"
    assert cfg.replace(sqnorm_mode="incremental").resolved_step("cuda") == \
        "composed"


@pytest.mark.parametrize("overrides,match", [
    (dict(cache="auto"), "Queue 1 item 7"),
    (dict(cache="lru"), "Queue 1 item 9"),
    (dict(restarts=2, cache="none"), "Queue 1 item 11"),
    (dict(distribution="sharded", cache="none"), "Queue 1 item 12"),
    (dict(sampler="nested", cache="none"), "Queue 1 item 9"),
    (dict(precision="bf16", cache="none"), "Queue 1 item 8"),
])
def test_unported_plans_raise_naming_the_roadmap_item(overrides, match):
    x, _, _ = _data(n=64)
    cfg = SolverConfig(**{**SMALL, **overrides})
    with pytest.raises(NotImplementedError, match=match):
        KernelKMeans(cfg, device="cpu").fit(x)


def test_unported_constructor_axes_raise():
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        SolverConfig(compress={"every": 1, "m": 4})
    with pytest.raises(NotImplementedError, match="Queue 1 item 12"):
        KernelKMeans(SolverConfig(), device="cpu", mesh=object())


def test_sample_weight_draws_only_weighted_rows():
    """Weighted sampling (paper footnote 1): with all weight on one blob,
    every appended window slot holds a row of that blob."""
    x, y, _ = _data(seed=6)
    w = (y == 0).astype(np.float32)
    est = KernelKMeans(SolverConfig(**SMALL, max_iters=4),
                       device="cpu").fit(x, key=0, sample_weight=w)
    st = est.state_
    assert float(st.counts.sum()) == 4 * B
    appended = st.idx[:, 1:][st.coef[:, 1:] != 0].long().numpy()
    assert appended.size > 0 and np.all(y[appended] == 0)


def test_loop_config_lowers_early_stop_and_max_iters():
    from repro_torch.core.loop import loop_config

    mb = tmb.MBConfig(k=K, batch_size=B, tau=TAU)
    assert loop_config(mb, True) == mb
    got = loop_config(mb, False, max_iters=3)
    assert got.max_iters == 3 and got.epsilon == float("-inf")
