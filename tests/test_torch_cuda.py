"""The port's CUDA kernels on a card, against their plain torch versions.

Every test here carries the ``cuda`` marker and skips without a CUDA card:
the kernels have no CPU mode.  The file imports neither JAX nor the JAX
package, so it runs on a machine that has only torch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Bar: distances and dots within rtol = atol = 2e-5, argmin agreement at
least 99% (sums run in another order than cuBLAS's).
"""
import numpy as np
import pytest
import torch

from repro_torch.api import KernelKMeans, SolverConfig
from repro_torch.core import kernel_fns as tk
from repro_torch.data import blobs
from repro_torch.kernels import fused_assign, fused_step, ref

TOL = dict(rtol=2e-5, atol=2e-5)
KINDS = {
    "gaussian": (tk.Gaussian(kappa=1.3), dict(kind="gaussian", p0=1.3)),
    "linear": (tk.Linear(), dict(kind="linear")),
    "polynomial": (tk.Polynomial(bias=1.0, scale=2.0, degree=2),
                   dict(kind="polynomial", p0=1.0, p1=2.0, p2=2)),
}

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(b, k, w, d, kern, dev):
    rng = np.random.default_rng(b + k + w + d)
    xb = torch.tensor(rng.normal(size=(b, d)), dtype=torch.float32)
    sup = torch.tensor(rng.normal(size=(k, w, d)) * 0.6, dtype=torch.float32)
    coef = torch.tensor(rng.normal(size=(k, w)) * 0.1, dtype=torch.float32)
    sq = torch.tensor(np.abs(rng.normal(size=(k,))), dtype=torch.float32)
    diag = tk.diag_of(kern, xb)
    return [t.to(dev) for t in (xb, sup, coef, sq, diag)]


@pytest.mark.parametrize("kname", list(KINDS))
@pytest.mark.parametrize("b,k,w,d", [(100, 7, 45, 33), (300, 10, 200, 70),
                                     (32, 4, 48, 8), (1, 1, 1, 1)])
def test_kernels_match_plain(dev, kname, b, k, w, d):
    kern, kw = KINDS[kname]
    xb, sup, coef, sq, diag = _inputs(b, k, w, d, kern, dev)
    n1, n2 = fused_step.launches.n, fused_assign.launches.n
    best, assign = fused_step.streaming_assign_cuda(xb, sup, coef, sq, diag,
                                                    **kw)
    p = fused_assign.fused_batch_center_dots_cuda(xb, sup, coef, **kw)
    torch.cuda.synchronize()
    assert (fused_step.launches.n, fused_assign.launches.n) == (n1 + 1,
                                                                 n2 + 1)
    want_best, want_idx = ref.streaming_assign_ref(
        kern, xb, sup.reshape(k * w, d), coef, sq, diag)
    torch.testing.assert_close(best, want_best, **TOL)
    torch.testing.assert_close(
        p, ref.batch_center_dots(kern, xb, sup, coef), **TOL)
    assert assign.dtype == torch.int32
    assert (assign == want_idx).float().mean().item() >= 0.99


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    kern, kw = KINDS["gaussian"]
    xb, sup, coef, sq, diag = _inputs(16, 3, 10, 8, kern, dev)
    with pytest.raises(ValueError, match="contiguous"):
        fused_assign.fused_batch_center_dots_cuda(xb.t().contiguous().t(),
                                                  sup, coef, **kw)
    with pytest.raises(TypeError):
        fused_step.streaming_assign_cuda(xb.double(), sup, coef, sq, diag,
                                         **kw)
    with pytest.raises(ValueError):
        fused_step.streaming_assign_cuda(xb, sup.cpu(), coef, sq, diag, **kw)
    with pytest.raises(ValueError):
        fused_step.streaming_assign_cuda(xb, sup, coef[:, :5], sq, diag, **kw)


def test_fused_fit_on_the_card_matches_the_cpu(dev):
    x, y = blobs(n=2000, d=16, k=5, spread=0.1, seed=5)
    init = np.array([int(np.flatnonzero(y == c)[0]) for c in range(5)],
                    np.int32)
    cfg = SolverConfig(k=5, batch_size=256, tau=64, cache="none",
                       distribution="single", kernel="rbf",
                       kernel_params={"kappa": 1.0}, max_iters=8,
                       epsilon=-1.0)
    n0 = fused_step.launches.n
    gpu = KernelKMeans(cfg).fit(x, key=3, init_idx=init)
    assert gpu.plan_.config.step == "fused"
    assert fused_step.launches.n - n0 == 2 * gpu.iters_
    cpu = KernelKMeans(cfg, device="cpu").fit(x, key=3, init_idx=init)
    assert torch.equal(gpu.state_.idx.cpu(), cpu.state_.idx)
    torch.testing.assert_close(gpu.state_.coef.cpu(), cpu.state_.coef,
                               rtol=1e-5, atol=1e-5)
    agree = (gpu.predict(x).cpu() == cpu.predict(x)).float().mean().item()
    assert agree >= 0.999
