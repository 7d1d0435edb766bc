"""Package boundaries of the port: ``repro_torch`` and ``chip_smoke.py``
import neither JAX nor the JAX package, and the entry points run on the
card unless the caller asks for the CPU."""
import ast
import pathlib

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.api import KernelKMeans, SolverConfig

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(mod):
    return any(mod == top or mod.startswith(top + ".")
               for top in ("jax", "jaxlib", "repro"))


def test_port_files_exist():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for must in ("chip_smoke.py", "src/repro_torch/__init__.py",
                 "src/repro_torch/kernels/fused_step.py",
                 "src/repro_torch/kernels/fused_assign.py",
                 "src/repro_torch/api/estimator.py"):
        assert must in names
    assert (ROOT / "src/repro_torch/kernels/csrc/center_dots.cu").exists()


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_repro_imports(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path} imports {bad}"


def test_forbidden_matcher():
    assert _forbidden("jax.numpy") and _forbidden("repro.core")
    assert _forbidden("repro") and not _forbidden("repro_torch.core")


def test_default_device_is_cuda_and_never_the_cpu_quietly(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.zeros((16, 2), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        KernelKMeans().fit(x)
    with pytest.raises(RuntimeError):
        KernelKMeans(SolverConfig(k=2), device="cuda")


def test_explicit_cpu_device_runs():
    x = np.random.default_rng(0).normal(size=(64, 3)).astype(np.float32)
    est = KernelKMeans(SolverConfig(k=2, batch_size=16, tau=8, cache="none",
                                    max_iters=3), device="cpu").fit(x)
    assert est.state_.coef.device.type == "cpu"
    assert est.predict(x).shape == (64,)
    assert repro_torch.KernelKMeans is KernelKMeans
