"""``KernelKMeans`` — sklearn-style estimator over the solver-plan layer,
on a torch device.

    from repro_torch.api import KernelKMeans, SolverConfig

    est = KernelKMeans(SolverConfig(k=10, batch_size=4096, tau=200,
                                    cache="none", distribution="single",
                                    kernel="rbf",
                                    kernel_params={"kappa": 2.0}))
    est.fit(x, key=0)                  # runs on "cuda" unless told otherwise
    labels = est.predict(xq)
    est.save("centers.npz"); served = KernelKMeans.load("centers.npz")

Snapshots use the JAX package's save format 3 (an npz payload with a meta
JSON, then an 8-byte ``KKC3`` CRC32 footer), byte-layout compatible in both
directions: the port writes its carried generator state under
``carry_torch_generator`` (not ``carry_key``), so the JAX package reads a
port snapshot as serving state, and a JAX snapshot loads here as serving
state plus ``state_`` — its threefry key cannot resume a torch stream.
"""
from __future__ import annotations

import io
import json
import os
import struct
import zipfile
import zlib
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.api import keys as api_keys
from repro_torch.api.config import SolverConfig, field_names
from repro_torch.core.kernel_fns import kernel_spec, make_kernel, to_tensor
from repro_torch.core.loop import FitCarry, carry_of, outcome_from_carry
from repro_torch.core.minibatch import (
    assign_chunked, center_distances_chunked,
)
from repro_torch.core.state import (
    CenterState, state_from_numpy, state_to_numpy,
)

# SolverConfig fields saved as-is (the kernel is saved as (name, params))
_JSON_FIELDS = tuple(f for f in field_names()
                     if f not in ("kernel", "kernel_params"))

_CRC_MAGIC = b"KKC3"
_CRC_FOOTER = struct.Struct("<4sI")
_GEN_ARRAY = "carry_torch_generator"
# the reference's landmark-compression counters; compression is not ported,
# so a port snapshot always carries this initial value
_COMPRESS_STATS = {"compressions": 0, "m": None, "last_drift": None,
                   "ratio": None}


class SnapshotIntegrityError(RuntimeError):
    """Snapshot file failed its integrity check (CRC mismatch, truncated or
    undecodable container)."""


def _verified_payload(path: str) -> bytes:
    """The npz payload of ``path`` with its format-3 CRC footer verified
    and stripped (footer-less legacy files pass through whole)."""
    with open(path, "rb") as f:
        raw = f.read()
    if len(raw) >= _CRC_FOOTER.size:
        magic, crc = _CRC_FOOTER.unpack(raw[-_CRC_FOOTER.size:])
        if magic == _CRC_MAGIC:
            payload = raw[:-_CRC_FOOTER.size]
            if zlib.crc32(payload) != crc:
                raise SnapshotIntegrityError(
                    f"CRC mismatch in {path}: stored {crc:#010x}, "
                    f"computed {zlib.crc32(payload):#010x}")
            return payload
    return raw


def resolve_device(device) -> torch.device:
    """``None`` means ``"cuda"``; a CUDA device on a machine without CUDA
    raises instead of running on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "KernelKMeans runs on a CUDA device unless told otherwise, and "
            "torch.cuda.is_available() is False here; pass device='cpu' to "
            "run on the CPU")
    return dev


class KernelKMeans:
    """Mini-batch kernel k-means estimator (the paper's Algorithm 2).

    Parameters: a :class:`SolverConfig` (or field overrides as kwargs) and
    the torch ``device`` to run on (default ``"cuda"``).

    Fitted attributes: ``state_`` (truncated-center state), ``history_``,
    ``iters_``, ``plan_`` (the resolved :class:`repro_torch.api.plan.Plan`).
    """

    def __init__(self, config: Optional[SolverConfig] = None, *,
                 device=None, mesh=None, **overrides):
        if config is None:
            config = SolverConfig(**overrides)
        elif overrides:
            config = config.replace(**overrides)
        if mesh is not None:
            raise NotImplementedError("meshes (the sharded plans) are not "
                                      "ported yet (ROADMAP Queue 1 item 12)")
        self.config = config
        self.device = resolve_device(device)
        self.plan_ = None
        self._plan_sig = None
        self._carry_solver = None
        self._foreign_carry = False   # a JAX snapshot's state: not resumable
        self._outcome = None
        self._x = None
        self._serving = None      # (kernel, sup, coef, sqnorm) after load()
        self.state_ = None
        self.history_ = None
        self.iters_ = None

    # ------------------------------------------------------------- plans
    def plan_for(self, n: int):
        """Resolve (and cache) the execution plan for an n-row dataset."""
        from repro_torch.api.plan import resolve_plan

        resolved = self.config.resolve(n=n, device=self.device)
        sig = (resolved.cache, resolved.distribution, resolved.restarts,
               resolved.sampler, resolved.jit, resolved.step)
        if self.plan_ is None or sig != self._plan_sig:
            self.plan_ = resolve_plan(self.config, n=n, device=self.device)
            self._plan_sig = sig
        return self.plan_

    def _as_x(self, X) -> torch.Tensor:
        return to_tensor(X, device=self.device, dtype=torch.float32)

    # --------------------------------------------------------------- fit
    def fit(self, X, key: Any = 0, *, init_idx=None, sample_weight=None):
        """Fit on ``(n, d)`` data.  ``key``: int seed or
        ``torch.Generator`` (see :mod:`repro_torch.api.keys`)."""
        X = self._as_x(X)
        plan = self.plan_for(X.shape[0])
        out = plan.executor.fit(X, api_keys.as_key(key), init_idx=init_idx,
                                sample_weight=sample_weight)
        self._set_fitted(X, out)
        return self

    def partial_fit(self, X, key: Any = 0, *, iters: Optional[int] = None):
        """Continue (or start) fitting for ``iters`` more iterations
        (default ``config.max_iters``), resuming the batch stream exactly
        where the previous call stopped."""
        if self._foreign_carry:
            raise NotImplementedError(
                "this estimator was loaded from a JAX snapshot: its "
                "threefry fit key cannot resume a torch generator stream "
                "(fit anew, or serve it as loaded)")
        X = self._as_x(X)
        iters = iters if iters is not None else self.config.max_iters
        if self._outcome is None:
            plan = self.plan_for(X.shape[0])
            out = plan.executor.fit(X, api_keys.as_key(key),
                                    max_iters=iters)
            self._set_fitted(X, out)
            return self
        if self.plan_ is None and self._carry_solver is not None:
            from repro_torch.api.plan import resolve_plan

            self.plan_ = resolve_plan(self.config, n=X.shape[0],
                                      device=self.device,
                                      solver=self._carry_solver)
            self._plan_sig = ("carry", self._carry_solver)
        plan = self.plan_ if self.plan_ is not None \
            else self.plan_for(X.shape[0])
        if not plan.executor.supports_partial_fit:
            raise NotImplementedError(
                f"plan {plan.name!r} does not support partial_fit")
        out = plan.executor.resume(X, self._outcome, iters)
        if self.history_ is not None and out.history is not None:
            out.history = self.history_ + out.history
        self._set_fitted(X, out)
        return self

    def _set_fitted(self, X, out):
        self._x = X
        self._outcome = out
        self._serving = None
        self.state_ = out.state
        self.history_ = out.history
        self.iters_ = out.iters

    # ----------------------------------------------------------- serving
    def _serving_tuple(self):
        if self._serving is not None:
            return self._serving
        if self._outcome is None:
            raise RuntimeError("fit() (or load()) before serving")
        return self.plan_.executor.serving_tuple(self._outcome, self._x)

    def predict(self, X, chunk: int = 4096) -> torch.Tensor:
        """Nearest-center labels (nq,) int32 for coordinate queries."""
        kern, sup, coef, sqnorm = self._serving_tuple()
        return assign_chunked(kern, coef, sqnorm, sup, self._as_x(X), chunk)

    def transform(self, X, chunk: int = 4096) -> torch.Tensor:
        """Feature-space distances d(x, C_j), (nq, k)."""
        kern, sup, coef, sqnorm = self._serving_tuple()
        return center_distances_chunked(kern, coef, sqnorm, sup,
                                        self._as_x(X), chunk)

    def score(self, X) -> float:
        """Negative clustering objective (mean min squared feature-space
        distance) — higher is better, sklearn-style."""
        d = self.transform(X)
        return -float(torch.mean(torch.min(d, dim=1).values))

    def fit_predict(self, X, key: Any = 0, **kw):
        return self.fit(X, key, **kw).predict(X)

    # -------------------------------------------------------- save / load
    def save_atomic(self, path: str) -> str:
        """:meth:`save` through a same-directory temp file + ``os.replace``
        — a concurrent reader sees the complete old or new file."""
        tmp = f"{path}.tmp.{os.getpid()}"
        self.save(tmp)
        os.replace(tmp, path)
        return path

    def save(self, path: str) -> str:
        """Serialize the serving state (support coordinates, coefficients,
        center norms), the config and — for a resumable fit — the center
        state, the fit generator's state and the step cursor, in save
        format 3."""
        kern, sup, coef, sqnorm = self._serving_tuple()
        name, params = kernel_spec(kern)
        meta = {"format": 3, "kernel": name, "kernel_params": params,
                "config": {f: getattr(self.config, f)
                           for f in _JSON_FIELDS},
                "compress": dict(_COMPRESS_STATS)}
        arrays = dict(sup=sup.detach().cpu().numpy(),
                      coef=coef.detach().cpu().numpy(),
                      sqnorm=sqnorm.detach().cpu().numpy())
        resumable = (self.plan_.executor.supports_partial_fit
                     if self.plan_ is not None else self._x is None)
        carry = carry_of(self._outcome) if resumable else None
        if carry is not None:
            for f, v in zip(CenterState._fields,
                            state_to_numpy(carry.state)):
                arrays[f"carry_{f}"] = v
            arrays[_GEN_ARRAY] = carry.key.get_state().numpy()
            meta["carry"] = {"steps": carry.steps, "iters": carry.iters,
                             "solver": (self.plan_.name
                                        if self.plan_ is not None
                                        else self._carry_solver)}
        buf = io.BytesIO()
        np.savez(buf, meta=np.frombuffer(
            json.dumps(meta).encode(), dtype=np.uint8), **arrays)
        payload = buf.getvalue()
        with open(path, "wb") as f:
            f.write(payload)
            f.write(_CRC_FOOTER.pack(_CRC_MAGIC, zlib.crc32(payload)))
        return path

    @classmethod
    def load(cls, path: str, device=None) -> "KernelKMeans":
        """Rebuild a serving estimator on ``device`` (default ``"cuda"``).
        A port snapshot of a resumable fit is also resumable; a JAX
        snapshot's center state loads as ``state_`` but cannot resume."""
        dev = resolve_device(device)
        payload = _verified_payload(path)
        try:
            with np.load(io.BytesIO(payload)) as data:
                meta = json.loads(bytes(data["meta"]).decode())
                arrays = {f: np.asarray(data[f]) for f in data.files}
        except (zipfile.BadZipFile, KeyError, OSError,
                json.JSONDecodeError, EOFError, ValueError) as e:
            raise SnapshotIntegrityError(
                f"undecodable snapshot {path}: {e}") from e
        fmt = meta.get("format", 1)
        if fmt > 3:
            raise ValueError(f"snapshot format {fmt} is newer than this "
                             "build understands (<= 3)")
        cfg_dict = dict(meta["config"])
        cfg_dict["kernel"] = meta["kernel"]
        cfg_dict["kernel_params"] = meta["kernel_params"]
        est = cls(SolverConfig(**cfg_dict), device=dev)
        f32 = dict(device=dev, dtype=torch.float32)
        est._serving = (make_kernel(meta["kernel"], **meta["kernel_params"]),
                        to_tensor(arrays["sup"], **f32),
                        to_tensor(arrays["coef"], **f32),
                        to_tensor(arrays["sqnorm"], **f32))
        if "carry_idx" in arrays:
            state = state_from_numpy(
                {f: arrays[f"carry_{f}"] for f in CenterState._fields},
                device=dev)
            est.state_ = state
            est.iters_ = meta["carry"]["iters"]
            if _GEN_ARRAY in arrays:
                gen = torch.Generator()
                gen.set_state(to_tensor(arrays[_GEN_ARRAY]))
                cmeta = meta["carry"]
                est._outcome = outcome_from_carry(FitCarry(
                    state=state, key=gen, steps=cmeta["steps"],
                    iters=cmeta["iters"]))
                est._carry_solver = cmeta.get("solver")
            else:
                est._foreign_carry = True
        return est
