"""``fast_select_torch``, the port's drop-in for the upstream import
surface, against the JAX package's ``fast_select``.

Every submodule of ``fast_select`` has a counterpart with the same
``__all__`` and the same objects' kinds; the reference's private helpers
equal the JAX shim's exactly on seeded inputs; the drop-in imports no JAX;
``backend='gpu'`` is valid, as upstream, and raises ``RuntimeError``
without a CUDA device.
"""

import importlib
import json
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from numpy.testing import assert_array_equal

import fast_select
import fast_select_torch
import fastselect_tpu_torch

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
SUBMODULES = sorted(m.name for m in pkgutil.iter_modules(fast_select.__path__))


def test_every_submodule_has_a_counterpart():
    ours = sorted(m.name for m in pkgutil.iter_modules(
        fast_select_torch.__path__))
    assert ours == SUBMODULES
    assert fast_select_torch.__all__ == fast_select.__all__
    for name in fast_select.__all__:
        assert getattr(fast_select_torch, name) is getattr(
            fastselect_tpu_torch, name)


@pytest.mark.parametrize("name", SUBMODULES)
def test_submodule_exports_match(name):
    ref = importlib.import_module(f"fast_select.{name}")
    got = importlib.import_module(f"fast_select_torch.{name}")
    assert got.__all__ == ref.__all__
    for attr in ref.__all__:
        a, b = getattr(got, attr), getattr(ref, attr)
        assert type(a) is type(b) or (isinstance(a, type)
                                      and isinstance(b, type)), attr
        if callable(a):
            assert not a.__module__.startswith(("fast_select.",
                                                "fastselect_tpu.")), attr
        else:
            assert a == b, attr


def test_max_k_for_kernel():
    from fast_select.MDR import MAX_K_FOR_KERNEL as ref
    from fast_select_torch.MDR import MAX_K_FOR_KERNEL
    from fastselect_tpu_torch.models.mdr import MAX_K_FOR_KERNEL as port
    assert MAX_K_FOR_KERNEL == ref == port
    assert type(MAX_K_FOR_KERNEL) is type(ref)


@pytest.mark.parametrize("dtype", [np.float64, np.int64, np.float32])
def test_chi2_helpers_match_jax_shim(dtype, rng):
    ref = importlib.import_module("fast_select.Chi2")
    got = importlib.import_module("fast_select_torch.Chi2")
    X = rng.randint(0, 5, (60, 9)).astype(dtype)
    X[:, 4] = 0                                 # a zero-count feature
    y = rng.randint(0, 3, 60)
    args = (X, y, 9, 3)
    obs, counts = got._compute_observed_and_feature_counts(*args)
    obs_r, counts_r = ref._compute_observed_and_feature_counts(*args)
    assert_array_equal(obs, obs_r)
    assert_array_equal(counts, counts_r)
    assert obs.dtype == obs_r.dtype and counts.dtype == counts_r.dtype
    freqs = np.bincount(y, minlength=3).astype(np.float64)
    stats = got._chi2_core(obs, freqs, counts, 60)
    assert_array_equal(stats, ref._chi2_core(obs_r, freqs, counts_r, 60))
    assert stats[4] == 0.0 and np.isfinite(stats).all()


@pytest.mark.parametrize("dtype", [np.int8, np.int32, np.float64])
def test_encode_data_matches_jax_shim(dtype, rng):
    ref = importlib.import_module("fast_select.mRMR")
    got = importlib.import_module("fast_select_torch.mRMR")
    X = rng.randint(-2, 4, (40, 7)).astype(dtype)
    y = rng.randint(0, 2, 40).astype(dtype)
    vocab = np.unique(np.concatenate([X.ravel(), y]))
    for a, b in zip(got._encode_data_numba(X, y, vocab),
                    ref._encode_data_numba(X, y, vocab)):
        assert a.dtype == b.dtype == dtype
        assert_array_equal(a, b)


def test_import_and_fit_without_jax():
    """A process that imports the drop-in and fits with it holds no JAX
    module."""
    code = """
import json, sys
import numpy as np
import fast_select_torch as fs
from fast_select_torch.mutual_information import calculate_mi_matrices
rs = np.random.RandomState(0)
X = rs.randint(0, 3, (60, 12))
y = rs.randint(0, 2, 60)
X[:, 3] = 2 * y
ests = [fs.MultiSURF(n_features_to_select=2, backend="cpu"),
        fs.ReliefF(n_features_to_select=2, backend="cpu"),
        fs.TuRF(fs.SURF(backend="cpu"), n_features_to_select=2),
        fs.mRMR(n_features_to_select=2, backend="cpu")]
top = [3 in est.fit(X, y).top_features_ for est in ests]
top.append(int(np.argmax(fs.chi2(X, y, backend="cpu")[0])) == 3)
fs.CFS(backend="cpu").fit(X, y)
fs.MDR(k=2, cv=3, backend="cpu").fit(X[:, :5], y)
calculate_mi_matrices(X[:, :4].astype(np.int32), y.astype(np.int32))
print(json.dumps({"top": top, "loaded": sorted(
    m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib",
                                                  "fastselect_tpu",
                                                  "fast_select"))}))
"""
    env = os.environ.copy()
    env["PYTHONPATH"] = str(REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["loaded"] == []
    assert out["top"] == [True] * 5


@pytest.mark.parametrize("make", [
    lambda fs: fs.MultiSURF(backend="gpu"),
    lambda fs: fs.ReliefF(backend="gpu"),
    lambda fs: fs.SURF(backend="gpu"),
    lambda fs: fs.TuRF(fs.MultiSURF(backend="gpu")),
    lambda fs: fs.mRMR(n_features_to_select=2, backend="gpu"),
    lambda fs: fs.CFS(backend="gpu"),
    lambda fs: fs.MDR(backend="gpu"),
    lambda fs: (lambda X, y: fs.chi2(X, y, backend="gpu")),
], ids=["MultiSURF", "ReliefF", "SURF", "TuRF", "mRMR", "CFS", "MDR",
        "chi2"])
def test_gpu_backend_raises_without_a_card(make, monkeypatch, rng):
    """'gpu' is accepted, as upstream, and needs a CUDA device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X = rng.randint(0, 3, (40, 6))
    y = rng.randint(0, 2, 40)
    with pytest.raises(RuntimeError, match="CUDA"):
        est = make(fast_select_torch)
        (est.fit if hasattr(est, "fit") else est)(X, y)


@pytest.mark.parametrize("name", SUBMODULES)
def test_names_survive_submodule_imports(name):
    """Importing ``fast_select_torch.MultiSURF`` (the module) leaves
    ``fast_select_torch.MultiSURF`` the class, as upstream."""
    importlib.import_module(f"fast_select_torch.{name}")
    for attr in fast_select_torch.__all__:
        assert getattr(fast_select_torch, attr) is getattr(
            fastselect_tpu_torch, attr)
