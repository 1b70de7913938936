"""The port's MultiSURF estimator against the JAX package's, on the CPU.

Fixtures follow ``tests/test_multisurf.py``.  The JAX CPU fit runs its
generic or discrete engine, the port its fused engine with the plain
passes: scores agree to rtol 1e-4, atol 1e-5 (float32 sums in another
order) and ``top_features_`` exactly.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal
from sklearn.exceptions import NotFittedError
from sklearn.utils.estimator_checks import check_estimator

import fastselect_tpu
import fastselect_tpu_torch
from fastselect_tpu_torch import _build
from fastselect_tpu_torch.interop import estimator_from_jax
from fastselect_tpu_torch.utils.backend import default_device, resolve_backend

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent


def _simple_data():
    X = np.array([
        [1.0, 5.1, 10, 3.0], [1.4, 3.9, 10, 3.0], [2.1, 6.2, 10, 3.0],
        [2.6, 5.4, 10, 3.0], [1.7, 4.4, 20, 3.0], [8.5, 5.2, 20, 3.0],
        [9.0, 4.1, 20, 3.0], [9.6, 6.1, 20, 3.0], [10.2, 4.6, 20, 3.0],
        [10.4, 4.3, 10, 3.0],
    ], dtype=np.float32)
    return X, np.array([0, 0, 0, 0, 0, 1, 1, 1, 1, 1])


def _mixed(rng):
    X = rng.rand(37, 19).astype(np.float32)
    X[:, 3] = rng.randint(0, 3, 37)
    X[:, 7] = rng.randint(0, 5, 37)
    return X, rng.randint(0, 2, 37)


def _multiclass(rng):
    return rng.rand(30, 11).astype(np.float32), rng.randint(0, 3, 30)


def _continuous(rng):
    X = rng.rand(150, 40).astype(np.float32)
    y = rng.randint(0, 2, 150)
    X[:, 5] += 0.5 * y
    return X, y


def _all_discrete_int(rng):
    X = rng.randint(0, 3, (80, 40))
    y = rng.randint(0, 2, 80)
    X[:, 2] = 2 * y
    return X, y


FIXTURES = {
    "simple": (_simple_data, dict(n_features_to_select=2, discrete_limit=4)),
    "oracle_mixed": (_mixed, dict(n_features_to_select=5)),
    "oracle_mixed_star": (_mixed, dict(n_features_to_select=5,
                                       use_star=True)),
    "multiclass": (_multiclass, dict(n_features_to_select=3)),
    "continuous": (_continuous, dict(n_features_to_select=6)),
    "continuous_star": (_continuous, dict(n_features_to_select=6,
                                          use_star=True)),
    "int_genotypes": (_all_discrete_int, dict(n_features_to_select=5)),
}


@pytest.mark.parametrize("name", list(FIXTURES))
def test_matches_jax_estimator(name, rng):
    make, params = FIXTURES[name]
    X, y = make(rng) if name != "simple" else make()
    port = fastselect_tpu_torch.MultiSURF(backend="cpu", **params).fit(X, y)
    ref = fastselect_tpu.MultiSURF(backend="cpu", **params).fit(X, y)
    assert port.effective_backend_ == "cpu"
    assert_allclose(port.feature_importances_, ref.feature_importances_,
                    rtol=1e-4, atol=1e-5)
    assert_array_equal(port.top_features_, ref.top_features_)
    assert_array_equal(port.is_discrete_, ref.is_discrete_)
    assert port.n_features_in_ == ref.n_features_in_


def test_estimator_from_jax_roundtrip(rng):
    X, y = _mixed(rng)
    ref = fastselect_tpu.MultiSURF(n_features_to_select=5, backend="cpu",
                                   use_star=True).fit(X, y)
    port = estimator_from_jax(ref)
    assert isinstance(port, fastselect_tpu_torch.MultiSURF)
    assert port.get_params() == {k: v for k, v in ref.get_params().items()
                                 if k != "transfer_dtype"}
    assert_array_equal(port.transform(X), ref.transform(X))
    assert_array_equal(port.feature_importances_, ref.feature_importances_)
    refit = fastselect_tpu_torch.MultiSURF(**port.get_params()).fit(X, y)
    assert_array_equal(refit.top_features_, port.top_features_)
    with pytest.raises(TypeError):
        estimator_from_jax(fastselect_tpu.MultiSURF())   # not fitted


def test_backend_strings():
    assert resolve_backend("auto") == "cpu"
    assert resolve_backend("cpu") == "cpu"
    assert default_device("cpu") == torch.device("cpu")
    for forced in ("cuda", "gpu"):
        with pytest.raises(RuntimeError, match="no CUDA-enabled GPU"):
            resolve_backend(forced, "MultiSURF")
    with pytest.raises(ValueError, match="backend must be one of"):
        resolve_backend("tpu")


@pytest.mark.parametrize("backend", ["cuda", "gpu"])
def test_forced_gpu_without_card_raises(backend):
    X, y = _simple_data()
    with pytest.raises(RuntimeError, match="no CUDA-enabled GPU"):
        fastselect_tpu_torch.MultiSURF(backend=backend,
                                       n_features_to_select=2).fit(X, y)


def test_auto_backend_fits_on_cpu():
    X, y = _simple_data()
    m = fastselect_tpu_torch.MultiSURF(n_features_to_select=1,
                                       discrete_limit=4).fit(X, y)
    assert m.effective_backend_ == "cpu"
    assert set(m.top_features_) == {0}


def test_input_checks():
    X, y = _simple_data()
    MS = fastselect_tpu_torch.MultiSURF
    Xn = X.copy()
    Xn[0, 0] = np.nan
    with pytest.raises(ValueError, match="NaN"):
        MS(backend="cpu", n_features_to_select=2).fit(Xn, y)
    with pytest.raises(ValueError, match="at least 2 samples"):
        MS(n_features_to_select=1).fit(np.ones((1, 3)), np.zeros(1))
    with pytest.raises(ValueError, match="backend must be one of"):
        MS(backend="tpu").fit(X, y)
    with pytest.raises(ValueError):
        MS(n_features_to_select=100).fit(X, y)
    with pytest.raises(NotFittedError):
        MS().transform(X)


def test_verbose_output(capsys):
    X, y = _simple_data()
    fastselect_tpu_torch.MultiSURF(verbose=True, backend="cpu").fit(X, y)
    assert "Running MultiSURF on the CPU now..." in capsys.readouterr().out
    fastselect_tpu_torch.MultiSURF(verbose=True, use_star=True,
                                   backend="cpu").fit(X, y)
    assert "Running MultiSURF*" in capsys.readouterr().out


def test_check_estimator():
    check_estimator(fastselect_tpu_torch.MultiSURF(backend="cpu"))


def _run(code):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


_FIT = """
import json, sys
import numpy as np
{prelude}
import torch
torch.set_num_threads(1)
import fastselect_tpu_torch as ft
rng = np.random.RandomState(0)
X = rng.rand(60, 9).astype(np.float32)
X[:, 2] = rng.randint(0, 3, 60)
y = rng.randint(0, 2, 60)
m = ft.MultiSURF(n_features_to_select=3, backend="cpu").fit(X, y)
print(json.dumps({{"jax": "jax" in sys.modules,
                   "sklearn": ft.utils.sklearn_compat.HAVE_SKLEARN,
                   "scores": m.feature_importances_.tolist(),
                   "top": m.top_features_.tolist(),
                   "cols": m.transform(X).tolist()}}))
"""


@pytest.fixture(scope="module")
def fresh_fit():
    """A CPU fit in a fresh interpreter that imports only the port."""
    return _run(_FIT.format(prelude=""))


def test_port_never_imports_jax(fresh_fit):
    assert fresh_fit["jax"] is False and fresh_fit["sklearn"] is True


def test_fit_without_sklearn_matches(fresh_fit):
    """Without scikit-learn (as on a GPU host that lacks it) the estimator
    fits through the minimal stand-in base and gives the same model."""
    blocked = _run(_FIT.format(prelude="sys.modules['sklearn'] = None"))
    normal = fresh_fit
    assert blocked["sklearn"] is False
    for key in ("scores", "top", "cols"):
        assert blocked[key] == normal[key]


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="nvcc, the CUDA compiler, was "
                       "not found"):
        _build.build()
    assert not (tmp_path / "kernels").exists()


def test_library_name_tracks_sources(monkeypatch, tmp_path):
    lib = _build.library_path()
    assert lib.parent == _build.BUILD_DIR
    assert lib.name.startswith("libfastselect_kernels_")
    for src in _build._sources():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert _build.library_path() == lib
    with open(tmp_path / "relief_pass2.cu", "a") as f:
        f.write("// edited\n")
    assert _build.library_path() != lib


@pytest.mark.parametrize("kw", [
    dict(n_samples=500, n_features=100, n_informative=10, random_state=0),
    dict(n_samples=100, n_features=3000, random_state=0),
    dict(n_samples=97, n_features=40, n_informative=5, n_classes=3,
         random_state=7),
])
def test_chip_smoke_data_is_make_classification(kw):
    """chip_smoke.py draws sklearn.datasets.make_classification's data
    with numpy alone, for hosts without scikit-learn."""
    from sklearn.datasets import make_classification
    import chip_smoke
    X, y = chip_smoke.make_classification(**kw)
    X_ref, y_ref = make_classification(**kw)
    assert_array_equal(X, X_ref)
    assert_array_equal(y, y_ref)
