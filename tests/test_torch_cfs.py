"""The port's CFS against the JAX package's, on the CPU.

``tests/test_cfs.py``'s cases go through both packages: equal
``selected_indices_`` and ``merit_`` within rtol 1e-6; the streamed path
past ``FULL_SU_MAX_P`` selects as the full one.  The ``KBinsDiscretizer``
stand-in (the GPU host has no scikit-learn) must give scikit-learn's edges
and codes.
"""

import warnings

import numpy as np
import pandas as pd
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal
from sklearn.preprocessing import KBinsDiscretizer

import fastselect_tpu
import fastselect_tpu.models.cfs as JC
import fastselect_tpu_torch.models.cfs as TC
from fastselect_tpu_torch import CFS
from fastselect_tpu_torch.interop import estimator_from_jax
from fastselect_tpu_torch.utils.sklearn_compat import (NotFittedError,
                                                       _KBinsDiscretizer)

torch.set_num_threads(2)


def _sample_data():
    """tests/test_cfs.py's fixture: f0 strong signal; f1 redundant copy of
    f0; f2 independent moderate signal; f3 noise; f4 constant; f5
    high-cardinality discrete."""
    rs = np.random.RandomState(42)
    n = 200
    y = rs.randint(0, 2, n)
    f0 = y + rs.normal(0, 0.1, n)
    f1 = f0 + rs.normal(0, 0.05, n)
    f2 = y + rs.normal(0, 0.5, n)
    f2[y == 0] -= 0.5
    f3 = rs.rand(n) * 10
    f4 = np.full(n, 5.0)
    f5 = rs.randint(0, 40, n).astype(float)
    return np.column_stack([f0, f1, f2, f3, f4, f5]), y


def _classification(seed, n, p):
    """Noise with a planted signal (column 0 = y + noise, column 1 = a
    noisy copy of column 0), as chip_smoke.py's CFS phase."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, p)
    y = rng.randint(0, 3, n)
    X[:, 0] = y + rng.normal(0, 0.1, n)
    X[:, 1] = X[:, 0] + rng.normal(0, 0.05, n)
    X[:, 2] = y * 0.5 + rng.normal(0, 0.6, n)
    return X, y


def _discrete(seed):
    rng = np.random.RandomState(seed)
    y = rng.randint(0, 2, 80)
    X = np.column_stack([y ^ rng.binomial(1, 0.05, 80),
                         rng.randint(0, 3, 80)]).astype(np.int64)
    return X, y


CASES = {
    "sample": (_sample_data, {}),
    "sample-quantile": (_sample_data, dict(strategy="quantile", n_bins=6)),
    "classification": (lambda: _classification(1, 300, 40), {}),
    "classification-5bins": (lambda: _classification(2, 250, 70),
                             dict(n_bins=5)),
    "discrete": (lambda: _discrete(0), {}),
}


@pytest.fixture(autouse=True)
def _quiet():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield


@pytest.mark.parametrize("name", list(CASES))
def test_fit_matches_jax(name):
    make, params = CASES[name]
    X, y = make()
    want = fastselect_tpu.CFS(backend="cpu", **params).fit(X, y)
    got = CFS(backend="cpu", **params).fit(X, y)
    assert_array_equal(got.selected_indices_, want.selected_indices_)
    assert_array_equal(got.support_mask_, want.support_mask_)
    assert_allclose(got.merit_, want.merit_, rtol=1e-6)
    assert got.effective_backend_ == "cpu"
    assert len(got.selected_indices_) > 0


def test_selects_signal_not_redundant():
    X, y = _sample_data()
    c = CFS(backend="cpu").fit(X, y)
    assert 0 in c.selected_indices_
    assert 1 not in c.selected_indices_
    assert 3 not in c.selected_indices_
    assert 4 not in c.selected_indices_
    assert c.merit_ > 0


def test_support_mask_and_get_support():
    X, y = _sample_data()
    c = CFS(backend="cpu").fit(X, y)
    mask = c._get_support_mask()
    assert mask.dtype == bool and mask.sum() == len(c.selected_indices_)
    assert_array_equal(c.get_support(), mask)
    assert_array_equal(c.get_support(indices=True), c.selected_indices_)
    assert_array_equal(c.transform(X), X[:, mask])
    assert_array_equal(CFS(backend="cpu").fit_transform(X, y), X[:, mask])


def test_pandas_roundtrip():
    X, y = _sample_data()
    df = pd.DataFrame(X, columns=[f"f{i}" for i in range(X.shape[1])])
    c = CFS(backend="cpu").fit(df, y)
    assert list(c.feature_names_in_) == list(df.columns)
    out = c.transform(df)
    assert isinstance(out, pd.DataFrame)
    assert list(out.columns) == [f"f{i}" for i in c.selected_indices_]


@pytest.mark.parametrize("name", ["sample", "classification-5bins"])
def test_streaming_matches_full_matrix(monkeypatch, name):
    """Past FULL_SU_MAX_P the SU columns stream (tests/test_cfs.py:105-117)
    and select as the full matrix does."""
    make, params = CASES[name]
    X, y = make()
    full = TC.CFS(backend="cpu", **params).fit(X, y)
    monkeypatch.setattr(TC, "FULL_SU_MAX_P", 5)
    stream = TC.CFS(backend="cpu", **params).fit(X, y)
    assert_array_equal(stream.selected_indices_, full.selected_indices_)
    assert_allclose(stream.merit_, full.merit_, rtol=1e-6)


def test_streaming_case_of_jax_tests(monkeypatch):
    rng = np.random.RandomState(0)
    X = rng.randint(0, 3, (100, 30)).astype(np.float64)
    X[:, 2] = (rng.rand(100) > 0.5) * 2.0
    y = (X[:, 2] > 0).astype(np.float64)
    full = TC.CFS(backend="cpu").fit(X, y)
    monkeypatch.setattr(TC, "FULL_SU_MAX_P", 5)
    monkeypatch.setattr(JC, "FULL_SU_MAX_P", 5)
    stream = TC.CFS(backend="cpu").fit(X, y)
    jstream = JC.CFS(backend="cpu").fit(X, y)
    assert_array_equal(stream.selected_indices_, full.selected_indices_)
    assert_array_equal(stream.selected_indices_, jstream.selected_indices_)
    assert_allclose(stream.merit_, jstream.merit_, rtol=1e-6)


@pytest.mark.parametrize("args", [(0.0, 0, 0.0), (0.8, 1, 0.0),
                                  (0.9, 2, 0.2), (2.1, 5, 1.7),
                                  (1.0, 3, 0.0)])
def test_merit_formula(args):
    assert TC._cfs_merit(*args) == JC._cfs_merit(*args)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_search_and_prune_match_jax(seed):
    rng = np.random.RandomState(seed)
    p = 25
    r_cf = rng.rand(p).astype(np.float32) * 0.6
    r_ff = rng.rand(p, p).astype(np.float32) * 0.5
    r_ff = (r_ff + r_ff.T) / 2
    np.fill_diagonal(r_ff, 0.0)
    col = lambda j: r_ff[:, j]  # noqa: E731
    got = TC._best_first_search(r_cf, col)
    assert got == JC._best_first_search(r_cf, col)
    assert TC._prune_redundant(got, r_cf, col) == \
        JC._prune_redundant(got, r_cf, col)


def test_best_first_min_rcf_floor():
    r_cf = np.array([0.05, 0.08], dtype=np.float32)
    r_ff = np.zeros((2, 2), dtype=np.float32)
    assert TC._best_first_search(r_cf, lambda j: r_ff[:, j]) == []


def test_not_fitted():
    X, _ = _sample_data()
    with pytest.raises(NotFittedError):
        CFS().transform(X)


def test_backends():
    X, y = _sample_data()
    with pytest.raises(ValueError, match="backend"):
        CFS(backend="tpu").fit(X, y)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            CFS(backend="gpu").fit(X, y)
    assert CFS().fit(X, y).effective_backend_ == (
        "cuda" if torch.cuda.is_available() else "cpu")


def test_rejects_one_sample():
    with pytest.raises(ValueError, match="minimum of 2"):
        CFS(backend="cpu").fit(np.ones((1, 3)), np.array([1]))


# ---------------------------------------------------------------------------
# The KBinsDiscretizer stand-in against scikit-learn 1.9
# ---------------------------------------------------------------------------

def _kbins_inputs():
    rng = np.random.RandomState(3)
    X = rng.randn(300, 6)
    X[:, 1] = 2.5                                   # constant
    X[:, 2] = np.repeat([0.0, 1.0, 1.0, 3.0, 7.0, 7.0], 50)  # repeated
    X[:, 3] = rng.exponential(size=300)
    X[:, 4] = rng.randint(0, 4, 300)                # few values
    return X


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("n_bins", [3, 10])
@pytest.mark.parametrize("strategy", ["uniform", "quantile"])
def test_kbins_stand_in_matches_sklearn(strategy, n_bins, dtype):
    X = _kbins_inputs().astype(dtype)
    want = KBinsDiscretizer(n_bins=n_bins, encode="ordinal",
                            strategy=strategy, subsample=None).fit(X)
    got = _KBinsDiscretizer(n_bins=n_bins, encode="ordinal",
                            strategy=strategy, subsample=None).fit(X)
    assert_array_equal(got.n_bins_, want.n_bins_)
    for a, b in zip(got.bin_edges_, want.bin_edges_):
        assert a.dtype == b.dtype
        assert_array_equal(a, b)
    codes = got.transform(X)
    assert codes.dtype == want.transform(X).dtype
    assert_array_equal(codes, want.transform(X))
    assert_array_equal(got.fit_transform(X), codes)
    assert got.n_bins_[1] == 1 and np.all(codes[:, 1] == 0)


def test_kbins_stand_in_warns_like_sklearn():
    X = _kbins_inputs()
    with pytest.warns(UserWarning, match="Feature 1 is constant"):
        _KBinsDiscretizer(n_bins=10, strategy="quantile").fit(X)
    with pytest.warns(UserWarning, match="Bins whose width are too small"):
        _KBinsDiscretizer(n_bins=10, strategy="quantile").fit(X[:, 2:3])


def test_kbins_stand_in_kmeans_needs_sklearn():
    with pytest.raises(ImportError, match="KMeans"):
        _KBinsDiscretizer(n_bins=4, strategy="kmeans").fit(_kbins_inputs())


@pytest.mark.parametrize("strategy", ["uniform", "quantile"])
def test_cfs_with_the_stand_in_matches(monkeypatch, strategy):
    X, y = _classification(4, 200, 30)
    want = CFS(backend="cpu", strategy=strategy).fit(X, y)
    monkeypatch.setattr(TC, "KBinsDiscretizer", _KBinsDiscretizer)
    got = CFS(backend="cpu", strategy=strategy).fit(X, y)
    assert_array_equal(got.selected_indices_, want.selected_indices_)
    assert got.merit_ == want.merit_


def test_estimator_from_jax():
    X, y = _sample_data()
    df = pd.DataFrame(X, columns=[f"f{i}" for i in range(X.shape[1])])
    jest = fastselect_tpu.CFS(n_bins=8).fit(df, y)
    est = estimator_from_jax(jest)
    assert type(est) is CFS
    assert est.get_params() == dict(n_bins=8, strategy="uniform",
                                    backend="auto", n_jobs=-1)
    for name in ("selected_indices_", "support_mask_", "feature_names_in_"):
        assert_array_equal(getattr(est, name), getattr(jest, name))
    assert est.merit_ == jest.merit_ and isinstance(est.merit_, float)
    assert est.effective_backend_ == jest.effective_backend_
    assert list(est.transform(df).columns) == list(jest.transform(df).columns)
