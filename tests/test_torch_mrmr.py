"""The port's mRMR against the JAX package's, on the CPU.

``tests/test_mrmr.py``'s cases go through both packages: the selections
must be equal, the relevance and redundancy agree within rtol 1e-5 and
atol 1e-7 (JAX's tolerance against its oracle; rtol 1e-5 and atol 4e-7 at
2 states, see ``tests/test_torch_contingency.py``), and the port's
redundancy matrix is bitwise symmetric with a zero diagonal.  The
streamed path past ``FULL_REDUNDANCY_MAX_P`` must select as the full one.
"""

import pickle

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

import fastselect_tpu
import fastselect_tpu.models.mrmr as JM
import fastselect_tpu_torch.models.mrmr as TM
from fastselect_tpu_torch import mRMR
from fastselect_tpu_torch.interop import estimator_from_jax
from fastselect_tpu_torch.utils.sklearn_compat import NotFittedError

torch.set_num_threads(2)

RTOL = 1e-5


def _atol(X, y):
    return 4e-7 if max(np.max(X), np.max(y)) <= 1 else 1e-7


def _data(seed, n, p, s, s_y):
    rng = np.random.RandomState(seed)
    return rng.randint(0, s, (n, p)), rng.randint(0, s_y, n)


CASES = [  # (seed, n, p, states of X, of y, k)
    (0, 60, 9, 4, 3, 4),          # tests/test_mrmr.py's discrete_data
    (1, 120, 60, 4, 3, 8),
    (2, 90, 40, 3, 2, 6),
    (3, 200, 30, 2, 2, 5),
    (4, 150, 25, 140, 2, 5),      # int32 codes
]


@pytest.mark.parametrize("method", ["MID", "MIQ"])
@pytest.mark.parametrize("case", CASES)
def test_fit_matches_jax(case, method):
    seed, n, p, s, s_y, k = case
    X, y = _data(seed, n, p, s, s_y)
    want = fastselect_tpu.mRMR(k, method=method, backend="cpu").fit(X, y)
    got = mRMR(k, method=method, backend="cpu").fit(X, y)
    assert_array_equal(got.top_features_, want.top_features_)
    atol = _atol(X, y)
    assert_allclose(got.relevance_scores_, want.relevance_scores_,
                    rtol=RTOL, atol=atol)
    red = got.redundancy_matrix_
    assert red.dtype == np.float64 and red.shape == (p, p)
    assert_allclose(red, want.redundancy_matrix_, rtol=RTOL, atol=atol)
    assert_array_equal(red, red.T)
    assert_array_equal(np.diag(red), 0.0)
    assert_array_equal(got.unique_vals_, want.unique_vals_)
    assert got.feature_importances_ is got.relevance_scores_


def test_redundant_feature_not_selected():
    rng = np.random.RandomState(0)
    y = rng.randint(0, 2, 100)
    f0 = y.copy()
    f1 = f0.copy()
    f2 = (y + rng.randint(0, 2, 100)) % 3
    f3 = rng.randint(0, 3, 100)
    X = np.column_stack([f0, f1, f2, f3])
    got = mRMR(n_features_to_select=2, backend="cpu").fit(X, y)
    want = fastselect_tpu.mRMR(n_features_to_select=2, backend="cpu").fit(X, y)
    assert_array_equal(got.top_features_, want.top_features_)
    assert got.top_features_[0] in (0, 1)
    assert got.top_features_[1] not in (0, 1)


@pytest.mark.parametrize("X,y", [
    (np.array([[5, 7], [9, 5]]), np.array([7, 9])),
    (np.random.RandomState(0).choice([0, 2, 5, 9], (50, 12)),
     np.random.RandomState(1).choice([1, 2], 50)),
    (np.random.RandomState(2).choice([0, 2, 5, 9], (50, 12)).astype(float),
     np.random.RandomState(3).choice([1, 2], 50).astype(float)),
    (np.random.RandomState(4).randn(30, 3).round(1), np.arange(30) % 2),
])
def test_encode_union_matches_jax(X, y):
    got = TM._encode_union(X, y)
    want = JM._encode_union(X, y)
    for a, b in zip(got, want):
        assert_array_equal(a, b)


def test_encode_union_bincount_path_matches_sorted():
    rng = np.random.RandomState(0)
    X = rng.choice([0, 2, 5, 9], (50, 12)).astype(np.int64)
    y = rng.choice([1, 2], 50).astype(np.int64)
    for a, b in zip(TM._encode_union(X, y),
                    TM._encode_union(X.astype(float), y.astype(float))):
        assert_array_equal(a, b)


@pytest.mark.parametrize("method,seed,s,s_y,k", [("MID", 0, 4, 3, 8),
                                                  ("MIQ", 1, 3, 2, 6),
                                                  ("MID", 2, 6, 2, 7)])
def test_streaming_matches_full_matrix(monkeypatch, method, seed, s, s_y,
                                       k):
    """Past FULL_REDUNDANCY_MAX_P the columns stream from StagedColumnStats
    (tests/test_mrmr.py:125-152): the same selection, and the same
    relevance bit for bit (equal tables, one reduction)."""
    X, y = _data(seed, 120, 60, s, s_y)
    X, y = X.astype(np.float64), y.astype(np.float64)
    full = TM.mRMR(n_features_to_select=k, method=method,
                   backend="cpu").fit(X, y)
    assert full.redundancy_matrix_ is not None
    monkeypatch.setattr(TM, "FULL_REDUNDANCY_MAX_P", 10)
    monkeypatch.setattr(JM, "FULL_REDUNDANCY_MAX_P", 10)
    stream = TM.mRMR(n_features_to_select=k, method=method,
                     backend="cpu").fit(X, y)
    jstream = JM.mRMR(n_features_to_select=k, method=method,
                      backend="cpu").fit(X, y)
    assert stream.redundancy_matrix_ is None
    assert_array_equal(stream.top_features_, full.top_features_)
    assert_array_equal(stream.top_features_, jstream.top_features_)
    assert_array_equal(stream.relevance_scores_, full.relevance_scores_)


def test_redundancy_matrix_lazy_and_pickled():
    """The fit keeps R as a tensor; the first read copies it to the host
    and frees it; pickling carries the host copy."""
    X, y = _data(5, 60, 12, 4, 2)
    est = mRMR(n_features_to_select=4, backend="cpu").fit(X, y)
    assert isinstance(est._redundancy_dev, torch.Tensor)
    clone = pickle.loads(pickle.dumps(est))
    assert est._redundancy_dev is None
    host = est.redundancy_matrix_
    assert est.redundancy_matrix_ is host
    assert_array_equal(clone.redundancy_matrix_, host)
    assert_array_equal(clone.top_features_, est.top_features_)
    refit = est.fit(X[:, :6], y)
    assert refit.redundancy_matrix_.shape == (6, 6)


def test_greedy_over_device_matrix_matches_fit():
    """The greedy loop over matrix_column reads gives the fit's choice."""
    from fastselect_tpu_torch.ops.contingency import (
        matrix_column, pairwise_stat_matrix_device)
    X, y = _data(6, 100, 30, 4, 2)
    ref = mRMR(n_features_to_select=8, backend="cpu").fit(X, y)
    Xe, ye, _ = TM._encode_union(X, y)
    R, p = pairwise_stat_matrix_device(Xe, int(max(Xe.max(), ye.max())) + 1,
                                       "mi")
    est = mRMR(n_features_to_select=8)
    est.n_features_in_ = p
    got = est._greedy_select(ref.relevance_scores_,
                             lambda j: matrix_column(R, j, p))
    assert_array_equal(got, ref.top_features_)


def test_transform_and_fit_transform():
    X, y = _data(0, 60, 9, 4, 3)
    m = mRMR(n_features_to_select=4, backend="cpu")
    out = m.fit_transform(X, y)
    assert out.shape == (60, 4)
    assert_array_equal(out, X[:, m.top_features_])
    assert_array_equal(m.transform(X), out)
    with pytest.raises(ValueError, match="features"):
        m.transform(X[:, :5])


@pytest.mark.parametrize("kw,err,match", [
    (dict(method="bogus"), ValueError, "MID"),
    (dict(backend="bogus"), ValueError, "Backend"),
    (dict(backend="tpu"), ValueError, "Backend"),
])
def test_invalid_params(kw, err, match):
    with pytest.raises(err, match=match):
        mRMR(n_features_to_select=2, **kw)


def test_cuda_backend_needs_a_card():
    if torch.cuda.is_available():
        assert mRMR(n_features_to_select=2, backend="gpu").backend == "gpu"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            mRMR(n_features_to_select=2, backend="gpu")


@pytest.mark.parametrize("k", [0, 100])
def test_invalid_n_features(k):
    X, y = _data(0, 60, 9, 4, 3)
    with pytest.raises(ValueError, match="n_features_to_select"):
        mRMR(n_features_to_select=k, backend="cpu").fit(X, y)


def test_not_fitted():
    with pytest.raises(NotFittedError):
        mRMR(n_features_to_select=2).transform(np.zeros((3, 3)))


@pytest.mark.parametrize("stream", [False, True])
def test_estimator_from_jax(monkeypatch, stream):
    if stream:
        monkeypatch.setattr(JM, "FULL_REDUNDANCY_MAX_P", 5)
    X, y = _data(7, 80, 20, 3, 2)
    jest = fastselect_tpu.mRMR(n_features_to_select=5, method="MIQ").fit(X, y)
    est = estimator_from_jax(jest)
    assert type(est) is mRMR
    assert est.get_params() == dict(n_features_to_select=5, method="MIQ",
                                    backend="auto")
    assert_array_equal(est.top_features_, jest.top_features_)
    assert_array_equal(est.relevance_scores_, jest.relevance_scores_)
    assert_array_equal(est.unique_vals_, jest.unique_vals_)
    if stream:
        assert est.redundancy_matrix_ is None
    else:
        assert_array_equal(est.redundancy_matrix_, jest.redundancy_matrix_)
    assert_array_equal(est.transform(X), jest.transform(X))


@pytest.mark.parametrize("phase,n,p", [("mrmr_phase", 300, 150),
                                       ("mrmr_stream_phase", 300, 400),
                                       ("cfs_phase", 400, 120),
                                       ("cfs_stream_phase", 400, 300)])
def test_chip_smoke_selector_phases_rehearse_on_cpu(monkeypatch, phase, n,
                                                    p):
    """chip_smoke.py's phases 14-17, with their referees, at a small size
    on the CPU (streaming thresholds lowered to below p)."""
    import chip_smoke as cs
    for name in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(TM, "FULL_REDUNDANCY_MAX_P", 200)
    monkeypatch.setattr(cs.cfs_mod, "FULL_SU_MAX_P", 200)
    res, sec = getattr(cs, phase)(torch.device("cpu"), n=n, p=p)
    assert res["gemm_ops"] > 0 and sec > 0
    assert res["est"].n_features_in_ == p
