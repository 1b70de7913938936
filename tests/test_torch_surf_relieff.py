"""The port's SURF and ReliefF estimators against the JAX package's, on the
CPU, and the integer genotype fast path of every Relief estimator.

Fixtures follow ``tests/test_surf.py`` and ``tests/test_relieff.py``.  The
JAX CPU fit runs its generic or discrete engine; the port runs its fused
engine with the plain passes, or its discrete engine on all-discrete data.
Scores agree to rtol 1e-4, atol 1e-5 (float32 sums in another order), as
``tests/test_torch_multisurf.py`` holds MultiSURF, and ``top_features_``
exactly.
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal
from sklearn.utils.estimator_checks import check_estimator

import fastselect_tpu
import fastselect_tpu_torch
from fastselect_tpu_torch.interop import estimator_from_jax
from test_torch_multisurf import _run

torch.set_num_threads(2)


def _surf_mixed(rng):
    X = rng.rand(41, 23).astype(np.float32)
    X[:, 5] = rng.randint(0, 4, 41)
    return X, rng.randint(0, 2, 41)


def _relevant(rng):
    y = np.repeat([0, 1], 20)
    X = np.column_stack([np.where(y == 0, 0.0, 5.0) + rng.randn(40) * 0.3,
                         rng.randn(40), rng.randn(40)]).astype(np.float32)
    return X, y


def _zero_range(rng):
    X = rng.rand(20, 3).astype(np.float32)
    X[:, 1] = 7.0
    return X, rng.randint(0, 2, 20)


def _discrete_limit(rng):
    X = np.array([[i, i % 3] for i in range(11)] * 2, dtype=np.float32)
    return X, np.array([0] * 11 + [1] * 11)


def _relieff_binary(rng):
    X = rng.rand(35, 13).astype(np.float32)
    X[:, 2] = rng.randint(0, 3, 35)
    return X, rng.randint(0, 2, 35)


def _multiclass(rng):
    return rng.rand(42, 9).astype(np.float32), rng.randint(0, 4, 42)


def _genotypes(rng, n=90, p=40, ncls=2):
    X = rng.randint(0, 3, (n, p))
    y = rng.randint(0, ncls, n)
    X[:, 2] = 2 * (y == 1)
    return X, y


def _genotypes_float(rng):
    X, y = _genotypes(rng, ncls=3)
    return X.astype(np.float64) * 0.5 - 1, y


FIXTURES = {
    "SURF": {
        "oracle_mixed": (_surf_mixed, dict(n_features_to_select=5)),
        "oracle_mixed_star": (_surf_mixed, dict(n_features_to_select=5,
                                                use_star=True)),
        "relevant": (_relevant, dict(n_features_to_select=1)),
        "zero_range": (_zero_range, dict(n_features_to_select=1)),
        "discrete_limit": (_discrete_limit, dict(discrete_limit=12)),
        "continuous": (_multiclass, dict(n_features_to_select=3)),
        "int_genotypes": (_genotypes, dict(n_features_to_select=5)),
        "int_genotypes_star": (_genotypes, dict(n_features_to_select=5,
                                                use_star=True)),
        "float_genotypes": (_genotypes_float, dict(n_features_to_select=5)),
    },
    "ReliefF": {
        "binary_k1": (_relieff_binary, dict(n_features_to_select=5,
                                            n_neighbors=1)),
        "binary_k3": (_relieff_binary, dict(n_features_to_select=5)),
        "binary_k7": (_relieff_binary, dict(n_features_to_select=5,
                                            n_neighbors=7)),
        "multiclass": (_multiclass, dict(n_features_to_select=3)),
        "relevant": (_relevant, dict(n_features_to_select=1)),
        "zero_range": (_zero_range, dict(n_features_to_select=2)),
        "int_genotypes": (_genotypes, dict(n_features_to_select=5,
                                           n_neighbors=5)),
        "float_genotypes": (_genotypes_float, dict(n_features_to_select=5,
                                                   n_neighbors=4)),
    },
}
CASES = [(est, name) for est, fx in FIXTURES.items() for name in fx]


@pytest.mark.parametrize("est,name", CASES)
def test_matches_jax_estimator(est, name, rng):
    make, params = FIXTURES[est][name]
    X, y = make(rng)
    port = getattr(fastselect_tpu_torch, est)(backend="cpu", **params)
    ref = getattr(fastselect_tpu, est)(backend="cpu", **params)
    port.fit(X, y)
    ref.fit(X, y)
    assert port.effective_backend_ == "cpu"
    assert_allclose(port.feature_importances_, ref.feature_importances_,
                    rtol=1e-4, atol=1e-5)
    assert_array_equal(port.top_features_, ref.top_features_)
    assert_array_equal(port.is_discrete_, ref.is_discrete_)
    if est == "ReliefF":
        assert_array_equal(port.classes_, ref.classes_)


@pytest.mark.parametrize("est", ["SURF", "ReliefF"])
def test_check_estimator(est):
    check_estimator(getattr(fastselect_tpu_torch, est)(backend="cpu"))


def test_relieff_single_class_early_exit(rng):
    X = rng.rand(10, 4)
    m = fastselect_tpu_torch.ReliefF(n_features_to_select=2,
                                     backend="cpu").fit(X, np.zeros(10))
    ref = fastselect_tpu.ReliefF(n_features_to_select=2,
                                 backend="cpu").fit(X, np.zeros(10))
    assert_array_equal(m.feature_importances_, ref.feature_importances_)
    assert m.feature_importances_.dtype == np.float32
    assert list(m.top_features_) == list(ref.top_features_) == [0, 1]
    assert m.effective_backend_ == ref.effective_backend_ == "cpu"


def test_relieff_small_class_warns(rng):
    X = rng.rand(10, 3)
    y = np.array([0] * 8 + [1] * 2)
    with pytest.warns(UserWarning, match="smallest class size"):
        fastselect_tpu_torch.ReliefF(n_neighbors=3, backend="cpu").fit(X, y)


@pytest.mark.parametrize("bad_k", [0, -1, 12, 100, 2.5])
def test_relieff_bad_n_neighbors(bad_k, rng):
    X = rng.rand(12, 3)
    y = rng.randint(0, 2, 12)
    with pytest.raises(ValueError, match="n_neighbors"):
        fastselect_tpu_torch.ReliefF(n_neighbors=bad_k,
                                     backend="cpu").fit(X, y)


@pytest.mark.parametrize("est,kw,expected", [
    ("SURF", {}, ["Running SURF on the CPU now...",
                  "Feature scoring completed."]),
    ("SURF", {"use_star": True}, ["Running SURF* on the CPU now..."]),
    ("ReliefF", {}, ["Running ReliefF on the CPU now..."]),
])
def test_verbose_strings(est, kw, expected, capsys, rng):
    X, y = rng.rand(12, 4), rng.randint(0, 2, 12)
    getattr(fastselect_tpu, est)(verbose=True, backend="cpu", **kw).fit(X, y)
    ref = capsys.readouterr().out
    getattr(fastselect_tpu_torch, est)(verbose=True, backend="cpu",
                                       **kw).fit(X, y)
    out = capsys.readouterr().out
    assert out == ref
    for line in expected:
        assert line in out


@pytest.mark.parametrize("est", ["MultiSURF", "SURF", "ReliefF"])
def test_estimator_from_jax_roundtrip(est, rng):
    X, y = _relieff_binary(rng)
    ref = getattr(fastselect_tpu, est)(n_features_to_select=4,
                                       backend="cpu").fit(X, y)
    port = estimator_from_jax(ref)
    assert type(port) is getattr(fastselect_tpu_torch, est)
    assert port.get_params() == ref.get_params()
    assert_array_equal(port.transform(X), ref.transform(X))
    refit = type(port)(**port.get_params()).fit(X, y)
    assert_array_equal(refit.top_features_, port.top_features_)
    if est == "ReliefF":
        assert_array_equal(port.classes_, ref.classes_)
    with pytest.raises(TypeError):
        estimator_from_jax(getattr(fastselect_tpu, est)())   # not fitted


# ---------------------------------------------------------------------------
# Integer genotype fast path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.int8, np.int32, np.int64, np.uint8])
def test_int_fast_analysis_codes_are_x(dtype, rng):
    X = rng.randint(0, 3, (30, 9)).astype(dtype)
    est = fastselect_tpu_torch.MultiSURF(backend="cpu")
    est.effective_backend_ = "cpu"
    fa = est._int_fast_analysis(X)
    assert fa.codes.dtype == torch.int8 and fa.x_dev is None
    assert fa.n_states == 3
    assert_array_equal(fa.codes.numpy(), X)
    assert fa.is_discrete.all() and (fa.recip == 1).all()


@pytest.mark.parametrize("X", [
    np.array([[0, 1], [2, -1]], np.int8),      # negative
    np.array([[0, 1], [2, -1]]),
    np.array([[0, 1], [2, 10]], np.uint8),     # max + 1 > discrete_limit
    np.array([[0, 1], [2, 10]]),
    np.array([[0, 1], [2, 200]], np.uint8),    # past int8
])
def test_int_fast_path_not_taken(X):
    est = fastselect_tpu_torch.MultiSURF(backend="cpu")
    est.effective_backend_ = "cpu"
    assert est._int_fast_analysis(X) is None


@pytest.mark.parametrize("X", [
    np.array([[0, 1], [2, 11], [1, 3]]),                   # continuous column
    np.array([[0, 1], [2, 11], [1, 3]], np.uint8) * 20,    # wraps in int8
    np.array([[0.0, 1.0], [2.0, 1.0], [1.0, 0.0]]),        # not integer
    [[0, 1], [2, 1], [1, 0]],                              # not an ndarray
])
def test_non_fast_input_fits_as_floats(X):
    """Input the fast path does not take is analysed as floats, exactly
    as the float matrix would be."""
    y = np.array([0, 1, 0])
    a = fastselect_tpu_torch.MultiSURF(n_features_to_select=1,
                                       discrete_limit=2,
                                       backend="cpu").fit(X, y)
    b = fastselect_tpu_torch.MultiSURF(n_features_to_select=1,
                                       discrete_limit=2, backend="cpu").fit(
        np.asarray(X, np.float64), y)
    assert_array_equal(a.feature_importances_, b.feature_importances_)
    assert_array_equal(a.is_discrete_, b.is_discrete_)


@pytest.mark.parametrize("est", ["MultiSURF", "SURF", "ReliefF"])
def test_int_input_scores_as_float_input(est, rng):
    X, y = _genotypes(rng, ncls=3)
    make = getattr(fastselect_tpu_torch, est)
    a = make(n_features_to_select=4, backend="cpu").fit(X.astype(np.int8), y)
    b = make(n_features_to_select=4, backend="cpu").fit(X.astype(np.float64),
                                                       y)
    assert_allclose(a.feature_importances_, b.feature_importances_,
                    atol=1e-7)
    assert_array_equal(a.top_features_, b.top_features_)
    assert a.is_discrete_.all() and b.is_discrete_.all()
    assert_array_equal(a.transform(X), b.transform(X))


_INT_FIT = """
import json, sys
import numpy as np
{prelude}
import torch
torch.set_num_threads(1)
import fastselect_tpu_torch as ft
rng = np.random.RandomState(0)
X = rng.randint(0, 3, (70, 12)).astype(np.int8)
y = rng.randint(0, 2, 70)
X[:, 4] = 2 * y
out = {{"sklearn": ft.utils.sklearn_compat.HAVE_SKLEARN}}
for name in ("MultiSURF", "SURF", "ReliefF"):
    m = getattr(ft, name)(n_features_to_select=3, backend="cpu").fit(X, y)
    out[name] = [m.feature_importances_.tolist(), m.top_features_.tolist()]
print(json.dumps(out))
"""


def test_int_fit_without_sklearn_matches():
    """The stand-in ``validate_data`` takes ``dtype="numeric"``, so the
    integer fast path also runs where scikit-learn is missing."""
    blocked = _run(_INT_FIT.format(prelude="sys.modules['sklearn'] = None"))
    normal = _run(_INT_FIT.format(prelude=""))
    assert blocked.pop("sklearn") is False and normal.pop("sklearn") is True
    assert blocked == normal
    assert all(v[1][0] == 4 for v in blocked.values())
