"""The port's TuRF against the JAX package's, on the CPU.

The loop cases follow ``tests/test_turf.py`` with the same deterministic
mock scorer, run through both packages: equal selections and state.  With
a Relief base estimator the port's fast scorer (one copy of X on the
device, the active columns gathered there each round; on the CPU here) is
held to the port's own re-fitting loop bit for bit on all-discrete,
continuous and mixed data (each round runs the engine a fit on the active
columns takes, on the same values), and to JAX's
``TuRF(MultiSURF(backend='cpu'))`` at the estimator tolerance: equal
``top_features_``, importances within atol 1e-5, rtol 1e-4.
"""

import pickle

import numpy as np
import pytest
import sklearn.base
import torch
from numpy.testing import assert_allclose, assert_array_equal
from sklearn.base import BaseEstimator
from sklearn.exceptions import NotFittedError

import fastselect_tpu
import fastselect_tpu_torch
from fastselect_tpu_torch import MultiSURF, ReliefF, SURF, TuRF
from fastselect_tpu_torch.interop import estimator_from_jax
from fastselect_tpu_torch.models import _relief_base
from fastselect_tpu_torch.utils.sklearn_compat import _clone

torch.set_num_threads(2)


class MockScorer(BaseEstimator):
    """Deterministic importances: feature j scores j (ascending)."""

    def fit(self, X, y):
        self.feature_importances_ = np.linspace(
            0, 1, X.shape[1], dtype=np.float64)
        self.n_features_in_ = X.shape[1]
        return self


class CountingScorer(MockScorer):
    """MockScorer that counts fits and can die after ``die_after`` fits."""

    def __init__(self, die_after=None):
        self.die_after = die_after
        self.n_fits = 0

    def fit(self, X, y):
        self.n_fits += 1
        if self.die_after is not None and self.n_fits > self.die_after:
            raise RuntimeError("simulated crash")
        return super().fit(X, y)

    def __sklearn_clone__(self):
        return self


class RefitTuRF(TuRF):
    """TuRF with the fast scorers off: the base estimator re-fits on the
    active columns every round (the reference's loop)."""

    def _make_fast_scorer(self, base, X, y):
        return None


@pytest.fixture
def data(rng):
    return rng.rand(20, 10), rng.randint(0, 2, 20)


def _both(X, y, **kw):
    """The port's and JAX's TuRF on the mock scorer, fitted alike."""
    return (TuRF(MockScorer(), **kw).fit(X, y),
            fastselect_tpu.TuRF(MockScorer(), **kw).fit(X, y))


def _same(port, ref):
    assert_array_equal(port.top_features_, ref.top_features_)
    assert_array_equal(port.feature_importances_, ref.feature_importances_)
    assert_array_equal(port._active_, ref._active_)
    assert port._iteration_ == ref._iteration_


@pytest.mark.parametrize("kw,top", [
    (dict(n_features_to_select=3, pct_remove=0.2), [7, 8, 9]),
    (dict(n_features_to_select=4, pct_remove=0.25), [6, 7, 8, 9]),
    (dict(n_features_to_select=9, pct_remove=0.9), list(range(1, 10))),
    (dict(n_features_to_select=4, pct_remove=0.3), [6, 7, 8, 9]),
])
def test_mock_selection_matches_jax(kw, top, data):
    """The mock keeps the tail; the overshoot clamp stops at exactly
    n_features_to_select; importances are the first round's."""
    port, ref = _both(*data, **kw)
    _same(port, ref)
    assert_array_equal(port.top_features_, top)
    assert_array_equal(port.feature_importances_, np.linspace(0, 1, 10))


def test_iteration_cap(data):
    port, ref = _both(*data, n_features_to_select=2, pct_remove=0.1,
                      n_iterations=1)
    _same(port, ref)
    assert len(port._active_) == 9


def test_invalid_pct_remove(data):
    for bad in (0.0, 1.0, -0.5, 2.0):
        with pytest.raises(ValueError, match="pct_remove"):
            TuRF(MockScorer(), pct_remove=bad).fit(*data)


def test_transform_and_errors(data, capsys):
    X, y = data
    t = TuRF(MockScorer(), n_features_to_select=5, pct_remove=0.2,
             verbose=True)
    assert t.fit_transform(X, y).shape == (20, 5)
    assert "features remaining" in capsys.readouterr().out
    with pytest.raises(ValueError):
        t.transform(X[:, :-1])
    with pytest.raises(NotFittedError):
        TuRF(MockScorer(), n_features_to_select=2).transform(X)


def test_save_and_load_state(data):
    X, y = data
    t = TuRF(MockScorer(), n_features_to_select=4, pct_remove=0.2).fit(X, y)
    state = t.save_state()
    ref = fastselect_tpu.TuRF(MockScorer(), n_features_to_select=4,
                              pct_remove=0.2).fit(X, y).save_state()
    assert state.keys() == ref.keys()
    for key in state:
        assert_array_equal(state[key], ref[key])
    t2 = TuRF(MockScorer(), n_features_to_select=4).load_state(state)
    assert_array_equal(t2.top_features_, t.top_features_)
    assert_array_equal(t2.transform(X), t.transform(X))


@pytest.mark.parametrize("package", ["port", "jax"])
def test_kill_and_resume(package, data, tmp_path):
    """A run killed after three scoring rounds resumes from its snapshot
    in the port, whichever package wrote it, and re-runs only the rounds
    that remain; a finished fit deletes its snapshot."""
    X, y = data
    ckpt = str(tmp_path / "turf.ckpt")
    kw = dict(n_features_to_select=2, pct_remove=0.15)
    writer = TuRF if package == "port" else fastselect_tpu.TuRF
    with pytest.raises(RuntimeError, match="simulated crash"):
        writer(CountingScorer(die_after=3), checkpoint_path=ckpt,
               **kw).fit(X, y)
    assert (tmp_path / "turf.ckpt").exists()

    resumer = CountingScorer()
    t = TuRF(resumer, checkpoint_path=ckpt, **kw).fit(X, y)
    full = CountingScorer()
    ref = TuRF(full, checkpoint_path=str(tmp_path / "other.ckpt"),
               **kw).fit(X, y)
    _same(t, ref)
    assert resumer.n_fits == full.n_fits - 3
    assert not (tmp_path / "turf.ckpt").exists()


def test_fingerprint_matches_jax(data):
    X, y = data
    for Xv in (X, X.astype(np.float32), (X * 3).astype(np.int8)):
        assert (TuRF._data_fingerprint(Xv, y)
                == fastselect_tpu.TuRF._data_fingerprint(Xv, y))


@pytest.mark.parametrize("other", ["wider", "same_width"])
def test_checkpoint_of_other_data_is_ignored(other, data, tmp_path):
    X, y = data
    ckpt = str(tmp_path / "turf.ckpt")
    kw = dict(n_features_to_select=2, pct_remove=0.15)
    with pytest.raises(RuntimeError):
        TuRF(CountingScorer(die_after=1), checkpoint_path=ckpt,
             **kw).fit(X, y)
    X2 = np.concatenate([X, X], axis=1) if other == "wider" else X + 1.0
    fresh = CountingScorer()
    t = TuRF(fresh, checkpoint_path=ckpt, **kw).fit(X2, y)
    full = CountingScorer()
    TuRF(full, checkpoint_path=str(tmp_path / "o.ckpt"), **kw).fit(X2, y)
    assert fresh.n_fits == full.n_fits        # started afresh
    assert t.n_features_in_ == X2.shape[1]


def test_load_state_mid_run_resumes_next_fit(data, tmp_path):
    X, y = data
    ckpt = str(tmp_path / "turf.ckpt")
    kw = dict(n_features_to_select=3, pct_remove=0.2)
    with pytest.raises(RuntimeError):
        TuRF(CountingScorer(die_after=2), checkpoint_path=ckpt,
             **kw).fit(X, y)
    with open(ckpt, "rb") as f:
        state = pickle.load(f)
    assert "iteration" in state and not state.get("complete", False)
    resumer = CountingScorer()
    t = TuRF(resumer, **kw).load_state(state).fit(X, y)
    _same(t, fastselect_tpu.TuRF(MockScorer(), **kw).fit(X, y))
    assert resumer.n_fits == t._iteration_ + 1 - 2


def test_small_int_dtype_reaches_the_estimator(data):
    X, y = data
    Xi = (X * 3).astype(np.int8)
    seen = []

    class DtypeSpy(MockScorer):
        def fit(self, X, y):
            seen.append(X.dtype)
            return super().fit(X, y)

    TuRF(DtypeSpy(), n_features_to_select=4, pct_remove=0.25).fit(Xi, y)
    assert seen and all(np.issubdtype(d, np.integer) for d in seen)


# ---------------------------------------------------------------------------
# Relief base estimators: the fast scorers
# ---------------------------------------------------------------------------

def _discrete(rng):
    X = rng.randint(0, 3, (200, 64)).astype(np.float64)
    y = rng.randint(0, 2, 200)
    X[:, 5] = y * 2
    X[:, 11] = (y + rng.randint(0, 2, 200)).clip(0, 2)
    return X, y


def _genotypes(rng):
    X, y = _discrete(rng)
    return X.astype(np.int8), y


def _continuous(rng):
    X = rng.rand(220, 48)
    y = rng.randint(0, 2, 220)
    X[:, 7] += y * 0.8
    return X, y


def _mixed(rng):
    X, y = _continuous(rng)
    X[:, :10] = rng.randint(0, 3, (220, 10))
    return X, y


DATA = {"discrete": _discrete, "genotypes": _genotypes,
        "continuous": _continuous, "mixed": _mixed}
BASES = {"MultiSURF": dict(), "MultiSURF*": dict(use_star=True),
         "SURF": dict(), "ReliefF": dict(n_neighbors=5)}


def _base(name, package):
    params = BASES[name]
    cls = name.rstrip("*")
    return getattr(package, cls)(backend="cpu", **params)


@pytest.mark.parametrize("base", list(BASES))
@pytest.mark.parametrize("kind", list(DATA))
def test_relief_turf(kind, base, rng):
    """The fast scorer copies X to the device once, where the re-fitting
    loop copies it every round, and equals that loop bit for bit on every
    kind of data.  Both match JAX's TuRF on the same base estimator."""
    X, y = DATA[kind](rng)
    kw = dict(n_features_to_select=8, pct_remove=0.25)
    _relief_base.reset_upload_count()
    fast = TuRF(_base(base, fastselect_tpu_torch), **kw).fit(X, y)
    assert _relief_base.uploads == 1
    _relief_base.reset_upload_count()
    slow = RefitTuRF(_base(base, fastselect_tpu_torch), **kw).fit(X, y)
    assert _relief_base.uploads == slow._iteration_ + 1
    _same(fast, slow)
    assert_array_equal(fast._final_scores_, slow._final_scores_)
    assert fast._iteration_ >= 5

    ref = fastselect_tpu.TuRF(_base(base, fastselect_tpu), **kw).fit(X, y)
    assert_array_equal(fast.top_features_, ref.top_features_)
    assert_allclose(fast.feature_importances_, ref.feature_importances_,
                    rtol=1e-4, atol=1e-5)


def test_fast_scorers_mask_columns(rng):
    """The active columns, gathered on the device, score as a fit on them
    alone does, also where dropping columns changes the engine (mixed X
    whose active columns are all discrete or all continuous)."""
    for X_of in (_discrete, _genotypes, _continuous, _mixed):
        X, y = X_of(rng)
        scorer = TuRF(None)._make_fast_scorer(MultiSURF(backend="cpu"), X, y)
        for active in (np.arange(3, X.shape[1], 2), np.arange(4),
                       np.arange(12, X.shape[1])):
            got = scorer(active)
            want = MultiSURF(backend="cpu").fit(X[:, active],
                                                y).feature_importances_
            assert_array_equal(got, want)


def test_no_fast_scorer_for_other_estimators_or_one_class(rng):
    """Other estimators and a discrete column past 127 states re-fit each
    round; a single class takes ReliefF's early exit in the fast scorer
    as in the re-fitting loop; a forced card that is absent raises."""
    X, y = _discrete(rng)
    t = TuRF(MockScorer())
    assert t._make_fast_scorer(MockScorer(), X, y) is None
    Xm, ym = _mixed(rng)
    Xm[:, 1] = np.arange(len(ym)) % 150
    assert t._make_fast_scorer(SURF(backend="cpu", discrete_limit=200),
                               Xm, ym) is None
    kw = dict(n_features_to_select=8, pct_remove=0.25)
    one = np.zeros(len(y))
    fast = TuRF(ReliefF(backend="cpu"), **kw).fit(X, one)
    _same(fast, RefitTuRF(ReliefF(backend="cpu"), **kw).fit(X, one))
    assert not fast.feature_importances_.any()
    with pytest.raises(RuntimeError, match="no CUDA-enabled GPU"):
        t._make_fast_scorer(MultiSURF(backend="cuda"), X, y)


def test_estimator_from_jax_turf(rng):
    """A fitted JAX TuRF carries over: the nested estimator's parameters
    and the fitted state, so transform selects the same columns."""
    X, y = _continuous(rng)
    ref = fastselect_tpu.TuRF(
        fastselect_tpu.MultiSURF(backend="cpu", use_star=True,
                                 transfer_dtype="float32"),
        n_features_to_select=6, pct_remove=0.3).fit(X, y)
    port = estimator_from_jax(ref)
    assert isinstance(port, TuRF)
    assert isinstance(port.estimator, MultiSURF)
    assert port.estimator.get_params() == dict(
        n_features_to_select=0.2, backend="cpu", use_star=True,
        discrete_limit=10, n_jobs=-1, verbose=False,
        transfer_dtype="float32")
    assert_array_equal(port.transform(X), ref.transform(X))
    assert_array_equal(port.feature_importances_, ref.feature_importances_)
    refit = TuRF(**port.get_params(deep=False)).fit(X, y)
    assert_array_equal(refit.top_features_, port.top_features_)
    mock = fastselect_tpu.TuRF(MockScorer(), n_features_to_select=3).fit(X, y)
    assert isinstance(estimator_from_jax(mock).estimator, MockScorer)
    with pytest.raises(TypeError):
        estimator_from_jax(fastselect_tpu.TuRF(MockScorer()))  # not fitted


@pytest.mark.parametrize("est", [
    MultiSURF(n_features_to_select=5, use_star=True),
    TuRF(ReliefF(n_neighbors=4), n_features_to_select=3, pct_remove=0.5),
    TuRF(MockScorer(), checkpoint_path="turf.ckpt"),
    [SURF(backend="cpu"), MultiSURF()],
])
def test_clone_stand_in_matches_sklearn(est):
    """The stand-in clone (used where scikit-learn is not installed) gives
    what sklearn.base.clone gives: a new unfitted object of the same type
    with equal parameters, nested estimators cloned in turn."""
    got, want = _clone(est), sklearn.base.clone(est)
    if isinstance(est, list):
        assert [type(e) for e in got] == [type(e) for e in want]
        pairs = list(zip(got, want, est))
    else:
        pairs = [(got, want, est)]
    for g, w, e in pairs:
        assert type(g) is type(w) and g is not e
        assert repr(g.get_params(deep=False)) == repr(
            w.get_params(deep=False))
        inner = g.get_params(deep=False).get("estimator")
        if inner is not None:
            assert inner is not e.estimator
            assert inner.get_params() == e.estimator.get_params()
    counting = CountingScorer()
    assert _clone(counting) is sklearn.base.clone(counting) is counting
    with pytest.raises(TypeError):
        _clone(object())
