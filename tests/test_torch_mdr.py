"""The port's MDR against the JAX package's, on the CPU.

``tests/test_mdr.py``'s cases go through both packages: unranked combos,
search ranks, CVC, interactions and lookup tables equal; balanced
accuracies within 1e-6 (the port's float32 epilogue is JAX's, so they
come out equal); the int8-GEMM tables equal the plain bincount tables;
selection past JAX's 65,536-sample gate equals the float64 oracle's; the
``StratifiedKFold`` stand-in gives scikit-learn 1.9's folds.
"""

import io
import math
import pickle
import warnings
from contextlib import redirect_stdout
from functools import partial
from itertools import combinations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

import fastselect_tpu
import fastselect_tpu.ops.mdr_op as JO
import fastselect_tpu_torch.models.mdr as TM
import fastselect_tpu_torch.ops.mdr_op as TO
from fastselect_tpu_torch import MDR
from fastselect_tpu_torch.interop import estimator_from_jax
from fastselect_tpu_torch.ops import relief_discrete as rd
from fastselect_tpu_torch.utils import sklearn_compat as SC

from oracles import mdr_balanced_accuracy

torch.set_num_threads(2)

BA_ATOL = 1e-6
CPU = torch.device("cpu")


def _weights(y, folds, n):
    w_case = np.zeros((len(folds), n), np.float32)
    w_ctrl = np.zeros((len(folds), n), np.float32)
    for f, tr in enumerate(folds):
        w_case[f, tr] = y[tr] == 1
        w_ctrl[f, tr] = y[tr] != 1
    return w_case, w_ctrl


def _overlapping_folds():
    """tests/test_mdr.py:148-170's data and three overlapping folds."""
    rng = np.random.RandomState(3)
    X = rng.randint(0, 3, (40, 7)).astype(np.int32)
    y = rng.randint(0, 2, 40)
    y[:4] = [0, 1, 0, 1]
    folds = [np.arange(0, 30), np.arange(10, 40), np.arange(0, 40, 2)]
    return X, y, _weights(y, folds, 40)


def _search_data(seed=11, n=50, p=9):
    """tests/test_mdr.py:210-234's data: two folds."""
    rng = np.random.RandomState(seed)
    X = rng.randint(0, 3, (n, p)).astype(np.int32)
    y = rng.randint(0, 2, n)
    y[:2] = [0, 1]
    return X, y, _weights(y, [np.arange(0, 40), np.arange(5, n)], n)


def _f64_ranks(X, w_case, w_ctrl, k):
    """Each fold's first best rank by float64 BA, the rule of
    tests/test_mdr.py:287-301."""
    combos = np.array(list(combinations(range(X.shape[1]), k)))
    out = []
    for f in range(w_case.shape[0]):
        cw, lw = w_case[f].astype(np.float64), w_ctrl[f].astype(np.float64)
        P, N = cw.sum(), lw.sum()
        best, best_r = -1.0, -1
        for r, c in enumerate(combos):
            cells = X[:, c].astype(np.int64) @ (3 ** np.arange(k - 1, -1, -1))
            case = np.bincount(cells, weights=cw, minlength=3 ** k)
            ctrl = np.bincount(cells, weights=lw, minlength=3 ** k)
            high = (ctrl == 0) | (case / np.maximum(ctrl, 1e-30) > P / N)
            ba = (case[high].sum() / P + ctrl[~high].sum() / N) / 2
            if ba > best:
                best, best_r = ba, r
        out.append(best_r)
    return np.array(out)


# ---------------------------------------------------------------------------
# Unranking
# ---------------------------------------------------------------------------

def _jax_unrank(ranks, p, k):
    fn = jax.jit(partial(JO._unrank_device, k=k))
    return np.asarray(fn(jnp.asarray(ranks, jnp.int32),
                         jnp.asarray(JO._comb_tables(p, k))))


def _port_unrank(ranks, p, k):
    return TO._unrank_device(torch.as_tensor(ranks, dtype=torch.int64),
                             torch.from_numpy(TO._comb_tables(p, k)),
                             k=k).numpy()


@pytest.mark.parametrize("p,k", [(5, 1), (6, 2), (9, 3), (10, 4), (7, 6),
                                 (12, 4)])
def test_unrank_matches_itertools_and_jax(p, k):
    want = np.array(list(combinations(range(p), k)), np.int32)
    n = want.shape[0]
    got = TO.unrank_combos(p, k, 0, n)
    assert got.dtype == np.int32
    assert_array_equal(got, want)
    assert_array_equal(got, JO.unrank_combos(p, k, 0, n))
    r0, r1 = n // 3, 2 * n // 3
    assert_array_equal(TO.unrank_combos(p, k, r0, r1), want[r0:r1])
    ranks = np.arange(n)
    assert_array_equal(_port_unrank(ranks, p, k), want)
    assert_array_equal(_jax_unrank(ranks, p, k), want)


def test_unrank_window_near_c2000_3():
    """Ranks near C(2000, 3) = 1,331,334,000 (int32 in JAX, int64 here):
    host, device and JAX agree, rows are increasing, the last is the last
    combo, and consecutive rows are lexicographic successors."""
    p, k = 2000, 3
    n = math.comb(p, k)
    ranks = np.concatenate([np.arange(n - 3000, n),
                            np.arange(n // 2 - 500, n // 2 + 500)])
    host = np.concatenate([TO.unrank_combos(p, k, n - 3000, n),
                           TO.unrank_combos(p, k, n // 2 - 500,
                                            n // 2 + 500)])
    assert_array_equal(_port_unrank(ranks, p, k), host)
    assert_array_equal(_jax_unrank(ranks, p, k), host)
    assert_array_equal(host[:3000], JO.unrank_combos(p, k, n - 3000, n))
    assert (np.diff(host, axis=1) > 0).all()
    assert tuple(host[2999]) == (1997, 1998, 1999)
    tail = host[:3000].astype(np.int64)
    code = (tail[:, 0] * p + tail[:, 1]) * p + tail[:, 2]
    assert (np.diff(code) > 0).all()


# ---------------------------------------------------------------------------
# Scoring
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 6])
def test_batch_balanced_accuracy_matches_jax_and_oracle(k):
    rng = np.random.RandomState(k)
    n, p = 70, k + 2
    X = rng.randint(0, 3, (n, p)).astype(np.int32)
    y = rng.randint(0, 2, n)
    combos = np.array(list(combinations(range(p), k)), np.int32)
    got = TO.batch_balanced_accuracy(X, y, combos, k)
    assert got.dtype == np.float32 and got.shape == (len(combos),)
    assert_allclose(got, JO.batch_balanced_accuracy(X, y, combos, k),
                    rtol=0, atol=BA_ATOL)
    want = [mdr_balanced_accuracy(X, y, tuple(c)) for c in combos]
    assert_allclose(got, want, rtol=0, atol=BA_ATOL)


@pytest.mark.parametrize("k", [2, 3])
def test_fold_scorer_matches_jax_and_plain_tables(k):
    X, y, (w_case, w_ctrl) = _overlapping_folds()
    combos = np.array(list(combinations(range(7), k)), np.int32)
    sc = TO.MDRFoldScorer(X, w_case, w_ctrl, k)
    assert sc.device == CPU            # device=None: the card, else the CPU
    got = sc(combos)
    assert got.shape == (3, len(combos))
    assert_allclose(got, JO.MDRFoldScorer(X, w_case, w_ctrl, k)(combos),
                    rtol=0, atol=BA_ATOL)
    for f, tr in enumerate((np.arange(0, 30), np.arange(10, 40),
                            np.arange(0, 40, 2))):
        assert_allclose(got[f], TO.batch_balanced_accuracy(
            X[tr], y[tr], combos, k), rtol=0, atol=BA_ATOL)
    tables = sc.tables(combos)
    assert tables.dtype == torch.int32
    assert tables.shape == (2, 3, len(combos), 3 ** k)
    ref = TO.mdr_tables_ref(X, w_case, w_ctrl, combos, k)
    assert ref.dtype == torch.int64
    assert torch.equal(tables.to(torch.int64), ref)
    assert (ref[0].sum(-1) == torch.from_numpy(
        w_case.sum(1)).to(torch.int64)[:, None]).all()


def test_tables_ignore_padding_and_tiling(monkeypatch):
    """n = 53 pads to 56 samples with code -1, whose cell is never a real
    one; tiles of 32 combos give the tables of one tile."""
    rng = np.random.RandomState(5)
    X = rng.randint(0, 3, (53, 10))
    y = rng.randint(0, 2, 53)
    w_case, w_ctrl = _weights(y, [np.arange(0, 40), np.arange(13, 53)], 53)
    combos = TO.unrank_combos(10, 3, 0, 120)
    whole = TO.MDRFoldScorer(X, w_case, w_ctrl, 3).tables(combos)
    monkeypatch.setattr(TO, "_ONEHOT_BYTES", 32 * 27 * 56)
    sc = TO.MDRFoldScorer(X, w_case, w_ctrl, 3)
    assert sc.n_pad == 56 and sc.tc == 32
    assert torch.equal(sc.tables(combos), whole)
    assert torch.equal(whole.to(torch.int64),
                       TO.mdr_tables_ref(X, w_case, w_ctrl, combos, 3))


@pytest.mark.parametrize("n_pad,k,f", [(8, 1, 2), (1000, 2, 5),
                                       (1000, 3, 5), (1000, 4, 10),
                                       (120000, 2, 5), (64, 6, 10),
                                       (2000, 6, 5)])
def test_tile_rule(n_pad, k, f):
    """A tile is a multiple of 32 combos with its int8 one-hot within
    _ONEHOT_BYTES and its float32 epilogue within _TABLE_BYTES (or the
    32-combo floor), and shrinks with 3^k."""
    t = TO._tile_combos(n_pad, k, f)
    assert t % 32 == 0 and t >= 32
    assert (t * 3 ** k * n_pad <= TO._ONEHOT_BYTES
            and 4 * f * t * 3 ** k <= TO._TABLE_BYTES) or t == 32
    assert TO._tile_combos(n_pad, min(k + 1, 6), f) <= t


@pytest.mark.parametrize("bad", [0.5, 2, -1])
def test_weights_must_be_zero_or_one(bad):
    X, y, (w_case, w_ctrl) = _overlapping_folds()
    w_case = w_case.copy()
    w_case[0, 3] = bad
    with pytest.raises(ValueError, match="0 or 1"):
        TO.MDRFoldScorer(X, w_case, w_ctrl, 2)
    with pytest.raises(ValueError, match="0 or 1"):
        TO.mdr_tables_ref(X, w_case, w_ctrl, [[0, 1]], 2)


def test_every_table_is_a_counted_int8_gemm(monkeypatch):
    """Each tile is one torch._int_mm with the GEMM's rules: A (the fold
    weights) with 32 rows, more than 16; K (samples) a multiple of 8; N
    (the tile's one-hot rows) a multiple of 8; a column-major B; gemm_ops
    counts them."""
    shapes = []
    real = torch._int_mm

    def spy(a, b):
        assert a.dtype == b.dtype == torch.int8
        assert a.shape[0] > 16 and a.shape[1] % 8 == 0
        assert b.shape[1] % 8 == 0 and b.stride(0) == 1  # column-major B
        shapes.append((a.shape[0], a.shape[1], b.shape[1]))
        return real(a, b)

    monkeypatch.setattr(torch, "_int_mm", spy)
    X, y, (w_case, w_ctrl) = _search_data(n=61)
    rd.reset_gemm_ops()
    sc = TO.MDRFoldScorer(X, w_case, w_ctrl, 3)
    sc.search(9, 84, chunk=16)
    tile, m = sc.chunk_plan(84, 16)
    assert (tile, m) == (32, 32)
    assert shapes == [(32, 64, 32 * 27)] * 3
    sc(TO.unrank_combos(9, 3, 0, 5))          # 5 combos: N padded to 136
    assert shapes[-1] == (32, 64, 136)
    TO.batch_balanced_accuracy(X, y, np.array([[0]]), 1)
    assert shapes[-1] == (32, 64, 8)
    assert rd.gemm_ops == sum(2 * m_ * k_ * n_ for m_, k_, n_ in shapes)
    rd.reset_gemm_ops()


def test_failed_gemm_raises(monkeypatch):
    """No fallback: a product the GEMM refuses raises out of the fit."""
    def refuse(a, b):
        raise RuntimeError("int8 GEMM refused")

    monkeypatch.setattr(torch, "_int_mm", refuse)
    X, y, _ = _search_data()
    with pytest.raises(RuntimeError, match="refused"):
        MDR(k=2, cv=2, backend="cpu").fit(X, y)


# ---------------------------------------------------------------------------
# Search
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,k,chunk", [(11, 3, 16), (13, 2, 16),
                                          (17, 3, 1 << 18), (19, 4, 40)])
def test_search_all_matches_jax(seed, k, chunk):
    X, y, (w_case, w_ctrl) = _search_data(seed)
    p = X.shape[1]
    n = math.comb(p, k)
    sv, _, sr = TO.MDRFoldScorer(X, w_case, w_ctrl, k).search(p, n,
                                                              chunk=chunk)
    jv, jr = JO.MDRFoldScorer(X, w_case, w_ctrl, k).search_all(p, n,
                                                              chunk=chunk)
    assert sr.dtype == np.int64 and sv.dtype == np.float64
    assert_array_equal(sr, jr)
    assert_allclose(sv, jv, rtol=0, atol=BA_ATOL)
    assert_array_equal(sr, _f64_ranks(X, w_case, w_ctrl, k))
    bas = TO.MDRFoldScorer(X, w_case, w_ctrl, k)(
        TO.unrank_combos(p, k, 0, n))
    assert_array_equal(sr, bas.argmax(1))


def test_search_past_jax_gate_matches_f64_oracle():
    """n = 120,000 pads past JAX's 65,536-sample gate for its int32 key;
    the port's int64 key is exact there: its ranks are the float64
    oracle's, and the keys pass 2^31."""
    rng = np.random.RandomState(23)
    n, p, k = 120000, 6, 2
    X = rng.randint(0, 3, (n, p)).astype(np.int32)
    y = ((X[:, 2] + X[:, 4]) % 3 == 0).astype(int)
    y[rng.rand(n) < 0.45] ^= 1
    w_case, w_ctrl = _weights(y, [np.arange(0, 96000),
                                  np.arange(24000, n)], n)
    sc = TO.MDRFoldScorer(X, w_case, w_ctrl, k)
    vals, keys, ranks = sc.search(p, math.comb(p, k), chunk=8)
    assert keys.dtype == np.int64 and keys.max() > 2 ** 31
    assert_array_equal(ranks, _f64_ranks(X, w_case, w_ctrl, k))
    P, N = w_case.sum(1), w_ctrl.sum(1)
    combos = TO.unrank_combos(p, k, 0, math.comb(p, k))
    t = sc.tables(combos).numpy().astype(np.int64)
    for f in range(2):
        c = combos[ranks[f]]
        want = mdr_balanced_accuracy(X[w_case[f] + w_ctrl[f] > 0],
                                     y[w_case[f] + w_ctrl[f] > 0], tuple(c))
        assert abs(vals[f] - want) <= BA_ATOL
        case, ctrl = t[0, f, ranks[f]], t[1, f, ranks[f]]
        high = (ctrl == 0) | (case / np.maximum(ctrl, 1e-30) > P[f] / N[f])
        assert keys[f] == (case[high].sum() * int(N[f])
                           + ctrl[~high].sum() * int(P[f]))


def test_ties_keep_the_first_combo_across_chunks():
    """Duplicate columns give equal keys: argmax's first index inside a
    chunk and strict > across chunks of 32 keep the lexicographically
    first combo (the reference's tie-break)."""
    rng = np.random.RandomState(29)
    p = 20
    X = rng.randint(0, 3, (80, p))
    y = ((X[:, 0] + X[:, 1]) % 3 == 0).astype(int)
    X[:, 19] = X[:, 1]
    X[:, 18] = X[:, 0]                # (0,1) ties (0,19), (1,18), (18,19)
    w_case, w_ctrl = _weights(y, [np.arange(0, 60), np.arange(20, 80)], 80)
    sc = TO.MDRFoldScorer(X, w_case, w_ctrl, 2)
    n = math.comb(p, 2)
    assert sc.chunk_plan(n, 1) == (32, 32)
    _, keys, ranks = sc.search(p, n, chunk=1)
    _, allkeys = sc.scores(TO.unrank_combos(p, 2, 0, n))
    order = list(combinations(range(p), 2))
    want = [order.index(c) for c in ((0, 1), (0, 19), (1, 18), (18, 19))]
    assert [w // 32 for w in want] == [0, 0, 1, 5]   # across chunks
    for f in range(2):
        tied = np.flatnonzero(allkeys[f] == allkeys[f].max())
        assert_array_equal(tied, want)
        assert ranks[f] == 0 and keys[f] == allkeys[f].max()
    _, jr = JO.MDRFoldScorer(X.astype(np.int32), w_case, w_ctrl, 2) \
        .search_all(p, n, chunk=8)
    assert_array_equal(ranks, jr)


def test_padded_tail_repeats_the_last_combo():
    X, _, (w_case, w_ctrl) = _search_data()
    sc = TO.MDRFoldScorer(X, w_case, w_ctrl, 3)
    ranks = sc.chunk_ranks(64, 32, 84).numpy()
    assert_array_equal(ranks, np.r_[np.arange(64, 84), np.full(12, 83)])


# ---------------------------------------------------------------------------
# The estimator
# ---------------------------------------------------------------------------

def _epistasis():
    X = np.array([[2, 2], [2, 2], [2, 0], [0, 2], [0, 0], [1, 1], [1, 0],
                  [0, 1]], dtype=np.uint8)
    return X, np.array([1, 1, 0, 0, 0, 0, 0, 0], dtype=np.uint8)


def _random(seed, n, p):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 3, (n, p)).astype(np.uint8), rng.randint(0, 2, n)


def _planted(seed, n, p, k, dup=True):
    rng = np.random.RandomState(seed)
    X = rng.randint(0, 3, (n, p))
    cols = np.sort(rng.choice(p - 1, k, replace=False))
    y = (X[:, cols].sum(1) % 3 == 0).astype(int)
    y[rng.rand(n) < 0.1] ^= 1
    if dup:
        X[:, p - 1] = X[:, cols[-1]]        # a tie of the planted combo
    return X, y


FIT_CASES = {
    "epistasis": (_epistasis, 2, 2),
    "random_k2_cv5": (partial(_random, 1, 200, 12), 2, 5),
    "random_k3_cv5": (partial(_random, 2, 150, 10), 3, 5),
    "random_k2_cv10": (partial(_random, 3, 300, 9), 2, 10),
    "random_k3_cv2": (partial(_random, 4, 120, 8), 3, 2),
    "planted_k2_cv5": (partial(_planted, 5, 400, 14, 2), 2, 5),
    "planted_k3_cv10": (partial(_planted, 6, 600, 10, 3), 3, 10),
    "planted_k3_cv2": (partial(_planted, 7, 300, 9, 3), 3, 2),
    "planted_k2_cv2_dup": (partial(_planted, 8, 90, 6, 2), 2, 2),
}


def _fit_both(X, y, k, cv):
    out = []
    for cls in (fastselect_tpu.MDR, MDR):
        buf = io.StringIO()
        with redirect_stdout(buf):
            est = cls(k=k, cv=cv, backend="cpu", verbose=True).fit(X, y)
        out.append((est, buf.getvalue()))
    return out


@pytest.mark.parametrize("name", list(FIT_CASES))
def test_fit_matches_jax(name):
    make, k, cv = FIT_CASES[name]
    X, y = make()
    (want, want_out), (got, got_out) = _fit_both(X, y, k, cv)
    assert got.best_interaction_ == want.best_interaction_
    assert all(type(v) is int for v in got.best_interaction_)
    assert got.best_cvc_ == want.best_cvc_
    assert got.best_mean_testing_ba_ == want.best_mean_testing_ba_
    assert_array_equal(got.best_model_lookup_table_,
                       want.best_model_lookup_table_)
    assert got.best_model_lookup_table_.dtype == np.uint8
    assert_array_equal(got.classes_, want.classes_)
    assert got.effective_backend_ == "cpu"
    assert_array_equal(got.predict(X), want.predict(X))
    assert_array_equal(got.transform(X), want.transform(X))
    assert got.score(X, y) == want.score(X, y)
    assert got_out.replace("CUDA", "CPU") == want_out.replace("TPU", "CPU")
    assert "Fit Complete" in got_out and f"CVC: {got.best_cvc_}/{cv}" \
        in got_out


def test_planted_interaction_found():
    X, y = _planted(5, 400, 14, 2, dup=False)
    est = MDR(k=2, cv=5, backend="cpu").fit(X, y)
    assert est.best_cvc_ == 5
    assert len(est._fold_best) == 5 and len(est._fold_test_ba) == 5
    assert est.best_mean_testing_ba_ > 0.8


@pytest.mark.parametrize("chunk", [1, 7, 10, 100])
def test_combo_chunk_does_not_change_the_model(monkeypatch, chunk):
    X, y = _planted(10, 200, 8, 3)
    want = MDR(k=3, cv=5, backend="cpu").fit(X, y)
    monkeypatch.setattr(TM, "_COMBO_CHUNK", chunk)
    got = MDR(k=3, cv=5, backend="cpu").fit(X, y)
    assert got._fold_best == want._fold_best


def test_multiclass_raises():
    X, _ = _random(0, 30, 4)
    with pytest.raises(ValueError, match="binary"):
        MDR(backend="cpu").fit(X, np.random.RandomState(0).randint(0, 3, 30))


@pytest.mark.parametrize("bad", [5, -1])
def test_bad_genotypes_raise(bad):
    X, y = _random(0, 30, 4)
    X = X.astype(np.int64)
    X[3, 2] = bad                  # -1 is cast to 255 as scikit-learn does
    for cls in (MDR, fastselect_tpu.MDR):
        with pytest.raises(ValueError, match="0/1/2"):
            cls(backend="cpu").fit(X, y)


def test_float_genotypes_truncate_as_jax():
    X, y = _random(1, 60, 5)
    Xf = X.astype(np.float64)
    Xf[Xf == 2] = 2.7
    got = MDR(k=2, cv=3, backend="cpu").fit(Xf, y)
    want = fastselect_tpu.MDR(k=2, cv=3, backend="cpu").fit(Xf, y)
    assert got.best_interaction_ == want.best_interaction_
    assert_array_equal(got.predict(Xf), want.predict(Xf))


def test_k_limits():
    X, y = _random(0, 30, 4)
    with pytest.raises(ValueError, match="MAX_K_FOR_KERNEL"):
        MDR(k=TM.MAX_K_FOR_KERNEL + 1, backend="cpu").fit(X, y)
    with pytest.raises(ValueError, match="n_features"):
        MDR(k=5, cv=2, backend="cpu").fit(X, y)


def test_predict_proba_not_implemented():
    X, y = _epistasis()
    clf = MDR(k=2, cv=2, backend="cpu").fit(X, y)
    with pytest.raises(NotImplementedError):
        clf.predict_proba(X)


@pytest.mark.parametrize("backend", ["gpu", "cuda", "GPU"])
def test_gpu_backend_without_a_card_raises(backend):
    X, y = _epistasis()
    with pytest.raises(RuntimeError, match="no CUDA-enabled GPU"):
        MDR(k=2, cv=2, backend=backend).fit(X, y)


@pytest.mark.parametrize("backend", ["tpu", "bogus"])
def test_unknown_backend_raises(backend):
    X, y = _epistasis()
    with pytest.raises(ValueError, match="backend must be one of"):
        MDR(k=2, cv=2, backend=backend).fit(X, y)


def test_auto_backend_is_the_cpu_here():
    X, y = _epistasis()
    assert MDR(k=2, cv=2).fit(X, y).effective_backend_ == "cpu"


def test_not_fitted():
    with pytest.raises(SC.NotFittedError):
        MDR().predict(np.zeros((3, 2), np.uint8))


def test_pickle_and_clone():
    X, y = _planted(11, 150, 7, 2)
    est = MDR(k=2, cv=3, backend="cpu").fit(X, y)
    back = pickle.loads(pickle.dumps(est))
    assert back.best_interaction_ == est.best_interaction_
    assert_array_equal(back.predict(X), est.predict(X))
    for clone in (SC.clone, SC._clone):
        fresh = clone(est)
        assert type(fresh) is MDR and fresh.get_params() == est.get_params()
        assert not hasattr(fresh, "best_interaction_")
    assert est.get_params() == dict(k=2, cv=3, backend="cpu", verbose=False)


def test_estimator_from_jax():
    X, y = _planted(12, 200, 8, 2)
    jest = fastselect_tpu.MDR(k=2, cv=5).fit(X, y)
    est = estimator_from_jax(jest)
    assert type(est) is MDR
    assert est.get_params() == dict(k=2, cv=5, backend="auto",
                                    verbose=False)
    assert est.best_interaction_ == jest.best_interaction_
    assert isinstance(est.best_interaction_, tuple)
    assert est.best_cvc_ == jest.best_cvc_
    assert est.best_mean_testing_ba_ == jest.best_mean_testing_ba_
    assert_array_equal(est.best_model_lookup_table_,
                       jest.best_model_lookup_table_)
    assert_array_equal(est.classes_, jest.classes_)
    assert_array_equal(est.predict(X), jest.predict(X))
    with pytest.raises(TypeError):
        estimator_from_jax(fastselect_tpu.MDR())          # not fitted


# ---------------------------------------------------------------------------
# scikit-learn stand-ins
# ---------------------------------------------------------------------------

def _labels(kind, y):
    if kind == "37":
        return np.where(y == 1, 7, 3)
    if kind == "str":
        return np.where(y == 1, "case", "ctrl")
    return y


def _splits(cls, X, y, n_splits, **kw):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            out = [(a.tolist(), b.tolist()) for a, b in cls(
                n_splits, **kw).split(X, y)]
        except ValueError as e:
            out = str(e)
    return out, [(w.category, str(w.message)) for w in caught]


@pytest.mark.parametrize("kind", ["01", "37", "str"])
@pytest.mark.parametrize("share", [0.5, 0.1])
@pytest.mark.parametrize("n", [10, 11, 37, 100, 513, 2000])
def test_stratified_kfold_matches_sklearn(n, share, kind):
    """scikit-learn 1.9's folds, errors and warnings for n_splits 2..10."""
    from sklearn.model_selection import StratifiedKFold
    rng = np.random.RandomState(n)
    y = (rng.rand(n) < share).astype(int)
    y[:2] = [0, 1]
    y = _labels(kind, y)
    X = np.zeros((n, 3))
    for n_splits in range(2, 11):
        for kw in (dict(shuffle=True, random_state=42), dict(),
                   dict(shuffle=True, random_state=7)):
            assert _splits(SC._StratifiedKFold, X, y, n_splits, **kw) \
                == _splits(StratifiedKFold, X, y, n_splits, **kw)


def test_stratified_kfold_errors_match_sklearn():
    from sklearn.model_selection import StratifiedKFold
    X = np.zeros((6, 2))
    y = np.array([0, 1, 0, 1, 0, 1])
    cases = [(7, {}, X, y), (4, {}, X, y), (2, {}, X, y[:5]),
             (3, {}, X, np.array([0, 0.5, 1, 0, 1, 0]))]
    for n_splits, kw, Xc, yc in cases:
        want = _splits(StratifiedKFold, Xc, yc, n_splits, **kw)
        got = _splits(SC._StratifiedKFold, Xc, yc, n_splits, **kw)
        assert isinstance(got[0], str) and got == want
    for kw, err in ((dict(n_splits=1), ValueError),
                    (dict(n_splits=2.0), ValueError),
                    (dict(n_splits=3, shuffle=1), TypeError),
                    (dict(n_splits=3, random_state=0), ValueError)):
        with pytest.raises(err) as e_sk:
            StratifiedKFold(**kw)
        with pytest.raises(err) as e_ours:
            SC._StratifiedKFold(**kw)
        assert str(e_ours.value) == str(e_sk.value)


@pytest.mark.parametrize("X", [
    np.array([[-1, 2], [0, 1]]), np.array([[2.7, 1.0], [0, 1]]),
    [[-1, 2], [0, 1]], [[2.7, 1], [0, 1]], np.array([[1000, 1], [0, 1]]),
    np.array([[True, False], [False, True]]), np.array([[1, 2]], np.int8)])
def test_check_array_casts_as_sklearn(X):
    from sklearn.utils.validation import check_array
    got = SC._check_array_standin(X, dtype=np.uint8)
    want = check_array(X, dtype=np.uint8)
    assert got.dtype == want.dtype
    assert_array_equal(got, want)


@pytest.mark.parametrize("X,match", [
    (np.array([[np.nan, 1.0], [0, 1]]), "NaN"),
    (np.array([[np.inf, 1.0], [0, 1]]), "infinity"),
    (np.zeros((0, 3)), "0 sample"), (np.zeros((3, 0)), "0 feature"),
    (np.zeros(3), "2D")])
def test_check_array_rejects_as_sklearn(X, match):
    from sklearn.utils.validation import check_array
    with pytest.raises(ValueError, match=match):
        check_array(X, dtype=np.uint8)
    with pytest.raises(ValueError, match=match):
        SC._check_array_standin(X, dtype=np.uint8)


@pytest.mark.parametrize("ys", [
    (np.array([3, 7, 3]),), (np.array(["b", "a", "b"]),),
    (np.array([1.0, 0.0]),), (np.array([0, 1], np.uint8),),
    (np.array([0, 2]), np.array([1, 2])), ([1, 0, 1],)])
def test_unique_labels_matches_sklearn(ys):
    from sklearn.utils.multiclass import unique_labels
    got, want = SC._unique_labels(*ys), unique_labels(*ys)
    assert got.dtype == want.dtype
    assert_array_equal(got, want)


@pytest.mark.parametrize("ys", [(np.array([0.5, 1.0]),),
                                (np.array([1, 0]), np.array(["a", "b"]))])
def test_unique_labels_errors_as_sklearn(ys):
    from sklearn.utils.multiclass import unique_labels
    with pytest.raises(ValueError):
        unique_labels(*ys)
    with pytest.raises(ValueError):
        SC._unique_labels(*ys)


@pytest.mark.parametrize("weighted", [False, True])
def test_classifier_mixin_score_matches_sklearn(weighted):
    from sklearn.base import ClassifierMixin

    X, y = _planted(13, 120, 6, 2)
    est = MDR(k=2, cv=3, backend="cpu").fit(X, y)
    w = np.random.RandomState(1).rand(len(y)) if weighted else None
    got = SC._ClassifierMixin.score(est, X, y, sample_weight=w)
    want = ClassifierMixin.score(est, X, y, sample_weight=w)
    assert type(got) is float and got == pytest.approx(want, abs=1e-15)
    assert SC._ClassifierMixin._estimator_type == "classifier"


# ---------------------------------------------------------------------------
# chip_smoke.py's MDR phases
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("phase,kw", [
    ("mdr_phase", dict(n=300, p=12, n_large=3000, p_large=6)),
    ("mdr_k3_phase", dict(n=600, p=12)),
    ("mdr_k4_phase", dict(n=1000, p=8))])
def test_chip_smoke_mdr_phases_rehearse_on_cpu(monkeypatch, phase, kw):
    """chip_smoke.py's phases 18-20, with their referees, at a small size
    on the CPU (chunks of 64 combos, so the k = 3 phase checks four chunks
    and a padded tail)."""
    import chip_smoke as cs
    for name in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(TM, "_COMBO_CHUNK", 64)
    res = getattr(cs, phase)(CPU, **kw)
    res, sec = res[0], res[-1]
    assert res["gemm_ops"] > 0 and sec > 0
    assert res["est"].best_cvc_ == 5


def test_chip_smoke_helpers():
    import chip_smoke as cs
    for p, k in ((9, 3), (12, 4), (30, 2)):
        for r, c in enumerate(combinations(range(p), k)):
            assert cs.combo_rank(p, c) == r
    X, y, planted = cs.planted_interaction(0, 3000, 10, 2, flip=0.0)
    assert X.dtype == np.uint8 and X.max() == 2
    assert_array_equal(y, X[:, planted].astype(int).sum(1) % 3 == 0)
    for c in range(10):                          # no marginal effect
        rates = [y[X[:, c] == g].mean() for g in range(3)]
        assert max(rates) - min(rates) < 0.08
