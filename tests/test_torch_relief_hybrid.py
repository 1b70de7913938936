"""The port's hybrid engine for mixed data against JAX's, on the CPU.

JAX's ``relief_hybrid_scores`` runs its Pallas kernels in interpret mode;
the port's runs the continuous kernels' plain versions and ``torch._int_mm``,
the route a CUDA card takes with the kernels.  Both take the same numpy
inputs.  Scores: atol 1e-5 with equal rankings.

Continuous distances are float32 sums in another order in each package,
so a distance or a row statistic can round to the other side of a near
threshold and move a score by about 1e-4 (on the uniform fixture with
class-sorted rows: 5.2e-5 for MultiSURF, 2.5e-4 for MultiSURF*).  Every
path is therefore also held to JAX's on a grid fixture whose continuous
values are quarters in [0, 1] with recip 1: its distances, row sums and
sums of squares are exact in float32, so no summation order moves a
threshold.
"""

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from numpy.testing import assert_allclose, assert_array_equal

import fastselect_tpu.ops.relief_discrete as JD
import fastselect_tpu.ops.relief_hybrid as JH
import fastselect_tpu.utils.preprocessing as JP
import fastselect_tpu_torch.ops.relief_cuda as RC
import fastselect_tpu_torch.ops.relief_discrete as TD
import fastselect_tpu_torch.ops.relief_hybrid as TH
import fastselect_tpu_torch.utils.preprocessing as TP
from fastselect_tpu_torch import MultiSURF, ReliefF, SURF
from fastselect_tpu_torch.interop import analysis_from_jax
from fastselect_tpu_torch.ops.relief import relief_engine
from test_engines import CASES

torch.set_num_threads(2)

ATOL = 1e-5


def _mixed(rng, ncls, n=300, p=96, grid=False):
    """The fixture of tests/test_engines.py's hybrid tests: 40 columns in
    0..2 and 10 in 0..4 among uniform continuous ones (with ``grid``,
    continuous values in {0, 1/4, ..., 1} and recip 1)."""
    x = (rng.randint(0, 5, (n, p)) / 4 if grid else rng.rand(n, p)).astype(
        np.float32)
    x[:, :40] = rng.randint(0, 3, (n, 40))
    x[:, 60:70] = rng.randint(0, 5, (n, 10))
    y = rng.randint(0, ncls, n).astype(np.int32)
    disc = np.zeros(p, bool)
    disc[:40] = True
    disc[60:70] = True
    recip = (1.0 / np.maximum(x.max(0) - x.min(0), 1e-9)).astype(np.float32)
    if grid:
        recip[:] = 1.0
    cp = np.bincount(y, minlength=ncls).astype(np.float32) / n
    return x, y, recip, disc, cp


def _jax_hybrid(*args, **kw):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(JH.relief_hybrid_scores(*args, **kw))


def _force_path(monkeypatch, path):
    """Open the v2 gate, or close the square gate, in both packages; the
    port's blocked path then streams five focal blocks of 64 rows."""
    if path == "v2":
        for mod in (JD, TD):
            monkeypatch.setattr(mod, "_V2_MIN_N", 16)
    if path == "blocked":
        for mod in (JH, TH):
            monkeypatch.setattr(mod, "HYBRID_SQUARE_MAX_N", 64)
        monkeypatch.setattr(RC, "_CPU_BLOCK_BYTES", 64 * 320 * 48)


@pytest.mark.parametrize("algo,star,k,ncls", CASES)
@pytest.mark.parametrize("path,fixture", [
    ("v1", "grid"), ("v2", "grid"), ("blocked", "grid"),
    ("v1", "uniform"), ("blocked", "uniform")])
def test_hybrid_matches_jax(path, fixture, algo, star, k, ncls, monkeypatch,
                            rng):
    """The square path (unsorted rows, and class-sorted rows with the
    segment pass 2) and the blocked path, each against JAX's."""
    _force_path(monkeypatch, path)
    x, y, recip, disc, cp = _mixed(rng, ncls, grid=fixture == "grid")
    plan = TH.hybrid_plan(300, 46, 50, 5, torch.device("cpu"), algo)
    assert (plan.nb < plan.n_pad) == (path == "blocked")
    kw = dict(algo=algo, use_star=star, n_neighbors=k, class_probs=cp)
    got = TH.relief_hybrid_scores(x, y, recip, disc, **kw)
    ref = _jax_hybrid(x, y, recip, disc, **kw)
    assert got.dtype == np.float32 and got.shape == ref.shape
    assert_allclose(got, ref, atol=ATOL)
    assert_array_equal(np.argsort(got), np.argsort(ref))


def _cuda_gemm_size(v, device):
    return TD._round_up(v, TD._GEMM_ALIGN)


def test_cuda_padding_rules_change_nothing(monkeypatch, rng):
    """The padding a CUDA card's int8 GEMM needs (focal rows of a small
    class padded to 16, segments rounded to multiples of 128) gives the
    scores of the unpadded CPU run, on classes of 7, 13 and 280 rows, up
    to float32 sums over more rows (rtol 1e-6)."""
    _force_path(monkeypatch, "v2")
    x, _, recip, disc, _ = _mixed(rng, 3)
    y = np.array([0] * 7 + [1] * 13 + [2] * 280, np.int32)
    y = y[rng.permutation(300)]
    cp = np.bincount(y).astype(np.float32) / 300
    for algo, star, k in (("multisurf", True, 0), ("surf", True, 0),
                          ("relieff", False, 3)):
        kw = dict(algo=algo, use_star=star, n_neighbors=k, class_probs=cp)
        plain = TH.relief_hybrid_scores(x, y, recip, disc, **kw)
        with monkeypatch.context() as m:
            m.setattr(TD, "_gemm_size", _cuda_gemm_size)
            padded = TH.relief_hybrid_scores(x, y, recip, disc, **kw)
        assert_allclose(padded, plain, rtol=1e-6, atol=1e-9)


def test_hybrid_codes_equal_encoding(rng):
    """Scores from the analysis's codes for the whole matrix, and from the
    JAX analysis's codes carried by interop, equal those from the
    engine's own encoding of the discrete columns."""
    x, y, recip, disc, _ = _mixed(rng, 2)
    fa = TP.analyze_features(torch.from_numpy(x), 10)
    assert fa.x_dev is not None and fa.codes is not None
    assert_array_equal(fa.is_discrete.numpy(), disc)
    assert fa.n_states == 5
    kw = dict(algo="multisurf", use_star=True)
    own = TH.relief_hybrid_scores(x, y, recip, disc, **kw)
    via_fa = TH.relief_hybrid_scores(fa.x_dev, y, fa.recip, fa.is_discrete,
                                     codes=fa.codes, n_states=fa.n_states,
                                     **kw)
    assert_allclose(via_fa, own, atol=1e-7)
    fa_jax = JP.analyze_features_device(x, 10)
    assert fa_jax.codes is not None
    carried = analysis_from_jax(fa_jax)
    assert_array_equal(carried.codes[:, disc].numpy(),
                       fa.codes[:, disc].numpy())
    via_jax = TH.relief_hybrid_scores(x, y, recip, disc,
                                      codes=carried.codes,
                                      n_states=carried.n_states, **kw)
    assert_array_equal(via_jax, own)


def test_engine_routing():
    mixed = np.array([True, False, True])
    assert relief_engine(100, mixed, 3) == "hybrid"
    assert relief_engine(100, mixed, 0) == "hybrid"       # states unknown
    assert relief_engine(TH.HYBRID_MAX_N, mixed, 3) == "hybrid"
    assert relief_engine(TH.HYBRID_MAX_N + 1, mixed, 3) == "fused"
    assert relief_engine(100, mixed, 128) == "fused"
    assert relief_engine(100, np.ones(3, bool), 127) == "discrete"
    assert relief_engine(100, np.ones(3, bool), 128) == "fused"
    assert relief_engine(100, np.zeros(3, bool), 0) == "fused"
    cpu = torch.device("cpu")
    assert TH.hybrid_plan(24576, 10, 10, 3, cpu).nb == 24576
    blocked = TH.hybrid_plan(24577, 10, 10, 3, cpu)
    assert blocked.n_pad == 24640 and blocked.nb < blocked.n_pad
    assert blocked.n_pad % blocked.nb == 0 and blocked.nb % 64 == 0


def _spy(monkeypatch):
    """Count the engines a fit enters and the pass-1 kinds it runs."""
    calls = {"fused": 0, "hybrid": 0, "cont": 0, "mixed": 0}

    def counted(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    def pass1(*a, mixed, **kw):
        calls["mixed" if mixed else "cont"] += 1
        return dist_ref(*a, mixed=mixed, **kw)

    dist_ref = RC.dist_matrix_ref
    monkeypatch.setattr(RC, "relief_fused_scores",
                        counted("fused", RC.relief_fused_scores))
    monkeypatch.setattr(TH, "relief_hybrid_scores",
                        counted("hybrid", TH.relief_hybrid_scores))
    monkeypatch.setattr(RC, "dist_matrix_ref", pass1)
    return calls


@pytest.mark.parametrize("est", [MultiSURF, SURF, ReliefF])
def test_fits_route_mixed_data(est, monkeypatch, rng):
    """A mixed fit takes the hybrid engine (continuous pass 1 and int8
    GEMMs, no MIXED pass); a discrete column of more than 127 states, or
    more samples than HYBRID_MAX_N, sends it to the fused engine."""
    calls = _spy(monkeypatch)
    X = rng.rand(300, 8)
    X[:, :3] = rng.randint(0, 3, (300, 3))
    y = rng.randint(0, 2, 300)

    def fit(**params):
        calls.update(fused=0, hybrid=0, cont=0, mixed=0)
        TD.reset_gemm_ops()
        return est(backend="cpu", **params).fit(X, y)

    m = fit()
    assert calls["hybrid"] == 1 and calls["fused"] == 0
    assert calls["cont"] > 0 and calls["mixed"] == 0 and TD.gemm_ops > 0
    assert m.is_discrete_[:3].all() and not m.is_discrete_[3:].any()

    X[:, 3] = np.arange(300) % 100          # 100 states
    fit(discrete_limit=200)
    assert calls["hybrid"] == 1 and calls["fused"] == 0
    X[:, 3] = np.arange(300) % 150          # 150 states
    m = fit(discrete_limit=200)
    assert m.is_discrete_[:4].all() and not m.is_discrete_[4:].any()
    assert calls["fused"] == 1 and calls["hybrid"] == 0
    assert calls["mixed"] > 0 and TD.gemm_ops == 0

    monkeypatch.setattr(TH, "HYBRID_MAX_N", 299)
    fit()
    assert calls["fused"] == 1 and calls["hybrid"] == 0 and calls["mixed"] > 0


def test_estimator_on_hybrid_matches_jax(rng):
    """MultiSURF* on the card's route for mixed data against the JAX
    estimator's CPU fit (its generic engine), at the estimator tolerance
    of tests/test_torch_multisurf.py: rtol 1e-4, atol 1e-5."""
    import fastselect_tpu
    x, y, _, disc, _ = _mixed(rng, 2)
    port = MultiSURF(n_features_to_select=10, use_star=True,
                     backend="cpu").fit(x, y)
    ref = fastselect_tpu.MultiSURF(n_features_to_select=10, use_star=True,
                                   backend="cpu").fit(x, y)
    assert_array_equal(port.is_discrete_, disc)
    assert_allclose(port.feature_importances_, ref.feature_importances_,
                    rtol=1e-4, atol=ATOL)
    assert_array_equal(port.top_features_, ref.top_features_)
