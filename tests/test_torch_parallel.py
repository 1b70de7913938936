"""The port's multi-device layouts (``fastselect_tpu_torch.parallel``) on a
CPU mesh, against the port on one device and against JAX's layouts.

``tests/test_sharding.py``'s cases (all but the graft-entry contract and
the bit-packed staging, which the port does not have) run the port's
layout on ``[cpu] * ndev`` for ndev = 1..4: (a) against the port's
single-device engine at the JAX test's tolerances (continuous atol 2e-5 /
rtol 1e-5, discrete 2e-7 / 1e-6 where the auto-route test has them, pair
statistics bit for bit, MDR exact), and (b) against JAX's same layout on
``jax.devices()[:ndev]`` with equal rankings.  The auto-routes are reached
from the estimators with ``ops.relief._mesh_devices`` monkeypatched to a
CPU mesh.
"""

import math
from itertools import combinations

import jax
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

import fastselect_tpu.parallel as JP
import fastselect_tpu.parallel.feature_shard as JFS
import fastselect_tpu.ops.relief_discrete as JRD
import fastselect_tpu_torch.ops.relief as TR
import fastselect_tpu_torch.ops.relief_discrete as TRD
import fastselect_tpu_torch.parallel as TP
import fastselect_tpu_torch.parallel.feature_shard as TFS
import fastselect_tpu_torch.parallel.ring as TRING
import fastselect_tpu_torch.parallel.sharded as TSH
from fastselect_tpu.ops.relief import _relief_engine, pack_chunks
from fastselect_tpu.parallel.ring import (_ring_rule_groups as j_groups,
                                          _ring_skip_table as j_skip)
from fastselect_tpu.utils.preprocessing import (compute_recip_ranges,
                                                detect_discrete_features)
from fastselect_tpu_torch import MDR, SURF, MultiSURF, ReliefF
from fastselect_tpu_torch.ops import chi2_op, contingency as ct, mdr_op
from fastselect_tpu_torch.ops import relief_cuda as rc

torch.set_num_threads(2)

CPU = torch.device("cpu")
NDEVS = (1, 2, 3, 4)
CONT_TOL = dict(atol=2e-5, rtol=1e-5)    # tests/test_sharding.py:38
DISC_TOL = dict(atol=2e-7, rtol=1e-6)    # tests/test_sharding.py:213
JAX_TOL = dict(atol=1e-4)                # the port against JAX's layout
MESH_DEVICES = TR._mesh_devices


def cpus(ndev):
    return [CPU] * ndev


def _data(rng, n=48, p=20):
    """tests/test_sharding.py:16's mixed data."""
    X = rng.rand(n, p).astype(np.float32)
    X[:, 1] = rng.randint(0, 3, n)
    y = rng.randint(0, 2, n).astype(np.int32)
    return X, y, compute_recip_ranges(X), detect_discrete_features(X, 10)


def _cp(y, n_classes=2):
    return (np.bincount(y, minlength=n_classes) / len(y)).astype(np.float32)


def _same_ranking(a, b, tol=1e-6):
    """a and b rank the features alike: in either's descending order the
    other never rises by more than ``tol``.  Features whose scores are
    equal (up to float32 rounding; Relief on small discrete data ties
    exactly) may come in either order."""
    for u, v in ((a, b), (b, a)):
        order = np.argsort(-v, kind="stable")
        assert np.all(np.diff(u[order]) <= tol), (u[order], v[order])


def _held(got, single, jax_got, tol):
    """(a) against the port on one device, (b) against JAX's layout."""
    assert_allclose(got, single, **tol)
    assert_allclose(got, jax_got, **JAX_TOL)
    _same_ranking(got, jax_got)


# ---------------------------------------------------------------------------
# The mesh and its collectives
# ---------------------------------------------------------------------------

def test_make_mesh_repeats_and_converts():
    assert TP.make_mesh(["cpu", CPU, "cpu"]) == (CPU, CPU, CPU)
    assert TSH.distinct(TP.make_mesh(cpus(4))) == [CPU]


def test_make_mesh_default_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="at least one device"):
        TP.make_mesh()


def test_collectives_in_mesh_order():
    mesh = TP.make_mesh(cpus(3))
    parts = [torch.tensor([1e8, 1.0]), torch.tensor([-1e8, 1.0]),
             torch.tensor([1.0, 1.0])]
    # (1e8 - 1e8) + 1 in mesh order; 1e8 + 1 would round the 1 away
    assert TSH.psum(parts, mesh).tolist() == [1.0, 3.0]
    assert TSH.all_gather(parts, mesh).tolist() == [
        1e8, 1.0, -1e8, 1.0, 1.0, 1.0]
    t = torch.ones(2)
    assert TSH.ppermute(t, CPU) is t
    rep = TSH.replicate(t, mesh)
    assert list(rep) == [CPU] and rep[CPU] is t


# ---------------------------------------------------------------------------
# relief_engine_core against JAX's generic engine
# ---------------------------------------------------------------------------

CASES = [("multisurf", False, 0, 2), ("multisurf", True, 0, 2),
         ("surf", False, 0, 2), ("surf", True, 0, 3),
         ("relieff", False, 5, 3)]   # tests/test_engines.py:25


@pytest.mark.parametrize("row_split", [0, 64])
@pytest.mark.parametrize("algo,star,k,ncls", CASES)
def test_engine_core_matches_jax_engine(algo, star, k, ncls, row_split,
                                        rng):
    """relief_engine_core on the fused layout, all focal rows at once or
    split in two calls at global row ``row_split`` (as two shards), against
    JAX's _relief_engine on the same data."""
    n, p = 61, 37
    x = rng.rand(n, p).astype(np.float32)
    y = rng.randint(0, ncls, n).astype(np.int32)
    x[:, :5] = rng.randint(0, 3, (n, 5))
    x[:, 6] += 0.7 * (y == 1)
    recip = compute_recip_ranges(x)
    disc = detect_discrete_features(x, 10)
    cp = _cp(y, ncls)
    xf, yv, valid, recipf, discf, (t, cj) = pack_chunks(x, y, recip, disc)
    want = np.asarray(_relief_engine(
        xf, yv, valid, recipf, discf, np.float32(n), cp, algo=algo,
        use_star=star, k=k, t=t, cj=cj), np.float32)[:p] / n

    plan = rc.block_plan(n, p, CPU, algo, n_disc=int(disc.sum()))
    fl = rc.stage_fused(torch.from_numpy(x), y, recip, disc, cp, CPU,
                        plan.n_pad, plan.p_pad)
    kw = dict(algo=algo, use_star=star, k=k, nb=plan.nb, n_disc=fl.n_disc)
    cuts = [0, row_split, plan.n_pad] if row_split else [0, plan.n_pad]
    scores = sum(TR.relief_engine_core(
        fl.xp[a:b], fl.yv[a:b], fl.valid[a:b], a, fl.xp, fl.yv, fl.valid,
        fl.recip, fl.disc, fl.n_real, fl.class_probs, **kw)
        for a, b in zip(cuts, cuts[1:]))
    got = (scores.index_select(0, fl.pos) / fl.n_real).numpy()
    assert_allclose(got, want, **JAX_TOL)
    _same_ranking(got, want)


@pytest.mark.parametrize("algo,star,k,ncls", CASES)
def test_fused_scores_are_engine_core_at_row0(algo, star, k, ncls, rng):
    """relief_fused_scores is relief_engine_core over every row from row 0,
    bit for bit."""
    x, y, recip, disc = _data(rng, n=70, p=13)
    y = y % ncls
    cp = _cp(y, ncls)
    got = rc.relief_fused_scores(x, y, recip, disc, algo=algo,
                                 use_star=star, n_neighbors=k,
                                 class_probs=cp)
    plan = rc.block_plan(70, 13, CPU, algo, n_disc=int(disc.sum()))
    fl = rc.stage_fused(torch.from_numpy(x), y, recip, disc, cp, CPU,
                        plan.n_pad, plan.p_pad)
    core = TR.relief_engine_core(
        fl.xp, fl.yv, fl.valid, 0, fl.xp, fl.yv, fl.valid, fl.recip,
        fl.disc, fl.n_real, fl.class_probs, algo=algo, use_star=star, k=k,
        nb=plan.nb, n_disc=fl.n_disc)
    assert_array_equal(got, (core.index_select(0, fl.pos)
                             / fl.n_real).numpy())


# ---------------------------------------------------------------------------
# Sample shard (tests/test_sharding.py:29-79)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ndev", NDEVS)
@pytest.mark.parametrize("algo,kw", [
    ("multisurf", {}), ("multisurf", {"use_star": True}), ("surf", {}),
    ("relieff", {"n_neighbors": 3})])
def test_sharded_matches_single_device(algo, kw, ndev, rng):
    X, y, recip, is_disc = _data(rng)
    if algo == "relieff":
        kw = dict(kw, class_probs=_cp(y))
    single = rc.relief_fused_scores(X, y, recip, is_disc, algo=algo, **kw)
    got = TP.sharded_relief_scores(X, y, recip, is_disc, algo=algo,
                                   devices=cpus(ndev), **kw)
    want = JP.sharded_relief_scores(X, y, recip, is_disc, algo=algo,
                                    devices=jax.devices()[:ndev], **kw)
    _held(got, single, want, CONT_TOL)


@pytest.mark.parametrize("ndev", NDEVS)
def test_sharded_on_sub_mesh(ndev, rng):
    X, y, recip, is_disc = _data(rng, n=20, p=9)
    single = rc.relief_fused_scores(X, y, recip, is_disc, algo="multisurf")
    got = TP.sharded_multisurf_scores(X, y, recip, is_disc,
                                      devices=cpus(ndev))
    want = JP.sharded_multisurf_scores(X, y, recip, is_disc,
                                       devices=jax.devices()[:ndev])
    _held(got, single, want, CONT_TOL)


def test_sharded_continuous_takes_shards_with_their_rows(monkeypatch, rng):
    """Each shard runs relief_engine_core on its contiguous focal rows with
    their global offset, whole 64-row tiles."""
    X, y, recip, is_disc = _data(rng, n=150, p=7)
    calls = []
    orig = TSH.relief_engine_core

    def spy(x_f, *a, **k):
        calls.append((x_f.shape[0], a[2]))
        return orig(x_f, *a, **k)

    monkeypatch.setattr(TSH, "relief_engine_core", spy)
    TP.sharded_relief_scores(X, y, recip, is_disc, devices=cpus(3))
    assert calls == [(64, 0), (64, 64), (64, 128)]


@pytest.mark.parametrize("ndev", NDEVS)
def test_sharded_discrete_matches_single_device(ndev, rng):
    n, p = 48, 21
    codes = rng.randint(0, 3, (n, p)).astype(np.int8)
    y = rng.randint(0, 2, n).astype(np.int32)
    single = TRD.relief_discrete_scores(None, y, algo="multisurf",
                                        codes=codes, n_states=3)
    got = TP.sharded_relief_discrete_scores(codes, y, algo="multisurf",
                                            n_states=3, devices=cpus(ndev))
    want = JP.sharded_relief_discrete_scores(
        codes, y, algo="multisurf", n_states=3, devices=jax.devices()[:ndev])
    _held(got, single, want, CONT_TOL)


# ---------------------------------------------------------------------------
# Ring and feature shard (tests/test_sharding.py:82-125)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ndev", NDEVS)
@pytest.mark.parametrize("algo,kw", [
    ("multisurf", {}), ("multisurf", {"use_star": True}),
    ("relieff", {"n_neighbors": 3})])
def test_ring_matches_single_device(algo, kw, ndev, rng):
    n, p = 52, 19
    codes = rng.randint(0, 3, (n, p)).astype(np.int8)
    y = rng.randint(0, 2, n).astype(np.int32)
    if algo == "relieff":
        kw = dict(kw, class_probs=_cp(y))
    single = TRD.relief_discrete_scores(None, y, algo=algo, codes=codes,
                                        n_states=3, **kw)
    got = TP.ring_relief_discrete_scores(codes, y, algo=algo, n_states=3,
                                         devices=cpus(ndev), **kw)
    want = JP.ring_relief_discrete_scores(
        codes, y, algo=algo, n_states=3, devices=jax.devices()[:ndev], **kw)
    _held(got, single, want, CONT_TOL)


@pytest.mark.parametrize("ndev", NDEVS)
def test_feature_sharded_matches_single_device(ndev, rng):
    n, p = 30, 70
    codes = rng.randint(0, 3, (n, p)).astype(np.int8)
    y = rng.randint(0, 2, n).astype(np.int32)
    single = TRD.relief_discrete_scores(None, y, algo="multisurf",
                                        codes=codes, n_states=3)
    got = TP.feature_sharded_relief_discrete_scores(
        codes, y, algo="multisurf", n_states=3, devices=cpus(ndev))
    want = JP.feature_sharded_relief_discrete_scores(
        codes, y, algo="multisurf", n_states=3, devices=jax.devices()[:ndev])
    _held(got, single, want, CONT_TOL)


# ---------------------------------------------------------------------------
# chi2 and MDR (tests/test_sharding.py:128-151)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ndev", NDEVS)
def test_sharded_chi2_matches_single_device(ndev, rng):
    n, p = 80, 37
    X = rng.randint(0, 6, (n, p)).astype(np.float64)
    y = rng.randint(0, 3, n)
    single = chi2_op.chi2_stats(torch.from_numpy(X), y, 3)
    got = TP.sharded_chi2_stats(X, y, 3, devices=cpus(ndev))
    want = JP.sharded_chi2_stats(X, y, 3, devices=jax.devices()[:ndev])
    assert_allclose(got, single, rtol=1e-6, atol=1e-6)
    assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    _same_ranking(got, want)


@pytest.mark.parametrize("ndev", NDEVS)
def test_sharded_mdr_matches_single_device(ndev, rng):
    n, p, k = 60, 10, 2
    X = rng.randint(0, 3, (n, p)).astype(np.int32)
    y = rng.randint(0, 2, n)
    combos = np.array(list(combinations(range(p), k)), np.int32)
    single = mdr_op.batch_balanced_accuracy(X, y, combos, k)
    got = TP.sharded_batch_balanced_accuracy(X, y, combos, k,
                                             devices=cpus(ndev))
    want = JP.sharded_batch_balanced_accuracy(X, y, combos, k,
                                              devices=jax.devices()[:ndev])
    assert_array_equal(got, single)
    assert_allclose(got, want, atol=1e-6)


def _folds(y, n, n_folds=3):
    w_case = np.stack([(y == 1) & (np.arange(n) % n_folds != f)
                       for f in range(n_folds)])
    w_ctrl = np.stack([(y != 1) & (np.arange(n) % n_folds != f)
                       for f in range(n_folds)])
    return w_case, w_ctrl


@pytest.mark.parametrize("ndev", NDEVS)
@pytest.mark.parametrize("k,chunk", [(2, 32), (3, 32), (3, 64), (3, 1 << 18)])
def test_sharded_search_equals_single_device(k, chunk, ndev, rng):
    """Per-fold best BA, key and rank equal to MDRFoldScorer.search's,
    across chunk boundaries and a padded tail."""
    n, p = 60, 11
    X = rng.randint(0, 3, (n, p))
    y = rng.randint(0, 2, n)
    w_case, w_ctrl = _folds(y, n)
    n_combos = math.comb(p, k)
    single = mdr_op.MDRFoldScorer(X, w_case, w_ctrl, k).search(
        p, n_combos, chunk=chunk)
    got = TP.ShardedMDRFoldScorer(X, w_case, w_ctrl, k,
                                  devices=cpus(ndev)).search(
        p, n_combos, chunk=chunk)
    for a, b in zip(got, single):
        assert_array_equal(a, b)


@pytest.mark.parametrize("ndev", NDEVS)
def test_sharded_search_keeps_the_first_of_tied_combos(ndev):
    """Duplicated columns tie every combo with its twin: the first in
    lexicographic order wins, whichever shard scores the twin."""
    rng = np.random.RandomState(5)
    base = rng.randint(0, 3, (40, 4))
    X = np.hstack([base, base, base])          # 12 columns, 3 copies
    y = (base[:, 0] + base[:, 1]) % 3 == 0
    w_case, w_ctrl = _folds(y.astype(int), 40, 2)
    n_combos = math.comb(12, 2)
    single = mdr_op.MDRFoldScorer(X, w_case, w_ctrl, 2).search(
        12, n_combos, chunk=32)
    got = TP.ShardedMDRFoldScorer(X, w_case, w_ctrl, 2,
                                  devices=cpus(ndev)).search(
        12, n_combos, chunk=32)
    for a, b in zip(got, single):
        assert_array_equal(a, b)
    assert single[2].tolist() == [0, 0]        # (0, 1), the first twin


def test_mdr_fit_takes_the_sharded_scorer(monkeypatch):
    """MDR.fit takes ShardedMDRFoldScorer when the mesh has more than one
    device, and selects as on one device; FS_NO_AUTO_SHARD=1 keeps one."""
    import fastselect_tpu_torch.models.mdr as TM
    rng = np.random.RandomState(2)
    X = rng.randint(0, 3, (300, 9))
    y = ((X[:, 2] + X[:, 5]) % 3 == 0).astype(int)
    single = MDR(k=2, cv=3, backend="cpu").fit(X, y)
    made = []
    orig = TM.ShardedMDRFoldScorer

    def spy(*a, **k):
        made.append(k["devices"])
        return orig(*a, **k)

    monkeypatch.setattr(TM, "ShardedMDRFoldScorer", spy)
    monkeypatch.setattr(TR, "_mesh_devices", lambda device: cpus(3))
    monkeypatch.setattr(TM, "_COMBO_CHUNK", 32)
    sharded = MDR(k=2, cv=3, backend="cpu").fit(X, y)
    assert made == [cpus(3)]
    assert sharded._fold_best == single._fold_best
    assert sharded.best_interaction_ == single.best_interaction_ == (2, 5)
    assert sharded.best_mean_testing_ba_ == single.best_mean_testing_ba_
    monkeypatch.setenv("FS_NO_AUTO_SHARD", "1")
    monkeypatch.setattr(TR, "_mesh_devices", MESH_DEVICES)
    MDR(k=2, cv=3, backend="cpu").fit(X, y)
    assert len(made) == 1


# ---------------------------------------------------------------------------
# Determinism (tests/test_sharding.py:154)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["sample", "discrete", "ring", "feature"])
def test_same_bits_on_a_fixed_mesh(layout, rng):
    mesh = cpus(4)
    if layout == "sample":
        X, y, recip, is_disc = _data(rng, n=32, p=12)
        run = lambda: TP.sharded_relief_scores(  # noqa: E731
            X, y, recip, is_disc, algo="multisurf", devices=mesh)
    else:
        codes = rng.randint(0, 3, (40, 17)).astype(np.int8)
        y = rng.randint(0, 2, 40)
        fn = {"discrete": TP.sharded_relief_discrete_scores,
              "ring": TP.ring_relief_discrete_scores,
              "feature": TP.feature_sharded_relief_discrete_scores}[layout]
        run = lambda: fn(codes, y, n_states=3, devices=mesh)  # noqa: E731
    assert_array_equal(run(), run())


# ---------------------------------------------------------------------------
# The automatic routes from the estimators (tests/test_sharding.py:180-275)
# ---------------------------------------------------------------------------

def _spy(monkeypatch, module, name, calls):
    orig = getattr(module, name)

    def wrapper(*a, **k):
        calls.append(name)
        return orig(*a, **k)

    monkeypatch.setattr(module, name, wrapper)


def _auto_mesh(monkeypatch, ndev=4, elems=5000):
    monkeypatch.setattr(TR, "_AUTO_SHARD_MIN_ELEMS", elems)
    monkeypatch.setattr(TR, "_mesh_devices",
                        lambda device: [] if device is None else cpus(ndev))


def _single(monkeypatch, make, X, y):
    monkeypatch.setenv("FS_NO_AUTO_SHARD", "1")
    monkeypatch.setattr(TR, "_mesh_devices", MESH_DEVICES)
    calls = []
    _spy(monkeypatch, TR, "_sharded_dispatch", calls)
    est = make().fit(X, y)
    assert calls == []
    return est


@pytest.mark.parametrize("route,module,name,shape,ring", [
    ("sample", TSH, "sharded_relief_discrete_scores", (160, 64), False),
    ("feature", TFS, "feature_sharded_relief_discrete_scores", (130, 4200),
     False),
    ("ring", TRING, "ring_relief_discrete_scores", (160, 64), True)])
def test_auto_route_discrete(monkeypatch, route, module, name, shape, ring,
                             rng):
    _auto_mesh(monkeypatch)
    if ring:
        monkeypatch.setattr(TR, "_RING_BYTES", 1000)
    calls = []
    _spy(monkeypatch, module, name, calls)
    X = rng.randint(0, 3, shape).astype(np.float64)
    y = rng.randint(0, 2, shape[0])
    make = lambda: MultiSURF(backend="cpu")  # noqa: E731
    est = make().fit(X, y)
    assert calls == [name]
    single = _single(monkeypatch, make, X, y)
    assert_allclose(est.feature_importances_, single.feature_importances_,
                    **DISC_TOL)


@pytest.mark.parametrize("make", [SURF, MultiSURF])
def test_auto_route_continuous_sample_shard(monkeypatch, make, rng):
    _auto_mesh(monkeypatch)
    calls = []
    _spy(monkeypatch, TSH, "sharded_relief_scores", calls)
    X = rng.rand(160, 64)
    y = rng.randint(0, 2, 160)
    est = make(backend="cpu").fit(X, y)
    assert calls == ["sharded_relief_scores"]
    single = _single(monkeypatch, lambda: make(backend="cpu"), X, y)
    assert_allclose(est.feature_importances_, single.feature_importances_,
                    **CONT_TOL)


def test_auto_route_mixed_takes_the_fused_sample_shard(monkeypatch, rng):
    """Mixed data shards through the fused engine (JAX: its generic
    engine), where one device takes the hybrid engine."""
    _auto_mesh(monkeypatch)
    calls = []
    _spy(monkeypatch, TSH, "sharded_relief_scores", calls)
    X = rng.rand(160, 64)
    X[:, :20] = rng.randint(0, 3, (160, 20))
    y = rng.randint(0, 2, 160)
    X[:, 3] = 2 * y
    est = ReliefF(backend="cpu", n_neighbors=5).fit(X, y)
    assert calls == ["sharded_relief_scores"]
    single = _single(monkeypatch, lambda: ReliefF(backend="cpu",
                                                  n_neighbors=5), X, y)
    assert_allclose(est.feature_importances_, single.feature_importances_,
                    atol=1e-4)
    assert est.top_features_[0] == single.top_features_[0] == 3


def test_auto_route_skips_small_fits_and_tensor_fits(monkeypatch, rng):
    _auto_mesh(monkeypatch, elems=1 << 21)
    calls = []
    _spy(monkeypatch, TR, "_sharded_dispatch", calls)
    MultiSURF(backend="cpu").fit(rng.rand(40, 10), rng.randint(0, 2, 40))
    assert calls == []
    _auto_mesh(monkeypatch)
    X = rng.rand(160, 64)
    y = rng.randint(0, 2, 160)
    MultiSURF(backend="cpu").fit(torch.from_numpy(X), y)
    assert calls == []                       # a tensor fit never shards
    MultiSURF(backend="cpu").fit(rng.rand(60, 100), y[:60])
    assert calls == []                       # fewer than 16 rows a device
    MultiSURF(backend="cpu").fit(X, y)
    assert calls == ["_sharded_dispatch"]


def test_mesh_devices(monkeypatch):
    assert TR._mesh_devices(None) == [] and TR._mesh_devices(CPU) == []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    cuda = torch.device("cuda", 0)
    assert TR._mesh_devices(cuda) == [torch.device("cuda", i)
                                      for i in range(3)]
    monkeypatch.setenv("FS_NO_AUTO_SHARD", "1")
    assert TR._mesh_devices(cuda) == []


def test_routing_constants_are_jax():
    import fastselect_tpu.ops.relief as JR
    assert TR._AUTO_SHARD_MIN_ELEMS == JR._AUTO_SHARD_MIN_ELEMS == 1 << 21
    assert TR._RING_BYTES == JR._RING_BYTES == 4 << 30


# ---------------------------------------------------------------------------
# Pairwise statistic matrices (tests/test_sharding.py:283-323)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ndev", NDEVS)
@pytest.mark.parametrize("stat", ["mi", "su"])
def test_sharded_pairwise_stat_matches_single_device(stat, ndev, rng):
    X = rng.randint(0, 4, (90, 50)).astype(np.int32)
    single = ct.pairwise_stat_matrix(X, 4, stat, symmetric=False)
    got = TFS.sharded_pairwise_stat_matrix(X, 4, stat, devices=cpus(ndev),
                                           tile=32)
    assert_array_equal(got, single)
    want = JFS.sharded_pairwise_stat_matrix(X, 4, stat, tile=8,
                                            devices=jax.devices()[:ndev])
    assert_allclose(got, want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("symmetric", [True, False])
def test_pairwise_stat_matrix_autoroutes_to_mesh(monkeypatch, symmetric,
                                                 rng):
    calls = []
    _spy(monkeypatch, TFS, "sharded_pairwise_stat_matrix", calls)
    X = rng.randint(0, 3, (40, 1030)).astype(np.int32)
    ref = ct.pairwise_stat_matrix(X, 3, "mi", symmetric=symmetric)
    monkeypatch.setattr(TR, "_mesh_devices", lambda device: cpus(3))
    got = ct.pairwise_stat_matrix(X, 3, "mi", symmetric=symmetric)
    assert calls == ["sharded_pairwise_stat_matrix"]
    assert_array_equal(got, ref)
    if symmetric:
        assert_array_equal(got, got.T)
    ct.pairwise_stat_matrix(X[:, :1000], 3, "mi")
    assert len(calls) == 1                   # under 1,024 features


@pytest.mark.parametrize("s", [2, 3, 5])
def test_staged_columns_over_the_mesh(monkeypatch, s, rng):
    """StagedColumnStats deals its feature tiles round-robin over the
    mesh; every column equals the one-device one bit for bit."""
    X = rng.randint(0, s, (50, 200))
    monkeypatch.setattr(ct, "_ONEHOT_BYTES", 56 * 32 * (s - (s >= 3)))
    single = ct.StagedColumnStats(X, s)
    monkeypatch.setattr(TR, "_mesh_devices", lambda device: cpus(3))
    staged = ct.StagedColumnStats(X, s)
    assert len(staged._tiles) == len(single._tiles) > 3
    for j in (0, 7, 199):
        assert_array_equal(staged.column(j, "su"), single.column(j, "su"))
    y = rng.randint(0, 2, 50)
    assert_array_equal(staged.stats_vs(y, 2, "mi"),
                       single.stats_vs(y, 2, "mi"))


# ---------------------------------------------------------------------------
# v2 layouts and the ring's skip table (tests/test_sharding.py:330-450)
# ---------------------------------------------------------------------------

@pytest.fixture
def force_v2(monkeypatch):
    monkeypatch.setattr(JRD, "_V2_MIN_N", 16)
    monkeypatch.setattr(TRD, "_V2_MIN_N", 16)


@pytest.mark.parametrize("ndev", NDEVS)
@pytest.mark.parametrize("algo,kw", [
    ("multisurf", {}), ("multisurf", {"use_star": True}),
    ("surf", {"use_star": True}), ("relieff", {"n_neighbors": 3})])
def test_sharded_discrete_v2_matches_single_device(monkeypatch, force_v2,
                                                   algo, kw, ndev, rng):
    calls = []
    _spy(monkeypatch, TSH, "_sharded_discrete_v2", calls)
    n, p = 72, 26
    codes = rng.randint(0, 3, (n, p)).astype(np.int8)
    y = rng.randint(0, 2, n).astype(np.int32)
    if algo == "relieff":
        kw = dict(kw, class_probs=_cp(y))
    single = TRD.relief_discrete_scores(None, y, algo=algo, codes=codes,
                                        n_states=3, **kw)
    got = TP.sharded_relief_discrete_scores(codes, y, algo=algo, n_states=3,
                                            devices=cpus(ndev), **kw)
    want = JP.sharded_relief_discrete_scores(
        codes, y, algo=algo, n_states=3, devices=jax.devices()[:ndev], **kw)
    _held(got, single, want, CONT_TOL)
    assert calls == ["_sharded_discrete_v2"]


def test_v2_blocks_are_dealt_round_robin_per_plan(monkeypatch, force_v2,
                                                  rng):
    """Blocks of each plan group go to the shards in turn: every shard of
    a 3-shard mesh scores its share of an 8-block layout."""
    codes = rng.randint(0, 3, (64, 9)).astype(np.int8)
    y = np.repeat([0, 1], 32)
    seen = []
    orig = TRD._block_scores_v2
    sizes = TRD._discrete_tile_sizes
    monkeypatch.setattr(TRD, "_discrete_tile_sizes",
                        lambda *a: (8, sizes(*a)[1]))

    def spy(ci, yi, vi, iid, *a, **k):
        seen.append(int(iid[0]) // 8)
        return orig(ci, yi, vi, iid, *a, **k)

    monkeypatch.setattr(TRD, "_block_scores_v2", spy)
    layout = TRD._tiles_and_layout(64, 9, 3, y, "multisurf", None, CPU)[0]
    assert layout[3] == [0, 0, 0, 0, 1, 1, 1, 1]
    TP.sharded_relief_discrete_scores(codes, y, n_states=3,
                                      devices=cpus(3))
    # group of class 0: blocks 0-3, of class 1: 4-7, dealt 0,1,2,0 each
    assert seen == [0, 3, 4, 7, 1, 5, 2, 6]


@pytest.mark.parametrize("ndev", NDEVS)
@pytest.mark.parametrize("algo,kw", [
    ("multisurf", {}), ("surf", {"use_star": True}),
    ("relieff", {"n_neighbors": 3})])
def test_feature_shard_v2_matches_single_device(force_v2, algo, kw, ndev,
                                                rng):
    n, p = 44, 90
    codes = rng.randint(0, 3, (n, p)).astype(np.int8)
    y = rng.randint(0, 3, n).astype(np.int32)
    if algo == "relieff":
        kw = dict(kw, class_probs=_cp(y, 3))
    single = TRD.relief_discrete_scores(None, y, algo=algo, codes=codes,
                                        n_states=3, **kw)
    got = TP.feature_sharded_relief_discrete_scores(
        codes, y, algo=algo, n_states=3, devices=cpus(ndev), **kw)
    want = JP.feature_sharded_relief_discrete_scores(
        codes, y, algo=algo, n_states=3, devices=jax.devices()[:ndev], **kw)
    _held(got, single, want, CONT_TOL)


@pytest.mark.parametrize("ndev", NDEVS)
@pytest.mark.parametrize("algo,kw", [
    ("multisurf", {"use_star": True}), ("surf", {}),
    ("relieff", {"n_neighbors": 3})])
def test_ring_v2_skip_table_matches_single_device(monkeypatch, force_v2,
                                                  algo, kw, ndev, rng):
    n, p = 52, 19
    codes = rng.randint(0, 3, (n, p)).astype(np.int8)
    y = rng.randint(0, 2, n).astype(np.int32)
    if algo == "relieff":
        kw = dict(kw, class_probs=_cp(y))
    single = TRD.relief_discrete_scores(None, y, algo=algo, codes=codes,
                                        n_states=3, **kw)
    calls = []
    _spy(monkeypatch, TRING, "_ring_skip_table", calls)
    got = TP.ring_relief_discrete_scores(codes, y, algo=algo, n_states=3,
                                         devices=cpus(ndev), **kw)
    want = JP.ring_relief_discrete_scores(
        codes, y, algo=algo, n_states=3, devices=jax.devices()[:ndev], **kw)
    _held(got, single, want, CONT_TOL)
    assert calls == ["_ring_skip_table"]


def test_ring_skips_contractions_by_the_table(monkeypatch, force_v2, rng):
    """Two classes on four shards: each shard's 'same' and 'other' groups
    contract two of the four blocks in flight each, so sweep 2 runs 16 of
    its 32 (group, step) contractions; sweep 1 all 16 match blocks."""
    codes = rng.randint(0, 3, (64, 11)).astype(np.int8)
    y = np.repeat([0, 1], 32)
    counts = {"match": 0, "acc": 0}
    orig_m, orig_a = TRD._match_rows, TRD._accumulate_discrete

    def m(*a, **k):
        counts["match"] += 1
        return orig_m(*a, **k)

    def acc(*a, **k):
        counts["acc"] += 1
        return orig_a(*a, **k)

    monkeypatch.setattr(TRD, "_match_rows", m)
    monkeypatch.setattr(TRD, "_accumulate_discrete", acc)
    TP.ring_relief_discrete_scores(codes, y, n_states=3, devices=cpus(4))
    assert counts == {"match": 16, "acc": 16}


@pytest.mark.parametrize("algo,star,n_cls", [
    ("multisurf", False, 2), ("multisurf", True, 3), ("surf", False, 2),
    ("surf", True, 2), ("relieff", False, 3)])
@pytest.mark.parametrize("segments,n,nb,ndev", [
    ([(0, 32), (32, 32)], 64, 16, 4),
    ([(0, 10), (10, 25), (35, 17)], 52, 16, 4),
    ([(0, 5), (5, 40)], 45, 24, 2)])
def test_ring_tables_equal_jax(algo, star, n_cls, segments, n, nb, ndev):
    segments = segments[:n_cls] if len(segments) >= n_cls else segments
    groups = TRING._ring_rule_groups(algo, star, len(segments))
    assert groups == j_groups(algo, star, len(segments))
    assert_array_equal(TRING._ring_skip_table(groups, segments, n, nb, ndev),
                       j_skip(groups, segments, n, nb, ndev))


def test_ring_skip_table_structure():
    """tests/test_sharding.py:435: single-class devices skip about half the
    pass-2 steps in a balanced 2-class layout."""
    segments = [(0, 32), (32, 32)]
    groups = TRING._ring_rule_groups("multisurf", False, 2)
    tbl = TRING._ring_skip_table(groups, segments, 64, 16, 4)
    assert tbl[0, 0].tolist() == [1, 1, 0, 0]
    assert tbl[1, 0].tolist() == [0, 0, 1, 1]
    assert tbl[0, 3].tolist() == [0, 0, 1, 1]
    assert tbl[1, 3].tolist() == [1, 1, 0, 0]
