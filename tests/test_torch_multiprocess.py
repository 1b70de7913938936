"""The port's layouts over a mesh that spans processes: gloo groups of CPU
processes on this host, against the one-process mesh of the same shards
and against JAX's layouts.

Each group (``chip_smoke.run_processes``: ``spawn``, a ``FileStore`` in a
temporary directory, a hard deadline) runs every case of
``tests/torch_mp_workers.py`` once; the parametrised tests read its
results.  Meshes: 2 and 4 processes of one shard each, and the uneven
one, 2 processes of two shards each, interleaved as ranks 0, 1, 0, 1
(every ring step then crosses processes both ways).  Every rank's result
must equal the one-process mesh ``[cpu] * shards`` bit for bit (and so
every other rank's), and lie within ``tests/test_torch_parallel.py``'s
tolerances of JAX's same layout on ``jax.devices()[:shards]``, which this
process computes: the workers never import JAX.  The sharded MDR search
has no JAX counterpart; it is held to the port's one-device search.
"""

import math

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from numpy.testing import assert_allclose, assert_array_equal

import fastselect_tpu.ops.contingency as JC
import fastselect_tpu.ops.relief_discrete as JRD
import fastselect_tpu.parallel as JP
import fastselect_tpu.parallel.feature_shard as JFS
import fastselect_tpu_torch.ops.relief as TR
import chip_smoke as cs
import fastselect_tpu_torch.parallel.sharded as TSH
import torch_mp_workers as W
from fastselect_tpu_torch import MDR, MultiSURF
from fastselect_tpu_torch.ops import contingency as ct
from fastselect_tpu_torch.ops import mdr_op
from fastselect_tpu_torch.ops import relief_cuda as rc
from fastselect_tpu_torch.parallel import distributed

CPU = torch.device("cpu")
CONT_TOL = dict(atol=2e-5, rtol=1e-5)    # tests/test_torch_parallel.py
JAX_TOL = dict(atol=1e-4)                # the port against JAX's layout
PAIR_TOL = dict(rtol=1e-5, atol=1e-7)    # pair statistics against JAX
DEADLINE_S = 180.0
# name -> (processes, rank of each shard; None: one CPU shard a process)
GROUPS = {"w2": (2, None), "w4": (4, None), "w2x2": (2, (0, 1, 0, 1))}
AUTO_GROUP = "w4"
_RUNS: dict = {}


def group(name):
    """Every rank's report of the group's run, started once per module."""
    if name not in _RUNS:
        world, ranks = GROUPS[name]
        names = W.LAYOUTS + (W.AUTO + W.MISMATCH if name == AUTO_GROUP
                             else ())
        _RUNS[name] = cs.run_processes(
            W.group_worker, world, (names, ranks), deadline_s=DEADLINE_S)
    return _RUNS[name]


def shards(name):
    world, ranks = GROUPS[name]
    return world if ranks is None else len(ranks)


def _same_ranking(a, b, tol=1e-6):
    """tests/test_torch_parallel.py's rule: in either's descending order
    the other never rises by more than ``tol``."""
    for u, v in ((a, b), (b, a)):
        order = np.argsort(-v, kind="stable")
        assert np.all(np.diff(u[order]) <= tol), (u[order], v[order])


def jax_layout(name, ndev, monkeypatch):
    """JAX's same layout of the case on ``jax.devices()[:ndev]``."""
    args, kw = W.inputs(name)
    devs = jax.devices()[:ndev]
    if name in ("discrete-v2", "ring-skip", "feature-v2"):
        monkeypatch.setattr(JRD, "_V2_MIN_N", 16)
    if name.startswith("fused"):
        return JP.sharded_relief_scores(*args, devices=devs, **kw)
    if name.startswith("discrete"):
        return JP.sharded_relief_discrete_scores(*args, devices=devs, **kw)
    if name.startswith("ring"):
        return JP.ring_relief_discrete_scores(*args, devices=devs, **kw)
    if name.startswith("feature"):
        return JP.feature_sharded_relief_discrete_scores(*args, devices=devs,
                                                         **kw)
    if name in ("mi", "su"):
        return JFS.sharded_pairwise_stat_matrix(args[0], 4, name, tile=8,
                                                devices=devs)
    if name == "staged":
        X, y = args
        staged = JC.StagedColumnStats(X, 3, device=None)
        return np.stack([staged.column(j, "su") for j in (0, 7, 199)]
                        + [staged.stats_vs(y, 2, "mi")])
    if name == "chi2":
        return JP.sharded_chi2_stats(*args, 3, devices=devs)
    if name == "mdr-scores":
        return JP.sharded_batch_balanced_accuracy(*args, 2, devices=devs)
    raise KeyError(name)


@pytest.mark.parametrize("case", W.LAYOUTS)
@pytest.mark.parametrize("name", list(GROUPS))
def test_layout_over_processes(name, case, monkeypatch):
    """Every rank returns the one-process mesh's result on the same
    shards, bit for bit, and JAX's within the one-process tolerances."""
    ndev = shards(name)
    runs = group(name)
    one = W.run_case(case, [CPU] * ndev)
    for run in runs:
        got = run["results"][case]
        if isinstance(one, tuple):
            for a, b in zip(got, one):
                assert_array_equal(a, b)
        else:
            assert got.dtype == one.dtype and got.shape == one.shape
            assert_array_equal(got, one)
    if case in ("mdr-search", "mdr-tie"):
        X, w_case, w_ctrl, k = W.inputs(case)[0]
        p = X.shape[1]
        single = mdr_op.MDRFoldScorer(X, w_case, w_ctrl, k).search(
            p, math.comb(p, k), chunk=32)
        for a, b in zip(one, single):
            assert_array_equal(a, b)
        if case == "mdr-tie":
            assert single[2].tolist() == [0, 0]    # (0, 1), the first twin
        return
    want = jax_layout(case, ndev, monkeypatch)
    if case in ("mi", "su", "staged"):
        assert_allclose(one, want, **PAIR_TOL)
    elif case == "chi2":
        assert_allclose(one, want, rtol=1e-5, atol=1e-5)
        _same_ranking(one, want)
    elif case == "mdr-scores":
        assert_allclose(one, want, atol=1e-6)
    else:
        assert_allclose(one, want, **JAX_TOL)
        _same_ranking(one, want)


@pytest.mark.parametrize("name", list(GROUPS))
def test_group_mesh_budget_and_imports(name):
    """The group's mesh is every rank's shards in rank order on every
    rank; the focal-block budget is shared by the processes on the host's
    CPU; the collectives ran; no process imported JAX or the JAX
    package."""
    world, ranks = GROUPS[name]
    runs = group(name)
    assert [run["rank"] for run in runs] == list(range(world))
    for run in runs:
        assert run["ranks"] == list(ranks or range(world))
        assert run["mesh"] == ["cpu"] * shards(name)
        assert run["sharers"] == world
        assert run["budget"] == rc._CPU_BLOCK_BYTES // world
        assert run["comm"]["calls"] > 0 and run["comm"]["bytes"] > 0
        assert run["imports"] == []
    assert len({run["comm"]["calls"] for run in runs}) == 1


ROUTES = {"auto-multisurf": "sharded_relief_scores",
          "auto-ring": "ring_relief_discrete_scores",
          "auto-feature": "feature_sharded_relief_discrete_scores",
          "auto-mdr": "ShardedMDRFoldScorer",
          "auto-pairwise": "sharded_pairwise_stat_matrix"}


@pytest.mark.parametrize("case", W.AUTO)
def test_auto_route_under_a_group(case):
    """Under a group the estimators' routes take the group's mesh (one CPU
    a process): every rank reaches the layout and returns what one
    process returns on ``[cpu] * 4`` bit for bit; the selection equals the
    fit on one device."""
    ndev = shards(AUTO_GROUP)
    runs = group(AUTO_GROUP)
    one, one_calls = W.run_case(case, [CPU] * ndev)
    assert one_calls == [ROUTES[case]]
    for run in runs:
        got, calls = run["results"][case]
        assert calls == [ROUTES[case]]
        for a, b in zip(got if isinstance(got, tuple) else (got,),
                        one if isinstance(one, tuple) else (one,)):
            assert_array_equal(a, b)
    args, _ = W.inputs(case)
    if case == "auto-mdr":
        single = MDR(k=2, cv=3, backend="cpu").fit(*args)
        assert one[1].tolist() == list(single.best_interaction_) == [2, 5]
        assert one[0].tolist() == np.array(single._fold_best).tolist()
    elif case == "auto-pairwise":
        assert_array_equal(one, ct.pairwise_stat_matrix(args[0], 3, "mi"))
    else:
        single = MultiSURF(backend="cpu").fit(*args)
        assert_array_equal(one[1], single.top_features_)
        assert_allclose(one[0], single.feature_importances_, **CONT_TOL)


@pytest.mark.parametrize("case", W.MISMATCH)
def test_routes_refuse_other_data_on_a_rank(case):
    """Rank 1 of four passes another y (or X) of the same shape: the
    route's check raises on every rank, with one message, before any
    collective of the layout runs."""
    runs = group(AUTO_GROUP)
    got = [run["results"][case] for run in runs]
    assert got[0] is not None and "same inputs" in got[0]
    assert "ranks [1]" in got[0]
    assert got == [got[0]] * len(runs)


def test_block_budget_is_shared_by_the_processes_on_a_device():
    """_block_budget_bytes divides by the processes whose shards share the
    device; a one-process mesh keeps the whole budget."""
    assert rc._block_budget_bytes(CPU) == rc._CPU_BLOCK_BYTES
    assert rc._block_budget_bytes(CPU, 4) == rc._CPU_BLOCK_BYTES // 4
    mesh = TSH.make_mesh([CPU] * 3)
    assert TSH.sharers(mesh, CPU) == 1
    shared = TSH.Mesh([CPU] * 4, places=["h/cpu"] * 4)
    assert TSH.sharers(shared, CPU) == 1      # all one process's


def _one_rank_group(tmp_path):
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)


def test_collectives_in_a_one_rank_group(tmp_path):
    """The helpers call the group's collective whenever the mesh has a
    group, one rank included (``chip_smoke.py`` runs this under NCCL on
    the card): the float psum adds in mesh order, the integer psum and
    merge_disjoint are exact, all_gather takes parts of any length."""
    _one_rank_group(tmp_path)
    try:
        mesh = TSH.make_mesh([(0, CPU)] * 3)
        assert mesh.group is not None and mesh.mine == [0, 1, 2]
        parts = [torch.tensor([1e8, 1.0]), torch.tensor([-1e8, 1.0]),
                 torch.tensor([1.0, 1.0])]
        TSH.reset_comm()
        assert TSH.psum(parts, mesh).tolist() == [1.0, 3.0]
        ints = [torch.tensor([2 ** 29, 1], dtype=torch.int32)] * 3
        assert TSH.psum(ints, mesh).tolist() == [3 * 2 ** 29, 3]
        assert TSH.all_gather(
            [torch.ones(2, 1), torch.zeros(0, 1), torch.full((1, 1), 2.)],
            mesh).flatten().tolist() == [1.0, 1.0, 2.0]
        neg = torch.tensor([-0.0, 1.5, float("nan")])
        assert_array_equal(TSH.merge_disjoint(neg, mesh).numpy().view(
            np.int32), neg.numpy().view(np.int32))
        held = {s: torch.full((2,), float(s)) for s in range(3)}
        assert [t.tolist() for t in TSH.ring_shift(held, mesh).values()] \
            == [[2.0, 2.0], [0.0, 0.0], [1.0, 1.0]]
        assert TSH.comm["calls"] == 5     # the ring step stays local
        assert TSH.make_mesh([(0, CPU)] * 3) is mesh
    finally:
        dist.destroy_process_group()
    assert not TR._mesh_devices(CPU)             # no group: no route


def test_a_new_group_gets_a_new_mesh(tmp_path):
    """A mesh is cached for its group only: after the group is destroyed
    and another made, make_mesh gathers a mesh of the new group."""
    meshes = []
    for i in range(2):
        dist.init_process_group("gloo", store=dist.FileStore(
            str(tmp_path / f"store{i}"), 1), rank=0, world_size=1)
        try:
            mesh = TSH.make_mesh([(0, CPU)] * 2)
            assert mesh.group is dist.group.WORLD
            assert TSH.psum([torch.ones(2)] * 2, mesh).tolist() == [2.0, 2.0]
            meshes.append(mesh)
        finally:
            dist.destroy_process_group()
    assert meshes[1] is not meshes[0]


def test_make_mesh_takes_rank_device_pairs():
    """Pairs of rank 0 need no group; other ranks do; a plain device list
    keeps today's mesh."""
    assert TSH.make_mesh([(0, "cpu"), (0, CPU)]) == (CPU, CPU)
    with pytest.raises(ValueError, match="need a process group"):
        TSH.make_mesh([(0, "cpu"), (1, "cpu")])
    mesh = TSH.make_mesh(["cpu"] * 2)
    assert mesh.group is None and mesh.ranks == (0, 0)
    assert TSH.make_mesh(mesh) is mesh


def test_a_failing_process_fails_the_group():
    with pytest.raises(Exception, match="rank 1 fails on purpose"):
        cs.run_processes(W.raising_worker, 2, deadline_s=60)


def test_a_deadlocked_group_is_terminated():
    """A collective that one rank never joins: the group is ended at its
    deadline and the call raises, so no test can hang the suite."""
    with pytest.raises(TimeoutError, match="terminated"):
        cs.run_processes(W.hanging_worker, 2, deadline_s=12)


def test_local_devices_follow_the_launcher(monkeypatch):
    """A rank offers its CPU without a card; under a launcher of several
    processes a host with at least as many cards, rank LOCAL_RANK takes
    every LOCAL_WORLD_SIZE-th card from its own; else every card."""
    for var in ("LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert distributed.local_devices() == [CPU]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    cards = [torch.device("cuda", i) for i in range(8)]
    assert distributed.local_devices() == cards
    monkeypatch.setenv("LOCAL_RANK", "3")
    for world, want in (("8", [cards[3]]), ("4", [cards[3], cards[7]]),
                        ("16", cards)):
        monkeypatch.setenv("LOCAL_WORLD_SIZE", world)
        assert distributed.local_devices() == want
