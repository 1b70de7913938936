"""chip_smoke.py's mesh and profiling phases (21-22) rehearsed on the CPU at
a small size, on a mesh of four CPU shards, with their referees, and its
phase 23 as four CPU processes in a gloo group.

On the CPU the kernel wrappers run their plain versions and count no
launch; here they count as the kernels would, so that the phases' launch
checks see which passes ran."""

import numpy as np
import pytest
import torch

import chip_smoke as cs
import torch_mp_workers as W
from fastselect_tpu_torch import MultiSURF, _build
from fastselect_tpu_torch.models import mdr as mdr_mod
from fastselect_tpu_torch.ops import relief as relief_mod
from fastselect_tpu_torch.ops import relief_cuda as rc
from fastselect_tpu_torch.ops import relief_discrete as rd

torch.set_num_threads(2)

CPU = torch.device("cpu")
MESH = [CPU] * 4


@pytest.fixture
def cpu_card(monkeypatch):
    """torch.cuda's timers and memory statistics as no-ops, the plain
    passes and ReliefF's plain rule on the fused engine and the int8
    GEMM's twin counted as launches, and the auto-route's size gate
    lowered."""
    for name in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(relief_mod, "_AUTO_SHARD_MIN_ELEMS", 1000)
    for pass_no, name in ((1, "dist_matrix"), (2, "accumulate")):
        orig = getattr(rc, name)

        def counted(*a, _orig=orig, _pass=pass_no, **k):
            kind = "mixed" if k["mixed"] else "cont"
            _build.launches[f"relief_pass{_pass}_{kind}"] += 1
            return _orig(*a, **k)
        monkeypatch.setattr(rc, name, counted)
    make = relief_mod.weight_rule

    def counted_rule(*a, **k):
        rule = make(*a, **k)
        if k["algo"] != "relieff":
            return rule

        def counted(*b):
            _build.launches["relieff_weights"] += 1
            return rule(*b)
        return counted
    monkeypatch.setattr(relief_mod, "weight_rule", counted_rule)
    gemm = rd.int8_gemm

    def counted_gemm(*a, **k):
        _build.launches["int8_gemm"] += 1
        return gemm(*a, **k)
    monkeypatch.setattr(rd, "int8_gemm", counted_gemm)


def test_mesh_large_n_and_mixed_rehearse(cpu_card):
    X, y = cs.make_classification(n_samples=300, n_features=40,
                                  n_informative=10, random_state=0)
    X = X.astype(np.float32)
    single = MultiSURF(n_features_to_select=10).fit(X, y)
    sec, warm, _ = cs.mesh_fit_phase(
        MESH, "mesh-large-n", lambda: MultiSURF(n_features_to_select=10),
        X, y, single.feature_importances_, (cs.psh, "sharded_relief_scores"),
        "cont", (cs.fit_tol(single.feature_importances_), 0.0))
    assert sec > 0 and len(warm) == 1
    X[:, :10] = np.random.RandomState(3).randint(0, 3, (300, 10))
    X[:, 0] = 2 * y
    X[:, 1] = np.arange(300) % 150            # 150 states
    est = MultiSURF(n_features_to_select=10, discrete_limit=200).fit(X, y)
    assert cs.mesh_mixed_phase(CPU, MESH, X, y, est) > 0


def test_mesh_discrete_layouts_rehearse(monkeypatch, cpu_card):
    monkeypatch.setattr(cs, "MESH_GEMM_LAUNCHES", {})
    X, y = cs.planted_genotypes(0, 64, 4096, 2)        # p >= 4n, 4,096
    single = MultiSURF(n_features_to_select=10).fit(X, y)
    cs.mesh_fit_phase(
        MESH, "mesh-snp", lambda: MultiSURF(n_features_to_select=10), X, y,
        single.feature_importances_,
        (cs.feature_shard, "feature_sharded_relief_discrete_scores"), "gemm",
        cs.DISC_TOL, warm=0)
    monkeypatch.setattr(rd, "_V2_MIN_N", 16)
    X, y = cs.planted_genotypes(2, 300, 64, 2)
    make = lambda: MultiSURF(n_features_to_select=3,  # noqa: E731
                             use_star=True)
    single = make().fit(X, y).feature_importances_
    cs.mesh_fit_phase(MESH, "mesh-v2", make, X, y, single,
                      (cs.psh, "_sharded_discrete_v2"), "gemm", cs.DISC_TOL,
                      warm=0)
    cs.mesh_fit_phase(MESH, "mesh-ring", make, X, y, single,
                      (cs.parallel.ring, "_ring_skip_table"), "gemm",
                      (cs.fit_tol(single), 0.0), warm=0,
                      ring_bytes=X.size - 1)
    assert relief_mod._RING_BYTES == 4 << 30       # restored
    # each layout's launches of the int8 GEMM, kept for the summary
    assert set(cs.MESH_GEMM_LAUNCHES) == {"mesh-snp", "mesh-v2", "mesh-ring"}
    assert all(v["int8_gemm"] > 0 for v in cs.MESH_GEMM_LAUNCHES.values())


def test_mesh_route_checks_fail_loudly(cpu_card):
    """A fit that does not take the expected route fails the phase."""
    X, y = cs.planted_genotypes(0, 100, 50, 2)
    single = MultiSURF(n_features_to_select=3).fit(X, y)
    with pytest.raises(RuntimeError, match="routed to"):
        cs.mesh_fit_phase(
            MESH, "mesh-snp", lambda: MultiSURF(n_features_to_select=3), X,
            y, single.feature_importances_,
            (cs.feature_shard, "feature_sharded_relief_discrete_scores"),
            "gemm", cs.DISC_TOL, warm=0)


def test_mesh_mdr_and_stats_rehearse(monkeypatch, cpu_card):
    monkeypatch.setattr(mdr_mod, "_COMBO_CHUNK", 64)
    res, _ = cs.mdr_k3_phase(CPU, n=600, p=12)
    assert cs.mesh_mdr_phase(CPU, MESH, res["X"], res["y"], res["planted"],
                             res) > 0
    assert cs.mesh_stats_phase(CPU, MESH, n=120, p=1100) > 0


def test_mesh_chi2_and_profiling_rehearse(monkeypatch, cpu_card, tmp_path):
    monkeypatch.setattr(cs, "cuda_ms", lambda fn, reps: (fn(), 0.0)[1])
    dev_ms, host_s = cs.chi2_phase(CPU, n=200, p=3000, meshes=[MESH])
    assert host_s > 0
    X, y = cs.make_classification(n_samples=200, n_features=20,
                                  random_state=0)
    timing = cs.profiling_phase(CPU, X.astype(np.float32), y,
                                tmp_path / "trace")
    assert timing.seconds > 0
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0


def test_mesh_procs_rehearse(monkeypatch, cpu_card):
    """Phase 23 at a small size: phase 21's layouts on four CPU shards in
    one process, then four CPU processes in a gloo group on the same data,
    each layout held to phase 21's result; the collectives in a one-rank
    gloo group.  Every kernel's plain pass is counted in the processes."""
    monkeypatch.setattr(cs, "MESH_RESULTS", {})
    monkeypatch.setattr(cs, "MESH_GEMM_LAUNCHES", {})
    monkeypatch.setattr(rd, "_V2_MIN_N", 16)
    monkeypatch.setattr(mdr_mod, "_COMBO_CHUNK", 64)
    make = lambda: MultiSURF(n_features_to_select=10)  # noqa: E731
    X_n, y_n = cs.make_classification(n_samples=300, n_features=40,
                                      n_informative=10, random_state=0)
    X_n = X_n.astype(np.float32)
    single = make().fit(X_n, y_n).feature_importances_
    cs.mesh_fit_phase(MESH, "mesh-large-n", make, X_n, y_n, single,
                      (cs.psh, "sharded_relief_scores"), "cont",
                      (cs.fit_tol(single), 0.0))
    X_mf, y_mf = X_n.copy(), y_n
    X_mf[:, :10] = np.random.RandomState(3).randint(0, 3, (300, 10))
    X_mf[:, 1] = np.arange(300) % 150            # 150 states
    est = MultiSURF(n_features_to_select=10, discrete_limit=200).fit(X_mf,
                                                                     y_mf)
    cs.mesh_mixed_phase(CPU, MESH, X_mf, y_mf, est)
    X_snp, y_snp = cs.planted_genotypes(0, 64, 4096, 2)
    single = make().fit(X_snp, y_snp).feature_importances_
    cs.mesh_fit_phase(MESH, "mesh-snp", make, X_snp, y_snp, single,
                      (cs.feature_shard,
                       "feature_sharded_relief_discrete_scores"), "gemm",
                      cs.DISC_TOL, warm=0)
    X_v2, y_v2 = cs.planted_genotypes(2, 300, 64, 2)
    make_v2 = lambda: MultiSURF(n_features_to_select=3,  # noqa: E731
                                use_star=True)
    single = make_v2().fit(X_v2, y_v2).feature_importances_
    cs.mesh_fit_phase(MESH, "mesh-v2", make_v2, X_v2, y_v2, single,
                      (cs.psh, "_sharded_discrete_v2"), "gemm", cs.DISC_TOL,
                      warm=0)
    cs.mesh_fit_phase(MESH, "mesh-ring", make_v2, X_v2, y_v2, single,
                      (cs.parallel.ring, "_ring_skip_table"), "gemm",
                      (cs.fit_tol(single), 0.0), warm=0,
                      ring_bytes=X_v2.size - 1)
    res, _ = cs.mdr_k3_phase(CPU, n=600, p=12)
    cs.mesh_mdr_phase(CPU, MESH, res["X"], res["y"], res["planted"], res)
    cs.mesh_stats_phase(CPU, MESH, n=120, p=1100)
    launches = cs.mesh_procs_phase(
        CPU, {"X_n": X_n, "y_n": y_n, "X_mf": X_mf, "y_mf": y_mf,
              "X_snp": X_snp, "y_snp": y_snp, "X_v2": X_v2, "y_v2": y_v2,
              "X_k3": res["X"], "y_k3": res["y"]},
        stats_shape=(120, 1100), setup=W.rehearse_on_cpu)
    assert set(launches) == set(cs.KERNELS) and all(launches.values())
    assert not torch.distributed.is_initialized()
