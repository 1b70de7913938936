"""The layouts of ``fastselect_tpu_torch.parallel`` as cases that a group of
processes runs, for ``tests/test_torch_multiprocess.py``.

This module imports the port and never JAX or the JAX package: the
processes of a group import it (``chip_smoke.run_processes`` unpickles
:func:`group_worker` from here), and each reports what it imported.  Every
case builds its inputs from its own seed with numpy, so the group's
processes, the parent's one-process mesh and the parent's JAX side all see
the same arrays (:func:`inputs`).
"""

from __future__ import annotations

import contextlib
import math
import sys
from itertools import combinations

import numpy as np
import torch

import fastselect_tpu_torch.models.mdr as TM
import fastselect_tpu_torch.ops.relief as TR
import fastselect_tpu_torch.ops.relief_discrete as TRD
import fastselect_tpu_torch.parallel as TP
import fastselect_tpu_torch.parallel.feature_shard as TFS
import fastselect_tpu_torch.parallel.ring as TRING
import fastselect_tpu_torch.parallel.sharded as TSH
from fastselect_tpu_torch import MDR, MultiSURF, _build
from fastselect_tpu_torch.ops import contingency as ct
from fastselect_tpu_torch.ops import relief_cuda as rc
from fastselect_tpu_torch.parallel import distributed
from fastselect_tpu_torch.utils.preprocessing import (
    compute_recip_ranges, detect_discrete_features)

CPU = torch.device("cpu")

# layout cases: every rank's result is held to the one-process mesh of the
# same shards bit for bit, and to JAX's layout
LAYOUTS = ("fused-cont", "fused-mixed", "discrete-v1", "discrete-v2",
           "ring", "ring-skip", "feature-v1", "feature-v2", "mi", "su",
           "staged", "chi2", "mdr-scores", "mdr-search", "mdr-tie")
# the estimators' automatic routes under a group
AUTO = ("auto-multisurf", "auto-ring", "auto-feature", "auto-mdr",
        "auto-pairwise")
# the routes given other data on rank 1 than on the other ranks
MISMATCH = ("mismatch-multisurf", "mismatch-mdr", "mismatch-pairwise",
            "mismatch-staged")


@contextlib.contextmanager
def patched(*settings):
    """(module, name, value) settings for the block."""
    saved = [(m, n, getattr(m, n)) for m, n, _ in settings]
    for m, n, v in settings:
        setattr(m, n, v)
    try:
        yield
    finally:
        for m, n, v in reversed(saved):
            setattr(m, n, v)


def _cp(y, n_classes=2):
    return (np.bincount(y, minlength=n_classes) / len(y)).astype(np.float32)


def inputs(name):
    """The case's arrays and keyword arguments, from its own seed."""
    rng = np.random.RandomState(LAYOUTS.index(name) if name in LAYOUTS
                                else 100 + AUTO.index(name))
    if name.startswith("fused"):
        X = rng.rand(48, 20).astype(np.float32)
        y = rng.randint(0, 2, 48).astype(np.int32)
        kw = dict(algo="multisurf")
        if name == "fused-mixed":
            X[:, 1] = rng.randint(0, 3, 48)
            X[:, 4] = rng.randint(0, 4, 48)
            kw = dict(algo="relieff", n_neighbors=3, class_probs=_cp(y))
        recip = compute_recip_ranges(torch.from_numpy(X)).numpy()
        disc = detect_discrete_features(torch.from_numpy(X), 10).numpy()
        return (X, y, recip, disc), kw
    if name in ("discrete-v1", "discrete-v2", "ring", "ring-skip"):
        n, p = {"discrete-v1": (48, 21), "discrete-v2": (72, 26)}.get(
            name, (52, 19))
        codes = rng.randint(0, 3, (n, p)).astype(np.int8)
        y = rng.randint(0, 2, n).astype(np.int32)
        kw = {"discrete-v2": dict(algo="multisurf", use_star=True),
              "ring-skip": dict(algo="relieff", n_neighbors=3,
                                class_probs=_cp(y))}.get(
            name, dict(algo="multisurf"))
        return (codes, y), dict(kw, n_states=3)
    if name.startswith("feature"):
        n, p, c = (30, 70, 2) if name == "feature-v1" else (44, 90, 3)
        codes = rng.randint(0, 3, (n, p)).astype(np.int8)
        y = rng.randint(0, c, n).astype(np.int32)
        kw = (dict(algo="multisurf") if name == "feature-v1"
              else dict(algo="surf", use_star=True))
        return (codes, y), dict(kw, n_states=3)
    if name in ("mi", "su"):
        return (rng.randint(0, 4, (90, 130)).astype(np.int32),), {}
    if name == "staged":
        return (rng.randint(0, 3, (50, 200)), rng.randint(0, 2, 50)), {}
    if name == "chi2":
        return (rng.randint(0, 6, (80, 37)).astype(np.float64),
                rng.randint(0, 3, 80)), {}
    if name == "mdr-scores":
        X = rng.randint(0, 3, (60, 10)).astype(np.int32)
        y = rng.randint(0, 2, 60)
        return (X, y, np.array(list(combinations(range(10), 2)),
                               np.int32)), {}
    if name in ("mdr-search", "mdr-tie"):
        if name == "mdr-tie":
            base = np.random.RandomState(5).randint(0, 3, (40, 4))
            X = np.hstack([base, base, base])    # 12 columns, 3 copies
            y = ((base[:, 0] + base[:, 1]) % 3 == 0).astype(int)
            n_folds, k = 2, 2
        else:
            X = rng.randint(0, 3, (60, 11))
            y = rng.randint(0, 2, 60)
            n_folds, k = 3, 3
        n = len(y)
        w_case = np.stack([(y == 1) & (np.arange(n) % n_folds != f)
                           for f in range(n_folds)])
        w_ctrl = np.stack([(y != 1) & (np.arange(n) % n_folds != f)
                           for f in range(n_folds)])
        return (X, w_case, w_ctrl, k), {}
    if name in ("auto-multisurf", "auto-ring"):
        X = rng.randint(0, 3, (160, 64)).astype(np.float64) \
            if name == "auto-ring" else rng.rand(160, 64)
        return (X, rng.randint(0, 2, 160)), {}
    if name == "auto-feature":
        return (rng.randint(0, 3, (130, 4200)).astype(np.float64),
                rng.randint(0, 2, 130)), {}
    if name == "auto-mdr":
        X = rng.randint(0, 3, (300, 9))
        return (X, ((X[:, 2] + X[:, 5]) % 3 == 0).astype(int)), {}
    if name == "auto-pairwise":
        return (rng.randint(0, 3, (40, 1030)).astype(np.int32),), {}
    raise KeyError(name)


def _spy(module, name, calls):
    orig = getattr(module, name)

    def wrapper(*a, **k):
        calls.append(name)
        return orig(*a, **k)

    return module, name, wrapper


def run_case(name, devices):
    """The case's result on ``devices`` (a mesh, or a list of devices for
    one process).  Auto cases fit through the estimators' routes: with
    ``devices`` None under a group the route finds the group's mesh,
    otherwise ``ops.relief._mesh_devices`` is set to ``devices``; their
    result is (scores or selection, the layout functions they reached)."""
    args, kw = inputs(name)
    force_v2 = ((TRD, "_V2_MIN_N", 16),) if name in (
        "discrete-v2", "ring-skip", "feature-v2") else ()
    with patched(*force_v2):
        if name.startswith("fused"):
            return TP.sharded_relief_scores(*args, devices=devices, **kw)
        if name.startswith("discrete"):
            return TP.sharded_relief_discrete_scores(*args, devices=devices,
                                                     **kw)
        if name.startswith("ring"):
            return TP.ring_relief_discrete_scores(*args, devices=devices,
                                                  **kw)
        if name.startswith("feature"):
            return TP.feature_sharded_relief_discrete_scores(
                *args, devices=devices, **kw)
    if name in ("mi", "su"):
        return TFS.sharded_pairwise_stat_matrix(args[0], 4, name,
                                                devices=devices, tile=32)
    if name == "staged":
        X, y = args
        with patched((ct, "_ONEHOT_BYTES", 56 * 32 * 2),
                     (TR, "_mesh_devices", lambda device: devices)):
            staged = ct.StagedColumnStats(X, 3)
            cols = [staged.column(j, "su") for j in (0, 7, 199)]
            return np.stack(cols + [staged.stats_vs(y, 2, "mi")])
    if name == "chi2":
        return TP.sharded_chi2_stats(*args, 3, devices=devices)
    if name == "mdr-scores":
        return TP.sharded_batch_balanced_accuracy(*args, 2, devices=devices)
    if name in ("mdr-search", "mdr-tie"):
        X, w_case, w_ctrl, k = args
        p = X.shape[1]
        return TP.ShardedMDRFoldScorer(X, w_case, w_ctrl, k,
                                       devices=devices).search(
            p, math.comb(p, k), chunk=32)
    return _run_auto(name, args, devices)


def _run_auto(name, args, devices):
    calls = []
    routes = {"auto-multisurf": (TSH, "sharded_relief_scores"),
              "auto-ring": (TRING, "ring_relief_discrete_scores"),
              "auto-feature": (TFS, "feature_sharded_relief_discrete_scores"),
              "auto-mdr": (TM, "ShardedMDRFoldScorer"),
              "auto-pairwise": (TFS, "sharded_pairwise_stat_matrix")}
    settings = [_spy(*routes[name], calls),
                (TR, "_AUTO_SHARD_MIN_ELEMS", 5000)]
    if devices is not None:
        settings.append((TR, "_mesh_devices", lambda device: devices))
    if name == "auto-ring":
        settings.append((TR, "_RING_BYTES", 1000))
    if name == "auto-mdr":
        settings.append((TM, "_COMBO_CHUNK", 32))
    with patched(*settings):
        if name == "auto-mdr":
            est = MDR(k=2, cv=3, backend="cpu").fit(*args)
            out = (np.array(est._fold_best), np.array(
                est.best_interaction_), est.best_mean_testing_ba_)
        elif name == "auto-pairwise":
            out = ct.pairwise_stat_matrix(args[0], 3, "mi", device=CPU)
        else:
            est = MultiSURF(backend="cpu").fit(*args)
            out = (est.feature_importances_, est.top_features_)
    return out, calls


def group_worker(names, ranks=None):
    """One process of a group: each case on the group's mesh (``ranks``:
    the rank of each shard, every shard this host's CPU; default: the
    group's own mesh, ``make_mesh()``), then what the process saw."""
    torch.set_num_threads(1)
    mesh = TP.make_mesh(None if ranks is None
                        else [(r, CPU) for r in ranks])
    TSH.reset_comm()
    out = {}
    for name in names:
        if name in MISMATCH:
            out[name] = mismatch_case(name)
        else:
            out[name] = run_case(name, None if name in AUTO else mesh)
    budget = rc._block_budget_bytes(CPU, TSH.sharers(mesh, CPU))
    return {"results": out, "rank": torch.distributed.get_rank(),
            "mesh": [str(d) for d in mesh], "ranks": list(mesh.ranks),
            "sharers": TSH.sharers(mesh, CPU), "budget": budget,
            "comm": dict(TSH.comm),
            "imports": [m for m in ("jax", "fastselect_tpu")
                        if m in sys.modules]}


def mismatch_case(name):
    """The error a route raises under the group when rank 1's y (or X)
    differs from the other ranks', as the group's mesh is taken (None: no
    error)."""
    rng = np.random.RandomState(200 + MISMATCH.index(name))
    other = torch.distributed.get_rank() == 1
    try:
        with patched((TR, "_AUTO_SHARD_MIN_ELEMS", 5000)):
            if name == "mismatch-multisurf":
                X, y = rng.rand(200, 40), rng.randint(0, 2, 200)
                MultiSURF(backend="cpu").fit(X, 1 - y if other else y)
            elif name == "mismatch-mdr":
                X, y = rng.randint(0, 3, (120, 6)), rng.randint(0, 2, 120)
                MDR(k=2, cv=3, backend="cpu").fit(X, 1 - y if other else y)
            elif name == "mismatch-pairwise":
                X = rng.randint(0, 3, (40, 1100)).astype(np.int8)
                ct.pairwise_stat_matrix((X + other) % 3, 3, "mi", device=CPU)
            else:
                X = rng.randint(0, 3, (60, 30)).astype(np.int8)
                y = rng.randint(0, 2, 60)
                ct.StagedColumnStats(X, 3).stats_vs(1 - y if other else y,
                                                    2, "mi")
    except ValueError as e:
        return str(e)
    return None


def raising_worker():
    """A process that fails on rank 1."""
    if torch.distributed.get_rank() == 1:
        raise RuntimeError("rank 1 fails on purpose")
    return distributed.local_devices()


def hanging_worker():
    """A deadlock: rank 0 waits in a collective that rank 1 never joins."""
    if torch.distributed.get_rank() == 0:
        torch.distributed.all_reduce(torch.ones(1))
    else:
        import time
        time.sleep(3600)


def rehearse_on_cpu():
    """chip_smoke.py's phase 23 in a CPU process, set as
    ``tests/test_torch_chip_mesh.py`` sets its phase 21: the plain passes
    counted as the kernels' launches, the auto-route's size gate lowered,
    the class-sorted layouts from 16 samples, MDR in chunks of 64, one
    thread."""
    torch.set_num_threads(1)
    TR._AUTO_SHARD_MIN_ELEMS = 1000
    TRD._V2_MIN_N = 16
    TM._COMBO_CHUNK = 64
    for pass_no, name in ((1, "dist_matrix"), (2, "accumulate")):
        orig = getattr(rc, name)

        def counted(*a, _orig=orig, _pass=pass_no, **k):
            kind = "mixed" if k["mixed"] else "cont"
            _build.launches[f"relief_pass{_pass}_{kind}"] += 1
            return _orig(*a, **k)
        setattr(rc, name, counted)
