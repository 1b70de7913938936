"""Feature-sharded layouts: the p >> n (GWAS) Relief layout, pair tiles of
the MI/SU matrix, and chi2.

Counterpart of ``fastselect_tpu/parallel/feature_shard.py``.  For Relief
each shard holds the int8 codes of its own slice of the features and
counts the sample pairs' matches over them; the int32 counts add exactly
(psum), so every device sees the whole (n, n) match matrix.  The weight
rules then run once a distinct device on the full distances, a focal block
at a time, and pass 2 is local to each shard: its feature scores are
final, and the score vector is their concatenation in mesh order
(all_gather).

Per device: the codes of its features, the (n, n) match and weight
arrays; between devices: one (n, n) int32 sum and the (p,) scores.  JAX
packs each shard's codes into 2-bit planes for its chip's link; here each
shard's int8 slice is copied as it is (no bit-packing, by design).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops import contingency as ct
from ..ops import relief_discrete as rd
from ..ops.chi2_op import chi2_device
from ..ops.relief import pair_weight_rules
from .sharded import (_discrete_inputs, _round_up, _scalars, all_gather,
                      distinct, home, make_mesh, merge_disjoint, plan_device,
                      psum)


def feature_sharded_relief_discrete_scores(
    codes,
    y,
    *,
    algo: str = "multisurf",
    use_star: bool = False,
    n_neighbors: int = 0,
    n_states: int | None = None,
    class_probs: np.ndarray | None = None,
    devices=None,
) -> np.ndarray:
    """All-discrete Relief scores with the feature axis sharded over the
    mesh, divided by n.

    When the class-sorted v2 layout applies, the rows are sorted by class
    (feature scores do not depend on the row order) and pass 2 contracts
    each focal block's rules only over their class segments
    (``relief_discrete._accumulate_plan``), as on one device; otherwise
    over all samples (``_accumulate_discrete``).  The weight rules and
    pass 2 run a focal block at a time either way, on the one-device
    engine's blocks, and pass 2's block partials are summed in float64.
    Across processes each runs its own shards: the int32 match counts add
    by all_reduce, and the scores are gathered.
    """
    mesh = make_mesh(devices)
    ndev = len(mesh)
    codes, n_states, cp = _discrete_inputs(codes, n_states, class_probs,
                                           mesh)
    n, p = codes.shape
    y = np.asarray(y)
    dev0 = home(mesh)
    pb0 = max(-(-p // ndev), 1)
    layout, ti, ft = rd._tiles_and_layout(n, pb0, n_states, y, algo,
                                          class_probs, plan_device(mesh))
    if layout is not None:
        classes, perm, segments, block_class, n_pad = layout
        codes = codes[torch.as_tensor(perm, device=dev0)]
        y = y[perm]
        cls_t = tuple(int(c) for c in classes)
        plans = [rd._plan_segments(algo, use_star, cls_t, pos)
                 for pos in block_class]
        segs_all = list(segments) + [(0, n_pad)]
    else:
        n_pad = _round_up(n, ti)
    # equal ft-aligned feature slices, one a shard; padded features hold
    # state 0 on every row, so they always match and score 0
    pb = _round_up(pb0, ft)
    p_pad = pb * ndev
    if (n_pad, p_pad) != (n, p):
        codes = torch.nn.functional.pad(codes, (0, p_pad - p, 0, n_pad - n))
    yv = torch.full((n_pad,), -1, dtype=torch.int64, device=dev0)
    yv[:n] = torch.as_tensor(y.astype(np.int64), device=dev0)
    valid = torch.zeros(n_pad, dtype=torch.float32, device=dev0)
    valid[:n] = 1.0
    shards = [codes[:, s * pb:(s + 1) * pb].to(mesh[s], non_blocking=True)
              for s in mesh.mine]

    # pass 1: partial match counts over each shard's features, summed
    match = psum([rd._match_rows(c, c, ft, n_states) for c in shards], mesh)
    ops = {d: ((p_pad - match.to(d, non_blocking=True)).to(torch.float32),
               yv.to(d, non_blocking=True), valid.to(d, non_blocking=True),
               *_scalars(n, cp, d))
           for d in distinct(mesh)}
    del match
    # a focal block at a time: the rules once a distinct device on the
    # block's rows of the full distances, then pass 2 local to each shard
    exact = algo == "surf" and ti * n_pad < 2 ** 31
    parts = [torch.zeros(pb, dtype=torch.float64, device=c.device)
             for c in shards]
    for b, i0 in enumerate(range(0, n_pad, ti)):
        rows = slice(i0, i0 + ti)
        rules = {d: pair_weight_rules(
            D[rows], yd[rows], vd[rows],
            torch.arange(i0, i0 + ti, device=d), yd, vd, n_real, cpd,
            algo=algo, use_star=use_star, k=int(n_neighbors))
            for d, (D, yd, vd, n_real, cpd) in ops.items()}
        for part, c in zip(parts, shards):
            if layout is None:
                part += rd._accumulate_discrete(c[rows], c, rules[c.device],
                                                ft, n_states, exact_int=exact)
            else:
                part += rd._accumulate_plan(c[rows], c, rules[c.device],
                                            plans[b], segs_all, ft, n_states,
                                            use_star)
    scores = all_gather(parts, mesh)
    return (scores[:p].to(torch.float32) / float(n)).cpu().numpy()


def sharded_pairwise_stat_matrix(
    X_enc,
    s: int,
    stat: str,
    *,
    devices=None,
    log_base: float = math.log(2.0),
    tile: int | None = None,
) -> np.ndarray:
    """(p, p) pairwise 'mi' or 'su' matrix, host float64, with the
    feature-pair tiles' block rows dealt over the mesh: each tile row of
    the matrix (a tile of features against all features) is computed on
    one device, which holds every feature's codes.  Across processes each
    computes the tile rows of its own shards, and the rows are merged
    exactly (``sharded.merge_disjoint``).

    The tiles, their operands and their statistic are those of
    ``contingency.pairwise_stat_matrix(..., symmetric=False)``, so every
    entry equals it bit for bit (each entry comes from its own exact
    integer table)."""
    mesh = make_mesh(devices)
    xt = ct.stage_codes(X_enc, s, home(mesh))
    R = ct._pair_blocks(xt, X_enc.shape[0], s, stat, log_base, upper=False,
                        tile=tile, mesh=mesh)
    return merge_disjoint(R, mesh).cpu().numpy().astype(np.float64)


def sharded_chi2_stats(x, y_mapped, n_classes: int, *,
                       devices=None) -> np.ndarray:
    """chi2 statistics (host float64) with the feature axis sharded over
    the mesh: features are independent, so each shard computes its slice
    (``chi2_op.chi2_device``) and the slices are concatenated."""
    mesh = make_mesh(devices)
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    x = x.to(home(mesh))
    pb = -(-x.shape[1] // len(mesh))
    parts = [chi2_device(x[:, s * pb:(s + 1) * pb].to(mesh[s],
                                                        non_blocking=True),
                         y_mapped, n_classes)
             for s in mesh.mine]
    return all_gather(parts, mesh).cpu().numpy()
