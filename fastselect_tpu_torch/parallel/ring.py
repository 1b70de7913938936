"""Ring-pass Relief scoring: the codes are never replicated, the sample
blocks go round the mesh.

Counterpart of ``fastselect_tpu/parallel/ring.py``.  The sample-shard
layout holds all the codes on every device; here each shard holds only its
own block of samples, and the blocks pass from shard to shard
(``ppermute``) so that every shard meets all of them: per device O(n p /
ndev + n^2 / ndev) instead of O(n p).

Two sweeps mirror the engine's two passes (a focal row's threshold needs
its whole distance row before any weight exists):

  sweep 1  ndev ring steps, each adding the exact match counts of the
           shard's focal block against the block in flight (int8 GEMMs)
           to its (nb, n_pad) match rows;
  weights  D = p_pad - match, then the (mask, coefficient) rules;
  sweep 2  ndev ring steps again, each contracting the mask columns of
           the block in flight against its one-hot states; the shards'
           partial scores are summed (psum).

When the class-sorted layout applies, a table built on the host from the
class segments (:func:`_ring_skip_table`) says which ring steps hold a
column that a rule group can select for a shard's rows; sweep 2 launches
nothing for the others.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import relief_discrete as rd
from ..ops.relief import pair_weight_rules
from ..utils.logging import phase
from .sharded import (_discrete_inputs, _round_up, _scalars, home,
                      make_mesh, plan_device, psum, replicate, ring_shift)


def _ring_rule_groups(algo, use_star, n_classes):
    """Rule-index groups sharing one j-support kind.

    'same' rules touch only j-columns of the focal row's own class,
    'other' rules only the remaining classes, ('cls', c) exactly class c
    (the rule-list positions mirror ``relief.pair_weight_rules``)."""
    if algo == "multisurf":
        return [("same", (0,)),
                ("other", (1, 2) if use_star else (1,))]
    if algo == "surf":
        return [("same", (1, 2) if use_star else (1,)),
                ("other", (0, 3) if use_star else (0,))]
    return ([("same", (0,))]
            + [(("cls", c), (1 + c,)) for c in range(n_classes)])


def _ring_skip_table(groups, segments, n, nb, ndev):
    """(n_groups, ndev, ndev) int8: does ring step ``owner``'s block hold
    any j-column that group ``g``'s rules can select for device ``me``'s
    focal rows?  Built host-side from the class-sorted segment bounds —
    zero entries let sweep 2 skip the whole contraction."""
    n_cls = len(segments)

    def seg_overlaps(seg_list, o):
        lo, hi = o * nb, (o + 1) * nb
        return any(s0 < hi and s0 + sl > lo for s0, sl in seg_list)

    cls_of_dev = []
    for d in range(ndev):
        lo, hi = d * nb, min((d + 1) * nb, n)
        cls_of_dev.append({c for c, (s0, sl) in enumerate(segments)
                           if s0 < hi and s0 + sl > lo})
    tbl = np.zeros((len(groups), ndev, ndev), np.int8)
    for g, (kind, _idxs) in enumerate(groups):
        for d in range(ndev):
            if kind == "same":
                sup = cls_of_dev[d]
            elif kind == "other":
                sup = set()
                for a in cls_of_dev[d]:
                    sup |= {c for c in range(n_cls) if c != a}
            else:
                sup = {kind[1]} if cls_of_dev[d] else set()
            segs_sup = [segments[c] for c in sup]
            for o in range(ndev):
                tbl[g, d, o] = seg_overlaps(segs_sup, o)
    return tbl


def ring_relief_discrete_scores(
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
    """All-discrete Relief scores with the sample blocks going round the
    mesh, divided by n.

    When the class-sorted v2 layout applies, the rows are sorted by class
    and sweep 2 skips every (rule group, shard, ring step) whose entry in
    :func:`_ring_skip_table` is 0: the ring's form of v2's segment
    restriction.  Across processes each holds its own shards' blocks, and
    a block passes to the next shard's process (``sharded.ring_shift``);
    ``nb`` and ``ft`` come from n, p, the mesh's length and its devices'
    type, so every process hands on blocks of one shape.  Sweep 1, the
    rules and sweep 2 are ``phase``s (``ring.sweep1``, ``ring.rules``,
    ``ring.sweep2``): logged at INFO, each timed between syncs at its
    edges.
    """
    mesh = make_mesh(devices)
    ndev = len(mesh)
    codes, n_states, cp = _discrete_inputs(codes, n_states, class_probs,
                                           mesh)
    n, p = codes.shape
    y = np.asarray(y)
    dev0 = home(mesh)
    _, ft = rd._discrete_tile_sizes(max(n // ndev, 1), p, n_states)
    ft = rd._gemm_size(ft, plan_device(mesh))
    # a block of samples a shard, padded as the GEMM takes it on the card
    nb = rd._gemm_size(_round_up(-(-n // ndev), 8), plan_device(mesh))
    n_pad = nb * ndev
    p_pad = _round_up(p, ft)

    layout = rd._v2_layout(y, n, 8, algo, class_probs)
    groups = skip = None
    if layout is not None:
        classes, perm, segments, _, _ = layout
        codes = codes[torch.as_tensor(perm, device=dev0)]
        y = y[perm]
        groups = _ring_rule_groups(algo, use_star, len(classes))
        skip = _ring_skip_table(groups, segments, n, nb, ndev)
    codes = torch.nn.functional.pad(codes, (0, p_pad - p, 0, n_pad - n))
    yv = torch.full((n_pad,), -1, dtype=torch.int64, device=dev0)
    yv[:n] = torch.as_tensor(y.astype(np.int64), device=dev0)
    valid = torch.zeros(n_pad, dtype=torch.float32, device=dev0)
    valid[:n] = 1.0
    # each of this process's shards its own block; labels and validity
    # (small) on each of its devices
    blocks = {s: codes[s * nb:(s + 1) * nb].to(mesh[s], non_blocking=True)
              for s in mesh.mine}
    labels = {d: (yd, valid.to(d, non_blocking=True),
                  *_scalars(n, cp, d))
              for d, yd in replicate(yv, mesh).items()}

    def ring(step_fn):
        """Runs ``step_fn(me, owner, block in flight)`` for each ring step
        and shard of this process: at step t shard me holds the block of
        shard me - t, passed on from shard me - 1."""
        held = dict(blocks)
        for t in range(ndev):
            for me in held:
                step_fn(me, (me - t) % ndev, held[me])
            if t + 1 < ndev:
                held = ring_shift(held, mesh)

    # sweep 1: every shard's match rows against all samples
    match = {s: torch.empty((nb, n_pad), dtype=torch.int32, device=mesh[s])
             for s in blocks}

    def sweep1(me, owner, blk):
        match[me][:, owner * nb:(owner + 1) * nb] = rd._match_rows(
            blocks[me], blk, ft, n_states)

    with phase("ring.sweep1", work=float(n_pad) * n_pad * p_pad):
        ring(sweep1)
    rules = {}
    with phase("ring.rules"):
        for me in blocks:
            d = mesh[me]
            y_all, v_all, n_real, cpd = labels[d]
            rows = slice(me * nb, (me + 1) * nb)
            D = (p_pad - match[me]).to(torch.float32)
            match[me] = None
            rules[me] = pair_weight_rules(
                D, y_all[rows], v_all[rows],
                torch.arange(me * nb, (me + 1) * nb, device=d), y_all,
                v_all, n_real, cpd, algo=algo, use_star=use_star,
                k=int(n_neighbors))
            del D

    # sweep 2: contract the in-flight block's mask columns
    parts = {s: torch.zeros(p_pad, dtype=torch.float64, device=mesh[s])
             for s in blocks}
    n_rules = len(next(iter(rules.values())))
    rule_groups = groups or [(None, tuple(range(n_rules)))]

    def sweep2(me, owner, blk):
        cols = slice(owner * nb, (owner + 1) * nb)
        for g, (_kind, idxs) in enumerate(rule_groups):
            if skip is not None and not skip[g, me, owner]:
                continue
            sub = [(rules[me][i][0][:, cols], rules[me][i][1]) for i in idxs]
            parts[me] += rd._accumulate_discrete(blocks[me], blk, sub, ft,
                                                 n_states)

    with phase("ring.sweep2", work=float(n_pad) * n_pad * p_pad):
        ring(sweep2)
    scores = psum([parts[s] for s in sorted(parts)], mesh)
    return (scores[:p].to(torch.float32) / float(n)).cpu().numpy()
