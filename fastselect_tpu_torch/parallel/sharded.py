"""Sample-shard Relief scoring over a mesh of devices.

Counterpart of ``fastselect_tpu/parallel/sharded.py``.  The focal-sample
axis is split into contiguous shards, one a device of the mesh; every
shard scores its focal rows against all samples, which every device holds,
and the per-feature partial scores are summed.

JAX's mesh is one controller over one host's devices (``shard_map``).
Here a mesh is an ordered tuple of ``torch.device``s driven by one
process, and the collectives are plain tensor code:

  psum        the shards' partials moved to the first device and added in
              mesh order, so a given mesh gives the same bits on every run;
  all_gather  (tiled) a ``torch.cat`` in mesh order;
  ppermute    ``.to(next shard's device, non_blocking=True)``, which does
              nothing between shards on one device.

A device may appear in a mesh more than once: several shards then run on
it one after the other.  Operands every shard reads (X, codes, labels)
are staged once per distinct device.  The host issues every shard's work
and merges once, with no host sync between shards, so that shards on
different GPUs can overlap (unmeasured: the port has been run on one GPU).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import relief_cuda as rc
from ..ops import relief_discrete as rd
from ..ops.relief import relief_engine_core


def make_mesh(devices=None) -> tuple:
    """1-D mesh: an ordered tuple of ``torch.device``s, by default every
    visible CUDA device (none without one).  A device may repeat."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    mesh = tuple(torch.device(d) for d in devices)
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    return mesh


def distinct(mesh) -> list:
    """The mesh's devices, each once, in mesh order."""
    return list(dict.fromkeys(mesh))


def replicate(tensor: torch.Tensor, mesh) -> dict:
    """``{device: tensor on it}`` for every distinct device of the mesh,
    copied from the tensor's own device (no copy there)."""
    return {d: tensor.to(d, non_blocking=True) for d in distinct(mesh)}


def psum(parts, mesh) -> torch.Tensor:
    """Sum of the shards' partials on the mesh's first device, added in
    mesh order."""
    total = parts[0].to(mesh[0], non_blocking=True)
    for part in parts[1:]:
        total = total + part.to(mesh[0], non_blocking=True)
    return total


def all_gather(parts, mesh) -> torch.Tensor:
    """The shards' parts concatenated in mesh order on the first device."""
    return torch.cat([p.to(mesh[0], non_blocking=True) for p in parts])


def ppermute(tensor: torch.Tensor, device: torch.device) -> torch.Tensor:
    """One ring step: the tensor on the next shard's device."""
    return tensor.to(device, non_blocking=True)


def _round_up(v: int, m: int) -> int:
    return ((v + m - 1) // m) * m


def sharded_relief_scores(
    x,
    y,
    recip,
    is_discrete,
    *,
    algo: str = "multisurf",
    use_star: bool = False,
    n_neighbors: int = 0,
    class_probs: np.ndarray | None = None,
    devices=None,
) -> np.ndarray:
    """Relief-family scores of any data, the focal rows sharded over the
    mesh, divided by n.

    The fused engine's operands (``relief_cuda.stage_fused``) are staged
    on the mesh's first device and copied to each other distinct device;
    the samples pad to ``TILE_ROWS`` rows a shard, so each shard holds a
    whole number of the kernels' 16-byte rows.  Each shard runs
    ``relief_engine_core`` over its contiguous focal rows, in blocks sized
    from its device's free memory: the hand-written kernels on a CUDA
    device, their plain versions on the CPU (the ``MIXED`` kernels when a
    column is discrete).
    """
    mesh = make_mesh(devices)
    ndev = len(mesh)
    if not isinstance(x, torch.Tensor):
        x = torch.tensor(np.asarray(x), dtype=torch.float32)
    n, p = x.shape
    disc = np.asarray(torch.as_tensor(is_discrete).cpu(), bool)
    plan = rc.block_plan(n, p, mesh[0], algo, n_disc=int(disc.sum()))
    n_pad = _round_up(n, rc.TILE_ROWS * ndev)
    nf = n_pad // ndev
    first = rc.stage_fused(x, y, recip, disc, class_probs, mesh[0], n_pad,
                           plan.p_pad)
    staged = {d: first.to(d) for d in distinct(mesh)}
    per_pair = (rc._RELIEFF_BYTES_PER_PAIR if algo == "relieff"
                else rc._BYTES_PER_PAIR)
    nb = {d: rc._focal_block_rows(n_pad, rc.TILE_ROWS,
                                  rc._block_budget_bytes(d), per_pair,
                                  n_focal=nf)
          for d in staged}
    parts = []
    for s, d in enumerate(mesh):
        fl = staged[d]
        rows = slice(s * nf, (s + 1) * nf)
        parts.append(relief_engine_core(
            fl.xp[rows], fl.yv[rows], fl.valid[rows], s * nf, fl.xp, fl.yv,
            fl.valid, fl.recip, fl.disc, fl.n_real, fl.class_probs,
            algo=algo, use_star=use_star, k=int(n_neighbors), nb=nb[d],
            n_disc=fl.n_disc))
    scores = psum(parts, mesh)
    return (scores.index_select(0, first.pos) / first.n_real).cpu().numpy()


def sharded_multisurf_scores(x, y, recip, is_discrete, *, devices=None,
                             use_star: bool = False) -> np.ndarray:
    """Sample-shard MultiSURF scores."""
    return sharded_relief_scores(x, y, recip, is_discrete, algo="multisurf",
                                 use_star=use_star, devices=devices)


def _discrete_inputs(codes, n_states, class_probs, mesh):
    """(int8 codes on the first device, n_states, class_probs) of a
    discrete layout."""
    codes, n_states = rd.int8_codes(codes, n_states, mesh[0])
    if class_probs is None:
        class_probs = np.zeros((1,), np.float32)
    return codes, n_states, np.asarray(class_probs, np.float32)


def _scalars(n, class_probs, device):
    """n_real and class_probs as the weight rules take them."""
    return (torch.tensor(float(n), dtype=torch.float32, device=device),
            torch.as_tensor(class_probs, device=device))


def _sharded_discrete_v2(codes, y, layout, n, p, n_states, class_probs,
                         mesh, *, algo, use_star, k, ti, ft):
    """Class-sorted v2 over the mesh: (p_pad,) float64 unnormalised scores.

    The focal blocks of the sorted layout keep their per-class plans
    (``relief_discrete._plan_segments``), so every shard runs the
    segment-restricted pass 2.  The blocks of each plan group are dealt to
    the shards round-robin; block order does not matter, since partials
    add.  (JAX pads the deal with weight-0 blocks to keep one traced
    program for every device; a loop needs none.)"""
    classes, perm, segments, block_class, n_pad = layout
    p_pad = rd._round_up(p, ft)
    cpad, yv, valid = rd._apply_layout(codes, y[:n], perm, n_pad, p_pad)
    cls_t = tuple(int(c) for c in classes)
    plan_of = {pos: rd._plan_segments(algo, use_star, cls_t, pos)
               for pos in set(block_class)}
    groups: dict = {}
    for b, pos in enumerate(block_class):
        key = tuple((spec, tuple(segs)) for spec, segs in plan_of[pos])
        groups.setdefault(key, []).append(b)
    dealt = [[] for _ in mesh]
    for blocks in groups.values():
        for i, b in enumerate(blocks):
            dealt[i % len(mesh)].append(b)
    segs_all = list(segments) + [(0, n_pad)]
    ops = {d: (c, yv.to(d, non_blocking=True), valid.to(d, non_blocking=True),
               *_scalars(n, class_probs, d))
           for d, c in replicate(cpad, mesh).items()}
    parts = []
    for s, d in enumerate(mesh):
        c, yd, vd, n_real, cp = ops[d]
        total = torch.zeros(p_pad, dtype=torch.float64, device=d)
        for b in dealt[s]:
            rows = slice(b * ti, (b + 1) * ti)
            total += rd._block_scores_v2(
                c[rows], yd[rows], vd[rows],
                torch.arange(b * ti, (b + 1) * ti, device=d), c, yd, vd,
                n_real, cp, algo=algo, use_star=use_star, k=k, ft=ft,
                n_states=n_states, plan=plan_of[block_class[b]],
                segs_all=segs_all)
        parts.append(total)
    return psum(parts, mesh)


def sharded_relief_discrete_scores(
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
    """All-discrete Relief scores, the focal rows sharded over the mesh,
    divided by n.

    Codes (array or tensor) are staged once a distinct device.  When the
    class-sorted v2 layout applies (``relief_discrete._v2_layout``) its
    blocks are dealt to the shards (:func:`_sharded_discrete_v2`);
    otherwise each shard runs ``relief_discrete_core`` over its contiguous
    focal rows.  Both are int8 GEMMs on every device.
    """
    mesh = make_mesh(devices)
    ndev = len(mesh)
    codes, n_states, cp = _discrete_inputs(codes, n_states, class_probs,
                                           mesh)
    n, p = codes.shape
    y = np.asarray(y)
    ti0, _ = rd._discrete_tile_sizes(n, p, n_states)
    # a focal block divides each shard's rows
    ti = min(ti0, max(8, rd._round_up(n // ndev or 1, 8)))
    layout, ti, ft = rd._tiles_and_layout(n, p, n_states, y, algo,
                                          class_probs, mesh[0], ti)
    if layout is not None:
        scores = _sharded_discrete_v2(
            codes, y, layout, n, p, n_states, cp, mesh, algo=algo,
            use_star=use_star, k=int(n_neighbors), ti=ti, ft=ft)
    else:
        cpad, yv, valid, _ = rd.pack_discrete(codes, y, n_states, ti=ti,
                                              ft=ft)
        n_pad = _round_up(cpad.shape[0], ti * ndev)
        if n_pad > cpad.shape[0]:
            extra = n_pad - cpad.shape[0]
            cpad = torch.nn.functional.pad(cpad, (0, 0, 0, extra))
            yv = torch.nn.functional.pad(yv, (0, extra), value=-1)
            valid = torch.nn.functional.pad(valid, (0, extra))
        nf = n_pad // ndev
        ops = {d: (c, yv.to(d, non_blocking=True),
                   valid.to(d, non_blocking=True), *_scalars(n, cp, d))
               for d, c in replicate(cpad, mesh).items()}
        parts = []
        for s, d in enumerate(mesh):
            c, yd, vd, n_real, cpd = ops[d]
            rows = slice(s * nf, (s + 1) * nf)
            parts.append(rd.relief_discrete_core(
                c[rows], yd[rows], vd[rows], s * nf, c, yd, vd, n_real, cpd,
                algo=algo, use_star=use_star, k=int(n_neighbors), ti=ti,
                ft=ft, n_states=n_states))
        scores = psum(parts, mesh)
    return (scores[:p].to(torch.float32) / float(n)).cpu().numpy()
