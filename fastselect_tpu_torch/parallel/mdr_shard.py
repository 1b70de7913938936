"""Combo-sharded MDR scoring over a mesh of devices.

Counterpart of ``fastselect_tpu/parallel/mdr_shard.py``.  Combos are
independent, so the rank range of the C(p, k) search is split into
contiguous slices, one a shard; each device holds the genotypes and the
fold weights (one ``MDRFoldScorer`` a distinct device of this process),
and the shards' per-fold maxima are merged in ascending rank order.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.mdr_op import MDRFoldScorer, _comb_tables
from .sharded import (_gather_ranks, all_gather, distinct, home,
                      make_mesh)


class ShardedMDRFoldScorer:
    """All-folds MDR combo scorer with the combos sharded over a mesh.

    The genotypes and the folds' 0/1 weights are staged once a distinct
    device of this process (one
    :class:`~fastselect_tpu_torch.ops.mdr_op.MDRFoldScorer` each).
    :meth:`search` has ``MDRFoldScorer.search``'s contract and result:
    each chunk's ranks are split into contiguous slices of whole tiles,
    one a shard, and the per-fold (BA, key, rank) maxima merge in
    ascending rank order with strict ``>`` on the exact int64 key, so the
    first combo in lexicographic order wins ties, rank for rank and key
    for key as on one device.  The tiles and chunks come from the shape
    alone (``MDRFoldScorer.chunk_plan``), the same on every process.
    (JAX's sharded search compares an int32 key, exact below 65,536
    padded samples.)
    """

    def __init__(self, X, w_case, w_ctrl, k: int, *, devices=None):
        self.mesh = make_mesh(devices)
        self.k = int(k)
        self.scorers = {d: MDRFoldScorer(X, w_case, w_ctrl, k, device=d)
                        for d in distinct(self.mesh)}
        first = self.scorers[home(self.mesh)]
        self.n_folds, self.tc = first.n_folds, first.tc

    def __call__(self, combos) -> np.ndarray:
        """(F, m) balanced accuracies of one combo chunk (m, k), its rows
        split into contiguous slices over the shards."""
        combos = np.asarray(combos)
        step = -(-combos.shape[0] // len(self.mesh))
        parts = []
        for s in self.mesh.mine:
            sc = self.scorers[self.mesh[s]]
            part = combos[s * step:(s + 1) * step]
            parts.append(sc._score(sc._combos(part), self.tc)[0] if len(part)
                         else torch.empty((self.n_folds, 0), device=sc.device))
        return all_gather(parts, self.mesh, dim=1).cpu().numpy()

    def search(self, p: int, n_combos: int, chunk: int = 1 << 18):
        """Per-fold (best BA, best key, best rank) over ALL C(p, k) combos,
        host arrays; the host syncs once, at the end.

        Each process merges its own shards' maxima, chunk by chunk in
        ascending rank order; across processes the merged maxima are
        gathered, and the largest key wins, ties going to the smallest
        rank: the combo the one-process merge keeps."""
        mesh = self.mesh
        first = self.scorers[home(mesh)]
        tile, m = first.chunk_plan(n_combos, chunk)
        # whole tiles a shard
        step = tile * -(-(m // tile) // len(mesh))
        tables = {d: torch.from_numpy(_comb_tables(p, self.k)).to(d)
                  for d in self.scorers}
        dev0 = home(mesh)
        best_v = torch.zeros(self.n_folds, dtype=torch.float32, device=dev0)
        best_k = torch.full((self.n_folds,), -1, dtype=torch.int64,
                            device=dev0)
        best_r = torch.zeros_like(best_k)
        for r0 in range(0, n_combos, m):
            end = min(r0 + m, n_combos)
            for s in mesh.mine:
                d = mesh[s]
                s0 = r0 + s * step
                if s0 >= end:
                    break
                v, key, r = self.scorers[d]._best_in_range(
                    tables[d], s0, n_combos, tile, min(step, r0 + m - s0))
                v, key, r = (t.to(dev0, non_blocking=True)
                             for t in (v, key, r))
                upd = key > best_k
                best_v = torch.where(upd, v, best_v)
                best_k = torch.where(upd, key, best_k)
                best_r = torch.where(upd, r, best_r)
        if mesh.group is not None:
            best_v, best_k, best_r = _merge_ranks(best_v, best_k, best_r,
                                                  mesh)
        return (best_v.cpu().numpy().astype(np.float64),
                best_k.cpu().numpy(), best_r.cpu().numpy())


def _merge_ranks(best_v, best_k, best_r, mesh):
    """Every process's per-fold maxima gathered and merged: the largest
    key, ties to the smallest combo rank (a process with no combo holds
    key -1)."""
    v, key, r = (_gather_ranks(t, mesh.group)
                 for t in (best_v, best_k, best_r))
    out_v, out_k, out_r = v[0], key[0], r[0]
    for v2, k2, r2 in zip(v[1:], key[1:], r[1:]):
        upd = (k2 > out_k) | ((k2 == out_k) & (r2 < out_r))
        out_v = torch.where(upd, v2, out_v)
        out_k = torch.where(upd, k2, out_k)
        out_r = torch.where(upd, r2, out_r)
    return out_v, out_k, out_r


def sharded_batch_balanced_accuracy(X, y, combos, k: int, *,
                                    devices=None) -> np.ndarray:
    """Balanced accuracy of every combo's MDR model on (X, y), the combos
    sharded over the mesh."""
    y = np.asarray(y)
    scorer = ShardedMDRFoldScorer(X, (y == 1)[None], (y != 1)[None], k,
                                  devices=devices)
    return scorer(combos)[0]
