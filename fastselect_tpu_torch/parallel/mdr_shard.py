"""Combo-sharded MDR scoring over a mesh of devices.

Counterpart of ``fastselect_tpu/parallel/mdr_shard.py``.  Combos are
independent, so the rank range of the C(p, k) search is split into
contiguous slices, one a shard; each device holds the genotypes and the
fold weights (one ``MDRFoldScorer`` a distinct device), and the shards'
per-fold maxima are merged in ascending rank order.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.mdr_op import MDRFoldScorer, _comb_tables
from .sharded import distinct, make_mesh


class ShardedMDRFoldScorer:
    """All-folds MDR combo scorer with the combos sharded over a mesh.

    The genotypes and the folds' 0/1 weights are staged once a distinct
    device (one :class:`~fastselect_tpu_torch.ops.mdr_op.MDRFoldScorer`
    each).  :meth:`search` has ``MDRFoldScorer.search``'s contract and
    result: each chunk's ranks are split into contiguous slices of whole
    tiles, one a shard, and the per-fold (BA, key, rank) maxima merge on
    the first device in ascending rank order with strict ``>`` on the
    exact int64 key, so the first combo in lexicographic order wins ties,
    rank for rank and key for key as on one device.  (JAX's sharded search
    compares an int32 key, exact below 65,536 padded samples.)
    """

    def __init__(self, X, w_case, w_ctrl, k: int, *, devices=None):
        self.mesh = make_mesh(devices)
        self.k = int(k)
        self.scorers = {d: MDRFoldScorer(X, w_case, w_ctrl, k, device=d)
                        for d in distinct(self.mesh)}
        first = self.scorers[self.mesh[0]]
        self.n_folds, self.tc = first.n_folds, first.tc

    def __call__(self, combos) -> np.ndarray:
        """(F, m) balanced accuracies of one combo chunk (m, k), its rows
        split into contiguous slices over the shards."""
        combos = np.asarray(combos)
        step = -(-combos.shape[0] // len(self.mesh))
        parts = [self.scorers[d]._score(self.scorers[d]._combos(
            combos[s * step:(s + 1) * step]), self.tc)[0]
            for s, d in enumerate(self.mesh) if s * step < len(combos)]
        return torch.cat([p.to(self.mesh[0], non_blocking=True)
                          for p in parts], dim=1).cpu().numpy()

    def search(self, p: int, n_combos: int, chunk: int = 1 << 18):
        """Per-fold (best BA, best key, best rank) over ALL C(p, k) combos,
        host arrays; the host syncs once, at the end."""
        first = self.scorers[self.mesh[0]]
        tile, m = first.chunk_plan(n_combos, chunk)
        # whole tiles a shard
        step = tile * -(-(m // tile) // len(self.mesh))
        tables = {d: torch.from_numpy(_comb_tables(p, self.k)).to(d)
                  for d in self.scorers}
        dev0 = self.mesh[0]
        best_v = torch.zeros(self.n_folds, dtype=torch.float32, device=dev0)
        best_k = torch.full((self.n_folds,), -1, dtype=torch.int64,
                            device=dev0)
        best_r = torch.zeros_like(best_k)
        for r0 in range(0, n_combos, m):
            end = min(r0 + m, n_combos)
            for s, d in enumerate(self.mesh):
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
        return (best_v.cpu().numpy().astype(np.float64),
                best_k.cpu().numpy(), best_r.cpu().numpy())


def sharded_batch_balanced_accuracy(X, y, combos, k: int, *,
                                    devices=None) -> np.ndarray:
    """Balanced accuracy of every combo's MDR model on (X, y), the combos
    sharded over the mesh."""
    y = np.asarray(y)
    scorer = ShardedMDRFoldScorer(X, (y == 1)[None], (y != 1)[None], k,
                                  devices=devices)
    return scorer(combos)[0]
