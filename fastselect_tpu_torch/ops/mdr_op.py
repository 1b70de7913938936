"""Balanced-accuracy scoring of k-locus MDR models on exact int8 GEMMs.

Counterpart of ``fastselect_tpu/ops/mdr_op.py``.  Every C(p, k) genotype
combination is scored by the balanced accuracy of its 3^k-cell
case/control table (reference ``MDR.py:20-129``).  The JAX package builds
a tile's tables with float32 one-hot einsums; here they are products of
0/1 int8 matrices on ``torch._int_mm`` through ``relief_discrete._dot_t``
(counted in ``relief_discrete.gemm_ops``), so the counts are exact int32
at any n:

  staging   genotypes as (p, n_pad) int8 rows, samples padded with -1 to
            a multiple of 8 (``contingency.stage_codes``), and the folds'
            0/1 sample weights as (32, n_pad) int8 rows, case then control
            per fold (2F rounded up to 8, and to the GEMM's 32 rows);
  a tile    the k rows of each of tc combos gathered and folded into
            int16 base-3 cells (tc, n_pad): a padded sample's cell is
            -(3^k - 1) / 2, never a real one;
            their one-hot (3^k * tc, n_pad), cell-major with samples
            contiguous; the weights times its transpose: (32, 3^k * tc)
            int32 case and control counts of every fold.  (On an H100,
            ``tools/mdr_tile_ab.py``: the one-hot as A and the weights as
            a 16-column B took 1.07 ms where this takes 0.65, and a
            combo-major one-hot, one broadcast ``torch.eq``, 2.8 ms.)

The epilogue turns the counts into balanced accuracies with the JAX
package's float32 expressions, so the high-risk cells are JAX's, and into
the exact selection key ``tp*N + tn*P`` in int64 (JAX's is int32 and
exact only below 65,536 padded samples).  A shape the GEMM refuses
raises; :func:`mdr_tables_ref` (bincount) is the plain version of the
tables for the tests and ``chip_smoke.py`` only.
"""

from __future__ import annotations

from functools import lru_cache
from math import comb

import numpy as np
import torch

from ..utils.backend import default_device, resolve_backend
from .contingency import stage_codes
from .relief_discrete import _dot_t

# one int8 one-hot tile (tc * 3^k, n_pad), and one float32 (F, tc, 3^k)
# epilogue tensor: an H100 has 80 GB, so a tile is sized by the one-hot's
# bytes (JAX's 48 MB float32 budget fits a 16 GB chip)
_ONEHOT_BYTES = 1 << 30
_TABLE_BYTES = 256 << 20
# tiles hold multiples of 32 combos; the GEMM's A (the fold weights) has
# at least 32 rows, more than the 16 it needs
_MIN_TILE = 32
_ALIGN = 8


def _round_up(v: int, m: int) -> int:
    return ((v + m - 1) // m) * m


@lru_cache(maxsize=32)
def _comb_cache(p: int, r: int) -> np.ndarray:
    """comb(v, r) for v in 0..p, exact int64."""
    vals = [comb(v, r) for v in range(p + 1)]
    if vals[-1] >= (1 << 62):  # pragma: no cover - absurd search size
        raise OverflowError(f"C({p},{r}) exceeds int64")
    return np.asarray(vals, np.int64)


def unrank_combos(p: int, k: int, r0: int, r1: int) -> np.ndarray:
    """Rows r0..r1 (exclusive) of ``itertools.combinations(range(p), k)``
    in lexicographic order, computed arithmetically with vectorised
    binomial unranking — no per-combo Python.

    Position i holds the smallest x > prev with
    ``comb(p-prev-1, k-i) - comb(p-x-1, k-i) > rank_remaining`` — found
    for the whole chunk at once with a searchsorted over the monotone
    comb(v, k-i) table (hockey-stick identity for the cumulative count).
    """
    m = r1 - r0
    out = np.empty((m, k), np.int32)
    rem = np.arange(r0, r1, dtype=np.int64)
    prev = np.full((m,), -1, np.int64)
    for i in range(k):
        cb = _comb_cache(p, k - i)
        top = cb[p - prev - 1]          # combos left in this suffix block
        A = top - rem                   # pick largest v with cb[v] < A
        v = np.searchsorted(cb, A, side="left") - 1
        x = p - v - 1
        rem -= top - cb[v + 1]
        out[:, i] = x
        prev = x
    return out


def _comb_tables(p: int, k: int) -> np.ndarray:
    """(k, p+1) binomial tables for device-side unranking: row i holds
    comb(v, k-i) for v in 0..p."""
    return np.stack([_comb_cache(p, k - i) for i in range(k)])


def _unrank_device(ranks: torch.Tensor, tables: torch.Tensor, *,
                   k: int) -> torch.Tensor:
    """Device twin of :func:`unrank_combos`: (m, k) lexicographic
    combination rows of int64 ranks, by searchsorted over the int64
    binomial tables on the ranks' device."""
    p = tables.shape[1] - 1
    rem = ranks
    prev = torch.full_like(ranks, -1)
    cols = []
    for i in range(k):
        cb = tables[i]
        top = cb[p - prev - 1]
        v = torch.searchsorted(cb, top - rem, right=False) - 1
        x = p - v - 1
        rem = rem - (top - cb[v + 1])
        cols.append(x)
        prev = x
    return torch.stack(cols, dim=1)


def _tile_combos(n_pad: int, k: int, n_folds: int) -> int:
    """Combos a tile holds: its int8 one-hot within _ONEHOT_BYTES and an
    (F, tc, 3^k) float32 epilogue tensor within _TABLE_BYTES, a multiple
    of 32 (k = 6's 729 cells shrink it 81-fold from k = 2's 9)."""
    cells = 3 ** k
    t = min(_ONEHOT_BYTES // (cells * n_pad),
            _TABLE_BYTES // (4 * n_folds * cells))
    return max(_MIN_TILE, t // _MIN_TILE * _MIN_TILE)


def _check_weights(w_case, w_ctrl) -> tuple[np.ndarray, np.ndarray]:
    """Per-fold sample weights as (F, n) 0/1 int8; any other value
    raises."""
    out = []
    for w in (w_case, w_ctrl):
        w = np.atleast_2d(np.asarray(w))
        if not np.isin(w, (0, 1)).all():
            raise ValueError("MDR's fold weights must be 0 or 1.")
        out.append(w.astype(np.int8))
    if out[0].shape != out[1].shape:
        raise ValueError("w_case and w_ctrl must have the same shape.")
    return out[0], out[1]


def _ba_and_key(case: torch.Tensor, ctrl: torch.Tensor, P: torch.Tensor,
                N: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Balanced accuracy (float32) and exact selection key (int64) of
    integer case/control tables (F, tc, cells), with the fold totals P
    and N (F,) int64.

    The float32 expressions are ``_mdr_chunk_ba_folds``' (JAX
    ``:137-147``), so the high-risk cells are JAX's; JAX's float32 sums
    of counts are exact integers below 2^24 samples, so they are taken
    here as integer sums cast to float32.  Within a fold P and N are the
    same for every combo, so ``BA = (tp/P + tn/N) / 2`` is ordered exactly
    by ``tp*N + tn*P``; in int64 it is exact at any n."""
    total_case = case.sum(-1, dtype=torch.int64)
    total_ctrl = ctrl.sum(-1, dtype=torch.int64)
    ok = (total_case > 0) & (total_ctrl > 0)
    case_t, ctrl_t = total_case.to(torch.float32), total_ctrl.to(
        torch.float32)
    thr = case_t / torch.clamp_min(ctrl_t, 1.0)
    high = (ctrl == 0) | (case.to(torch.float32) / torch.clamp_min(
        ctrl.to(torch.float32), 1e-30) > thr[..., None])
    tp = torch.where(high, case, 0).sum(-1, dtype=torch.int64)
    tn = total_ctrl - torch.where(high, ctrl, 0).sum(-1, dtype=torch.int64)
    sens = tp.to(torch.float32) / torch.clamp_min(case_t, 1.0)
    spec = tn.to(torch.float32) / torch.clamp_min(ctrl_t, 1.0)
    ba = torch.where(ok, (sens + spec) / 2.0, 0.0)
    key = tp * N[:, None] + tn * P[:, None]
    return ba, torch.where(ok, key, 0)


class MDRFoldScorer:
    """Stages the genotypes and every fold's 0/1 case and control weights
    on the device ONCE and scores combos for every fold at once —
    chunk-outer, fold-inner, one GEMM a tile of combos.

    ``device=None`` is the card where there is one, else the CPU."""

    def __init__(self, X, w_case, w_ctrl, k: int, device=None):
        if device is None:
            device = default_device(resolve_backend("auto"))
        self.device = torch.device(device)
        self.k = int(k)
        self.n_cells = 3 ** self.k
        w_case, w_ctrl = _check_weights(w_case, w_ctrl)
        n, p = np.shape(X)
        self.n_folds = f = w_case.shape[0]
        self.xt = stage_codes(np.asarray(X), 3, self.device)  # (p, n_pad)
        self.n_pad = n_pad = self.xt.shape[1]
        # the cells' base-3 digits, pre-scaled: row j * p + c of ``scaled``
        # is column c times 3^(k-1-j) (padding: -3^(k-1-j))
        powers = [3 ** (self.k - 1 - j) for j in range(self.k)]
        x16 = self.xt.to(torch.int16)
        self.scaled = torch.cat([x16 * pw for pw in powers])
        self.offsets = torch.arange(self.k, device=self.device) * p
        # the GEMM's A: case then control rows of each fold, at least 32
        wt = np.zeros((max(_round_up(2 * f, _ALIGN), _MIN_TILE), n_pad),
                      np.int8)
        wt[:f, :n] = w_case
        wt[f:2 * f, :n] = w_ctrl
        self.wt = torch.from_numpy(wt).to(self.device)
        self.P = torch.from_numpy(w_case.sum(1, dtype=np.int64)).to(
            self.device)
        self.N = torch.from_numpy(w_ctrl.sum(1, dtype=np.int64)).to(
            self.device)
        self.tc = _tile_combos(n_pad, self.k, f)

    def _combos(self, combos) -> torch.Tensor:
        c = combos if isinstance(combos, torch.Tensor) else \
            torch.from_numpy(np.asarray(combos))
        return c.to(self.device, torch.int64).reshape(-1, self.k)

    def _tile_tables(self, combos: torch.Tensor) -> torch.Tensor:
        """(2, F, tc, 3^k) int32 case and control counts of one tile of
        combos (tc, k) int64 on the device: one int8 GEMM, the weights'
        rows times the one-hot's.  The one-hot is cell-major, row
        ``cell * tc + combo`` (N = 3^k * tc, rounded up to 8), so each cell's
        rows are one contiguous ``torch.eq`` against a contiguous input,
        which runs vectorised; the counts come back as a view."""
        tc, cells, f = combos.shape[0], self.n_cells, self.n_folds
        cells_t = self.scaled[combos + self.offsets].sum(
            dim=1, dtype=torch.int16)                     # (tc, n_pad)
        rows = _round_up(cells * tc, _ALIGN)
        alloc = torch.zeros if rows > cells * tc else torch.empty
        hot = alloc((rows, self.n_pad), dtype=torch.bool, device=self.device)
        hot3 = hot[:cells * tc].view(cells, tc, self.n_pad)
        for cell in range(cells):
            torch.eq(cells_t, cell, out=hot3[cell])
        counts = _dot_t(self.wt, hot.view(torch.int8))
        return counts[:2 * f, :cells * tc].view(2, f, cells, tc).transpose(
            2, 3)

    def tables(self, combos) -> torch.Tensor:
        """(2, F, m, 3^k) int32 case ([0]) and control ([1]) counts of every
        fold for m combos (host array or tensor, (m, k)), on the device."""
        c = self._combos(combos)
        return torch.cat([self._tile_tables(c[t0:t0 + self.tc])
                          for t0 in range(0, c.shape[0], self.tc)], dim=2)

    def _score(self, combos: torch.Tensor, tile: int):
        """(F, m) float32 balanced accuracies and int64 keys of combos on
        the device, ``tile`` combos a GEMM."""
        m = combos.shape[0]
        ba = torch.empty((self.n_folds, m), dtype=torch.float32,
                         device=self.device)
        key = torch.empty((self.n_folds, m), dtype=torch.int64,
                          device=self.device)
        for t0 in range(0, m, tile):
            t = self._tile_tables(combos[t0:t0 + tile])
            ba[:, t0:t0 + tile], key[:, t0:t0 + tile] = _ba_and_key(
                t[0], t[1], self.P, self.N)
        return ba, key

    def scores(self, combos) -> tuple[np.ndarray, np.ndarray]:
        """(F, m) float32 balanced accuracies and int64 selection keys of
        one host combo chunk."""
        ba, key = self._score(self._combos(combos), self.tc)
        return ba.cpu().numpy(), key.cpu().numpy()

    def __call__(self, combos) -> np.ndarray:
        """(F, m) balanced accuracies for one combo chunk."""
        return self.scores(combos)[0]

    def chunk_plan(self, n_combos: int, chunk: int = 1 << 18):
        """(combos a tile, combos a chunk) of a search over n_combos: the
        chunk a whole number of tiles, neither larger than the search
        needs."""
        want = min(chunk, max(n_combos, 1))
        tile = min(self.tc, _round_up(want, _MIN_TILE))
        return tile, _round_up(want, tile)

    def chunk_ranks(self, r0: int, m: int, n_combos: int) -> torch.Tensor:
        """Ranks r0..r0+m on the device, a padded tail clamped to the last
        combo: the offset is clamped before r0 is added."""
        offs = torch.arange(m, dtype=torch.int64, device=self.device)
        return r0 + torch.clamp_max(offs, n_combos - 1 - r0)

    def _best_in_range(self, tables, r0: int, n_combos: int, tile: int,
                       m: int):
        """Per-fold (BA, key, rank) of the first maximum key over the ranks
        [r0, r0 + m), on the device.  A padded tail repeats the last combo:
        its key can only tie the real one, and argmax keeps the first."""
        ranks = self.chunk_ranks(r0, m, n_combos)
        ba, key = self._score(_unrank_device(ranks, tables, k=self.k), tile)
        idx = torch.argmax(key, dim=1, keepdim=True)
        return (ba.gather(1, idx)[:, 0], key.gather(1, idx)[:, 0],
                ranks[idx[:, 0]])

    def search(self, p: int, n_combos: int, chunk: int = 1 << 18):
        """Per-fold (best BA, best key, best rank) over ALL C(p, k) combos,
        host arrays.  Combos are unranked on the device, chunk maxima are
        merged there with strict ``>`` on the key in ascending rank order
        (the first combo in lexicographic order wins ties), and the host
        syncs once, at the end."""
        tile, m = self.chunk_plan(n_combos, chunk)
        tables = torch.from_numpy(_comb_tables(p, self.k)).to(self.device)
        best_v = torch.zeros(self.n_folds, dtype=torch.float32,
                             device=self.device)
        best_k = torch.full((self.n_folds,), -1, dtype=torch.int64,
                            device=self.device)
        best_r = torch.zeros_like(best_k)
        for r0 in range(0, n_combos, m):
            v, key, r = self._best_in_range(tables, r0, n_combos, tile, m)
            upd = key > best_k
            best_v = torch.where(upd, v, best_v)
            best_k = torch.where(upd, key, best_k)
            best_r = torch.where(upd, r, best_r)
        return (best_v.cpu().numpy().astype(np.float64),
                best_k.cpu().numpy(), best_r.cpu().numpy())


def mdr_tables_ref(X, w_case, w_ctrl, combos, k: int,
                   device=None) -> torch.Tensor:
    """Plain version of :meth:`MDRFoldScorer.tables`: (2, F, m, 3^k) int64
    counts from one ``bincount`` of ``combo * 3^k + cell`` per fold and
    class over the samples it weighs, no one-hot and no GEMM (the tests'
    and ``chip_smoke.py``'s referee)."""
    w_case, w_ctrl = _check_weights(w_case, w_ctrl)
    device = torch.device(device or "cpu")
    x, c = (a if isinstance(a, torch.Tensor) else
            torch.from_numpy(np.asarray(a)) for a in (X, combos))
    x, c = x.to(device, torch.int64), c.to(device, torch.int64)
    m, cells = c.shape[0], 3 ** k
    cell = torch.zeros((m, x.shape[0]), dtype=torch.int64, device=device)
    for j in range(k):
        cell = cell * 3 + x[:, c[:, j]].t()
    cell += (torch.arange(m, device=device) * cells)[:, None]
    out = torch.empty((2, w_case.shape[0], m, cells), dtype=torch.int64,
                      device=device)
    for side, w in enumerate((w_case, w_ctrl)):
        for f in range(w.shape[0]):
            idx = torch.from_numpy(np.flatnonzero(w[f])).to(device)
            out[side, f] = torch.bincount(
                cell[:, idx].reshape(-1), minlength=m * cells).view(m, cells)
    return out


def batch_balanced_accuracy(X, y, combos, k: int,
                            device=None) -> np.ndarray:
    """Balanced accuracy of every combo's MDR model on (X, y)."""
    y = np.asarray(y)
    scorer = MDRFoldScorer(X, (y == 1)[None], (y != 1)[None], k,
                           device=device)
    return scorer(combos)[0]
