"""Contingency-table statistics on exact int8 one-hot GEMMs.

Counterpart of ``fastselect_tpu/ops/contingency.py``.  A joint count table
of two discrete columns is a product of their one-hot encodings,

    counts[a, b] = sum_i 1[u_i = a] * 1[v_i = b] = onehot(U) @ onehot(V).T,

batched over features (relevance vectors) and over feature-pair tiles
(redundancy and r_ff matrices).  The JAX package takes bf16 one-hots with
float32 accumulation, exact below 2^24 samples.  Here the one-hots are
int8 and every product goes to ``torch._int_mm`` through
``relief_discrete._dot_t`` (counted in ``relief_discrete.gemm_ops``), so
the counts are exact int32 at any n.  The statistics are float32, as the
JAX package's f32 tables feed them.

Layout: codes are staged once as (p, n_pad), one feature a row, samples
contiguous and padded with -1 to a multiple of 8, so a padded sample is an
all-zero one-hot column and weighs nothing.  A one-hot is (F * S, n_pad),
feature-major (row f * S + c is ``1[codes[f] == first + c]``); both GEMM
operands take that layout, A row-major and B column-major, as
``torch._int_mm`` wants them on CUDA.  Its other rules (A with more than
16 rows, N a multiple of 8) are met by all-zero padding rows, on every
device, so the CPU tests run the card's shapes.  A shape the GEMM refuses
raises: there is no float fallback.

At s >= 3 states the pair and column builders contract states 1.. only
and recover state 0's row and column from the per-feature marginals, in
int32 with the real n, as the JAX package does in f32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import relief as _relief
from .relief_discrete import _dot_t, _round_up

_EPS = 1e-12
# torch._int_mm on CUDA: A needs more than 16 rows, K and N multiples of 8
_MIN_ROWS = 32
_ALIGN = 8
# one int8 one-hot operand, and one (ti, tj, s, s) float32 table block
_ONEHOT_BYTES = 1 << 30
_TABLE_BYTES = 256 << 20
_PAIR_TILE_MAX = 1024


def _codes_dtype(s: int) -> torch.dtype:
    """int8 codes where s states fit beside the -1 padding, else int32."""
    return torch.int8 if s <= 127 else torch.int32


def _scalar(v, device) -> torch.Tensor:
    """A float32 0-dim tensor on ``device``: ``tables / n`` then divides on
    the device (a host scalar divisor becomes a reciprocal multiply on
    CUDA)."""
    return torch.tensor(float(v), dtype=torch.float32, device=device)


def _inv_log(log_base: float) -> float:
    """1 / log_base rounded as XLA rounds its rewrite of ``x / log_base``
    into ``x * (1 / log_base)`` in float32."""
    return float(np.float32(1.0) / np.float32(log_base))


# ---------------------------------------------------------------------------
# Statistics from count tables
# ---------------------------------------------------------------------------

def mi_from_tables(tables: torch.Tensor, n: torch.Tensor,
                   log_base: float) -> torch.Tensor:
    """MI per table over the last two axes, reference
    ``mutual_information.py:25-46`` semantics: terms where p_xy > 1e-12,
    denominator p_x*p_y + 1e-12, divided by log_base."""
    p_xy = tables / n
    p_x = p_xy.sum(dim=-1, keepdim=True)
    p_y = p_xy.sum(dim=-2, keepdim=True)
    ratio = p_xy / (p_x * p_y + _EPS)
    terms = torch.where(p_xy > _EPS,
                        p_xy * torch.log(torch.clamp_min(ratio, _EPS)), 0.0)
    return terms.sum(dim=(-2, -1)) * _inv_log(log_base)


def su_from_tables(tables: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Symmetrical uncertainty per table (reference ``CFS.py:44-77``):
    MI in bits with the CFS variant's guards (p_xy, p_x, p_y all > eps),
    normalised by the marginal entropies."""
    p_xy = tables / n
    p_x = p_xy.sum(dim=-1)
    p_y = p_xy.sum(dim=-2)
    h_x = torch.where(p_x > _EPS, -p_x * torch.log2(torch.clamp_min(
        p_x, _EPS)), 0.0).sum(dim=-1)
    h_y = torch.where(p_y > _EPS, -p_y * torch.log2(torch.clamp_min(
        p_y, _EPS)), 0.0).sum(dim=-1)
    denom_ok = (h_x + h_y) > _EPS
    px_b = p_x[..., :, None]
    py_b = p_y[..., None, :]
    valid = (p_xy > _EPS) & (px_b > _EPS) & (py_b > _EPS)
    ratio = p_xy / torch.clamp_min(px_b * py_b, _EPS)
    mi = torch.where(valid, p_xy * torch.log2(torch.clamp_min(ratio, _EPS)),
                     0.0).sum(dim=(-2, -1))
    return torch.where(denom_ok,
                       2.0 * mi / torch.where(denom_ok, h_x + h_y, 1.0), 0.0)


def entropy_from_counts(counts: torch.Tensor) -> torch.Tensor:
    """Shannon entropy (bits) from count vectors along the last axis
    (reference ``CFS.py:26-41``)."""
    n = counts.sum(dim=-1, keepdim=True)
    prob = counts / torch.clamp_min(n, 1.0)
    terms = torch.where(prob > _EPS,
                        -prob * torch.log2(torch.clamp_min(prob, _EPS)), 0.0)
    return terms.sum(dim=-1)


def tables_stat(tables: torch.Tensor, n: int, stat: str,
                log_base: float = math.log(2.0)) -> torch.Tensor:
    """The statistic ('mi' or 'su') of integer count tables, float32 on
    their device."""
    t = tables.to(torch.float32)
    n_real = _scalar(n, t.device)
    if stat == "mi":
        return mi_from_tables(t, n_real, log_base)
    if stat == "su":
        return su_from_tables(t, n_real)
    raise ValueError(f"stat must be 'mi' or 'su', got {stat!r}")


# ---------------------------------------------------------------------------
# Staging and one-hots
# ---------------------------------------------------------------------------

def stage_codes(X_enc, s: int, device=None) -> torch.Tensor:
    """Codes (n, p) as a (p, n_pad) tensor on ``device``: one feature a
    row, samples padded with -1 to a multiple of 8, int8 where s allows
    (4x less to copy), else int32."""
    dtype = _codes_dtype(s)
    if isinstance(X_enc, torch.Tensor):
        x = X_enc.to(device=device or X_enc.device, dtype=dtype)
    else:
        x = torch.from_numpy(np.asarray(X_enc).astype(
            np.int8 if dtype == torch.int8 else np.int32, copy=False))
        x = x.to(device or "cpu")
    n, p = x.shape
    xt = torch.full((p, _round_up(max(n, 1), _ALIGN)), -1, dtype=dtype,
                    device=x.device)
    xt[:, :n] = x.t()
    return xt


def _onehot_rows(codes_t: torch.Tensor, n_states: int, first: int = 0,
                 rows: int | None = None) -> torch.Tensor:
    """(F, n_pad) codes -> (rows, n_pad) int8 one-hot, row f * S + c being
    ``1[codes_t[f] == first + c]`` for S = n_states; rows past F * S are
    all zero."""
    f, n_pad = codes_t.shape
    rows = max(rows or 0, f * n_states)
    hot = torch.zeros((rows, n_pad), dtype=torch.bool, device=codes_t.device)
    if f * n_states:
        states = torch.arange(first, first + n_states, dtype=codes_t.dtype,
                              device=codes_t.device)
        torch.eq(codes_t[:, None, :], states[None, :, None],
                 out=hot[:f * n_states].view(f, n_states, n_pad))
    return hot.view(torch.int8)


def _b_rows(v: int) -> int:
    """Rows of a B operand: its product's N, a multiple of 8."""
    return _round_up(max(v, 1), _ALIGN)


def _marginals(onehot: torch.Tensor, f: int, n_states: int) -> torch.Tensor:
    """Per-feature counts (f, S) of the states in a one-hot's first f * S
    rows, int32."""
    return onehot[:f * n_states].view(f, n_states, -1).sum(
        dim=-1, dtype=torch.int32)


def _assemble(sub, m_row, m_col, n):
    """(..., s_x, s_y) int32 tables from the state-0-dropped counts ``sub``
    (..., s_x-1, s_y-1) and the marginals of states 1.. of each side,
    broadcast against sub's leading axes: ``m_row`` (..., s_x-1) and
    ``m_col`` (..., s_y-1).  Exact integer arithmetic with the real n."""
    lead = sub.shape[:-2]
    sx, sy = sub.shape[-2] + 1, sub.shape[-1] + 1
    out = torch.empty(lead + (sx, sy), dtype=torch.int32, device=sub.device)
    out[..., 1:, 1:] = sub
    out[..., 0, 1:] = m_col - sub.sum(dim=-2, dtype=torch.int32)
    out[..., 1:, 0] = m_row - sub.sum(dim=-1, dtype=torch.int32)
    out[..., 0, 0] = (n - m_row.sum(dim=-1, dtype=torch.int32)
                      - m_col.sum(dim=-1, dtype=torch.int32)
                      + sub.sum(dim=(-2, -1), dtype=torch.int32))
    return out


# ---------------------------------------------------------------------------
# Feature-against-vector tables
# ---------------------------------------------------------------------------

def _vector_tile(n_pad: int, p: int, s_x: int) -> int:
    """Features a (tile * s_x, n_pad) one-hot holds within _ONEHOT_BYTES, a
    multiple of 32."""
    t = _ONEHOT_BYTES // max(n_pad * s_x, 1)
    return max(_MIN_ROWS, min(_round_up(p, _MIN_ROWS), t // 32 * 32))


def _vs_tables(xt: torch.Tensor, v: torch.Tensor, s_x: int,
               s_v: int) -> torch.Tensor:
    """(p, s_x, s_v) int32 tables of every staged feature against the
    staged vector v (n_pad,), full one-hots, one GEMM a feature tile."""
    p, n_pad = xt.shape
    tile = _vector_tile(n_pad, p, s_x)
    b = _onehot_rows(v[None, :], s_v, rows=_b_rows(s_v))
    out = torch.empty((p, s_x, s_v), dtype=torch.int32, device=xt.device)
    for t0 in range(0, p, tile):
        f = min(tile, p - t0)
        a = _onehot_rows(xt[t0:t0 + f], s_x, rows=max(f * s_x, _MIN_ROWS))
        out[t0:t0 + f] = _dot_t(a, b)[:f * s_x, :s_v].view(f, s_x, s_v)
    return out


def _stage_vector(v, n_pad: int, device) -> torch.Tensor:
    """1-D codes as an int32 (n_pad,) tensor on ``device``, padded with
    -1."""
    v = torch.as_tensor(v if isinstance(v, torch.Tensor) else np.asarray(v))
    v = v.to(device=device, dtype=torch.int32).reshape(-1)
    out = torch.full((n_pad,), -1, dtype=torch.int32, device=device)
    out[:v.shape[0]] = v
    return out


def staged_target_tables(xt: torch.Tensor, y_enc, s_x: int,
                         s_y: int) -> torch.Tensor:
    """(p, s_x, s_y) int32 tables of every feature of the codes staged by
    :func:`stage_codes` against the target codes y (host array or
    tensor)."""
    return _vs_tables(xt, _stage_vector(y_enc, xt.shape[1], xt.device),
                      s_x, s_y)


def feature_target_tables(X_enc, y_enc, s_x: int, s_y: int,
                          device=None) -> torch.Tensor:
    """Joint count tables of each feature vs the target, (p, s_x, s_y)
    int32 on ``device``."""
    return staged_target_tables(stage_codes(X_enc, s_x, device), y_enc,
                                s_x, s_y)


def _int64(a, device) -> torch.Tensor:
    """Codes as int64 on ``device`` (default: a tensor's own, else the
    CPU)."""
    t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
    return t.to(device or t.device, torch.int64)


def feature_target_tables_ref(X_enc, y_enc, s_x: int, s_y: int,
                              device=None) -> torch.Tensor:
    """Plain version of :func:`feature_target_tables`: one
    ``bincount(u * s_y + v)`` with an offset per column, no one-hot and no
    GEMM (the tests' and ``chip_smoke.py``'s referee)."""
    x = _int64(X_enc, device)
    y = _int64(y_enc, x.device)
    if x.dim() == 1:
        x = x[:, None]
    p = x.shape[1]
    cell = s_x * s_y
    key = x * s_y + y[:, None] + torch.arange(p, device=x.device) * cell
    counts = torch.bincount(key.reshape(-1), minlength=p * cell)
    return counts.view(p, s_x, s_y).to(torch.int32)


# ---------------------------------------------------------------------------
# Pair tables
# ---------------------------------------------------------------------------

class _PairOperand:
    """One feature tile's GEMM operand: its (tile * S, n_pad) one-hot (S =
    s, or s - 1 with state 0 dropped at s >= 3) and, at s >= 3, its
    marginals of states 1.. (tile, s - 1)."""

    def __init__(self, codes_t: torch.Tensor, s: int, tile: int):
        self.f = codes_t.shape[0]
        self.tile = tile
        self.drop = s >= 3
        width = s - 1 if self.drop else s
        self.onehot = _onehot_rows(codes_t, width, first=int(self.drop),
                                   rows=tile * width)
        self.marg = (_marginals(self.onehot, tile, width) if self.drop
                     else None)


def pair_tables(Xi: torch.Tensor, Xj: torch.Tensor, n_real: int, *,
                s: int) -> torch.Tensor:
    """(ti, tj, s, s) int32 joint count tables of every pair of the staged
    feature tiles Xi (ti, n_pad) and Xj (tj, n_pad): the ONE builder behind
    the pairwise statistic matrices.

    Below 3 states both one-hots are full; from 3 states on, state 0 is
    dropped from both and its row and column recovered from the
    marginals (the contraction shrinks by (s-1)^2/s^2)."""
    ti, tj = Xi.shape[0], Xj.shape[0]
    a = _PairOperand(Xi, s, _round_up(max(ti, tj), _MIN_ROWS))
    b = a if Xj is Xi else _PairOperand(Xj, s, a.tile)
    return _pair_block(a, b, n_real, s)[:ti, :tj]


def _pair_block(a: _PairOperand, b: _PairOperand, n_real: int,
                s: int) -> torch.Tensor:
    """(a.tile, b.tile, s, s) int32 tables of two tile operands."""
    t = a.tile
    w = s - 1 if a.drop else s
    c = _dot_t(a.onehot, b.onehot).view(t, w, t, w).permute(0, 2, 1, 3)
    if not a.drop:
        return c.contiguous()
    return _assemble(c, a.marg[:, None, :], b.marg[None, :, :], n_real)


def pair_tables_ref(Xi, Xj, *, s: int, device=None) -> torch.Tensor:
    """Plain version of :func:`pair_tables` on (n, ti) and (n, tj) codes:
    ``bincount(u * s + v)`` with an offset per pair, a few rows of pairs at
    a time, no one-hot and no GEMM."""
    xi = _int64(Xi, device)
    xj = _int64(Xj, xi.device)
    n, ti = xi.shape
    tj = xj.shape[1]
    out = torch.empty((ti, tj, s, s), dtype=torch.int32, device=xi.device)
    cell = s * s
    rows = max(1, (64 << 20) // max(n * tj, 1))
    offs = torch.arange(tj, device=xi.device) * cell
    for r0 in range(0, ti, rows):
        r = min(rows, ti - r0)
        key = (xi[:, r0:r0 + r, None] * s + xj[:, None, :]
               + (torch.arange(r, device=xi.device)[:, None] * (tj * cell)
                  + offs[None, :]))
        counts = torch.bincount(key.reshape(-1), minlength=r * tj * cell)
        out[r0:r0 + r] = counts.view(r, tj, s, s)
    return out


def pair_tile(n: int, p: int, s: int) -> int:
    """Features a pair-matrix tile holds: a multiple of 32, at most 1024,
    with a (tile, tile, s, s) float32 table block within _TABLE_BYTES and
    a one-hot operand within _ONEHOT_BYTES."""
    n_pad = _round_up(max(n, 1), _ALIGN)
    by_table = math.isqrt(_TABLE_BYTES // (4 * s * s))
    by_onehot = _ONEHOT_BYTES // max(n_pad * s, 1)
    t = min(_PAIR_TILE_MAX, by_table, by_onehot) // 32 * 32
    return max(_MIN_ROWS, min(t, _round_up(p, _MIN_ROWS)))




def _pair_blocks(xt: torch.Tensor, n: int, s: int, stat: str,
                 log_base: float, *, upper: bool = True,
                 tile: int | None = None, mesh=None) -> torch.Tensor:
    """(p, p) float32 statistic of the feature pairs of the staged codes,
    on their device, one GEMM a pair of tiles: the blocks on and above the
    diagonal (``upper``), else all of them.  Every entry comes from its
    own table, so the tile size changes no entry.  A mesh
    (``parallel.sharded.Mesh``) deals the tile rows round-robin over its
    shards, each device holding all the codes; a block is computed there
    as it would be on xt's device.  Only this process's shards compute:
    the tile rows of another process's stay zero here."""
    from ..parallel.sharded import distinct, make_mesh
    p = xt.shape[0]
    tile = tile or pair_tile(n, p, s)
    nt = -(-p // tile)
    mesh = mesh or make_mesh([xt.device])
    codes = {d: xt.to(d, non_blocking=True) for d in distinct(mesh)}

    def operand(t, d):
        return _PairOperand(codes[d][t * tile:(t + 1) * tile], s, tile)

    R = torch.zeros((p, p), dtype=torch.float32, device=xt.device)
    for ti in range(nt):
        if ti % len(mesh) not in mesh.mine:
            continue
        dev = mesh[ti % len(mesh)]
        a = operand(ti, dev)
        for tj in range(ti if upper else 0, nt):
            b = a if tj == ti else operand(tj, dev)
            blk = tables_stat(_pair_block(a, b, n, s), n, stat, log_base)
            i0, j0 = ti * tile, tj * tile
            R[i0:i0 + a.f, j0:j0 + b.f] = blk[:a.f, :b.f]
    return R


def _mirror(R: torch.Tensor) -> torch.Tensor:
    """The strict upper triangle mirrored, zero diagonal: stat(i, j) ==
    stat(j, i) bit for bit (the reference computes each pair once)."""
    U = R.triu(1)
    return U + U.t()


def staged_stat_matrix(xt: torch.Tensor, n: int, s: int, stat: str,
                       log_base: float = math.log(2.0)) -> torch.Tensor:
    """(p, p) float32 pairwise statistic with zero diagonal of the codes
    staged by :func:`stage_codes` (n real samples), on their device."""
    return _mirror(_pair_blocks(xt, n, s, stat, log_base))


def pairwise_stat_matrix_device(X_enc, s: int, stat: str, device=None,
                                log_base: float = math.log(2.0)):
    """Device-RESIDENT (p, p) pairwise statistic with zero diagonal:
    ``(R, p)``, R float32 on ``device``.  Greedy consumers (mRMR, CFS)
    read the columns they select with :func:`matrix_column`."""
    xt = stage_codes(X_enc, s, device)
    return staged_stat_matrix(xt, X_enc.shape[0], s, stat, log_base), \
        xt.shape[0]


def matrix_column(R: torch.Tensor, j: int, p: int) -> np.ndarray:
    """Column j of a mirrored pairwise matrix as host float64: its row j,
    equal to it bit for bit and contiguous."""
    return R[int(j), :p].cpu().numpy().astype(np.float64)


def pairwise_stat_matrix(X_enc, s: int, stat: str, device=None,
                         log_base: float = math.log(2.0),
                         symmetric: bool = True) -> np.ndarray:
    """Full (p, p) pairwise statistic ('mi' or 'su') over feature pairs as
    host float64, the diagonal holding each feature's statistic against
    itself (``symmetric``: the upper triangle mirrored).

    From 1,024 features, with more than one device in the mesh of a fit on
    ``device`` (``relief._mesh_devices``), the pair tiles are sharded over
    it (``parallel.feature_shard.sharded_pairwise_stat_matrix``): the same
    entries, bit for bit."""
    devs = _relief._mesh_devices(device) if X_enc.shape[1] >= 1024 else []
    if len(devs) > 1:
        from ..parallel.feature_shard import sharded_pairwise_stat_matrix
        from ..parallel.sharded import check_same_inputs, make_mesh
        check_same_inputs(make_mesh(devs), X_enc)
        out = sharded_pairwise_stat_matrix(X_enc, s, stat, devices=devs,
                                           log_base=log_base)
        if symmetric:
            upper = np.triu(out, 1)
            out = upper + upper.T + np.diag(np.diag(out))
        return out
    xt = stage_codes(X_enc, s, device)
    R = _pair_blocks(xt, X_enc.shape[0], s, stat, log_base, upper=symmetric)
    if symmetric:
        R = _mirror(R) + torch.diag(R.diagonal())
    return R.cpu().numpy().astype(np.float64)


def pairwise_stat_columns(X_enc, col, s: int, stat: str, device=None,
                          log_base: float = math.log(2.0)) -> np.ndarray:
    """One COLUMN of the pairwise statistic matrix, host float64 (one-shot
    staging; use :class:`StagedColumnStats` when reading several
    columns)."""
    tables = feature_target_tables(X_enc, col, s, s, device)
    return tables_stat(tables, X_enc.shape[0], stat,
                       log_base).cpu().numpy().astype(np.float64)


class StagedColumnStats:
    """Column statistics against codes staged on the device ONCE, for the
    memory-bounded greedy loops (mRMR and CFS past 8192 features): they
    read redundancy columns of the k selected features only, never the
    (p, p) matrix.

    At s >= 3 a column contracts states 1.. of both sides against the
    staged per-feature marginals and recovers state 0 exactly, so its
    tables, and with them its entries, are those of the full one-hot
    builders.

    With more than one device in the mesh of a fit on ``device``
    (``relief._mesh_devices``) the feature tiles are dealt round-robin over
    it: each tile's codes are staged on its device once, and its tables
    are computed there and gathered on ``device``.  Across processes each
    computes the tiles of its own shards, and the int32 tables add by
    all_reduce (every other process's rows are zero)."""

    def __init__(self, X_enc, s: int, device=None,
                 log_base: float = math.log(2.0)):
        self.n, self.p = X_enc.shape
        self.s = int(s)
        self.log_base = log_base
        self.xt = stage_codes(X_enc, self.s, device)
        self.device = self.xt.device
        self.drop = self.s >= 3
        width = self.s - 1 if self.drop else self.s
        self.tile = _vector_tile(self.xt.shape[1], self.p, width)
        from ..parallel.sharded import check_same_inputs, make_mesh
        mesh = _relief._mesh_devices(self.device)
        self._mesh = make_mesh(mesh if len(mesh) > 1 else [self.device])
        check_same_inputs(self._mesh, X_enc)
        # (first feature, features, staged codes, marginals of states 1..)
        # of this process's tiles
        self._tiles = []
        for i, t0 in enumerate(range(0, self.p, self.tile)):
            f = min(self.tile, self.p - t0)
            s = i % len(self._mesh)
            if s not in self._mesh.mine:
                continue
            xt = self.xt[t0:t0 + f].to(self._mesh[s], non_blocking=True)
            marg = (_marginals(_onehot_rows(xt, width, first=1), f, width)
                    if self.drop else None)
            self._tiles.append((t0, f, xt, marg))

    def tables_vs(self, v_enc, s_v: int) -> torch.Tensor:
        """(p, s, s_v) int32 tables of every feature against 1-D codes v
        (host array or tensor): one GEMM a feature tile, on its device.
        At s >= 3 states 1.. of both sides are contracted and state 0 is
        recovered from the staged marginals.  Across processes every
        process must pass the same v (checked)."""
        from ..parallel.sharded import check_same_inputs
        check_same_inputs(self._mesh, v_enc)
        return self._tables(v_enc, s_v)

    def _tables(self, v_enc, s_v: int) -> torch.Tensor:
        first = int(self.drop)
        sxm, svm = self.s - first, s_v - first
        v = _stage_vector(v_enc, self.xt.shape[1], self.device)
        rhs = {}   # device -> (v's one-hot, its marginals)
        spans = self._mesh.group is not None
        out = (torch.zeros if spans else torch.empty)(
            (self.p, self.s, s_v), dtype=torch.int32, device=self.device)
        for t0, f, xt, marg in self._tiles:
            if xt.device not in rhs:
                b = _onehot_rows(v.to(xt.device, non_blocking=True)[None, :],
                                 svm, first=first, rows=_b_rows(svm))
                rhs[xt.device] = b, _marginals(b, 1, svm)
            b, mv = rhs[xt.device]
            a = _onehot_rows(xt, sxm, first=first,
                             rows=max(f * sxm, _MIN_ROWS))
            sub = _dot_t(a, b)[:f * sxm, :svm].view(f, sxm, svm)
            tables = _assemble(sub, marg, mv, self.n) if self.drop else sub
            out[t0:t0 + f] = tables.to(self.device, non_blocking=True)
        if spans:
            from ..parallel.sharded import psum
            out = psum([out], self._mesh)
        return out

    def stats_vs(self, v_enc, s_v: int, stat: str) -> np.ndarray:
        """stat(X_f, v) for every feature f against the 1-D codes v, host
        float64."""
        return self._stats(self.tables_vs(v_enc, s_v), stat)

    def _stats(self, tables: torch.Tensor, stat: str) -> np.ndarray:
        return tables_stat(tables, self.n, stat,
                           self.log_base).cpu().numpy().astype(np.float64)

    def column(self, j: int, stat: str) -> np.ndarray:
        """One COLUMN of the pairwise statistic matrix, O(p * s^2); the
        staged codes of feature j never leave the device (nor are they
        checked across processes: they are the checked X's)."""
        return self._stats(self._tables(self.xt[int(j), :self.n], self.s),
                           stat)
