"""Relief-family engine for all-discrete data on exact int8 GEMMs.

Counterpart of ``fastselect_tpu/ops/relief_discrete.py``.  On all-discrete
data every feature diff is a Hamming mismatch ``1[x_if != x_jf]``
(reference ``MultiSURF.py:37-40``), so both O(n^2 p) passes become
products of 0/1 one-hot matrices:

  encode    x[:, f] -> state codes 0..S-1 (``utils.preprocessing``)
  pass 1    match[i, j] = sum_f 1[x_if == x_jf] = sum_c A_c @ A_c^T,
            A_c = 1[codes == c];  D = p_pad - match  (padded features
            always match, so they cancel)
  weights   W = sum_k r_k[:, None] * M_k   (``relief.pair_weight_rules``)
  pass 2    scores_f = sum_i r_k[i] |M_k[i]|
                       - sum_ck (A_c * (M_k @ A_c) * r_k).sum(i)

Every operand is 0/1 (or -1/0/1), so int8 x int8 -> int32 is exact and D
holds exact integer mismatch counts.  The products go to ``torch._int_mm``
(cuBLASLt on CUDA), as the JAX package left them to XLA's ``dot_general``:
no Pallas kernel is involved.  On CUDA that GEMM takes a row-major A with
more than 16 rows and a contraction length and output width that are
multiples of 8; the engine pads to those rules (:func:`_gemm_size`,
:func:`_segment_operand`) and never falls back to a float product: a
shape the GEMM refuses raises.  ``gemm_ops`` counts 2*m*k*n for every
product, as ``relief_cuda.launches`` counts kernel launches.

Three tiers, chosen as in the JAX package and by the same gates:

  v1      unsorted rows; pass 2 contracts every rule over all samples;
  v2      rows stable-sorted by class; pass 2 contracts each rule only
          over its class segment (``_plan_segments``);
  v2-sym  v2 with the one-hot built once and pass 1 taken from the upper
          block triangle of one (n_pad, n_pad) match matrix.

The JAX package runs v1 and v2 either monolithically (``lax.map`` in one
dispatch) or streamed (one dispatch per block, summed in float64 on the
host) because of jit dispatch limits.  Here each tier is one Python loop
over focal blocks, and block partials are summed in float64 on the device.
The score is divided by n by :func:`relief_discrete_scores`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.logging import phase
from ..utils.preprocessing import MAX_STATES, encode_columns
from .relief import pair_weight_rules

_DOT_DTYPE = torch.int8
_ACC_DTYPE = torch.int32
# torch._int_mm on CUDA: A needs more than 16 rows, and the contraction
# length and output width must be multiples of 8.
_CUDA_MIN_ROWS = 32
_GEMM_ALIGN = 8

# 2*m*k*n of every int8 product since the last reset
gemm_ops = 0


def reset_gemm_ops() -> None:
    global gemm_ops
    gemm_ops = 0


def _round_up(v: int, m: int) -> int:
    return ((v + m - 1) // m) * m


def _dot(a, b):
    """a @ b, int8 x int8 -> exact int32."""
    global gemm_ops
    out = torch._int_mm(a, b)
    gemm_ops += 2 * a.shape[0] * a.shape[1] * b.shape[1]
    return out


def _dot_t(a, b):
    """a @ b.T for row-major a (m, k) and b (n, k): b.T is the
    column-major (k, n) operand, which the GEMM reads without a copy.

    Every product of the engine takes this layout, with the contraction
    axis contiguous in both operands: on an H100 cuBLASLt ran a
    4096x8192x6144 int8 product at 959 TOP/s this way and at 129 TOP/s
    with a row-major B."""
    return _dot(a, b.t())


def _onehot(codes, states, shape):
    """1[codes == states] broadcast into a new contiguous int8 tensor of
    ``shape`` (bool and int8 share their bytes: True is 1)."""
    hot = torch.empty(shape, dtype=torch.bool, device=codes.device)
    torch.eq(codes, states, out=hot)
    return hot.view(_DOT_DTYPE)


def _states(n_states, codes):
    return torch.arange(n_states, dtype=codes.dtype, device=codes.device)


def _onehot_flat(codes_t, n_states):
    """(rows, FT) codes -> (rows, S * FT) 0/1 int8 one-hot, state c at
    columns [c * FT, (c + 1) * FT), so one product covers the sum over
    states."""
    rows, ft = codes_t.shape
    hot = _onehot(codes_t[:, None, :],
                  _states(n_states, codes_t)[None, :, None],
                  (rows, n_states, ft))
    return hot.view(rows, n_states * ft)


def _onehot_flat_t(codes_t, n_states):
    """The transpose of :func:`_onehot_flat`, (S * FT, rows), rows
    contiguous: pass 2 contracts over rows."""
    rows, ft = codes_t.shape
    hot = _onehot(codes_t.t()[None, :, :],
                  _states(n_states, codes_t)[:, None, None],
                  (n_states, ft, rows))
    return hot.view(n_states * ft, rows)


def _float_tensor(x, device=None):
    """X (numpy or tensor) as float32 on ``device`` (default: its own)."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    return x.to(device=device or x.device, dtype=torch.float32)


def encode_discrete(x, f_chunk: int | None = None):
    """Per-column state codes: ``(codes (n, p) int8 np.ndarray, n_states)``.

    code[i, f] is the rank of x[i, f] among column f's unique values, from
    one column sort per chunk of ``f_chunk`` columns, in float32 on X's
    device (CPU for a numpy X).  ``n_states`` is the largest cardinality.
    """
    codes, n_unique, _ = encode_columns(_float_tensor(x), f_chunk)
    n_states = int(n_unique.max()) if n_unique.numel() else 1
    return codes.cpu().numpy(), max(n_states, 1)


# ---------------------------------------------------------------------------
# v1: unsorted rows
# ---------------------------------------------------------------------------

def _match_rows(ci, codes_a, ft, n_states):
    """Pass 1: exact match counts (TI, n_pad), one
    (TI, S*FT) x (n_pad, S*FT)^T product per feature tile."""
    n_pad, p_pad = codes_a.shape
    acc = torch.zeros((ci.shape[0], n_pad), dtype=_ACC_DTYPE,
                      device=ci.device)
    for f0 in range(0, p_pad, ft):
        acc += _dot_t(_onehot_flat(ci[:, f0:f0 + ft], n_states),
                      _onehot_flat(codes_a[:, f0:f0 + ft], n_states))
    return acc


def _total_weight(masks, coeffs, acc_dtype):
    """sum_ij W_ij = sum_k sum_i r_k[i] |M_k[i]|, in ``acc_dtype``."""
    return sum((r * m.sum(dim=1, dtype=_ACC_DTYPE).to(acc_dtype)).sum()
               for m, r in zip(masks, coeffs))


def _tile_part(total_w, p_sum, ci_t, n_states):
    """One feature tile's scores: total_w minus the weight of the pairs
    that match, float32 (FT,)."""
    ai = _onehot_flat(ci_t, n_states)
    t2 = torch.where(ai > 0, p_sum, 0).sum(dim=0)
    return (total_w - t2.view(n_states, -1).sum(dim=0)).to(torch.float32)


def _accumulate_discrete(ci, codes_a, rules, ft, n_states,
                         exact_int=False):
    """Pass 2: per-feature score partials (p_pad,) via mask products.

    Padded features always match, so their score is exactly 0.
    ``exact_int`` (SURF's unit +/-1 row coefficients): every term is an
    integer count, so the sums run in int32, exact while TI * n < 2^31.
    """
    ti = ci.shape[0]
    p_pad = codes_a.shape[1]
    masks = [m.to(_DOT_DTYPE) for m, _ in rules]
    if exact_int:
        coeffs = [r.to(_ACC_DTYPE) for _, r in rules]
        acc_dtype = _ACC_DTYPE
    else:
        coeffs = [r for _, r in rules]
        acc_dtype = torch.float32
    total_w = _total_weight(masks, coeffs, acc_dtype)
    parts = torch.empty(p_pad, dtype=torch.float32, device=ci.device)
    for f0 in range(0, p_pad, ft):
        aa_t = _onehot_flat_t(codes_a[:, f0:f0 + ft], n_states)
        p_sum = torch.zeros((ti, n_states * ft), dtype=acc_dtype,
                            device=ci.device)
        for m, r in zip(masks, coeffs):
            p_sum = p_sum + _dot_t(m, aa_t).to(acc_dtype) * r[:, None]
        parts[f0:f0 + ft] = _tile_part(total_w, p_sum, ci[:, f0:f0 + ft],
                                       n_states)
    return parts


def relief_discrete_core(codes_f, yv_f, valid_f, row0,
                         codes_a, yv_a, valid_a,
                         n_real, class_probs,
                         *, algo, use_star, k, ti, ft, n_states):
    """Scores (p_pad,) float64 contributed by focal rows ``codes_f``
    against all rows ``codes_a``, one block of ``ti`` focal rows at a time.

    codes_*: (rows, p_pad) int8; ``row0`` is the global id of the first
    focal row, so a sample is never its own neighbour.
    """
    n_pad, p_pad = codes_a.shape
    dev = codes_a.device
    total = torch.zeros(p_pad, dtype=torch.float64, device=dev)
    # SURF's coefficients are exactly +/-1: exact int32 pass 2 while
    # |t2| <= TI * n stays inside int32
    exact = algo == "surf" and ti * n_pad < 2 ** 31
    for i0 in range(0, codes_f.shape[0], ti):
        ci = codes_f[i0:i0 + ti]
        iid = torch.arange(row0 + i0, row0 + i0 + ti, device=dev)
        D = (p_pad - _match_rows(ci, codes_a, ft, n_states)).to(
            torch.float32)
        rules = pair_weight_rules(
            D, yv_f[i0:i0 + ti], valid_f[i0:i0 + ti], iid, yv_a, valid_a,
            n_real, class_probs, algo=algo, use_star=use_star, k=k)
        total += _accumulate_discrete(ci, codes_a, rules, ft, n_states,
                                      exact_int=exact)
    return total


def _discrete_tile_sizes(n: int, p: int, n_states: int):
    """(TI focal block, FT feature tile), as the JAX package picks them.

    TI >= 4096 keeps the matrix unit busy; FT is 2048 in the symmetric
    zone and 1024 elsewhere (the JAX package's measured sweet spots on a
    TPU), bounded so the (n_pad, S*FT) one-hot temporary stays under 1 GB.
    """
    ti = 4096 if n >= 4096 else _round_up(max(n, 1), 8)
    s = max(n_states, 2)
    n_pad_est = _round_up(max(n, 1), ti)
    cap = 2048 if _sym_zone(n_pad_est, p, s) else 1024
    budget = 1 << 30
    ft_max = min(cap, max(128, budget // max(n * s, 1)))
    p128 = _round_up(max(p, 1), 128)
    n_tiles = -(-p128 // ft_max)
    ft = _round_up(-(-p128 // n_tiles), 128)  # even tiles, < 128*n_tiles pad
    return ti, ft


def _gemm_size(v: int, device: torch.device, minimum: int = 1) -> int:
    """A tile size the GEMM takes on ``device``: on CUDA at least
    ``minimum`` and a multiple of 8 (padded rows and features weigh
    nothing); on the CPU, as given."""
    if device.type != "cuda":
        return v
    return _round_up(max(v, minimum), _GEMM_ALIGN)


def pack_discrete(codes, y, n_states: int = 2, ti: int | None = None,
                  ft: int | None = None):
    """Zero-pad codes/y/validity to (TI, FT) multiples, on the codes'
    device: ``(cpad, yv, valid, (ti, ft))``.

    Padded features are all state 0 (always match -> zero score); padded
    samples get y = -1 and validity 0.  Codes that need no padding are
    used as they are, with no copy.
    """
    codes = torch.as_tensor(codes)
    n, p = codes.shape
    ti0, ft0 = _discrete_tile_sizes(n, p, n_states)
    ti = ti or ti0
    ft = ft or ft0
    n_pad, p_pad = _round_up(n, ti), _round_up(p, ft)
    if (n_pad, p_pad) != (n, p):
        codes = torch.nn.functional.pad(codes, (0, p_pad - p, 0, n_pad - n))
    yv = torch.full((n_pad,), -1, dtype=torch.int64, device=codes.device)
    yv[:n] = torch.as_tensor(np.asarray(y, np.int64), device=codes.device)
    valid = torch.zeros(n_pad, dtype=torch.float32, device=codes.device)
    valid[:n] = 1.0
    return codes, yv, valid, (ti, ft)


# ---------------------------------------------------------------------------
# v2: class-sorted rows, segment-restricted pass 2, symmetric pass 1
#
# Every rule's pair support lies inside ONE class of j-columns (hits: the
# focal class; per-class misses: that class) or its complement.  With the
# samples stable-sorted by class, almost every focal block holds one class,
# so pass 2 contracts each rule only over its support segment: the total
# contraction per focal row drops from R*n to n columns (R rules).  The
# <= C-1 blocks that straddle a class boundary contract the full span.
# ---------------------------------------------------------------------------

def _class_sorted_layout(y, ti):
    """Host-side layout for the class-sorted engines.

    Samples are stable-sorted by class with NO inter-class padding, so
    n_pad is the v1 value.  Returns (classes, perm, segments, block_class,
    n_pad): ``segments[c] = (col0, ncols)`` is class c's exact column
    slice (a plan entry may sum several segments, so they stay disjoint:
    no alignment rounding) and ``block_class[b]`` is the class POSITION
    of focal block b, or None when the block straddles a class boundary.
    """
    y = np.asarray(y)
    n = y.shape[0]
    classes, counts = np.unique(y, return_counts=True)
    perm = np.argsort(y, kind="stable")
    n_pad = _round_up(n, ti)
    bounds = np.concatenate([[0], np.cumsum(counts)]).astype(int)
    segments = [(int(bounds[c]), int(counts[c]))
                for c in range(len(classes))]
    block_class = []
    for b in range(n_pad // ti):
        r0, r1 = b * ti, min((b + 1) * ti, n)
        if r0 >= n:
            block_class.append(len(classes) - 1)  # all-padding block
            continue
        c0 = int(np.searchsorted(bounds, r0, side="right") - 1)
        c1 = int(np.searchsorted(bounds, r1 - 1, side="right") - 1)
        block_class.append(c0 if c0 == c1 else None)
    return classes, perm, segments, block_class, n_pad


def _apply_layout(codes, y, perm, n_pad, p_pad):
    """Class-sorted, zero-padded (n_pad, p_pad) copy of ``codes`` on its
    device, with labels (-1 past n) and validity (0 past n) in the same
    order: one row gather."""
    n, p = codes.shape
    dev = codes.device
    perm_t = torch.as_tensor(perm, device=dev)
    cpad = torch.zeros((n_pad, p_pad), dtype=torch.int8, device=dev)
    cpad[:n, :p] = codes[perm_t]
    yv = torch.full((n_pad,), -1, dtype=torch.int64, device=dev)
    yv[:n] = torch.as_tensor(np.asarray(y, np.int64)[perm], device=dev)
    valid = torch.zeros(n_pad, dtype=torch.float32, device=dev)
    valid[:n] = 1.0
    return cpad, yv, valid


def _plan_segments(algo, use_star, classes, focal_class_pos):
    """Static pass-2 product plan for one focal block.

    Returns a list of (rule_spec, seg_positions) where rule_spec names
    how to build the int8 operand and its row coefficient from the
    rules list:
      'hit'      rules[0]          coeff rules[0].r
      'miss'     rules[1] (- rules[2] when star)   coeff rules[1].r
      'surf_hit' -near_hit (+far_hit when star)    exact +/-1
      'surf_miss' near_miss (-far_miss when star)  exact +/-1
      ('relieff', c)  rules[1 + c]  coeff rules[1 + c].r
    Position ``len(classes)`` denotes the full column span, used by
    blocks that straddle a class boundary.  ReliefF's per-class miss
    supports depend only on the J side, so they stay restricted even for
    those blocks.
    """
    n_cls = len(classes)
    full = [n_cls]
    mixed = focal_class_pos is None
    same = full if mixed else [focal_class_pos]
    other = (full if mixed
             else [i for i in range(n_cls) if i != focal_class_pos])
    if algo == "multisurf":
        return [("hit", same), ("miss", other)]
    if algo == "surf":
        return [("surf_hit", same), ("surf_miss", other)]
    if algo == "relieff":
        plan = [("hit", same)]
        for pos, c in enumerate(classes):
            if mixed or pos != focal_class_pos:
                plan.append((("relieff", int(c)), [pos]))
        return plan
    raise ValueError(algo)  # pragma: no cover


def _plan_operand(spec, rules, use_star):
    """(matrix (TI, n_pad) int8, row_coeff (TI,) | None) for one plan
    entry.  A None coefficient marks the exact-int path: the operand
    already carries the +/-1 signs."""
    if spec == "hit":
        m, r = rules[0]
        return m.to(_DOT_DTYPE), r
    if spec == "miss":
        m, r = rules[1]
        mat = m.to(_DOT_DTYPE)
        if use_star:
            # far-miss coefficient is exactly -r: fold the sign in
            mat = mat - rules[2][0].to(_DOT_DTYPE)
        return mat, r
    if spec == "surf_hit":
        mat = -rules[1][0].to(_DOT_DTYPE)          # near hits, -1
        if use_star:
            mat = mat + rules[2][0].to(_DOT_DTYPE)  # far hits, +1
        return mat, None
    if spec == "surf_miss":
        mat = rules[0][0].to(_DOT_DTYPE)           # near misses, +1
        if use_star:
            mat = mat - rules[3][0].to(_DOT_DTYPE)  # far misses, -1
        return mat, None
    m, r = rules[1 + spec[1]]
    return m.to(_DOT_DTYPE), r


def _segment_operand(mat, s0, sl):
    """``mat``'s columns [s0, s0 + sl) as a GEMM operand: ``(op, r0, r1)``.

    ``op`` spans [r0, r1), the segment rounded out to multiples of 8, and
    is zero outside the segment, so the product with one-hot rows
    [r0, r1) has a contraction length the GEMM takes and adds nothing
    from the neighbouring segments: the segment itself stays exact.
    """
    r0 = s0 // _GEMM_ALIGN * _GEMM_ALIGN
    r1 = min(_round_up(s0 + sl, _GEMM_ALIGN), mat.shape[1])
    op = torch.zeros((mat.shape[0], r1 - r0), dtype=_DOT_DTYPE,
                     device=mat.device)
    op[:, s0 - r0:s0 - r0 + sl] = mat[:, s0:s0 + sl]
    return op, r0, r1


def _accumulate_plan(ci, codes_a, rules, plan, segs_all, ft, n_states,
                     use_star, onehot_t=None):
    """Segment-restricted pass 2: (p_pad,) float32 score partials.

    Each plan entry's operand is cut to its support segments and
    contracted only against those rows of the one-hot, so the total
    contraction is n_pad across ALL entries (vs rules x n_pad for
    :func:`_accumulate_discrete`).  ``segs_all[pos]`` is (col0, ncols);
    ``onehot_t`` optionally supplies the precomputed transposed one-hot
    (:func:`_build_onehot_t`).
    """
    ti = ci.shape[0]
    n_pad, p_pad = codes_a.shape
    sft = n_states * ft
    dev = ci.device

    # int32 sums exactly when every entry is exact-int (SURF / SURF*,
    # whose +/-1 signs live inside the operand) AND |t2| <= TI * n stays
    # inside int32; else float32 (each product is still exact int32)
    all_int = (all(spec in ("surf_hit", "surf_miss") for spec, _ in plan)
               and ti * n_pad < 2 ** 31)
    acc_dtype = _ACC_DTYPE if all_int else torch.float32

    operands = []
    for spec, segs in plan:
        mat, coeff = _plan_operand(spec, rules, use_star)
        operands.append(([_segment_operand(mat, *segs_all[pos])
                          for pos in segs], coeff))

    # total_w from the ORIGINAL full rules (mask row sums)
    coeffs = [r.to(_ACC_DTYPE) if all_int else r for _, r in rules]
    total_w = _total_weight([m for m, _ in rules], coeffs, acc_dtype)

    parts = torch.empty(p_pad, dtype=torch.float32, device=dev)
    for t, f0 in enumerate(range(0, p_pad, ft)):
        aa_t = (_onehot_flat_t(codes_a[:, f0:f0 + ft], n_states)
                if onehot_t is None else onehot_t[t])
        p_sum = torch.zeros((ti, sft), dtype=acc_dtype, device=dev)
        for seg_ops, coeff in operands:
            q = torch.zeros((ti, sft), dtype=_ACC_DTYPE, device=dev)
            for op, r0, r1 in seg_ops:
                q += _dot_t(op, aa_t[:, r0:r1])
            if coeff is None:
                p_sum = p_sum + q.to(acc_dtype)
            else:
                p_sum = p_sum + q.to(torch.float32) * coeff[:, None]
        parts[f0:f0 + ft] = _tile_part(total_w, p_sum, ci[:, f0:f0 + ft],
                                       n_states)
    return parts


def _block_scores_v2(ci, yi, vi, iid, codes_a, yv_a, valid_a, n_real,
                     class_probs, *, algo, use_star, k, ft, n_states,
                     plan, segs_all, match=None, onehot_t=None):
    """Scores (p_pad,) float32 contributed by ONE focal block (v2)."""
    if match is None:
        match = _match_rows(ci, codes_a, ft, n_states)
    D = (codes_a.shape[1] - match).to(torch.float32)
    rules = pair_weight_rules(
        D, yi, vi, iid, yv_a, valid_a, n_real, class_probs,
        algo=algo, use_star=use_star, k=k)
    return _accumulate_plan(ci, codes_a, rules, plan, segs_all, ft,
                            n_states, use_star, onehot_t=onehot_t)


def _build_onehot(cpad, ft, n_states):
    """Precomputed one-hot, tile-major: (n_pad, nf * S * ft) int8 with
    f-tile t's states at columns [t * S * ft, (t + 1) * S * ft)."""
    n_pad, p_pad = cpad.shape
    nf = p_pad // ft
    hot = _onehot(cpad.view(n_pad, nf, 1, ft),
                  _states(n_states, cpad).view(1, 1, n_states, 1),
                  (n_pad, nf, n_states, ft))
    return hot.view(n_pad, nf * n_states * ft)


def _build_onehot_t(cpad, ft, n_states):
    """Precomputed transposed one-hot for pass 2: (nf, S * ft, n_pad)
    int8, entry t the :func:`_onehot_flat_t` of f-tile t."""
    n_pad, p_pad = cpad.shape
    nf = p_pad // ft
    hot = _onehot(cpad.t().reshape(nf, 1, ft, n_pad),
                  _states(n_states, cpad).view(1, n_states, 1, 1),
                  (nf, n_states, ft, n_pad))
    return hot.view(nf, n_states * ft, n_pad)


def _match_matrix_sym(onehot_a, ti):
    """Full (n_pad, n_pad) int32 match-count matrix from the upper block
    triangle only: match is symmetric, so block (bj, bi) is the transpose
    of (bi, bj).  Match counts sum over features, so each block row is one
    product over the whole one-hot width."""
    n_pad = onehot_a.shape[0]
    M = torch.empty((n_pad, n_pad), dtype=_ACC_DTYPE,
                    device=onehot_a.device)
    for b0 in range(0, n_pad, ti):
        b1 = b0 + ti
        row = _dot_t(onehot_a[b0:b1], onehot_a[b0:])   # (ti, n_pad - b0)
        M[b0:b1, b0:] = row
        M[b1:, b0:b1] = row[:, ti:].t()
    return M


# v2 gates, at the JAX package's values so that a shape takes the same
# tier in both packages: minimum sample count, and the symmetric tier's
# budgets for the precomputed one-hot and the (n, n) match matrix.  The
# byte budgets were sized for a 16 GB TPU; an 80 GB card could take more.
_V2_MIN_N = 4096
_SYM_MAX_N = 24576
_SYM_ONEHOT_BYTES = 4 << 30
_SYM_MATCH_BYTES = 3 << 30


def _sym_zone(n_pad: int, p: int, n_states: int) -> bool:
    """The symmetric tier's gate, shared by the tile-size chooser and
    :func:`_run_v2`: the precomputed one-hot and the (n, n) match matrix
    must both fit their budgets.  ``p`` is the RAW feature count,
    normalised here to the 128-aligned lower bound of any ft padding."""
    p128 = _round_up(max(p, 1), 128)
    s = max(int(n_states), 2)
    return (n_pad <= _SYM_MAX_N
            and n_pad * s * p128 <= _SYM_ONEHOT_BYTES
            and 4 * n_pad * n_pad <= _SYM_MATCH_BYTES)


def _v2_layout(y, n, ti, algo, class_probs):
    """Class-sorted layout when the v2 engines apply, else None."""
    if n < _V2_MIN_N:
        return None
    layout = _class_sorted_layout(y[:n], ti)
    if len(layout[0]) > 16:
        return None  # at most 16 per-class plans
    if algo == "relieff":
        # per-class plans index rules[1 + c] by class VALUE; that needs
        # classes 0..C-1 AND class_probs actually covering them (the
        # op-level default class_probs=None yields a single dummy rule)
        if class_probs is None or not np.array_equal(
                layout[0], np.arange(len(layout[0]))):
            return None
        if np.asarray(class_probs).shape[0] < len(layout[0]):
            return None
    return layout


def _run_v2(codes, y, layout, n, p, n_states, class_probs,
            *, algo, use_star, k, ti, ft):
    """Class-sorted v2 on the codes' device: (p_pad,) float64 scores.

    In the symmetric zone the one-hot is built once for pass 1, which
    comes from one match matrix, and once transposed for pass 2;
    otherwise every focal block runs its own pass 1 and builds each
    tile's one-hot."""
    classes, perm, segments, block_class, n_pad = layout
    p_pad = _round_up(p, ft)
    cpad, yv, valid = _apply_layout(codes, y[:n], perm, n_pad, p_pad)
    dev = cpad.device
    cls_t = tuple(int(c) for c in classes)
    plan_of = {pos: _plan_segments(algo, use_star, cls_t, pos)
               for pos in set(block_class)}
    segs_all = list(segments) + [(0, n_pad)]  # last position = full span
    cp = torch.as_tensor(np.asarray(class_probs, np.float32), device=dev)
    n_real = torch.tensor(float(n), dtype=torch.float32, device=dev)

    onehot_t = match = None
    if _sym_zone(n_pad, p, n_states):
        match = _match_matrix_sym(_build_onehot(cpad, ft, n_states), ti)
        onehot_t = _build_onehot_t(cpad, ft, n_states)
    total = torch.zeros(p_pad, dtype=torch.float64, device=dev)
    for b, pos in enumerate(block_class):
        rows = slice(b * ti, (b + 1) * ti)
        total += _block_scores_v2(
            cpad[rows], yv[rows], valid[rows],
            torch.arange(b * ti, (b + 1) * ti, device=dev),
            cpad, yv, valid, n_real, cp, algo=algo, use_star=use_star,
            k=k, ft=ft, n_states=n_states, plan=plan_of[pos],
            segs_all=segs_all,
            match=None if match is None else match[rows],
            onehot_t=onehot_t)
    return total


def _tiles_and_layout(n, p, n_states, y, algo, class_probs, device,
                      ti=None, ft=None):
    """(v2 layout or None, TI, FT) of a fit on ``device``."""
    ti0, ft0 = _discrete_tile_sizes(n, p, n_states)
    ti = _gemm_size(ti or ti0, device, _CUDA_MIN_ROWS)
    layout = _v2_layout(np.asarray(y), n, ti, algo, class_probs)
    if ft is None and layout is not None:
        ft = _discrete_tile_sizes(layout[4], p, n_states)[1]
    return layout, ti, _gemm_size(ft or ft0, device)


def discrete_tier(n, p, n_states, y, algo, class_probs=None,
                  device="cpu", ti=None) -> str:
    """The tier, 'v1', 'v2' or 'v2-sym', that :func:`relief_discrete_scores`
    takes for these arguments."""
    layout, _, _ = _tiles_and_layout(n, p, n_states, y, algo, class_probs,
                                     torch.device(device), ti)
    if layout is None:
        return "v1"
    return "v2-sym" if _sym_zone(layout[4], p, n_states) else "v2"


def relief_discrete_scores(
    x,
    y,
    *,
    algo: str,
    use_star: bool = False,
    n_neighbors: int = 0,
    class_probs: np.ndarray | None = None,
    device: torch.device | str | None = None,
    codes=None,
    n_states: int | None = None,
    ti: int | None = None,
    ft: int | None = None,
) -> np.ndarray:
    """Relief-family scores for all-discrete X, divided by n_samples.

    ``codes``/``n_states`` can be passed directly (e.g. int8 genotype
    matrices that are already 0..S-1) to skip the encoding.  ``codes`` is
    a numpy array (copied once to ``device``, default CPU) or a tensor,
    scored on its own device.  Without codes, X (numpy or tensor) is
    encoded on ``device`` (default: X's own).  ``ti``/``ft`` override the
    focal-block and feature-tile sizes.
    """
    n, p = (x if codes is None else codes).shape
    if codes is None:
        with phase("relief_discrete.encode", work=n * p):
            codes, n_unique, _ = encode_columns(_float_tensor(x, device))
        n_states = int(n_unique.max())
    elif not isinstance(codes, torch.Tensor):
        with phase("relief_discrete.h2d", work=n * p):
            codes = torch.as_tensor(np.asarray(codes, np.int8), device=device)
    codes, n_states = int8_codes(codes, n_states)
    dev = codes.device
    y = np.asarray(y)

    layout, ti, ft = _tiles_and_layout(n, p, n_states, y, algo,
                                       class_probs, dev, ti, ft)
    if class_probs is None:
        class_probs = np.zeros((1,), np.float32)
    if layout is not None:
        # class-sorted v2: segment-restricted pass 2 (+ symmetric pass 1
        # when the precomputed one-hot fits)
        with phase(f"relief_discrete.engine_v2[{algo}]",
                   work=float(n) * n * p):
            scores = _run_v2(codes, y, layout, n, p, n_states, class_probs,
                             algo=algo, use_star=use_star,
                             k=int(n_neighbors), ti=ti, ft=ft)
            return (scores[:p].to(torch.float32) / float(n)).cpu().numpy()
    cpad, yv, valid, _ = pack_discrete(codes, y, n_states, ti=ti, ft=ft)
    with phase(f"relief_discrete.engine[{algo}]", work=float(n) * n * p):
        scores = relief_discrete_core(
            cpad, yv, valid, 0, cpad, yv, valid,
            torch.tensor(float(n), dtype=torch.float32, device=dev),
            torch.as_tensor(np.asarray(class_probs, np.float32), device=dev),
            algo=algo, use_star=use_star, k=int(n_neighbors), ti=ti, ft=ft,
            n_states=n_states)
        return (scores[:p].to(torch.float32) / float(n)).cpu().numpy()


def int8_codes(codes, n_states: int | None = None, device=None):
    """``(codes, n_states)``: state codes (array or tensor) as an int8
    tensor on ``device`` (default: a tensor's own, else the CPU), with
    n_states (default: the largest code + 1); more than ``MAX_STATES``
    raises."""
    if not isinstance(codes, torch.Tensor):
        codes = torch.as_tensor(np.asarray(codes, np.int8))
    codes = codes.to(device=device or codes.device, dtype=torch.int8)
    if n_states is None:
        n_states = int(codes.max()) + 1
    n_states = max(int(n_states), 1)
    if n_states > MAX_STATES:
        raise ValueError(f"{n_states} states per column: int8 state codes "
                         f"hold at most {MAX_STATES}")
    return codes, n_states
