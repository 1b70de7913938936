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
holds exact integer mismatch counts.  Every product goes to
:func:`int8_gemm`, ``C = A B^T`` or ``C += A B^T`` with the contraction
axis contiguous in both operands: on CUDA the hand-written Hopper kernel
of ``csrc/int8_gemm.cu`` (TMA loads, ``wgmma``), which adds each pass-1
window's product into the match counts in place; on the CPU its plain
twin, ``torch._int_mm``.  The JAX package leaves these products to XLA's
``dot_general``: no Pallas kernel is involved.  The kernel reads its
operands through TMA, whose bases and row strides are 16-byte aligned;
the engine pads windows to multiples of 16 (:func:`_gemm_size`) and cuts
class segments on 128-byte boundaries (:func:`_segment_operand`), and
never falls back to a float product: an operand the kernel refuses
raises.  ``gemm_ops`` counts 2*m*k*n for every product, as
``_build.launches`` counts kernel launches.  On CUDA the focal blocks of
at least ``_V2_MIN_N`` samples are the fewest of at most the JAX package's
TI rows that cover them, equal and whole 128-row lines
(:func:`_block_rows`), where JAX pads n to a multiple of its TI.

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

Each feature window of both passes runs two hand-written kernels of
``csrc/relief_discrete.cu`` around its GEMMs, the counterparts of the two
fusions XLA makes of the JAX package's window scan:
:func:`window_onehot` builds the window's one-hot operand (unpacking
packed codes and reading rows through an index as it goes), and
:func:`window_partials` reduces pass 2's int32 products at each focal
row's state into the window's score partials, with no float temporary
of the products.  On a CUDA tensor each wrapper launches its kernel or
raises; on a CPU tensor it runs its plain twin (:func:`window_onehot_ref`,
:func:`window_partials_ref`), which is also the kernels' referee on the
card.  ``_build.launches`` counts the kernels' launches by name.

Codes past the sort budget (GWAS scale: 2.2 n p bytes over
``_DEVICE_SORT_BUDGET``, JAX's share of its 16 GiB chip scaled to the
card) get no class-sorted copy.  Host codes go to the device bit-packed,
2 or 4 bits a code (:class:`PackedCodes`, packed there a chunk of rows at
a time), and v2 then takes one of two routes (:func:`_v2_route`):

  v2-promote  packed codes up to ``_PACKED_PROMOTE_BUDGET`` are unpacked
              class-sorted into the resident layout, freed, and scored as
              resident codes;
  v2-gather   packed codes past it, or int8 codes on the device past the
              sort budget, stay as they are: each focal block gathers its
              rows, and every window of both passes reads all rows in
              class order through one index, unpacking as it reads.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from .. import _build
from ..utils import staging
from ..utils.logging import count, phase, span
from ..utils.preprocessing import MAX_STATES, encode_columns
from .relief import pair_weight_rules

_DOT_DTYPE = torch.int8
_ACC_DTYPE = torch.int32
# On CUDA: focal blocks and windows padded to multiples of 16, so that
# every base and row stride of the int8 GEMM's operands is 16-byte
# aligned, as its TMA loads need (a row count is free: TMA fills rows past
# m with zeros and drops them on store).
_GEMM_ALIGN = 16
# pass 2's class segments start and end on 128-byte boundaries, so the
# GEMM reads whole 128-byte rows of both operands: on an H100 a segment of
# the transposed one-hot starting 16 bytes past one ran at half the rate
# (793 against 1,748 TOP/s at 4,096 x 3,072 x 15,000)
_SEGMENT_ALIGN = 128

# 2*m*k*n of every int8 product since the last reset
gemm_ops = 0


def reset_gemm_ops() -> None:
    global gemm_ops
    gemm_ops = 0


def _round_up(v: int, m: int) -> int:
    return ((v + m - 1) // m) * m


def _dot(a, b, out=None):
    """a @ b, int8 x int8 -> exact int32 (into ``out`` if given), on
    ``torch._int_mm``: the contingency tables' and MDR's products."""
    global gemm_ops
    out = torch._int_mm(a, b) if out is None else torch._int_mm(a, b,
                                                                out=out)
    gemm_ops += 2 * a.shape[0] * a.shape[1] * b.shape[1]
    return out


def _dot_t(a, b, out=None):
    """a @ b.T for row-major a (m, k) and b (n, k): b.T is the
    column-major (k, n) operand, which the GEMM reads without a copy (on
    an H100 cuBLASLt ran a 4096x8192x6144 int8 product at 959 TOP/s this
    way and at 129 TOP/s with a row-major B)."""
    return _dot(a, b.t(), out)


# ---------------------------------------------------------------------------
# The engine's int8 GEMM (csrc/int8_gemm.cu) and its plain twin
# ---------------------------------------------------------------------------

def _check_gemm(a, b, out, aligned: bool) -> None:
    """Raise unless int8 ``a`` (m, k) and ``b`` (n, k) and int32 ``out``
    (m, n) on one device have unit column strides; with ``aligned`` (the
    kernel's rule on CUDA) also unless every base and row stride, and a
    row of ``out``, is a multiple of 16 bytes (TMA stores whole 16-byte
    pieces of a row)."""
    if a.dtype != _DOT_DTYPE or b.dtype != _DOT_DTYPE:
        raise TypeError(f"int8_gemm takes int8 operands, got {a.dtype} "
                        f"and {b.dtype}")
    if out.dtype != _ACC_DTYPE:
        raise TypeError(f"int8_gemm writes int32, got {out.dtype}")
    if a.dim() != 2 or b.dim() != 2 or out.dim() != 2:
        raise ValueError("int8_gemm takes 2-d tensors")
    (m, k), n = a.shape, b.shape[0]
    if b.shape[1] != k or tuple(out.shape) != (m, n) or 0 in (m, n, k):
        raise ValueError(f"int8_gemm: a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)} and out {tuple(out.shape)} do "
                         f"not make a non-empty a @ b.T")
    if a.device != b.device or a.device != out.device:
        raise ValueError("int8_gemm's tensors must share a device")
    if ((a.stride(1) != 1 and k > 1) or (b.stride(1) != 1 and k > 1)
            or (out.stride(1) != 1 and n > 1)):
        raise ValueError("int8_gemm's operands must be contiguous along K "
                         "and its output along its columns")
    if aligned:
        bases = (a.data_ptr(), b.data_ptr(), out.data_ptr())
        strides = (a.stride(0), b.stride(0), 4 * out.stride(0), 4 * n)
        if any(v % 16 for v in bases + strides):
            raise ValueError(f"int8_gemm on {a.device} needs 16-byte "
                             f"aligned bases, row strides and output rows, "
                             f"got bases {[v % 16 for v in bases]} past 16, "
                             f"row strides of {list(strides[:3])} bytes and "
                             f"output rows of {4 * n}")


def int8_gemm_ref(a, b, out, *, accumulate=False):
    """Plain version of :func:`int8_gemm`: ``torch._int_mm`` and, for the
    accumulating form, an int32 add."""
    prod = torch._int_mm(a, b.t())
    return out.add_(prod) if accumulate else out.copy_(prod)


def int8_gemm(a, b, out, *, accumulate=False):
    """``out = a @ b.T``, or with ``accumulate`` ``out += a @ b.T``: int8
    ``a`` (m, k) and ``b`` (n, k) into int32 ``out`` (m, n), exact.

    Both operands are contiguous along K (``b``'s rows may lie further
    apart, as a column slice of a wider matrix), ``out`` along its columns
    (its rows may lie further apart).  On CUDA the kernel of
    ``csrc/int8_gemm.cu`` computes it, which also needs every base and row
    stride 16-byte aligned and n a multiple of 4, or the call raises; on
    the CPU :func:`int8_gemm_ref`.  ``gemm_ops`` counts 2*m*k*n."""
    global gemm_ops
    cuda = a.device.type == "cuda"
    _check_gemm(a, b, out, aligned=cuda)
    (m, k), n = a.shape, b.shape[0]
    if cuda:
        _build.launch("int8_gemm", a.device, a.data_ptr(), a.stride(0),
                      b.data_ptr(), b.stride(0), out.data_ptr(),
                      out.stride(0), m, n, k, int(accumulate))
    else:
        int8_gemm_ref(a, b, out, accumulate=accumulate)
    gemm_ops += 2 * m * k * n
    return out


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
# Bit-packed codes: 2 bits a code up to 4 states, 4 bits up to 16, packed
# little-endian (byte j holds features j*per .. j*per + per - 1, per =
# 8 // bits; trailing slots hold 0), the JAX package's ``_pack_codes``
# layout byte for byte.  Packing runs on the codes' device.
# ---------------------------------------------------------------------------

# about this many bytes of unpacked codes per chunk of rows when codes are
# staged packed or promoted
_CHUNK_BYTES = 1 << 30


def _pack_bits(n_states: int) -> int:
    """Bits a packed code takes for ``n_states`` states; 0: not packable."""
    return 2 if n_states <= 4 else 4 if n_states <= 16 else 0


def _pack_codes(codes, n_states: int):
    """``(packed uint8 (n, ceil(p / per)), bits)`` of (n, p) int8 codes on
    their device, or None past 16 states."""
    bits = _pack_bits(int(n_states))
    if not bits:
        return None
    per = 8 // bits
    n, p = codes.shape
    pb = -(-p // per)
    u = codes.to(torch.uint8)
    if pb * per != p:
        u = F.pad(u, (0, pb * per - p))
    v = u.reshape(n, pb, per)
    packed = v[:, :, 0].clone()
    for i in range(1, per):
        packed |= v[:, :, i] << (bits * i)
    return packed, bits


class PackedCodes:
    """A code matrix held on a device bit-packed (JAX's ``PackedCodes``):
    a quarter of a byte a genotype at 2 bits, so v2 can score codes whose
    int8 matrix would crowd the device, unpacking windows as it reads them
    (:func:`stage_codes_packed` makes one)."""

    __slots__ = ("packed", "bits", "n", "p", "consumed")

    def __init__(self, packed, bits: int, n: int, p: int):
        self.packed = packed  # (n, ceil(p / (8 // bits))) uint8 tensor
        self.bits = bits
        self.n = n
        self.p = p
        self.consumed = False

    def consume(self):
        """Drop the packed buffer and mark this object spent: the promote
        path calls this once it has unpacked the codes, so the packed and
        the unpacked matrix are not held together for the fit.  The memory
        is freed when no other reference to ``packed`` is left."""
        self.packed = None
        self.consumed = True

    def check_live(self):
        if self.consumed:
            raise RuntimeError(
                "this PackedCodes was consumed by a previous fit (its "
                "packed HBM buffer was freed by the promote path); "
                "re-stage the matrix with stage_codes_packed() before "
                "fitting again")

    @property
    def per(self) -> int:
        return 8 // self.bits

    @property
    def p_eff(self) -> int:
        """Unpacked width (>= p; the overhang decodes to state-0 pad
        features, which always match and score exactly 0)."""
        return self.packed.shape[1] * self.per

    @property
    def shape(self) -> tuple:
        return (self.n, self.p)


def _int8_tensor(codes, device):
    """Codes (numpy or tensor) as an int8 tensor on ``device``."""
    if not isinstance(codes, torch.Tensor):
        codes = torch.as_tensor(np.asarray(codes, np.int8))
    return codes.to(device=device, dtype=torch.int8)


def stage_codes_packed(codes, n_states: int, device=None, *, shape=None):
    """A :class:`PackedCodes` on ``device`` when ``n_states`` allows it (at
    most 16), else the codes as an int8 tensor there.

    ``codes`` is an (n, p) numpy array or tensor (``device`` defaults to a
    tensor's own, else the CPU), copied to the device and packed there a
    chunk of rows at a time into one (n, ceil(p / per)) buffer, so the
    unpacked matrix never exists whole on the device; or, with
    ``shape=(n, p)``, an iterable of row chunks in order (arrays or
    tensors, e.g. drawn on the device one at a time).  Host codes (a
    numpy array or a CPU tensor) go through the process's stager
    (``utils/staging.py``: pinned buffers and a copy stream on a CUDA
    device), so packing one chunk overlaps copying the next.
    """
    if shape is None:
        n, p = codes.shape
        if device is None and isinstance(codes, torch.Tensor):
            device = codes.device
        device = torch.device(device or "cpu")
        if isinstance(codes, torch.Tensor) and codes.device.type != "cpu":
            step = max(1, _CHUNK_BYTES // max(p, 1))
            chunks = (codes[r0:r0 + step] for r0 in range(0, n, step))
        else:
            host = codes.numpy() if isinstance(codes, torch.Tensor) else codes
            chunks = staging.stager(device).stage(
                staging.row_chunks(host, torch.int8), torch.int8)
    else:
        (n, p), chunks = shape, codes
    device = torch.device(device or "cpu")
    bits = _pack_bits(int(n_states))
    if not bits:
        return torch.cat([_int8_tensor(c, device) for c in chunks])
    packed = torch.empty((n, -(-p // (8 // bits))), dtype=torch.uint8,
                         device=device)
    r0 = 0
    for chunk in chunks:
        c = _int8_tensor(chunk, device)
        packed[r0:r0 + c.shape[0]] = _pack_codes(c, n_states)[0]
        r0 += c.shape[0]
    if r0 != n:
        raise ValueError(f"row chunks hold {r0} rows, shape says {n}")
    return PackedCodes(packed, bits, n, p)


def _codes_window(codes_a, off, ft, bits, rows=None):
    """(rows, ft) int8 codes of features [off, off + ft) in their natural
    order, from int8 codes (``bits`` 0) or codes packed ``8 // bits`` a
    byte (``off`` and ``ft`` whole bytes of them), of every row or of the
    rows the index tensor ``rows`` names, in its order.

    A packed window is the per shifts of each byte stacked on a last axis
    and reshaped: one reshape on the card, where JAX unpacks in a plane
    order to avoid a TPU lane shuffle."""
    if bits == 0:
        win = codes_a[:, off:off + ft]
        return win if rows is None else win[rows]
    per = 8 // bits
    win = codes_a[:, off // per:(off + ft) // per]
    if rows is not None:
        win = win[rows]
    shifts = torch.arange(0, 8, bits, dtype=torch.uint8, device=win.device)
    out = (win[:, :, None] >> shifts).bitwise_and_((1 << bits) - 1)
    return out.view(torch.int8).view(win.shape[0], -1)


def _unpacked_width(codes_a, bits) -> int:
    """Features in each row of int8 (``bits`` 0) or packed codes."""
    return codes_a.shape[1] * (8 // bits if bits else 1)


def _gemm_window(codes_a, off, w, bits, rows=None):
    """:func:`_codes_window`, widened on CUDA to the GEMM's multiple of 8
    with code -1, whose one-hot columns are all 0."""
    win = _codes_window(codes_a, off, w, bits, rows)
    wp = _gemm_size(w, win.device)
    return win if wp == w else F.pad(win, (0, wp - w), value=-1)


# ---------------------------------------------------------------------------
# The window kernels (csrc/relief_discrete.cu) and their plain twins
# ---------------------------------------------------------------------------

# window_partials: 32 features by 8 row groups a block; the focal rows
# split into spans of at least _PARTIALS_MIN_SPAN rows (a multiple of 8)
# until the grid has _PARTIALS_TARGET_BLOCKS blocks (eight resident blocks
# on each of the H100's 132 SMs).  The plan comes from the shape alone, so
# the sums' order, and the bits, do too.
_PARTIALS_FEATURES = 32
_PARTIALS_MIN_SPAN = 64
_PARTIALS_TARGET_BLOCKS = 1056


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def partials_plan(n_rows: int, w: int) -> tuple[int, int]:
    """(spans, rows a span) of :func:`window_partials` over ``n_rows``
    focal rows and ``w`` features."""
    ftiles = _cdiv(w, _PARTIALS_FEATURES)
    spans = max(1, min(_cdiv(_PARTIALS_TARGET_BLOCKS, ftiles),
                       _cdiv(n_rows, _PARTIALS_MIN_SPAN)))
    span = _round_up(_cdiv(n_rows, spans), 8)
    return _cdiv(n_rows, span), span


def window_onehot_ref(codes_a, off, w, n_states, bits=0, rows=None, *,
                      transpose=False):
    """Plain version of :func:`window_onehot`: the window's codes widened
    to the GEMM's size with code -1 and expanded by ``torch.eq``."""
    win = _gemm_window(codes_a, off, w, bits, rows)
    return (_onehot_flat_t if transpose else _onehot_flat)(win, n_states)


def _check_window(codes_a, bits, off, w):
    """Raise unless [off, off + w) lies inside the codes' features and
    starts on a packed byte."""
    if (off < 0 or w <= 0 or off + w > _unpacked_width(codes_a, bits)
            or (bits and off % (8 // bits))):
        raise ValueError(f"window [{off}, {off + w}) is not inside the "
                         f"codes' {_unpacked_width(codes_a, bits)} features"
                         f" or does not start on a packed byte")


def _check_codes(codes_a, bits, rows, off, w, n_states):
    """Raise unless the window [off, off + w) of ``codes_a`` can be read
    as the kernels read it."""
    if codes_a.dtype != (torch.uint8 if bits else torch.int8):
        raise TypeError(f"codes must be {'uint8 packed' if bits else 'int8'}"
                        f", got {codes_a.dtype}")
    if codes_a.dim() != 2 or codes_a.stride(1) != 1:
        raise ValueError("codes must be a 2-d tensor with unit column "
                         "stride")
    if bits not in (0, 1, 2, 4):
        raise ValueError(f"bits must be 0, 1, 2 or 4, got {bits}")
    _check_window(codes_a, bits, off, w)
    if not 0 < n_states <= MAX_STATES:
        raise ValueError(f"n_states must be in [1, {MAX_STATES}], got "
                         f"{n_states}")
    if rows is not None and (rows.dtype != torch.int64 or rows.dim() != 1
                             or not rows.is_contiguous()
                             or rows.device != codes_a.device):
        raise ValueError("rows must be a contiguous int64 vector on the "
                         "codes' device")


def window_onehot(codes_a, off, w, n_states, bits=0, rows=None, *,
                  transpose=False, out=None):
    """The one-hot GEMM operand of features [off, off + w) of ``codes_a``:
    (rows, S * wp) int8 with state c of feature f at column c * wp + f,
    or with ``transpose`` its transpose (S * wp, rows), rows contiguous;
    wp is ``w`` widened to the GEMM's size on CUDA (:func:`_gemm_size`),
    whose columns past w are 0.

    ``codes_a`` is int8 codes (``bits`` 0) or codes packed ``8 // bits`` a
    byte (``off`` whole bytes of them), unpacked as they are read; the
    index ``rows`` (int64) picks and orders its rows.  ``out``, a tensor of
    that shape with unit column stride (rows may be further apart), takes
    the result.  On CUDA the kernel writes it (``csrc/relief_discrete.cu``);
    on the CPU :func:`window_onehot_ref` computes it."""
    _check_codes(codes_a, bits, rows, off, w, n_states)
    n_rows = codes_a.shape[0] if rows is None else rows.shape[0]
    wp = _gemm_size(w, codes_a.device)
    shape = (n_states * wp, n_rows) if transpose else (n_rows, n_states * wp)
    if out is not None and (tuple(out.shape) != shape
                            or out.dtype != _DOT_DTYPE or out.stride(1) != 1
                            or out.device != codes_a.device):
        raise ValueError(f"out must be int8 of shape {shape} with unit "
                         f"column stride on {codes_a.device}")
    if codes_a.device.type == "cpu":
        hot = window_onehot_ref(codes_a, off, w, n_states, bits, rows,
                                transpose=transpose)
        return hot if out is None else out.copy_(hot)
    if out is None:
        out = torch.empty(shape, dtype=_DOT_DTYPE, device=codes_a.device)
    _build.launch("window_onehot", codes_a.device, codes_a.data_ptr(),
                  codes_a.stride(0), None if rows is None else rows.data_ptr(),
                  n_rows, off, w, wp, bits, n_states, out.data_ptr(),
                  out.stride(0), int(transpose))
    return out


def window_partials_ref(prods, coeffs, ci, off, w, n_states, total_w,
                        bits=0):
    """Plain version of :func:`window_partials`: each product gathered at
    the focal rows' states first, then the float (or, for an integer
    ``total_w``, int32) work on (TI, w) values."""
    codes = _codes_window(ci, off, w, bits).to(torch.int64)
    wp = prods[0][0].shape[1] // n_states
    idx = codes * wp + torch.arange(w, device=ci.device)
    exact = not total_w.is_floating_point()
    acc = _ACC_DTYPE if exact else torch.float32
    v = torch.zeros(idx.shape, dtype=acc, device=ci.device)
    for seg_prods, coeff in zip(prods, coeffs):
        s = seg_prods[0].gather(1, idx)
        for q in seg_prods[1:]:
            s += q.gather(1, idx)
        if coeff is None:
            v = v + s.to(acc)
        elif exact:
            v = v + s * coeff[:, None]
        else:
            v = v + s.to(torch.float32) * coeff[:, None]
    return (total_w - v.sum(dim=0)).to(torch.float32)


class WindowPartials:
    """:func:`window_partials` of one focal block: what holds for all its
    windows (the coefficients, ``total_w``, the focal codes) is checked
    and converted once, and each call reduces one window's products.

    ``n_products[k]`` is the number of products of operand k.  On CUDA a
    call launches the kernel with a device table of the products' and
    coefficients' addresses, built the first time a window's products
    lie at those addresses: products written into the same buffers every
    window (:meth:`products`) reuse one table a window width.  On the CPU
    a call runs :func:`window_partials_ref`."""

    def __init__(self, n_products, coeffs, ci, n_states, total_w, bits=0):
        _check_codes(ci, bits, None, 0, 1, n_states)
        self.n_products = [int(c) for c in n_products]
        if len(self.n_products) != len(coeffs) or min(self.n_products) < 1:
            raise ValueError("every operand needs a coefficient entry and "
                             "at least one product")
        self.ci, self.n_states, self.bits = ci, n_states, bits
        self.exact = not total_w.is_floating_point()
        dtype = _ACC_DTYPE if self.exact else torch.float32
        ti = ci.shape[0]
        self.coeffs = [None if c is None else c.contiguous() for c in coeffs]
        for c in self.coeffs:
            if c is not None and (c.dtype != dtype or c.shape != (ti,)
                                  or c.device != ci.device):
                raise ValueError(f"coefficients must be {dtype} of shape "
                                 f"({ti},) on {ci.device}")
        self.total_w = total_w.to(device=ci.device, dtype=torch.int64
                                  if self.exact else torch.float32)
        self._buf = None
        # (w, wp, product addresses) -> (table, partial scratch, spans, span)
        self._launch = {}

    def products(self, w):
        """Buffers for one window's products, ``[[q, ...], ...]`` in plan
        order, each (TI, S * wp) int32 for ``w`` features; every window of
        one width gets the same buffers."""
        wp = _gemm_size(w, self.ci.device)
        cols = self.n_states * wp
        size = sum(self.n_products) * self.ci.shape[0] * cols
        if self._buf is None or self._buf.numel() < size:
            self._buf = torch.empty(size, dtype=_ACC_DTYPE,
                                    device=self.ci.device)
        qs = iter(self._buf[:size].view(-1, self.ci.shape[0], cols)
                  .unbind(0))
        return [[next(qs) for _ in range(m)] for m in self.n_products]

    def _check_products(self, prods, w, wp):
        ti = self.ci.shape[0]
        if [len(seg_prods) for seg_prods in prods] != self.n_products:
            raise ValueError(f"products per operand must be "
                             f"{self.n_products}")
        for seg_prods in prods:
            for q in seg_prods:
                if (q.dtype != _ACC_DTYPE
                        or q.shape != (ti, self.n_states * wp)
                        or not q.is_contiguous()
                        or q.device != self.ci.device):
                    raise ValueError(f"every product must be contiguous "
                                     f"int32 of shape ({ti}, "
                                     f"{self.n_states * wp}) on "
                                     f"{self.ci.device}")
        if not 0 < w <= wp:
            raise ValueError(f"w {w} must be in (0, {wp}]")

    def __call__(self, prods, off, w, *, out=None):
        """The (w,) float32 partials of the window [off, off + w) from its
        products ``prods`` (``[[q, ...], ...]``, as :meth:`products`)."""
        ci = self.ci
        wp = prods[0][0].shape[1] // self.n_states
        if out is not None and (out.shape != (w,)
                                or out.dtype != torch.float32
                                or not out.is_contiguous()):
            raise ValueError(f"out must be contiguous float32 ({w},)")
        _check_window(ci, self.bits, off, w)
        if ci.device.type == "cpu":
            self._check_products(prods, w, wp)
            part = window_partials_ref(prods, self.coeffs, ci, off, w,
                                       self.n_states, self.total_w,
                                       self.bits)
            return part if out is None else out.copy_(part)
        addrs = [q.data_ptr() for seg_prods in prods for q in seg_prods]
        key = (w, wp, *addrs)
        launch = self._launch.get(key)
        if launch is None:
            self._check_products(prods, w, wp)
            first = np.cumsum([0] + self.n_products).tolist()
            table = torch.tensor(
                addrs + [0 if c is None else c.data_ptr()
                         for c in self.coeffs] + first,
                dtype=torch.int64).to(ci.device, non_blocking=True)
            spans, span = partials_plan(ci.shape[0], w)
            partial = torch.empty((spans, w), dtype=_ACC_DTYPE if self.exact
                                  else torch.float32, device=ci.device)
            launch = self._launch[key] = (table, partial, spans, span)
        table, partial, spans, span = launch
        if out is None:
            out = torch.empty(w, dtype=torch.float32, device=ci.device)
        _build.launch("window_partials", ci.device, table.data_ptr(),
                      len(addrs), len(self.n_products), int(self.exact),
                      ci.data_ptr(), ci.stride(0), off, self.bits,
                      ci.shape[0], w, wp, self.n_states,
                      self.total_w.data_ptr(), partial.data_ptr(), spans,
                      span, out.data_ptr())
        return out


def window_partials(prods, coeffs, ci, off, w, n_states, total_w, bits=0,
                    *, out=None):
    """Pass 2's score partials of one window, (w,) float32:
    ``total_w - sum_i v[i, f]`` with
    ``v[i, f] = sum_k coeffs[k][i] * float(q_k[i, ci[i, f] * wp + f])``.

    ``prods[k]`` lists operand k's int32 products (TI, S * wp) (several
    for an operand of several segments: summed in int32 first),
    ``coeffs[k]`` its (TI,) row coefficients or None for 1, ``ci`` the
    focal rows' codes, read as :func:`window_onehot` reads codes (``off``,
    ``bits``).  ``total_w`` is a scalar tensor: float32, or an integer for
    the exact-int path (int32 coefficients, every term and sum exact).  v
    adds the operands in order, with the rounding of the plain version's
    ``p_sum``; the sum over focal rows runs in an order fixed by the shape
    (:func:`partials_plan`).  ``out`` takes the result.  On CUDA the
    kernel computes it (``csrc/relief_discrete.cu``); on the CPU
    :func:`window_partials_ref`.  A loop over the windows of one focal
    block uses :class:`WindowPartials`, which does the per-block work
    once."""
    return WindowPartials([len(seg_prods) for seg_prods in prods], coeffs,
                          ci, n_states, total_w, bits)(prods, off, w,
                                                       out=out)


# ---------------------------------------------------------------------------
# v1: unsorted rows
# ---------------------------------------------------------------------------

# Pass 1 takes as many feature tiles a window as keep the one-hot of all
# its rows under this many bytes: match counts are exact int32 sums over
# features, so the width moves no bit, and each window's product is added
# into the counts in place, a read and a write of them a window.
_PASS1_ONEHOT_BYTES = 1 << 28


def pass1_width(n_rows: int, n_states: int, ft: int, ti: int) -> int:
    """Features a window of :func:`_match_rows` over ``n_rows`` rows
    against ``ti`` focal rows: as many ``ft``-feature tiles as keep its
    one-hot under ``_PASS1_ONEHOT_BYTES``, at least one, and as many more
    as the bytes of a (ti, n_rows) int32 product buy of both one-hots.
    :func:`int8_gemm` adds each window into the counts in place, so the
    window's one-hots and the counts take no more bytes than a window of
    the first rule alone with its own product beside the counts."""
    tile = n_states * ft
    return ft * (max(1, _PASS1_ONEHOT_BYTES // max(1, n_rows * tile))
                 + 4 * ti * n_rows // ((ti + n_rows) * tile))


def pass2_width(n_rows: int, ti: int, n_products: int, n_states: int,
                ft: int, device: torch.device) -> int:
    """Features a window of :func:`_accumulate_plan` over ``n_rows`` rows
    against ``ti`` focal rows with ``n_products`` int32 products: on CUDA
    as many ``ft``-feature tiles as keep the window's transposed one-hot
    and its products under ``_PASS1_ONEHOT_BYTES``, at least one, so that
    a short, wide matrix launches fewer windows (5,000 x 500,000: 3
    tiles, 163 windows a block in place of 489); one tile elsewhere."""
    if device.type != "cuda":
        return ft
    tile = n_states * ft * (n_rows + 4 * n_products * ti)
    return ft * max(1, _PASS1_ONEHOT_BYTES // tile)


def _match_rows(ci, codes_a, ft, n_states, bits=0, rows=None):
    """Pass 1: exact match counts (TI, rows), one (TI, S*w) x (rows, S*w)^T
    product per window of a whole number of ``ft``-feature tiles (the
    last one narrower on a ragged feature axis), each added into the
    counts by :func:`int8_gemm`.

    ``ci`` and ``codes_a`` are int8 codes, or both packed (``bits``; ``ft``
    whole bytes); ``rows`` picks and orders ``codes_a``'s rows.  The
    counterpart of JAX's ``_match_rows`` and ``_match_rows_raw``.  Padded
    and packed overhang features are state 0 on both sides: they match.
    """
    p_raw = _unpacked_width(codes_a, bits)
    n_rows = codes_a.shape[0] if rows is None else rows.shape[0]
    fw = pass1_width(n_rows, n_states, ft, ci.shape[0])
    acc = torch.zeros((ci.shape[0], n_rows), dtype=_ACC_DTYPE,
                      device=ci.device)
    for off in range(0, p_raw, fw):
        w = min(fw, p_raw - off)
        int8_gemm(window_onehot(ci, off, w, n_states, bits),
                  window_onehot(codes_a, off, w, n_states, bits, rows), acc,
                  accumulate=True)
    return acc


def _total_weight(masks, coeffs, acc_dtype):
    """sum_ij W_ij = sum_k sum_i r_k[i] |M_k[i]|, in ``acc_dtype``."""
    return sum((r * m.sum(dim=1, dtype=_ACC_DTYPE).to(acc_dtype)).sum()
               for m, r in zip(masks, coeffs))


def _accumulate_discrete(ci, codes_a, rules, ft, n_states,
                         exact_int=False):
    """Pass 2: per-feature score partials (p_pad,) via mask products.

    Padded features always match, so their score is exactly 0.
    ``exact_int`` (SURF's unit +/-1 row coefficients): every term is an
    integer count, so the sums run in int32, exact while TI * n < 2^31.
    """
    p_pad = codes_a.shape[1]
    masks = [m.to(_DOT_DTYPE) for m, _ in rules]
    if exact_int:
        coeffs = [r.to(_ACC_DTYPE) for _, r in rules]
        acc_dtype = _ACC_DTYPE
    else:
        coeffs = [r for _, r in rules]
        acc_dtype = torch.float32
    total_w = _total_weight(masks, coeffs, acc_dtype)
    epilogue = WindowPartials([1] * len(masks), coeffs, ci, n_states,
                              total_w)
    parts = torch.empty(p_pad, dtype=torch.float32, device=ci.device)
    count("windows", _cdiv(p_pad, ft))
    for f0 in range(0, p_pad, ft):
        w = min(ft, p_pad - f0)
        aa_t = window_onehot(codes_a, f0, w, n_states, transpose=True)
        prods = epilogue.products(w)
        for m, (q,) in zip(masks, prods):
            int8_gemm(m, aa_t, q)
        epilogue(prods, f0, w, out=parts[f0:f0 + w])
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
        count("focal_blocks")
        ci = codes_f[i0:i0 + ti]
        iid = torch.arange(row0 + i0, row0 + i0 + ti, device=dev)
        with span("discrete.pass1", device=dev):
            match = _match_rows(ci, codes_a, ft, n_states)
        with span("weight_rules", device=dev):
            D = (p_pad - match).to(torch.float32)
            del match
            rules = pair_weight_rules(
                D, yv_f[i0:i0 + ti], valid_f[i0:i0 + ti], iid, yv_a,
                valid_a, n_real, class_probs, algo=algo, use_star=use_star,
                k=k)
        with span("discrete.pass2", device=dev):
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


def _gemm_size(v: int, device: torch.device) -> int:
    """A tile size the GEMM takes on ``device``: on CUDA a multiple of 16
    (padded rows and features weigh nothing); on the CPU, as given."""
    if device.type != "cuda":
        return v
    return _round_up(v, _GEMM_ALIGN)


def _block_rows(n: int, ti: int, device: torch.device) -> int:
    """Focal rows a block of a fit of ``n`` samples, from the JAX
    package's TI ``ti``.  On CUDA from ``_V2_MIN_N`` samples: the fewest
    blocks of at most ``ti`` rows that cover n, equal and rounded up to
    ``_SEGMENT_ALIGN`` rows, so that n pads by less than a block (5,000
    samples: 2 x 2,560, not 2 x 4,096) and every row of pass 2's
    transposed one-hot (n_pad bytes) starts on a 128-byte line; elsewhere
    ``ti`` itself."""
    if device.type != "cuda" or n < _V2_MIN_N:
        return ti
    return _round_up(_cdiv(n, _cdiv(n, ti)), _SEGMENT_ALIGN)


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
    order: each row copied straight to its sorted place
    (``index_copy_``), with no gathered copy of the codes beside them."""
    n, p = codes.shape
    dev = codes.device
    perm_t = torch.as_tensor(perm, device=dev)
    place = torch.empty_like(perm_t)
    place[perm_t] = torch.arange(n, device=dev)
    cpad = torch.zeros((n_pad, p_pad), dtype=torch.int8, device=dev)
    cpad[:n, :p].index_copy_(0, place, codes)
    return (cpad, *_sorted_labels(y, perm, n_pad, dev))


def _sorted_labels(y, perm, n_pad, dev):
    """Labels (-1 past n) and validity (0 past n) of the class-sorted
    layout, on ``dev``."""
    n = len(perm)
    yv = torch.full((n_pad,), -1, dtype=torch.int64, device=dev)
    yv[:n] = torch.as_tensor(np.asarray(y, np.int64)[perm], device=dev)
    valid = torch.zeros(n_pad, dtype=torch.float32, device=dev)
    valid[:n] = 1.0
    return yv, valid


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

    ``op`` spans [r0, r1), the segment rounded out to multiples of
    ``_SEGMENT_ALIGN`` (or to the end of ``mat``), and is zero outside the
    segment, so the product with one-hot rows [r0, r1) starts both
    operands on 128-byte boundaries, as the GEMM reads them fastest, and
    adds nothing from the neighbouring segments: the segment itself stays
    exact.
    """
    r0 = s0 // _SEGMENT_ALIGN * _SEGMENT_ALIGN
    r1 = min(_round_up(s0 + sl, _SEGMENT_ALIGN), mat.shape[1])
    op = torch.zeros((mat.shape[0], r1 - r0), dtype=_DOT_DTYPE,
                     device=mat.device)
    op[:, s0 - r0:s0 - r0 + sl] = mat[:, s0:s0 + sl]
    return op, r0, r1


def _accumulate_plan(ci, codes_a, rules, plan, segs_all, ft, n_states,
                     use_star, onehot_t=None, bits=0, rows=None):
    """Segment-restricted pass 2: (p_pad,) float32 score partials.

    Each plan entry's operand is cut to its support segments and
    contracted only against those rows of the one-hot, so the total
    contraction is n_pad across ALL entries (vs rules x n_pad for
    :func:`_accumulate_discrete`).  ``segs_all[pos]`` is (col0, ncols);
    ``onehot_t`` optionally supplies the precomputed transposed one-hot
    (:func:`_build_onehot_t`), one ``ft`` tile a window; without it a
    window is :func:`pass2_width` features.  The operands are cut once,
    outside the window loop.  ``bits`` and ``rows`` read the windows as
    :func:`_match_rows` does (the gather route: ``rows`` puts the rows in
    class order, so the segments are the resident layout's; JAX's
    ``_accumulate_plan_gather``), over the packed width when packed.
    """
    ti = ci.shape[0]
    n_pad = codes_a.shape[0] if rows is None else rows.shape[0]
    p_pad = _unpacked_width(codes_a, bits)
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

    epilogue = WindowPartials([len(seg_ops) for seg_ops, _ in operands],
                              [coeff for _, coeff in operands], ci,
                              n_states, total_w, bits)
    parts = torch.empty(p_pad, dtype=torch.float32, device=dev)
    fw = (ft if onehot_t is not None
          else pass2_width(n_pad, ti, sum(epilogue.n_products), n_states,
                           ft, dev))
    count("windows", _cdiv(p_pad, fw))
    for t, f0 in enumerate(range(0, p_pad, fw)):
        w = min(fw, p_pad - f0)
        aa_t = (window_onehot(codes_a, f0, w, n_states, bits, rows,
                              transpose=True)
                if onehot_t is None else onehot_t[t])
        prods = epilogue.products(w)
        for (seg_ops, _), seg_prods in zip(operands, prods):
            for (op, r0, r1), q in zip(seg_ops, seg_prods):
                int8_gemm(op, aa_t[:, r0:r1], q)
        epilogue(prods, f0, w, out=parts[f0:f0 + w])
    return parts


def _block_scores_v2(ci, yi, vi, iid, codes_a, yv_a, valid_a, n_real,
                     class_probs, *, algo, use_star, k, ft, n_states,
                     plan, segs_all, match=None, onehot_t=None, bits=0,
                     rows=None):
    """Scores (p_pad,) float32 contributed by ONE focal block (v2); with
    ``bits`` and ``rows`` over codes read as :func:`_match_rows` reads
    them (JAX's ``_relief_discrete_block_v2g``).  Pass 2 of a block that
    straddles a class boundary (its plan contracts the full span, the
    last position of ``segs_all``) is also the span
    ``discrete.straddle``."""
    count("focal_blocks")
    dev = ci.device
    straddle = any(len(segs_all) - 1 in segs for _, segs in plan)
    if match is None:
        with span("discrete.pass1", device=dev):
            match = _match_rows(ci, codes_a, ft, n_states, bits, rows)
    with span("weight_rules", device=dev):
        D = (_unpacked_width(codes_a, bits) - match).to(torch.float32)
        rules = pair_weight_rules(
            D, yi, vi, iid, yv_a, valid_a, n_real, class_probs,
            algo=algo, use_star=use_star, k=k)
    inner = (span("discrete.straddle", device=dev) if straddle
             else contextlib.nullcontext())
    with span("discrete.pass2", device=dev), inner:
        return _accumulate_plan(ci, codes_a, rules, plan, segs_all, ft,
                                n_states, use_star, onehot_t=onehot_t,
                                bits=bits, rows=rows)


def _build_onehot(cpad, ft, n_states):
    """Precomputed one-hot, tile-major: (n_pad, nf * S * ft) int8 with
    f-tile t's states at columns [t * S * ft, (t + 1) * S * ft)."""
    n_pad, p_pad = cpad.shape
    sft = n_states * ft
    hot = torch.empty((n_pad, p_pad // ft * sft), dtype=_DOT_DTYPE,
                      device=cpad.device)
    for t in range(p_pad // ft):
        window_onehot(cpad, t * ft, ft, n_states,
                      out=hot[:, t * sft:(t + 1) * sft])
    return hot


def _build_onehot_t(cpad, ft, n_states):
    """Precomputed transposed one-hot for pass 2: (nf, S * ft, n_pad)
    int8, entry t the transposed :func:`window_onehot` of f-tile t."""
    n_pad, p_pad = cpad.shape
    hot = torch.empty((p_pad // ft, n_states * ft, n_pad), dtype=_DOT_DTYPE,
                      device=cpad.device)
    for t in range(p_pad // ft):
        window_onehot(cpad, t * ft, ft, n_states, transpose=True, out=hot[t])
    return hot


def _match_matrix_sym(onehot_a, ti):
    """Full (n_pad, n_pad) int32 match-count matrix from the upper block
    triangle only: match is symmetric, so block (bj, bi) is the transpose
    of (bi, bj).  Match counts sum over features, so each block row is one
    product over the whole one-hot width, written in place."""
    n_pad = onehot_a.shape[0]
    M = torch.empty((n_pad, n_pad), dtype=_ACC_DTYPE,
                    device=onehot_a.device)
    for b0 in range(0, n_pad, ti):
        b1 = b0 + ti
        int8_gemm(onehot_a[b0:b1], onehot_a[b0:], M[b0:b1, b0:])
        M[b1:, b0:b1] = M[b0:b1, b1:].t()
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


# Past 2.2x this many bytes of int8 codes a class-sorted copy cannot sit
# beside them on the device: host codes are staged packed, and v2 reads
# device codes in place (the gather route).  Packed codes of at most
# _PACKED_PROMOTE_BUDGET codes are promoted to the resident layout instead.
# Both are JAX's values for its 16 GiB chip, kept so that tests patch them
# alike in both packages; on a CUDA device :func:`_budget` scales them by
# its memory.
_DEVICE_SORT_BUDGET = 6 << 30
_PACKED_PROMOTE_BUDGET = 7 << 30
_JAX_CHIP_BYTES = 16 << 30


def _budget(value, device) -> float:
    """``value`` as a share of the JAX package's 16 GiB chip, scaled to a
    CUDA device's memory (read at each call); as it is on the CPU, and for
    planning on a host without CUDA."""
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return value
    total = torch.cuda.get_device_properties(device).total_memory
    return value * total / _JAX_CHIP_BYTES


def _past_sort_budget(n: int, p: int, device) -> bool:
    return 2.2 * n * p > _budget(_DEVICE_SORT_BUDGET, device)


def keeps_host_codes(n: int, p: int, device) -> bool:
    """Whether a fit hands (n, p) host codes to :func:`relief_discrete_scores`
    as they are, for it to stage them packed where v2 applies, rather than
    copying them to ``device`` first: at v2's sample count and past the
    sort budget."""
    return n >= _V2_MIN_N and _past_sort_budget(n, p, device)


def _v2_route(n: int, p: int, ft: int, device, per: int = 0) -> str:
    """How v2 reads (n, p) codes on ``device``: packed ones (``per`` codes
    a byte) 'promote' or 'gather', int8 ones 'gather' or 'resident' (JAX's
    ``_run_v2`` choice)."""
    if per:
        if n * p <= _budget(_PACKED_PROMOTE_BUDGET, device) and ft % per == 0:
            return "promote"
        return "gather"
    return ("gather" if _past_sort_budget(n, p, device) and p >= ft
            else "resident")


def _v2_context(layout, n, class_probs, dev, algo, use_star):
    """(plan of each focal block's class position, segments with the full
    span last, class_probs and n as tensors on ``dev``) of a v2 run."""
    classes, _, segments, block_class, n_pad = layout
    cls_t = tuple(int(c) for c in classes)
    plan_of = {pos: _plan_segments(algo, use_star, cls_t, pos)
               for pos in set(block_class)}
    segs_all = list(segments) + [(0, n_pad)]  # last position = full span
    cp = torch.as_tensor(np.asarray(class_probs, np.float32), device=dev)
    n_real = torch.tensor(float(n), dtype=torch.float32, device=dev)
    return plan_of, segs_all, cp, n_real


def _promote_packed_sorted(codes, perm, n_pad, p_pad):
    """Packed codes unpacked into ``_apply_layout``'s class-sorted,
    zero-padded (n_pad, p_pad) int8 layout (``p_pad`` whole packed bytes:
    overhang slots hold 0), a chunk of rows at a time, so the unpacked
    matrix exists once."""
    dev = codes.packed.device
    cpad = torch.zeros((n_pad, p_pad), dtype=torch.int8, device=dev)
    perm_t = torch.as_tensor(perm, device=dev)
    step = max(1, _CHUNK_BYTES // codes.p_eff)
    for r0 in range(0, len(perm), step):
        rows = perm_t[r0:r0 + step]
        cpad[r0:r0 + len(rows), :codes.p_eff] = _codes_window(
            codes.packed, 0, codes.p_eff, codes.bits, rows)
    return cpad


def _run_v2_gather(codes, y, layout, n, n_states, class_probs,
                   *, algo, use_star, k, ti, ft):
    """v2 with no sorted or padded copy of the codes: (p_raw,) float64
    scores of int8 codes, or of packed codes, which stay packed.

    Each focal block gathers its rows (packed: ti * p / per bytes), and
    every window of both passes reads all rows in class order through one
    index (padded positions read row 0 at weight 0), unpacking as it
    reads.  D, the weight rules and the plan's segments are then the
    resident route's, so are the scores but for the float32 sums of a
    narrower last window.  Pass 1 and pass 2 (with the rules) of every
    block are phases: ``relief_discrete.gather_pass1`` and ``_pass2``."""
    _, perm, _, block_class, n_pad = layout
    packed = isinstance(codes, PackedCodes)
    codes_a, bits = (codes.packed, codes.bits) if packed else (codes, 0)
    per = 8 // bits if bits else 1
    if ft % per:
        raise ValueError(f"a feature tile of {ft} codes is not whole bytes "
                         f"of {per} packed codes")
    dev = codes_a.device
    with span("discrete.layout", device=dev):
        rows = torch.zeros(n_pad, dtype=torch.int64, device=dev)
        rows[:n] = torch.as_tensor(perm, device=dev)
        yv, valid = _sorted_labels(y[:n], perm, n_pad, dev)
        plan_of, segs_all, cp, n_real = _v2_context(
            layout, n, class_probs, dev, algo, use_star)
    p_raw = _unpacked_width(codes_a, bits)
    work = float(ti) * n_pad * p_raw
    total = torch.zeros(p_raw, dtype=torch.float64, device=dev)
    for b, pos in enumerate(block_class):
        blk = slice(b * ti, (b + 1) * ti)
        ci = codes_a[rows[blk]]
        with phase("relief_discrete.gather_pass1", work=work), \
                span("discrete.pass1", device=dev):
            match = _match_rows(ci, codes_a, ft, n_states, bits, rows)
        with phase("relief_discrete.gather_pass2", work=work):
            total += _block_scores_v2(
                ci, yv[blk], valid[blk],
                torch.arange(b * ti, (b + 1) * ti, device=dev),
                codes_a, yv, valid, n_real, cp, algo=algo,
                use_star=use_star, k=k, ft=ft, n_states=n_states,
                plan=plan_of[pos], segs_all=segs_all, match=match,
                bits=bits, rows=rows)
        del ci, match  # freed before the next block's rows are gathered
    return total


def _run_v2(codes, y, layout, n, p, n_states, class_probs,
            *, algo, use_star, k, ti, ft):
    """Class-sorted v2 on the codes' device: (>= p,) float64 scores.

    ``codes`` is an int8 tensor or a :class:`PackedCodes`, read as
    :func:`_v2_route` says: in place (:func:`_run_v2_gather`), or from a
    class-sorted, zero-padded copy (``_apply_layout``; promoted packed
    codes are unpacked into it and then consumed).  In the symmetric zone
    the one-hot of that copy is built once for pass 1, which comes from
    one match matrix, and once transposed for pass 2; otherwise every
    focal block runs its own pass 1 and builds each tile's one-hot."""
    packed = isinstance(codes, PackedCodes)
    if packed:
        codes.check_live()
    route = _v2_route(n, p, ft, (codes.packed if packed else codes).device,
                      codes.per if packed else 0)
    if route == "gather":
        return _run_v2_gather(codes, y, layout, n, n_states, class_probs,
                              algo=algo, use_star=use_star, k=k, ti=ti,
                              ft=ft)
    _, perm, _, block_class, n_pad = layout
    p_pad = _round_up(p, ft)
    dev = (codes.packed if packed else codes).device
    with span("discrete.layout", device=dev):
        if route == "promote":
            cpad = _promote_packed_sorted(codes, perm, n_pad, p_pad)
            codes.consume()
            yv, valid = _sorted_labels(y[:n], perm, n_pad, dev)
        else:
            cpad, yv, valid = _apply_layout(codes, y[:n], perm, n_pad, p_pad)
        plan_of, segs_all, cp, n_real = _v2_context(
            layout, n, class_probs, dev, algo, use_star)

    onehot_t = match = None
    if _sym_zone(n_pad, p, n_states):
        with span("discrete.layout", device=dev):
            hot = _build_onehot(cpad, ft, n_states)
        with span("discrete.pass1", device=dev):
            match = _match_matrix_sym(hot, ti)
        del hot   # freed before the transposed one-hot is built
        with span("discrete.layout", device=dev):
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
    """(v2 layout or None, TI, FT) of a fit on ``device``: a ``ti`` given
    wins, else :func:`_block_rows` of the JAX package's TI."""
    ti0, ft0 = _discrete_tile_sizes(n, p, n_states)
    ti = _gemm_size(ti or _block_rows(n, ti0, device), device)
    layout = _v2_layout(np.asarray(y), n, ti, algo, class_probs)
    if ft is None and layout is not None:
        ft = _discrete_tile_sizes(layout[4], p, n_states)[1]
    return layout, ti, _gemm_size(ft or ft0, device)


def _stages_packed(layout, n, p, ft, device) -> bool:
    """Whether host codes go to ``device`` packed (JAX's staging choice)."""
    return layout is not None and _past_sort_budget(n, p, device) and p >= ft


def discrete_tier(n, p, n_states, y, algo, class_probs=None,
                  device="cpu", ti=None, source="host") -> str:
    """The tier, 'v1', 'v2', 'v2-sym', 'v2-gather' or 'v2-promote', that
    :func:`relief_discrete_scores` takes for these arguments, with codes
    given as ``source``: 'host' (a numpy array), 'tensor' (an int8 tensor
    on ``device``) or 'packed' (a :class:`PackedCodes`)."""
    device = torch.device(device)
    layout, _, ft = _tiles_and_layout(n, p, n_states, y, algo, class_probs,
                                      device, ti)
    if layout is None:
        return "v1"
    bits = 0
    if source == "packed" or (source == "host" and _stages_packed(
            layout, n, p, ft, device)):
        bits = _pack_bits(n_states)
    route = _v2_route(n, p, ft, device, 8 // bits if bits else 0)
    if route != "resident":
        return f"v2-{route}"
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
    a numpy array, copied once to ``device`` (default CPU) through the
    process's stager: as int8, or packed (:func:`stage_codes_packed`)
    where v2 applies past the sort budget; or a tensor, or a
    :class:`PackedCodes` (``n_states`` given), scored on its own device.
    Without codes, X (numpy or tensor) is encoded on ``device`` (default:
    X's own).  ``ti``/``ft`` override the focal-block and feature-tile
    sizes.  The counter ``padded_rows`` adds the padded samples, n_pad - n.
    """
    n, p = (x if codes is None else codes).shape
    y = np.asarray(y)
    host = codes is not None and not isinstance(codes, (torch.Tensor,
                                                        PackedCodes))
    if codes is None:
        with phase("relief_discrete.encode", work=n * p):
            codes, n_unique, _ = encode_columns(_float_tensor(x, device))
        n_states = int(n_unique.max())
    elif isinstance(codes, PackedCodes):
        codes.check_live()
        if n_states is None:
            raise ValueError("packed codes need n_states")
    elif host:
        codes = torch.from_numpy(np.asarray(codes, np.int8))
    if isinstance(codes, torch.Tensor):
        codes, n_states = int8_codes(codes, n_states)
    dev = (codes.packed.device if isinstance(codes, PackedCodes)
           else torch.device(device or "cpu") if host else codes.device)
    layout, ti, ft = _tiles_and_layout(n, p, n_states, y, algo, class_probs,
                                       dev, ti, ft)
    if host:   # through the stager, packed or as they are
        with phase("relief_discrete.h2d", work=n * p):
            codes = (stage_codes_packed(codes, n_states, dev)
                     if _stages_packed(layout, n, p, ft, dev)
                     else staging.to_device(codes.numpy(), dev))

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
            count("padded_rows", layout[4] - n)
            return (scores[:p].to(torch.float32) / float(n)).cpu().numpy()
    if isinstance(codes, PackedCodes):
        codes = _codes_window(codes.packed, 0, codes.p_eff, codes.bits)[:, :p]
    cpad, yv, valid, _ = pack_discrete(codes, y, n_states, ti=ti, ft=ft)
    with phase(f"relief_discrete.engine[{algo}]", work=float(n) * n * p):
        scores = relief_discrete_core(
            cpad, yv, valid, 0, cpad, yv, valid,
            torch.tensor(float(n), dtype=torch.float32, device=dev),
            torch.as_tensor(np.asarray(class_probs, np.float32), device=dev),
            algo=algo, use_star=use_star, k=int(n_neighbors), ti=ti, ft=ft,
            n_states=n_states)
        count("padded_rows", cpad.shape[0] - n)
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
