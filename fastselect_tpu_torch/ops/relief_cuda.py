"""Fused two-pass Relief engine on hand-written CUDA kernels.

Counterpart of ``fastselect_tpu/ops/relief_pallas.py``.  The Pallas
kernels of that module become the Hopper kernels of ``csrc/``:

  pass 1  D[i, j] = sum_f diff(i, j, f), for a focal block of rows against
          all samples: ``relief_pass1.cu`` (``_dist_kernel_cont`` and
          ``_dist_kernel``);
  pass 2  scores[f] = sum_ij W[i, j] * diff(i, j, f): ``relief_pass2.cu``
          (``_accum_kernel_cont`` and ``_accum_kernel``).

One body per pass serves both kinds.  The ``MIXED`` instance applies
Hamming distance to the discrete columns and reads a column's kind once
for every float4 group; the fused engine orders its columns by kind
(:func:`feature_positions`), so that a group, a pass-1 step and a pass-2
block are each of one kind.  The kernels take rows that are 16-byte
aligned (p a multiple of 4, and n too in pass 2), so every engine pads
features to ``TILE_FEATURES``.  Between the passes the pair weights W
come from D by the fit's weight rule (``relief.weight_rule``): the rule
kernels on the card, the rules of ``relief.pair_weight_rules`` on the
CPU.  Where p >> n pass 1 sums feature ranges apart, in float64, and D
is float64.

Each wrapper (:func:`dist_matrix`, :func:`accumulate`) launches its kernel
for a CUDA tensor, or raises: it never falls back.  For a CPU tensor it
runs its plain PyTorch twin (:func:`dist_matrix_ref`,
:func:`accumulate_ref`), which is also the reference the kernels are held
to on the card.  ``_build.launches`` counts the kernel launches by name.

Focal rows stream in blocks of ``nb`` rows so that only (nb, n) distance
and weight blocks exist at a time; ``nb`` is sized from the device's free
memory.  The square case is the single block ``nb == n_pad``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from ..utils.logging import count, phase, span
from .relief import relief_engine_core

# Samples pad to 64 rows, which meets the hybrid engine's int8 GEMMs
# (multiples of 16; the kernels mask ragged rows themselves),
# features to the kernels' 16-byte vector width; padded rows and features
# weigh nothing.
TILE_ROWS = 64
TILE_FEATURES = 4

# Pass 1 (relief_pass1.cu): a block tile of kTile x kTile pairs.  When
# the tiles cannot fill the card (p >> n), the features split
# into ranges summed apart, so that the blocks reach _PASS1_TARGET_BLOCKS
# (two resident blocks on each of the H100's 132 SMs), each range holding
# at least _PASS1_MIN_SPLIT features (a multiple of 4): below that, writing
# and re-reading a partial D costs more than its features' arithmetic.
_PASS1_TILE = 128
_PASS1_TARGET_BLOCKS = 264
_PASS1_MIN_SPLIT = 128
# Pass 2 (relief_pass2.cu): a thread holds 8 focal rows of one float4
# feature group; a block is at most 32 groups by 32 row groups and 256
# threads.  Sample spans of at least _PASS2_MIN_SPAN samples (a
# multiple of the 64-sample stage) are added when the focal and feature
# tiles give fewer than _PASS2_TARGET_BLOCKS blocks (four waves of two
# resident blocks on 132 SMs).
_PASS2_ROWS_PER_THREAD = 8
_PASS2_MAX_GROUPS = 32
_PASS2_MAX_ROW_GROUPS = 32
_PASS2_MAX_THREADS = 256
_PASS2_STAGE = 64
_PASS2_MIN_SPAN = 1024
_PASS2_TARGET_BLOCKS = 1056

# Block-size rules: the nominal bytes a (focal row, sample) pair of a
# focal block by which :func:`focal_block_rows` sizes the blocks of a
# MultiSURF or SURF fit and of a ReliefF fit; not what a pair holds.  On
# the card the fused engine's rule kernels, the mesh's fused sample shard
# included, hold W beside D and nothing else a pair, 8 B (12 where p >> n
# gives a float64 D; a ReliefF fit at large-n peaked at 8.3 B a pair, X
# and the scores included).  The chain of PyTorch rules, which the CPU
# and the discrete and hybrid engines keep (the ring, feature-shard and
# discrete mesh layouts among them), holds about six (nb, n_pad) float32
# and bool temporaries besides.  The blocks set the order of the float32
# score sums, so these rules fix the scores' bits: at large-n (50,048
# samples) they give 2 MultiSURF blocks of 25,024 rows and 17 ReliefF
# blocks of 2,944 rows.
_THRESHOLD_BLOCK_RULE = 32
_RELIEFF_BLOCK_RULE = 64
# Share of the device's free memory a focal block may take.
_FREE_MEM_FRACTION = 0.8
# Focal-block budget on the CPU, where the pair arrays live in host memory.
_CPU_BLOCK_BYTES = 1 << 30
# Elements of the (features, rows, samples) diff temporaries of the plain
# versions.
_REF_CHUNK_ELEMS = 1 << 26


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def pass1_splits(nb: int, n: int, p: int) -> list[tuple[int, int]]:
    """Feature ranges [f0, f1) that pass 1 (either kind) sums apart, in
    order, for focal rows nb, samples n and features p (a multiple of 4).

    From the shape alone, never the device, so the plain version on the
    CPU takes the same ranges as the kernel.  One range unless the
    (nb, n) tile grid leaves the card short of blocks and p is large."""
    tiles = _cdiv(nb, _PASS1_TILE) * _cdiv(n, _PASS1_TILE)
    count = max(1, min(_PASS1_TARGET_BLOCKS // tiles, p // _PASS1_MIN_SPLIT))
    width = _round_up(_cdiv(p, count), 4)
    return [(f0, min(p, f0 + width)) for f0 in range(0, p, width)]


class Pass2Plan(NamedTuple):
    groups: int   # float4 feature groups per block
    rows: int     # row groups per block (groups * rows threads)
    spans: int    # sample spans
    span: int     # samples per span (the last one ragged)

    @property
    def focal_rows(self) -> int:   # focal rows per block
        return _PASS2_ROWS_PER_THREAD * self.rows


def pass2_plan(nb: int, n: int, p: int, n_disc: int = 0) -> Pass2Plan:
    """Block shape and sample spans of pass 2 for focal rows nb, samples n
    and features p whose first n_disc form the discrete run (both
    multiples of 4), from the shape alone.

    The kernel tiles the run [0, n_disc) in tiles of 4 * groups features,
    then the run [n_disc, p), so that no tile straddles the two.  Tiles are
    balanced within a run, so that a p of 100 runs as one tile of 25
    groups (250 threads) rather than 32 groups with 7 idle; with two runs
    a block is as wide as the wider run's tile."""
    runs = [g for g in (n_disc // 4, (p - n_disc) // 4) if g]
    groups = max(_cdiv(g, _cdiv(g, _PASS2_MAX_GROUPS)) for g in runs)
    rows = min(_PASS2_MAX_THREADS // groups, _PASS2_MAX_ROW_GROUPS)
    ftiles = sum(_cdiv(g, groups) for g in runs)
    blocks = ftiles * _cdiv(nb, _PASS2_ROWS_PER_THREAD * rows)
    spans = max(1, min(_cdiv(_PASS2_TARGET_BLOCKS, blocks),
                       n // _PASS2_MIN_SPAN))
    span = _round_up(_cdiv(n, spans), _PASS2_STAGE)
    return Pass2Plan(groups, rows, _cdiv(n, span), span)


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def _diff_chunk(xiT, xpT, recip, disc, mixed):
    """diff(i, j, f) for a feature chunk: (fc, nb, n) float32.

    xiT (fc, nb), xpT (fc, n) are the chunk's columns."""
    d = xiT[:, :, None] - xpT[:, None, :]
    val = d.abs().mul_(recip[:, None, None])
    if mixed:
        val = torch.where(disc[:, None, None] > 0,
                          (d != 0).to(torch.float32), val)
    return val


def _feature_chunk(nb: int, n: int) -> int:
    return max(1, _REF_CHUNK_ELEMS // max(1, nb * n))


def _dist_sum(xiT, xpT, recip, disc, f0, f1, mixed, dtype=torch.float32):
    """sum over features f0..f1-1 of diff(i, j, f), added in order from
    0.0 with separately rounded multiply and add: (nb, n) of ``dtype``
    (float32 diffs, added in ``dtype``)."""
    nb, n = xiT.shape[1], xpT.shape[1]
    D = torch.zeros((nb, n), dtype=dtype, device=xpT.device)
    fc = _feature_chunk(nb, n)
    for c0 in range(f0, f1, fc):
        c1 = min(f1, c0 + fc)
        val = _diff_chunk(xiT[c0:c1], xpT[c0:c1], recip[c0:c1],
                          disc[c0:c1], mixed)
        for q in range(c1 - c0):
            D.add_(val[q])
    return D


def dist_dtype(nb: int, n: int, p: int) -> torch.dtype:
    """D's dtype for focal rows nb, samples n and features p: float64
    where pass 1 sums several feature ranges apart (p >> n, where D
    reaches 1e5 and float32's step of 0.0078 there moves MultiSURF's near
    masks), float32 otherwise."""
    return torch.float64 if len(pass1_splits(nb, n, p)) > 1 \
        else torch.float32


def dist_matrix_ref(xp, recip, disc, xi=None, *, mixed):
    """Plain version of :func:`dist_matrix`.

    Each feature range of the kernel's plan (:func:`pass1_splits`) is
    summed from 0.0 in feature order, then the ranges are added in order,
    exactly as the kernels do, so the kernel's D equals this one bit for
    bit.  With several ranges the sums and D are float64
    (:func:`dist_dtype`)."""
    xi = xp if xi is None else xi
    nb, n, p = xi.shape[0], xp.shape[0], xp.shape[1]
    xiT, xpT = xi.t(), xp.t()
    splits = pass1_splits(nb, n, p)
    dtype = dist_dtype(nb, n, p)
    D = _dist_sum(xiT, xpT, recip, disc, *splits[0], mixed, dtype)
    for f0, f1 in splits[1:]:
        D.add_(_dist_sum(xiT, xpT, recip, disc, f0, f1, mixed, dtype))
    return D


def accumulate_ref(xp, W, recip, disc, xi=None, *, mixed, n_disc=0):
    """Plain version of :func:`accumulate`: (p,) float32.  ``n_disc``
    places the kernel's feature tiles; these sums take no plan."""
    xi = xp if xi is None else xi
    nb, n, p = xi.shape[0], xp.shape[0], xp.shape[1]
    s = torch.empty(p, dtype=torch.float32, device=xp.device)
    xiT, xpT = xi.t(), xp.t()
    fc = _feature_chunk(nb, n)
    for f0 in range(0, p, fc):
        f1 = min(p, f0 + fc)
        val = _diff_chunk(xiT[f0:f1], xpT[f0:f1], recip[f0:f1],
                          disc[f0:f1], mixed)
        s[f0:f1] = (val * W[None]).sum(dim=(1, 2))
    return s


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check_inputs(xp, xi, recip, disc, W=None, *, mixed):
    """Raise unless every input is a contiguous float32 tensor of the
    expected shape on one device, with rows 16-byte aligned for the
    kernels; returns (nb, n, p)."""
    named = {"xp": xp, "xi": xi, "recip": recip, "disc": disc}
    if W is not None:
        named["W"] = W
    for name, t in named.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != xp.device:
            raise ValueError(f"{name} is on {t.device}, xp on {xp.device}")
    if xp.dim() != 2 or xi.dim() != 2 or xi.shape[1] != xp.shape[1]:
        raise ValueError(f"xp (n, p) and xi (nb, p) expected, got "
                         f"{tuple(xp.shape)} and {tuple(xi.shape)}")
    nb, (n, p) = xi.shape[0], xp.shape
    if recip.shape != (p,) or disc.shape != (p,):
        raise ValueError(f"recip and disc must have shape ({p},)")
    if W is not None and W.shape != (nb, n):
        raise ValueError(f"W must have shape ({nb}, {n}), got "
                         f"{tuple(W.shape)}")
    if nb == 0 or n == 0 or p == 0:
        raise ValueError("empty input")
    if xp.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {xp.device}")
    rows = ([xp, xi, recip] + ([disc] if mixed else [])
            + ([W] if W is not None else []))
    if (p % 4 or (W is not None and n % 4)
            or any(t.data_ptr() % 16 for t in rows)):
        raise ValueError(
            f"the kernels take 16-byte aligned rows (p, and n for W, "
            f"multiples of 4, data 16-byte aligned); got nb, n, p = {nb}, "
            f"{n}, {p}: pad features to TILE_FEATURES")
    return nb, n, p


def dist_matrix(xp, recip, disc, xi=None, *, mixed):
    """Pass 1: distance rows D (nb, n) of focal rows ``xi`` (nb, p) against
    all samples ``xp`` (n, p); square (``xi = xp``) by default.

    ``mixed=False`` selects the all-continuous kernel (``disc`` is
    ignored).  Either kernel sums the feature ranges of
    :func:`pass1_splits` apart and then in order, in float64 where there
    are several (D is then float64: :func:`dist_dtype`).  Counter
    ``pass1_ranges`` adds up the ranges.
    """
    xi = xp if xi is None else xi
    nb, n, p = _check_inputs(xp, xi, recip, disc, mixed=mixed)
    splits = pass1_splits(nb, n, p)
    count("pass1_ranges", len(splits))
    if xp.device.type == "cpu":
        return dist_matrix_ref(xp, recip, disc, xi, mixed=mixed)
    dtype = dist_dtype(nb, n, p)
    D = torch.empty((nb, n), dtype=dtype, device=xp.device)
    part = (torch.empty((len(splits), nb, n), dtype=dtype,
                        device=xp.device) if len(splits) > 1 else None)
    _build.launch(
        "relief_pass1_mixed" if mixed else "relief_pass1_cont", xp.device,
        xi.data_ptr(), xp.data_ptr(), recip.data_ptr(),
        *((disc.data_ptr(),) if mixed else ()), D.data_ptr(),
        0 if part is None else part.data_ptr(), nb, n, p, splits[0][1],
        len(splits))
    return D


def accumulate(xp, W, recip, disc, xi=None, *, mixed, n_disc=0):
    """Pass 2: per-feature scores (p,) from pair weights ``W`` (nb, n) of
    focal rows ``xi`` (default ``xp``) against all samples ``xp``.

    ``n_disc`` (a multiple of 4, ``mixed`` only) says that the discrete
    columns are the first n_disc: the plan then keeps every block inside
    one kind.  It places blocks only, since the kernel reads each column's
    kind from ``disc``, so any ``disc`` is scored right.  The kernel writes
    one partial row per focal tile and sample span of :func:`pass2_plan`;
    they are summed here in a fixed order, so the result is the same from
    run to run.
    """
    xi = xp if xi is None else xi
    nb, n, p = _check_inputs(xp, xi, recip, disc, W, mixed=mixed)
    if n_disc % 4 or not 0 <= n_disc <= p or (n_disc and not mixed):
        raise ValueError(f"n_disc must be a multiple of 4 in [0, {p}] and 0 "
                         f"for the continuous kernel, got {n_disc}")
    if xp.device.type == "cpu":
        return accumulate_ref(xp, W, recip, disc, xi, mixed=mixed)
    plan = pass2_plan(nb, n, p, n_disc)
    partial = torch.empty((_cdiv(nb, plan.focal_rows) * plan.spans, p),
                          dtype=torch.float32, device=xp.device)
    _build.launch(
        "relief_pass2_mixed" if mixed else "relief_pass2_cont", xp.device,
        xi.data_ptr(), xp.data_ptr(), W.data_ptr(), recip.data_ptr(),
        *((disc.data_ptr(),) if mixed else ()), partial.data_ptr(), nb, n, p,
        *((n_disc,) if mixed else ()), plan.groups, plan.rows, plan.span)
    return partial.sum(dim=0)


# ---------------------------------------------------------------------------
# Sizing
# ---------------------------------------------------------------------------

def _round_up(v: int, m: int) -> int:
    return ((v + m - 1) // m) * m


def _block_budget_bytes(device: torch.device, sharers: int = 1) -> int:
    """Bytes a focal block may use: a share of the memory PyTorch could
    still allocate on ``device`` (free on the card plus its own cache),
    divided among the ``sharers`` processes whose shards sit on it."""
    if device.type != "cuda":
        return _CPU_BLOCK_BYTES // sharers
    count("mem_get_info")
    free, _ = torch.cuda.mem_get_info(device)
    cached = (torch.cuda.memory_reserved(device)
              - torch.cuda.memory_allocated(device))
    return int((free + cached) * _FREE_MEM_FRACTION) // sharers


def focal_block_rows(n_pad: int, device: torch.device, algo: str, *,
                     n_focal: int | None = None, sharers: int = 1,
                     extra_bytes: int = 0) -> int:
    """Focal block rows nb of an ``algo`` fit of n_pad samples on
    ``device``: the largest multiple of ``TILE_ROWS`` that divides the
    focal rows ``n_focal`` (default n_pad; a multiple of TILE_ROWS) and
    whose pairs against all n_pad samples fit the block budget of the
    ``sharers`` processes on the device (:func:`_block_budget_bytes`) at
    the algorithm's block-size rule plus ``extra_bytes`` a pair.

    The JAX engine's rule (``relief_pallas._focal_block_rows``) with the
    budget taken from the device.  That rule minimises padded work first,
    so it only ever picks block sizes that divide the focal axis.  The
    fused engine (:func:`block_plan`), the hybrid engine's blocked path
    and the mesh's fused sample shard all size their blocks here."""
    per_pair = extra_bytes + (_RELIEFF_BLOCK_RULE if algo == "relieff"
                              else _THRESHOLD_BLOCK_RULE)
    budget = _block_budget_bytes(device, sharers)
    n_focal = n_pad if n_focal is None else n_focal
    if n_focal * n_pad * per_pair <= budget:
        return n_focal
    m = n_focal // TILE_ROWS
    cap = max(1, budget // (per_pair * n_pad * TILE_ROWS))
    return TILE_ROWS * max(d for d in range(1, min(cap, m) + 1) if m % d == 0)


class BlockPlan(NamedTuple):
    n_pad: int   # padded samples, a multiple of nb
    p_pad: int   # padded features
    nb: int      # focal rows per block


def padded_features(p: int, n_disc: int = 0) -> int:
    """Padded features of an (n, p) fit with ``n_disc`` discrete columns:
    the discrete and the continuous run each pad to ``TILE_FEATURES``
    (:func:`feature_positions`)."""
    return max(TILE_FEATURES, _round_up(n_disc, TILE_FEATURES)
               + _round_up(p - n_disc, TILE_FEATURES))


def block_plan(n: int, p: int, device: torch.device,
               algo: str = "multisurf", *, n_disc: int = 0) -> BlockPlan:
    """Padded shape and focal block rows for an (n, p) fit of ``algo`` on
    ``device`` with ``n_disc`` discrete columns: the discrete and the
    continuous run each pad to ``TILE_FEATURES`` (:func:`feature_positions`)."""
    n_pad = _round_up(max(n, 1), TILE_ROWS)
    p_pad = padded_features(p, n_disc)
    return BlockPlan(n_pad, p_pad, focal_block_rows(n_pad, device, algo))


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

def feature_positions(is_discrete: np.ndarray) -> np.ndarray:
    """The padded column of each input column in the fused engine's layout:
    the discrete columns first, then the continuous ones, each run in
    column order and padded with zero columns to ``TILE_FEATURES``, so
    that every float4 group of the kernels is of one kind.  Per-feature
    scores do not depend on the column order."""
    disc = np.asarray(is_discrete, bool)
    d_run = _round_up(int(disc.sum()), TILE_FEATURES)
    return np.where(disc, np.cumsum(disc) - 1, d_run + np.cumsum(~disc) - 1)


class FusedLayout(NamedTuple):
    """The fused engine's operands on one device (:func:`stage_fused`)."""
    xp: torch.Tensor           # (n_pad, p_pad) float32, columns by kind
    yv: torch.Tensor           # (n_pad,) int64 labels, -1 past n
    valid: torch.Tensor        # (n_pad,) float32, 0 past n
    recip: torch.Tensor        # (p_pad,) float32
    disc: torch.Tensor         # (p_pad,) float32, 1 on the discrete run
    class_probs: torch.Tensor  # (C,) float32
    n_real: torch.Tensor       # float32 scalar, n
    pos: torch.Tensor          # (p,) padded column of each input column
    n_disc: int                # the padded discrete run

    def to(self, device: torch.device) -> "FusedLayout":
        """The same operands on ``device`` (no copy on their own)."""
        return FusedLayout(*(t.to(device, non_blocking=True)
                             if isinstance(t, torch.Tensor) else t
                             for t in self))


def stage_fused(x, y, recip, disc, class_probs, device, n_pad: int,
                p_pad: int) -> FusedLayout:
    """X (a tensor) and its labels, ranges and kinds (``disc`` a numpy bool
    array) padded to (n_pad, p_pad) in the layout of
    :func:`feature_positions`, on ``device``."""
    n, p = x.shape
    d_run = _round_up(int(disc.sum()), TILE_FEATURES)   # padded run
    # with no discrete column the layout is X's own column order
    pos = (torch.as_tensor(feature_positions(disc), device=device) if d_run
           else torch.arange(p, device=device))
    xp = torch.zeros((n_pad, p_pad), dtype=torch.float32, device=device)
    xp[:n].index_copy_(1, pos, x.to(device=device, dtype=torch.float32))
    yv = torch.full((n_pad,), -1, dtype=torch.int64, device=device)
    yv[:n] = torch.as_tensor(np.asarray(y, np.int64), device=device)
    valid = torch.zeros(n_pad, dtype=torch.float32, device=device)
    valid[:n] = 1.0
    recip2 = torch.zeros(p_pad, dtype=torch.float32, device=device)
    recip2.index_copy_(0, pos, torch.as_tensor(recip).to(
        device=device, dtype=torch.float32))
    # the discrete run's zero pad columns are discrete too: they never
    # differ, and keep every float4 group of the run one kind
    disc2 = torch.zeros(p_pad, dtype=torch.float32, device=device)
    disc2[:d_run] = 1.0
    if class_probs is None:
        class_probs = np.zeros((1,), np.float32)
    cp = torch.as_tensor(np.asarray(class_probs, np.float32), device=device)
    n_real = torch.tensor(n, dtype=torch.float32, device=device)
    return FusedLayout(xp, yv, valid, recip2, disc2, cp, n_real, pos, d_run)


def relief_fused_scores(
    x,
    y,
    recip,
    is_discrete,
    *,
    algo: str,
    use_star: bool = False,
    n_neighbors: int = 0,
    class_probs: np.ndarray | None = None,
    device: torch.device | None = None,
    _pass1=dist_matrix,
    _pass2=accumulate,
    _rule=None,
) -> np.ndarray:
    """Relief-family scores through the fused engine, divided by n.

    ``x`` is a tensor (scored on its own device) or an array (copied to
    ``device``, default CPU).  ``_pass1``, ``_pass2`` and ``_rule`` replace
    the passes and the weight rule for a reference run of the same engine
    (``relief_engine_core``'s ``pass1``, ``pass2`` and ``rule``); the
    default is the kernel wrappers.
    """
    if not isinstance(x, torch.Tensor):
        x = torch.tensor(np.asarray(x), dtype=torch.float32)
    device = torch.device(x.device if device is None else device)
    n, p = x.shape
    disc = np.asarray(torch.as_tensor(is_discrete).cpu(), bool)
    with span("fused.plan"):
        plan = block_plan(n, p, device, algo, n_disc=int(disc.sum()))
        fl = stage_fused(x, y, recip, disc, class_probs, device, plan.n_pad,
                         plan.p_pad)
    with phase(f"relief_cuda.engine[{algo}]", work=float(n) * n * p):
        scores = relief_engine_core(
            fl.xp, fl.yv, fl.valid, 0, fl.xp, fl.yv, fl.valid, fl.recip,
            fl.disc, fl.n_real, fl.class_probs, algo=algo, use_star=use_star,
            k=int(n_neighbors), nb=plan.nb, n_disc=fl.n_disc, pass1=_pass1,
            pass2=_pass2, rule=_rule)
        return (scores.index_select(0, fl.pos) / fl.n_real).cpu().numpy()
