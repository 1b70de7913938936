"""Relief-family engine for mixed discrete and continuous data.

Counterpart of ``fastselect_tpu/ops/relief_hybrid.py``.  Mixed tabular
data (genotypes beside continuous covariates) has Hamming diffs on its
discrete columns and range-scaled L1 diffs on its continuous ones
(reference ``MultiSURF.py:37-40``), so the distance splits as

    D = D_continuous + D_discrete,   D_discrete = p_d_pad - match

and each half runs where it is cheapest: the continuous columns through
the fused engine's continuous kernels (``relief_cuda.dist_matrix`` and
``accumulate`` with ``mixed=False``), the discrete columns as exact int8
one-hot products (``relief_discrete``).  The pair weights W come once from
the combined D by ``relief.pair_weight_rules``; each half then scores its
own columns, and the scores go back to column order.

Two paths, chosen by the JAX package's gates so that a shape takes the
same one in both packages:

  square   n <= HYBRID_SQUARE_MAX_N: one (n_pad, n_pad) block.  With the
           v2 layout (``relief_discrete._v2_layout``) the rows are
           stable-sorted by class and the discrete pass 2 contracts each
           rule over its class segment only (``_accumulate_plan``);
  blocked  larger n: focal blocks of ``nb`` rows stream against all
           samples (v1 discrete pass 2), ``nb`` sized from the device's
           free memory as ``relief_cuda.block_plan`` sizes it.

Above ``HYBRID_MAX_N`` samples ``relief.relief_scores`` sends mixed data
to the fused engine's ``MIXED`` kernels instead.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils.preprocessing import MAX_STATES, encode_columns
from . import relief_cuda as rc
from . import relief_discrete as rd
from .relief import _sum_rules, pair_weight_rules

# The JAX package's gates.  The square path holds D, W and the rules for
# all n^2 pairs at once (about 32 B a pair): 24576 rows was sized for a
# 16 GB TPU, and an 80 GB card could take a larger square.
HYBRID_SQUARE_MAX_N = 24576
HYBRID_MAX_N = 131072

# Bytes per (focal row, sample) pair of a focal block beyond the fused
# engine's: the int32 match counts, their int32 and float32 differences,
# and the int8 rule operands of the discrete pass 2.
_EXTRA_BYTES_PER_PAIR = 16


class HybridPlan(NamedTuple):
    n_pad: int     # padded samples: a multiple of the pass-1 tile and of nb
    p_c_pad: int   # padded continuous features
    p_d_pad: int   # padded discrete features, a multiple of ftd
    ftd: int       # discrete feature tile
    nb: int        # focal rows per block (n_pad on the square path)


def hybrid_plan(n: int, p_c: int, p_d: int, n_states: int,
                device: torch.device, algo: str = "multisurf") -> HybridPlan:
    """Padded shapes and focal block rows of an (n, p_c + p_d) fit.

    The sample axis pads to the pass-1 tile (64 rows), which also meets
    the int8 GEMM's rule (multiples of 16)."""
    n_pad = rc._round_up(max(n, 1), rc.TILE_ROWS)
    nb = (n_pad if n <= HYBRID_SQUARE_MAX_N else rc.focal_block_rows(
        n_pad, device, algo, extra_bytes=_EXTRA_BYTES_PER_PAIR))
    ftd = rd._gemm_size(
        rd._discrete_tile_sizes(n_pad, max(p_d, 1), n_states)[1], device)
    return HybridPlan(n_pad, rc._round_up(max(p_c, 1), rc.TILE_FEATURES),
                      rc._round_up(max(p_d, 1), ftd), ftd, nb)


def _pad_rows(t, rows):
    """``t`` with zero (False) rows appended up to ``rows`` rows."""
    if t.shape[0] == rows:
        return t
    out = t.new_zeros((rows,) + tuple(t.shape[1:]))
    out[:t.shape[0]] = t
    return out


def _distances(xc, recip2, disc2, ci, codes_d, xi, ftd, n_states):
    """Combined D (nb, n_pad): the continuous kernel's D plus the discrete
    mismatch count, added as float32 after the kernel as the JAX engine
    adds them (a sum in another order would move the near thresholds)."""
    D = rc.dist_matrix(xc, recip2, disc2, xi=xi, mixed=False)
    mismatch = codes_d.shape[1] - rd._match_rows(ci, codes_d, ftd, n_states)
    return D.add_(mismatch.to(torch.float32))


def _square_scores(xc, codes_d, yv, valid, recip2, disc2, n_real, cp,
                   segments, plans, *, algo, use_star, k, ftd, n_states):
    """(continuous (p_c_pad,), discrete (p_d_pad,)) scores of the single
    square block; with class-sorted rows (``plans`` per class position)
    the discrete pass 2 runs each class's rows over its segments."""
    n_pad = xc.shape[0]
    dev = xc.device
    D = _distances(xc, recip2, disc2, codes_d, codes_d, None, ftd, n_states)
    rules = pair_weight_rules(
        D, yv, valid, torch.arange(n_pad, device=dev), yv, valid, n_real,
        cp, algo=algo, use_star=use_star, k=k)
    del D
    if plans is None:
        s_d = rd._accumulate_discrete(codes_d, codes_d, rules, ftd,
                                      n_states)
    else:
        segs_all = list(segments) + [(0, n_pad)]
        s_d = torch.zeros(codes_d.shape[1], dtype=torch.float32, device=dev)
        for pos, plan in enumerate(plans):
            s0, sl = segments[pos]
            # a class's focal rows, padded as the GEMM takes them
            rows = rd._gemm_size(sl, dev)
            ci = _pad_rows(codes_d[s0:s0 + sl], rows)
            rules_c = [(_pad_rows(m[s0:s0 + sl], rows),
                        _pad_rows(r[s0:s0 + sl], rows)) for m, r in rules]
            s_d += rd._accumulate_plan(ci, codes_d, rules_c, plan, segs_all,
                                       ftd, n_states, use_star)
    W = _sum_rules(rules)
    del rules
    s_c = rc.accumulate(xc, W, recip2, disc2, mixed=False)
    return s_c, s_d


def _blocked_scores(xc, codes_d, yv, valid, recip2, disc2, n_real, cp,
                    *, algo, use_star, k, ftd, n_states, nb):
    """(continuous, discrete) scores summed over focal blocks of nb rows
    in block order, with the v1 discrete pass 2."""
    n_pad = xc.shape[0]
    dev = xc.device
    s_c = torch.zeros(xc.shape[1], dtype=torch.float32, device=dev)
    s_d = torch.zeros(codes_d.shape[1], dtype=torch.float32, device=dev)
    for b0 in range(0, n_pad, nb):
        rows = slice(b0, b0 + nb)
        xi, ci = xc[rows], codes_d[rows]
        D = _distances(xc, recip2, disc2, ci, codes_d, xi, ftd, n_states)
        rules = pair_weight_rules(
            D, yv[rows], valid[rows], torch.arange(b0, b0 + nb, device=dev),
            yv, valid, n_real, cp, algo=algo, use_star=use_star, k=k)
        del D
        s_d += rd._accumulate_discrete(ci, codes_d, rules, ftd, n_states)
        W = _sum_rules(rules)
        del rules
        s_c += rc.accumulate(xc, W, recip2, disc2, xi=xi, mixed=False)
    return s_c, s_d


def relief_hybrid_scores(
    x,
    y,
    recip,
    is_discrete,
    *,
    algo: str,
    use_star: bool = False,
    n_neighbors: int = 0,
    class_probs: np.ndarray | None = None,
    device: torch.device | str | None = None,
    codes=None,
    n_states: int | None = None,
) -> np.ndarray:
    """Mixed-data Relief scores, divided by n_samples.

    ``x`` is a tensor (scored on its own device unless ``device`` is
    given) or an array (copied to ``device``, default CPU).  ``codes`` may
    carry state codes for the full matrix (``analyze_features`` makes
    them); only its discrete columns are read.  Without codes the
    discrete columns are encoded here.
    """
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x, np.float32))
    dev = torch.device(x.device if device is None else device)
    n, p = x.shape
    disc = np.asarray(torch.as_tensor(is_discrete).cpu(), bool)
    d_idx = torch.as_tensor(np.flatnonzero(disc), device=dev)
    c_idx = torch.as_tensor(np.flatnonzero(~disc), device=dev)
    p_d, p_c = d_idx.numel(), c_idx.numel()

    if codes is None:
        codes_d, n_unique, _ = encode_columns(
            x.to(device=dev, dtype=torch.float32).index_select(1, d_idx))
        n_states = int(n_unique.max()) if p_d else 1
    else:
        codes_d = torch.as_tensor(codes).to(dev).index_select(1, d_idx)
        if n_states is None:
            n_states = int(codes_d.max()) + 1 if p_d else 1
    n_states = max(int(n_states), 1)
    if n_states > MAX_STATES:
        raise ValueError(f"{n_states} states in a discrete column: int8 "
                         f"state codes hold at most {MAX_STATES}")

    y = np.asarray(y)
    # class-sorted rows on the square path: its discrete pass 2 then
    # contracts each rule over its class segment (scores do not depend on
    # the row order); the blocked path keeps v1, whose focal blocks would
    # straddle class boundaries
    layout = (None if n > HYBRID_SQUARE_MAX_N
              else rd._v2_layout(y, n, 8, algo, class_probs))
    rows = torch.arange(n, device=dev)
    segments = plans = None
    if layout is not None:
        classes, perm, segments, _, _ = layout
        rows = torch.as_tensor(perm, device=dev)
        y = y[perm]
        cls_t = tuple(int(c) for c in classes)
        plans = [rd._plan_segments(algo, use_star, cls_t, pos)
                 for pos in range(len(classes))]

    plan = hybrid_plan(n, p_c, p_d, n_states, dev, algo)
    xc = torch.zeros((plan.n_pad, plan.p_c_pad), dtype=torch.float32,
                     device=dev)
    xc[:n, :p_c] = x.to(dev)[rows[:, None], c_idx[None, :]]
    cd = torch.zeros((plan.n_pad, plan.p_d_pad), dtype=torch.int8,
                     device=dev)
    cd[:n, :p_d] = codes_d.to(torch.int8)[rows]
    del codes_d
    yv = torch.full((plan.n_pad,), -1, dtype=torch.int64, device=dev)
    yv[:n] = torch.as_tensor(y.astype(np.int64), device=dev)
    valid = torch.zeros(plan.n_pad, dtype=torch.float32, device=dev)
    valid[:n] = 1.0
    recip_t = torch.as_tensor(recip).to(device=dev, dtype=torch.float32)
    recip2 = torch.zeros(plan.p_c_pad, dtype=torch.float32, device=dev)
    recip2[:p_c] = recip_t[c_idx]
    disc2 = torch.zeros(plan.p_c_pad, dtype=torch.float32, device=dev)
    if class_probs is None:
        class_probs = np.zeros((1,), np.float32)
    cp = torch.as_tensor(np.asarray(class_probs, np.float32), device=dev)
    n_real = torch.tensor(float(n), dtype=torch.float32, device=dev)

    kw = dict(algo=algo, use_star=use_star, k=int(n_neighbors),
              ftd=plan.ftd, n_states=n_states)
    if plan.nb == plan.n_pad:
        s_c, s_d = _square_scores(xc, cd, yv, valid, recip2, disc2, n_real,
                                  cp, segments, plans, **kw)
    else:
        s_c, s_d = _blocked_scores(xc, cd, yv, valid, recip2, disc2, n_real,
                                   cp, nb=plan.nb, **kw)
    scores = torch.empty(p, dtype=torch.float32, device=dev)
    scores[c_idx] = s_c[:p_c]
    scores[d_idx] = s_d[:p_d]
    return (scores / n_real).cpu().numpy()
