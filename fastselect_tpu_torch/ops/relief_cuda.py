"""Fused two-pass Relief engine on hand-written CUDA kernels.

Counterpart of ``fastselect_tpu/ops/relief_pallas.py``.  The Pallas
kernels of that module become the Hopper kernels of ``csrc/``:

  pass 1  ``relief_pass1.cu``  D[i, j] = sum_f diff(i, j, f), for a focal
          block of rows against all samples (``_dist_kernel`` and
          ``_dist_kernel_cont``);
  pass 2  ``relief_pass2.cu``  scores[f] = sum_ij W[i, j] * diff(i, j, f)
          (``_accum_kernel`` and ``_accum_kernel_cont``).

``MIXED`` kernels apply Hamming distance to the discrete columns; the
continuous ones skip the per-feature select.  Between the passes the pair
weights W come from D by the rules of ``relief.pair_weight_rules``.

Each wrapper (:func:`dist_matrix`, :func:`accumulate`) launches its kernel
for a CUDA tensor, or raises: it never falls back.  For a CPU tensor it
runs its plain PyTorch twin (:func:`dist_matrix_ref`,
:func:`accumulate_ref`), which is also the reference the kernels are held
to on the card.  ``launches`` counts the kernel launches by name.

Focal rows stream in blocks of ``nb`` rows so that only (nb, n) distance
and weight blocks exist at a time; ``nb`` is sized from the device's free
memory.  The square case is the single block ``nb == n_pad``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from .relief import _sum_rules, pair_weight_rules

# Samples pad to the pass-1 tile (kBI == kBJ in relief_pass1.cu), features
# to its feature chunk (kBF); padded rows and features weigh nothing.
TILE_ROWS = 64
TILE_FEATURES = 32
_PASS2_ROWS = 32   # focal rows per pass-2 block (kIT in relief_pass2.cu)

# Bytes per (focal row, sample) pair a block needs at its peak: D and W,
# plus the rules' float32 and bool temporaries (_rules_multisurf holds
# about six (nb, n_pad) arrays), with headroom.
_BYTES_PER_PAIR = 32
# ReliefF's rules hold more: each of their C + 1 stable sorts keeps float32
# values and int64 indices (12 B a pair) and the sort's own scratch beside
# D, the masked copy of D and a one-hot weight block.
_RELIEFF_BYTES_PER_PAIR = 64
# Share of the device's free memory a focal block may take.
_FREE_MEM_FRACTION = 0.8
# Focal-block budget on the CPU, where the pair arrays live in host memory.
_CPU_BLOCK_BYTES = 1 << 30
# Elements of the (features, rows, samples) diff temporaries of the plain
# versions.
_REF_CHUNK_ELEMS = 1 << 26

launches = {"relief_pass1_cont": 0, "relief_pass1_mixed": 0,
            "relief_pass2_cont": 0, "relief_pass2_mixed": 0}


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0


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


def dist_matrix_ref(xp, recip, disc, xi=None, *, mixed):
    """Plain version of :func:`dist_matrix`.

    Features are added one at a time in order, with separately rounded
    multiply and add, exactly as each thread of ``relief_pass1.cu`` does,
    so the kernel's D equals this one bit for bit."""
    xi = xp if xi is None else xi
    nb, n, p = xi.shape[0], xp.shape[0], xp.shape[1]
    D = torch.zeros((nb, n), dtype=torch.float32, device=xp.device)
    xiT, xpT = xi.t(), xp.t()
    fc = _feature_chunk(nb, n)
    for f0 in range(0, p, fc):
        f1 = min(p, f0 + fc)
        val = _diff_chunk(xiT[f0:f1], xpT[f0:f1], recip[f0:f1],
                          disc[f0:f1], mixed)
        for q in range(f1 - f0):
            D.add_(val[q])
    return D


def accumulate_ref(xp, W, recip, disc, xi=None, *, mixed):
    """Plain version of :func:`accumulate`: (p,) float32."""
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

def _check_inputs(xp, xi, recip, disc, W=None):
    """Raise unless every input is a contiguous float32 tensor of the
    expected shape on one device; returns (nb, n, p)."""
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
    return nb, n, p


def dist_matrix(xp, recip, disc, xi=None, *, mixed):
    """Pass 1: distance rows D (nb, n) of focal rows ``xi`` (nb, p) against
    all samples ``xp`` (n, p); square (``xi = xp``) by default.

    ``mixed=False`` selects the all-continuous kernel (``disc`` is ignored).
    """
    xi = xp if xi is None else xi
    nb, n, p = _check_inputs(xp, xi, recip, disc)
    if xp.device.type == "cpu":
        return dist_matrix_ref(xp, recip, disc, xi, mixed=mixed)
    lib = _build.load()
    D = torch.empty((nb, n), dtype=torch.float32, device=xp.device)
    with torch.cuda.device(xp.device):
        err = lib.fs_relief_pass1(
            xi.data_ptr(), xp.data_ptr(), recip.data_ptr(), disc.data_ptr(),
            D.data_ptr(), nb, n, p, int(mixed),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "relief_pass1")
    launches["relief_pass1_mixed" if mixed else "relief_pass1_cont"] += 1
    return D


def accumulate(xp, W, recip, disc, xi=None, *, mixed):
    """Pass 2: per-feature scores (p,) from pair weights ``W`` (nb, n) of
    focal rows ``xi`` (default ``xp``) against all samples ``xp``.

    The kernel writes one partial row per 32 focal rows; they are summed
    here in a fixed order, so the result is the same from run to run.
    """
    xi = xp if xi is None else xi
    nb, n, p = _check_inputs(xp, xi, recip, disc, W)
    if xp.device.type == "cpu":
        return accumulate_ref(xp, W, recip, disc, xi, mixed=mixed)
    lib = _build.load()
    partial = torch.empty((-(-nb // _PASS2_ROWS), p), dtype=torch.float32,
                          device=xp.device)
    with torch.cuda.device(xp.device):
        err = lib.fs_relief_pass2(
            xi.data_ptr(), xp.data_ptr(), W.data_ptr(), recip.data_ptr(),
            disc.data_ptr(), partial.data_ptr(), nb, n, p, int(mixed),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "relief_pass2")
    launches["relief_pass2_mixed" if mixed else "relief_pass2_cont"] += 1
    return partial.sum(dim=0)


# ---------------------------------------------------------------------------
# Sizing
# ---------------------------------------------------------------------------

def _round_up(v: int, m: int) -> int:
    return ((v + m - 1) // m) * m


def _focal_block_rows(n_pad: int, ti: int, budget_bytes: int,
                      bytes_per_pair: int = _BYTES_PER_PAIR) -> int:
    """Focal block rows nb: the largest multiple of ti that divides n_pad
    (a multiple of ti) and whose pair arrays fit ``budget_bytes``.

    The JAX engine's rule (``relief_pallas._focal_block_rows``) with the
    budget taken from the device.  That rule minimises padded work first,
    so it only ever picks block sizes that divide the sample axis."""
    if n_pad * n_pad * bytes_per_pair <= budget_bytes:
        return n_pad
    m = n_pad // ti
    cap = max(1, budget_bytes // (bytes_per_pair * n_pad * ti))
    return ti * max(d for d in range(1, min(cap, m) + 1) if m % d == 0)


def _block_budget_bytes(device: torch.device) -> int:
    """Bytes a focal block may use: a share of the memory PyTorch could
    still allocate on ``device`` (free on the card plus its own cache)."""
    if device.type != "cuda":
        return _CPU_BLOCK_BYTES
    free, _ = torch.cuda.mem_get_info(device)
    cached = (torch.cuda.memory_reserved(device)
              - torch.cuda.memory_allocated(device))
    return int((free + cached) * _FREE_MEM_FRACTION)


class BlockPlan(NamedTuple):
    n_pad: int   # padded samples, a multiple of nb
    p_pad: int   # padded features
    nb: int      # focal rows per block


def block_plan(n: int, p: int, device: torch.device,
               algo: str = "multisurf") -> BlockPlan:
    """Padded shape and focal block rows for an (n, p) fit of ``algo`` on
    ``device``."""
    n_pad = _round_up(max(n, 1), TILE_ROWS)
    p_pad = _round_up(max(p, 1), TILE_FEATURES)
    per_pair = (_RELIEFF_BYTES_PER_PAIR if algo == "relieff"
                else _BYTES_PER_PAIR)
    nb = _focal_block_rows(n_pad, TILE_ROWS, _block_budget_bytes(device),
                           per_pair)
    return BlockPlan(n_pad, p_pad, nb)


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

def _fused_engine(xp, yv, valid, recip, disc, n_real, class_probs, *,
                  algo, use_star, k, nb, mixed, pass1, pass2):
    """Unnormalised scores (p_pad,): every focal block of nb rows runs
    pass 1 against all samples, the weight rules with its global row ids,
    then pass 2; block scores are added in block order."""
    n_pad = xp.shape[0]
    scores = torch.zeros(xp.shape[1], dtype=torch.float32, device=xp.device)
    for b0 in range(0, n_pad, nb):
        xi = xp[b0:b0 + nb]
        iid = torch.arange(b0, b0 + nb, device=xp.device)
        W = _sum_rules(pair_weight_rules(
            pass1(xp, recip, disc, xi=xi, mixed=mixed),
            yv[b0:b0 + nb], valid[b0:b0 + nb], iid, yv, valid, n_real,
            class_probs, algo=algo, use_star=use_star, k=k))
        scores += pass2(xp, W, recip, disc, xi=xi, mixed=mixed)
    return scores


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
) -> np.ndarray:
    """Relief-family scores through the fused engine, divided by n.

    ``x`` is a tensor (scored on its own device) or an array (copied to
    ``device``, default CPU).  ``_pass1`` and ``_pass2`` replace the passes
    for a reference run of the same engine; the default is the kernel
    wrappers.
    """
    if not isinstance(x, torch.Tensor):
        x = torch.tensor(np.asarray(x), dtype=torch.float32)
    device = torch.device(x.device if device is None else device)
    n, p = x.shape
    plan = block_plan(n, p, device, algo)

    xp = torch.zeros((plan.n_pad, plan.p_pad), dtype=torch.float32,
                     device=device)
    xp[:n, :p] = x
    yv = torch.full((plan.n_pad,), -1, dtype=torch.int64, device=device)
    yv[:n] = torch.as_tensor(np.asarray(y, np.int64), device=device)
    valid = torch.zeros(plan.n_pad, dtype=torch.float32, device=device)
    valid[:n] = 1.0
    recip2 = torch.zeros(plan.p_pad, dtype=torch.float32, device=device)
    recip2[:p] = torch.as_tensor(recip, device=device)
    disc = torch.as_tensor(is_discrete, device=device)
    disc2 = torch.zeros(plan.p_pad, dtype=torch.float32, device=device)
    disc2[:p] = disc.to(torch.float32)
    if class_probs is None:
        class_probs = np.zeros((1,), np.float32)
    cp = torch.as_tensor(np.asarray(class_probs, np.float32), device=device)
    n_real = torch.tensor(n, dtype=torch.float32, device=device)

    scores = _fused_engine(
        xp, yv, valid, recip2, disc2, n_real, cp,
        algo=algo, use_star=use_star, k=int(n_neighbors), nb=plan.nb,
        mixed=bool(disc.any()), pass1=_pass1, pass2=_pass2)
    return (scores[:p] / n_real).cpu().numpy()
