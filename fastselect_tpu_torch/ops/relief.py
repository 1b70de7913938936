"""Per-algorithm pair weights for the Relief family, and the score entry point.

Counterpart of the weight rules of ``fastselect_tpu/ops/relief.py``.  The
engine makes two passes over the data with weights in between:

  pass 1:  distance rows  D[i, j] = sum_f diff(i, j, f)
           where diff is Hamming for discrete features and range-scaled L1
           for continuous ones (reference ``MultiSURF.py:37-40``).
  weights: an (i, j) weight matrix W derived from D per algorithm:
             * MultiSURF:  near = D < mu_i - sigma_i/2; hits get -1/n_hit,
               misses +1/n_miss; MultiSURF* adds far misses at -1/n_miss
               (reference ``MultiSURF.py:193-251``).
             * SURF: near = D < mean_i; +/-1 weights; SURF* adds far hits at
               +1 and far misses at -1 (reference ``SURF.py:131-195``).
             * ReliefF (CPU semantics): k nearest hits at -1/h_found, k
               nearest misses PER CLASS at P(c)/(1-P(y_i))/k
               (reference ``ReliefF.py:137-220``).
  pass 2:  scores[f] = sum_ij W[i, j] * diff(i, j, f)

The passes live in ``relief_cuda.py`` (any data), ``relief_discrete.py``
(all-discrete data) and ``relief_hybrid.py`` (mixed data, both halves);
this module holds the rules, which are plain tensor code on D's device,
and the routing between the engines.  Every rule returns a list of
``(boolean mask (T, n), per-row coefficient (T,))`` terms with
``W = sum_k r_k[:, None] * M_k``.  Statistics stay in float32, as in the
JAX engines: promoting them would move thresholds and flip near masks.
"""

from __future__ import annotations

import os

import numpy as np
import torch

_INF = 3.0e38


def _pair_masks(D, yi, vi, iid, y_flat, valid_flat):
    jid = torch.arange(D.shape[1], device=D.device)
    not_self = jid[None, :] != iid[:, None]
    vmask = (valid_flat[None, :] > 0) & (vi[:, None] > 0) & not_self
    hit = y_flat[None, :] == yi[:, None]
    return vmask, hit


def _row_mean_stats(D, vmask, n_real):
    """Masked D, per-row mean over the n_real - 1 other samples, and
    1 / (n_real - 1), all float32."""
    Dm = torch.where(vmask, D, 0.0)
    denom = 1.0 / (n_real - 1.0)
    mu = Dm.sum(dim=1) * denom
    return Dm, mu, denom


def _rules_multisurf(D, yi, vi, iid, y_flat, valid_flat, n_real, use_star):
    """mu - sigma/2 adaptive threshold (reference MultiSURF.py:193-251)."""
    vmask, hit = _pair_masks(D, yi, vi, iid, y_flat, valid_flat)
    Dm, mu, denom = _row_mean_stats(D, vmask, n_real)
    sum_d2 = (Dm * Dm).sum(dim=1)
    del Dm
    var = torch.clamp_min(sum_d2 * denom - mu * mu, 0.0)
    thresh = mu - 0.5 * torch.sqrt(var)

    near = (D < thresh[:, None]) & vmask
    near_hit = near & hit
    near_miss = near & ~hit
    n_hit = near_hit.sum(dim=1).to(torch.float32)
    n_miss = near_miss.sum(dim=1).to(torch.float32)
    w_hit = -1.0 / torch.clamp_min(n_hit, 1.0)
    w_miss = 1.0 / torch.clamp_min(n_miss, 1.0)

    rules = [(near_hit, w_hit), (near_miss, w_miss)]
    if use_star:
        far_miss = vmask & ~near & ~hit
        rules.append((far_miss, -w_miss))
    return rules


def _rules_surf(D, yi, vi, iid, y_flat, valid_flat, n_real, use_star):
    """Mean-distance threshold, unit weights (reference SURF.py:131-195)."""
    vmask, hit = _pair_masks(D, yi, vi, iid, y_flat, valid_flat)
    _, mu, _ = _row_mean_stats(D, vmask, n_real)
    near = (D < mu[:, None]) & vmask
    ones = torch.ones(D.shape[0], dtype=torch.float32, device=D.device)
    rules = [(near & ~hit, ones), (near & hit, -ones)]
    if use_star:
        far = vmask & ~near
        rules.append((far & hit, ones))
        rules.append((far & ~hit, -ones))
    return rules


def _sum_rules(rules):
    """Dense pairwise weight matrix from (mask, row-coefficient) terms,
    summed in rule order as the JAX engines do."""
    mask0 = rules[0][0]
    W = torch.zeros(mask0.shape, dtype=torch.float32, device=mask0.device)
    for mask, r in rules:
        W.add_(torch.where(mask, r[:, None], 0.0))
    return W


def _rules_relieff(D, yi, vi, iid, y_flat, valid_flat, k, class_probs):
    """Class-prior-weighted k-NN rule: the reference CPU semantics
    (ReliefF.py:137-220), NOT the simpler GPU variant.

    One stable sort of each masked row, shared by the hit rule and every
    class rule, as in the reference's single ``np.argsort(dists)`` walk
    (``ReliefF.py:157-174``) and JAX's ``_rules_relieff_argsort``: an
    entry's rank among the hits, or within its class, is a cumulative
    count in sorted order, and the picks go back to the original order by
    one scatter through the sort's permutation.  The stable sort breaks
    ties by the lower index, as ``lax.top_k`` does, so W equals that of
    JAX's default rule (a ``top_k`` of each rule's masked row) bit for
    bit; ``FS_RELIEFF_ARGSORT``, which picks between JAX's two rules, has
    nothing to pick here.
    """
    n_classes = class_probs.shape[0]
    vmask, _ = _pair_masks(D, yi, vi, iid, y_flat, valid_flat)
    sidx = torch.sort(torch.where(vmask, D, _INF), dim=1, stable=True)[1]
    # labels in sorted order; -2, which no label equals (padding is -1),
    # where the pair is masked out
    y_s = torch.where(vmask.gather(1, sidx), y_flat.to(torch.int32)[sidx],
                      -2)
    del vmask

    def first_k(member):
        """The first k members of each row in sorted order, and the
        number of members."""
        rank = torch.cumsum(member, dim=1, dtype=torch.int32)
        return member & (rank <= k), rank[:, -1]

    # pick_s: c + 1 on class c's k nearest, -1 on the k nearest hits (a
    # hit's own class is no miss class), 0 elsewhere
    pick_s = torch.zeros_like(y_s)
    for c in range(n_classes):
        pick_s.masked_fill_(first_k(y_s == c)[0], c + 1)
    hits, n_hit = first_k(y_s == yi.to(torch.int32)[:, None])
    pick_s.masked_fill_(hits, -1)
    del y_s, hits
    pick = torch.zeros_like(pick_s).scatter_(1, sidx, pick_s)
    del pick_s, sidx

    # k nearest hits at weight -1/h_found; the hits are the focal row's
    # label, also one past class_probs (the op-level default of one dummy
    # class)
    h_found = n_hit.clamp(max=k).to(torch.float32)
    hit_norm = torch.where(h_found > 0,
                           1.0 / torch.clamp_min(h_found, 1.0), 0.0)
    rules = [(pick == -1, -hit_norm)]

    # k nearest misses per class at weight P(c) / (1 - P(y_i)) / k;
    # labels past class_probs read its last entry, as JAX's clamped
    # gather does
    denom = 1.0 - class_probs[yi.clamp(max=n_classes - 1)]
    denom = torch.where(denom == 0, 1.0, denom)
    for c in range(n_classes):
        # times float32(1/k): XLA turns the JAX engine's division by the
        # constant k into this product, and W matches it bit for bit
        w_c = (class_probs[c] / denom) * (np.float32(1) / np.float32(k))
        rules.append(((pick == c + 1) & (yi != c)[:, None],
                      w_c.expand_as(hit_norm)))
    return rules


def pair_weight_rules(D, yi, vi, iid, y_flat, valid_flat, n_real,
                      class_probs, *, algo, use_star, k):
    """Algorithm dispatch: (mask, row-coeff) decomposition of W for one
    focal block's distance rows D (T, n).

    ``iid`` holds the block's global row ids, so a sample is never its own
    neighbour; ``n_real`` is a float32 scalar tensor with the true n.
    """
    if algo == "multisurf":
        return _rules_multisurf(D, yi, vi, iid, y_flat, valid_flat,
                                n_real, use_star)
    if algo == "surf":
        return _rules_surf(D, yi, vi, iid, y_flat, valid_flat,
                           n_real, use_star)
    if algo == "relieff":
        return _rules_relieff(D, yi, vi, iid, y_flat, valid_flat,
                              k, class_probs)
    raise ValueError(f"unknown Relief algorithm {algo!r}")


def relief_engine_core(x_f, yv_f, valid_f, row0, x_a, yv_a, valid_a,
                       recip, disc, n_real, class_probs, *, algo, use_star,
                       k, nb, n_disc=0, pass1=None, pass2=None):
    """Unnormalised scores (p_pad,) float32 contributed by the focal rows
    ``x_f`` against all rows ``x_a``, on their device.

    ``row0`` is the global row id of x_f's first row: the sharded layer
    passes each shard's contiguous focal rows with their offset, a single
    device all rows with 0.  Every block of ``nb`` focal rows runs pass 1
    against all rows, the weight rules with its global row ids, then pass
    2; block scores are added in block order.  The first ``n_disc``
    columns (a multiple of 4) are the discrete ones.  ``pass1`` and
    ``pass2`` default to the kernel wrappers of ``relief_cuda.py``
    (:func:`~.relief_cuda.dist_matrix`, :func:`~.relief_cuda.accumulate`).
    Counterpart of JAX's ``relief_engine_core``.
    """
    if pass1 is None or pass2 is None:
        from .relief_cuda import accumulate, dist_matrix
        pass1, pass2 = pass1 or dist_matrix, pass2 or accumulate
    mixed = n_disc > 0
    dev = x_a.device
    scores = torch.zeros(x_a.shape[1], dtype=torch.float32, device=dev)
    for b0 in range(0, x_f.shape[0], nb):
        xi = x_f[b0:b0 + nb]
        iid = torch.arange(row0 + b0, row0 + b0 + xi.shape[0], device=dev)
        W = _sum_rules(pair_weight_rules(
            pass1(x_a, recip, disc, xi=xi, mixed=mixed),
            yv_f[b0:b0 + nb], valid_f[b0:b0 + nb], iid, yv_a, valid_a,
            n_real, class_probs, algo=algo, use_star=use_star, k=k))
        scores += pass2(x_a, W, recip, disc, xi=xi, mixed=mixed,
                        n_disc=n_disc)
    return scores


# Automatic multi-device routing, at the JAX package's values: below this
# element count a fit stays on one device; a code matrix of more bytes
# than _RING_BYTES takes the ring layout (X never replicated).  Both were
# sized for a 16 GB TPU chip and wait for an H100 measurement.
_AUTO_SHARD_MIN_ELEMS = 1 << 21
_RING_BYTES = 4 << 30


def _mesh_devices(device) -> list:
    """The mesh of the automatic multi-device routes for a fit on
    ``device``: in a process group of more than one process, the group's
    mesh (``parallel.make_mesh()``: every process's devices, even one
    each) when its devices are of ``device``'s type; else every visible
    CUDA device when ``device`` is a CUDA device; none otherwise, and none
    under ``FS_NO_AUTO_SHARD=1``."""
    if device is None or os.environ.get("FS_NO_AUTO_SHARD") == "1":
        return []
    kind = torch.device(device).type
    from ..parallel import distributed
    if distributed.is_multihost():
        from ..parallel.sharded import make_mesh
        mesh = make_mesh()
        return mesh if all(d.type == kind for d in mesh) else []
    if kind != "cuda":
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _sharded_dispatch(x, y, recip, is_discrete, devs, *, algo, use_star,
                      n_neighbors, class_probs, codes, n_states):
    """Pick a sharded layout from (n, p): all-discrete data takes the
    sample shard (codes on every device), the feature shard when p >> n
    (the GWAS layout), or the ring when the codes are too large to hold
    on every device; any other data takes the sample shard of the fused
    engine.  Across processes every process must pass the same X and y:
    ``check_same_inputs`` raises on every process otherwise."""
    from ..parallel.sharded import check_same_inputs, home, make_mesh
    data = x if codes is None else codes
    check_same_inputs(make_mesh(devs), data, y)
    n, p = data.shape
    kw = dict(algo=algo, use_star=use_star, n_neighbors=n_neighbors,
              class_probs=class_probs, devices=devs)
    if relief_engine(n, is_discrete, n_states) != "discrete":
        from ..parallel.sharded import sharded_relief_scores
        return sharded_relief_scores(x, y, recip, is_discrete, **kw)
    if codes is None:
        from ..utils.preprocessing import encode_columns
        codes, n_unique, _ = encode_columns(torch.as_tensor(x).to(
            home(make_mesh(devs)), torch.float32))
        n_states = int(n_unique.max())
    kw["n_states"] = n_states or None
    if n * p > _RING_BYTES:
        from ..parallel.ring import ring_relief_discrete_scores
        return ring_relief_discrete_scores(codes, y, **kw)
    if p >= 4 * n and p >= 4096:
        from ..parallel.feature_shard import (
            feature_sharded_relief_discrete_scores)
        return feature_sharded_relief_discrete_scores(codes, y, **kw)
    from ..parallel.sharded import sharded_relief_discrete_scores
    return sharded_relief_discrete_scores(codes, y, **kw)


def relief_engine(n: int, is_discrete, n_states: int = 0) -> str:
    """The engine :func:`relief_scores` takes: ``'discrete'``, ``'hybrid'``
    or ``'fused'``, from the shape and the state count alone.

    ``n_states`` is the largest cardinality of a discrete column (0: not
    known yet; the engine then encodes the columns and raises above
    ``MAX_STATES``)."""
    from ..utils.preprocessing import MAX_STATES
    from .relief_hybrid import HYBRID_MAX_N
    disc = torch.as_tensor(is_discrete)
    if n_states > MAX_STATES or not bool(disc.any()):
        return "fused"
    if bool(disc.all()):
        return "discrete"
    return "hybrid" if n <= HYBRID_MAX_N else "fused"


def relief_scores(
    x,
    y: np.ndarray,
    recip,
    is_discrete,
    *,
    algo: str,
    use_star: bool = False,
    n_neighbors: int = 0,
    class_probs: np.ndarray | None = None,
    device: torch.device | None = None,
    codes=None,
    n_states: int = 0,
    from_host: bool | None = None,
) -> np.ndarray:
    """Relief-family importance scores (already divided by n_samples).

    Data that came from the host (``from_host``; by default, X or codes
    not a tensor) with at least ``_AUTO_SHARD_MIN_ELEMS`` values and at
    least 16 samples a device takes a sharded layout of ``parallel/`` when
    :func:`_mesh_devices` finds more than one device: the estimators'
    ``fit`` on a host array does, a fit on a tensor never does.

    All-discrete data goes to the int8 one-hot GEMM engine of
    ``relief_discrete.py``, scored from ``codes`` when given (X may then be
    None) or from X encoded there; so does JAX's ``relief_scores``.  Mixed
    data with at most ``MAX_STATES`` states in a discrete column and at
    most ``HYBRID_MAX_N`` samples goes to the hybrid engine of
    ``relief_hybrid.py``, on every device.  Anything else goes to the
    fused engine of ``relief_cuda.py``.  The engines run the hand-written
    kernels on a CUDA device and their plain PyTorch versions on the CPU.
    """
    data = x if codes is None else codes
    n, p = data.shape
    if from_host is None:
        from_host = not isinstance(data, torch.Tensor)
    if from_host and n * p >= _AUTO_SHARD_MIN_ELEMS:
        devs = _mesh_devices(device)
        if len(devs) > 1 and n >= 16 * len(devs):
            return _sharded_dispatch(
                x, y, recip, is_discrete, devs, algo=algo, use_star=use_star,
                n_neighbors=n_neighbors, class_probs=class_probs,
                codes=codes, n_states=n_states)
    engine = relief_engine(n, is_discrete, n_states)
    kw = dict(algo=algo, use_star=use_star, n_neighbors=n_neighbors,
              class_probs=class_probs, device=device)
    if engine == "discrete":
        from .relief_discrete import relief_discrete_scores
        return relief_discrete_scores(
            x if codes is None else None, y, codes=codes,
            n_states=n_states or None, **kw)
    if engine == "hybrid":
        from .relief_hybrid import relief_hybrid_scores
        return relief_hybrid_scores(x, y, recip, is_discrete, codes=codes,
                                    n_states=n_states or None, **kw)
    from .relief_cuda import relief_fused_scores
    return relief_fused_scores(x, y, recip, is_discrete, **kw)
