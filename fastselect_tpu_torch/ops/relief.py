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

The passes live in ``relief_cuda.py``; this module holds the rules, which
are plain tensor code on D's device.  Every rule returns a list of
``(boolean mask (T, n), per-row coefficient (T,))`` terms with
``W = sum_k r_k[:, None] * M_k``.  Statistics stay in float32, as in the
JAX engines: promoting them would move thresholds and flip near masks.
"""

from __future__ import annotations

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


def _topk_weight_rows(D_masked, k, n_pad):
    """One-hot weight rows for the k smallest entries of each masked row.

    ``lax.top_k`` takes the lower index first among equal values and
    ``torch.topk`` promises no order among ties, so a stable sort picks
    the same k entries as the JAX engines on tied rows.
    """
    vals, idx = torch.sort(D_masked, dim=1, stable=True)
    vals, idx = vals[:, :k], idx[:, :k]
    sel = (vals < _INF / 2).to(torch.float32)   # finite -> selected
    W = torch.zeros((D_masked.shape[0], n_pad), dtype=torch.float32,
                    device=D_masked.device)
    W.scatter_(1, idx, sel)
    return W, sel.sum(dim=1)


def _rules_relieff(D, yi, vi, iid, y_flat, valid_flat, k, class_probs):
    """Class-prior-weighted k-NN rule: the reference CPU semantics
    (ReliefF.py:137-220), NOT the simpler GPU variant."""
    n_pad = D.shape[1]
    n_classes = class_probs.shape[0]
    vmask, hit = _pair_masks(D, yi, vi, iid, y_flat, valid_flat)

    # k nearest hits at weight -1/h_found
    Dh = torch.where(hit & vmask, D, _INF)
    W_hit, h_found = _topk_weight_rows(Dh, k, n_pad)
    hit_norm = torch.where(h_found > 0,
                           1.0 / torch.clamp_min(h_found, 1.0), 0.0)
    rules = [(W_hit > 0, -hit_norm)]

    # k nearest misses per class at weight P(c) / (1 - P(y_i)) / k
    denom = 1.0 - class_probs[yi]
    denom = torch.where(denom == 0, 1.0, denom)
    for c in range(n_classes):
        cand = (y_flat[None, :] == c) & vmask & (yi != c)[:, None]
        Dc = torch.where(cand, D, _INF)
        W_c, _ = _topk_weight_rows(Dc, k, n_pad)
        # times float32(1/k): XLA turns the JAX engine's division by the
        # constant k into this product, and W matches it bit for bit
        w_c = (class_probs[c] / denom) * (np.float32(1) / np.float32(k))
        rules.append((W_c > 0, w_c.expand_as(hit_norm)))
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
) -> np.ndarray:
    """Relief-family importance scores (already divided by n_samples).

    Every input goes to the fused engine of ``relief_cuda.py``: on a CUDA
    device it runs the hand-written kernels, on the CPU their plain
    PyTorch versions.
    """
    from .relief_cuda import relief_fused_scores
    return relief_fused_scores(
        x, y, recip, is_discrete, algo=algo, use_star=use_star,
        n_neighbors=n_neighbors, class_probs=class_probs, device=device)
