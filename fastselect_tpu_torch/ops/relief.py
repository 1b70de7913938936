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
and the routing between the engines.  The fused engine takes its rule
from :func:`weight_rule`, once a fit: on the card W comes from
hand-written kernels instead, ReliefF's from one launch
(:func:`relieff_weights`, ``csrc/relieff_select.cu``), equal to its
rule's bit for bit, MultiSURF's and SURF's from two
(:func:`threshold_weights`, ``csrc/threshold_rule.cu``), equal to theirs
but where a pair lies within an ulp or so of the threshold.  Every rule
returns a list of ``(boolean mask (T, n), per-row coefficient (T,))``
terms with ``W = sum_k r_k[:, None] * M_k``.

MultiSURF's and SURF's row statistics are taken in D's dtype (float32;
float64 where pass 1 sums feature ranges apart, p >> n), of D less a
per-row shift (a distance of the row), and the near masks compare the
shifted D with the shifted threshold.  The JAX engines take
``E[D^2] - mu^2`` of D itself in float32, which at D ~ 1e5 (100 x
500,000) keeps about one digit of sigma^2 and puts the threshold off by
units; shifted, the variance cancels no more than a bit, and the
threshold is rounded at the scale of sigma rather than of D.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import _build
from ..utils.logging import count, span

_INF = 3.0e38


def _pair_masks(D, yi, vi, iid, y_flat, valid_flat):
    jid = torch.arange(D.shape[1], device=D.device)
    not_self = jid[None, :] != iid[:, None]
    vmask = (valid_flat[None, :] > 0) & (vi[:, None] > 0) & not_self
    hit = y_flat[None, :] == yi[:, None]
    return vmask, hit


def _row_shift(D, iid, valid_flat):
    """Each focal row's D at its first valid other sample (T,): the
    shift of :func:`_row_mean_stats`.  Any other valid sample of the row
    would do; none syncs the device."""
    valid = valid_flat > 0
    first = torch.argmax(valid.to(torch.uint8))
    second = torch.argmax((valid & (torch.arange(
        valid.shape[0], device=D.device) != first)).to(torch.uint8))
    j = torch.where(iid == first, second, first)
    return D.gather(1, j[:, None])[:, 0]


def _row_mean_stats(D, vmask, n_real, shift):
    """Statistics of the shifted distances, in D's dtype: (Dm, the
    masked D - shift (T, n), 0 where masked; mu, its per-row mean over the
    n_real - 1 other samples; 1 / (n_real - 1)).  The row mean of D is
    ``mu + shift``."""
    Dm = torch.where(vmask, D, shift[:, None]).sub_(shift[:, None])
    denom = 1.0 / (n_real.to(D.dtype) - 1.0)
    mu = Dm.sum(dim=1) * denom
    return Dm, mu, denom


def _rules_multisurf(D, yi, vi, iid, y_flat, valid_flat, n_real, use_star):
    """mu - sigma/2 adaptive threshold (reference MultiSURF.py:193-251).

    The statistics are taken of D less a per-row shift, a distance of the
    row itself, so that sigma^2 = E[Dm^2] - mu^2 cancels no more than a
    bit, and the near mask compares the shifted D with the shifted
    threshold: D - shift is exact where D lies within a factor of two of
    the shift, and the threshold is rounded at the scale of sigma rather
    than of D."""
    vmask, hit = _pair_masks(D, yi, vi, iid, y_flat, valid_flat)
    with span("weight_rules.stats", device=D.device):
        Dm, mu, denom = _row_mean_stats(D, vmask, n_real,
                                        _row_shift(D, iid, valid_flat))
        sum_d2 = torch.linalg.vector_norm(Dm, dim=1).square_()
        var = torch.clamp_min(sum_d2 * denom - mu * mu, 0.0)
        thresh = mu - 0.5 * torch.sqrt(var)

    near = (Dm < thresh[:, None]) & vmask
    del Dm
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
    with span("weight_rules.stats", device=D.device):
        Dm, mu, _ = _row_mean_stats(D, vmask, n_real,
                                    _row_shift(D, iid, valid_flat))
    near = (Dm < mu[:, None]) & vmask
    del Dm
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

    hit_norm, w = _relieff_coefficients(n_hit, yi, k, class_probs)
    rules = [(pick == -1, -hit_norm)]
    for c in range(n_classes):
        rules.append(((pick == c + 1) & (yi != c)[:, None], w[:, c]))
    return rules


def _relieff_coefficients(n_hit, yi, k, class_probs):
    """ReliefF's row coefficients from each focal row's number of hits
    ``n_hit``: (hit_norm (T,), w (T, C)) float32.  The k nearest hits
    weigh -hit_norm = -1/h_found; the hits are the focal row's label, also
    one past class_probs (the op-level default of one dummy class).  The k
    nearest misses of class c weigh w[:, c] = P(c) / (1 - P(y_i)) / k;
    labels past class_probs read its last entry, as JAX's clamped gather
    does."""
    n_classes = class_probs.shape[0]
    h_found = n_hit.clamp(max=k).to(torch.float32)
    hit_norm = torch.where(h_found > 0,
                           1.0 / torch.clamp_min(h_found, 1.0), 0.0)
    denom = 1.0 - class_probs[yi.clamp(max=n_classes - 1)]
    denom = torch.where(denom == 0, 1.0, denom)
    # times float32(1/k): XLA turns the JAX engine's division by the
    # constant k into this product, and W matches it bit for bit
    w = (class_probs[None, :] / denom[:, None]) * (
        np.float32(1) / np.float32(k))
    return hit_norm, w


# A sample that is no one's neighbour (padding) in the kernel's labels
_NO_LABEL = -(1 << 31)


def sample_labels(y_flat, valid_flat):
    """The samples' labels as the rule kernels read them: (n,) int32, with
    ``_NO_LABEL`` where the sample is invalid."""
    return torch.where(valid_flat > 0, y_flat, _NO_LABEL).to(torch.int32)


def relieff_labels(y_flat, valid_flat):
    """The per-fit half of ``csrc/relieff_select.cu``'s operands: (lab (n,)
    int32 of :func:`sample_labels`; lab sorted, from which each focal
    row's hits are counted).  The engine makes them once a fit and hands
    them to every focal block's :func:`relieff_weights`."""
    lab = sample_labels(y_flat, valid_flat)
    return lab, torch.sort(lab)[0]


def _relieff_select_operands(D, yi, vi, iid, labels, k, class_probs):
    """What ``csrc/relieff_select.cu`` reads beside D, on D's device:
    (lab (n,) int32 of :func:`relieff_labels`; yi (T,) int32; vals (T,
    C + 1) float32, the value W takes on a pick of each slot: class c's
    miss weight in slot c, the hit weight in the focal row's own label's
    slot (slot C for a label past class_probs)).

    The row coefficients are :func:`_rules_relieff`'s, from the same
    :func:`_relieff_coefficients`; each value is 0.0 plus its coefficient,
    as :func:`_sum_rules` adds it to a zero W, so the kernel's W equals
    the plain version's bit for bit.  A focal row's hits are counted in
    the sorted labels (no (T, n) pass): the valid samples of its label,
    less itself."""
    n, n_classes = D.shape[1], class_probs.shape[0]
    lab, ordered = labels
    y32 = yi.to(torch.int32)
    n_lab = (torch.searchsorted(ordered, y32, right=True)
             - torch.searchsorted(ordered, y32))
    own = (iid < n) & (lab[iid.clamp(max=n - 1)] == y32)
    n_hit = torch.where(vi > 0, n_lab - own.to(n_lab.dtype), 0)
    hit_norm, w = _relieff_coefficients(n_hit, yi, k, class_probs)
    coef = torch.cat([w, torch.zeros_like(w[:, :1])], dim=1)
    own_slot = torch.where((yi >= 0) & (yi < n_classes), yi, n_classes)
    coef.scatter_(1, own_slot[:, None], -hit_norm[:, None])
    return lab, y32.contiguous(), torch.zeros_like(coef) + coef


def relieff_weights(D, yi, vi, iid, y_flat, valid_flat, k, class_probs,
                    labels=None):
    """ReliefF's pair weights W (T, n) float32 of one focal block on the
    card: ``_sum_rules(_rules_relieff(...))``, bit for bit.

    One launch of ``csrc/relieff_select.cu`` selects each label's k
    nearest members of every row and writes W from a float32 CUDA D (no
    sort; 8 B a pair of device memory, D and W), after the row
    coefficients of :func:`_relieff_select_operands` in PyTorch; anything
    else raises.  ``labels`` is :func:`relieff_labels` of (y_flat,
    valid_flat), made here when not given.  Labels are >= -1 (padding),
    as the engines stage them."""
    T, n = _check_rule_operands("relieff_weights", (torch.float32,), D, yi,
                                y_flat)
    if k < 1:
        raise ValueError(f"k >= 1 expected, got {k}")
    if labels is None:
        labels = relieff_labels(y_flat, valid_flat)
    lab, y32, vals = _relieff_select_operands(D, yi, vi, iid, labels, k,
                                              class_probs)
    return _relieff_launch(D, lab, y32, iid.to(torch.int64).contiguous(),
                           vi.to(torch.float32).contiguous(), vals, k)


def _check_rule_operands(name, dtypes, D, yi, y_flat):
    """Raise unless the rule kernel ``name`` takes D: a CUDA tensor of one
    of ``dtypes``, contiguous with 16-byte aligned rows (n a multiple of
    4), with yi (T,) and y_flat (n,); returns (T, n)."""
    T, n = D.shape
    if (D.dtype not in dtypes or not D.is_contiguous() or n % 4
            or D.data_ptr() % 16):
        kinds = " or ".join(str(t).split(".")[1] for t in dtypes)
        raise ValueError(
            f"{name} takes a contiguous {kinds} D with 16-byte aligned rows "
            f"(n a multiple of 4); got {D.dtype}, {T}x{n}")
    if yi.shape != (T,) or y_flat.shape != (n,):
        raise ValueError(f"yi ({T},) and y_flat ({n},) expected")
    if D.device.type != "cuda":
        raise ValueError(f"unsupported device {D.device}")
    return T, n


def _relieff_launch(D, lab, y32, iid, vi, vals, k):
    """W from one launch of ``csrc/relieff_select.cu`` on the operands of
    :func:`_relieff_select_operands` (iid int64, vi float32)."""
    T, n = D.shape
    W = torch.empty_like(D)
    _build.launch("relieff_weights", D.device, D.data_ptr(), lab.data_ptr(),
                  y32.data_ptr(), iid.data_ptr(), vi.data_ptr(),
                  vals.data_ptr(), W.data_ptr(), T, n, vals.shape[1] - 1,
                  int(k))
    return W


def threshold_weights(D, yi, vi, iid, y_flat, valid_flat, n_real, *, algo,
                      use_star, labels=None):
    """MultiSURF's or SURF's (``algo``) pair weights W (T, n) float32 of one
    focal block on the card: ``_sum_rules(pair_weight_rules(...))``.

    Two launches of ``csrc/threshold_rule.cu`` write W from a float32 or
    float64 CUDA D (12 B a pair of device memory; D and W are all a block
    holds): the row statistics and thresholds, inside the span
    ``weight_rules.stats`` as in the chain, then the weights; anything
    else raises.  The row shift and 1 / (n_real - 1) are the chain's own
    tensors.  The kernels sum in float64, so a pair within an ulp or so of
    the chain's threshold may take the other side of it; every other W
    equals the chain's bit for bit.  ``labels`` is :func:`sample_labels`
    of (y_flat, valid_flat), made here when not given."""
    if algo not in ("multisurf", "surf"):
        raise ValueError(f"threshold_weights takes 'multisurf' or 'surf', "
                         f"got {algo!r}")
    _check_rule_operands("threshold_weights", (torch.float32, torch.float64),
                         D, yi, y_flat)
    with span("weight_rules.stats", device=D.device):
        ops, shift, denom = _threshold_operands(
            D, yi, vi, iid, y_flat, valid_flat, n_real, labels)
        thr, coef = _threshold_stats(D, ops, shift, denom,
                                     algo == "multisurf", use_star)
    return _threshold_launch(D, ops, shift, thr, coef)


def _threshold_operands(D, yi, vi, iid, y_flat, valid_flat, n_real,
                        labels=None):
    """(ops, shift, denom): the operands of :func:`threshold_weights`'
    launches.  ``ops`` is (labels int32, yi int32, iid int64, vi float32),
    ``shift`` the chain's row shift and ``denom`` its 1 / (n_real - 1), of
    D's dtype; ``labels`` as there."""
    n = D.shape[1]
    if labels is None:
        labels = sample_labels(y_flat, valid_flat)
    if (labels.dtype != torch.int32 or labels.shape != (n,)
            or not labels.is_contiguous() or labels.data_ptr() % 16):
        raise ValueError(f"labels must be sample_labels' contiguous ({n},) "
                         f"int32 tensor")
    ops = (labels, yi.to(torch.int32).contiguous(),
           iid.to(torch.int64).contiguous(), vi.to(torch.float32).contiguous())
    shift = _row_shift(D, iid, valid_flat).contiguous()
    denom = 1.0 / (n_real.to(D.device, D.dtype) - 1.0)
    return ops, shift, denom


def _threshold_stats(D, ops, shift, denom, multisurf, star):
    """(thr (T,) of D's dtype, coef (T, 4) float32) from one launch of
    ``csrc/threshold_rule.cu``'s statistics on the operands of
    :func:`_threshold_operands`."""
    T, n = D.shape
    thr = torch.empty_like(shift)
    coef = torch.empty((T, 4), dtype=torch.float32, device=D.device)
    _build.launch("threshold_stats", D.device, D.data_ptr(),
                  int(D.dtype == torch.float64),
                  *(t.data_ptr() for t in ops), shift.data_ptr(),
                  denom.data_ptr(), thr.data_ptr(), coef.data_ptr(), T, n,
                  int(multisurf), int(star))
    return thr, coef


def _threshold_launch(D, ops, shift, thr, coef):
    """W (T, n) float32 from one launch of ``csrc/threshold_rule.cu``'s
    weights on the operands of :func:`_threshold_stats` and its result."""
    T, n = D.shape
    W = torch.empty(D.shape, dtype=torch.float32, device=D.device)
    _build.launch("threshold_weights", D.device, D.data_ptr(),
                  int(D.dtype == torch.float64),
                  *(t.data_ptr() for t in ops), shift.data_ptr(),
                  thr.data_ptr(), coef.data_ptr(), W.data_ptr(), T, n)
    return W


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


def chain_rule(y_flat, valid_flat, n_real, class_probs, *, algo, use_star,
               k):
    """The weight rule of one fused-engine fit as the chain of PyTorch
    operations, on any device: ``W = rule(D, yi, vi, iid)``, (T, n)
    float32, the rules of :func:`pair_weight_rules` summed.  It is what
    the kernels of :func:`relieff_weights` and :func:`threshold_weights`
    replace on the card, and their reference there.  ReliefF's rule ranks
    D in float32, as its kernel does: p >> n's float64 D is rounded."""
    def rule(D, yi, vi, iid):
        if algo == "relieff":
            D = D.to(torch.float32)
        return _sum_rules(pair_weight_rules(
            D, yi, vi, iid, y_flat, valid_flat, n_real, class_probs,
            algo=algo, use_star=use_star, k=k))
    return rule


def weight_rule(y_flat, valid_flat, n_real, class_probs, *, algo, use_star,
                k):
    """The fused engine's weight rule of one fit, ``W = rule(D, yi, vi,
    iid)`` (T, n) float32 of a focal block's distance rows D against all
    samples (labels ``y_flat``, validity ``valid_flat``, both on D's
    device).

    On the CPU it is :func:`chain_rule`.  On the card it is the rule
    kernels, with their per-fit labels made here once: ReliefF's one
    launch (:func:`relieff_weights`) on D rounded to float32, MultiSURF's
    and SURF's two (:func:`threshold_weights`) on D as pass 1 gives it."""
    if y_flat.device.type == "cpu":
        return chain_rule(y_flat, valid_flat, n_real, class_probs, algo=algo,
                          use_star=use_star, k=k)
    if algo == "relieff":
        labels = relieff_labels(y_flat, valid_flat)
        return lambda D, yi, vi, iid: relieff_weights(
            D.to(torch.float32), yi, vi, iid, y_flat, valid_flat, k,
            class_probs, labels)
    labels = sample_labels(y_flat, valid_flat)
    return lambda D, yi, vi, iid: threshold_weights(
        D, yi, vi, iid, y_flat, valid_flat, n_real, algo=algo,
        use_star=use_star, labels=labels)


def relief_engine_core(x_f, yv_f, valid_f, row0, x_a, yv_a, valid_a,
                       recip, disc, n_real, class_probs, *, algo, use_star,
                       k, nb, n_disc=0, pass1=None, pass2=None, rule=None):
    """Unnormalised scores (p_pad,) float32 contributed by the focal rows
    ``x_f`` against all rows ``x_a``, on their device.

    ``row0`` is the global row id of x_f's first row: the sharded layer
    passes each shard's contiguous focal rows with their offset, a single
    device all rows with 0.  Every block of ``nb`` focal rows runs pass 1
    against all rows, the weight rule with its global row ids, then pass
    2; block scores are added in block order.  The first ``n_disc``
    columns (a multiple of 4) are the discrete ones.  ``pass1`` and
    ``pass2`` default to the kernel wrappers of ``relief_cuda.py``
    (:func:`~.relief_cuda.dist_matrix`, :func:`~.relief_cuda.accumulate`);
    ``rule`` makes the fit's weight rule, called as :func:`weight_rule`
    (the default; :func:`chain_rule` runs the chain on any device).
    Counterpart of JAX's ``relief_engine_core``.
    """
    if pass1 is None or pass2 is None:
        from .relief_cuda import accumulate, dist_matrix
        pass1, pass2 = pass1 or dist_matrix, pass2 or accumulate
    mixed = n_disc > 0
    dev = x_a.device
    scores = torch.zeros(x_a.shape[1], dtype=torch.float32, device=dev)
    rule = (rule or weight_rule)(yv_a, valid_a, n_real, class_probs,
                                 algo=algo, use_star=use_star, k=k)
    for b0 in range(0, x_f.shape[0], nb):
        count("focal_blocks")
        xi = x_f[b0:b0 + nb]
        iid = torch.arange(row0 + b0, row0 + b0 + xi.shape[0], device=dev)
        with span("fused.pass1", device=dev):
            D = pass1(x_a, recip, disc, xi=xi, mixed=mixed)
        with span("weight_rules", device=dev):
            W = rule(D, yv_f[b0:b0 + nb], valid_f[b0:b0 + nb], iid)
            del D
        with span("fused.pass2", device=dev):
            scores += pass2(x_a, W, recip, disc, xi=xi, mixed=mixed,
                            n_disc=n_disc)
        del W   # freed before the next block's D
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
