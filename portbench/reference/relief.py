"""Plain PyTorch MultiSURF and ReliefF: the benchmark's reference.

Independent of the program under test: it imports nothing of it, and
recomputes everything from X and y.  The semantics are the upstream
library's (``MultiSURF.py``, ``ReliefF.py`` of GavinLynch04/FastSelect
v0.2.0, CPU semantics):

* a feature with at most ``discrete_limit`` unique values is discrete
  (Hamming diff), otherwise continuous (|x_if - x_jf| / range_f, a zero
  range taken as 1);
* D[i, j] = sum_f diff(i, j, f) over every pair i != j;
* MultiSURF: near = D[i, j] < mu_i - sigma_i / 2, with mu_i and sigma_i
  the mean and the population standard deviation of D[i, j] over j != i;
  near hits weigh -1 / n_hit(i), near misses +1 / n_miss(i);
* ReliefF: the k nearest hits weigh -1 / h(i), h(i) = min(k, hits found),
  and the k nearest of each other class c weigh P(c) / (1 - P(y_i)) / k
  (a zero denominator taken as 1); nearest by a stable sort of D[i, :],
  so ties go to the lower index;
* score_f = sum_ij W[i, j] diff(i, j, f) / n.

Everything runs on ``device`` in blocks of focal rows, so that a
30,000 x 200,000 genotype matrix fits on one card.  Floating-point work is
done in ``dtype`` (float64 for the reference; the benchmark's control
passes a lower precision), with TF32 off.  Where every column is discrete
and X is integer, the diffs are counted exactly: diff = 1 - sum_s
1[x_if = s] 1[x_jf = s], and each count is a product of 0/1 int8 matrices
with int32 results (``torch._int_mm`` on the card).  Mixed data (discrete
and continuous columns together) is not supported.
"""

from __future__ import annotations

import numpy as np
import torch

# bytes of one focal block's (rows, n) float arrays, and of one feature
# chunk's one-hot
_BLOCK_BYTES = 1 << 30
_ONEHOT_BYTES = 1 << 30


def _unique_counts(x: torch.Tensor, chunk_elems: int = 1 << 27):
    """Unique values of each column of ``x``."""
    n, p = x.shape
    if not x.is_floating_point():
        lo, hi = (int(v) for v in torch.aminmax(x))
        if hi - lo < 256:
            out = torch.zeros(p, dtype=torch.int64, device=x.device)
            for v in range(lo, hi + 1):
                out += (x == v).any(dim=0)
            return out
    out = torch.empty(p, dtype=torch.int64, device=x.device)
    step = max(1, chunk_elems // max(n, 1))
    for f0 in range(0, p, step):
        xs = torch.sort(x[:, f0:f0 + step], dim=0).values
        out[f0:f0 + step] = 1 + (xs[1:] != xs[:-1]).sum(dim=0)
    return out


def _rules_multisurf(D, yi, y, iid, dtype):
    """(mask, coefficient) terms of MultiSURF for focal rows ``iid``."""
    n = D.shape[1]
    self_ = torch.arange(n, device=D.device)[None, :] == iid[:, None]
    D = D.to(dtype)
    mu = D.masked_fill(self_, 0).sum(dim=1) / (n - 1)
    dev = (D - mu[:, None]).masked_fill(self_, 0)
    sigma = torch.sqrt((dev * dev).sum(dim=1) / (n - 1))
    near = (D < (mu - sigma / 2)[:, None]) & ~self_
    hit = y[None, :] == yi[:, None]
    near_hit, near_miss = near & hit, near & ~hit
    one = torch.ones((), dtype=dtype, device=D.device)
    n_hit = torch.maximum(near_hit.sum(dim=1).to(dtype), one)
    n_miss = torch.maximum(near_miss.sum(dim=1).to(dtype), one)
    return [(near_hit, -1 / n_hit), (near_miss, 1 / n_miss)]


def _first_k(member, k):
    return member & (torch.cumsum(member, dim=1) <= k)


def _rules_relieff(D, yi, y, iid, dtype, k, priors):
    """(mask, coefficient) terms of ReliefF for focal rows ``iid``."""
    n = D.shape[1]
    self_ = torch.arange(n, device=D.device)[None, :] == iid[:, None]
    D = D.to(dtype)
    order = torch.sort(D.masked_fill(self_, float("inf")), dim=1,
                       stable=True).indices
    ys = y[order]
    valid = ~self_.gather(1, order)

    def back(mask_sorted):
        return torch.zeros_like(mask_sorted).scatter_(1, order, mask_sorted)

    hits = valid & (ys == yi[:, None])
    h = torch.clamp(hits.sum(dim=1), max=k).to(dtype)
    r_hit = torch.where(h > 0, -1 / torch.clamp(h, min=1), 0)
    rules = [(back(_first_k(hits, k)), r_hit)]
    denom = 1 - priors[yi]
    denom = torch.where(denom == 0, torch.ones_like(denom), denom)
    for c in range(len(priors)):
        member = valid & (ys == c) & (yi != c)[:, None]
        rules.append((back(_first_k(member, k)), priors[c] / denom / k))
    return rules


def _rules(algo, D, yi, y, iid, dtype, k, priors):
    if algo == "multisurf":
        return _rules_multisurf(D, yi, y, iid, dtype)
    if algo == "relieff":
        return _rules_relieff(D, yi, y, iid, dtype, k, priors)
    raise ValueError(f"the reference has no algorithm {algo!r}")


def _block_rows(n: int, itemsize: int) -> int:
    return max(32, min(n, _BLOCK_BYTES // (itemsize * n)) // 32 * 32)


# ---------------------------------------------------------------------------
# All-discrete integer X: exact counts
# ---------------------------------------------------------------------------

def _round8(v: int) -> int:
    return (v + 7) // 8 * 8


def _count_mm(a: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
    """a @ bt.T of 0/1 int8 matrices, exact integer counts.  On the card
    torch._int_mm with int32 results (k and n are multiples of 8 here;
    rows are padded past 16); on the CPU a float64 product, exact below
    2**53, as int64."""
    if a.device.type != "cuda":
        return (a.to(torch.float64) @ bt.to(torch.float64).t()).to(
            torch.int64)
    m = a.shape[0]
    if m <= 16:
        a = torch.cat([a, a.new_zeros((17 - m, a.shape[1]))])
    return torch._int_mm(a, bt.t())[:m]


def _onehot(codes: torch.Tensor, f0: int, f1: int, n_states: int,
            n8: int, transpose: bool) -> torch.Tensor:
    """0/1 int8 one-hot of columns f0..f1 of the codes: (n8, S * fw), or
    its transpose (S * fw, n8), with fw = f1 - f0 rounded up to 8 and
    column s * fw + f holding 1[code of feature f0 + f == s]; padded
    features and samples are 0."""
    n = codes.shape[0]
    fw = _round8(f1 - f0)
    c = codes[:, f0:f1]
    if transpose:
        out = torch.zeros((n_states, fw, n8), dtype=torch.int8,
                          device=codes.device)
        for s in range(n_states):
            out[s, :f1 - f0, :n] = c.t() == s
        return out.view(n_states * fw, n8)
    out = torch.zeros((n8, n_states, fw), dtype=torch.int8,
                      device=codes.device)
    for s in range(n_states):
        out[:n, s, :f1 - f0] = c == s
    return out.view(n8, n_states * fw)


def _discrete_scores(codes, ys, n_states, algo, k, priors_list, dtype):
    """Each feature chunk's one-hot is built once a pass and serves every
    focal block: pass 1 fills the whole (n, n) match matrix, the rules
    then give every block's masks, and pass 2 counts each rule's
    mismatches chunk by chunk."""
    n, p = codes.shape
    dev = codes.device
    n8 = _round8(n)
    fw = max(8, _round8(_ONEHOT_BYTES // (n_states * n8)) - 8)
    chunks = [(f0, min(p, f0 + fw)) for f0 in range(0, p, fw)]
    tb = _block_rows(n, 8)
    blocks = [(b0, min(n, b0 + tb)) for b0 in range(0, n, tb)]
    # pass 1: match counts of every pair
    match = torch.zeros((n, n), dtype=torch.int32, device=dev)
    for f0, f1 in chunks:
        oh = _onehot(codes, f0, f1, n_states, n8, transpose=False)
        for b0, b1 in blocks:
            match[b0:b1] += _count_mm(oh[b0:b1], oh)[:, :n].to(torch.int32)
        del oh
    # the rules of every block and label vector, as int8 masks
    ys_t = [torch.as_tensor(y, device=dev) for y in ys]
    masks = []
    for b0, b1 in blocks:
        D = p - match[b0:b1].to(torch.int64)
        iid = torch.arange(b0, b1, device=dev)
        masks.append([[(torch.nn.functional.pad(m.to(torch.int8),
                                                (0, n8 - n)),
                        m.sum(dim=1), r)
                       for m, r in _rules(algo, D, y[b0:b1], y, iid, dtype,
                                          k, pr)]
                      for y, pr in zip(ys_t, priors_list)])
        del D
    del match
    # pass 2: each rule's mismatch counts at every (focal row, feature)
    totals = [torch.zeros(p, dtype=dtype, device=dev) for _ in ys]
    for f0, f1 in chunks:
        oh = _onehot(codes, f0, f1, n_states, n8, transpose=True)
        step = oh.shape[0] // n_states
        for (b0, b1), per_y in zip(blocks, masks):
            at = (codes[b0:b1, f0:f1].to(torch.int64) * step
                  + torch.arange(f1 - f0, device=dev))
            for total, rules in zip(totals, per_y):
                for m8, cnt, r in rules:
                    same = _count_mm(m8, oh).gather(1, at)
                    total[f0:f1] += (r[:, None]
                                     * (cnt[:, None] - same).to(dtype)
                                     ).sum(dim=0)
        del oh
    return [t / n for t in totals]


# ---------------------------------------------------------------------------
# All-continuous X: range-scaled L1
# ---------------------------------------------------------------------------

def _continuous_scores(xr, ys, algo, k, priors_list, dtype):
    n, p = xr.shape
    dev = xr.device
    tb = _block_rows(n, 8 * 4)
    fc = max(1, _BLOCK_BYTES // (8 * tb * n))
    ys_t = [torch.as_tensor(y, device=dev) for y in ys]
    totals = [torch.zeros(p, dtype=dtype, device=dev) for _ in ys]
    for b0 in range(0, n, tb):
        b1 = min(n, b0 + tb)
        iid = torch.arange(b0, b1, device=dev)
        D = torch.cdist(xr[b0:b1], xr, p=1)
        for total, y, pr in zip(totals, ys_t, priors_list):
            W = torch.zeros(D.shape, dtype=dtype, device=dev)
            for m, r in _rules(algo, D, y[b0:b1], y, iid, dtype, k, pr):
                W += torch.where(m, r[:, None], 0)
            for f0 in range(0, p, fc):
                d = (xr[b0:b1, None, f0:f0 + fc]
                     - xr[None, :, f0:f0 + fc]).abs_().to(dtype)
                total[f0:f0 + fc] += torch.einsum("ij,ijf->f", W, d)
            del W, d
        del D
    return [t / n for t in totals]


def relief_scores(x, ys, *, algo: str, n_neighbors: int = 10,
                  discrete_limit: int = 10, device=None,
                  dtype: torch.dtype = torch.float64) -> list[np.ndarray]:
    """Scores (p,) float64 of ``algo`` ('multisurf' or 'relieff') on X for
    each label vector of ``ys`` (a list: one pass over X serves them all).

    ``x`` is a host array or a tensor; it is copied to ``device`` (default:
    a tensor's own, else the CPU)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device is None:
        device = x.device if isinstance(x, torch.Tensor) else "cpu"
    x = torch.as_tensor(x).to(device)
    ys = [np.asarray(y) for y in ys]
    n = x.shape[0]
    priors_list, y_codes = [], []
    for y in ys:
        classes, enc = np.unique(y, return_inverse=True)
        y_codes.append(enc.astype(np.int64))
        priors_list.append(torch.as_tensor(
            np.bincount(enc, minlength=len(classes)) / n, dtype=dtype,
            device=device))
    disc = _unique_counts(x) <= discrete_limit
    if bool(disc.all()) and not x.is_floating_point():
        lo, hi = (int(v) for v in torch.aminmax(x))
        codes = x if lo == 0 and x.dtype == torch.int8 else (
            x - lo).to(torch.int8)
        out = _discrete_scores(codes, y_codes, hi - lo + 1, algo,
                               n_neighbors, priors_list, dtype)
    elif not bool(disc.any()):
        x64 = x.to(torch.float64)
        rng = x64.amax(dim=0) - x64.amin(dim=0)
        rng = torch.where(rng == 0, torch.ones_like(rng), rng)
        out = _continuous_scores(x64 / rng, y_codes, algo, n_neighbors,
                                 priors_list, dtype)
    else:
        raise NotImplementedError(
            "the reference takes all-discrete integer X or all-continuous X")
    return [t.to(torch.float64).cpu().numpy() for t in out]
