"""ReliefF's pair weights from one launch (``ops/relief.py``
``relieff_weights``, ``csrc/relieff_select.cu``).

On the CPU the fused engine's rule (``weight_rule``) is the kernel's
plain twin, the sort chain ``_sum_rules(_rules_relieff(...))``.  The
kernel cannot run here, so its
algorithm is held to the twin through a plain model of it
(:func:`_kernel_model`: the radix select of each label's k-th key by
11-bit digits, then the picks in index order) fed by the operands the
wrapper hands the kernel (``_relieff_select_operands``): the twin's bits
over tie-heavy and float distances, padded rows and samples, labels past
class_probs, classes of fewer than k members, k = 1 to hundreds and 60
and 70 classes.  Tests marked ``card`` hold the kernel itself to the twin
on a CUDA device and skip without one; on a CUDA host without JAX:

    python -m pytest --noconftest -m card tests/test_torch_relieff_weights.py
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_array_equal

from fastselect_tpu_torch import _build
from fastselect_tpu_torch.ops import relief as TR
from fastselect_tpu_torch.ops import relief_cuda as RC

torch.set_num_threads(2)

_ALL = np.iinfo(np.int32).max   # the kernel's kAll: every tied member
_BITS = 11                      # the kernel's kDigit


@pytest.fixture
def rng():
    return np.random.RandomState(0)


def _card():
    """The first CUDA device; the calling test skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _bits(a):
    a = a.cpu().numpy() if isinstance(a, torch.Tensor) else a
    return np.asarray(a, np.float32).view(np.int32)


# ---------------------------------------------------------------------------
# Focal blocks
# ---------------------------------------------------------------------------

def _distances(rng, kind, shape):
    if kind == "integer":                  # ties everywhere
        return rng.randint(0, 6, shape).astype(np.float32)
    if kind == "quantised":                # ties between non-integers
        return (rng.randint(0, 12, shape) / 4).astype(np.float32)
    if kind == "signed-zeros":             # zeros signed in _block
        return rng.randint(0, 3, shape).astype(np.float32)
    return (rng.rand(*shape) * 5).astype(np.float32)


def _block(rng, ncls, kind, *, t=16, n_real=37, n_pad=48, row0=16,
           n_probs=None, few=None):
    """One focal block of t rows from global row ``row0`` (rows past
    n_real are padding, label -1 and validity 0), as the engine passes it:
    (D, yi, vi, iid, y_flat, valid_flat, class_probs) tensors.  ``few``
    gives one class that many members; ``n_probs`` cuts class_probs to
    that many classes (the op-level default of one dummy class)."""
    D = _distances(rng, kind, (t, n_pad))
    if kind == "signed-zeros":
        D = np.where(D == 0, np.where(rng.rand(t, n_pad) < 0.5, -0.0, 0.0),
                     np.abs(D)).astype(np.float32)
    y = np.full(n_pad, -1, np.int64)
    y[:n_real] = rng.randint(0, ncls, n_real)
    if few is not None:
        y[:n_real][y[:n_real] == ncls - 1] = 0
        y[rng.choice(n_real, few, replace=False)] = ncls - 1
    valid = (y >= 0).astype(np.float32)
    rows = np.arange(row0, row0 + t)
    cp = np.bincount(y[:n_real], minlength=ncls).astype(np.float32) / n_real
    if n_probs is not None:
        cp = np.zeros(n_probs, np.float32)
    t_ = torch.from_numpy
    return (t_(D), t_(y[rows]), t_(valid[rows]), t_(rows), t_(y), t_(valid),
            t_(cp))


def _twin(args, k):
    D, yi, vi, iid, y, valid, cp = args
    return TR._sum_rules(TR._rules_relieff(D, yi, vi, iid, y, valid, k, cp))


def _cpu_rule(args, k):
    """W of the fused engine's rule (``weight_rule``) on the CPU."""
    D, yi, vi, iid, y, valid, cp = args
    return TR.weight_rule(y, valid, None, cp, algo="relieff",
                          use_star=False, k=k)(D, yi, vi, iid)


GRID = [(ncls, k, kind, row0)
        for ncls in (2, 3) for k in (3, 30)       # 30: past a class's count
        for kind in ("integer", "quantised", "float")
        for row0 in (16, 32)]                     # rows 37..47 of 32 pad

# case -> (block arguments, k)
CASES = {
    "k=1": (dict(ncls=2, kind="integer"), 1),
    "k in the hundreds": (dict(ncls=3, kind="quantised", t=8, n_real=700,
                               n_pad=704, row0=600), 200),
    "60 classes": (dict(ncls=60, kind="quantised", n_real=300, n_pad=320,
                        row0=290), 3),
    "70 classes": (dict(ncls=70, kind="integer", n_real=400, n_pad=448,
                        row0=100), 4),
    "few members": (dict(ncls=3, kind="integer", n_real=60, n_pad=64,
                         few=2), 5),
    "labels past class_probs": (dict(ncls=3, kind="quantised", n_probs=1),
                                3),
    "signed zeros": (dict(ncls=2, kind="signed-zeros", n_real=60, n_pad=64,
                          row0=0), 7),
    "row 0": (dict(ncls=2, kind="float", row0=0), 5),
}


def _case(rng, case):
    params, k = CASES[case]
    params = dict(params)
    return _block(rng, params.pop("ncls"), params.pop("kind"), **params), k


# ---------------------------------------------------------------------------
# A plain model of the kernel
# ---------------------------------------------------------------------------

def _order_key(D):
    """csrc/relieff_select.cu ``order_key``: the sorts' order as uint32."""
    u = D.view(np.uint32).copy()
    u[u == 0x80000000] = 0
    key = np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)
    key[np.isnan(D)] = 0xFFFFFFFF
    return key


def _threshold(keys, k, bits=_BITS):
    """(pre, msk, take) of one label's members ``keys``, as ``settle``
    finds them by digits of ``bits`` bits (the last one what is left):
    pick a member when key & msk < pre, or when equal while fewer than
    ``take`` equal ones came before it."""
    pre = msk = 0
    need = k
    levels = -(-32 // bits)
    for level in range(levels):
        shift = max(0, 32 - bits * (level + 1))
        digit = (1 << (32 - bits * level - shift)) - 1
        hist = np.bincount((keys[(keys & msk) == pre] >> shift) & digit,
                           minlength=digit + 1)
        if level == 0 and hist.sum() <= k:
            return 0, 0, _ALL
        cum = np.cumsum(hist)
        d = int(np.searchsorted(cum, need))      # the need-th member's digit
        rest = need - int(cum[d] - hist[d])
        pre |= d << shift
        msk |= digit << shift
        if rest == hist[d]:
            return pre, msk, _ALL
        if level == levels - 1:
            return pre, msk, rest
        need = rest
    raise AssertionError("unreachable")


def _kernel_model(D, lab, y32, iid, vi, vals, k, n_classes):
    """W as the kernel writes it, from the operands it is handed."""
    D, lab, y32, iid, vi, vals = (a.numpy() for a in (D, lab, y32, iid, vi,
                                                      vals))
    t, n = D.shape
    keys = _order_key(D)
    W = np.zeros((t, n), np.float32)
    for i in range(t):
        if vi[i] <= 0:
            continue
        slot = np.where((lab >= 0) & (lab < n_classes), lab,
                        np.where(lab == y32[i], n_classes, -1))
        if iid[i] < n:
            slot[iid[i]] = -1
        for s in range(n_classes + 1):
            idx = np.flatnonzero(slot == s)
            pre, msk, take = _threshold(keys[i, idx], k)
            kb = keys[i, idx] & msk
            tie = kb == pre
            pick = (kb < pre) | (tie & (np.cumsum(tie) <= take))
            W[i, idx[pick]] = vals[i, s]
    return W


def _model(args, k):
    D, yi, vi, iid, y, valid, cp = args
    lab, y32, vals = TR._relieff_select_operands(
        D, yi, vi, iid, TR.relieff_labels(y, valid), k, cp)
    assert lab.dtype == y32.dtype == torch.int32
    assert vals.shape == (D.shape[0], cp.shape[0] + 1)
    return _kernel_model(D, lab, y32, iid, vi, vals, k, cp.shape[0])


# ---------------------------------------------------------------------------
# The CPU: the twin, the operands and the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ncls,k,kind,row0", GRID)
def test_cpu_runs_the_sort_chain(ncls, k, kind, row0, rng):
    args = _block(rng, ncls, kind, row0=row0)
    before = dict(_build.launches)
    W = _cpu_rule(args, k)
    assert W.dtype == torch.float32 and W.shape == args[0].shape
    assert_array_equal(_bits(W), _bits(_twin(args, k)))
    assert _build.launches == before     # no kernel ran


@pytest.mark.parametrize("ncls,k,kind,row0", GRID)
def test_kernel_model_equals_the_sort_chain(ncls, k, kind, row0, rng):
    args = _block(rng, ncls, kind, row0=row0)
    assert_array_equal(_bits(_model(args, k)), _bits(_twin(args, k)))


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_model_equals_the_sort_chain_cases(case, rng):
    args, k = _case(rng, case)
    want = _twin(args, k)
    assert_array_equal(_bits(_model(args, k)), _bits(want))
    assert_array_equal(_bits(_cpu_rule(args, k)), _bits(want))
    if case == "few members":
        _, yi, vi, _, y, _, _ = args
        picked = (want.numpy() != 0) & (y.numpy() == 2)[None, :]
        assert picked.sum(axis=1).max() == 2      # all of its 2, not k
    if case == "signed zeros":
        assert (np.signbit(args[0].numpy()) & (args[0].numpy() == 0)).any()


def test_operands_count_hits_and_padding(rng):
    """The wrapper's hit counts (from sorted labels) give the twin's
    hit_norm; padded samples carry no label and padded focal rows no
    hits."""
    D, yi, vi, iid, y, valid, cp = _block(rng, 3, "integer", row0=32)
    lab, y32, vals = TR._relieff_select_operands(
        D, yi, vi, iid, TR.relieff_labels(y, valid), 3, cp)
    assert (lab[37:] == TR._NO_LABEL).all() and (lab[:37] == y[:37]).all()
    vmask, hit = TR._pair_masks(D, yi, vi, iid, y, valid)
    n_hit = (vmask & hit).sum(dim=1)
    hit_norm, w = TR._relieff_coefficients(n_hit, yi, 3, cp)
    own = torch.where((yi >= 0) & (yi < 3), yi, 3)
    got = vals.gather(1, own[:, None])[:, 0]
    assert_array_equal(_bits(got), _bits(0.0 - hit_norm))
    assert (got[vi == 0] == 0).all() and (vi == 0).any()


def test_engine_core_routes_relieff_to_the_new_rule(monkeypatch, rng):
    """relief_engine_core on the CPU: ReliefF's rule, made once a fit,
    runs once a focal block with the block's global row ids (the sample
    shard's row0 included) and scores as the sort chain bit for bit.  Off
    the CPU it is relieff_weights on D rounded to float32, with the fit's
    sorted labels; MultiSURF's rule does not go through it."""
    n, p, nb = 96, 8, 32
    x = torch.from_numpy(rng.rand(n, p).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 3, n).astype(np.int64))
    valid = torch.ones(n)
    valid[90:] = 0.0
    y[90:] = -1
    recip, disc = torch.ones(p), torch.zeros(p)
    cp = torch.tensor([0.3, 0.3, 0.4])
    n_real = torch.tensor(90.0)

    def core(row0, rule=None):
        rows = slice(row0, n)
        return RC.relief_engine_core(
            x[rows], y[rows], valid[rows], row0, x, y, valid, recip, disc,
            n_real, cp, algo="relieff", use_star=False, k=4, nb=nb,
            rule=rule)

    calls = []
    new = TR.weight_rule

    def spy(*a, **kw):
        rule = new(*a, **kw)
        return lambda D, yi, vi, iid: (calls.append(iid[0].item())
                                       or rule(D, yi, vi, iid))
    monkeypatch.setattr(TR, "weight_rule", spy)
    got = {row0: core(row0) for row0 in (0, 32)}
    assert calls == [0, 32, 64, 32, 64]

    def chain(y_flat, valid_flat, n_real, cp, **kw):
        return lambda D, yi, vi, iid: TR._sum_rules(TR._rules_relieff(
            D, yi, vi, iid, y_flat, valid_flat, kw["k"], cp))
    for row0, scores in got.items():
        assert_array_equal(_bits(scores), _bits(core(row0, rule=chain)))
    seen = []
    monkeypatch.setattr(TR, "relieff_weights", lambda *a: seen.append(
        (a[0].dtype, a[6], a[8][0].dtype, a[8][1].dtype)) or a[0])
    monkeypatch.setattr(TR, "threshold_weights", lambda *a, **kw: a[0])
    meta = torch.device("meta")
    D = torch.empty((nb, n), dtype=torch.float64, device=meta)
    block = (D, y[:nb].to(meta), valid[:nb].to(meta),
             torch.arange(nb, device=meta))
    for algo in ("relieff", "multisurf"):
        new(y.to(meta), valid.to(meta), n_real.to(meta), cp.to(meta),
            algo=algo, use_star=False, k=4)(*block)
    assert seen == [(torch.float32, 4, torch.int32, torch.int32)]


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------

def _to(args, dev):
    return tuple(a.to(dev) for a in args)


@pytest.mark.card
@pytest.mark.parametrize("ncls,k,kind,row0", GRID)
def test_kernel_equals_the_sort_chain_on_the_card(ncls, k, kind, row0, rng):
    args = _to(_block(rng, ncls, kind, row0=row0), _card())
    before = _build.launches["relieff_weights"]
    W = TR.relieff_weights(*args[:6], k, args[6])
    assert _build.launches["relieff_weights"] == before + 1
    assert_array_equal(_bits(W), _bits(_twin(args, k)))


@pytest.mark.card
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_equals_the_sort_chain_on_the_card_cases(case, rng):
    card = _card()
    args, k = _case(rng, case)
    args = _to(args, card)
    W = TR.relieff_weights(*args[:6], k, args[6])
    again = TR.relieff_weights(*args[:6], k, args[6])
    assert_array_equal(_bits(W), _bits(_twin(args, k)))
    assert torch.equal(W, again)


@pytest.mark.card
def test_one_launch_a_focal_block_on_the_card(monkeypatch, rng):
    """A ReliefF fit of the fused engine on a CUDA tensor launches the
    kernel once a focal block, and no sort chain."""
    card = _card()
    n, p = 1000, 12
    x = torch.from_numpy(rng.rand(n, p).astype(np.float32)).to(card)
    y = rng.randint(0, 2, n)
    monkeypatch.setattr(RC, "_block_budget_bytes",
                        lambda *a, **k: 64 * 1024 * 256)
    monkeypatch.setattr(TR, "_rules_relieff", None)
    plan = RC.block_plan(n, p, card, "relieff")
    blocks = plan.n_pad // plan.nb
    assert blocks > 1
    before = dict(_build.launches)
    RC.relief_fused_scores(x, y, torch.ones(p), np.zeros(p, bool),
                           algo="relieff", n_neighbors=5,
                           class_probs=np.array([0.5, 0.5], np.float32))
    moved = {k: _build.launches[k] - before[k] for k in before}
    assert moved["relieff_weights"] == blocks
    assert moved["relief_pass1_cont"] == moved["relief_pass2_cont"] == blocks


def test_chip_phase_28_rehearses(monkeypatch):
    """chip_smoke.py's phase 28 at a small size on the CPU: the call on
    CPU tensors (its operand checks but the device's passed), the plain
    model for the launch."""
    import time

    import chip_smoke as cs

    def host_ms(fn, reps, warmup=1):
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3

    def model_launch(D, lab, y32, iid, vi, vals, k):
        return torch.from_numpy(_kernel_model(D, lab, y32, iid, vi, vals, k,
                                              vals.shape[1] - 1))
    monkeypatch.setattr(cs, "cuda_ms", host_ms)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a: None)
    monkeypatch.setattr(TR, "_relieff_launch", model_launch)
    monkeypatch.setattr(TR, "_check_rule_operands",
                        lambda name, dtypes, D, yi, y: D.shape)
    cpu = torch.device("cpu")
    X, y = cs.make_classification(n_samples=150, n_features=12,
                                  n_informative=4, random_state=0)
    # rows 48..63 of the first case are past the 60 real samples
    cases = tuple((label, kind, 16, 64, 60, min(row0, 48), ncls, k, few,
                   n_probs)
                  for label, kind, _, _, _, row0, ncls, k, few, n_probs
                  in cs.RELIEFF_CASES)
    rows = cs.relieff_kernel_phase(cpu, cs.large_n_block(
        cpu, X.astype(np.float32), y), cases=cases, reps=1)
    assert len(rows) == len(cases) + 1 == len(cs.RELIEFF_CASES) + 1
    assert "large-n block: 192x192, 2 classes, k 10" in rows[0]["shape"]
    for row in rows:
        assert row["bound_by"] == "bytes" and row["picks"] > 0
        assert row["ms"] > 0 and row["library_ms"] > 0
