"""MultiSURF's and SURF's pair weights from two launches (``ops/relief.py``
``threshold_weights``, ``csrc/threshold_rule.cu``).

On the CPU the fused engine's rule (``weight_rule``) is the chain the
kernels replace on the card, ``_sum_rules(pair_weight_rules(...))``.  The
kernels cannot run here, so
their arithmetic is held to the chain through a plain model of it
(:func:`_kernel_model`: the chain's shift, float64 sums of the shifted
row rounded to D's dtype, the threshold rounded step by step, integer
counts, one coefficient a kind of pair).  The kernels sum in float64
where the chain sums in D's dtype, so over rows of many samples their
threshold may lie some ulps off the chain's, and the pairs between the
two change sides: :func:`_held` (``chip_smoke.threshold_held``, which
phase 29 of ``chip_smoke.py`` applies at a large-n block) takes W bit for
bit on every row whose near mask agrees with the chain's, asks that W's
near mask be that of the float64 sums' threshold but for pairs within
``chip_smoke.THRESHOLD_ULPS`` ulps of it, and that W be the rule's on its
own near mask.  Tests marked ``card`` hold the kernels themselves to the
chain on a CUDA device and skip without one; on a CUDA host without JAX:

    python -m pytest --noconftest -m card tests/test_torch_threshold_rule.py
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_array_equal

import chip_smoke as cs
from fastselect_tpu_torch import SURF, MultiSURF, _build
from fastselect_tpu_torch.ops import relief as TR
from fastselect_tpu_torch.ops import relief_cuda as RC

torch.set_num_threads(2)

RULES = [(algo, star) for algo in ("multisurf", "surf")
         for star in (False, True)]
DTYPES = [torch.float32, torch.float64]


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
        return rng.randint(0, 6, shape).astype(np.float64)
    if kind == "offset":                   # D ~ 1e5, sigma ~ 100 (p >> n)
        return 1.0e5 + rng.randn(*shape) * 100.0
    return rng.rand(*shape) * 5


def _block(rng, kind, dtype, *, ncls=2, t=16, n_real=37, n_pad=48, row0=16,
           past=False):
    """One focal block of t rows from global row ``row0`` (rows past
    n_real are padding: label -1, validity 0), as the engine passes it:
    (D, yi, vi, iid, y_flat, valid_flat, n_real) tensors.  ``past`` gives
    a few samples a label past the ncls classes."""
    D = _distances(rng, kind, (t, n_pad))
    y = np.full(n_pad, -1, np.int64)
    y[:n_real] = rng.randint(0, ncls, n_real)
    if past:
        y[rng.choice(n_real, 5, replace=False)] = ncls + 3
    valid = (y >= 0).astype(np.float32)
    rows = np.arange(row0, row0 + t)
    t_ = torch.from_numpy
    return (t_(D).to(dtype), t_(y[rows]), t_(valid[rows]), t_(rows), t_(y),
            t_(valid), torch.tensor(float(n_real)))


# case -> block arguments
CASES = {
    "float": dict(kind="float"),
    "padded and invalid focal rows": dict(kind="float", row0=32),
    "first valid sample a focal row": dict(kind="float", row0=0),
    "integer ties": dict(kind="integer", n_real=60, n_pad=64, row0=8),
    "3 classes": dict(kind="float", ncls=3, n_real=90, n_pad=96, row0=40),
    "a label past the classes": dict(kind="integer", ncls=3, past=True),
    "D ~ 1e5": dict(kind="offset", n_real=100, n_pad=128, t=32, row0=64),
    "rows of 50,000 samples": dict(kind="float", n_real=50000, n_pad=50048,
                                   t=64, row0=0),
}
GRID = [(case, algo, star, dtype) for case in CASES
        for algo, star in RULES for dtype in DTYPES]


def _case(rng, case, dtype, dev=None):
    args = _block(rng, dtype=dtype, **CASES[case])
    return args if dev is None else tuple(a.to(dev) for a in args)


def _chain(args, algo, star):
    return TR._sum_rules(TR.pair_weight_rules(
        *args, None, algo=algo, use_star=star, k=0))


# ---------------------------------------------------------------------------
# Holding W to the chain
# ---------------------------------------------------------------------------

def _held(W, args, algo, star):
    """Hold W to the chain on the same D by ``chip_smoke.threshold_held``
    (see the module's docstring); returns the number of pairs that changed
    sides."""
    pairs, _, _, faults = cs.threshold_held(W, args, algo, star)
    assert not faults, faults
    return pairs


# ---------------------------------------------------------------------------
# A plain model of the kernels
# ---------------------------------------------------------------------------

def _kernel_model(args, algo, star):
    """W as the two launches write it, from the operands the wrapper hands
    them: the chain's shift and 1 / (n_real - 1), float64 sums of the
    shifted row rounded to D's dtype, every later step rounded in it."""
    D, yi, vi, iid, y, valid, n_real = args
    t_dtype = np.float32 if D.dtype == torch.float32 else np.float64
    lab = TR.sample_labels(y, valid).numpy()
    shift = TR._row_shift(D, iid, valid).numpy()
    denom = (1.0 / (n_real.to(D.dtype) - 1.0)).numpy()
    D, yi, vi, iid = (a.numpy() for a in (D, yi, vi, iid))
    t, n = D.shape
    W = np.zeros((t, n), np.float32)
    for i in range(t):
        vm = (lab != TR._NO_LABEL) & (vi[i] > 0) & (np.arange(n) != iid[i])
        if not vm.any():
            continue
        hit = lab == yi[i]
        dm = (D[i] - shift[i]).astype(t_dtype)
        s1 = t_dtype(np.sum(dm[vm].astype(np.float64)))
        s2 = t_dtype(np.sum(np.square(dm[vm].astype(np.float64))))
        mu = t_dtype(s1 * denom)
        thr = mu
        if algo == "multisurf":
            var = t_dtype(t_dtype(s2 * denom) - t_dtype(mu * mu))
            var = max(var, t_dtype(0))
            thr = t_dtype(mu - t_dtype(t_dtype(0.5) * np.sqrt(var)))
        near = vm & (dm < thr)
        if algo == "multisurf":
            w_hit = -(np.float32(1) / np.float32(max((near & hit).sum(), 1)))
            w_miss = np.float32(1) / np.float32(max((near & ~hit).sum(), 1))
            coef = (w_hit, w_miss, 0.0, -w_miss if star else 0.0)
        else:
            coef = (-1.0, 1.0, 1.0 if star else 0.0, -1.0 if star else 0.0)
        kind = np.where(near, np.where(hit, 0, 1), np.where(hit, 2, 3))
        W[i] = np.where(vm, np.asarray(coef, np.float32)[kind], 0.0)
    return torch.from_numpy(W)


# ---------------------------------------------------------------------------
# The CPU: the chain, the operands, the model and the routing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case,algo,star,dtype", GRID)
def test_cpu_runs_the_chain(case, algo, star, dtype, rng):
    args = _case(rng, case, dtype)
    before = dict(_build.launches)
    rule = TR.weight_rule(*args[4:], None, algo=algo, use_star=star, k=0)
    W = rule(*args[:4])
    assert_array_equal(_bits(W), _bits(_chain(args, algo, star)))
    assert _build.launches == before     # no kernel ran


@pytest.mark.parametrize("case,algo,star,dtype", GRID)
def test_kernel_model_is_held_to_the_chain(case, algo, star, dtype, rng):
    args = _case(rng, case, dtype)
    W = _kernel_model(args, algo, star)
    _held(W, args, algo, star)
    if case == "padded and invalid focal rows":
        assert (args[2] == 0).any() and not W[args[2] == 0].any()


def test_held_catches_a_wrong_weight(rng):
    """The comparison itself: a weight off by an ulp, or a pair far from
    the threshold put on the other side, fails it."""
    args = _case(rng, "float", torch.float32)
    W = _kernel_model(args, "multisurf", True)
    off = W.clone()
    i, j = (int(v) for v in torch.nonzero(off > 0)[0])
    off[i, j] = torch.nextafter(off[i, j], torch.tensor(2.0))
    with pytest.raises(AssertionError):
        _held(off, args, "multisurf", True)
    Dm, thr, vmask, hit = cs.chain_threshold(args, "multisurf")
    far = vmask & ((Dm - thr[:, None]).abs() > 0.5) & ~hit & (W > 0)
    i, j = (int(v) for v in torch.nonzero(far)[0])
    flipped = W.clone()
    flipped[i, j] = -flipped[i, j]     # a near miss made a far miss
    with pytest.raises(AssertionError):
        _held(flipped, args, "multisurf", True)


def test_operand_checks_raise():
    D = torch.zeros(4, 8)
    yi, y = torch.zeros(4, dtype=torch.long), torch.zeros(8, dtype=torch.long)
    check = TR._check_rule_operands
    dtypes = (torch.float32, torch.float64)
    for bad in (D.half(), D.t().contiguous().t(), torch.zeros(4, 6),
                torch.zeros(33)[1:].view(4, 8)):
        with pytest.raises(ValueError, match="16-byte aligned rows"):
            check("threshold_weights", dtypes, bad, yi, y[:bad.shape[1]])
    with pytest.raises(ValueError, match=r"yi \(4,\) and y_flat \(8,\)"):
        check("threshold_weights", dtypes, D, yi[:3], y)
    with pytest.raises(ValueError, match="unsupported device cpu"):
        check("threshold_weights", dtypes, D.double(), yi, y)
    with pytest.raises(ValueError, match="contiguous float32 D"):
        check("relieff_weights", (torch.float32,), D.double(), yi, y)
    with pytest.raises(ValueError, match="takes 'multisurf' or 'surf'"):
        TR.threshold_weights(D, yi, torch.ones(4), torch.arange(4), y,
                             torch.ones(8), torch.tensor(8.0),
                             algo="relieff", use_star=False)


@pytest.mark.card
def test_wrapper_checks_raise_on_the_card():
    """On a CUDA tensor the wrapper raises on what the kernels do not take
    (D's dtype, rows that are not 16-byte aligned, labels not of
    ``sample_labels``) before any launch."""
    card = _card()
    args = _block(np.random.RandomState(1), "float", torch.float32)
    args = tuple(a.to(card) for a in args)
    D, rest = args[0], args[1:]
    before = dict(_build.launches)
    for bad in (D.half(), D[:, :44]):
        with pytest.raises(ValueError, match="16-byte aligned rows"):
            TR.threshold_weights(bad, *rest, algo="surf", use_star=False)
    with pytest.raises(ValueError, match="sample_labels"):
        TR.threshold_weights(*args, algo="surf", use_star=False,
                             labels=TR.sample_labels(args[4], args[5]).long())
    assert _build.launches == before


def test_engine_core_routes_by_algorithm(monkeypatch, rng):
    """relief_engine_core makes the fit's rule once (``weight_rule``) and
    calls it once a focal block with the block's global row ids (the
    sample shard's row0 included); on the CPU it is the rule chain, bit for
    bit.  Off the CPU the rule is the kernels: MultiSURF and SURF go
    through threshold_weights with the fit's sample labels, on D as it
    is; ReliefF does not go through it."""
    n, p, nb = 96, 8, 32
    x = torch.from_numpy(rng.rand(n, p).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 3, n).astype(np.int64))
    valid = torch.ones(n)
    valid[90:] = 0.0
    y[90:] = -1
    recip, disc = torch.ones(p), torch.zeros(p)
    cp = torch.tensor([0.3, 0.3, 0.4])
    n_real = torch.tensor(90.0)

    def core(row0, algo, star=False, rule=None):
        rows = slice(row0, n)
        return RC.relief_engine_core(
            x[rows], y[rows], valid[rows], row0, x, y, valid, recip, disc,
            n_real, cp, algo=algo, use_star=star, k=4, nb=nb, rule=rule)

    calls = []
    new = TR.weight_rule

    def spy(*a, **kw):
        rule = new(*a, **kw)
        calls.append(kw["algo"])
        return lambda D, yi, vi, iid: (calls.append(iid[0].item())
                                       or rule(D, yi, vi, iid))
    monkeypatch.setattr(TR, "weight_rule", spy)
    got = {(row0, algo, star): core(row0, algo, star)
           for row0 in (0, 32) for algo, star in RULES}
    assert calls == [c for row0 in (0, 32) for algo, _ in RULES
                     for c in [algo, *range(row0, n, nb)]]
    for (row0, algo, star), scores in got.items():
        assert_array_equal(_bits(scores), _bits(core(
            row0, algo, star, rule=TR.chain_rule)))
    seen = []
    monkeypatch.setattr(TR, "threshold_weights", lambda *a, **kw: (
        seen.append((a[0].dtype, kw["algo"], kw["use_star"],
                     kw["labels"].dtype)) or a[0]))
    monkeypatch.setattr(TR, "relieff_weights", lambda *a: a[0])
    meta = torch.device("meta")
    D = torch.empty((nb, n), dtype=torch.float64, device=meta)
    block = (D, y[:nb].to(meta), valid[:nb].to(meta),
             torch.arange(nb, device=meta))
    for algo, star in RULES + [("relieff", False)]:
        new(y.to(meta), valid.to(meta), n_real.to(meta), cp.to(meta),
            algo=algo, use_star=star, k=4)(*block)
    assert seen == [(torch.float64, algo, star, torch.int32)
                    for algo, star in RULES]


@pytest.mark.parametrize("algo,star", RULES + [("relieff", False)])
def test_engine_core_takes_a_rule_in_place_of_the_kernels(monkeypatch, algo,
                                                          star, rng):
    """``rule`` (``relief_fused_scores``' ``_rule``) makes the weight rule
    in place of ``weight_rule``, once a fit, and runs once a focal block
    with no call of either kernel's wrapper: ``chain_rule`` there scores
    as the default route bit for bit."""
    n, p = 80, 12
    x = rng.rand(n, p).astype(np.float32)
    y = rng.randint(0, 3, n)
    recip, disc = np.ones(p, np.float32), np.zeros(p, bool)
    cp = (np.bincount(y) / n).astype(np.float32)
    monkeypatch.setattr(RC, "_CPU_BLOCK_BYTES",
                        RC._THRESHOLD_BLOCK_RULE * 128 * 128 // 2)
    plan = RC.block_plan(n, p, torch.device("cpu"), algo)
    assert plan.n_pad // plan.nb >= 2
    kw = dict(algo=algo, use_star=star, n_neighbors=4, class_probs=cp)
    want = RC.relief_fused_scores(x, y, recip, disc, **kw)
    calls = []

    def make(*a, **k):
        chain = TR.chain_rule(*a, **k)
        calls.append("made")
        return lambda D, *b: calls.append(D.dtype) or chain(D, *b)

    for name in ("threshold_weights", "relieff_weights", "weight_rule"):
        monkeypatch.setattr(TR, name, lambda *a, **k: pytest.fail(
            "the default rule ran"))
    got = RC.relief_fused_scores(x, y, recip, disc, _rule=make, **kw)
    assert calls == ["made"] + [torch.float32] * (plan.n_pad // plan.nb)
    assert_array_equal(_bits(got), _bits(want))


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------

def _large_n_block(dev, dtype, seed=21):
    """A large-n focal block (2,944 x 50,048 pairs, 50,000 real samples, 2
    classes) of pass 1's D of make_classification-like data."""
    rng = np.random.RandomState(seed)
    n, n_pad, p, t = 50000, 50048, 100, 2944
    x = torch.zeros((n_pad, p), dtype=torch.float32, device=dev)
    x[:n] = torch.from_numpy(rng.randn(n, p).astype(np.float32)).to(dev)
    recip = 1.0 / (x[:n].amax(0) - x[:n].amin(0))
    D = RC.dist_matrix(x, recip.contiguous(), torch.zeros_like(recip),
                       xi=x[1000:1000 + t], mixed=False).to(dtype)
    y = np.full(n_pad, -1, np.int64)
    y[:n] = rng.randint(0, 2, n)
    valid = (y >= 0).astype(np.float32)
    rows = np.arange(1000, 1000 + t)
    t_ = torch.from_numpy
    return (D, t_(y[rows]).to(dev), t_(valid[rows]).to(dev),
            t_(rows).to(dev), t_(y).to(dev), t_(valid).to(dev),
            torch.tensor(float(n), device=dev))


def _on_card(args, algo, star, what):
    """The kernels' W held to the chain on the card, twice the same;
    prints the pairs that changed sides."""
    before = dict(_build.launches)
    W = TR.threshold_weights(*args, algo=algo, use_star=star)
    again = TR.threshold_weights(*args, algo=algo, use_star=star)
    assert _build.launches["threshold_stats"] == \
        before["threshold_stats"] + 2
    assert _build.launches["threshold_weights"] == \
        before["threshold_weights"] + 2
    assert torch.equal(W, again)
    moved = _held(W, args, algo, star)
    print(f"{what} {algo}{'*' if star else ''} {args[0].dtype}: {moved} "
          f"pairs changed sides of {args[0].numel()}")


@pytest.mark.card
@pytest.mark.parametrize("case,algo,star,dtype", GRID)
def test_kernels_are_held_to_the_chain_on_the_card(case, algo, star, dtype,
                                                   rng):
    _on_card(_case(rng, case, dtype, _card()), algo, star, case)


@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernels_at_a_large_n_block_on_the_card(dtype):
    args = _large_n_block(_card(), dtype)
    for algo, star in RULES:
        _on_card(args, algo, star, "large-n block")


def _surf_reference(monkeypatch):
    """The benchmark's reference with SURF's rule added: near = D < mu_i,
    near misses +1, near hits -1, in the reference's dtype."""
    from portbench.reference import relief as ref

    def rules(algo, D, yi, y, iid, dtype, k, priors):
        if algo != "surf":
            return rules_of(algo, D, yi, y, iid, dtype, k, priors)
        n = D.shape[1]
        self_ = torch.arange(n, device=D.device)[None, :] == iid[:, None]
        D = D.to(dtype)
        mu = D.masked_fill(self_, 0).sum(dim=1) / (n - 1)
        near = (D < mu[:, None]) & ~self_
        hit = y[None, :] == yi[:, None]
        one = torch.ones(D.shape[0], dtype=dtype, device=D.device)
        return [(near & ~hit, one), (near & hit, -one)]
    rules_of = ref._rules
    monkeypatch.setattr(ref, "_rules", rules)
    return ref


@pytest.mark.card
@pytest.mark.parametrize("make,algo", [(MultiSURF, "multisurf"),
                                       (SURF, "surf")])
def test_fits_against_the_reference_on_the_card(make, algo, monkeypatch,
                                                rng):
    """Fits of the fused engine on a CUDA tensor, in two focal blocks,
    launch both kernels once a block and score within the large-n cell's
    limits of the float64 reference (``portbench/limits``)."""
    from portbench.checks import readings
    card = _card()
    ref = _surf_reference(monkeypatch)
    n, p, n_select = 4096, 100, 10
    X = rng.randn(n, p)
    y = (X[:, :5].sum(axis=1) + 0.5 * rng.randn(n) > 0).astype(np.int64)
    monkeypatch.setattr(RC, "_block_budget_bytes", lambda *a, **k:
                        RC._THRESHOLD_BLOCK_RULE * n * n // 2)
    plan = RC.block_plan(n, p, card, algo)
    assert plan.n_pad // plan.nb == 2
    before = dict(_build.launches)
    est = make(n_features_to_select=n_select).fit(
        torch.from_numpy(X.astype(np.float32)).to(card), y)
    moved = {k: _build.launches[k] - before[k] for k in before}
    assert moved["threshold_stats"] == moved["threshold_weights"] == 2
    want = ref.relief_scores(X.astype(np.float32), [y], algo=algo,
                             device=card)[0]
    got = readings([(0, est.feature_importances_, est.top_features_)],
                   {0: want}, n_select, 4e-5)
    print(f"{algo} fit: {got}")
    assert got["score_gap"] <= 4e-5 and got["top_miss"] == 0


def test_chip_phase_29_rehearses(monkeypatch):
    """chip_smoke.py's phase 29 at a small size on the CPU: the chain
    (``chain_rule``) stands in for the calls, zeros for the launches."""
    import time

    def host_ms(fn, reps, warmup=1):
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3

    monkeypatch.setattr(cs, "cuda_ms", host_ms)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a: None)
    monkeypatch.setattr(
        TR, "threshold_weights",
        lambda D, yi, vi, iid, y, valid, n_real, *, algo, use_star: (
            TR.chain_rule(y, valid, n_real, None, algo=algo,
                          use_star=use_star, k=0)(D, yi, vi, iid)))
    monkeypatch.setattr(TR, "_threshold_stats", lambda D, *a: (
        torch.zeros(D.shape[0], dtype=D.dtype), torch.zeros(D.shape[0], 4)))
    monkeypatch.setattr(TR, "_threshold_launch", lambda D, *a: torch.zeros(
        D.shape, dtype=torch.float32))
    cpu = torch.device("cpu")
    X, y = cs.make_classification(n_samples=150, n_features=12,
                                  n_informative=4, random_state=0)
    rows = cs.threshold_kernel_phase(cpu, cs.large_n_block(
        cpu, X.astype(np.float32), y, "multisurf"), reps=1)
    assert set(rows) == {"threshold_stats", "threshold_weights"}
    for kernel, timed in rows.items():
        assert len(timed) == 2 * len(cs.THRESHOLD_RULES)
        assert "large-n block multisurf float32: 192x192" in timed[0]["shape"]
        for row in timed:
            assert row["bound_by"] == "bytes" and row["rows_moved"] == 0
            assert row["ms"] > 0 and row["library_ms"] > 0
    assert rows["threshold_weights"][0]["bound_ms"] == pytest.approx(
        2 * rows["threshold_stats"][0]["bound_ms"], rel=1e-2)
