"""p >> n: MultiSURF's and SURF's thresholds at D ~ 1e5, and pass 1's
float64 split path.

At 100 x 500,000 (the upstream large-p point) D is about 1.1e5 with a
spread of about 100 over a row.  The rules take their row statistics of D
less a per-row shift, in D's dtype, and pass 1 sums its feature ranges in
float64 where it splits them, so that the near masks are those of a
float64 computation.  The CPU tests hold the rules to a float64 two-pass
computation, the fits to the benchmark's plain float64 reference
(``portbench/reference/relief.py``) and the plain pass 1 to a float64
``cdist``.  The tests marked ``card`` hold the kernels to their plain
versions on a CUDA device, and skip without one; this file imports no
JAX, so they run on a host without it:

    python3 -m pytest --noconftest -m card tests/test_torch_large_p.py
"""

import numpy as np
import pytest
import torch

from fastselect_tpu_torch import SURF, MultiSURF
from fastselect_tpu_torch.models import _relief_base as TB
from fastselect_tpu_torch.ops import relief as TR
from fastselect_tpu_torch.ops import relief_cuda as RC
from fastselect_tpu_torch.utils import sklearn_compat as SC
from portbench.generators.classification import (make_classification,
                                                 random_state)
from portbench.reference import relief as REF

torch.set_num_threads(2)

# float32's unit roundoff: a float32 diff |a - b| * r is off its exact
# value by at most two roundings
U32 = 2.0 ** -24


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


# ---------------------------------------------------------------------------
# The rules at D ~ 1e5
# ---------------------------------------------------------------------------

def _near(rules):
    """The near mask of MultiSURF's or SURF's (mask, coefficient) terms:
    the first two are the near misses and hits, in either order."""
    return (rules[0][0] | rules[1][0]).numpy()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
@pytest.mark.parametrize("algo", ["multisurf", "surf"])
def test_near_masks_at_1e5_equal_float64_two_pass(algo, dtype):
    """A block of 64 rows against 1,000 samples (10 padded), D = 1e5 plus a
    spread of about 100: the near masks equal those of float64 statistics
    taken in two passes (mean, then the centred variance) of the same D.
    The one-pass E[D^2] - mu^2 in float32 flips hundreds here."""
    rng = np.random.default_rng(5)
    T, N, N_REAL, ROW0 = 64, 1000, 990, 100
    D = torch.tensor(1e5 + 100 * rng.standard_normal((T, N)), dtype=dtype)
    y = np.full(N, -1)
    y[:N_REAL] = rng.integers(0, 2, N_REAL)
    valid = np.zeros(N, np.float32)
    valid[:N_REAL] = 1.0
    iid = np.arange(ROW0, ROW0 + T)
    t = torch.from_numpy
    rules = TR.pair_weight_rules(
        D, t(y[iid]), t(valid[iid]), t(iid), t(y), t(valid),
        torch.tensor(float(N_REAL)), None, algo=algo, use_star=False, k=0)
    d = D.double().numpy()
    vm = (valid[None, :] > 0) & (np.arange(N)[None, :] != iid[:, None])
    mu = np.where(vm, d, 0).sum(1) / (N_REAL - 1)
    thresh = mu
    if algo == "multisurf":
        var = np.where(vm, (d - mu[:, None]) ** 2, 0).sum(1) / (N_REAL - 1)
        thresh = mu - np.sqrt(var) / 2
    expected = (d < thresh[:, None]) & vm
    assert expected.sum(1).min() > 100          # every row has near pairs
    np.testing.assert_array_equal(_near(rules), expected)


# ---------------------------------------------------------------------------
# Fits against the benchmark's float64 reference
# ---------------------------------------------------------------------------

def _surf_rules(D, yi, y, iid, dtype):
    """SURF in the reference's form: near = D < mu_i over j != i, unit
    weights (upstream SURF.py:131-195)."""
    n = D.shape[1]
    self_ = torch.arange(n, device=D.device)[None, :] == iid[:, None]
    D = D.to(dtype)
    mu = D.masked_fill(self_, 0).sum(dim=1) / (n - 1)
    near = (D < mu[:, None]) & ~self_
    hit = y[None, :] == yi[:, None]
    one = torch.ones(D.shape[0], dtype=dtype, device=D.device)
    return [(near & ~hit, one), (near & hit, -one)]


@pytest.fixture
def reference_with_surf(monkeypatch):
    rules = REF._rules

    def with_surf(algo, D, yi, y, iid, dtype, k, priors):
        if algo == "surf":
            return _surf_rules(D, yi, y, iid, dtype)
        return rules(algo, D, yi, y, iid, dtype, k, priors)
    monkeypatch.setattr(REF, "_rules", with_surf)


@pytest.mark.parametrize("algo,seed", [("multisurf", 7), ("multisurf", 9),
                                       ("surf", 9)])
def test_fit_at_p_much_larger_than_n_matches_float64_reference(
        algo, seed, reference_with_surf):
    """100 x 8,192 ``make_classification`` data of the large-p
    configuration (dataset 0 of the seed): pass 1 splits 64 ranges and D
    is about 1,800.  With float32 range sums and the one-pass float32
    statistics the gap read 1.8e-2 and 1.4e-2 of the largest score
    (MultiSURF, seeds 7 and 9) and 7.1e-3 (SURF, seed 9; SURF's mean alone
    read 1e-7 on seeds 7, 8 and 10 to 14).  The scores are within 1e-5 of
    the largest reference score, and the top 10 are a valid choice."""
    n, p = 100, 8192
    x, y = make_classification(
        n, p, n_informative=10, n_redundant=2, n_classes=2,
        n_clusters_per_class=2, flip_y=0.01, class_sep=1.0,
        random_state=random_state(seed, 0))
    assert len(RC.pass1_splits(128, 128, p)) == 64
    est = {"multisurf": MultiSURF, "surf": SURF}[algo]
    fit = est(n_features_to_select=10, backend="cpu").fit(x, y)
    ref = REF.relief_scores(x, [y], algo=algo, device="cpu")[0]
    scale = np.abs(ref).max()
    gap = np.abs(np.asarray(fit.feature_importances_, np.float64) - ref)
    assert gap.max() <= 1e-5 * scale
    kth = np.sort(ref)[-10]
    assert (ref[fit.top_features_] >= kth - 2e-5 * scale).all()


# ---------------------------------------------------------------------------
# Pass 1's split path in float64
# ---------------------------------------------------------------------------

def _split_inputs(rng, nb, n, p, mixed):
    x = rng.random((n, p), dtype=np.float32)
    disc = np.zeros(p, np.float32)
    if mixed:
        disc[::3] = 1.0                          # interleaved kinds
        x[:, ::3] = rng.integers(0, 3, (n, len(disc[::3])))
    recip = (1.0 / (x.max(0) - x.min(0))).astype(np.float32)
    return (torch.from_numpy(x), torch.from_numpy(recip),
            torch.from_numpy(disc), torch.from_numpy(x[:nb]))


def _float64_dist(x, recip, disc, xi):
    """sum_f diff(i, j, f) of the float32 inputs, in float64."""
    x64, r64, xi64 = x.double(), recip.double(), xi.double()
    cont = torch.cdist(xi64 * r64, x64 * r64, p=1) if not disc.any() else \
        torch.cdist(xi64[:, disc == 0] * r64[disc == 0],
                    x64[:, disc == 0] * r64[disc == 0], p=1)
    if disc.any():
        d = disc > 0
        cont = cont + (xi64[:, None, d] != x64[None, :, d]).sum(-1)
    return cont


@pytest.mark.parametrize("mixed", [False, True], ids=["cont", "mixed"])
def test_split_pass1_is_float64_within_two_roundings_a_diff(monkeypatch,
                                                            mixed):
    """16 focal rows against 64 samples of 8,192 features: 64 ranges,
    summed in float64.  Each float32 diff is off by at most two roundings,
    so D is within 2.01 u D of the float64 distance, where float32 sums
    are not; the one-range plan of the same inputs stays float32."""
    rng = np.random.default_rng(3)
    nb, n, p = 16, 64, 8192
    x, recip, disc, xi = _split_inputs(rng, nb, n, p, mixed)
    assert len(RC.pass1_splits(nb, n, p)) == 64
    assert RC.dist_dtype(nb, n, p) == torch.float64
    D = RC.dist_matrix(x, recip, disc, xi=xi, mixed=mixed)
    assert D.dtype == torch.float64
    exact = _float64_dist(x, recip, disc, xi)
    assert ((D - exact).abs() <= 2.01 * U32 * exact).all()
    monkeypatch.setattr(RC, "_PASS1_TARGET_BLOCKS", 1)   # one range
    assert len(RC.pass1_splits(nb, n, p)) == 1
    one = RC.dist_matrix(x, recip, disc, xi=xi, mixed=mixed)
    assert one.dtype == torch.float32
    assert not ((one.double() - exact).abs() <= 2.01 * U32 * exact).all()


def test_engine_rounds_split_d_for_relieff(monkeypatch):
    """ReliefF's rule takes float32 D: the split path's float64 D reaches
    its ranking rounded."""
    rng = np.random.default_rng(4)
    x = rng.random((20, 512))
    y = rng.integers(0, 2, 20)
    seen = []
    rules = TR._rules_relieff

    def spy(D, *a, **k):
        seen.append(D.dtype)
        return rules(D, *a, **k)
    monkeypatch.setattr(TR, "_rules_relieff", spy)
    assert RC.dist_dtype(64, 64, 512) == torch.float64
    RC.relief_fused_scores(x, y, np.ones(512, np.float32), np.zeros(512),
                           algo="relieff", n_neighbors=3,
                           class_probs=np.array([0.5, 0.5]))
    assert seen == [torch.float32]


# ---------------------------------------------------------------------------
# Host validation of wide X
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_finite_check_sums_first_and_tells_nan_from_infinity(dtype):
    """The stand-in's check (a host without scikit-learn) takes the sum
    first; finite values whose sum overflows pass, a read-only array takes
    numpy's sum without a warning, and NaN and infinity raise as
    scikit-learn raises."""
    import warnings
    SC._check_finite(np.ones((3, 4), dtype))
    SC._check_finite(np.full((2, 2), np.finfo(dtype).max, dtype))
    ro = np.ones((3, 4), dtype)
    ro.flags.writeable = False
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        SC._check_finite(ro)
    for bad, msg in (([np.nan], "NaN"), ([np.inf], "infinity"),
                     ([-np.inf], "infinity"), ([np.inf, -np.inf], "infinity"),
                     ([np.inf, np.nan], "NaN")):
        x = np.ones((3, 4), dtype)
        x.flat[:len(bad)] = bad
        with pytest.raises(ValueError, match=f"Input X contains {msg}"):
            SC._check_finite(x)


@pytest.fixture
def staged_on_cpu(monkeypatch):
    monkeypatch.setattr(TB, "_STAGED_DEVICE_TYPES", ("cuda", "cpu"))
    monkeypatch.setattr(TB, "_STAGED_MIN_ELEMS", 1000)


@pytest.mark.parametrize("td", [None, "float32", "float16", "bfloat16"])
def test_multisurf_validates_float64_x_without_a_copy(monkeypatch,
                                                      staged_on_cpu, td):
    """MultiSURF validates to float32, as JAX does; where it stages
    float32 the fit keeps float64 X as it is (staging casts it) and where
    it stages at half width the validation casts, so that the half-width
    values round from float32 as JAX's do.  Either way the scores equal
    those of X cast to float32 first, bit for bit."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((40, 300)) * 1e3 + 0.1
    y = rng.integers(0, 2, 40)
    seen = []
    analysis = TB.BaseReliefSelector._analysis

    def spy(self, X, dev, *a, **k):
        seen.append(X.dtype)
        return analysis(self, X, dev, *a, **k)
    monkeypatch.setattr(TB.BaseReliefSelector, "_analysis", spy)
    kw = dict(n_features_to_select=5, backend="cpu", transfer_dtype=td)
    wide = MultiSURF(**kw).fit(x, y)
    narrow = MultiSURF(**kw).fit(x.astype(np.float32), y)
    keeps = td in (None, "float32")
    assert seen == [np.float64 if keeps else np.float32, np.float32]
    np.testing.assert_array_equal(wide.feature_importances_,
                                  narrow.feature_importances_)
    assert wide.transfer_dtype_ == narrow.transfer_dtype_


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("staged", [False, True], ids=["copied", "staged"])
@pytest.mark.parametrize("have_sklearn", [True, False],
                         ids=["sklearn", "stand-in"])
def test_fit_rejects_nan_and_infinity_where_x_is_analysed(
        monkeypatch, staged, have_sklearn):
    """A host float X is looked for NaN and infinity once, where it is
    analysed: a staged X on the device, in its float32 copy, and on the
    host only where that copy holds one; finite float64 values past
    float32's range are accepted, as validation accepts them."""
    if staged:
        monkeypatch.setattr(TB, "_STAGED_DEVICE_TYPES", ("cuda", "cpu"))
        monkeypatch.setattr(TB, "_STAGED_MIN_ELEMS", 1000)
    if not have_sklearn:
        monkeypatch.setattr(SC, "HAVE_SKLEARN", False)
    calls = []
    check = SC.check_finite
    monkeypatch.setattr(SC, "check_finite",
                        lambda X: calls.append(X.shape) or check(X))
    rng = np.random.default_rng(3)
    y = rng.integers(0, 2, 40)
    for bad, msg in ((np.nan, "NaN"), (np.inf, "infinity"),
                     (-np.inf, "infinity")):
        x = rng.standard_normal((40, 300))
        x[5, 17] = bad
        with pytest.raises(ValueError, match=f"Input X contains {msg}"):
            MultiSURF(n_features_to_select=3, backend="cpu").fit(x, y)
    calls.clear()
    MultiSURF(n_features_to_select=3, backend="cpu").fit(
        rng.standard_normal((40, 300)), y)
    assert calls == ([] if staged else [(40, 300)])
    x = rng.standard_normal((40, 300))
    x[0, 0] = 1e300
    MultiSURF(n_features_to_select=3, backend="cpu").fit(x, y)
    assert calls[-1] == (40, 300)


@pytest.mark.parametrize("kind", ["distinct", "rounded", "nan", "few"])
def test_top_features_equal_the_full_sort(kind):
    """The partition's pick equals ``np.argsort(s)[::-1][:k]`` on every
    k, ties, NaN and signed zeros included."""
    rng = np.random.default_rng(len(kind))
    for _ in range(300):
        p = int(rng.integers(1, 50))
        s = rng.standard_normal(p).astype(np.float32)
        if kind == "rounded":
            s = np.round(s).astype(np.float32)
        elif kind == "nan":
            s[rng.integers(0, p, 2)] = np.nan
        elif kind == "few":
            s = rng.choice(np.float32([-0.0, 0.0, 1.0, 2.0]), p)
        for k in range(p + 2):
            np.testing.assert_array_equal(TB.top_features(s, k),
                                          np.argsort(s)[::-1][:k])


@pytest.mark.card
@pytest.mark.parametrize("mixed", [False, True], ids=["cont", "mixed"])
def test_split_kernel_equals_plain_version_on_the_card(mixed):
    dev = _card()
    rng = np.random.default_rng(11)
    nb, n, p = 16, 64, 8192
    x, recip, disc, xi = (t.to(dev) for t in
                          _split_inputs(rng, nb, n, p, mixed))
    D = RC.dist_matrix(x, recip, disc, xi=xi, mixed=mixed)
    assert D.dtype == torch.float64
    assert torch.equal(D, RC.dist_matrix_ref(x, recip, disc, xi=xi,
                                             mixed=mixed))


@pytest.mark.card
@pytest.mark.parametrize("mixed", [False, True], ids=["cont", "mixed"])
def test_one_range_kernel_unchanged_on_the_card(mixed):
    """The one-range path (every shape the split leaves alone, large-n's
    blocks among them) stays float32 and equal to the plain float32 sum."""
    dev = _card()
    rng = np.random.default_rng(12)
    nb, n, p = 512, 2048, 100
    assert len(RC.pass1_splits(nb, n, p)) == 1
    x, recip, disc, xi = (t.to(dev) for t in
                          _split_inputs(rng, nb, n, p, mixed))
    D = RC.dist_matrix(x, recip, disc, xi=xi, mixed=mixed)
    assert D.dtype == torch.float32
    assert torch.equal(D, RC.dist_matrix_ref(x, recip, disc, xi=xi,
                                             mixed=mixed))


@pytest.mark.card
def test_large_p_kernel_on_the_card():
    """100 x 500,000 (the large-p cell's block: 264 ranges of 1,896
    features): the kernel's float64 D equals the plain version's bit for
    bit and lies within 1e-4 of the float64 distance."""
    dev = _card()
    rng = np.random.default_rng(13)
    n, p = 100, 500000
    x, recip, disc, xi = (t.to(dev) for t in
                          _split_inputs(rng, n, n, p, False))
    assert len(RC.pass1_splits(n, n, p)) == 264
    D = RC.dist_matrix(x, recip, disc, mixed=False)
    assert torch.equal(D, RC.dist_matrix_ref(x, recip, disc, mixed=False))
    exact = _float64_dist(x, recip, disc, xi)
    assert float((D - exact).abs().max()) <= 1e-4
