"""The port's GWAS-scale discrete route against the JAX package's, on the
CPU: bit-packed codes, windows, packed match counts, and v2 through the
gather, promote and resident routes; then the fit path that stages host
codes packed, the tier names, and ``chip_smoke.py``'s phase 24 rehearsed
at a small size.

Packed bytes, windows and match counts equal JAX's exactly.  Scores are
held to JAX's same route at ``test_torch_relief_discrete.py``'s ATOL and
RTOL with equal rankings, and the port's gather and promote routes to its
own resident route within 5e-7 (JAX's own bound between its routes,
``tests/test_engines.py:554-611``).
"""

import types

import jax
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

import chip_smoke as cs
import fastselect_tpu.ops.relief_discrete as JD
import fastselect_tpu_torch.ops.relief_discrete as TD
from fastselect_tpu_torch import MultiSURF, ReliefF, _build
from fastselect_tpu_torch.interop import packed_codes_from_jax
from fastselect_tpu_torch.models import _relief_base
from test_engines import CASES

torch.set_num_threads(2)

ATOL, RTOL = 3e-6, 1e-5
ROUTE_ATOL = 5e-7


def _codes(rng, n, p, s):
    return rng.randint(0, s, (n, p)).astype(np.int8)


def _unplane(win, per):
    """JAX's plane-order window in natural feature order: its position
    i * (ft // per) + j holds feature j * per + i."""
    rows, ft = win.shape
    return win.reshape(rows, per, ft // per).transpose(0, 2, 1).reshape(
        rows, ft)


_jax_window = jax.jit(JD._codes_window, static_argnames=("ft", "bits"))
_jax_match = jax.jit(JD._match_rows_raw,
                     static_argnames=("ft", "n_states", "bits"))


@pytest.mark.parametrize("s", [2, 3, 4, 5, 9, 16])
@pytest.mark.parametrize("p", [1, 3, 8, 13, 37])
@pytest.mark.parametrize("layout", ["contiguous", "strided"])
def test_pack_codes_equal_jax(s, p, layout, rng):
    """Packed bytes and bits equal JAX's ``_pack_codes`` for every packed
    state count, ragged p and non-contiguous input, and so do
    ``stage_codes_packed``'s, from an array, a tensor or row chunks."""
    codes = _codes(rng, 11, 2 * p, s)
    codes = codes[:, :p] if layout == "contiguous" else codes[:, ::2]
    want, bits = JD._pack_codes(codes, s)
    got, got_bits = TD._pack_codes(torch.from_numpy(codes), s)
    assert got_bits == bits and got.dtype == torch.uint8
    assert_array_equal(got.numpy(), want)
    chunks = [codes[r0:r0 + 4] for r0 in range(0, 11, 4)]
    for staged in (TD.stage_codes_packed(codes, s),
                   TD.stage_codes_packed(torch.from_numpy(codes), s),
                   TD.stage_codes_packed(chunks, s, shape=codes.shape)):
        assert isinstance(staged, TD.PackedCodes)
        assert (staged.bits, staged.n, staged.p) == (bits, 11, p)
        assert staged.p_eff == want.shape[1] * staged.per >= p
        assert_array_equal(staged.packed.numpy(), want)


def test_past_16_states_stay_int8(rng):
    codes = _codes(rng, 9, 13, 17)
    assert JD._pack_codes(codes, 17) is None
    assert TD._pack_codes(torch.from_numpy(codes), 17) is None
    staged = TD.stage_codes_packed(codes, 17)
    assert staged.dtype == torch.int8
    assert_array_equal(staged.numpy(), codes)
    with pytest.raises(ValueError, match="row chunks hold 9 rows"):
        TD.stage_codes_packed([codes], 3, shape=(10, 13))


@pytest.mark.parametrize("s", [3, 5])  # 2 and 4 bits a code
@pytest.mark.parametrize("gathered", [False, True])
def test_codes_window_equal_jax(s, gathered, rng):
    """Every byte-aligned window, of all rows or of gathered rows, equals
    JAX's window in natural order and the codes themselves."""
    n, p = 23, 37
    codes = _codes(rng, n, p, s)
    packed, bits = JD._pack_codes(codes, s)
    per = 8 // bits
    natural = np.zeros((n, packed.shape[1] * per), np.int8)
    natural[:, :p] = codes
    rows = rng.permutation(n)[:17] if gathered else None
    t_rows = None if rows is None else torch.from_numpy(rows)
    for w in (per, 4 * per):
        for off in range(0, natural.shape[1] - w + 1, per):
            jwin = _unplane(np.asarray(_jax_window(
                packed, off, ft=w, bits=bits)), per)
            got = TD._codes_window(torch.from_numpy(packed), off, w, bits,
                                   t_rows).numpy()
            want = natural[:, off:off + w]
            if rows is not None:
                jwin, want = jwin[rows], want[rows]
            assert got.dtype == np.int8
            assert_array_equal(got, jwin)
            assert_array_equal(got, want)
            plain = TD._codes_window(torch.from_numpy(natural), off, w, 0,
                                     t_rows).numpy()
            assert_array_equal(plain, want)


@pytest.mark.parametrize("bits,s", [(0, 3), (2, 3), (4, 5)])
@pytest.mark.parametrize("card_sizes", [False, True])
def test_match_rows_raw_equal_jax(bits, s, card_sizes, monkeypatch, rng):
    """Pass 1 over a ragged feature axis equals JAX's ``_match_rows_raw``
    exactly, int8 or packed, also with the windows widened to the card's
    GEMM sizes (code -1 past the window); read through ``rows`` it gives
    the same counts in that row order."""
    if card_sizes:
        monkeypatch.setattr(TD, "_gemm_size",
                            lambda v, device: TD._round_up(v, 8))
    n, p, ft = 41, 37, 16
    codes = _codes(rng, n, p, s)
    focal = rng.permutation(n)[:12]
    if bits:
        codes_a = JD._pack_codes(codes, s)[0]
        assert JD._pack_codes(codes, s)[1] == bits
    else:
        codes_a = codes
    ci = codes_a[focal]
    want = np.asarray(_jax_match(ci, codes_a, ft=ft, n_states=s, bits=bits))
    got = TD._match_rows(torch.from_numpy(ci), torch.from_numpy(codes_a),
                         ft, s, bits)
    assert got.dtype == torch.int32
    assert_array_equal(got.numpy(), want)
    order = rng.permutation(n)
    got = TD._match_rows(torch.from_numpy(ci), torch.from_numpy(codes_a),
                         ft, s, bits, torch.from_numpy(order))
    assert_array_equal(got.numpy(), want[:, order])


def _v2_gates(monkeypatch, sort_budget=None, promote_budget=None):
    for mod in (JD, TD):
        monkeypatch.setattr(mod, "_V2_MIN_N", 1)
        if sort_budget is not None:
            monkeypatch.setattr(mod, "_DEVICE_SORT_BUDGET", sort_budget)
        if promote_budget is not None:
            monkeypatch.setattr(mod, "_PACKED_PROMOTE_BUDGET", promote_budget)


def _case(rng, ncls, s, n=210, p=37):
    codes = _codes(rng, n, p, s)
    y = rng.randint(0, ncls, n).astype(np.int32)
    codes[:, 0] = y % 3
    cp = np.bincount(y, minlength=ncls).astype(np.float32) / n
    return codes, y, cp


# route -> (bits of the codes, state count, sort budget, promote budget)
ROUTES = {"gather-0": (0, 3, 1, None), "gather-2": (2, 3, 1, 0),
          "gather-4": (4, 5, 1, 0), "promote-2": (2, 3, None, None),
          "promote-4": (4, 5, None, None), "resident": (0, 3, None, None)}


def _run_both(route, codes, y, cp, s, algo, star, k):
    """(port's, JAX's) ``_run_v2`` scores over n for the route's codes
    (ti = 64, ft = 16); packed codes reach the port through
    ``packed_codes_from_jax``, so both read the same bytes."""
    n, p = codes.shape
    bits = ROUTES[route][0]
    kw = dict(algo=algo, use_star=star, k=k, ti=64, ft=16)
    if bits:
        jcodes = JD.stage_codes_packed(codes, s)
        assert isinstance(jcodes, JD.PackedCodes) and jcodes.bits == bits
        tcodes = packed_codes_from_jax(jcodes)
    elif route == "gather-0":
        jcodes, tcodes = jax.device_put(codes), torch.from_numpy(codes)
    else:
        jcodes, tcodes = codes, torch.from_numpy(codes)
    layout = TD._v2_layout(y, n, 64, algo, cp)
    got = TD._run_v2(tcodes, y, layout, n, p, s, cp, **kw)
    want = JD._run_v2(jcodes, y, JD._v2_layout(y, n, 64, algo, cp), n, p,
                      s, cp, device=None, **kw)
    return (got[:p].to(torch.float32).numpy() / np.float32(n),
            np.asarray(want, np.float32)[:p] / np.float32(n), tcodes)


@pytest.mark.parametrize("algo,star,k,ncls", CASES)
@pytest.mark.parametrize("route", list(ROUTES))
def test_run_v2_routes_match_jax(route, algo, star, k, ncls, monkeypatch,
                                 rng):
    """v2 through each route on 210 x 37 (ragged in n and p) against JAX's
    same route, and the gather and promote routes against the port's
    resident one; a promoted PackedCodes is consumed."""
    bits, s, sort_budget, promote_budget = ROUTES[route]
    codes, y, cp = _case(rng, ncls, s)
    _v2_gates(monkeypatch)
    resident = _run_both("resident", codes, y, cp, s, algo, star, k)[0]
    _v2_gates(monkeypatch, sort_budget, promote_budget)
    spied = []
    for name in ("_apply_layout", "_promote_packed_sorted", "_run_v2_gather"):
        orig = getattr(TD, name)

        def spy(*a, _orig=orig, _name=name, **kw):
            spied.append(_name)
            return _orig(*a, **kw)
        monkeypatch.setattr(TD, name, spy)
    got, want, tcodes = _run_both(route, codes, y, cp, s, algo, star, k)
    expect = {"gather": "_run_v2_gather", "promote": "_promote_packed_sorted",
              "resident": "_apply_layout"}[route.split("-")[0]]
    assert spied == [expect]
    assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    assert_array_equal(np.argsort(got), np.argsort(want))
    assert_allclose(got, resident, atol=ROUTE_ATOL)
    if route.startswith("promote"):
        assert tcodes.consumed and tcodes.packed is None


def test_promote_layout_equals_apply_layout(rng):
    """The promoted layout is ``_apply_layout``'s copy byte for byte, also
    in several row chunks."""
    codes = _codes(rng, 50, 37, 3)
    perm = np.argsort(rng.randint(0, 2, 50), kind="stable")
    want = TD._apply_layout(torch.from_numpy(codes), np.zeros(50), perm,
                            64, 48)[0]
    pk = TD.stage_codes_packed(codes, 3)
    for chunk in (TD._CHUNK_BYTES, 100):
        TD._CHUNK_BYTES, saved = chunk, TD._CHUNK_BYTES
        try:
            got = TD._promote_packed_sorted(pk, perm, 64, 48)
        finally:
            TD._CHUNK_BYTES = saved
        assert torch.equal(got, want)


def test_consumed_packed_codes_raise_jax_error(monkeypatch, rng):
    """After the promote route, both packages' PackedCodes raise the same
    RuntimeError, in ``_run_v2``, ``relief_discrete_scores`` and the
    interop."""
    _v2_gates(monkeypatch)
    codes, y, cp = _case(rng, 2, 3)
    n, p = codes.shape
    kw = dict(algo="multisurf", use_star=False, k=0, ti=64, ft=16)
    jpk = JD.stage_codes_packed(codes, 3)
    tpk = packed_codes_from_jax(jpk)
    JD._run_v2(jpk, y, JD._v2_layout(y, n, 64, "multisurf", cp), n, p, 3,
               cp, device=None, **kw)
    TD._run_v2(tpk, y, TD._v2_layout(y, n, 64, "multisurf", cp), n, p, 3,
               cp, **kw)
    with pytest.raises(RuntimeError) as jerr:
        JD._run_v2(jpk, y, JD._v2_layout(y, n, 64, "multisurf", cp), n, p,
                   3, cp, device=None, **kw)
    for call in (lambda: TD._run_v2(tpk, y, TD._v2_layout(
                     y, n, 64, "multisurf", cp), n, p, 3, cp, **kw),
                 lambda: TD.relief_discrete_scores(
                     None, y, algo="multisurf", codes=tpk, n_states=3),
                 lambda: packed_codes_from_jax(jpk)):
        with pytest.raises(RuntimeError) as err:
            call()
        assert str(err.value) == str(jerr.value)


def test_scores_from_packed_codes(monkeypatch, rng):
    """``relief_discrete_scores`` takes a PackedCodes (n_states given): v2
    reads it (here gathered), v1 unpacks it; both equal the int8 codes'
    scores."""
    codes, y, cp = _case(rng, 2, 3)
    kw = dict(algo="multisurf", use_star=True)
    for v2 in (False, True):
        if v2:
            _v2_gates(monkeypatch, promote_budget=0)
        want = TD.relief_discrete_scores(None, y, codes=codes, n_states=3,
                                         **kw)
        pk = TD.stage_codes_packed(codes, 3)
        got = TD.relief_discrete_scores(None, y, codes=pk, n_states=3, **kw)
        assert_allclose(got, want, atol=ROUTE_ATOL)
        assert not pk.consumed
    with pytest.raises(ValueError, match="need n_states"):
        TD.relief_discrete_scores(None, y, codes=pk, **kw)


@pytest.mark.parametrize("route", ["gather", "promote"])
@pytest.mark.parametrize("make", [
    lambda: MultiSURF(n_features_to_select=10),
    lambda: ReliefF(n_features_to_select=10, n_neighbors=5)],
    ids=["MultiSURF", "ReliefF"])
def test_estimator_stages_host_codes_packed(route, make, monkeypatch, rng):
    """A fit on a host int8 array past the (patched) sort budget hands the
    codes to the engine, which stages them packed and takes v2-gather or
    v2-promote: ``_apply_layout`` never runs on the whole matrix, one
    upload is counted, and the resident fit's ``top_features_`` and
    scores come out."""
    n, p = 210, 2100       # p past the auto feature tile (1152)
    codes, y, _ = _case(rng, 3, 3, n, p)
    _v2_gates(monkeypatch)
    want = make().fit(codes, y)
    _v2_gates(monkeypatch, sort_budget=1,
              promote_budget=0 if route == "gather" else None)
    y_enc = np.unique(y, return_inverse=True)[1]
    cp = (np.bincount(y_enc) / n).astype(np.float32)
    algo = type(make()).__name__.lower()
    assert TD.discrete_tier(n, p, 3, y_enc, algo, cp) == f"v2-{route}"
    layouts = []
    monkeypatch.setattr(TD, "_apply_layout",
                        lambda *a, **k: layouts.append(a) or None)
    staged = []
    orig = TD.stage_codes_packed
    monkeypatch.setattr(TD, "stage_codes_packed",
                        lambda *a, **k: staged.append(a[0]) or orig(*a, **k))
    _relief_base.reset_upload_count()
    got = make().fit(codes, y)
    assert _relief_base.uploads == 1 and not layouts
    assert len(staged) == 1 and staged[0].data_ptr() == codes.ctypes.data
    assert_array_equal(got.top_features_, want.top_features_)
    assert_allclose(got.feature_importances_, want.feature_importances_,
                    atol=ROUTE_ATOL)


def test_turf_keeps_one_copy_of_host_codes(monkeypatch, rng):
    """TuRF's fast scorer gathers columns on the device: host codes past
    the sort budget are still copied there once, whole."""
    from fastselect_tpu_torch import TuRF
    codes, y, _ = _case(rng, 2, 3, 210, 150)
    _v2_gates(monkeypatch)
    want = TuRF(MultiSURF(n_features_to_select=5), n_features_to_select=5,
                pct_remove=0.5).fit(codes, y)
    _v2_gates(monkeypatch, sort_budget=1)
    _relief_base.reset_upload_count()
    got = TuRF(MultiSURF(n_features_to_select=5), n_features_to_select=5,
               pct_remove=0.5).fit(codes, y)
    assert _relief_base.uploads == 1
    assert_array_equal(got.top_features_, want.top_features_)


def _card(monkeypatch, total_memory):
    """A CUDA device of ``total_memory`` bytes, as far as the budgets
    read it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev=None: types.SimpleNamespace(
                            total_memory=total_memory))


H100 = 85_031_714_816  # total_memory of an NVIDIA H100 80GB HBM3


@pytest.mark.parametrize("shape,source,tier", [
    ((16384, 65536), "host", "v2-sym"),          # the SNP headline
    ((16384, 65536), "tensor", "v2-sym"),
    ((30000, 2048), "host", "v2"),
    ((3000, 5000), "host", "v1"),                 # below _V2_MIN_N
    ((6000, 2_600_000), "host", "v2-promote"),    # gwas-promote
    ((6000, 2_600_000), "tensor", "v2-gather"),
    ((8192, 5_000_000), "packed", "v2-gather"),   # gwas-gather
    ((8192, 5_000_000), "host", "v2-gather"),
    ((20000, 500_000), "host", "v2"),             # under the scaled gate
])
def test_discrete_tier_names_every_tier_on_the_card(shape, source, tier,
                                                    monkeypatch):
    """The tiers of chip_smoke.py's shapes on an 80 GB card, whose budgets
    are JAX's scaled by its memory: packed staging from n p of about
    1.45e10, promotion up to about 3.7e10."""
    _card(monkeypatch, H100)
    y = np.arange(shape[0]) % 2
    assert TD.discrete_tier(*shape, 3, y, "multisurf", device="cuda",
                            source=source) == tier
    scale = H100 / (16 << 30)
    assert TD._budget(TD._DEVICE_SORT_BUDGET, "cuda") == pytest.approx(
        (6 << 30) * scale)
    assert TD._budget(TD._DEVICE_SORT_BUDGET, "cpu") == 6 << 30
    assert TD.keeps_host_codes(6000, 2_600_000, "cuda")
    assert not TD.keeps_host_codes(6000, 2_000_000, "cuda")
    assert TD.keeps_host_codes(6000, 2_000_000, "cpu")


@pytest.mark.parametrize("gates,source,tier", [
    ({}, "host", "v2-sym"),
    ({"_SYM_MAX_N": 0}, "host", "v2"),
    ({"_DEVICE_SORT_BUDGET": 0}, "host", "v2-promote"),
    ({"_DEVICE_SORT_BUDGET": 0}, "tensor", "v2-gather"),
    ({"_DEVICE_SORT_BUDGET": 0, "_PACKED_PROMOTE_BUDGET": 0}, "host",
     "v2-gather"),
    ({"_PACKED_PROMOTE_BUDGET": 0}, "packed", "v2-gather"),
    ({}, "packed", "v2-promote"),
    ({"_V2_MIN_N": 1 << 20}, "host", "v1"),
])
def test_discrete_tier_names_every_tier(gates, source, tier, monkeypatch):
    """Each tier, at the headline's shape on the CPU, under the gates a
    test or chip_smoke.py's phase 24 sets; the tier of an estimator's fit
    is the one it takes (``test_estimator_stages_host_codes_packed``)."""
    for name, value in gates.items():
        monkeypatch.setattr(TD, name, value)
    y = np.arange(16384) % 2
    assert TD.discrete_tier(16384, 65536, 3, y, "multisurf",
                            source=source) == tier


@pytest.fixture
def cpu_card(monkeypatch):
    """torch.cuda's timers and memory statistics as no-ops on the CPU."""
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)


def test_gwas_phase_rehearse(cpu_card, monkeypatch):
    """chip_smoke.py's phase 24 at a small size on the CPU, with the gates
    lowered so that each point takes the route it takes on the card, the
    card's GEMM sizes, and every product held to the int8 GEMM kernel's
    rules on the card: K contiguous in both operands, every base and row
    stride 16-byte aligned."""
    monkeypatch.setattr(TD, "_V2_MIN_N", 1)
    monkeypatch.setattr(TD, "_gemm_size", lambda v, device:
                        TD._round_up(v, TD._GEMM_ALIGN))
    gemm = TD.int8_gemm
    products = []

    def card_gemm(a, b, out, *, accumulate=False):
        TD._check_gemm(a, b, out, aligned=True)
        products.append(accumulate)
        return gemm(a, b, out, accumulate=accumulate)
    monkeypatch.setattr(TD, "int8_gemm", card_gemm)
    rs = np.random.RandomState(0)
    X = rs.randint(0, 3, (300, 2100), dtype=np.int8)
    y = rs.randint(0, 2, 300)
    X[:, 0] = 2 * y
    head = cs.timed_fit(torch.device("cpu"),
                        MultiSURF(n_features_to_select=10), X, y)
    head = dict(scores=head[0].feature_importances_, first_s=head[1],
                warm_s=[head[1]])
    # gwas-promote (200 x 2100) past the sort budget and under the promote
    # budget, gwas-gather (260 x 5001) past both
    monkeypatch.setattr(TD, "_DEVICE_SORT_BUDGET", 2.2 * 200 * 2100 - 1)
    monkeypatch.setattr(TD, "_PACKED_PROMOTE_BUDGET", 10 ** 6)
    launched = dict(_build.launches)
    res = cs.gwas_phase(torch.device("cpu"), X, y, head, sizes={
        "pack": dict(n=90, p=301),
        "promote": dict(n=200, p=2100),
        "gather": dict(n=260, p=5001, sample=16, tail=40, chunk_rows=64,
                       ref_chunk=256)})
    assert res["gwas-gather"]["windows"] == 3
    assert res["gwas-gather"]["err"] <= cs.GWAS_TOL[0]
    assert max(v["err"] for v in res["routes"].values()) <= cs.GWAS_TOL[0]
    assert _build.launches == launched
    assert True in products and False in products
