"""The port's all-discrete engine against the JAX package's, on the CPU.

Both take the same numpy inputs.  Scores: atol 3e-6, rtol 1e-5 with equal
rankings, as ``tests/test_engines.py`` holds the v2 tiers to the generic
engine (float32 pass-2 sums in another order; match counts, D and the
weights are exact).  Match counts and state codes: exactly equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

import fastselect_tpu.ops.relief_discrete as JD
import fastselect_tpu.utils.preprocessing as JP
import fastselect_tpu_torch.ops.relief_cuda as RC
import fastselect_tpu_torch.ops.relief_discrete as TD
import fastselect_tpu_torch.utils.preprocessing as TP
from fastselect_tpu_torch.interop import analysis_from_jax
from test_engines import CASES

torch.set_num_threads(2)

ATOL, RTOL = 3e-6, 1e-5


def _gates(monkeypatch, v2, sym=True):
    """Force a tier in both packages by their module gates."""
    for mod in (JD, TD):
        if v2:
            monkeypatch.setattr(mod, "_V2_MIN_N", 1)
        if not sym:
            monkeypatch.setattr(mod, "_SYM_MAX_N", 0)


def _case_data(rng, ncls, n=230, p=37):
    x = rng.randint(0, 3, (n, p)).astype(np.float32)
    y = rng.randint(0, ncls, n).astype(np.int32)
    x[:, 0] = y % 3
    cp = np.bincount(y, minlength=ncls).astype(np.float32) / n
    return x, y, cp


def _assert_matches(got, ref):
    assert got.dtype == np.float32 and got.shape == ref.shape
    assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
    assert_array_equal(np.argsort(got), np.argsort(ref))


# JAX tier -> (port tier, forced v2, sym gate open, ti given to both)
TIERS = {"v1": ("v1", False, True, None),
         "v2-mono": ("v2", True, False, None),
         "v2-streamed": ("v2", True, False, 16),
         "sym": ("v2-sym", True, True, None)}


@pytest.mark.parametrize("algo,star,k,ncls", CASES)
@pytest.mark.parametrize("tier", list(TIERS))
def test_tier_matches_jax(tier, algo, star, k, ncls, monkeypatch, rng):
    """v1, the v2 block loop (against JAX's monolithic and streamed v2)
    and v2-sym, each against the same JAX tier."""
    port_tier, v2, sym, ti = TIERS[tier]
    _gates(monkeypatch, v2, sym)
    x, y, cp = _case_data(rng, ncls)
    kw = dict(algo=algo, use_star=star, n_neighbors=k, class_probs=cp, ti=ti)
    assert TD.discrete_tier(*x.shape, 3, y, algo, cp, ti=ti) == port_tier
    _assert_matches(TD.relief_discrete_scores(x, y, **kw),
                    JD.relief_discrete_scores(x, y, **kw))


def test_v2_boundary_blocks_match_jax(monkeypatch, rng):
    """Unbalanced classes whose boundaries fall inside focal blocks (full
    span contraction) and segments of odd length."""
    _gates(monkeypatch, v2=True)
    n, p = 300, 29
    x = rng.randint(0, 3, (n, p)).astype(np.float32)
    y = np.array([0] * 201 + [1] * 80 + [2] * 19, np.int32)
    x[:, 1] = (y == 1) * 2.0
    layout = TD._class_sorted_layout(y, 64)
    assert None in layout[3]
    assert [s for _, s in layout[2]] == [201, 80, 19]
    got = TD.relief_discrete_scores(x, y, algo="multisurf", ti=64)
    _assert_matches(got, JD.relief_discrete_scores(x, y, algo="multisurf",
                                                   ti=64))


def test_relieff_without_class_probs_takes_v1(monkeypatch, rng):
    _gates(monkeypatch, v2=True)
    x = rng.randint(0, 3, (120, 15)).astype(np.float32)
    y = rng.randint(0, 3, 120).astype(np.int32)
    assert TD._v2_layout(y, 120, 8, "relieff", None) is None
    assert TD.discrete_tier(120, 15, 3, y, "relieff") == "v1"
    got = TD.relief_discrete_scores(x, y, algo="relieff", n_neighbors=4)
    assert np.isfinite(got).all()
    _assert_matches(got, JD.relief_discrete_scores(x, y, algo="relieff",
                                                   n_neighbors=4))


def _codes(rng, n, p, s=3):
    return rng.randint(0, s, (n, p)).astype(np.int8)


@pytest.mark.parametrize("n_states", [2, 3, 5])
def test_match_rows_exact(n_states, rng):
    codes = _codes(rng, 48, 64, n_states)
    ci = codes[8:24]
    got = TD._match_rows(torch.from_numpy(ci), torch.from_numpy(codes), 16,
                         n_states)
    ref = np.asarray(JD._match_rows(jnp.asarray(ci), jnp.asarray(codes), 16,
                                    n_states))
    assert got.dtype == torch.int32
    assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("n_states", [2, 3])
def test_onehot_and_match_matrix_sym_exact(n_states, rng):
    codes = _codes(rng, 48, 64, n_states)
    ti, ft = 16, 32
    onehot = TD._build_onehot(torch.from_numpy(codes), ft, n_states)
    ref_onehot = JD._build_onehot(jnp.asarray(codes), ft=ft,
                                  n_states=n_states)
    assert_array_equal(onehot.numpy(), np.asarray(ref_onehot))
    # pass 2's transposed tiles hold the same one-hot
    onehot_t = TD._build_onehot_t(torch.from_numpy(codes), ft, n_states)
    sft = n_states * ft
    for t in range(64 // ft):
        assert torch.equal(onehot_t[t], onehot[:, t * sft:(t + 1) * sft].t())
    nb = 48 // ti
    pairs = tuple((i, j) for i in range(nb) for j in range(i, nb))
    ref = JD._match_matrix_sym(ref_onehot, ti=ti, ft=ft, n_states=n_states,
                               pairs=pairs)
    got = TD._match_matrix_sym(onehot, ti)
    assert_array_equal(got.numpy(), np.asarray(ref))
    assert torch.equal(got, got.t())


@pytest.mark.parametrize("f_chunk", [None, 1, 2])
def test_codes_match_encode_discrete(f_chunk, rng):
    x = np.array([[3.5, 10.0, 0.0], [3.5, -2.0, 1.0], [7.0, 10.0, -0.5],
                  [-1.0, -2.0, 1.0]], np.float32)
    codes, s = TD.encode_discrete(x, f_chunk=f_chunk)
    assert s == 3
    assert_array_equal(codes[:, 0], [1, 1, 2, 0])
    assert_array_equal(codes[:, 1], [1, 0, 1, 0])
    x = np.concatenate([x, rng.randint(-2, 3, (9, 3)) * 0.5])
    codes, s = TD.encode_discrete(x, f_chunk=f_chunk)
    ref_codes, ref_s = JD.encode_discrete(x, f_chunk=f_chunk)
    assert codes.dtype == np.int8 and s == ref_s
    assert_array_equal(codes, ref_codes)


@pytest.mark.parametrize("chunk_elems", [1, 40, 1 << 26])
def test_analysis_codes_match_jax(monkeypatch, chunk_elems, rng):
    """All-discrete X: the analysis returns JAX's codes and n_states and
    no float copy; mixed X keeps its float copy and gets the same codes
    for its discrete columns (the hybrid engine reads them)."""
    monkeypatch.setattr(TP, "_SORT_CHUNK_ELEMS", chunk_elems)
    x = (rng.randint(0, 4, (20, 7)) * 1.5 - 2).astype(np.float32)
    fa = TP.analyze_features(torch.from_numpy(x), 10)
    ref_codes, ref_s = JD.encode_discrete(x)
    assert fa.x_dev is None and fa.n_states == ref_s == 4
    assert_array_equal(fa.codes.numpy(), ref_codes)
    x[:, 3] = rng.rand(20)
    fa = TP.analyze_features(torch.from_numpy(x), 10)
    assert fa.x_dev is not None and fa.n_states == 4
    disc = np.arange(7) != 3
    assert_array_equal(fa.is_discrete.numpy(), disc)
    assert_array_equal(fa.codes.numpy()[:, disc], ref_codes[:, disc])


def test_analysis_from_jax_carries_codes(rng):
    x = rng.randint(0, 3, (12, 5)).astype(np.float32)
    codes, s = JD.encode_discrete(x)
    fa_jax = JP.FeatureAnalysis(np.ones(5, bool), np.ones(5, np.float32),
                                codes=codes, n_states=s)
    fa = analysis_from_jax(fa_jax)
    assert fa.codes.dtype == torch.int8 and fa.n_states == s
    assert_array_equal(fa.codes.numpy(), codes)
    assert analysis_from_jax(JP.FeatureAnalysis(
        np.zeros(5, bool), np.ones(5, np.float32))).codes is None


def test_tile_sizes_and_sym_zone_match_jax():
    for n in (1, 7, 100, 4096, 16384, 24576, 24577, 30000, 98304):
        for p in (1, 128, 512, 5000, 65536, 200000):
            for s in (2, 3, 10):
                assert (TD._discrete_tile_sizes(n, p, s)
                        == JD._discrete_tile_sizes(n, p, s)), (n, p, s)
                for n_pad in (n, JD._round_up(n, 4096)):
                    assert (TD._sym_zone(n_pad, p, s)
                            == JD._sym_zone(n_pad, p, s)), (n_pad, p, s)


@pytest.mark.parametrize("shape,algo,ncls,tier", [
    ((16384, 65536), "multisurf", 2, "v2-sym"),   # the SNP headline
    ((30000, 2048), "multisurf", 2, "v2"),        # n_pad 32768 > 24576
    ((8192, 16384), "surf", 2, "v2-sym"),
    ((3000, 5000), "relieff", 3, "v1"),           # below _V2_MIN_N
])
def test_tiers_of_the_card_shapes(shape, algo, ncls, tier):
    y = np.arange(shape[0]) % ncls
    cp = np.full(ncls, 1.0 / ncls, np.float32)
    for dev in ("cpu", "cuda"):
        assert TD.discrete_tier(*shape, 3, y, algo, cp, device=dev) == tier


def test_gemm_sizes_on_cuda():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert TD._gemm_size(8, cuda) == 16
    assert TD._gemm_size(44, cuda) == 48
    assert TD._gemm_size(12, cuda) == 16
    assert TD._gemm_size(12, cpu) == 12
    y = np.arange(10) % 2
    layout, ti, ft = TD._tiles_and_layout(10, 5, 2, y, "surf", None, cuda)
    assert (layout, ti, ft) == (None, 16, 128)


def test_scores_from_numpy_tensor_and_float_x(rng):
    codes = _codes(rng, 64, 23)
    codes[:, 4] = 2 * (codes[:, 4] == 2)     # a column with states {0, 2}
    y = rng.randint(0, 2, 64).astype(np.int32)
    kw = dict(algo="multisurf", use_star=True)
    a = TD.relief_discrete_scores(None, y, codes=codes, n_states=3, **kw)
    b = TD.relief_discrete_scores(None, y, codes=torch.from_numpy(codes),
                                  **kw)
    c = TD.relief_discrete_scores(codes.astype(np.float64), y, **kw)
    d = TD.relief_discrete_scores(torch.from_numpy(codes).float(), y, **kw)
    assert_array_equal(a, b)
    assert_array_equal(c, d)
    assert_allclose(c, a, atol=1e-7)
    _assert_matches(a, JD.relief_discrete_scores(None, y, codes=codes,
                                                 n_states=3, **kw))


def test_bitwise_repeatable(monkeypatch, rng):
    _gates(monkeypatch, v2=True)
    x = rng.randint(0, 3, (300, 31)).astype(np.float32)
    y = rng.randint(0, 2, 300).astype(np.int32)
    for tier_ti in (None, 64):
        a = TD.relief_discrete_scores(x, y, algo="multisurf", ti=tier_ti)
        b = TD.relief_discrete_scores(x, y, algo="multisurf", ti=tier_ti)
        assert_array_equal(a, b)


@pytest.mark.parametrize("s0,sl", [(0, 5), (3, 13), (7, 1), (9, 31),
                                   (40, 24), (17, 47)])
def test_segment_padding_equals_int32_matmul(s0, sl, rng):
    """A segment of any length, padded for the GEMM, gives the product of
    the segment alone."""
    mat = torch.from_numpy(rng.randint(-1, 2, (24, 64)).astype(np.int8))
    aa = torch.from_numpy(rng.randint(0, 2, (64, 40)).astype(np.int8))
    op, r0, r1 = TD._segment_operand(mat, s0, sl)
    assert r0 % 8 == 0 and op.shape[1] % 8 == 0 and r0 <= s0
    assert r1 >= s0 + sl and op.shape == (24, r1 - r0)
    want = mat[:, s0:s0 + sl].int() @ aa[s0:s0 + sl].int()
    assert torch.equal(TD._dot_t(op, aa.t().contiguous()[:, r0:r1]), want)


def test_gemm_ops_counts_every_product(monkeypatch, rng):
    """v1, one focal block at the card's GEMM sizes: pass 1 and one pass-2
    product per rule and feature tile, each (ti, S*ft) x n_pad, all through
    the int8 GEMM and held to its kernel's rules on the card (K contiguous
    in both operands, 16-byte aligned bases and row strides)."""
    monkeypatch.setattr(TD, "_gemm_size", lambda v, device:
                        TD._round_up(v, TD._GEMM_ALIGN))
    gemm = TD.int8_gemm
    ops = []

    def card_gemm(a, b, out, *, accumulate=False):
        TD._check_gemm(a, b, out, aligned=True)
        ops.append(2 * a.shape[0] * a.shape[1] * b.shape[0])
        return gemm(a, b, out, accumulate=accumulate)
    monkeypatch.setattr(TD, "int8_gemm", card_gemm)
    codes = _codes(rng, 40, 300)
    y = rng.randint(0, 2, 40)
    TD.reset_gemm_ops()
    TD.relief_discrete_scores(None, y, codes=codes, algo="multisurf",
                              ft=128)
    ti, n_pad, sft, nf = 48, 48, 3 * 128, 3
    assert TD.gemm_ops == sum(ops) == nf * 3 * (2 * ti * sft * n_pad)


def test_fits_route_by_data(monkeypatch, rng):
    """All-discrete fits go through the int8 GEMM engine and never reach
    a fused-pass wrapper; mixed fits take the hybrid engine (GEMMs and the
    continuous passes, not the fused engine); continuous fits take the
    fused engine and run no GEMM."""
    from fastselect_tpu_torch import MultiSURF, ReliefF, SURF

    calls = {"fused": 0, "pass1": 0, "pass2": 0}

    def counted(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(RC, "relief_fused_scores",
                        counted("fused", RC.relief_fused_scores))
    monkeypatch.setattr(RC, "dist_matrix_ref",
                        counted("pass1", RC.dist_matrix_ref))
    monkeypatch.setattr(RC, "accumulate_ref",
                        counted("pass2", RC.accumulate_ref))
    X = rng.randint(0, 3, (50, 12))
    y = rng.randint(0, 2, 50)
    mixed = X.astype(np.float64)
    mixed[:, 5:] = rng.rand(50, 7)
    for est in (MultiSURF(), SURF(), ReliefF()):
        for data, route in ((X, "discrete"),
                            (X.astype(np.float32), "discrete"),
                            (mixed, "hybrid"), (rng.rand(50, 12), "fused")):
            TD.reset_gemm_ops()
            calls.update(fused=0, pass1=0, pass2=0)
            est.set_params(backend="cpu").fit(data, y)
            if route == "discrete":
                assert TD.gemm_ops > 0 and not any(calls.values())
            elif route == "hybrid":
                assert TD.gemm_ops > 0 and calls["fused"] == 0
                assert calls["pass1"] > 0 and calls["pass2"] > 0
            else:
                assert TD.gemm_ops == 0 and min(calls.values()) > 0


def test_too_many_states_raise_and_route_to_fused(rng):
    from fastselect_tpu_torch import MultiSURF
    x = np.tile(np.arange(130, dtype=np.float32)[:, None], (1, 3))
    y = np.arange(130) % 2
    with pytest.raises(ValueError, match="at most 127"):
        TD.relief_discrete_scores(x, y, algo="multisurf")
    fa = TP.analyze_features(torch.from_numpy(x), 200)
    assert fa.codes is None and fa.n_states == 130
    TD.reset_gemm_ops()
    m = MultiSURF(discrete_limit=200, backend="cpu").fit(x, y)
    assert m.is_discrete_.all() and TD.gemm_ops == 0
