"""The discrete engine's window kernels, through their plain twins, against
the JAX package on the CPU.

``window_onehot`` builds a window's one-hot GEMM operand and
``window_partials`` reduces pass 2's products at the focal states; on the
card each is a kernel of ``csrc/relief_discrete.cu``, here its twin
(``window_onehot_ref``, ``window_partials_ref``).  One-hots equal JAX's
``_onehot_flat(_codes_window(...))`` exactly (packed windows remapped
from JAX's plane order).  Pass 2's partials (over n, as scores are) and
whole fits are held to JAX at ``test_torch_relief_discrete.py``'s atol
3e-6, rtol 1e-5 with equal rankings (float32 sums over focal rows in
another order); SURF's exact-int path equals JAX's and the eager chain
that the kernel replaced bit for bit.  Then ``chip_smoke.py``'s phase 27
is rehearsed at a small size.
"""

import functools
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

import chip_smoke as cs
import fastselect_tpu.ops.relief_discrete as JD
import fastselect_tpu_torch.ops.relief_discrete as TD
from fastselect_tpu_torch import _build
from fastselect_tpu_torch.ops.relief import pair_weight_rules

torch.set_num_threads(2)

ATOL, RTOL = 3e-6, 1e-5
# (algo, use_star, k, classes): test_engines.py's CASES, ReliefF on 3
CASES = [("multisurf", False, 0, 2), ("multisurf", True, 0, 2),
         ("surf", False, 0, 2), ("surf", True, 0, 2),
         ("relieff", False, 5, 3)]
# class sizes in row order: block 0 of 32 rows holds one class, block 1
# straddles a boundary
COUNTS = {2: (40, 56), 3: (40, 20, 36)}


def _card_sizes(monkeypatch):
    """Windows widened to the card's GEMM sizes (multiples of 8)."""
    monkeypatch.setattr(TD, "_gemm_size", lambda v, device:
                        TD._round_up(v, 8))


def _pack(codes, bits):
    """Codes packed 8 // bits a byte, little-endian (``_pack_codes``'s
    layout, at any width)."""
    per = 8 // bits
    n, p = codes.shape
    u = np.zeros((n, -(-p // per) * per), np.uint8)
    u[:, :p] = codes
    v = u.reshape(n, -1, per)
    return sum(v[:, :, i] << (bits * i) for i in range(per)).astype(np.uint8)


@functools.partial(jax.jit, static_argnames=("ft", "bits", "n_states"))
def _jax_onehot(codes_a, off, *, ft, bits, n_states):
    return JD._onehot_flat(JD._codes_window(codes_a, off, ft, bits),
                           n_states), JD._codes_window(codes_a, off, ft, bits)


def _natural(win, per):
    """Columns of a JAX plane-order window in natural order."""
    return win[:, JD._plane_to_natural(np.arange(win.shape[1]), per)]


@pytest.mark.parametrize("bits,s", [(0, 5), (1, 2), (2, 3), (4, 9)])
@pytest.mark.parametrize("gathered", [False, True])
@pytest.mark.parametrize("card", [False, True])
def test_window_onehot_ref_equals_jax(bits, s, gathered, card, monkeypatch,
                                      rng):
    """The twin's one-hot of a window, of all rows or of rows an index
    names, equals JAX's, state by state; the GEMM's padded columns are
    0, and the transposed form is its transpose."""
    if card:
        _card_sizes(monkeypatch)
    n, p, off = 29, 48, 8
    w = 16 if bits == 1 else 20           # whole bytes of codes
    codes = rng.randint(0, s, (n, p)).astype(np.int8)
    codes_a = codes if bits == 0 else _pack(codes, bits)
    rows = rng.permutation(n)[:17] if gathered else None
    got = TD.window_onehot_ref(
        torch.from_numpy(codes_a), off, w, s, bits,
        None if rows is None else torch.from_numpy(rows))
    sub = codes_a if rows is None else codes_a[rows]
    hot, win = _jax_onehot(jnp.asarray(sub), off, ft=w, bits=bits,
                           n_states=s)
    per = 8 // bits if bits else 1
    win = _natural(np.asarray(win), per)
    assert_array_equal(win, (codes if rows is None else codes[rows])
                       [:, off:off + w])
    want = np.asarray(JD._onehot_flat(jnp.asarray(win), s))
    wp = TD._round_up(w, 8) if card else w
    assert got.shape == (sub.shape[0], s * wp) and got.dtype == torch.int8
    for c in range(s):
        assert_array_equal(got[:, c * wp:c * wp + w].numpy(),
                           want[:, c * w:(c + 1) * w])
        assert not got[:, c * wp + w:(c + 1) * wp].any()
        assert_array_equal(
            got[:, c * wp:c * wp + w].numpy(),
            _natural(np.asarray(hot)[:, c * w:(c + 1) * w], per))
    got_t = TD.window_onehot_ref(
        torch.from_numpy(codes_a), off, w, s, bits,
        None if rows is None else torch.from_numpy(rows), transpose=True)
    assert torch.equal(got_t, got.t())


@pytest.mark.parametrize("transpose", [False, True])
def test_window_onehot_writes_out_and_counts_no_launch(transpose, rng):
    """On the CPU the wrapper runs its twin (no launch counted), into
    ``out`` when given, a slice of a wider matrix included; it raises on
    codes of the wrong type."""
    codes = torch.from_numpy(rng.randint(0, 3, (24, 40)).astype(np.int8))
    before = dict(_build.launches)
    want = TD.window_onehot_ref(codes, 8, 16, 3, transpose=transpose)
    assert torch.equal(TD.window_onehot(codes, 8, 16, 3,
                                        transpose=transpose), want)
    big = torch.full((want.shape[0], 2 * want.shape[1]), 7,
                     dtype=torch.int8)
    view = big[:, want.shape[1]:]
    assert TD.window_onehot(codes, 8, 16, 3, transpose=transpose,
                            out=view).data_ptr() == view.data_ptr()
    assert torch.equal(view, want) and (big[:, :want.shape[1]] == 7).all()
    assert _build.launches == before
    with pytest.raises(TypeError, match="int8"):
        TD.window_onehot(codes.to(torch.int16), 0, 8, 3)
    with pytest.raises(ValueError, match="out must be"):
        TD.window_onehot(codes, 0, 8, 3, out=torch.empty((24, 3),
                                                         dtype=torch.int8))
    with pytest.raises(ValueError, match="not inside"):
        TD.window_onehot(codes, 32, 16, 3)
    with pytest.raises(ValueError, match="packed byte"):
        TD.window_onehot(codes.view(torch.uint8), 2, 8, 3, bits=2)


def test_build_onehot_tiles_are_windows(rng):
    """The precomputed one-hots hold each f-tile's window operand."""
    codes = torch.from_numpy(rng.randint(0, 3, (40, 64)).astype(np.int8))
    hot, hot_t = TD._build_onehot(codes, 16, 3), TD._build_onehot_t(
        codes, 16, 3)
    for t in range(4):
        want = TD.window_onehot_ref(codes, 16 * t, 16, 3)
        assert torch.equal(hot[:, 48 * t:48 * (t + 1)], want)
        assert torch.equal(hot_t[t], want.t())


@pytest.mark.parametrize("bits,s", [(0, 3), (2, 3), (4, 5)])
@pytest.mark.parametrize("window_bytes", [0, 1 << 28])
def test_match_rows_windows_equal_jax(bits, s, window_bytes, monkeypatch,
                                      rng):
    """Pass 1's counts equal JAX's ``_match_rows_raw`` exactly whether each
    window is one feature tile (ragged last window) or pass 1 widens it
    to many (``_PASS1_ONEHOT_BYTES``), on the card's GEMM sizes, through
    a row index."""
    _card_sizes(monkeypatch)
    monkeypatch.setattr(TD, "_PASS1_ONEHOT_BYTES", window_bytes)
    n, p, ft = 41, 44, 16
    codes = rng.randint(0, s, (n, p)).astype(np.int8)
    codes_a = codes if bits == 0 else _pack(codes, bits)
    focal = rng.permutation(n)[:12]
    rows = rng.permutation(n)
    got = TD._match_rows(torch.from_numpy(codes_a[focal]),
                         torch.from_numpy(codes_a), ft, s, bits,
                         torch.from_numpy(rows))
    want = np.asarray(JD._match_rows_raw(
        jnp.asarray(codes_a[focal]), jnp.asarray(codes_a[rows]), ft, s,
        bits=bits))
    assert_array_equal(got.numpy(), want)


def test_pass1_width_at_the_card_windows():
    """Pass 1's window against 4,096 focal rows at gwas-gather (8,192
    rows, FT 1,024) is thirteen tiles, at the headline's rows (16,384, FT
    2,048) four, at snp-paper's (32,768, FT 1,024) six, and never under
    one; its two one-hots and the counts never take more bytes than a
    window of ``_PASS1_ONEHOT_BYTES`` alone with its own int32 product
    beside the counts."""
    assert TD.pass1_width(8192, 3, 1024, 4096) == 13312
    assert TD.pass1_width(16384, 3, 2048, 4096) == 8192
    assert TD.pass1_width(32768, 3, 1024, 4096) == 6144
    assert TD.pass1_width(1 << 30, 3, 16, 8) == 16
    for n, s, ft, ti in [(8192, 3, 1024, 4096), (16384, 3, 2048, 4096),
                         (32768, 3, 1024, 4096), (32768, 5, 1024, 4096),
                         (300, 3, 128, 48), (4096, 2, 2048, 4096)]:
        held = ft * max(1, TD._PASS1_ONEHOT_BYTES // (n * s * ft))
        live = (ti + n) * s * TD.pass1_width(n, s, ft, ti) + 4 * ti * n
        assert live <= (ti + n) * s * held + 8 * ti * n, (n, s, ft, ti)


def test_partials_plan_covers_the_rows():
    """Spans cover every focal row once, a multiple of 8 rows each, and
    fill about 1,056 blocks at the card's windows."""
    for ti, w in [(4096, 2048), (4096, 1024), (4096, 7), (33, 2048),
                  (1, 1)]:
        spans, span = TD.partials_plan(ti, w)
        assert span % 8 == 0 and (spans - 1) * span < ti <= spans * span
    assert TD.partials_plan(4096, 2048) == (17, 248)
    assert TD.partials_plan(4096, 1024) == (32, 128)


def _layout_case(rng, algo, star, k, ncls, s=3, n=96, p=37, ti=32):
    """Codes and labels in class order (class sizes COUNTS), padded to
    (n, p_pad) as ``_apply_layout`` pads them: (cpad, yv, valid, layout,
    class_probs)."""
    y = np.repeat(np.arange(ncls), COUNTS[ncls])
    codes = rng.randint(0, s, (n, p)).astype(np.int8)
    codes[:, 0] = y % s
    layout = TD._class_sorted_layout(y, ti)
    cpad, yv, valid = TD._apply_layout(torch.from_numpy(codes), y,
                                       layout[1], layout[4], 48)
    cp = np.bincount(y, minlength=ncls).astype(np.float32) / n
    return cpad, yv, valid, layout, cp


def _block_rules(cpad, yv, valid, cp, block, ti, s, algo, star, k,
                 ft=16):
    """The port's weight rules of focal block ``block``: (ci, rules)."""
    blk = slice(block * ti, (block + 1) * ti)
    ci = cpad[blk]
    D = (cpad.shape[1] - TD._match_rows(ci, cpad, ft, s)).to(torch.float32)
    rules = pair_weight_rules(
        D, yv[blk], valid[blk], torch.arange(block * ti, (block + 1) * ti),
        yv, valid, torch.tensor(float(cpad.shape[0])), torch.from_numpy(cp),
        algo=algo, use_star=star, k=k)
    return ci, rules


def _jax_rules(rules, cols=None):
    """The rules as JAX arrays, their columns put at ``cols``."""
    out = []
    for m, r in rules:
        m = m.numpy()
        if cols is not None:
            full = np.zeros_like(m)
            full[:, cols] = m
            m = full
        out.append((jnp.asarray(m), jnp.asarray(r.numpy())))
    return out


_jax_plan = jax.jit(JD._accumulate_plan, static_argnames=(
    "plan", "seg_starts", "seg_lens", "ft", "n_states", "use_star"))


def _eager(monkeypatch):
    """Route the engine's window epilogue through the eager chain it ran
    before the kernel (``chip_smoke.eager_window_partials``)."""
    def eager(self, prods, off, w, *, out=None):
        part = cs.eager_window_partials(prods, self.coeffs, self.ci, off, w,
                                        self.n_states, self.total_w,
                                        self.bits)
        return part if out is None else out.copy_(part)
    monkeypatch.setattr(TD.WindowPartials, "__call__", eager)


@pytest.mark.parametrize("algo,star,k,ncls", CASES)
@pytest.mark.parametrize("block", [0, 1])      # single-class, straddling
@pytest.mark.parametrize("ragged", [False, True])
def test_accumulate_plan_equals_jax(algo, star, k, ncls, block, ragged,
                                    monkeypatch, rng):
    """Pass 2's plan over one focal block equals JAX's ``_accumulate_plan``
    (a block of one class, whose operands may sum several segments, and a
    straddling one); with ``ragged`` the port's last window is narrower
    (48 features in tiles of 20) and JAX's tiles are 8; padded features
    score exactly 0 where the sums are exact, else as JAX's do.  SURF's
    exact-int path equals JAX's and the eager chain bit for bit."""
    s, ti = 3, 32
    cpad, yv, valid, layout, cp = _layout_case(rng, algo, star, k, ncls)
    classes, _, segments, block_class, n_pad = layout
    pos = block_class[block]
    assert (pos is None) == (block == 1)
    plan = TD._plan_segments(algo, star, tuple(int(c) for c in classes), pos)
    segs_all = list(segments) + [(0, n_pad)]
    ci, rules = _block_rules(cpad, yv, valid, cp, block, ti, s, algo, star, k)
    ft_t, ft_j = (20, 8) if ragged else (16, 16)
    got = TD._accumulate_plan(ci, cpad, rules, plan, segs_all, ft_t, s, star)
    want = np.asarray(_jax_plan(
        jnp.asarray(ci.numpy()), jnp.asarray(cpad.numpy()),
        _jax_rules(rules), tuple((sp, tuple(sg)) for sp, sg in plan),
        tuple(a for a, _ in segs_all), tuple(b for _, b in segs_all),
        ft_j, s, star))
    _eager(monkeypatch)
    parent = TD._accumulate_plan(ci, cpad, rules, plan, segs_all, ft_t, s,
                                 star)
    assert got.dtype == torch.float32 and got.shape == (48,)
    exact = algo == "surf"
    if exact:
        assert_array_equal(got.numpy(), want)
        assert_array_equal(got.numpy(), parent.numpy())
        assert not got[37:].any()
    else:
        assert_allclose(got.numpy() / n_pad, want / n_pad, atol=ATOL,
                        rtol=RTOL)
        assert_allclose(got.numpy() / n_pad, parent.numpy() / n_pad,
                        atol=ATOL, rtol=RTOL)
        assert_allclose(got[37:].numpy() / n_pad, 0, atol=ATOL)
    assert_array_equal(np.argsort(got[:37].numpy(), kind="stable")[-5:],
                       np.argsort(want[:37], kind="stable")[-5:])


_jax_gather = jax.jit(JD._accumulate_plan_gather, static_argnames=(
    "plan", "ft", "n_states", "use_star", "bits"))


@pytest.mark.parametrize("algo,star,k,ncls", CASES)
@pytest.mark.parametrize("bits,s", [(0, 3), (2, 3), (4, 5)])
def test_gather_windows_equal_jax(algo, star, k, ncls, bits, s, rng):
    """The gather route's pass 2 (codes in their own row order, packed or
    not, read through a class-order index, a ragged last window) equals
    JAX's ``_accumulate_plan_gather``, whose last window overlaps its
    neighbour and whose packed windows are in plane order."""
    n, p, ti, ft = 96, 40, 32, 16
    y = rng.permutation(np.repeat(np.arange(ncls), COUNTS[ncls]))
    codes = rng.randint(0, s, (n, p)).astype(np.int8)
    codes[:, 0] = y % s
    codes_a = codes if bits == 0 else _pack(codes, bits)
    classes, perm, segments, block_class, n_pad = TD._class_sorted_layout(
        y, ti)
    rows = torch.from_numpy(perm.astype(np.int64))
    ta = torch.from_numpy(codes_a)
    yv, valid = TD._sorted_labels(y, perm, n_pad, torch.device("cpu"))
    cp = np.bincount(y, minlength=ncls).astype(np.float32) / n
    per = 8 // bits if bits else 1
    offs = [0, 16, (p - ft) // per * per]       # JAX's overlapping tail
    idx_arrays, padvs = [], []
    for s0, sl in segments:
        L = TD._round_up(sl, 8)
        idx, pv = np.zeros(L, np.int32), np.zeros(L, np.int8)
        idx[:sl], pv[:sl] = perm[s0:s0 + sl], 1
        idx_arrays.append(jnp.asarray(idx))
        padvs.append(jnp.asarray(pv))
    for block in (0, 1):
        blk = slice(block * ti, (block + 1) * ti)
        ci = ta[rows[blk]]
        D = (TD._unpacked_width(ta, bits)
             - TD._match_rows(ci, ta, ft, s, bits, rows)).to(torch.float32)
        rules = pair_weight_rules(
            D, yv[blk], valid[blk], torch.arange(block * ti,
                                                 (block + 1) * ti),
            yv, valid, torch.tensor(float(n)), torch.from_numpy(cp),
            algo=algo, use_star=star, k=k)
        plan = TD._plan_segments(algo, star, tuple(int(c) for c in classes),
                                 block_class[block])
        got = TD._accumulate_plan(ci, ta, rules, plan,
                                  list(segments) + [(0, n_pad)], ft, s,
                                  star, bits=bits, rows=rows)[:p].numpy()
        out = np.asarray(_jax_gather(
            jnp.asarray(ci.numpy()), jnp.asarray(codes_a),
            _jax_rules(rules, perm), tuple((sp, tuple(sg)) for sp, sg in plan),
            tuple(idx_arrays), tuple(padvs), jnp.asarray(offs, jnp.int32), ft,
            s, star, bits=bits))
        want = np.zeros(p, np.float32)
        for i, off in enumerate(offs):
            win = JD._plane_to_natural(out[i], per) if bits else out[i]
            want[off:off + ft] = win[:min(ft, p - off)]
        if algo == "surf":
            assert_array_equal(got, want)
        else:
            assert_allclose(got / n, want / n, atol=ATOL, rtol=RTOL)


_jax_discrete = jax.jit(JD._accumulate_discrete, static_argnames=(
    "ft", "n_states", "exact_int"))


@pytest.mark.parametrize("algo,star,k,ncls", CASES)
def test_accumulate_discrete_equals_jax(algo, star, k, ncls, monkeypatch,
                                        rng):
    """v1's pass 2 (every rule over all samples, unsorted rows, two focal
    blocks) equals JAX's ``_accumulate_discrete``; SURF's int32 path
    (int32 coefficients) equals it and the eager chain bit for bit."""
    s, ti, ft = 3, 32, 16
    y = rng.randint(0, ncls, 96)
    codes = torch.from_numpy(rng.randint(0, s, (96, 48)).astype(np.int8))
    yv = torch.from_numpy(y.astype(np.int64))
    valid = torch.ones(96)
    cp = np.bincount(y, minlength=ncls).astype(np.float32) / 96
    exact = algo == "surf"
    for block in (0, 2):
        ci, rules = _block_rules(codes, yv, valid, cp, block, ti, s, algo,
                                 star, k)
        got = TD._accumulate_discrete(ci, codes, rules, ft, s,
                                      exact_int=exact)
        want = np.asarray(_jax_discrete(
            jnp.asarray(ci.numpy()), jnp.asarray(codes.numpy()),
            _jax_rules(rules), ft=ft, n_states=s, exact_int=exact))
        with monkeypatch.context() as mp:
            _eager(mp)
            parent = TD._accumulate_discrete(ci, codes, rules, ft, s,
                                             exact_int=exact)
        if exact:
            assert_array_equal(got.numpy(), want)
            assert_array_equal(got.numpy(), parent.numpy())
        else:
            assert_allclose(got.numpy() / 96, want / 96, atol=ATOL,
                            rtol=RTOL)
            assert_allclose(got.numpy() / 96, parent.numpy() / 96,
                            atol=ATOL, rtol=RTOL)


def test_accumulate_discrete_many_classes_equals_jax(rng):
    """v1's pass 2 for ReliefF on 60 classes (61 rules, so 61 operands a
    window, the tier of more than 16 classes) equals JAX's
    ``_accumulate_discrete`` within the tolerance."""
    s, ti, ft, n, ncls = 3, 64, 16, 240, 60
    y = np.repeat(np.arange(ncls), n // ncls)
    rng.shuffle(y)
    codes = torch.from_numpy(rng.randint(0, s, (n, 48)).astype(np.int8))
    codes[:, 0] = torch.from_numpy((y % s).astype(np.int8))
    yv = torch.from_numpy(y.astype(np.int64))
    cp = np.bincount(y, minlength=ncls).astype(np.float32) / n
    for block in (0, 2):
        ci, rules = _block_rules(codes, yv, torch.ones(n), cp, block, ti, s,
                                 "relieff", False, 5)
        assert len(rules) == ncls + 1
        got = TD._accumulate_discrete(ci, codes, rules, ft, s)
        want = np.asarray(_jax_discrete(
            jnp.asarray(ci.numpy()), jnp.asarray(codes.numpy()),
            _jax_rules(rules), ft=ft, n_states=s, exact_int=False))
        assert got.shape == (48,)
        assert_allclose(got.numpy() / n, want / n, atol=ATOL, rtol=RTOL)


def test_window_partials_block_reuses_buffers_and_checks(rng):
    """``WindowPartials`` hands out the same product buffers to every
    window of one width (the ragged last window a prefix of them), reduces
    them as ``window_partials`` does, and refuses products that do not
    match its operands."""
    ti, s = 10, 3
    ci = torch.from_numpy(rng.randint(0, s, (ti, 14)).astype(np.int8))
    coeffs = [torch.from_numpy(rng.rand(ti).astype(np.float32)), None]
    total_w = torch.tensor(50.25)
    epi = TD.WindowPartials([1, 3], coeffs, ci, s, total_w)
    full, again, ragged = epi.products(6), epi.products(6), epi.products(2)
    assert [len(sp) for sp in full] == [1, 3]
    for a, b, c in zip(sum(full, []), sum(again, []), sum(ragged, [])):
        assert a.data_ptr() == b.data_ptr() and a.shape == (ti, s * 6)
        assert c.shape == (ti, s * 2) and c.is_contiguous()
    for w, prods in ((6, full), (2, ragged)):
        for q in sum(prods, []):
            q.copy_(torch.from_numpy(rng.randint(-9, 9, q.shape).astype(
                np.int32)))
        got = epi(prods, 8 if w == 6 else 12, w)
        want = TD.window_partials(prods, coeffs, ci, 8 if w == 6 else 12, w,
                                  s, total_w)
        assert_array_equal(got.numpy(), want.numpy())
    with pytest.raises(ValueError, match="products per operand"):
        epi(full[:1], 8, 6)
    with pytest.raises(ValueError, match="float32"):
        TD.WindowPartials([1], [coeffs[0].double()], ci, s, total_w)
    with pytest.raises(ValueError, match="at least one product"):
        TD.WindowPartials([0], [None], ci, s, total_w)


def test_window_partials_ref_is_the_formula(rng):
    """The twin is total_w - sum_i v[i, f], v summing each operand's
    products (several segments in int32 first) at the focal state, times
    its coefficient, in plan order; a None coefficient is 1."""
    ti, w, s = 10, 6, 3
    ci = torch.from_numpy(rng.randint(0, s, (ti, w + 4)).astype(np.int8))
    prods = [[torch.from_numpy(rng.randint(-50, 50, (ti, s * w)).astype(
        np.int32)) for _ in range(segs)] for segs in (1, 3)]
    coeffs = [torch.from_numpy(rng.rand(ti).astype(np.float32)), None]
    total_w = torch.tensor(123.5)
    got = TD.window_partials(prods, coeffs, ci, 4, w, s, total_w)
    want = np.zeros(w, np.float64)
    codes = ci.numpy()[:, 4:]
    for f in range(w):
        for i in range(ti):
            col = codes[i, f] * w + f
            v = np.float32(0)
            for seg_prods, coeff in zip(prods, coeffs):
                q = sum(int(p[i, col]) for p in seg_prods)
                v += np.float32(q) * (1 if coeff is None else coeff[i].item())
            want[f] += v
    assert_allclose(got.numpy(), 123.5 - want, rtol=1e-5)
    exact = TD.window_partials([p[:1] for p in prods], [None, None], ci, 4,
                               w, s, torch.tensor(7, dtype=torch.int64))
    assert exact.dtype == torch.float32
    assert_array_equal(exact.numpy(), 7 - np.asarray(
        [sum(int(p[0][i, codes[i, f] * w + f]) for p in prods
             for i in range(ti)) for f in range(w)], np.float32))
    with pytest.raises(ValueError, match="contiguous int32"):
        TD.window_partials([[prods[0][0].to(torch.int64)]], [None], ci, 4,
                           w, s, total_w)


# whole fits through each tier: (_V2_MIN_N, _SYM_MAX_N, sort budget,
# promote budget) in both packages, and the port's functions that only
# that tier reaches
TIERS = {"v1": ((None, None, None, None), {"relief_discrete_core"}),
         "v2": ((1, 0, None, None), {"_apply_layout"}),
         "v2-sym": ((1, None, None, None),
                    {"_apply_layout", "_match_matrix_sym"}),
         "v2-promote": ((1, None, 1, None),
                        {"_promote_packed_sorted", "_match_matrix_sym"}),
         "v2-gather": ((1, None, 1, 0), {"_run_v2_gather"})}


@pytest.mark.parametrize("algo,star,k,ncls", CASES)
@pytest.mark.parametrize("tier", list(TIERS))
def test_fits_through_each_tier_equal_jax(tier, algo, star, k, ncls,
                                          monkeypatch, rng):
    """``relief_discrete_scores`` from host codes (210 x 37, ragged in
    both, focal blocks of 64 and feature tiles of 16), through each tier,
    against JAX's: atol 3e-6, rtol 1e-5, equal rankings."""
    (v2_min, sym_max, sort_budget, promote_budget), reached = TIERS[tier]
    for mod in (JD, TD):
        for name, value in (("_V2_MIN_N", v2_min), ("_SYM_MAX_N", sym_max),
                            ("_DEVICE_SORT_BUDGET", sort_budget),
                            ("_PACKED_PROMOTE_BUDGET", promote_budget)):
            if value is not None:
                monkeypatch.setattr(mod, name, value)
    n, p = 210, 37
    y = rng.randint(0, ncls, n)
    codes = rng.randint(0, 3, (n, p)).astype(np.int8)
    codes[:, 0] = y % 3
    cp = np.bincount(y, minlength=ncls).astype(np.float32) / n
    kw = dict(algo=algo, use_star=star, n_neighbors=k, class_probs=cp,
              codes=codes, n_states=3, ti=64, ft=16)
    seen = set()
    for name in ("relief_discrete_core", "_apply_layout", "_match_matrix_sym",
                 "_promote_packed_sorted", "_run_v2_gather"):
        def spy(*a, _orig=getattr(TD, name), _name=name, **k):
            seen.add(_name)
            return _orig(*a, **k)
        monkeypatch.setattr(TD, name, spy)
    got = TD.relief_discrete_scores(None, y, **kw)
    assert seen == reached
    want = np.asarray(JD.relief_discrete_scores(None, y, **kw), np.float32)
    assert got.dtype == np.float32 and got.shape == (p,)
    assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    assert_array_equal(np.argsort(got), np.argsort(want))


def test_window_phase_rehearse(monkeypatch):
    """chip_smoke.py's phase 27 at a small size on the CPU: both windows'
    checks and timing rows (the twins stand in for the kernels, so no
    launch is counted)."""
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a: None)

    def host_ms(fn, reps, warmup=1):
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    monkeypatch.setattr(cs, "cuda_ms", host_ms)
    # pass 1's windows: three tiles at the headline's rows, eight at gwas's
    monkeypatch.setattr(TD, "_PASS1_ONEHOT_BYTES", 1 << 17)
    before = dict(_build.launches)
    seen = []

    def spy(*a, **k):
        out = orig(*a, **k)
        seen.append(sum(len(sp) for sp in a[0]))
        return out
    orig = TD.window_partials
    monkeypatch.setattr(TD, "window_partials", spy)
    err, timing = cs.window_phase(torch.device("cpu"), windows=(
        ("snp-headline", 512, 64, 128, (200, 312), (150, 200, 162), 60),
        ("gwas-gather", 256, 32, 128, (170, 86), (140, 60, 56), 60)))
    assert err == {"window_onehot": 0.0, "window_partials": 0.0}
    assert [len(timing[k]) for k in cs.WINDOW_KERNELS] == [8, 2]
    shapes = [row["shape"] for row in timing["window_onehot"]]
    assert "pass 1 window, 512 rows x 192" in shapes[2]
    assert "pass 1 window, 256 rows x 256" in shapes[6]
    assert "pass 1 window, 128 focal rows x 256" in shapes[7]
    for row in timing["window_partials"]:
        assert row["eager_ms"] > 0 and row["bound_by"] == "bytes"
        assert "class 0, 2 products" in row["shape"]
    assert max(seen) == 61          # ReliefF on v1: hits and 60 classes
    assert _build.launches == before


def test_profile_split_trace_charges_innermost_range(tmp_path):
    """``tools/profile_fit.py``'s window split charges each device event
    to the pass whose range holds its launch and to the innermost part;
    what an epilogue range or the pass itself launched is the epilogue."""
    import importlib.util
    import json
    from pathlib import Path
    path = Path(cs.__file__).resolve().parent / "tools" / "profile_fit.py"
    spec = importlib.util.spec_from_file_location("profile_fit", path)
    pf = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(pf)
    ranges = [("fs.pass2", 0, 100), ("fs.gemm", 10, 20),
              ("fs.epilogue", 30, 60), ("fs.onehot", 35, 40),
              ("fs.pass1", 200, 300), ("fs.pass1.onehot", 310, 320)]
    launches = {1: 15, 2: 37, 3: 50, 4: 80, 5: 250, 6: 315, 7: 400}
    events = [{"cat": "user_annotation", "name": n, "ts": a, "dur": b - a}
              for n, a, b in ranges]
    events += [{"cat": "cuda_runtime", "ts": t, "dur": 1,
                "args": {"correlation": c}} for c, t in launches.items()]
    events += [{"cat": "kernel", "ts": 1000 + c, "dur": 1000 * c,
                "args": {"correlation": c}} for c in launches]
    trace = tmp_path / "trace.json"
    trace.write_text(json.dumps({"traceEvents": events}))
    split = pf.split_trace(trace)
    assert split["pass2"] == {"wall_ms": 0.1, "gemm": 1.0,
                              "epilogue": 2.0 + 3.0 + 4.0}
    assert split["pass1"] == {"wall_ms": 0.11, "epilogue": 5.0,
                              "onehot": 6.0}
    assert split["outside"] == {"epilogue": 7.0}
