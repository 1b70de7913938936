"""The port's fused Relief engine against the JAX package.

The CUDA kernels cannot run here, so their plain PyTorch versions, which a
wrapper runs for a CPU tensor, are held against the Pallas kernels run in
interpret mode on the same numpy inputs; on the card ``chip_smoke.py``
holds the kernels to those plain versions.  Tolerances: pass 1 atol 1e-5
(float32 sums of 24 features in another order), pass 2 and the engine
atol 1e-4 with equal rankings, as ``tests/test_engines.py`` holds the
Pallas engine to the generic one.
"""

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from numpy.testing import assert_allclose, assert_array_equal

from fastselect_tpu.ops.relief_pallas import (pallas_accumulate,
                                              pallas_dist_matrix,
                                              relief_pallas_scores)
from fastselect_tpu_torch.ops import relief_cuda as RC
from test_engines import CASES, _generic_scores

torch.set_num_threads(2)

N, P, P_PAD = 40, 24, 128   # JAX tiles: ti = tj = 40 (or 8), ft = 128


def _mixed_data(rng, n, p, n_disc, ncls=2):
    x = rng.rand(n, p).astype(np.float32)
    x[:, :n_disc] = rng.randint(0, 3, (n, n_disc))
    disc = np.zeros(p, bool)
    disc[:n_disc] = True
    recip = (1.0 / np.maximum(x.max(0) - x.min(0), 1e-9)).astype(np.float32)
    y = rng.randint(0, ncls, n).astype(np.int32)
    return x, y, recip, disc


def _padded(rng, mixed):
    """Padded (n, P_PAD) inputs as relief_pallas_scores builds them."""
    x, _, recip, disc = _mixed_data(rng, N, P, 6 if mixed else 0)
    xp = np.zeros((N, P_PAD), np.float32)
    xp[:, :P] = x
    recip2 = np.zeros((1, P_PAD), np.float32)
    recip2[0, :P] = recip
    disc2 = np.zeros((1, P_PAD), np.float32)
    disc2[0, :P] = disc
    return xp, recip2, disc2


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("mixed", [False, True], ids=["cont", "mixed"])
@pytest.mark.parametrize("rows", [None, (8, 32)], ids=["square", "rect"])
def test_dist_matrix_matches_pallas(mixed, rows, rng):
    xp, recip2, disc2 = _padded(rng, mixed)
    xi = None if rows is None else xp[rows[0]:rows[1]]
    ti = N if rows is None else 8
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(pallas_dist_matrix(xp, recip2, disc2, ti, N, P_PAD,
                                            xi=xi, cont=not mixed))
    got = RC.dist_matrix(_t(xp), _t(recip2[0]), _t(disc2[0]),
                         xi=None if xi is None else _t(xi), mixed=mixed)
    assert got.shape == ref.shape
    assert_allclose(got.numpy(), ref, atol=1e-5)
    # unpadded features give the same D: padding adds exact zeros
    got_unpadded = RC.dist_matrix(
        _t(xp[:, :P]), _t(recip2[0, :P]), _t(disc2[0, :P]),
        xi=None if xi is None else _t(xi[:, :P]), mixed=mixed)
    assert torch.equal(got_unpadded, got)


@pytest.mark.parametrize("mixed", [False, True], ids=["cont", "mixed"])
@pytest.mark.parametrize("rows", [None, (8, 32)], ids=["square", "rect"])
def test_accumulate_matches_pallas(mixed, rows, rng):
    xp, recip2, disc2 = _padded(rng, mixed)
    xi = None if rows is None else xp[rows[0]:rows[1]]
    nb = N if rows is None else rows[1] - rows[0]
    W = (rng.rand(nb, N) - 0.5).astype(np.float32)
    ti = N if rows is None else 8
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(pallas_accumulate(xp, W, recip2, disc2, ti, N,
                                           P_PAD, xi=xi, cont=not mixed))
    got = RC.accumulate(_t(xp), _t(W), _t(recip2[0]), _t(disc2[0]),
                        xi=None if xi is None else _t(xi), mixed=mixed)
    assert got.shape == (P_PAD,)
    assert_allclose(got.numpy(), ref, atol=1e-4)


@pytest.mark.parametrize("algo,star,k,ncls", CASES)
def test_fused_engine_matches_pallas_and_generic(algo, star, k, ncls, rng):
    x, y, recip, disc = _mixed_data(rng, N, P, 6, ncls)
    x[:, 7] += 0.7 * (y == 1)   # planted signal keeps the ranking apart
    cp = np.bincount(y, minlength=ncls).astype(np.float32) / N
    got = RC.relief_fused_scores(x, y, recip, disc, algo=algo,
                                 use_star=star, n_neighbors=k,
                                 class_probs=cp)
    pallas = relief_pallas_scores(x, y, recip, disc, algo=algo,
                                  use_star=star, n_neighbors=k,
                                  class_probs=cp, interpret=True)
    generic = _generic_scores(x, y, recip, disc, algo, star, k, cp)
    for ref in (pallas, generic):
        assert_allclose(got, ref, atol=1e-4)
        assert_array_equal(np.argsort(got), np.argsort(ref))


@pytest.mark.parametrize("algo,star,k,ncls", CASES)
def test_blocked_engine_matches_square(monkeypatch, algo, star, k, ncls,
                                       rng):
    """Focal blocks of nb < n_pad rows (global row ids, sliced labels and
    validity) must reproduce the single square block."""
    n, p = 150, 21
    x, y, recip, disc = _mixed_data(rng, n, p, 5, ncls)
    cp = np.bincount(y, minlength=ncls).astype(np.float32) / n
    kw = dict(algo=algo, use_star=star, n_neighbors=k, class_probs=cp)
    assert RC.block_plan(n, p, torch.device("cpu")).nb == 192
    square = RC.relief_fused_scores(x, y, recip, disc, **kw)
    # room for one 64-row tile per block: three blocks of 64 rows
    monkeypatch.setattr(RC, "_CPU_BLOCK_BYTES",
                        RC._BYTES_PER_PAIR * 192 * RC.TILE_ROWS)
    plan = RC.block_plan(n, p, torch.device("cpu"))
    assert (plan.nb, plan.n_pad) == (64, 192)
    blocked = RC.relief_fused_scores(x, y, recip, disc, **kw)
    assert_allclose(blocked, square, atol=2e-6, rtol=1e-6)
    assert_array_equal(np.argsort(blocked), np.argsort(square))


@pytest.mark.parametrize("n_pad,budget,expected", [
    (256, 1 << 30, 256),                # square fits
    (64, 1, 64),                        # one tile: the least block
    (192, 32 * 192 * 64, 64),           # one tile per block
    (448, 32 * 448 * 64 * 3, 64),       # 7 tiles, prime: 7 blocks
    (512, 32 * 512 * 64 * 5, 256),      # 8 tiles, room for 5: 2 blocks
    (50048, 32 * 50048 * 64 * 653, 25024),  # 782 = 2 * 391 tiles
])
def test_focal_block_rows(n_pad, budget, expected):
    nb = RC._focal_block_rows(n_pad, RC.TILE_ROWS, budget)
    assert nb == expected
    assert n_pad % nb == 0 and nb * n_pad * RC._BYTES_PER_PAIR <= max(
        budget, RC.TILE_ROWS * n_pad * RC._BYTES_PER_PAIR)


def test_fused_engine_is_deterministic(rng):
    x, y, recip, disc = _mixed_data(rng, 70, 13, 4)
    a = RC.relief_fused_scores(x, y, recip, disc, algo="multisurf")
    b = RC.relief_fused_scores(x, y, recip, disc, algo="multisurf")
    assert_array_equal(a, b)


def test_wrappers_use_plain_versions_on_cpu_only(rng):
    xp, recip2, disc2 = _padded(rng, True)
    xp_t, r, d = _t(xp), _t(recip2[0]), _t(disc2[0])
    W = _t((rng.rand(N, N) - 0.5).astype(np.float32))
    before = dict(RC.launches)
    assert torch.equal(RC.dist_matrix(xp_t, r, d, mixed=True),
                       RC.dist_matrix_ref(xp_t, r, d, mixed=True))
    assert torch.equal(RC.accumulate(xp_t, W, r, d, mixed=True),
                       RC.accumulate_ref(xp_t, W, r, d, mixed=True))
    assert RC.launches == before   # no kernel ran
    # a device the kernels do not serve raises instead of falling back
    with pytest.raises(ValueError, match="unsupported device"):
        RC.dist_matrix(xp_t.to("meta"), r.to("meta"), d.to("meta"),
                       mixed=True)


@pytest.mark.parametrize("bad", ["dtype", "contiguous", "shape", "W",
                                 "empty", "p_not_4", "unaligned",
                                 "n_not_4", "mixed_p_not_4",
                                 "disc_unaligned", "n_disc_not_4",
                                 "n_disc_cont"])
def test_wrappers_reject_bad_inputs(bad, rng):
    xp, recip2, disc2 = _padded(rng, False)
    xp_t, r, d = _t(xp), _t(recip2[0]), _t(disc2[0])
    W = torch.zeros(N, N)
    if bad in ("mixed_p_not_4", "disc_unaligned", "n_disc_not_4"):
        if bad == "mixed_p_not_4":
            xp_t, r, d = xp_t[:, :-1].contiguous(), r[:-1], d[:-1]
        elif bad == "disc_unaligned":
            d = torch.empty(P_PAD + 1)[1:].copy_(d)
        with pytest.raises(ValueError):
            if bad == "n_disc_not_4":
                RC.accumulate(xp_t, W, r, d, mixed=True, n_disc=6)
            else:
                RC.dist_matrix(xp_t, r, d, mixed=True)
        return
    if bad == "n_disc_cont":
        with pytest.raises(ValueError, match="n_disc"):
            RC.accumulate(xp_t, W, r, d, mixed=False, n_disc=4)
        return
    if bad == "dtype":
        xp_t = xp_t.double()
    elif bad == "contiguous":
        xp_t = xp_t.t().contiguous().t()
    elif bad == "shape":
        r = r[:-1]
    elif bad == "W":
        W = W[:, :-1]
    elif bad == "empty":
        xp_t = xp_t[:0]
        W = W[:0]
    elif bad == "p_not_4":      # rows of 127 floats are not 16-byte aligned
        xp_t, r, d = xp_t[:, :-1].contiguous(), r[:-1], d[:-1]
    elif bad == "unaligned":    # contiguous, but 4 bytes past an alignment
        xp_t = torch.empty(N * P_PAD + 1)[1:].view(N, P_PAD).copy_(xp_t)
    else:                       # W rows of 39 floats
        xp_t, W = xp_t[:-1], W[:-1, :-1]
    with pytest.raises((TypeError, ValueError)):
        if bad in ("W", "n_not_4"):
            RC.accumulate(xp_t, W, r, d, mixed=False)
        else:
            RC.dist_matrix(xp_t, r, d, mixed=False)


# ---------------------------------------------------------------------------
# The continuous kernels' plans: feature ranges of pass 1, blocks of pass 2
# ---------------------------------------------------------------------------

def _no_device(monkeypatch):
    """Make any question to a CUDA device fail: the plans read shapes only."""
    def refuse(*args, **kwargs):
        raise AssertionError("the plan asked the device")
    for name in ("is_available", "mem_get_info", "get_device_properties",
                 "device_count", "current_device"):
        monkeypatch.setattr(torch.cuda, name, refuse)


@pytest.mark.parametrize("nb,n,p,one", [
    (25024, 50048, 100, True),     # large-n focal block
    (16384, 16384, 2048, True),    # mixed-square's continuous half
    (128, 128, 100000, False),     # large-p
    (16, 16, 8192, False),
    (1000, 1000, 300, False),      # chip_smoke.py's checks: 64 tiles
    (333, 1004, 44, True),         # ragged in nb, n and p
])
def test_pass1_splits(monkeypatch, nb, n, p, one):
    _no_device(monkeypatch)
    splits = RC.pass1_splits(nb, n, p)
    assert (len(splits) == 1) == one
    assert splits[0][0] == 0 and splits[-1][1] == p
    for (f0, f1), (g0, _) in zip(splits, splits[1:] + [(p, p)]):
        assert f1 == g0 and f1 > f0 and f0 % 4 == 0 and f1 % 4 == 0
    tiles = -(-nb // RC._PASS1_TILE) * -(-n // RC._PASS1_TILE)
    assert len(splits) * tiles <= max(tiles, RC._PASS1_TARGET_BLOCKS)
    if not one:
        assert all(f1 - f0 >= RC._PASS1_MIN_SPLIT for f0, f1 in splits[:-1])


@pytest.mark.parametrize("nb,n,p,groups,ftiles", [
    (25024, 50048, 100, 25, 1),    # all of p = 100 in one block
    (25024, 50048, 128, 32, 1),
    (16384, 16384, 2048, 32, 16),
    (128, 128, 100000, 32, 782),
    (333, 1004, 44, 11, 1),
])
def test_pass2_plan(monkeypatch, nb, n, p, groups, ftiles):
    _no_device(monkeypatch)
    plan = RC.pass2_plan(nb, n, p)
    threads = plan.groups * plan.rows
    assert plan.groups == groups and -(-(p // 4) // plan.groups) == ftiles
    assert threads <= RC._PASS2_MAX_THREADS
    assert threads > 0.9 * min(RC._PASS2_MAX_THREADS,
                               plan.groups * RC._PASS2_MAX_ROW_GROUPS)
    assert plan.span % RC._PASS2_STAGE == 0
    assert (plan.spans - 1) * plan.span < n <= plan.spans * plan.span
    assert plan.focal_rows == RC._PASS2_ROWS_PER_THREAD * plan.rows


@pytest.mark.parametrize("rows", [None, (4, 12)], ids=["square", "rect"])
def test_split_dist_matrix_matches_pallas(monkeypatch, rows, rng):
    """p >> n: pass 1 sums 64 feature ranges apart, then in order."""
    n, p = 16, 8192
    x = rng.rand(n, p).astype(np.float32)
    recip = ((rng.rand(p) + 0.5) / p).astype(np.float32)   # D about 1/3
    xi = None if rows is None else x[rows[0]:rows[1]]
    nb = n if rows is None else rows[1] - rows[0]
    assert len(RC.pass1_splits(nb, n, p)) == 64
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(pallas_dist_matrix(
            x, recip[None], np.zeros((1, p), np.float32), 8, n, 128, xi=xi,
            cont=True))
    got = RC.dist_matrix(_t(x), _t(recip), torch.zeros(p),
                         xi=None if xi is None else _t(xi), mixed=False)
    assert_allclose(got.numpy(), ref, atol=1e-5)
    monkeypatch.setattr(RC, "_PASS1_TARGET_BLOCKS", 1)   # one range
    assert len(RC.pass1_splits(nb, n, p)) == 1
    whole = RC.dist_matrix(_t(x), _t(recip), torch.zeros(p),
                           xi=None if xi is None else _t(xi), mixed=False)
    assert_allclose(got.numpy(), whole.numpy(), atol=1e-5)


@pytest.mark.parametrize("algo,star,k,ncls", CASES[:1] + CASES[-1:])
def test_fused_engine_p_much_larger_than_n(algo, star, k, ncls, rng):
    n, p = 20, 512
    x, y, recip, disc = _mixed_data(rng, n, p, 0, ncls)
    x[:, 7] += 0.7 * (y == 1)
    assert len(RC.pass1_splits(64, 64, p)) > 1
    cp = np.bincount(y, minlength=ncls).astype(np.float32) / n
    got = RC.relief_fused_scores(x, y, recip, disc, algo=algo,
                                 use_star=star, n_neighbors=k,
                                 class_probs=cp)
    pallas = relief_pallas_scores(x, y, recip, disc, algo=algo,
                                  use_star=star, n_neighbors=k,
                                  class_probs=cp, interpret=True)
    generic = _generic_scores(x, y, recip, disc, algo, star, k, cp)
    for ref in (pallas, generic):
        assert_allclose(got, ref, atol=1e-4)
        assert_array_equal(np.argsort(got), np.argsort(ref))


@pytest.mark.parametrize("mixed", [False, True], ids=["cont", "mixed"])
def test_features_padded_to_4_as_to_32(monkeypatch, mixed, rng):
    """Padding p = 21 to 24 rather than 32 leaves D bit-equal and the
    scores within 1e-6."""
    n, p = 70, 21
    x, y, recip, disc = _mixed_data(rng, n, p, 5 if mixed else 0)
    assert RC.block_plan(n, p, torch.device("cpu")).p_pad == 24
    four = RC.relief_fused_scores(x, y, recip, disc, algo="multisurf")
    xp = np.zeros((n, 32), np.float32)
    xp[:, :p] = x
    rp = np.zeros(32, np.float32)
    rp[:p] = recip
    dp = np.zeros(32, np.float32)
    dp[:p] = disc
    D24 = RC.dist_matrix(_t(xp[:, :24]), _t(rp[:24]), _t(dp[:24]),
                         mixed=mixed)
    D32 = RC.dist_matrix(_t(xp), _t(rp), _t(dp), mixed=mixed)
    assert torch.equal(D24, D32)
    monkeypatch.setattr(RC, "TILE_FEATURES", 32)
    assert RC.block_plan(n, p, torch.device("cpu")).p_pad == 32
    thirty_two = RC.relief_fused_scores(x, y, recip, disc, algo="multisurf")
    assert_allclose(four, thirty_two, atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# Mixed data: the engine orders columns by kind, the kernels plan per run
# ---------------------------------------------------------------------------

def _layout_data(rng, n, p, layout, ncls):
    """Mixed data whose discrete columns (integers 0..2) are every third
    column ("interleaved"), or those and a planted discrete column at the
    last index ("planted-last", the label itself)."""
    x, y, recip, disc = _mixed_data(rng, n, p, 0, ncls)
    disc[::3] = True
    x[:, disc] = rng.randint(0, 3, (n, int(disc.sum())))
    if layout == "planted-last":
        disc[-1] = True
        x[:, -1] = y
    recip = (1.0 / np.maximum(x.max(0) - x.min(0), 1e-9)).astype(np.float32)
    return x, y, recip, disc


@pytest.mark.parametrize("layout", ["interleaved", "planted-last"])
@pytest.mark.parametrize("algo,star,k,ncls", CASES)
def test_fused_engine_mixed_layouts_match_pallas_and_generic(
        layout, algo, star, k, ncls, rng):
    """Columns of both kinds in any order: the engine runs them discrete
    first and returns the scores to column order."""
    x, y, recip, disc = _layout_data(rng, N, P, layout, ncls)
    if layout == "interleaved":
        x[:, 7] += 0.7 * (y == 1)   # planted signal keeps the ranking apart
    cp = np.bincount(y, minlength=ncls).astype(np.float32) / N
    kw = dict(algo=algo, use_star=star, n_neighbors=k, class_probs=cp)
    got = RC.relief_fused_scores(x, y, recip, disc, **kw)
    pallas = relief_pallas_scores(x, y, recip, disc, interpret=True, **kw)
    generic = _generic_scores(x, y, recip, disc, algo, star, k, cp)
    for ref in (pallas, generic):
        assert_allclose(got, ref, atol=1e-4)
        assert_array_equal(np.argsort(got), np.argsort(ref))
    if layout == "planted-last" and not star:   # * also scores far pairs
        assert np.argmax(got) == P - 1


@pytest.mark.parametrize("layout", ["interleaved", "planted-last"])
@pytest.mark.parametrize("algo,star,k,ncls", CASES[:1] + CASES[-1:])
def test_blocked_engine_mixed_layouts_match_square(monkeypatch, layout, algo,
                                                   star, k, ncls, rng):
    n, p = 150, 21
    x, y, recip, disc = _layout_data(rng, n, p, layout, ncls)
    cp = np.bincount(y, minlength=ncls).astype(np.float32) / n
    kw = dict(algo=algo, use_star=star, n_neighbors=k, class_probs=cp)
    square = RC.relief_fused_scores(x, y, recip, disc, **kw)
    monkeypatch.setattr(RC, "_CPU_BLOCK_BYTES",
                        RC._BYTES_PER_PAIR * 192 * RC.TILE_ROWS)
    assert RC.block_plan(n, p, torch.device("cpu")).nb == 64
    blocked = RC.relief_fused_scores(x, y, recip, disc, **kw)
    assert_allclose(blocked, square, atol=2e-6, rtol=1e-6)
    assert_array_equal(np.argsort(blocked), np.argsort(square))
    if layout == "planted-last" and not star:
        assert np.argmax(blocked) == p - 1


@pytest.mark.parametrize("disc,expected,p_pad", [
    ([0, 1, 0, 0, 1], [4, 0, 5, 6, 1], 8),   # 2 discrete: runs of 4 + 4
    ([1, 1, 1, 1, 0], [0, 1, 2, 3, 4], 8),
    ([0, 0, 0], [0, 1, 2], 4),                # one run: the identity
    ([1] * 5, [0, 1, 2, 3, 4], 8),
])
def test_feature_positions(disc, expected, p_pad):
    pos = RC.feature_positions(np.array(disc, bool))
    assert pos.tolist() == expected
    p = len(disc)
    assert RC.block_plan(10, p, torch.device("cpu"),
                         n_disc=sum(disc)).p_pad == p_pad
    assert pos.max() < p_pad


@pytest.mark.parametrize("nb,n,p,n_disc", [
    (512, 150016, 100, 40),        # mixed-xl's focal block
    (2048, 2048, 200, 40),         # mixed-fused
    (4096, 4096, 16384, 16384),    # all-discrete
    (128, 128, 100000, 30000),     # large-p, 30% discrete
    (333, 1004, 44, 12),
    (64, 64, 8, 4),
])
def test_mixed_plans(monkeypatch, nb, n, p, n_disc):
    """Pass 2's feature tiles cover each run once, in order, and none
    holds both kinds; pass 1's ranges are multiples of 4."""
    _no_device(monkeypatch)
    plan = RC.pass2_plan(nb, n, p, n_disc)
    width = 4 * plan.groups     # relief_pass2.cu's tiles, in blockIdx.x order
    tiles = [(f0, min(f1, f0 + width))
             for s0, f1 in ((0, n_disc), (n_disc, p))
             for f0 in range(s0, f1, width)]
    assert tiles[0][0] == 0 and tiles[-1][1] == p
    for (f0, f1), (g0, _) in zip(tiles, tiles[1:] + [(p, p)]):
        assert f1 == g0 and 0 < f1 - f0 <= 4 * plan.groups
        assert f0 % 4 == 0 and f1 % 4 == 0
        assert f1 <= n_disc or f0 >= n_disc        # one kind a tile
    assert plan.groups * plan.rows <= RC._PASS2_MAX_THREADS
    assert (plan.spans - 1) * plan.span < n <= plan.spans * plan.span
    for f0, f1 in RC.pass1_splits(nb, n, p):
        assert f0 % 4 == 0 and f1 % 4 == 0


@pytest.mark.parametrize("rows", [None, (4, 12)], ids=["square", "rect"])
def test_split_mixed_dist_matrix_is_exact(monkeypatch, rows, rng):
    """p >> n: mixed pass 1 sums 64 feature ranges apart, then in order;
    on a grid whose sums are exact in float32 that equals the one-range
    sum and JAX's Pallas kernel bit for bit."""
    n, p = 16, 8192
    x = (rng.randint(0, 4, (n, p)) / 4).astype(np.float32)
    disc = np.zeros(p, np.float32)
    disc[::3] = 1.0                                # interleaved kinds
    recip = np.where(rng.rand(p) < 0.5, 1.0, 0.5).astype(np.float32)
    xi = None if rows is None else x[rows[0]:rows[1]]
    nb = n if rows is None else rows[1] - rows[0]
    args = (_t(x), _t(recip), _t(disc))
    xi_t = None if xi is None else _t(xi)
    assert len(RC.pass1_splits(nb, n, p)) == 64
    split = RC.dist_matrix_ref(*args, xi=xi_t, mixed=True)
    assert torch.equal(RC.dist_matrix(*args, xi=xi_t, mixed=True), split)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(pallas_dist_matrix(
            x, recip[None], disc[None], 8, n, 128, xi=xi, cont=False))
    assert_array_equal(split.numpy(), ref)
    monkeypatch.setattr(RC, "_PASS1_TARGET_BLOCKS", 1)   # one range
    assert len(RC.pass1_splits(nb, n, p)) == 1
    assert torch.equal(RC.dist_matrix_ref(*args, xi=xi_t, mixed=True), split)


@pytest.mark.parametrize("p", [1, 3, 4, 5, 100, 101])
def test_plans_pad_features_to_4(p):
    from fastselect_tpu_torch.ops import relief_hybrid as RH
    cpu = torch.device("cpu")
    p_pad = RC.block_plan(300, p, cpu).p_pad
    p_c_pad = RH.hybrid_plan(300, p, 3, 3, cpu).p_c_pad
    for pad in (p_pad, p_c_pad):
        assert pad % 4 == 0 and p <= pad < p + 4


# ---------------------------------------------------------------------------
# The build: one nvcc per source, then one link, and ptxas's report
# ---------------------------------------------------------------------------

_FAKE_NVCC = '''#!/usr/bin/env python3
import sys
args = sys.argv[1:]
if "{fail}" and args[-1].endswith("{fail}"):
    sys.exit("error in " + args[-1])
open(args[args.index("-o") + 1], "w").write(" ".join(args))
if "-c" in args:
    name = args[-1].rsplit("/", 1)[-1]
    sys.stderr.write(
        "ptxas info    : Compiling entry function '_Z4k_" + name +
        "' for 'sm_90a'\\n    0 bytes stack frame, 8 bytes spill stores\\n"
        "ptxas info    : Used 40 registers, used 1 barriers\\n")
'''


def _fake_nvcc(monkeypatch, tmp_path, fail=""):
    from fastselect_tpu_torch import _build
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(_FAKE_NVCC.format(fail=fail))
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    return _build


def test_build_compiles_each_source_then_links(monkeypatch, tmp_path):
    _build = _fake_nvcc(monkeypatch, tmp_path)
    units = [s.name for s in _build._units()]
    assert units == ["relief_pass1.cu", "relief_pass2.cu"]   # not headers
    lib = _build.build()
    assert lib == _build.library_path() and lib.exists()
    link = lib.read_text().split()
    assert "-shared" in link
    assert sorted(a.rsplit("/", 1)[-1] for a in link if a.endswith(".o")) \
        == sorted(u.replace(".cu", ".o") for u in units)
    report = _build.ptxas_report()
    assert [r[0] for r in report] == [f"_Z4k_{u}" for u in units]
    assert all(r[1:] == (40, 8) for r in report)
    assert sorted((tmp_path / "kernels").iterdir()) == sorted(
        [lib, lib.with_suffix(".ptxas.txt")])   # no objects left behind


def test_build_failure_leaves_no_library(monkeypatch, tmp_path):
    _build = _fake_nvcc(monkeypatch, tmp_path, fail="relief_pass2.cu")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.build()
    assert not _build.library_path().exists()
    assert list((tmp_path / "kernels").iterdir()) == []
