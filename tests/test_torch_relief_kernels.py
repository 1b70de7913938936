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
                                 "empty"])
def test_wrappers_reject_bad_inputs(bad, rng):
    xp, recip2, disc2 = _padded(rng, False)
    xp_t, r, d = _t(xp), _t(recip2[0]), _t(disc2[0])
    W = torch.zeros(N, N)
    if bad == "dtype":
        xp_t = xp_t.double()
    elif bad == "contiguous":
        xp_t = xp_t.t().contiguous().t()
    elif bad == "shape":
        r = r[:-1]
    elif bad == "W":
        W = W[:, :-1]
    else:
        xp_t = xp_t[:0]
        W = W[:0]
    with pytest.raises((TypeError, ValueError)):
        if bad == "W":
            RC.accumulate(xp_t, W, r, d, mixed=False)
        else:
            RC.dist_matrix(xp_t, r, d, mixed=False)
