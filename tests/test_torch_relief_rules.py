"""The port's pair-weight rules against the JAX package's, on the same D.

A focal block of T rows with global row ids (so ``not_self`` falls inside
the block), padded samples (label -1, validity 0) and the three
algorithms of ``tests/test_engines.py``'s CASES.  On integer-valued D every
row sum is exact in float32, so W must match exactly; integer D also ties
constantly, which pins ReliefF's lowest-index-first choice among equal
distances.  On float D, sums in another order give atol 1e-6.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

from fastselect_tpu.ops import relief as JR
from fastselect_tpu_torch.ops import relief as TR
from test_engines import CASES

torch.set_num_threads(2)

N_REAL, N_PAD, T, ROW0 = 37, 40, 16, 16


@partial(jax.jit, static_argnames=("algo", "use_star", "k"))
def _jax_w(D, yi, vi, iid, y, valid, n_real, cp, *, algo, use_star, k):
    return JR._sum_rules(JR.pair_weight_rules(
        D, yi, vi, iid, y, valid, n_real, cp, algo=algo, use_star=use_star,
        k=k))


def _inputs(rng, ncls, integer):
    if integer:
        D = rng.randint(0, 6, (T, N_PAD)).astype(np.float32)
    else:
        D = (rng.rand(T, N_PAD) * 5).astype(np.float32)
    y = np.full(N_PAD, -1, np.int32)
    y[:N_REAL] = rng.randint(0, ncls, N_REAL)
    valid = np.zeros(N_PAD, np.float32)
    valid[:N_REAL] = 1.0
    iid = np.arange(ROW0, ROW0 + T, dtype=np.int32)
    cp = np.bincount(y[:N_REAL], minlength=ncls).astype(np.float32) / N_REAL
    return D, y, valid, iid, cp


def _both(D, y, valid, iid, cp, algo, star, k, block=slice(ROW0, ROW0 + T)):
    ref = np.asarray(_jax_w(D, y[block], valid[block], iid, y, valid,
                            np.float32(N_REAL), cp, algo=algo,
                            use_star=star, k=k))
    t = torch.from_numpy
    got = TR._sum_rules(TR.pair_weight_rules(
        t(D), t(y[block]).long(), t(valid[block]), t(iid).long(),
        t(y).long(), t(valid), torch.tensor(N_REAL, dtype=torch.float32),
        t(cp), algo=algo, use_star=star, k=k)).numpy()
    return got, ref


@pytest.mark.parametrize("integer", [True, False], ids=["int_D", "float_D"])
@pytest.mark.parametrize("algo,star,k,ncls", CASES)
def test_weights_match_jax(algo, star, k, ncls, integer, rng):
    D, y, valid, iid, cp = _inputs(rng, ncls, integer)
    got, ref = _both(D, y, valid, iid, cp, algo, star, k)
    assert got.dtype == np.float32 and got.shape == (T, N_PAD)
    if integer:
        assert_array_equal(got, ref)
    else:
        assert_allclose(got, ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("algo,star,k,ncls", CASES)
def test_padded_focal_rows_get_no_weight(algo, star, k, ncls, rng):
    """A block reaching past the real samples (rows 32..47 of 40 padded,
    37 real): the padded focal rows carry no weight, and no sample is
    weighted against itself."""
    D, y, valid, iid, cp = _inputs(rng, ncls, True)
    D = np.concatenate([D, D[:, :8]], axis=1)           # 48 columns
    y = np.concatenate([y, np.full(8, -1, np.int32)])
    valid = np.concatenate([valid, np.zeros(8, np.float32)])
    iid = np.arange(32, 48, dtype=np.int32)
    got, ref = _both(D, y, valid, iid, cp, algo, star, k,
                     block=slice(32, 48))
    assert_array_equal(got, ref)
    assert not got[N_REAL - 32:].any()
    assert not got[:, N_REAL:].any()
    assert not got[np.arange(N_REAL - 32), np.arange(32, N_REAL)].any()


def test_relieff_ties_pick_lowest_index(rng):
    """All distances equal: the k nearest hits are the k lowest-index
    same-class samples, as lax.top_k picks them."""
    D = np.ones((1, 12), np.float32)
    y = np.zeros(12, np.int64)
    W = TR._sum_rules(TR.pair_weight_rules(
        torch.from_numpy(D), torch.zeros(1, dtype=torch.long),
        torch.ones(1), torch.tensor([5]), torch.from_numpy(y),
        torch.ones(12), torch.tensor(12.0), torch.tensor([1.0]),
        algo="relieff", use_star=False, k=3)).numpy()
    assert_array_equal(np.flatnonzero(W[0]), [0, 1, 2])
    assert_allclose(W[0, :3], -1.0 / 3)


def test_unknown_algorithm_raises():
    D = torch.zeros(2, 3)
    with pytest.raises(ValueError, match="unknown Relief algorithm"):
        TR.pair_weight_rules(D, None, None, None, None, None, None, None,
                             algo="relief", use_star=False, k=0)


def test_multisurf_statistics_stay_float32(rng):
    """mu divides by n_real - 1 (not the valid count) and every statistic
    is float32, as in the JAX engines."""
    D, y, valid, iid, cp = _inputs(rng, 2, False)
    Dt = torch.from_numpy(D)
    vmask, _ = TR._pair_masks(Dt, torch.from_numpy(y[ROW0:ROW0 + T]).long(),
                              torch.from_numpy(valid[ROW0:ROW0 + T]),
                              torch.from_numpy(iid).long(),
                              torch.from_numpy(y).long(),
                              torch.from_numpy(valid))
    n_real = torch.tensor(N_REAL, dtype=torch.float32)
    Dm, mu, denom = TR._row_mean_stats(Dt, vmask, n_real)
    assert mu.dtype == denom.dtype == Dm.dtype == torch.float32
    expected = (np.where(vmask.numpy(), D, 0).sum(1, dtype=np.float64)
                / (N_REAL - 1))
    assert_allclose(mu.numpy(), expected, rtol=1e-6)
    jm = jax.jit(JR._row_mean_stats)(
        jnp.asarray(D), jnp.asarray(vmask.numpy()), np.float32(N_REAL))[1]
    assert_allclose(mu.numpy(), np.asarray(jm), rtol=1e-6)
