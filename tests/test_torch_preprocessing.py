"""The port's per-feature analysis against the JAX package's."""

import numpy as np
import pytest
import torch
from numpy.testing import assert_array_equal

from fastselect_tpu.utils import preprocessing as JP
from fastselect_tpu_torch.interop import analysis_from_jax
from fastselect_tpu_torch.utils import preprocessing as TP

torch.set_num_threads(2)


def _columns(rng, n=60):
    """Columns of cardinality 1, 2, 5, 10, 11 and n, plus a negative and
    a float-valued discrete one."""
    cols = [np.full(n, 3.0), rng.randint(0, 2, n), rng.randint(0, 5, n),
            np.arange(n) % 10, np.arange(n) % 11, rng.rand(n),
            -rng.randint(0, 4, n) * 0.5, rng.randn(n) * 100]
    return np.stack(cols, axis=1).astype(np.float32)


@pytest.mark.parametrize("limit", [1, 2, 5, 10, 11, 60])
def test_detect_discrete_matches_jax(limit, rng):
    x = _columns(rng)
    got = TP.detect_discrete_features(torch.from_numpy(x), limit)
    assert got.dtype == torch.bool
    assert_array_equal(got.numpy(), JP.detect_discrete_features(x, limit))


def test_detect_discrete_empty():
    got = TP.detect_discrete_features(torch.zeros(0, 4), 10)
    assert_array_equal(got.numpy(), np.zeros(4, bool))


@pytest.mark.parametrize("unit", [False, True])
def test_recip_ranges_match_jax(unit, rng):
    x = _columns(rng)
    disc = JP.detect_discrete_features(x, 10)
    got = TP.compute_recip_ranges(torch.from_numpy(x), torch.from_numpy(disc),
                                  unit_range_for_discrete=unit)
    ref = JP.compute_recip_ranges(x, disc, unit_range_for_discrete=unit)
    assert got.dtype == torch.float32
    assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("chunk_elems", [1, 120, 1 << 26])
def test_analyze_features_matches_jax(monkeypatch, chunk_elems, rng):
    """One sort per column chunk gives the same facts as the JAX package's
    host probe on float32 X, for any chunking."""
    monkeypatch.setattr(TP, "_SORT_CHUNK_ELEMS", chunk_elems)
    x = _columns(rng)
    xt = torch.from_numpy(x)
    fa = TP.analyze_features(xt, 10)
    assert_array_equal(fa.is_discrete.numpy(),
                       JP.detect_discrete_features(x, 10))
    assert_array_equal(fa.recip.numpy(), JP.compute_recip_ranges(x))
    assert fa.x_dev is xt   # the analysed tensor is the one scored


def test_analyze_features_casts_to_float32(rng):
    x = _columns(rng).astype(np.float64)
    x[:, 5] += 1e-12   # lost in float32
    fa = TP.analyze_features(torch.from_numpy(x), 10)
    assert fa.x_dev.dtype == torch.float32
    assert_array_equal(fa.recip.numpy(),
                       JP.compute_recip_ranges(x.astype(np.float32)))


def test_analysis_from_jax(rng):
    x = _columns(rng)
    disc = JP.detect_discrete_features(x, 10)
    fa_jax = JP.FeatureAnalysis(disc, JP.compute_recip_ranges(x))
    fa = analysis_from_jax(fa_jax, device="cpu")
    assert fa.is_discrete.dtype == torch.bool
    assert fa.recip.dtype == torch.float32
    assert fa.x_dev is None
    assert_array_equal(fa.is_discrete.numpy(), disc)
    assert_array_equal(fa.recip.numpy(), fa_jax.recip)
    ours = TP.analyze_features(torch.from_numpy(x), 10)
    assert torch.equal(ours.is_discrete, fa.is_discrete)
    assert torch.equal(ours.recip, fa.recip)
