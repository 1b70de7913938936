"""The port's chi2 against the JAX package's and scikit-learn's, on the CPU.

The float64 host path must equal JAX's bit for bit (the same numpy
arithmetic) and scikit-learn's to rtol 1e-10.  The float32 product on a
tensor's device (a CPU tensor here, the card's route) must agree with
JAX's float32 device path to rtol 1e-4 and with the exact path to rtol
1e-4; on integer counts, which the float32 product sums exactly, with the
exact path to rtol 1e-10 (the port takes the statistic in float64, JAX in
float32).  The fixtures and the deliberate divergences follow
``tests/test_chi2.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal
from sklearn.feature_selection import chi2 as sklearn_chi2

import fastselect_tpu
from fastselect_tpu_torch import chi2
from fastselect_tpu_torch.ops.chi2_op import chi2_stats, chi2_stats_exact

torch.set_num_threads(2)

SHAPES = [(50, 10, 2), (200, 64, 3), (97, 31, 5)]


def _counts(rng, n, p, c, integer=False):
    X = (rng.randint(0, 20, (n, p)).astype(float) if integer
         else rng.rand(n, p) * 10)
    return X, rng.randint(0, c, n)


@pytest.mark.parametrize("integer", [False, True])
@pytest.mark.parametrize("n,p,c", SHAPES)
def test_exact_matches_jax_and_sklearn(n, p, c, integer, rng):
    X, y = _counts(rng, n, p, c, integer)
    s, pv = chi2(X, y)                              # 'auto': host float64
    s_jax, pv_jax = fastselect_tpu.chi2(X, y, backend="cpu")
    assert_array_equal(s, s_jax)
    assert_array_equal(pv, pv_jax)
    assert_array_equal(chi2(X, y, backend="cpu")[0], s)
    assert_array_equal(chi2(torch.from_numpy(X), y, exact=True)[0], s)
    s_ref, p_ref = sklearn_chi2(X, y)
    assert_allclose(s, s_ref, rtol=1e-10)
    assert_allclose(pv, p_ref, rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("integer", [False, True])
@pytest.mark.parametrize("n,p,c", SHAPES)
def test_float32_on_device_matches_jax(n, p, c, integer, rng):
    X, y = _counts(rng, n, p, c, integer)
    X32 = X.astype(np.float32)
    s, pv = chi2(torch.from_numpy(X32), y)
    assert s.dtype == np.float64 and s.shape == (p,)
    s_jax, _ = fastselect_tpu.chi2(jnp.asarray(X32), y)
    assert_allclose(s, s_jax, rtol=1e-4)
    exact = chi2_stats_exact(X32, np.unique(y, return_inverse=True)[1], c)
    assert_allclose(s, exact, rtol=1e-10 if integer else 1e-4)
    assert_allclose(pv, sklearn_chi2(X, y)[1], rtol=1e-3, atol=1e-9)


def test_float32_product_ignores_the_tf32_setting(rng):
    X, y = _counts(rng, 60, 7, 3)
    x = torch.from_numpy(X)
    before = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        s = chi2_stats(x, y, 3)
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    assert_array_equal(s, chi2_stats(x, y, 3))


@pytest.mark.parametrize("as_tensor", [False, True])
def test_zero_count_feature_is_zero_not_nan(as_tensor, rng):
    X = rng.rand(60, 5)
    X[:, 2] = 0.0
    y = rng.randint(0, 2, 60)
    s, pv = chi2(torch.from_numpy(X) if as_tensor else X, y)
    assert s[2] == 0.0
    assert np.isfinite(pv).all()


@pytest.mark.parametrize("as_tensor", [False, True])
def test_single_class(as_tensor, rng):
    X = rng.rand(30, 4)
    s, pv = chi2(torch.from_numpy(X) if as_tensor else X, np.zeros(30))
    assert_array_equal(s, np.zeros(4))
    assert_array_equal(pv, np.ones(4))


@pytest.mark.parametrize("as_tensor", [False, True])
def test_invalid_input_raises(as_tensor, rng):
    wrap = torch.from_numpy if as_tensor else (lambda a: a)
    y = rng.randint(0, 2, 30)
    with pytest.raises(ValueError, match="non-negative"):
        chi2(wrap(rng.rand(30, 4) - 0.5), y)
    with pytest.raises(ValueError):
        chi2(wrap(rng.rand(10, 3)), np.zeros(8))
    Xn = rng.rand(30, 4)
    Xn[3, 1] = np.nan
    with pytest.raises(ValueError, match="NaN"):
        chi2(wrap(Xn), y)


def test_backends(rng):
    X, y = _counts(rng, 40, 6, 2)
    with pytest.raises(RuntimeError, match="no CUDA-enabled GPU"):
        chi2(X, y, backend="cuda")
    with pytest.raises(ValueError, match="backend must be one of"):
        chi2(X, y, backend="tpu")


def test_tensor_backend_must_name_its_device(monkeypatch, rng):
    """A tensor is scored on its own device only: a forced card raises
    without one, and with one a CPU tensor raises rather than being scored
    on the CPU."""
    X, y = _counts(rng, 40, 6, 2)
    Xt = torch.from_numpy(X)
    assert_array_equal(chi2(Xt, y, backend="cpu")[0], chi2(Xt, y)[0])
    with pytest.raises(RuntimeError, match="no CUDA-enabled GPU"):
        chi2(Xt, y, backend="cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="on a tensor on cpu"):
        chi2(Xt, y, backend="gpu")
