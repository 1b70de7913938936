"""``fit`` on a ``torch.Tensor``: checked and scored on the tensor's device.

On the CPU here a CPU tensor takes the route a CUDA tensor takes on the
card: the same checks on the device, the int8 code path for small
non-negative integers, and the engine the array fit would take.  A tensor
fit must give the array fit's model exactly (the same engine on the same
float32 values), and the JAX estimator's within rtol 1e-4, atol 1e-5.
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

import fastselect_tpu
from fastselect_tpu_torch import MultiSURF, ReliefF, SURF
from fastselect_tpu_torch.ops import relief_discrete as rd
from fastselect_tpu_torch.utils import backend as backend_mod

torch.set_num_threads(2)

ESTIMATORS = {"MultiSURF": (MultiSURF, dict(use_star=True)),
              "SURF": (SURF, {}),
              "ReliefF": (ReliefF, dict(n_neighbors=5))}


def _continuous(rng):
    X = rng.rand(300, 48).astype(np.float32)
    y = rng.randint(0, 2, 300)
    X[:, 7] += 0.5 * y
    return X, y


def _genotypes(rng):
    X = rng.randint(0, 3, (200, 64)).astype(np.int8)
    y = rng.randint(0, 2, 200)
    X[:, 3] = 2 * y
    return X, y


def _mixed(rng):
    X, y = _continuous(rng)
    X[:, :12] = rng.randint(0, 3, (300, 12))
    return X, y


DATA = {"continuous": _continuous, "int8": _genotypes, "mixed": _mixed}


@pytest.mark.parametrize("est", list(ESTIMATORS))
@pytest.mark.parametrize("kind", list(DATA))
def test_tensor_fit_equals_array_fit(kind, est, rng):
    X, y = DATA[kind](rng)
    cls, params = ESTIMATORS[est]
    rd.reset_gemm_ops()
    a = cls(n_features_to_select=5, backend="cpu", **params).fit(
        torch.from_numpy(X), torch.from_numpy(y))
    tensor_gemm = rd.gemm_ops
    b = cls(n_features_to_select=5, backend="cpu", **params).fit(X, y)
    assert a.effective_backend_ == "cpu"
    assert a.n_features_in_ == X.shape[1]
    assert_array_equal(a.feature_importances_, b.feature_importances_)
    assert_array_equal(a.top_features_, b.top_features_)
    assert_array_equal(a.is_discrete_, b.is_discrete_)
    assert (tensor_gemm > 0) == (kind != "continuous")
    assert_array_equal(a.transform(X), X[:, a.top_features_])
    ref = getattr(fastselect_tpu, est)(n_features_to_select=5,
                                       backend="cpu", **params).fit(X, y)
    assert_allclose(a.feature_importances_, ref.feature_importances_,
                    rtol=1e-4, atol=1e-5)
    assert_array_equal(a.top_features_, ref.top_features_)


@pytest.mark.parametrize("dtype", [torch.int8, torch.uint8, torch.int64])
def test_integer_tensor_takes_the_code_path(dtype, rng):
    """Integer tensors in 0..min(discrete_limit, 127) - 1 are scored from
    their values as int8 codes, no float copy; others are analysed as
    floats, as the array fit analyses them."""
    X, y = _genotypes(rng)
    est = MultiSURF(backend="cpu")
    est._device_ = torch.device("cpu")
    fa = est._int_fast_analysis(torch.from_numpy(X).to(dtype))
    assert fa.codes.dtype == torch.int8 and fa.x_dev is None
    assert fa.n_states == 3
    assert_array_equal(fa.codes.numpy(), X)
    wide = torch.from_numpy(X.astype(np.int64) * 5)   # states 0, 5, 10
    assert est._int_fast_analysis(wide) is None
    a = MultiSURF(n_features_to_select=5, backend="cpu",
                  discrete_limit=20).fit(wide, y)
    b = MultiSURF(n_features_to_select=5, backend="cpu",
                  discrete_limit=20).fit(wide.numpy(), y)
    assert_array_equal(a.feature_importances_, b.feature_importances_)


@pytest.mark.parametrize("bad,match", [
    (np.nan, "NaN"), (np.inf, "infinity")])
def test_tensor_with_nan_or_inf_raises(bad, match, rng):
    X, y = _continuous(rng)
    X[5, 7] = bad
    with pytest.raises(ValueError, match=match):
        MultiSURF(backend="cpu").fit(torch.from_numpy(X), y)


def test_tensor_shape_checks(rng):
    X, y = _continuous(rng)
    Xt = torch.from_numpy(X)
    with pytest.raises(ValueError, match="inconsistent numbers of samples"):
        MultiSURF(backend="cpu").fit(Xt, y[:-1])
    with pytest.raises(ValueError, match="inconsistent numbers of samples"):
        MultiSURF(backend="cpu").fit(Xt, np.stack([y, y], axis=1))
    with pytest.raises(ValueError, match="2D"):
        MultiSURF(backend="cpu").fit(Xt[:, 0], y)
    with pytest.raises(ValueError, match="backend must be one of"):
        MultiSURF(backend="tpu").fit(Xt, y)


@pytest.mark.parametrize("backend", ["cuda", "gpu"])
def test_backend_must_name_the_tensors_device(backend, monkeypatch, rng):
    """A forced backend is never met by scoring on another device: without
    a card it raises as an array fit does, and with one a CPU tensor
    raises instead of being scored on the CPU."""
    X, y = _continuous(rng)
    Xt = torch.from_numpy(X)
    with pytest.raises(RuntimeError, match="no CUDA-enabled GPU"):
        MultiSURF(backend=backend).fit(Xt, y)
    monkeypatch.setattr(backend_mod.torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="on a tensor on cpu"):
        MultiSURF(backend=backend).fit(Xt, y)
    assert MultiSURF(backend="auto").fit(Xt, y).effective_backend_ == "cpu"
