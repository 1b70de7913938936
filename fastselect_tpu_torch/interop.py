"""Carry the JAX package's state into the port.

Everything here reads numpy arrays and plain attributes of
``fastselect_tpu`` objects, so the port never imports JAX: the objects'
arrays are numpy on the host already.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.multisurf import MultiSURF
from .utils.preprocessing import FeatureAnalysis

_FITTED = ("n_features_in_", "feature_importances_", "top_features_",
           "is_discrete_", "effective_backend_", "feature_names_in_")
_BACKENDS = {"auto": "auto", "tpu": "auto", "cpu": "cpu", "gpu": "gpu"}


def analysis_from_jax(fa, device="cpu") -> FeatureAnalysis:
    """The port's FeatureAnalysis, on ``device``, from a ``fastselect_tpu``
    one (numpy ``is_discrete`` and ``recip``).  X is not carried over."""
    device = torch.device(device)
    return FeatureAnalysis(
        torch.as_tensor(np.asarray(fa.is_discrete, bool), device=device),
        torch.as_tensor(np.asarray(fa.recip, np.float32), device=device))


def estimator_from_jax(est) -> MultiSURF:
    """A fitted port ``MultiSURF`` from a fitted ``fastselect_tpu``
    ``MultiSURF``: the same parameters and fitted arrays, so ``transform``
    selects the same columns.  A JAX ``backend='tpu'`` becomes ``'auto'``.
    ``effective_backend_`` keeps saying where the scores were computed."""
    if type(est).__name__ != "MultiSURF" or not hasattr(
            est, "feature_importances_"):
        raise TypeError("estimator_from_jax takes a fitted "
                        "fastselect_tpu.MultiSURF")
    params = est.get_params(deep=False)
    out = MultiSURF(
        n_features_to_select=params["n_features_to_select"],
        backend=_BACKENDS[params["backend"]],
        use_star=params["use_star"],
        discrete_limit=params["discrete_limit"],
        n_jobs=params["n_jobs"],
        verbose=params["verbose"])
    for name in _FITTED:
        if hasattr(est, name):
            value = getattr(est, name)
            setattr(out, name, value if isinstance(value, (int, str))
                    else np.array(value))
    return out
