"""Carry the JAX package's state into the port.

Everything here reads numpy arrays and plain attributes of
``fastselect_tpu`` objects, so the port never imports JAX: the objects'
arrays are numpy on the host already.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.multisurf import MultiSURF
from .models.relieff import ReliefF
from .models.surf import SURF
from .utils.preprocessing import FeatureAnalysis

_ESTIMATORS = {"MultiSURF": MultiSURF, "SURF": SURF, "ReliefF": ReliefF}
_FITTED = ("n_features_in_", "feature_importances_", "top_features_",
           "is_discrete_", "effective_backend_", "feature_names_in_",
           "classes_")
_BACKENDS = {"auto": "auto", "tpu": "auto", "cpu": "cpu", "gpu": "gpu"}


def analysis_from_jax(fa, device="cpu") -> FeatureAnalysis:
    """The port's FeatureAnalysis, on ``device``, from a ``fastselect_tpu``
    one (numpy ``is_discrete``, ``recip`` and ``codes``, and
    ``n_states``).  X is not carried over."""
    device = torch.device(device)
    codes = (None if fa.codes is None else
             torch.as_tensor(np.asarray(fa.codes, np.int8), device=device))
    return FeatureAnalysis(
        torch.as_tensor(np.asarray(fa.is_discrete, bool), device=device),
        torch.as_tensor(np.asarray(fa.recip, np.float32), device=device),
        codes=codes, n_states=int(fa.n_states))


def estimator_from_jax(est):
    """A fitted port ``MultiSURF``, ``SURF`` or ``ReliefF`` from the fitted
    ``fastselect_tpu`` estimator of the same name: the same parameters
    (``transfer_dtype``, a TPU staging option, is not ported) and fitted
    arrays, so ``transform`` selects the same columns.  A JAX
    ``backend='tpu'`` becomes ``'auto'``.  ``effective_backend_`` keeps
    saying where the scores were computed."""
    cls = _ESTIMATORS.get(type(est).__name__)
    if cls is None or not hasattr(est, "feature_importances_"):
        raise TypeError("estimator_from_jax takes a fitted fastselect_tpu "
                        "MultiSURF, SURF or ReliefF")
    params = est.get_params(deep=False)
    params.pop("transfer_dtype", None)
    params["backend"] = _BACKENDS[params["backend"]]
    out = cls(**params)
    for name in _FITTED:
        if hasattr(est, name):
            value = getattr(est, name)
            setattr(out, name, value if isinstance(value, (int, str))
                    else np.array(value))
    return out
