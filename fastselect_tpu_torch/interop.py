"""Carry the JAX package's state into the port.

Everything here reads numpy arrays and plain attributes of
``fastselect_tpu`` objects, so the port never imports JAX: the objects'
arrays are numpy on the host already.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.cfs import CFS
from .models.mdr import MDR
from .models.mrmr import mRMR
from .models.multisurf import MultiSURF
from .models.relieff import ReliefF
from .models.surf import SURF
from .models.turf import TuRF
from .ops.relief_discrete import PackedCodes
from .utils.preprocessing import FeatureAnalysis

_ESTIMATORS = {"MultiSURF": MultiSURF, "SURF": SURF, "ReliefF": ReliefF,
               "mRMR": mRMR, "CFS": CFS, "MDR": MDR}
_RELIEF_FITTED = ("n_features_in_", "feature_importances_", "top_features_",
                  "is_discrete_", "effective_backend_", "feature_names_in_",
                  "classes_")
_FITTED = {"mRMR": ("n_features_in_", "relevance_scores_",
                    "redundancy_matrix_", "top_features_",
                    "feature_importances_", "unique_vals_"),
           "CFS": ("n_features_in_", "selected_indices_", "support_mask_",
                   "merit_", "effective_backend_", "feature_names_in_"),
           "MDR": ("best_interaction_", "best_cvc_", "best_mean_testing_ba_",
                   "best_model_lookup_table_", "classes_")}
# the attribute that says a JAX estimator was fitted
_FITTED_MARK = {"mRMR": "top_features_", "CFS": "support_mask_",
                "MDR": "best_interaction_"}
_BACKENDS = {"auto": "auto", "tpu": "auto", "cpu": "cpu", "gpu": "gpu"}


def analysis_from_jax(fa, device="cpu") -> FeatureAnalysis:
    """The port's FeatureAnalysis, on ``device``, from a ``fastselect_tpu``
    one (numpy ``is_discrete``, ``recip`` and ``codes``, and
    ``n_states``).  The codes of mixed X come along with those of
    all-discrete X; the hybrid engine reads their discrete columns.  X is
    not carried over."""
    device = torch.device(device)
    codes = (None if fa.codes is None else
             torch.as_tensor(np.asarray(fa.codes, np.int8), device=device))
    return FeatureAnalysis(
        torch.as_tensor(np.asarray(fa.is_discrete, bool), device=device),
        torch.as_tensor(np.asarray(fa.recip, np.float32), device=device),
        codes=codes, n_states=int(fa.n_states))


def packed_codes_from_jax(pk, device="cpu") -> PackedCodes:
    """The port's PackedCodes, on ``device``, from a ``fastselect_tpu``
    one: the same bytes (its packed array read as numpy), bits, n and p.
    A consumed one raises its own ``RuntimeError``."""
    pk.check_live()
    packed = torch.as_tensor(np.array(pk.packed, np.uint8), device=device)
    return PackedCodes(packed, int(pk.bits), int(pk.n), int(pk.p))


def _params_from_jax(est) -> dict:
    params = est.get_params(deep=False)
    params["backend"] = _BACKENDS[str(params["backend"]).lower()]
    return params


def estimator_from_jax(est):
    """A fitted port ``MultiSURF``, ``SURF``, ``ReliefF``, ``TuRF``,
    ``mRMR``, ``CFS`` or ``MDR`` from the fitted ``fastselect_tpu``
    estimator of the same name: the same parameters (a Relief estimator's
    ``transfer_dtype`` included: the port stages a CUDA fit's host X at
    it) and fitted state, so ``transform`` selects the same columns (an
    MDR's ``predict`` predicts the same).  A JAX ``backend='tpu'`` becomes
    ``'auto'``.  ``effective_backend_``
    keeps saying where the scores were computed.  A
    TuRF's Relief estimator becomes the port's, with its parameters; any
    other estimator is kept as it is.  Its fitted state is carried by
    ``save_state``.  An mRMR's redundancy matrix comes as the host array
    (None past its streaming threshold); an MDR's ``best_interaction_``
    stays a tuple."""
    if type(est).__name__ == "TuRF" and hasattr(est, "top_features_"):
        params = est.get_params(deep=False)
        inner = _ESTIMATORS.get(type(params["estimator"]).__name__)
        if inner is not None:
            params["estimator"] = inner(**_params_from_jax(
                params["estimator"]))
        return TuRF(**params).load_state(est.save_state())
    name = type(est).__name__
    cls = _ESTIMATORS.get(name)
    if cls is None or not hasattr(est, _FITTED_MARK.get(
            name, "feature_importances_")):
        raise TypeError("estimator_from_jax takes a fitted fastselect_tpu "
                        "MultiSURF, SURF, ReliefF, TuRF, mRMR, CFS or MDR")
    out = cls(**_params_from_jax(est))
    for attr in _FITTED.get(name, _RELIEF_FITTED):
        if hasattr(est, attr):
            value = getattr(est, attr)
            setattr(out, attr, value if value is None or isinstance(
                value, (int, float, str, tuple)) else np.array(value))
    return out
