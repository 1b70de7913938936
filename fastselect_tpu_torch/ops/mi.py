"""Mutual-information library (reference ``mutual_information.py``).

Counterpart of ``fastselect_tpu/ops/mi.py``: ``calculate_mi_single_pair``,
``calculate_mi_relevance`` and ``calculate_mi_matrices`` over
integer-coded discrete arrays, units 'bit' or 'nat'.  Both the relevance
vector and the redundancy matrix are int8 one-hot GEMMs
(``ops/contingency.py``) on the backend's device.
"""

from __future__ import annotations

import math
from typing import Literal, Tuple

import numpy as np

from ..utils.backend import default_device, resolve_backend
from .contingency import (feature_target_tables, pairwise_stat_matrix,
                          tables_stat)


def _validate_discrete(arr: np.ndarray, name: str) -> np.ndarray:
    """Ensure integer-coded, non-negative input (reference
    ``mutual_information.py:13-22``)."""
    if not np.issubdtype(arr.dtype, np.integer):
        raise ValueError(
            f"{name} must be an integer-coded array (got {arr.dtype}). "
            "Discretise continuous data before calling this function."
        )
    if arr.size and arr.min() < 0:
        raise ValueError(
            f"{name} contains negative values; expected 0..K-1 codes.")
    return arr.astype(np.int32, copy=False)


def _log_base(unit: str) -> float:
    return math.log(2.0) if unit == "bit" else 1.0


def calculate_mi_single_pair(
    x1: np.ndarray,
    x2: np.ndarray,
    *,
    backend: Literal["auto", "cuda", "gpu", "cpu"] = "auto",
    unit: Literal["bit", "nat"] = "bit",
) -> float:
    """Mutual information I(x1; x2) for discrete 1-D arrays."""
    if x1.ndim != 1 or x2.ndim != 1 or x1.shape != x2.shape:
        raise ValueError("x1 and x2 must be 1-D arrays of equal length")
    x1_d = _validate_discrete(np.ravel(x1), "x1")
    x2_d = _validate_discrete(np.ravel(x2), "x2")
    device = default_device(resolve_backend(backend,
                                            "calculate_mi_single_pair"))
    s1 = int(x1_d.max()) + 1
    s2 = int(x2_d.max()) + 1
    tables = feature_target_tables(x1_d[:, None], x2_d, s1, s2, device)
    return float(tables_stat(tables, x1_d.shape[0], "mi",
                             _log_base(unit))[0])


def _validated_setup(X, y, backend, unit, caller):
    if X.ndim != 2 or y.ndim != 1 or X.shape[0] != y.shape[0]:
        raise ValueError("X must be 2-D and y 1-D with matching sample size")
    X_d = _validate_discrete(X, "X")
    y_d = _validate_discrete(y, "y")
    device = default_device(resolve_backend(backend, caller))
    s = int(max(X_d.max() if X_d.size else 0, y_d.max())) + 1
    return X_d, y_d, _log_base(unit), device, s


def _relevance_vector(X_d, y_d, s, device, log_base):
    """I(X_f; y) per feature from already-validated codes, host float64."""
    tables = feature_target_tables(X_d, y_d, s, s, device)
    return tables_stat(tables, X_d.shape[0], "mi",
                       log_base).cpu().numpy().astype(np.float64)


def calculate_mi_relevance(
    X: np.ndarray,
    y: np.ndarray,
    *,
    backend: Literal["auto", "cuda", "gpu", "cpu"] = "auto",
    unit: Literal["bit", "nat"] = "bit",
) -> np.ndarray:
    """Relevance vector only: I(X_f; y) per feature, O(p) memory.

    The GWAS-scale entry point: no (p, p) matrix is built.  Pair with
    ``ops.contingency.StagedColumnStats`` for redundancy columns on demand
    (the memory-bounded mRMR greedy).
    """
    X_d, y_d, log_base, device, s = _validated_setup(
        X, y, backend, unit, "calculate_mi_relevance")
    return _relevance_vector(X_d, y_d, s, device, log_base)


def calculate_mi_matrices(
    X: np.ndarray,
    y: np.ndarray,
    *,
    backend: Literal["auto", "cuda", "gpu", "cpu"] = "auto",
    unit: Literal["bit", "nat"] = "bit",
) -> Tuple[np.ndarray, np.ndarray]:
    """(relevance, redundancy) MI matrices for discrete data.

    relevance[f] = I(X_f; y); redundancy[i, j] = I(X_i; X_j) with zero
    diagonal, both in `unit`.
    """
    X_d, y_d, log_base, device, s = _validated_setup(
        X, y, backend, unit, "calculate_mi_matrices")
    relevance = _relevance_vector(X_d, y_d, s, device, log_base)
    redundancy = pairwise_stat_matrix(X_d, s, "mi", device=device,
                                      log_base=log_base)
    np.fill_diagonal(redundancy, 0.0)
    return relevance, redundancy
