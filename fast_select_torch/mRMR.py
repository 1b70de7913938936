"""Reference submodule path ``fast_select.mRMR``.

``_encode_data_numba`` keeps the reference's internal encoder contract
(``mRMR.py:9-27``: encode X and y against a precomputed sorted
vocabulary, keeping the input dtypes) for code and tests that reach for
it (reference ``tests/test_mrmr.py:189-200``); it is one vectorised
``np.searchsorted`` in place of a JIT-compiled sample loop.
"""

import numpy as np

from fastselect_tpu_torch.models.mrmr import mRMR

__all__ = ["mRMR", "_encode_data_numba"]


def _encode_data_numba(X, y, unique_vals):
    """Encode X and y as indices into ``unique_vals`` (the reference
    Numba kernel's contract, dtype-preserving)."""
    X = np.asarray(X)
    y = np.asarray(y)
    X_encoded = np.searchsorted(unique_vals, X).astype(X.dtype, copy=False)
    y_encoded = np.searchsorted(unique_vals, y).astype(y.dtype, copy=False)
    return X_encoded, y_encoded
