"""MultiSURF / MultiSURF* estimator (reference ``MultiSURF.py:273-489``).

Counterpart of ``fastselect_tpu/models/multisurf.py``.  Adaptive
per-sample threshold mu_i - sigma_i/2 over the focal sample's distance
distribution; near hits/misses accumulate normalised per-feature diffs;
MultiSURF* additionally subtracts far-miss diffs (and, matching the
reference exactly, has NO far-hit term, unlike SURF*).
"""

from __future__ import annotations

import numpy as np

from ._relief_base import BaseReliefSelector
from ..ops.relief import relief_scores


class MultiSURF(BaseReliefSelector):
    """GPU-accelerated feature selection using the MultiSURF algorithm.

    Parameters
    ----------
    n_features_to_select : int or float, default=0.2
        Number (int) or fraction (float in (0, 1]) of top features to keep.
    backend : {'auto', 'cuda', 'gpu', 'cpu'}, default='auto'
        Compute backend. 'auto' uses a CUDA GPU when present, else the
        CPU; 'gpu' is an alias of 'cuda'. Forcing 'cuda' without a GPU
        raises RuntimeError.
    use_star : bool, default=False
        Run the MultiSURF* adaptation (adds far-miss updates).
    discrete_limit : int, default=10
        Features with at most this many unique values are treated as
        discrete (Hamming distance instead of range-scaled L1).
    n_jobs : int, default=-1
        Accepted for API compatibility with the reference.
    verbose : bool, default=False
        Print progress messages during fit.
    transfer_dtype : {None, 'float32', 'float16', 'bfloat16'}, default=None
        Staging dtype of the host-to-device copy of a host X of at least
        2**22 values on CUDA fits (smaller X, tensors and CPU fits take
        one float32 copy).  'float16'/'bfloat16' halve the bytes copied,
        at a ~1e-3 relative cost in score precision.  The default None
        stages exact float32: JAX's auto rule (float16 for float X of at
        least 2**24 values with p >= 4n) did not make such a fit faster
        on an H100, where the host's float16 cast outweighs the halved
        copy.  The dtype actually used is recorded in ``transfer_dtype_``.

    Attributes
    ----------
    n_features_in_ : int
    feature_importances_ : ndarray of shape (n_features,)
    top_features_ : ndarray of shape (n_features_to_select,)
    is_discrete_ : ndarray of shape (n_features,)
    effective_backend_ : str
        'cuda' or 'cpu': where the scores were computed.
    transfer_dtype_ : str
        The staging dtype a CUDA fit of a host X of at least 2**22 values
        used (set by such a fit only).
    """

    _algo_name = "MultiSURF"
    _validate_dtype = np.float32

    def __init__(
        self,
        n_features_to_select: int | float = 0.2,
        backend: str = "auto",
        use_star: bool = False,
        discrete_limit: int = 10,
        n_jobs: int = -1,
        verbose: bool = False,
        transfer_dtype: str | None = None,
    ):
        self.n_features_to_select = n_features_to_select
        self.backend = backend
        self.use_star = use_star
        self.discrete_limit = discrete_limit
        self.n_jobs = n_jobs
        self.verbose = verbose
        self.transfer_dtype = transfer_dtype

    def _score(self, X, y, analysis, n_select):
        # Labels only ever enter the kernel through y_i == y_j comparisons
        # (reference MultiSURF.py:86), so integer codes are equivalent.
        _, y_enc = np.unique(y, return_inverse=True)
        self._log_running("MultiSURF*" if self.use_star else "MultiSURF")
        return relief_scores(
            X, y_enc, analysis.recip, analysis.is_discrete,
            algo="multisurf", use_star=self.use_star, device=self._device(),
            codes=analysis.codes, n_states=analysis.n_states,
            from_host=self._device_ is None)
