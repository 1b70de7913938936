"""Correlation-based Feature Selection (reference ``CFS.py:246-429``).

Counterpart of ``fastselect_tpu/models/cfs.py``.  Merit = k * r_cf_avg /
sqrt(k + k(k-1) * r_ff_avg) over symmetrical-uncertainty correlations.
The O(p^2) SU matrix, the reference's hot loop (CPU prange all-pairs
``CFS.py:80-104``; one-thread-per-block GPU kernel ``CFS.py:219-243``), is
int8 one-hot GEMMs on the fit's device (``ops/contingency.py``) and stays
there; the greedy best-first search (with the reference's min_r_cf = 0.1
floor) and the redundancy prune are tiny, stay on the host and read the SU
columns of the features they select.
"""

from __future__ import annotations

import math

import numpy as np

from ..ops.contingency import (StagedColumnStats, matrix_column,
                               stage_codes, staged_stat_matrix,
                               staged_target_tables, tables_stat)
from ..utils.backend import default_device, resolve_backend
from ..utils.logging import fit_span
from ..utils.sklearn_compat import (BaseEstimator, KBinsDiscretizer,
                                    SelectorMixin, check_is_fitted,
                                    check_X_y)

# Above this feature count the (p, p) SU matrix is not built; the
# best-first search and the redundancy prune only ever read r_ff COLUMNS
# of selected features (k of them), streamed on demand.
FULL_SU_MAX_P = 8192


def _cfs_merit(sum_r_cf: float, k: int, sum_r_ff: float) -> float:
    """Subset merit (reference ``CFS.py:11-23``)."""
    if k == 0:
        return 0.0
    r_cf_avg = sum_r_cf / k
    r_ff_avg = (2.0 * sum_r_ff) / (k * (k - 1)) if k > 1 else 0.0
    denom = math.sqrt(k + k * (k - 1) * r_ff_avg)
    return (k * r_cf_avg / denom) if denom > 1e-12 else 0.0


def _best_first_search(r_cf: np.ndarray, get_col,
                       min_r_cf: float = 0.1) -> list[int]:
    """Greedy forward selection maximising merit (reference
    ``CFS.py:114-162``), vectorised over candidates per round.

    ``get_col(j) -> r_ff[:, j]`` supplies SU columns of selected
    features only, so the caller may stream them without a (p, p)
    matrix."""
    p = r_cf.shape[0]
    first = int(np.argmax(r_cf))
    if r_cf[first] < min_r_cf:
        return []

    selected = [first]
    in_set = np.zeros(p, dtype=bool)
    in_set[first] = True
    eligible = r_cf >= min_r_cf
    current_best = float(r_cf[first])
    sum_r_cf = float(r_cf[first])
    sum_r_ff = 0.0
    # r_ff sums of each candidate against the current subset
    cross = np.asarray(get_col(first), dtype=np.float64).copy()

    while True:
        cand = np.where(eligible & ~in_set)[0]
        if cand.size == 0:
            break
        k = len(selected) + 1
        merits = np.array([
            _cfs_merit(sum_r_cf + r_cf[i], k, sum_r_ff + cross[i])
            for i in cand
        ])
        best_pos = int(np.argmax(merits))
        if merits[best_pos] > current_best:
            i = int(cand[best_pos])
            current_best = float(merits[best_pos])
            sum_r_cf += float(r_cf[i])
            sum_r_ff += float(cross[i])
            cross += get_col(i)
            selected.append(i)
            in_set[i] = True
        else:
            break
    return selected


def _prune_redundant(selected, r_cf, get_col) -> list[int]:
    """Drop features dominated by an already-kept one (reference
    ``CFS.py:106-112``): prune idx if r_ff[idx, j] >= r_cf[idx] for a kept j."""
    kept: list[int] = []
    for idx in sorted(selected, key=lambda i: -r_cf[i]):
        if not any(get_col(j)[idx] >= r_cf[idx] for j in kept):
            kept.append(idx)
    return kept


def _encode(X: np.ndarray, n_bins: int, strategy: str):
    """(codes (n, p) int32, states per column): float columns through
    ``KBinsDiscretizer`` (reference ``CFS.py:319-337``), the others coded
    by ``np.unique``."""
    p = X.shape[1]
    is_continuous = np.array([np.issubdtype(X[:, i].dtype, np.floating)
                              for i in range(p)])
    X_encoded = np.zeros(X.shape, dtype=np.int32)
    n_states = np.zeros(p, dtype=np.int32)
    cont_idx = np.where(is_continuous)[0]
    if len(cont_idx) > 0:
        disc = KBinsDiscretizer(n_bins=n_bins, encode="ordinal",
                                strategy=strategy, subsample=None)
        X_encoded[:, cont_idx] = disc.fit_transform(
            X[:, cont_idx]).astype(np.int32)
        n_states[cont_idx] = n_bins
    for i in np.where(~is_continuous)[0]:
        uniq, codes = np.unique(X[:, i], return_inverse=True)
        X_encoded[:, i] = codes
        n_states[i] = len(uniq)
    return X_encoded, n_states


class CFS(BaseEstimator, SelectorMixin):
    """Correlation-based Feature Selection on the GPU.

    Parameters
    ----------
    n_bins : int, default=10
        Bins for discretising continuous features.
    strategy : {'uniform', 'quantile', 'kmeans'}, default='uniform'
        KBinsDiscretizer strategy ('kmeans' needs scikit-learn).
    backend : {'auto', 'cuda', 'gpu', 'cpu'}, default='auto'
        Where the SU statistics are computed ('gpu' is an alias of
        'cuda').
    n_jobs : int, default=-1
        API-compatibility no-op.

    Attributes
    ----------
    selected_indices_ : ndarray, indices of selected features (sorted).
    support_mask_ : ndarray of bool, shape (n_features_in_,)
    merit_ : float, merit of the selected subset.
    effective_backend_ : str, 'cuda' or 'cpu'.
    """

    def __init__(self, n_bins=10, strategy="uniform", backend="auto",
                 n_jobs=-1):
        self.n_bins = n_bins
        self.strategy = strategy
        self.backend = backend
        self.n_jobs = n_jobs

    @fit_span
    def fit(self, X, y):
        """Find the best feature subset by correlation analysis."""
        feature_names = np.asarray(X.columns) if hasattr(X, "columns") else None
        X, y = check_X_y(X, y, dtype=None, ensure_min_samples=2)
        self.n_features_in_ = p = X.shape[1]
        if feature_names is not None:
            self.feature_names_in_ = feature_names

        X_encoded, n_states = _encode(X, self.n_bins, self.strategy)
        unique_y, y_encoded = np.unique(y, return_inverse=True)
        y_encoded = y_encoded.astype(np.int32)

        effective = resolve_backend(self.backend, "CFS")
        device = default_device(effective)
        self.effective_backend_ = effective

        s = int(max(n_states.max() if n_states.size else 1, len(unique_y)))
        n = X.shape[0]
        if p > FULL_SU_MAX_P:
            # GWAS scale: SU columns of selected features streamed on
            # demand (cached: the prune and merit reuse them) against the
            # codes staged ONCE for the whole fit
            staged = StagedColumnStats(X_encoded, s, device=device)
            tables = staged.tables_vs(y_encoded, s)

            def read_col(j):
                col = staged.column(j, "su").astype(np.float32)
                col[j] = 0.0
                return col
        else:
            # the (p, p) SU matrix stays on the device; the search and
            # the prune read the columns of selected features only
            xt = stage_codes(X_encoded, s, device)
            tables = staged_target_tables(xt, y_encoded, s, s)
            R = staged_stat_matrix(xt, n, s, "su")

            def read_col(j):
                return matrix_column(R, j, p).astype(np.float32)

        r_cf_all = tables_stat(tables, n, "su").cpu().numpy()
        col_cache: dict[int, np.ndarray] = {}

        def get_col(j):
            j = int(j)
            if j not in col_cache:
                col_cache[j] = read_col(j)
            return col_cache[j]

        selected = _best_first_search(r_cf_all, get_col)
        selected = np.sort(np.asarray(selected, dtype=int))
        selected = np.sort(np.asarray(
            _prune_redundant(selected, r_cf_all, get_col), dtype=int))
        self.selected_indices_ = selected
        self.support_mask_ = np.zeros(self.n_features_in_, dtype=bool)
        if len(selected) > 0:
            self.support_mask_[selected] = True

        k = len(selected)
        if k == 0:
            self.merit_ = 0.0
        else:
            sum_r_cf = float(np.sum(r_cf_all[selected]))
            sum_r_ff = float(sum(
                get_col(selected[a])[selected[b]]
                for a in range(k) for b in range(a + 1, k)))
            self.merit_ = _cfs_merit(sum_r_cf, k, sum_r_ff)
        return self

    def _get_support_mask(self):
        check_is_fitted(self)
        return self.support_mask_

    def transform(self, X):
        """Reduce X to the selected features (a DataFrame stays one)."""
        check_is_fitted(self)
        if hasattr(X, "iloc"):
            return X.iloc[:, self.support_mask_]
        return X[:, self.support_mask_]
