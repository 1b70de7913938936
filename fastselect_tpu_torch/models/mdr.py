"""Multifactor Dimensionality Reduction classifier (reference
``MDR.py:148-357``).

Counterpart of ``fastselect_tpu/models/mdr.py``.  Epistasis search over
SNP genotypes coded 0/1/2, binary targets only.  Every C(p, k) combination
is scored by the balanced accuracy of its 3^k contingency-table model
under StratifiedKFold (shuffle, random_state=42, pinned for fold parity
with the reference); the final model is chosen by cross-validation
consistency with a mean-test-BA tie-break.  Combo scoring runs on the
fit's device as int8 GEMMs (``ops/mdr_op.py``), selected by the exact
int64 key; prediction uses a host-side 3^k lookup table.
"""

from __future__ import annotations

from collections import Counter
from math import comb

import numpy as np

from ..ops import relief
from ..ops.mdr_op import MDRFoldScorer, unrank_combos
from ..parallel.mdr_shard import ShardedMDRFoldScorer
from ..parallel.sharded import check_same_inputs, make_mesh
from ..utils.backend import default_device, resolve_backend
from ..utils.logging import fit_span
from ..utils.sklearn_compat import (BaseEstimator, ClassifierMixin,
                                    StratifiedKFold, check_array,
                                    check_is_fitted, check_X_y,
                                    unique_labels)

MAX_K_FOR_KERNEL = 6
_COMBO_CHUNK = 1 << 18  # stream combos; never materialise C(p,k) at once


def _balanced_accuracy(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """Mean of sensitivity and specificity over 0/1 labels; a class
    absent from ``y_true`` contributes rate 0 (the reference's held-out
    fold scoring convention, ``MDR.py:289-296``)."""
    rates = []
    for cls in (1, 0):
        present = y_true == cls
        rates.append(float((present & (y_pred == cls)).sum()
                           / present.sum()) if present.any() else 0.0)
    return 0.5 * sum(rates)


class MDR(BaseEstimator, ClassifierMixin):
    """GPU-accelerated Multifactor Dimensionality Reduction.

    Parameters
    ----------
    k : int, default=2
        Interaction order to search (max 6).
    cv : int, default=10
        Stratified folds for model selection.
    backend : {'auto', 'cuda', 'gpu', 'cpu'}, default='auto'
        Where combos are scored: 'auto' takes the GPU when there is one
        ('gpu' is an alias of 'cuda').
    verbose : bool, default=False
        Print per-fold progress.

    Attributes
    ----------
    best_interaction_ : tuple of int
    best_cvc_ : int — cross-validation consistency count.
    best_mean_testing_ba_ : float
    best_model_lookup_table_ : ndarray of shape (3**k,)
    """

    def __init__(self, k: int = 2, cv: int = 10, backend: str = "auto",
                 verbose: bool = False):
        self.k = k
        self.cv = cv
        self.backend = backend
        self.verbose = verbose

    def _make_fold_scorer(self, X, w_case, w_ctrl, device):
        """All-folds combo scorer: the combos sharded over every visible
        GPU when there is more than one (``ops/relief.py:_mesh_devices``,
        off under ``FS_NO_AUTO_SHARD=1``; across processes every process
        must hold the same X and folds, checked), else on the fit's
        device."""
        devs = relief._mesh_devices(device)
        if len(devs) > 1:
            check_same_inputs(make_mesh(devs), X, w_case, w_ctrl)
            return ShardedMDRFoldScorer(X, w_case, w_ctrl, self.k,
                                        devices=devs)
        return MDRFoldScorer(X, w_case, w_ctrl, self.k, device=device)

    def _create_lookup_table(self, X, y, interaction_indices):
        """3^k binary LUT (reference MDR.py:176-195): cell is high-risk iff
        case/(control+1e-9) strictly exceeds the global case/control ratio."""
        k = self.k
        powers = np.array([3 ** (k - 1 - j) for j in range(k)], np.int64)
        cells = (X[:, np.asarray(interaction_indices, int)].astype(np.int64)
                 @ powers)
        n_cells = 3 ** k
        case = np.bincount(cells[y == 1], minlength=n_cells)
        ctrl = np.bincount(cells[y != 1], minlength=n_cells)
        total_cases = case.sum()
        total_controls = ctrl.sum()
        threshold = (np.inf if total_controls == 0
                     else total_cases / total_controls)
        ratios = case / (ctrl + 1e-9)
        return (ratios > threshold).astype(np.uint8)

    def _internal_predict(self, X, interaction, lookup_table):
        k = len(interaction)
        powers = np.array([3 ** (k - 1 - j) for j in range(k)], np.int64)
        cells = (X[:, np.asarray(interaction, int)].astype(np.int64) @ powers)
        return lookup_table[cells]

    def _fold_weights(self, y, splits):
        """(F, n) 0/1 case and control weights of each fold's training
        samples."""
        w_case = np.zeros((len(splits), len(y)), np.uint8)
        w_ctrl = np.zeros((len(splits), len(y)), np.uint8)
        for f, (train_idx, _) in enumerate(splits):
            w_case[f, train_idx] = y[train_idx] == 1
            w_ctrl[f, train_idx] = y[train_idx] != 1
        return w_case, w_ctrl

    def _search(self, scorer, n_features, n_combos):
        """Each fold's best combo, by the exact key, first in
        lexicographic order on ties: combos unranked on the device in
        int64 (exact to C(p, k) < 2^62), the (F,) maxima kept there until
        the search ends."""
        best_ranks = scorer.search(n_features, n_combos,
                                   chunk=_COMBO_CHUNK)[2]
        return [tuple(int(v) for v in
                      unrank_combos(n_features, self.k, int(r), int(r) + 1)[0])
                for r in best_ranks]

    @fit_span
    def fit(self, X, y):
        """Search all k-way interactions and fit the best MDR model."""
        X, y = check_X_y(X, y, dtype=np.uint8)
        self.classes_ = unique_labels(y)

        if len(self.classes_) != 2:
            raise ValueError("MDR only supports binary classification.")
        if np.max(X) > 2 or np.min(X) < 0:
            raise ValueError("Genotypes must be coded 0/1/2.")
        if self.k > MAX_K_FOR_KERNEL:
            raise ValueError(
                f"k={self.k} exceeds MAX_K_FOR_KERNEL={MAX_K_FOR_KERNEL}.")

        n_samples, n_features = X.shape
        if self.k > n_features:
            raise ValueError(
                f"k must be <= n_features. Got k={self.k}, "
                f"n_features={n_features}")

        effective = resolve_backend(str(self.backend).lower(), "MDR")
        device = default_device(effective)
        self.effective_backend_ = effective

        n_combos = comb(n_features, self.k)
        skf = StratifiedKFold(n_splits=self.cv, shuffle=True, random_state=42)
        splits = list(skf.split(X, y))
        if self.verbose:
            print(
                f"CV with backend={effective.upper()}: "
                f"{self.k}-way search over {n_combos} combos"
            )

        # Chunk-outer / fold-inner: combos are enumerated once and each
        # chunk is scored for every fold by one GEMM a tile, with per-fold
        # train-sample weights.
        w_case, w_ctrl = self._fold_weights(y, splits)
        scorer = self._make_fold_scorer(X, w_case, w_ctrl, device)
        fold_best_models = self._search(scorer, n_features, n_combos)

        fold_test_bas = []
        for fold_i, (train_idx, test_idx) in enumerate(splits, start=1):
            best_combo = fold_best_models[fold_i - 1]
            lookup = self._create_lookup_table(X[train_idx], y[train_idx],
                                               best_combo)
            test_ba = _balanced_accuracy(
                y[test_idx],
                self._internal_predict(X[test_idx], best_combo, lookup))
            fold_test_bas.append(test_ba)

            if self.verbose:
                print(f"  Fold {fold_i}/{self.cv}: best {best_combo}, "
                      f"Test BA = {test_ba:.4f}")
        self._fold_best = fold_best_models
        self._fold_test_ba = fold_test_bas

        # Winner = highest cross-validation consistency, ties broken by
        # mean held-out BA (first-seen fold order wins exact BA ties,
        # matching the reference's selection semantics, MDR.py:304-323).
        counts = Counter(fold_best_models)
        max_cvc = max(counts.values())
        mean_ba = {
            model: float(np.mean([ba for m, ba in zip(fold_best_models,
                                                      fold_test_bas)
                                  if m == model]))
            for model, c in counts.items() if c == max_cvc
        }
        best_model = max(mean_ba, key=mean_ba.__getitem__)

        self.best_interaction_ = best_model
        self.best_cvc_ = max_cvc
        self.best_mean_testing_ba_ = mean_ba[best_model]
        if self.verbose:
            print("\nFit Complete")
            print(f"Best interaction: {self.best_interaction_}")
            print(f"CVC: {self.best_cvc_}/{self.cv}")
            print(f"Mean testing BA: {self.best_mean_testing_ba_:.4f}")

        self.best_model_lookup_table_ = self._create_lookup_table(
            X, y, self.best_interaction_)
        return self

    def predict(self, X):
        """Predict 0/1 labels via the fitted lookup table."""
        check_is_fitted(self)
        X = check_array(X, dtype=np.uint8)
        return self._internal_predict(
            X, self.best_interaction_, self.best_model_lookup_table_)

    def transform(self, X):
        """Column vector of predictions (reference MDR.py:343-344)."""
        return self.predict(X).reshape(-1, 1)

    def predict_proba(self, X):
        """Not implemented: MDR is a hard classifier (reference
        MDR.py:346-357)."""
        raise NotImplementedError(
            "predict_proba is not supported in this MDR implementation."
        )
