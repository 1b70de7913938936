"""TuRF meta-estimator (reference ``TuRF.py:7-136``).

Counterpart of ``fastselect_tpu/models/turf.py``.  Iterative elimination:
fit the base estimator, drop the worst ``pct_remove`` fraction of the
remaining features (at least 1) each round, stop at
``n_features_to_select`` or ``n_iterations``.  ``feature_importances_``
holds the FIRST full-set scores; ``top_features_`` is sorted ascending by
index (both pinned by the reference, ``TuRF.py:87-88,117-119``).

Wraps any estimator that has ``feature_importances_`` after fit.  With
``checkpoint_path`` set, every round atomically saves the loop state
(active set, scores, round, a fingerprint of the data); a killed run fit
again with the same path and data resumes from the last finished round.
``save_state``/``load_state`` expose the same state dict in memory; its
schema and fingerprint are the JAX package's, so a snapshot of either
package resumes in the other.

When the base estimator is one of the port's Relief selectors, X goes to
its device once (``_relief_base.uploads`` counts the copies), is analysed
there once, and every round gathers the active columns of that copy on
the device and scores them with the engine a fit on them alone would take
(discrete, hybrid or fused): the re-fitting loop's scores without its
per-round validation, copy and analysis.  The JAX package masks dropped
columns instead, to keep one compiled shape; gathering lets the work
shrink with the active set.  X with a discrete column of more than 127
states re-fits the base estimator on the active columns each round.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import tempfile

import numpy as np

from ..utils.logging import fit_span
from ..utils.sklearn_compat import (BaseEstimator, TransformerMixin,
                                    check_is_fitted, clone, validate_data)


class TuRF(TransformerMixin, BaseEstimator):
    """Iterative Relief (TuRF) wrapper around a feature-scoring estimator.

    Parameters
    ----------
    estimator : estimator object
        Base estimator with a ``feature_importances_`` attribute after fit.
        Cloned, never modified.
    n_features_to_select : int, default=10
        Final number of features to keep.
    pct_remove : float, default=0.1
        Fraction of remaining features removed per iteration, in (0, 1).
    n_iterations : int or None, default=None
        Iteration cap; None runs until the target count is reached.
    verbose : bool, default=False
        Print per-iteration feature counts.
    checkpoint_path : str or None, default=None
        File for per-iteration snapshots of the elimination state.  Each
        round the state is written atomically; a later ``fit`` on the
        same data resumes from the last finished iteration, and the
        snapshot is deleted when the fit finishes.

    Attributes
    ----------
    n_features_in_ : int
    feature_importances_ : ndarray of shape (n_features_in_,)
        Scores from the first (full feature set) iteration.
    top_features_ : ndarray
        Selected feature indices, sorted ascending.
    """

    def __init__(
        self,
        estimator,
        n_features_to_select: int = 10,
        pct_remove: float = 0.1,
        n_iterations: int | None = None,
        verbose: bool = False,
        checkpoint_path: str | None = None,
    ):
        self.estimator = estimator
        self.n_features_to_select = n_features_to_select
        self.pct_remove = pct_remove
        self.n_iterations = n_iterations
        self.verbose = verbose
        self.checkpoint_path = checkpoint_path

    @fit_span
    def fit(self, X, y):
        """Run the iterative elimination loop."""
        # small-int input (genotypes) keeps its dtype end to end: the Relief
        # estimator's int8 fast path then applies to every round
        keep_int = (isinstance(X, np.ndarray)
                    and np.issubdtype(X.dtype, np.integer))
        X, y = validate_data(
            self, X, y, y_numeric=True,
            dtype="numeric" if keep_int else np.float64, ensure_2d=True)
        self.n_features_in_ = X.shape[1]
        if not 0 < self.pct_remove < 1:
            raise ValueError("pct_remove must be between 0 and 1.")

        base = clone(self.estimator)
        scorer = self._make_fast_scorer(base, X, y)
        if scorer is not None:
            return self._fit_loop(X, y, None, scorer)
        return self._fit_loop(X, y, base, None)

    def _fit_loop(self, X, y, base, scorer):
        """The elimination loop.

        ``scorer(active) -> scores[len(active)]`` is a fast scorer;
        otherwise ``base.fit(X[:, active], y)`` validates and uploads the
        active columns every round (the reference's loop,
        ``TuRF.py:110-111``).
        """
        self._data_fp_ = self._data_fingerprint(X, y)
        resumed = self._load_checkpoint()
        if resumed is not None:
            active = np.asarray(resumed["active"])
            scores = np.asarray(resumed["scores"])
            self.feature_importances_ = np.asarray(
                resumed["feature_importances"])
            iteration = int(resumed["iteration"])
            if self.verbose:
                print(f"Resuming TuRF from iteration {iteration} "
                      f"({len(active)} features remaining).")
        else:
            active = np.arange(self.n_features_in_)
            scores = self._round_scores(X, y, base, scorer, active)
            self.feature_importances_ = scores.copy()
            iteration = 0
            self._write_checkpoint(active, scores, iteration)

        while len(active) > self.n_features_to_select and (
                self.n_iterations is None or iteration < self.n_iterations):
            n_remove = max(1, int(len(active) * self.pct_remove))
            if len(active) - n_remove < self.n_features_to_select:
                n_remove = len(active) - self.n_features_to_select

            worst = np.argsort(scores)[:n_remove]
            active = np.delete(active, worst)

            if self.verbose:
                print(f"Iteration {iteration}: {len(active)} features "
                      "remaining.")

            scores = self._round_scores(X, y, base, scorer, active)
            iteration += 1
            self._write_checkpoint(active, scores, iteration)

        order = np.argsort(scores)[::-1]
        self.top_features_ = np.sort(active[order])
        self._final_scores_ = scores
        self._active_ = active
        self._iteration_ = iteration
        if self.checkpoint_path and os.path.exists(self.checkpoint_path):
            os.remove(self.checkpoint_path)
        return self

    @staticmethod
    def _round_scores(X, y, base, scorer, active):
        if scorer is not None:
            return scorer(active)
        base.fit(X if len(active) == X.shape[1] else X[:, active], y)
        return np.asarray(base.feature_importances_)

    # -- per-iteration checkpoints ------------------------------------------

    @staticmethod
    def _data_fingerprint(X, y) -> str:
        """Identity of the data for resuming a checkpoint: shapes, dtypes
        and a strided sample of at most about 64 KB of values, so that a
        snapshot of other data of the same width never resumes.  The same
        digest as the JAX package's for the same numpy X and y."""
        X = np.asarray(X)
        y = np.asarray(y)
        h = hashlib.sha1()
        h.update(repr((X.shape, str(X.dtype), y.shape,
                       str(y.dtype))).encode())
        step = max(1, X.size // 8192)
        h.update(np.ascontiguousarray(X.reshape(-1)[::step]).tobytes())
        h.update(np.ascontiguousarray(y).tobytes())
        return h.hexdigest()

    def _state_dict(self, active, scores, iteration) -> dict:
        return {
            "active": np.asarray(active).copy(),
            "scores": np.asarray(scores).copy(),
            "feature_importances": np.asarray(
                self.feature_importances_).copy(),
            "n_features_in": int(self.n_features_in_),
            "data_fingerprint": getattr(self, "_data_fp_", None),
            "iteration": int(iteration),
        }

    def _write_checkpoint(self, active, scores, iteration) -> None:
        if not self.checkpoint_path:
            return
        # temporary file and rename in the target directory: a kill during
        # the dump never leaves a truncated snapshot behind
        d = os.path.dirname(os.path.abspath(self.checkpoint_path))
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".turf.tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                pickle.dump(self._state_dict(active, scores, iteration), f)
            os.replace(tmp, self.checkpoint_path)
        except BaseException:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise

    def _load_checkpoint(self):
        """Mid-run state to resume from: a ``load_state`` dict first, else
        a ``checkpoint_path`` snapshot of this data."""
        state = getattr(self, "_resume_state_", None)
        self._resume_state_ = None
        if state is None and self.checkpoint_path and os.path.exists(
                self.checkpoint_path):
            with open(self.checkpoint_path, "rb") as f:
                state = pickle.load(f)
        if state is None:
            return None
        if int(state["n_features_in"]) != self.n_features_in_:
            return None  # other data: start afresh
        fp = state.get("data_fingerprint")
        if fp is not None and fp != getattr(self, "_data_fp_", None):
            return None  # same width, other data: start afresh
        return state

    # -- device-resident fast scorers ---------------------------------------

    def _make_fast_scorer(self, base, X, y):
        """``scorer(active) -> scores[len(active)]`` that rescores one
        device copy of X each round (the base estimator's
        ``_column_scorer``), or None when the base estimator is not one of
        the port's Relief selectors or cannot gather columns.

        The reference's kernels take a ``feat_idx`` subset that TuRF never
        passes (``MultiSURF.py:16`` vs ``TuRF.py:110``); here the active
        columns are gathered on the device.
        """
        from ._relief_base import BaseReliefSelector

        if not isinstance(base, BaseReliefSelector):
            return None
        return base._column_scorer(X, y)

    # -- state ----------------------------------------------------------------

    def save_state(self) -> dict:
        """Snapshot of the fitted elimination state (picklable): the schema
        of the ``checkpoint_path`` snapshots, plus ``complete=True``."""
        check_is_fitted(self)
        state = self._state_dict(self._active_, self._final_scores_,
                                 getattr(self, "_iteration_", 0))
        state["complete"] = True
        return state

    def load_state(self, state: dict):
        """Restore a snapshot.

        A finished fit's snapshot (``complete=True``, from
        :meth:`save_state`) restores the fitted attributes.  A mid-run
        snapshot (a ``checkpoint_path`` file's contents) makes the NEXT
        :meth:`fit` resume the loop from its iteration.
        """
        if not state.get("complete", False):
            self._resume_state_ = dict(state)
            return self
        self._active_ = np.asarray(state["active"])
        self._final_scores_ = np.asarray(state["scores"])
        self.feature_importances_ = np.asarray(state["feature_importances"])
        self.n_features_in_ = int(state["n_features_in"])
        self._iteration_ = int(state.get("iteration", 0))
        order = np.argsort(self._final_scores_)[::-1]
        self.top_features_ = np.sort(self._active_[order])
        return self

    def transform(self, X):
        """Reduce X to the selected features."""
        check_is_fitted(self)
        X = validate_data(self, X, reset=False,
                          dtype=[np.float64, np.float32])
        return X[:, self.top_features_]

    def fit_transform(self, X, y):
        """Fit to data, then transform it."""
        self.fit(X, y)
        return self.transform(X)

