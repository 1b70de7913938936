"""Shared sklearn-API plumbing for the Relief-family estimators.

Counterpart of ``fastselect_tpu/models/_relief_base.py``: subclasses
define ``_algo_name`` and ``_score``.  A fit validates X on the host,
uploads it to the compute device once as float32, analyses its columns
there (NaN and infinity are looked for in that copy), and scores that
same tensor, the state codes the analysis made of it, or both (mixed
data).  On a CUDA device a host X of at least
``_STAGED_MIN_ELEMS`` values is staged a chunk of columns at a time
through pinned buffers and a copy stream, and analysed as it arrives
(``utils/preprocessing.analyze_features_staged``), at the staging dtype
``transfer_dtype`` asks for.  Small non-negative integer X (genotypes)
skips the float copy: it is uploaded once as int8 codes, through the same
stager.  A ``torch.Tensor`` X is checked and scored on its own device,
with no host round trip (the counterpart of the JAX package's
device-array fit).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.relief import relief_engine
from ..ops.relief_discrete import keeps_host_codes
from ..utils.backend import (default_device, resolve_backend,
                             tensor_backend, _VALID_BACKENDS)
from ..utils import sklearn_compat, staging
from ..utils.logging import fit_span, span
from ..utils.preprocessing import (MAX_STATES, FeatureAnalysis,
                                   analyze_features, analyze_features_staged,
                                   resolve_transfer_dtype)
from ..utils.sklearn_compat import (BaseEstimator, TransformerMixin,
                                    check_is_fitted, validate_data)
from ..utils.validation import check_min_samples, resolve_n_features_to_select

def top_features(scores: np.ndarray, k: int) -> np.ndarray:
    """``np.argsort(scores)[::-1][:k]``, from a partition where that
    gives the same indices: k distinct, non-NaN top scores, each above
    every other score.  The order of tied scores is the full sort's own,
    so a tie among them, or at the cut, a NaN, or k >= len(scores) takes
    the full sort.  For 500,000 scores the pick takes about a seventh of
    the sort's host time."""
    p = len(scores)
    if 0 < k < p:
        top = np.argpartition(scores, p - k)[p - k:]
        vals = scores[top]
        order = np.argsort(vals)[::-1]
        vals = vals[order]
        if (not np.isnan(vals[0]) and bool(np.all(vals[:-1] > vals[1:]))
                and np.count_nonzero(scores >= vals[-1]) == k):
            return top[order]
    return np.argsort(scores)[::-1][:k]


# copies of a host X to a fit's device since the last reset: one per fit,
# two where one-byte integer X fails the code range and goes again as float
# or where X staged at half width is scored from a float32 copy
uploads = 0

# Host X of at least this many values goes to a CUDA fit's device through
# the staged analysis (JAX's gate for its device analysis sweep); the
# tests add 'cpu' to the device types to rehearse it.
_STAGED_MIN_ELEMS = 1 << 22
_STAGED_DEVICE_TYPES = ("cuda",)
# JAX's auto half-width staging threshold: float X of at least this many
# values with p >= 4n stages at float16 where the auto rule holds.
_AUTO_F16_MIN_ELEMS = 1 << 24
# Whether that auto rule holds (only CUDA fits stage).  It does not on the
# H100: at 100 x 500,000 numpy's float16 cast cost more host time than
# the halved copy saved (chip_smoke.py phase 25, PERF.md), so None stages
# float32 there.
_AUTO_HALF_WIDTH = False
# Half-width staged X is scored only where JAX's would be: every column
# continuous, n at most JAX's PALLAS_MAX_N and n p float32 bytes within
# its _XDEV_BUDGET_BYTES; elsewhere the engine scores a float32 copy.
_HALF_WIDTH_MAX_N = 131072
_HALF_WIDTH_MAX_BYTES = 4 << 30


def reset_upload_count() -> None:
    global uploads
    uploads = 0


class BaseReliefSelector(TransformerMixin, BaseEstimator):
    """Common fit/transform skeleton; not part of the public API."""

    _algo_name = "Relief"
    _validate_dtype = np.float64

    def _validate_parameters(self, n_samples, n_features):
        if self.backend not in _VALID_BACKENDS:
            raise ValueError(
                "backend must be one of 'auto', 'cuda', 'gpu', or 'cpu'")
        resolve_transfer_dtype(getattr(self, "transfer_dtype", None))
        check_min_samples(n_samples, self._algo_name)
        return resolve_n_features_to_select(
            self.n_features_to_select, n_features)

    def _resolve_backend(self):
        return resolve_backend(self.backend, self._algo_name)

    def _device(self) -> torch.device:
        """A tensor fit's own device, else the effective backend's."""
        dev = getattr(self, "_device_", None)
        return dev if dev is not None else default_device(
            self.effective_backend_)

    def _log_running(self, star_name: str | None = None):
        if getattr(self, "verbose", False):
            name = star_name or self._algo_name
            print(f"Running {name} on the "
                  f"{self.effective_backend_.upper()} now...")

    @fit_span
    def fit(self, X, y):
        """Score all features and select the top ones.

        Parameters
        ----------
        X : array-like or torch.Tensor of shape (n_samples, n_features)
            Training samples. NaN values are rejected.  A tensor is
            scored on its own device (CUDA or CPU) and never copied to
            the host; a ``backend`` other than ``'auto'`` must name that
            device.
        y : array-like of shape (n_samples,)
            Numeric class labels.

        Returns
        -------
        self : object
        """
        with span("fit.validate"):
            if isinstance(X, torch.Tensor):
                X, y = self._check_tensor(X, y)
                self._device_ = X.device
                self.effective_backend_ = tensor_backend(
                    self.backend, X.device, self._algo_name)
            else:
                int_x = (isinstance(X, np.ndarray) and X.ndim == 2
                         and X.size > 0
                         and np.issubdtype(X.dtype, np.integer))
                X, y = validate_data(
                    self, X, y, y_numeric=True,
                    # integer input (genotypes) keeps its integer dtype: a
                    # float cast would copy it only to be encoded back to
                    # int8 (any injective per-column coding gives the same
                    # Hamming match counts, so small non-negative values
                    # ARE valid codes)
                    dtype="numeric" if int_x else self._host_dtype(),
                    ensure_2d=True,
                    # NaN and infinity are looked for where X is analysed,
                    # on the device where X is staged (_analysis)
                    ensure_all_finite=False)
            self.n_features_in_ = X.shape[1]
            n_select = self._validate_parameters(X.shape[0],
                                                 self.n_features_in_)
            if not isinstance(X, torch.Tensor):
                self.effective_backend_ = self._resolve_backend()
                self._device_ = None
        with span("fit.analysis"):
            analysis = self._analysis(X, self._device(), check_finite=True)
        return self._fit_analysis(analysis, y, n_select)

    def _fit_analysis(self, analysis, y, n_select):
        """The rest of ``fit`` once X is analysed on the fit's device."""
        with span("fit.score"):
            if relief_engine(len(y), analysis.is_discrete,
                             analysis.n_states) == "fused":
                analysis.codes = None   # the fused engine reads X alone
            self.is_discrete_ = analysis.is_discrete.cpu().numpy()
            scores = self._score(analysis.x_dev, y, analysis, n_select)
        if scores is None:  # the algorithm's early exit set the attributes
            return self
        with span("fit.select"):
            self.feature_importances_ = scores
            self.top_features_ = top_features(scores, n_select)
        return self

    def _column_scorer(self, X, y):
        """``scorer(active) -> scores`` equal to the
        ``feature_importances_`` of ``fit(X[:, active], y)``, for TuRF's
        rounds; X and y are validated host arrays.  X goes to the fit's
        device, at float32 whatever ``transfer_dtype`` says (as JAX's
        fast scorers stage it), and is analysed there once; each call
        gathers the active columns of that analysis on the device (a
        column's discreteness, range and state codes do not depend on
        the other columns) and scores them as ``fit`` would, engine
        choice included.  None when
        a discrete column has more than ``MAX_STATES`` states: that
        analysis keeps no state codes to gather.
        """
        self.effective_backend_ = self._resolve_backend()
        self._device_ = None
        full = self._analysis(X, self._device(), exact=True)
        if isinstance(full.codes, np.ndarray):
            # kept on the host for the engine to stage: the scorer gathers
            # columns on the device
            full.codes = staging.to_device(full.codes, self._device())
        if full.codes is None and bool(full.is_discrete.any()):
            return None
        n = X.shape[0]

        def scorer(active):
            cols = torch.as_tensor(active, device=full.is_discrete.device)
            disc = full.is_discrete[cols]
            any_disc, all_disc = bool(disc.any()), bool(disc.all())
            codes = full.codes[:, cols] if any_disc else None
            # the largest state count of an active discrete column, as the
            # analysis of X[:, active] finds it (codes are ranks or values)
            n_states = (int((codes if all_disc else codes[:, disc]).max())
                        + 1 if any_disc else 1)
            sub = FeatureAnalysis(
                disc, full.recip[cols],
                None if all_disc else full.x_dev[:, cols], codes, n_states)
            self.n_features_in_ = len(active)
            self._fit_analysis(sub, y, self._validate_parameters(
                n, len(active)))
            return np.asarray(self.feature_importances_)

        return scorer

    @staticmethod
    def _check_tensor(X, y):
        """Shape and NaN checks of a tensor X, on its device (one scalar
        comes back), and y as a host array."""
        if X.dim() != 2:
            raise ValueError(f"Expected 2D array, got {X.dim()}D array "
                             "instead.")
        y = np.asarray(y.cpu() if isinstance(y, torch.Tensor) else y)
        if y.ndim != 1 or y.shape[0] != X.shape[0]:
            raise ValueError("X and y have inconsistent numbers of samples "
                             f"or y is not 1-D: {tuple(X.shape)}, "
                             f"{y.shape}")
        if X.is_floating_point() and not bool(torch.isfinite(X).all()):
            raise ValueError("Input X contains NaN." if bool(X.isnan().any())
                             else "Input X contains infinity.")
        return X, y

    def _score(self, X, y, analysis, n_select):  # pragma: no cover
        raise NotImplementedError

    def _analysis(self, X, dev: torch.device, exact: bool = False,
                  check_finite: bool = False) -> FeatureAnalysis:
        """The analysis a fit on ``dev`` makes of validated X: the integer
        fast path's, else per-feature discreteness, ranges and state codes
        in float32 on ``dev`` (a host X is uploaded here, once).

        A host X of at least ``_STAGED_MIN_ELEMS`` values on a CUDA device
        is staged at :meth:`_staging_dtype` (float32 where ``exact``, and
        ``transfer_dtype_`` is then left alone) and analysed as it
        arrives; smaller X, and every CPU fit, take one copy.  X staged at
        half width is scored where JAX scores it: every column continuous,
        at most ``_HALF_WIDTH_MAX_N`` samples and ``_HALF_WIDTH_MAX_BYTES``
        float32 bytes; elsewhere the engine scores a float32 copy of X and
        only the analysis (discreteness, ranges, codes) is the rounded
        values'.

        ``check_finite`` raises on a NaN or an infinity of host X, as
        validation would have: a staged X is looked at on the device, in
        its float32 copy, and on the host only where that copy holds one
        (finite float64 values can round past float32's range); any other
        host X is looked at on the host before it is copied."""
        global uploads
        analysis = self._int_fast_analysis(X, dev)
        if analysis is not None:
            return analysis
        if isinstance(X, torch.Tensor):
            return analyze_features(X.to(dtype=torch.float32),
                                    self.discrete_limit)
        uploads += 1
        if dev.type not in _STAGED_DEVICE_TYPES or X.size < _STAGED_MIN_ELEMS:
            if check_finite:
                sklearn_compat.check_finite(X)
            return analyze_features(
                torch.tensor(X, dtype=torch.float32, device=dev),
                self.discrete_limit)
        if not np.issubdtype(X.dtype, np.floating):
            X = X.astype(self._validate_dtype)   # as JAX validates it
        td = "float32" if exact else self._staging_dtype(X)
        analysis = analyze_features_staged(
            X, self.discrete_limit, transfer_dtype=td, device=dev)
        n, p = X.shape
        half = resolve_transfer_dtype(td) != torch.float32
        scored = (not bool(analysis.is_discrete.any())
                  and n <= _HALF_WIDTH_MAX_N
                  and n * p * 4 <= _HALF_WIDTH_MAX_BYTES)
        if half and analysis.x_dev is not None and not scored:
            analysis.x_dev = staging.upload(X, dev, torch.float32)
            uploads += 1
        if check_finite and (analysis.x_dev is None or not bool(
                torch.isfinite(analysis.x_dev).all())):
            sklearn_compat.check_finite(X)
        return analysis

    def _host_dtype(self):
        """The dtype host float X is validated to: ``_validate_dtype``,
        or a list that keeps float64 X as it is where ``_validate_dtype``
        is float32 and the fit stages float32.  Every route then casts X to
        float32 once, as it is copied or staged, to the values the
        validation's cast would give, without its copy of X (for 100 x
        500,000 float64 X, 200 MB and about 0.1 s of one host thread a
        fit).  Half-width staging rounds from the validated values, float32
        as JAX validates them, so it keeps the cast."""
        td = getattr(self, "transfer_dtype", None)
        if self._validate_dtype is np.float32 and (
                td == "float32" or (td is None and not _AUTO_HALF_WIDTH)):
            return [np.float32, np.float64]
        return self._validate_dtype

    def _staging_dtype(self, X) -> str | None:
        """Host-to-device staging dtype of a CUDA fit (JAX's rule).

        An explicit ``transfer_dtype`` always wins (pass 'float32' to
        force exact staging).  With the default ``None``, large float
        matrices in the p >> n regime auto-stage at float16 where the
        rule holds (``_AUTO_HALF_WIDTH``): half-width staging halves the
        bytes copied at a ~1e-3 relative cost in score precision
        (integer-valued discrete columns up to 2048 are exact in f16, so
        discreteness detection is unaffected for ordinary coded data);
        elsewhere None resolves to 'float32'.  The policy is recorded in
        the fitted ``transfer_dtype_`` attribute."""
        td = getattr(self, "transfer_dtype", None)
        if td is None and _AUTO_HALF_WIDTH:
            n, p = X.shape
            if (X.size >= _AUTO_F16_MIN_ELEMS and p >= 4 * n
                    and np.issubdtype(X.dtype, np.floating)):
                td = "float16"
                if getattr(self, "verbose", False):
                    print("Auto-selected float16 H2D staging for this "
                          "transfer-bound p >> n fit (~1e-3 relative "
                          "score cost; pass transfer_dtype='float32' "
                          "for exact staging).")
        self.transfer_dtype_ = td or "float32"
        return td

    def _int_fast_analysis(self, X, dev=None) -> FeatureAnalysis | None:
        """Encode-free analysis of integer X (an array or a tensor) with
        values in 0..min(discrete_limit, 127) - 1 (the GWAS genotype
        case), else None.  Every column of such X is discrete by
        construction (cardinality <= max + 1 <= discrete_limit), and the
        raw values serve as state codes: they reach the device once as
        int8 (1 byte a value instead of 4), with n_states = max + 1 and
        recip all ones.  A tensor and one-byte X are range-checked on the
        device; wider host X is checked on the host and cast to int8 as it
        is staged (``utils/staging.py``: pinned and pipelined on a CUDA
        device).  Host X past the discrete engine's sort budget
        (``relief_discrete.keeps_host_codes``) is checked on the host and
        stays there as int8 codes: the engine copies it to the device
        itself, packed where its v2 layout applies.  ``dev`` defaults to
        the fit's device.
        """
        global uploads
        dev = self._device() if dev is None else dev
        if isinstance(X, torch.Tensor):
            if X.is_floating_point() or X.dtype == torch.bool \
                    or X.numel() == 0:
                return None
            codes = X.to(dev)
        elif np.issubdtype(X.dtype, np.integer) and X.size > 0:
            codes = None
            keep = keeps_host_codes(*X.shape, dev)
            if X.dtype.itemsize == 1 and not keep:
                codes = staging.to_device(X, dev)
                uploads += 1
        else:
            return None
        if codes is not None:
            mn, mx = (int(v) for v in torch.aminmax(codes))
        else:
            mn, mx = int(X.min()), int(X.max())
        if mn < 0 or mx + 1 > min(int(self.discrete_limit), MAX_STATES):
            return None
        if codes is None:
            codes = (X.astype(np.int8, copy=False) if keep
                     else staging.to_device(X, dev, torch.int8))
            uploads += 1  # where kept on the host, the engine's one copy
        else:
            codes = codes.to(torch.int8)
        p = X.shape[1]
        return FeatureAnalysis(
            torch.ones(p, dtype=torch.bool, device=dev),
            torch.ones(p, dtype=torch.float32, device=dev),
            codes=codes, n_states=mx + 1)

    def transform(self, X):
        """Reduce X to the selected top features."""
        check_is_fitted(self)
        X = validate_data(self, X, reset=False,
                          dtype=[np.float64, np.float32])
        return X[:, self.top_features_]

    def fit_transform(self, X, y):
        """Fit to data, then transform it."""
        self.fit(X, y)
        return self.transform(X)
