"""Per-feature preprocessing shared by the Relief-family estimators.

Counterpart of ``fastselect_tpu/utils/preprocessing.py``, with the
reference's numerics (``MultiSURF.py:141-144,409-420``):

* a feature with at most ``discrete_limit`` unique values is discrete
  (Hamming distance), otherwise continuous (range-scaled L1);
* the reciprocal of each feature's range scales the L1 distance, with
  zero-range features pinned to range 1.0.

Everything runs on whatever device X is on.  A fit uploads X once and
analyses that copy; :class:`FeatureAnalysis` keeps it as ``x_dev`` so the
engine scores the same tensor.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

# Sort at most this many elements at a time: a column sort holds the
# sorted values and their int64 indices, about 3x the chunk's bytes.
_SORT_CHUNK_ELEMS = 1 << 26


def _column_stats(xc: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(unique count, range) of each column of ``xc`` from one sort."""
    xs = torch.sort(xc, dim=0).values
    n_unique = 1 + (xs[1:] != xs[:-1]).sum(dim=0)
    return n_unique, xs[-1] - xs[0]


def _recip(ranges: torch.Tensor) -> torch.Tensor:
    ranges = torch.where(ranges == 0, torch.ones_like(ranges), ranges)
    return (1.0 / ranges).to(torch.float32)


def detect_discrete_features(x, discrete_limit: int) -> torch.Tensor:
    """Boolean mask of features with <= discrete_limit unique values.

    Equivalent to ``np.unique(x[:, f]).size <= discrete_limit`` per column
    (reference ``MultiSURF.py:416-420``).
    """
    x = torch.as_tensor(x)
    if x.shape[0] == 0:
        return torch.zeros(x.shape[1], dtype=torch.bool, device=x.device)
    return _column_stats(x)[0] <= discrete_limit


def compute_recip_ranges(x, is_discrete=None, *,
                         unit_range_for_discrete: bool = False
                         ) -> torch.Tensor:
    """Reciprocal of per-feature ranges, float32.

    ``unit_range_for_discrete=True`` gives discrete features range 1.0
    before the zero-range guard (ReliefF/SURF, ``ReliefF.py:377-380``);
    MultiSURF applies only the zero-range guard (``MultiSURF.py:409-412``).
    """
    x = torch.as_tensor(x)
    ranges = x.amax(dim=0) - x.amin(dim=0)
    if unit_range_for_discrete and is_discrete is not None:
        disc = torch.as_tensor(is_discrete, device=x.device)
        ranges = torch.where(disc, torch.ones_like(ranges), ranges)
    return _recip(ranges)


@dataclass
class FeatureAnalysis:
    """Per-feature facts the Relief engine needs, all on one device."""
    is_discrete: torch.Tensor         # (p,) bool
    recip: torch.Tensor               # (p,) float32, 1/range with zero guard
    x_dev: torch.Tensor | None = None  # (n, p) float32 X the analysis read


def analyze_features(x: torch.Tensor, discrete_limit: int) -> FeatureAnalysis:
    """Discreteness and reciprocal ranges of every column of ``x``.

    One ``torch.sort`` per column chunk gives both the cardinality and the
    range.  The analysis runs in float32, the engine's compute type, and
    ``x`` is kept as ``x_dev``.
    """
    x = x.to(torch.float32)
    n, p = x.shape
    f_chunk = max(1, _SORT_CHUNK_ELEMS // max(n, 1))
    n_unique = torch.empty(p, dtype=torch.int64, device=x.device)
    ranges = torch.empty(p, dtype=torch.float32, device=x.device)
    for f0 in range(0, p, f_chunk):
        nu, rg = _column_stats(x[:, f0:f0 + f_chunk])
        n_unique[f0:f0 + f_chunk] = nu
        ranges[f0:f0 + f_chunk] = rg
    return FeatureAnalysis(n_unique <= discrete_limit, _recip(ranges), x)
