"""Per-feature preprocessing shared by the Relief-family estimators.

Counterpart of ``fastselect_tpu/utils/preprocessing.py``, with the
reference's numerics (``MultiSURF.py:141-144,409-420``):

* a feature with at most ``discrete_limit`` unique values is discrete
  (Hamming distance), otherwise continuous (range-scaled L1);
* the reciprocal of each feature's range scales the L1 distance, with
  zero-range features pinned to range 1.0.

Everything runs on whatever device X is on.  A fit uploads X once and
analyses that copy.  The same sort gives each value's state code (its rank
among the column's unique values): the discrete engine scores all-discrete
X from the int8 codes alone, and the hybrid engine reads the discrete
columns of mixed X from them.  :class:`FeatureAnalysis` keeps X as
``x_dev`` whenever a column is continuous, so the engine scores the same
tensor.  A host array goes to a CUDA device through
:func:`analyze_features_staged`: staged a chunk of columns at a time
(``utils/staging.py``), at float32 or half width, and analysed chunk by
chunk on the device as it arrives.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .logging import phase, span
from .staging import column_chunk, stager

# Sort at most this many elements at a time: a column sort holds the
# sorted values and their int64 indices, about 3x the chunk's bytes.
_SORT_CHUNK_ELEMS = 1 << 26
# int8 state codes hold ranks 0..126, so at most this many states.
MAX_STATES = 127


def _column_stats(xc: torch.Tensor, with_codes: bool = False):
    """(unique count, range, codes or None) of each column of ``xc`` from
    one sort.  ``codes[i, f]`` is the rank of ``xc[i, f]`` among column
    f's unique values (int8; ranks wrap above ``MAX_STATES``)."""
    xs, order = torch.sort(xc, dim=0)
    newv = xs[1:] != xs[:-1]
    n_unique = 1 + newv.sum(dim=0)
    codes = None
    if with_codes:
        rank = torch.zeros(xs.shape, dtype=torch.int8, device=xs.device)
        rank[1:] = torch.cumsum(newv, dim=0, dtype=torch.int32)
        codes = torch.empty_like(rank).scatter_(0, order, rank)
    return n_unique, xs[-1] - xs[0], codes


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
    x_dev: torch.Tensor | None = None  # (n, p) float32 X, unless all-discrete
    codes: torch.Tensor | None = None  # (n, p) int8 state codes, X with a
    #                                    discrete column of <= MAX_STATES
    #                                    (a host int8 array where a fit
    #                                    leaves GWAS-scale codes there)
    n_states: int = 0                 # largest cardinality of a discrete column


def encode_columns(x: torch.Tensor, f_chunk: int | None = None):
    """(codes (n, p) int8, unique counts (p,), ranges (p,)) of float32 X,
    on X's device, one sort per chunk of ``f_chunk`` columns."""
    n, p = x.shape
    if f_chunk is None:
        f_chunk = max(1, _SORT_CHUNK_ELEMS // max(n, 1))
    codes = torch.empty((n, p), dtype=torch.int8, device=x.device)
    n_unique = torch.empty(p, dtype=torch.int64, device=x.device)
    ranges = torch.empty(p, dtype=torch.float32, device=x.device)
    for f0 in range(0, p, f_chunk):
        sl = slice(f0, f0 + f_chunk)
        n_unique[sl], ranges[sl], codes[:, sl] = _column_stats(
            x[:, sl], with_codes=True)
    return codes, n_unique, ranges


def analyze_features(x: torch.Tensor, discrete_limit: int) -> FeatureAnalysis:
    """Discreteness and reciprocal ranges of every column of ``x``.

    One ``torch.sort`` per column chunk gives the cardinality, the range
    and the state codes.  The analysis runs in float32, the engine's
    compute type.  X with a discrete column, and at most ``MAX_STATES``
    states in each, comes back with ``codes`` for every column (as
    ``fastselect_tpu``'s ``encode_discrete`` would give them; only the
    discrete columns' codes are meaningful).  X with a continuous column
    is kept as ``x_dev``: all-discrete X is scored from its codes alone,
    mixed X from both.  ``n_states`` is the largest cardinality over the
    discrete columns (1 when there is none).
    """
    x = x.to(torch.float32)
    return _analysis(x, *encode_columns(x), discrete_limit)


def _analysis(x, codes, n_unique, ranges, discrete_limit) -> FeatureAnalysis:
    """:func:`analyze_features`'s result from float32 X and every column's
    codes, unique count and range."""
    is_disc = n_unique <= discrete_limit
    n_states = int(n_unique[is_disc].max()) if bool(is_disc.any()) else 1
    if not bool(is_disc.any()) or n_states > MAX_STATES:
        codes = None
    x_dev = None if codes is not None and bool(is_disc.all()) else x
    return FeatureAnalysis(is_disc, _recip(ranges), x_dev, codes, n_states)


_TRANSFER_DTYPES = {None: torch.float32, "float32": torch.float32,
                    "float16": torch.float16, "bfloat16": torch.bfloat16}


def resolve_transfer_dtype(transfer_dtype: str | None) -> torch.dtype:
    """The dtype of the host-to-device staging copy (default: exact
    float32); JAX's ``_resolve_transfer_dtype`` with torch's dtypes."""
    if isinstance(transfer_dtype, (str, type(None))) \
            and transfer_dtype in _TRANSFER_DTYPES:
        return _TRANSFER_DTYPES[transfer_dtype]
    raise ValueError(
        "transfer_dtype must be None, 'float32', 'float16', or "
        f"'bfloat16', got {transfer_dtype!r}")


def analyze_features_staged(x: np.ndarray, discrete_limit: int, *,
                            transfer_dtype: str | None, device,
                            f_chunk: int | None = None) -> FeatureAnalysis:
    """:func:`analyze_features` of host array ``x`` staged onto ``device``
    at ``transfer_dtype``: the counterpart of the JAX package's
    ``analyze_features_device``.

    ``x`` goes to the device ``f_chunk`` columns at a time through the
    process's stager (pinned buffers and a copy stream on a CUDA device,
    ``utils/staging.py``), each chunk cast on the host from ``x``'s own
    values once, as JAX casts its staged chunks.  On the device each chunk
    is upcast to float32 and written into one (n, p) float32 tensor, and
    its columns' unique counts, ranges and state codes come from one sort
    of it, while the host casts the next chunk.  Half-width staging
    (``'float16'``, ``'bfloat16'``) halves the bytes copied; X, the
    ranges, the discreteness and the codes are then those of the rounded
    values.  The result equals JAX's: ``is_discrete``, ``recip``,
    ``n_states``, the discrete columns' codes and, where JAX keeps it,
    ``x_dev``, bit for bit.  As :func:`analyze_features`, ``x_dev`` is
    kept unless every column is discrete with state codes.
    """
    dtype = resolve_transfer_dtype(transfer_dtype)
    device = torch.device(device)
    n, p = x.shape
    if f_chunk is None:   # sized by the float32 chunk the device works on
        f_chunk = column_chunk(n, torch.float32, _SORT_CHUNK_ELEMS)
    starts = range(0, p, f_chunk)
    x_dev = torch.empty((n, p), dtype=torch.float32, device=device)
    codes = torch.empty((n, p), dtype=torch.int8, device=device)
    n_unique = torch.empty(p, dtype=torch.int64, device=device)
    ranges = torch.empty(p, dtype=torch.float32, device=device)
    with phase("staging.analyze", work=n * p):
        chunks = stager(device).stage(
            (x[:, f0:f0 + f_chunk] for f0 in starts), dtype)
        for f0, xc in zip(starts, chunks):
            with span("staging.analysis", device=device):
                xc = xc.to(torch.float32)
                sl = slice(f0, f0 + xc.shape[1])
                x_dev[:, sl] = xc
                n_unique[sl], ranges[sl], codes[:, sl] = _column_stats(
                    xc, with_codes=True)
        return _analysis(x_dev, codes, n_unique, ranges, discrete_limit)
