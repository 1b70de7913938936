"""Backend resolution for the PyTorch port.

The upstream reference dispatches ``backend='auto'|'gpu'|'cpu'`` on whether
CUDA is available (reference ``MultiSURF.py:393-406``).  The port does the
same: ``'auto'`` picks ``'cuda'`` when ``torch.cuda.is_available()``, else
``'cpu'``; ``'gpu'`` is an alias of ``'cuda'``, as it was upstream.
Counterpart of ``fastselect_tpu/utils/backend.py``.
"""

from __future__ import annotations

import torch

_VALID_BACKENDS = ("auto", "cuda", "gpu", "cpu")


def resolve_backend(backend: str, estimator_name: str = "estimator") -> str:
    """Map a user-supplied backend string to ``'cuda'`` or ``'cpu'``.

    Raises ValueError for unknown strings and RuntimeError when CUDA is
    forced (``'cuda'`` or ``'gpu'``) on a host without a CUDA device.
    """
    if backend not in _VALID_BACKENDS:
        raise ValueError(
            "backend must be one of 'auto', 'cuda', 'gpu', or 'cpu'")
    if backend == "auto":
        return "cuda" if torch.cuda.is_available() else "cpu"
    if backend in ("cuda", "gpu"):
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{estimator_name} was run with backend={backend!r}, but no "
                "CUDA-enabled GPU is available.")
        return "cuda"
    return "cpu"


def default_device(backend: str) -> torch.device:
    """The torch.device an effective backend computes on."""
    if backend == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")
