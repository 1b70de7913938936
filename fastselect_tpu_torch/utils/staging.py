"""Pinned, pipelined staging of host arrays onto a device.

The card's form of the JAX package's deferred-pull analysis sweep
(``fastselect_tpu/utils/preprocessing.py:analyze_features_device``, which
pulls chunk k's statistics only once chunk k + 1 is on its way).  A host
array goes to the device a chunk at a time through two pinned host
buffers, allocated once a process and reused:

    host      cast 0 | cast 1 | cast 2 | ...
    copy             | copy 0 | copy 1 | copy 2 | ...      (side stream)
    compute                   | use 0  | use 1  | use 2 | ...

The host casts chunk k + 1 into one buffer while chunk k's
``non_blocking`` copy reads the other on a side ``torch.cuda.Stream``; the
compute stream waits on chunk k's copy event before it reads the chunk,
and a buffer is written again only once its last copy's event has
completed.  Nothing else waits on the device: what the consumer computes
from a chunk stays there.  On a CPU device the same loop runs with plain
copies.  On a CUDA device there is no other route: a buffer that cannot be
pinned, or a stream that cannot be made, raises.

With the package's logger at INFO each step is a span
(:mod:`..utils.logging`): the host casts ``staging.cast`` by the host
clock, the copies ``staging.h2d`` by CUDA events on the side stream,
read where the records are logged, so nothing synchronises inside the
loop; the counters ``h2d_chunks``, ``h2d_bytes`` and ``pinned_allocs``
count the chunks, their bytes and the pinned buffers allocated.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from .logging import count, span

# Bytes of one chunk (and so of each pinned buffer, which grows only for a
# wider chunk).  On an H100 the staged analysis slows with more, narrower
# chunks at large n (150,000 x 100: 0.106 s at 32 MB, 0.067 s from 64 MB,
# as the one-shot copy), and 64 MB stages int8 codes within 5 ms a GB of
# the quickest width (tools/staging_ab.py, chip_smoke.py phase 25;
# PERF.md).
_CHUNK_BYTES = 64 << 20


def _host_tensor(a: np.ndarray) -> torch.Tensor:
    """A tensor sharing ``a``'s memory (read only here), or a contiguous
    copy where torch cannot view it (negative strides)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # read-only arrays
        try:
            return torch.from_numpy(a)
        except ValueError:
            return torch.from_numpy(np.ascontiguousarray(a))


def cast_into(dst: torch.Tensor, src: np.ndarray) -> None:
    """Write host array ``src`` into host tensor ``dst`` of the staging
    dtype, rounding once from ``src``'s values as the JAX package's staged
    chunks do: float16 through numpy (torch rounds float64 -> float32 ->
    float16, twice); bfloat16 through torch, which goes through float32
    as ``ml_dtypes`` does; anything else through torch's threaded copy."""
    if dst.dtype == torch.float16:
        np.copyto(dst.numpy(), src, casting="unsafe")
    else:
        dst.copy_(_host_tensor(src))


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def column_chunk(n: int, dtype: torch.dtype, max_elems: int) -> int:
    """Columns of an (n, p) array in one chunk: ``_CHUNK_BYTES`` of
    ``dtype``, at most ``max_elems`` values, at least one column."""
    return max(1, min(_CHUNK_BYTES // max(n * _itemsize(dtype), 1),
                      max_elems // max(n, 1)))


def row_chunks(x: np.ndarray, dtype: torch.dtype):
    """Chunks of rows of host array ``x``, about ``_CHUNK_BYTES`` staged
    as ``dtype`` each (contiguous in a C-order array)."""
    step = max(1, _CHUNK_BYTES // max(x[:1].size * _itemsize(dtype), 1))
    return (x[r0:r0 + step] for r0 in range(0, x.shape[0], step))


class Stager:
    """Two reusable host buffers (pinned for a CUDA device) and a side
    stream for copies to one device; see the module's docstring."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.buffers = [None, None]     # flat uint8 host tensors
        self.stream = torch.cuda.Stream(device) if self.cuda else None
        self.copied = ([torch.cuda.Event(), torch.cuda.Event()]
                       if self.cuda else None)
        self.busy = False

    def _buffer(self, slot: int, nbytes: int) -> torch.Tensor:
        """Host buffer ``slot`` once its last copy has read it, at least
        ``nbytes`` long."""
        if self.cuda:
            self.copied[slot].synchronize()
        buf = self.buffers[slot]
        if buf is None or buf.numel() < nbytes:
            self.buffers[slot] = None   # free the old one first
            if self.cuda:
                count("pinned_allocs")
            buf = self.buffers[slot] = torch.empty(
                nbytes, dtype=torch.uint8, pin_memory=self.cuda)
        return buf

    def stage(self, chunks, dtype: torch.dtype):
        """Each host array of ``chunks`` (any strides) as a tensor of
        ``dtype`` on the device, in order, ready on the current stream:
        the host casts the next chunk while this one is copied.  A chunk is
        the consumer's to keep; its device memory is released only once
        the current stream's work on it is done."""
        if self.busy:
            raise RuntimeError("a staging loop is already running on "
                               f"{self.device}")
        self.busy = True
        size = _itemsize(dtype)
        try:
            for k, src in enumerate(chunks):
                slot = k % 2
                nbytes = src.size * size
                host = self._buffer(slot, nbytes)[:nbytes].view(dtype).view(
                    src.shape)
                count("h2d_chunks")
                count("h2d_bytes", nbytes)
                with span("staging.cast"):
                    cast_into(host, src)
                if not self.cuda:
                    with span("staging.h2d"):
                        chunk = host.clone()
                    yield chunk
                    continue
                compute = torch.cuda.current_stream(self.device)
                with torch.cuda.stream(self.stream):
                    chunk = torch.empty(src.shape, dtype=dtype,
                                        device=self.device)
                    with span("staging.h2d", device=self.device):
                        chunk.copy_(host, non_blocking=True)
                    self.copied[slot].record(self.stream)
                compute.wait_event(self.copied[slot])
                # allocated on the side stream, read on the compute stream
                chunk.record_stream(compute)
                yield chunk
        finally:
            self.busy = False


_stagers: dict = {}


def stager(device) -> Stager:
    """The process's :class:`Stager` for ``device`` (made at first use)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device not in _stagers:
        _stagers[device] = Stager(device)
    return _stagers[device]


def upload(x: np.ndarray, device, dtype: torch.dtype) -> torch.Tensor:
    """Host array ``x`` as a new tensor of ``dtype`` on ``device``, staged
    a chunk of rows at a time through :func:`stager`."""
    device = torch.device(device)
    out = torch.empty(x.shape, dtype=dtype, device=device)
    r0 = 0
    for chunk in stager(device).stage(row_chunks(x, dtype), dtype):
        out[r0:r0 + chunk.shape[0]] = chunk
        r0 += chunk.shape[0]
    return out


def to_device(x: np.ndarray, device, dtype: torch.dtype | None = None
              ) -> torch.Tensor:
    """Host array ``x`` as a tensor of ``dtype`` (default: ``x``'s own) on
    ``device``: through :func:`upload` on a CUDA device; on the CPU
    ``x``'s own memory where the dtype is ``x``'s, else one cast copy."""
    device = torch.device(device)
    if dtype is None:
        dtype = torch.from_numpy(np.empty(0, x.dtype)).dtype
    if device.type == "cuda":
        return upload(x, device, dtype)
    return _host_tensor(x).to(device=device, dtype=dtype)
