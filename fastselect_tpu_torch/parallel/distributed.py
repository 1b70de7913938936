"""Multi-process initialisation and this process's devices.

Counterpart of ``fastselect_tpu/parallel/distributed.py``.  The upstream
reference is one process; a mesh that spans processes needs one handshake
of the collective runtime first.  :func:`initialize` wraps
``torch.distributed.init_process_group`` (NCCL on CUDA, gloo on the CPU)
with JAX's behaviour: nothing at all in a single process without cluster
settings, and a clear ``RuntimeError`` when a peer cannot be reached.

After it, every layout of ``fastselect_tpu_torch.parallel`` spans the
processes, as JAX's do after ``jax.distributed.initialize``:
``make_mesh()`` gathers every process's devices (:func:`local_devices`)
in rank order, the psum, all_gather and ppermute of each layout cross
processes through ``torch.distributed``, and the estimators' automatic
routes (``ops/relief.py:_mesh_devices``) take that mesh.  Every process
calls the same fit with the same X and y (the routes check it, and
raise on every process otherwise) and gets the whole result::

    # torchrun --nproc-per-node 8 fit.py
    from fastselect_tpu_torch import MultiSURF
    from fastselect_tpu_torch.parallel import distributed
    distributed.initialize()          # no-op in one process
    est = MultiSURF(n_features_to_select=10).fit(X, y)   # on every rank

Fits are short and keep no state between calls, so recovery is a re-run;
TuRF resumes from its per-round checkpoints (``models/turf.py``).
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               timeout_s: int = 120) -> None:
    """Join the process group (no-op in one process).

    The arguments default to the usual launcher settings: ``MASTER_ADDR``
    and ``MASTER_PORT`` for the coordinator's ``host:port``,
    ``WORLD_SIZE`` and ``RANK``.  Without a world of more than one process
    nothing happens.
    """
    if is_multihost():
        return  # already initialised
    env = os.environ
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", "1"))
    if num_processes <= 1:
        return
    if process_id is None:
        process_id = int(env.get("RANK", "0"))
    if coordinator_address is None:
        coordinator_address = (f"{env.get('MASTER_ADDR', 'localhost')}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    try:
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id,
            timeout=datetime.timedelta(seconds=timeout_s))
        if backend == "nccl":
            torch.cuda.set_device(local_devices()[0])
    except (RuntimeError, ValueError, OSError) as e:
        raise RuntimeError(
            "Multi-process initialisation failed: a peer is unreachable or "
            f"the coordinator address {coordinator_address!r} is wrong. "
            "Check that every process can reach the coordinator and restart "
            "the fit (fits keep no state; TuRF runs resume from their "
            "checkpoints).") from e


def is_multihost() -> bool:
    """Whether this process belongs to a group of more than one."""
    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)


def local_devices() -> list:
    """This process's devices in a mesh that spans processes: its CUDA
    devices, else its CPU.  Under a launcher that starts several processes
    a host (``LOCAL_RANK`` of ``LOCAL_WORLD_SIZE``, as ``torchrun`` sets
    them) with at least as many cards, process ``LOCAL_RANK`` takes every
    ``LOCAL_WORLD_SIZE``-th card from card ``LOCAL_RANK`` (one card each
    under ``--nproc-per-node`` = the cards); with fewer cards, every card
    (several processes then share one)."""
    count = torch.cuda.device_count()
    if count == 0:
        return [torch.device("cpu")]
    env = os.environ
    local_world = int(env.get("LOCAL_WORLD_SIZE", "1"))
    local_rank = int(env.get("LOCAL_RANK", "0"))
    if 1 < local_world <= count:
        return [torch.device("cuda", i)
                for i in range(local_rank, count, local_world)]
    return [torch.device("cuda", i) for i in range(count)]
