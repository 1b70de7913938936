"""Sample-shard Relief scoring over a mesh of devices, and the mesh.

Counterpart of ``fastselect_tpu/parallel/sharded.py``.  The focal-sample
axis is split into contiguous shards, one a shard of the mesh; every
shard scores its focal rows against all samples, which every device holds,
and the per-feature partial scores are summed.

A mesh (:class:`Mesh`) is an ordered tuple of ``torch.device``s, one a
shard, with the process (rank) that drives each shard.  The model is
JAX's multi-controller one: every process calls a layout with the same
host inputs (the estimators' routes check it: :func:`check_same_inputs`),
runs the shards on its own devices, and the collectives assemble the
result, which every process returns whole.  A mesh of one
process's devices (a list of devices; a device may repeat) needs no
process group, and the collectives are plain tensor code:

  psum        the shards' partials moved to the first device and added in
              mesh order, so a given mesh gives the same bits on every run;
  all_gather  (tiled) a ``torch.cat`` in mesh order;
  ppermute    ``.to(next shard's device, non_blocking=True)``, which does
              nothing between shards on one device.

A mesh across processes (``make_mesh()`` in a group of several, or a list
of (rank, device) pairs) crosses them through ``torch.distributed``:

  psum        float partials gathered (all_gather) and added in mesh order
              on every process: the bits of the one-process mesh on the
              same shards, on every rank (an all_reduce would add in the
              backend's order); integer partials by all_reduce(SUM), exact
              in any order;
  all_gather  every shard's part gathered in rank order, concatenated in
              mesh order;
  ppermute    (:func:`ring_shift`) a local copy when the next shard is
              this process's, else ``batch_isend_irecv``.

Under NCCL the CUDA tensors go to the collective as they are; under gloo,
which has no CUDA transport, every CUDA operand is staged through pinned
host memory.  Every size that a collective or a hand-off carries comes
from values all processes share (n, p, the mesh's length and its devices'
type); free memory sizes only a process's own focal blocks, shared among
the processes whose shards sit on one device (:func:`sharers`).

Operands every shard reads (X, codes, labels) are staged once per distinct
device of a process.  The host issues every shard's work and merges once,
with no host sync between shards, so that shards on different GPUs can
overlap (unmeasured: the port has been run on one GPU).
"""

from __future__ import annotations

import contextlib
import hashlib
import socket
import time

import numpy as np
import torch
import torch.distributed as dist

from ..ops import relief_cuda as rc
from ..ops import relief_discrete as rd
from ..ops.relief import relief_engine_core
from . import distributed

# This process's collectives: calls, payload bytes it handed to them, and
# host seconds in them (staging included; under NCCL, launch time only).
comm = {"calls": 0, "bytes": 0, "seconds": 0.0}


def reset_comm() -> None:
    comm.update(calls=0, bytes=0, seconds=0.0)


class Mesh(tuple):
    """A 1-D mesh: the shards' ``torch.device``s in mesh order, with
    ``ranks`` (the process of each shard in ``group``), ``group`` (the
    process group its collectives cross; None when every shard is this
    process's) and ``places`` (each shard's physical device, across hosts;
    None in one process)."""

    def __new__(cls, devices, ranks=None, group=None, places=None):
        mesh = super().__new__(cls, (torch.device(d) for d in devices))
        if not mesh:
            raise ValueError("a mesh needs at least one device")
        mesh.group = group
        mesh.rank = 0 if group is None else dist.get_rank(group)
        mesh.ranks = (tuple(int(r) for r in ranks) if ranks is not None
                      else (mesh.rank,) * len(mesh))
        mesh.places = None if places is None else tuple(places)
        mesh.mine = [s for s, r in enumerate(mesh.ranks) if r == mesh.rank]
        if group is not None and set(mesh.ranks) != set(
                range(dist.get_world_size(group))):
            raise ValueError("every process of the group needs a shard of "
                             f"the mesh: shards on ranks {mesh.ranks}")
        return mesh


# the group whose meshes are cached (held, so that a new group is never
# taken for it), and its meshes by pairs (None: every process's devices)
_GROUP_MESHES: dict = {"group": None, "meshes": {}}


def _place(device: torch.device) -> str:
    """The physical device behind ``device``, named across hosts."""
    host = socket.gethostname()
    if device.type != "cuda":
        return f"{host}/{device.type}"
    props = torch.cuda.get_device_properties(device)
    return f"{host}/{getattr(props, 'uuid', device.index)}"


def _gather_mesh(pairs=None) -> Mesh:
    """The mesh of (rank, device) pairs in the process group (default:
    every process's local devices, in rank order), gathered once a group
    and pairs: one ``all_gather_object`` tells every process where each
    shard sits.  A new group (after ``destroy_process_group`` and a new
    ``init_process_group``) drops the old group's meshes."""
    group = dist.group.WORLD
    if _GROUP_MESHES["group"] is not group:
        _GROUP_MESHES.update(group=group, meshes={})
    key = None if pairs is None else tuple(pairs)
    if key in _GROUP_MESHES["meshes"]:
        return _GROUP_MESHES["meshes"][key]
    me = dist.get_rank(group)
    own = (distributed.local_devices() if pairs is None
           else [d for r, d in pairs if r == me])
    info = [None] * dist.get_world_size(group)
    dist.all_gather_object(info, [(str(d), _place(d)) for d in own],
                           group=group)
    if pairs is None:
        pairs = [(r, torch.device(d)) for r, devs in enumerate(info)
                 for d, _ in devs]
    seen = [0] * len(info)
    devices, places = [], []
    for r, _ in pairs:
        dev, place = info[r][seen[r]]
        seen[r] += 1
        devices.append(torch.device(dev))
        places.append(place)
    mesh = Mesh(devices, [r for r, _ in pairs], group, places)
    _GROUP_MESHES["meshes"][key] = mesh
    return mesh


def make_mesh(devices=None) -> Mesh:
    """1-D mesh.

    No devices: in a process group of more than one process, every
    process's devices (``distributed.local_devices``: its CUDA devices,
    else its CPU) in rank order, gathered once per group; in one process
    every visible CUDA device (none without one).  A list of devices:
    every shard is this process's, and a device may repeat.  A list of
    ``(rank, device)`` pairs: each shard on that rank of the process group
    (every rank 0 without one).  A :class:`Mesh` is returned as it is."""
    if isinstance(devices, Mesh):
        return devices
    grouped = dist.is_available() and dist.is_initialized()
    if devices is None:
        if distributed.is_multihost():
            return _gather_mesh()
        return Mesh([torch.device("cuda", i)
                     for i in range(torch.cuda.device_count())])
    items = list(devices)
    if items and all(isinstance(d, tuple) for d in items):
        pairs = [(int(r), torch.device(d)) for r, d in items]
        if grouped:
            return _gather_mesh(pairs)
        if any(r != 0 for r, _ in pairs):
            raise ValueError("shards of other processes need a "
                             "process group (distributed.initialize)")
        return Mesh([d for _, d in pairs])
    return Mesh(items)


def home(mesh: Mesh) -> torch.device:
    """The device of this process's first shard: where it stages inputs
    and returns results."""
    return mesh[mesh.mine[0]]


def distinct(mesh: Mesh) -> list:
    """This process's devices of the mesh, each once, in mesh order."""
    return list(dict.fromkeys(mesh[s] for s in mesh.mine))


def replicate(tensor: torch.Tensor, mesh: Mesh) -> dict:
    """``{device: tensor on it}`` for every distinct device of this
    process's shards, copied from the tensor's own device (no copy
    there)."""
    return {d: tensor.to(d, non_blocking=True) for d in distinct(mesh)}


def sharers(mesh: Mesh, device: torch.device) -> int:
    """How many processes have shards on the physical device behind this
    process's ``device`` (1 in one process)."""
    if mesh.places is None:
        return 1
    place = next(mesh.places[s] for s in mesh.mine if mesh[s] == device)
    return len({r for r, pl in zip(mesh.ranks, mesh.places) if pl == place})


# rows of a 2-D input that check_same_inputs reads (1-D inputs: all)
_CHECK_ROWS = 64


def _fingerprint(a) -> tuple:
    """(shape, digest of the values) of an input: every value of a 1-D
    one, ``_CHECK_ROWS`` evenly spaced rows of a 2-D one."""
    shape = tuple(a.shape)
    rows = np.arange(shape[0]) if len(shape) < 2 else np.unique(
        np.linspace(0, shape[0] - 1, min(shape[0], _CHECK_ROWS)).astype(
            np.int64))
    if isinstance(a, torch.Tensor):
        vals = a[torch.as_tensor(rows, device=a.device)].cpu().numpy()
    else:
        vals = np.asarray(a)[rows]
    vals = vals.astype(np.float64 if vals.dtype.kind in "biuf" else str)
    return shape, hashlib.sha1(np.ascontiguousarray(vals).tobytes()
                               ).hexdigest()


def check_same_inputs(mesh: Mesh, *inputs) -> None:
    """Raise ``ValueError`` on every process unless all the processes of
    the mesh's group hold the same inputs (their shapes, and a digest of
    their values: ``_fingerprint``), as the layouts' collectives assume.
    One ``all_gather_object``; nothing in one process."""
    if mesh.group is None:
        return
    mine = [None if a is None else _fingerprint(a) for a in inputs]
    every = [None] * dist.get_world_size(mesh.group)
    dist.all_gather_object(every, mine, group=mesh.group)
    odd = [r for r, got in enumerate(every) if got != every[0]]
    if odd:
        raise ValueError(
            "every process must call the fit with the same inputs: ranks "
            f"{odd} hold other data than rank 0 (shapes and digests "
            f"{every[odd[0]]} against {every[0]})")


@contextlib.contextmanager
def _timed(nbytes: int):
    t0 = time.perf_counter()
    yield
    comm["calls"] += 1
    comm["bytes"] += int(nbytes)
    comm["seconds"] += time.perf_counter() - t0


def _staged(group, t: torch.Tensor) -> bool:
    """Whether ``t`` goes through host memory in ``group``: a CUDA tensor
    under any backend but NCCL."""
    return t.is_cuda and dist.get_backend(group) != "nccl"


def _wire(group, t: torch.Tensor) -> torch.Tensor:
    """``t`` as the group's backend takes it: a pinned host copy of a CUDA
    tensor under gloo, else ``t``."""
    if not _staged(group, t):
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def _recv_buffer(group, like: torch.Tensor) -> torch.Tensor:
    if _staged(group, like):
        return torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
    return torch.empty_like(like)


def _gather_ranks(t: torch.Tensor, group) -> list:
    """Every rank's ``t`` (one shape on all ranks), in rank order, on
    ``t``'s device."""
    src = _wire(group, t.contiguous())
    out = [_recv_buffer(group, t) for _ in range(dist.get_world_size(group))]
    with _timed(src.numel() * src.element_size()):
        dist.all_gather(out, src, group=group)
    return [o.to(t.device, non_blocking=True) for o in out]


def _every_part(parts, mesh) -> list:
    """Every shard's part (one shape on all shards), in mesh order, from
    this process's parts (its shards', in mesh order)."""
    per_rank = max(mesh.ranks.count(r) for r in set(mesh.ranks))
    pad = [torch.zeros_like(parts[0])] * (per_rank - len(parts))
    got = _gather_ranks(torch.stack(list(parts) + pad), mesh.group)
    seen: dict = {}
    out = []
    for r in mesh.ranks:
        out.append(got[r][seen.get(r, 0)])
        seen[r] = seen.get(r, 0) + 1
    return out


def psum(parts, mesh) -> torch.Tensor:
    """Sum over the mesh of the shards' partials, given this process's
    (its shards', in mesh order), on its first device.

    Float partials add in mesh order, on every process (gathered first
    across processes); integer ones add exactly, by all_reduce across
    processes."""
    dev = home(mesh)
    group = mesh.group
    if group is not None and parts[0].is_floating_point():
        parts = _every_part([p.to(dev, non_blocking=True) for p in parts],
                            mesh)
    total = parts[0].to(dev, non_blocking=True)
    for part in parts[1:]:
        total = total + part.to(dev, non_blocking=True)
    if group is None or total.is_floating_point():
        return total
    buf = _wire(group, total)
    if buf is parts[0]:
        buf = buf.clone()
    with _timed(buf.numel() * buf.element_size()):
        dist.all_reduce(buf, group=group)
    return buf.to(dev, non_blocking=True)


def merge_disjoint(part: torch.Tensor, mesh) -> torch.Tensor:
    """The whole of a tensor whose entries the processes wrote apart,
    each holding zeros where the others wrote, given this process's:
    across processes its bits add as integers (all_reduce), exact for any
    dtype, since a value's bits plus zero bits are its bits."""
    if mesh.group is None:
        return part
    bits = {1: torch.int8, 2: torch.int16, 4: torch.int32,
            8: torch.int64}[part.element_size()]
    return psum([part.view(bits)], mesh).view(part.dtype)


def all_gather(parts, mesh, dim: int = 0) -> torch.Tensor:
    """Every shard's part concatenated along ``dim`` in mesh order, on
    this process's first device, given this process's parts (its
    shards', in mesh order; their lengths along ``dim`` may differ)."""
    dev = home(mesh)
    parts = [p.to(dev, non_blocking=True) for p in parts]
    if mesh.group is None:
        return torch.cat(parts, dim)
    lengths = [p.shape[dim] for p in parts]
    every_len = _every_part([torch.tensor(n, device=dev)
                             for n in lengths], mesh)
    every_len = [int(n) for n in torch.stack(every_len).cpu()]
    top = max(every_len)
    padded = [torch.nn.functional.pad(
        p.movedim(dim, -1), (0, top - p.shape[dim])).movedim(-1, dim)
        for p in parts]
    every = _every_part(padded, mesh)
    return torch.cat([p.narrow(dim, 0, n)
                      for p, n in zip(every, every_len)], dim)


def ppermute(tensor: torch.Tensor, device: torch.device) -> torch.Tensor:
    """One ring step within a process: the tensor on the next shard's
    device."""
    return tensor.to(device, non_blocking=True)


def ring_shift(held: dict, mesh) -> dict:
    """One ring step over the mesh: ``{shard: block}`` of this process's
    shards becomes ``{shard: the block of the shard before it}``.  A block
    from this process's own shard is copied (:func:`ppermute`); the others
    are sent and received in one ``batch_isend_irecv``, every block of
    one shape, each process issuing its sends and receives in the order of
    the sending shard (and tagged with it), so that a pair of processes
    matches them alike under NCCL and gloo."""
    n = len(mesh)
    group = mesh.group
    if group is None:
        return {s: ppermute(held[(s - 1) % n], mesh[s]) for s in held}
    me = mesh.rank
    world = group is dist.group.WORLD

    def peer(r):
        return r if world else dist.get_global_rank(group, r)

    ops, recvs, out, nbytes = [], [], {}, 0
    for s in sorted(held):
        nxt = (s + 1) % n
        if mesh.ranks[nxt] != me:
            src = _wire(group, held[s].contiguous())
            nbytes += src.numel() * src.element_size()
            ops.append(dist.P2POp(dist.isend, src, peer(mesh.ranks[nxt]),
                                  group, tag=s))
    for s in sorted(held, key=lambda s: (s - 1) % n):
        prv = (s - 1) % n
        if mesh.ranks[prv] == me:
            out[s] = ppermute(held[prv], mesh[s])
        else:
            buf = _recv_buffer(group, held[s])
            ops.append(dist.P2POp(dist.irecv, buf, peer(mesh.ranks[prv]),
                                  group, tag=prv))
            recvs.append((s, buf))
    if ops:
        with _timed(nbytes):
            for req in dist.batch_isend_irecv(ops):
                req.wait()
    for s, buf in recvs:
        out[s] = buf.to(mesh[s], non_blocking=True)
    return {s: out[s] for s in sorted(out)}


def plan_device(mesh) -> torch.device:
    """The device whose type sizes a layout's tiles (``_gemm_size``): the
    first CUDA device of the mesh, else its first; the same on every
    process, since it reads only the mesh."""
    return next((d for d in mesh if d.type == "cuda"), mesh[0])


def _round_up(v: int, m: int) -> int:
    return ((v + m - 1) // m) * m


def sharded_relief_scores(
    x,
    y,
    recip,
    is_discrete,
    *,
    algo: str = "multisurf",
    use_star: bool = False,
    n_neighbors: int = 0,
    class_probs: np.ndarray | None = None,
    devices=None,
) -> np.ndarray:
    """Relief-family scores of any data, the focal rows sharded over the
    mesh, divided by n.

    The fused engine's operands (``relief_cuda.stage_fused``) are staged
    on this process's first device and copied to each other distinct
    device of its shards; the samples pad to ``TILE_ROWS`` rows a shard,
    so each shard holds a whole number of the kernels' 16-byte rows.
    Each shard runs ``relief_engine_core`` over its contiguous focal rows,
    in blocks sized from its device's free memory (shared among the
    processes on that device): the hand-written kernels on a CUDA device,
    their plain versions on the CPU (the ``MIXED`` kernels when a column
    is discrete).
    """
    mesh = make_mesh(devices)
    ndev = len(mesh)
    if not isinstance(x, torch.Tensor):
        x = torch.tensor(np.asarray(x), dtype=torch.float32)
    n, p = x.shape
    disc = np.asarray(torch.as_tensor(is_discrete).cpu(), bool)
    p_pad = rc.padded_features(p, int(disc.sum()))
    n_pad = _round_up(n, rc.TILE_ROWS * ndev)
    nf = n_pad // ndev
    first = rc.stage_fused(x, y, recip, disc, class_probs, home(mesh),
                           n_pad, p_pad)
    staged = {d: first.to(d) for d in distinct(mesh)}
    nb = {d: rc.focal_block_rows(n_pad, d, algo, n_focal=nf,
                                 sharers=sharers(mesh, d))
          for d in staged}
    parts = []
    for s in mesh.mine:
        d = mesh[s]
        fl = staged[d]
        rows = slice(s * nf, (s + 1) * nf)
        parts.append(relief_engine_core(
            fl.xp[rows], fl.yv[rows], fl.valid[rows], s * nf, fl.xp, fl.yv,
            fl.valid, fl.recip, fl.disc, fl.n_real, fl.class_probs,
            algo=algo, use_star=use_star, k=int(n_neighbors), nb=nb[d],
            n_disc=fl.n_disc))
    scores = psum(parts, mesh)
    return (scores.index_select(0, first.pos) / first.n_real).cpu().numpy()


def sharded_multisurf_scores(x, y, recip, is_discrete, *, devices=None,
                             use_star: bool = False) -> np.ndarray:
    """Sample-shard MultiSURF scores."""
    return sharded_relief_scores(x, y, recip, is_discrete, algo="multisurf",
                                 use_star=use_star, devices=devices)


def _discrete_inputs(codes, n_states, class_probs, mesh):
    """(int8 codes on this process's first device, n_states, class_probs)
    of a discrete layout."""
    codes, n_states = rd.int8_codes(codes, n_states, home(mesh))
    if class_probs is None:
        class_probs = np.zeros((1,), np.float32)
    return codes, n_states, np.asarray(class_probs, np.float32)


def _scalars(n, class_probs, device):
    """n_real and class_probs as the weight rules take them."""
    return (torch.tensor(float(n), dtype=torch.float32, device=device),
            torch.as_tensor(class_probs, device=device))


def _sharded_discrete_v2(codes, y, layout, n, p, n_states, class_probs,
                         mesh, *, algo, use_star, k, ti, ft):
    """Class-sorted v2 over the mesh: (p_pad,) float64 unnormalised scores.

    The focal blocks of the sorted layout keep their per-class plans
    (``relief_discrete._plan_segments``), so every shard runs the
    segment-restricted pass 2.  The blocks of each plan group are dealt to
    the shards round-robin; block order does not matter, since partials
    add.  (JAX pads the deal with weight-0 blocks to keep one traced
    program for every device; a loop needs none.)"""
    classes, perm, segments, block_class, n_pad = layout
    p_pad = rd._round_up(p, ft)
    cpad, yv, valid = rd._apply_layout(codes, y[:n], perm, n_pad, p_pad)
    cls_t = tuple(int(c) for c in classes)
    plan_of = {pos: rd._plan_segments(algo, use_star, cls_t, pos)
               for pos in set(block_class)}
    groups: dict = {}
    for b, pos in enumerate(block_class):
        key = tuple((spec, tuple(segs)) for spec, segs in plan_of[pos])
        groups.setdefault(key, []).append(b)
    dealt = [[] for _ in mesh]
    for blocks in groups.values():
        for i, b in enumerate(blocks):
            dealt[i % len(mesh)].append(b)
    segs_all = list(segments) + [(0, n_pad)]
    ops = {d: (c, yv.to(d, non_blocking=True), valid.to(d, non_blocking=True),
               *_scalars(n, class_probs, d))
           for d, c in replicate(cpad, mesh).items()}
    parts = []
    for s in mesh.mine:
        d = mesh[s]
        c, yd, vd, n_real, cp = ops[d]
        total = torch.zeros(p_pad, dtype=torch.float64, device=d)
        for b in dealt[s]:
            rows = slice(b * ti, (b + 1) * ti)
            total += rd._block_scores_v2(
                c[rows], yd[rows], vd[rows],
                torch.arange(b * ti, (b + 1) * ti, device=d), c, yd, vd,
                n_real, cp, algo=algo, use_star=use_star, k=k, ft=ft,
                n_states=n_states, plan=plan_of[block_class[b]],
                segs_all=segs_all)
        parts.append(total)
    return psum(parts, mesh)


def sharded_relief_discrete_scores(
    codes,
    y,
    *,
    algo: str = "multisurf",
    use_star: bool = False,
    n_neighbors: int = 0,
    n_states: int | None = None,
    class_probs: np.ndarray | None = None,
    devices=None,
) -> np.ndarray:
    """All-discrete Relief scores, the focal rows sharded over the mesh,
    divided by n.

    Codes (array or tensor) are staged once a distinct device.  When the
    class-sorted v2 layout applies (``relief_discrete._v2_layout``) its
    blocks are dealt to the shards (:func:`_sharded_discrete_v2`);
    otherwise each shard runs ``relief_discrete_core`` over its contiguous
    focal rows.  Both are int8 GEMMs on every device.
    """
    mesh = make_mesh(devices)
    ndev = len(mesh)
    codes, n_states, cp = _discrete_inputs(codes, n_states, class_probs,
                                           mesh)
    n, p = codes.shape
    y = np.asarray(y)
    ti0, _ = rd._discrete_tile_sizes(n, p, n_states)
    # a focal block divides each shard's rows
    ti = min(ti0, max(8, rd._round_up(n // ndev or 1, 8)))
    layout, ti, ft = rd._tiles_and_layout(n, p, n_states, y, algo,
                                          class_probs, plan_device(mesh), ti)
    if layout is not None:
        scores = _sharded_discrete_v2(
            codes, y, layout, n, p, n_states, cp, mesh, algo=algo,
            use_star=use_star, k=int(n_neighbors), ti=ti, ft=ft)
    else:
        cpad, yv, valid, _ = rd.pack_discrete(codes, y, n_states, ti=ti,
                                              ft=ft)
        n_pad = _round_up(cpad.shape[0], ti * ndev)
        if n_pad > cpad.shape[0]:
            extra = n_pad - cpad.shape[0]
            cpad = torch.nn.functional.pad(cpad, (0, 0, 0, extra))
            yv = torch.nn.functional.pad(yv, (0, extra), value=-1)
            valid = torch.nn.functional.pad(valid, (0, extra))
        nf = n_pad // ndev
        ops = {d: (c, yv.to(d, non_blocking=True),
                   valid.to(d, non_blocking=True), *_scalars(n, cp, d))
               for d, c in replicate(cpad, mesh).items()}
        parts = []
        for s in mesh.mine:
            c, yd, vd, n_real, cpd = ops[mesh[s]]
            rows = slice(s * nf, (s + 1) * nf)
            parts.append(rd.relief_discrete_core(
                c[rows], yd[rows], vd[rows], s * nf, c, yd, vd, n_real, cpd,
                algo=algo, use_star=use_star, k=int(n_neighbors), ti=ti,
                ft=ft, n_states=n_states))
        scores = psum(parts, mesh)
    return (scores[:p].to(torch.float32) / float(n)).cpu().numpy()
