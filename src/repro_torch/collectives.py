"""In-process collectives for partitioned execution, and the ledger of
what they move.

The reference needs no counterpart: XLA partitions its program and inserts
the collectives, which ``launch/dryrun.py::collective_bytes`` reads back
from the compiled HLO.  The port runs a partitioned program as a single
controller: ``Group.run`` calls one function on every rank, each on a
worker thread of its own (on its own CUDA stream where the rank's device
is a card), and the ranks meet in the collectives at a barrier.  The
devices may repeat: ``[cuda:0] * 4`` runs four ranks aliased on one card,
as ``launch/mesh.disagg_groups`` aliases it.

  * ``all_reduce``: every rank gets the sum (or the max) of every rank's
    tensor, added in rank order on its own device (16-bit tensors in
    float32, rounded once), so the result is the same on every rank and
    from run to run.
  * ``all_gather``: every rank's tensor concatenated in rank order.
  * ``reduce_scatter``: the rank's block of the rank-order sum.
  * Between two cards a rank reads another's tensor with
    ``.to(device, non_blocking=True)`` after waiting on the event its owner
    recorded; ranks aliased on one card each run on their own stream, and
    a reader's stream waits on the owner's event before it reads.
  * A barrier that is not met within ``timeout`` seconds raises, and a
    rank that raises breaks the barrier for the others, so a failed rank
    never hangs the caller.

``MeshGroup`` runs one rank thread per position of a ``sharding.Mesh``
and gives each collective the group of one set of mesh axes: a rank
meets only the ranks that share its coordinates on the other axes (the
``model`` group for tensor parallelism, the ``data`` group, with ``pod``
where the mesh has one, for data parallelism and FSDP).  Each axis group
has its own barrier and slots; a failed rank breaks every one of them.

``ShapeGroup`` is the same interface for one rank on the meta device (the
dry run): it returns each result's shape and records the bytes;
``ShapeMesh`` gives one per set of mesh axes.

The functions ``all_reduce``, ``conjugate``, ``all_gather`` and
``reduce_scatter`` take a ``(group, rank)`` and are differentiable
(``torch.autograd.Function``s), with Megatron's pairs: an all-reduce of
partial sums has the identity as its backward on a model group (the
gradient is replicated there), and an all-reduce as its backward where
every rank's copy of its result feeds a loss that the ranks average (the
data group); ``conjugate`` (Megatron's ``f``) is the identity forward and
an all-reduce backward; an all-gather's backward is a reduce-scatter (the
gradient reaching it is a partial sum on each rank), and a
reduce-scatter's an all-gather.  Their backwards run the collectives of
the group the forward ran on, so each rank's backward runs on its own
thread (``torch.autograd.set_multithreading_enabled(False)``).

The ledger, ``{"bytes": {type: B}, "counts": {type: n}}`` over the
reference's five collective types, counts each collective once however
many ranks take part: bytes are the per-device result shape, as
``collective_bytes`` counts them, backward collectives included, and
counts are executions (the reference's are HLO sites).  A mesh's ledger
sums the ledgers of the axis groups that hold mesh position (0, ..., 0).
"""
from __future__ import annotations

import itertools
import math
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Sequence

import torch

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


def new_ledger() -> dict:
    return {"bytes": {k: 0.0 for k in COLLECTIVES},
            "counts": {k: 0 for k in COLLECTIVES}}


def merge_ledgers(ledgers) -> dict:
    """The sum of ``ledgers``, type by type."""
    out = new_ledger()
    for led in ledgers:
        for part in ("bytes", "counts"):
            for k, v in led[part].items():
                out[part][k] += v
    return out


def _nbytes(shape, dtype) -> float:
    n = 1
    for d in shape:
        n *= int(d)
    return float(n * torch.empty((), dtype=dtype).element_size())


class CollectiveError(RuntimeError):
    """A rank failed, or a barrier was not met in time."""


class _Base:
    size: int

    def __init__(self):
        self.ledger = new_ledger()

    def _record(self, kind: str, shape, dtype):
        self.ledger["bytes"][kind] += _nbytes(shape, dtype)
        self.ledger["counts"][kind] += 1


class ShapeGroup(_Base):
    """The collectives of one rank of a ``size``-rank group on meta
    tensors: each returns a tensor of its result's shape and records the
    bytes, and no other rank exists."""

    def __init__(self, size: int):
        super().__init__()
        self.size = int(size)

    def all_reduce(self, rank: int, x, op: str = "sum"):
        self._record("all-reduce", x.shape, x.dtype)
        return x

    def all_gather(self, rank: int, x, dim: int):
        shape = list(x.shape)
        shape[dim] *= self.size
        self._record("all-gather", shape, x.dtype)
        return x.new_empty(shape)

    def reduce_scatter(self, rank: int, x, dim: int):
        shape = list(x.shape)
        shape[dim] //= self.size
        self._record("reduce-scatter", shape, x.dtype)
        return x.new_empty(shape)


class ShapeMesh:
    """The collectives of mesh position (0, ..., 0) on meta tensors: one
    ``ShapeGroup`` per set of mesh axes (``group``), whose ledgers sum to
    ``ledger``."""

    def __init__(self, mesh):
        self.mesh = mesh
        self._groups = {}

    def group(self, axes, coords) -> tuple:
        axes = tuple(a for a in self.mesh.axis_names if a in axes)
        if axes not in self._groups:
            self._groups[axes] = ShapeGroup(
                math.prod(self.mesh.shape[a] for a in axes))
        return self._groups[axes], 0

    @property
    def ledger(self) -> dict:
        return merge_ledgers(g.ledger for g in self._groups.values())


class Group(_Base):
    """``len(devices)`` ranks, rank ``r`` on ``devices[r]``.  With
    ``threads=False`` the group runs nothing itself: it is the collectives
    of a subset of another group's ranks (``MeshGroup``), which resets its
    barrier after every run and breaks it when a rank fails."""

    def __init__(self, devices: Sequence, timeout: float = 120.0, *,
                 threads: bool = True):
        super().__init__()
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a group needs at least one device")
        self.size = len(self.devices)
        self.timeout = float(timeout)
        self._barrier = threading.Barrier(self.size, timeout=self.timeout)
        self._slots = [None] * self.size
        # the groups whose barriers a failed rank breaks and a run resets
        self._members = [self]
        self._pool = self._streams = None
        if threads:
            self._pool = ThreadPoolExecutor(max_workers=self.size,
                                            thread_name_prefix="tp-rank")
            self._streams = [torch.cuda.Stream(d) if d.type == "cuda"
                             else None for d in self.devices]

    def close(self):
        if self._pool is not None:
            self._pool.shutdown(wait=False)

    # ---------------------------------------------------------------- run --
    def run(self, fn: Callable[[int], object]) -> list:
        """``fn(rank)`` on every rank at once; their results in rank order.
        Raises the first rank's error when any rank fails (``fn``'s own
        error first, a broken barrier's after it)."""
        starts = []
        for d in self.devices:
            ev = None
            if d.type == "cuda":
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(d))
            starts.append(ev)
        futs = [self._pool.submit(self._rank_main, fn, r, starts[r])
                for r in range(self.size)]
        outs, errors = [], []
        for f in futs:
            try:
                outs.append(f.result())
            except BaseException as e:      # noqa: BLE001 - re-raised
                outs.append(None)
                errors.append(e)
        for g in self._members:
            g._slots = [None] * g.size
            g._barrier.reset()
        if errors:
            first = next((e for e in errors
                          if not isinstance(e, threading.BrokenBarrierError)),
                         errors[0])
            if isinstance(first, threading.BrokenBarrierError):
                raise CollectiveError(
                    f"a collective's barrier was not met within "
                    f"{self.timeout} s") from first
            raise first
        # the caller's streams wait for the ranks' work, and the
        # results' memory is not reused before the caller is done
        for r, (out, end) in enumerate(outs):
            if end is not None:
                torch.cuda.current_stream(self.devices[r]).wait_event(end)
                _record_streams(out)
        return [out for out, _ in outs]

    def _rank_main(self, fn, rank: int, start):
        dev, stream = self.devices[rank], self._streams[rank]
        try:
            if stream is None:
                return fn(rank), None
            with torch.cuda.device(dev), torch.cuda.stream(stream):
                stream.wait_event(start)
                out = fn(rank)
                end = torch.cuda.Event()
                end.record(stream)
            return out, end
        except BaseException:
            for g in self._members:            # the others stop waiting
                g._barrier.abort()
            raise

    # -------------------------------------------------------- collectives --
    def _exchange(self, rank: int, x) -> list:
        """Every rank's tensor, readable on this rank's device and stream,
        in rank order.  The caller must call ``_done`` once it has
        enqueued its reads."""
        ev = None
        if x.is_cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(x.device))
        self._slots[rank] = (x, ev)
        self._barrier.wait()
        here = self.devices[rank]
        out = []
        for i, (xi, ei) in enumerate(self._slots):
            if i != rank and ei is not None:
                # the stream that reads xi: this rank's own where xi is on
                # its card, else the current stream of xi's card, on which
                # ``Tensor.to`` copies across
                src = torch.cuda.current_stream(xi.device)
                src.wait_event(ei)
                xi.record_stream(src)
            out.append(xi.to(here, non_blocking=True))
        return out

    def _done(self):
        self._barrier.wait()                   # slots are read: reusable

    def all_reduce(self, rank: int, x, op: str = "sum"):
        parts = self._exchange(rank, x)
        if op == "max":
            acc = parts[0].clone()
            for p in parts[1:]:
                acc = torch.maximum(acc, p)
            wide = False
        else:
            wide = x.dtype in (torch.bfloat16, torch.float16)
            acc = parts[0].float() if wide else parts[0].clone()
            for p in parts[1:]:
                acc = acc + (p.float() if wide else p)
        self._done()
        if rank == 0:
            self._record("all-reduce", x.shape, x.dtype)
        return acc.to(x.dtype) if wide else acc

    def all_gather(self, rank: int, x, dim: int):
        out = torch.cat(self._exchange(rank, x), dim=dim)
        self._done()
        if rank == 0:
            self._record("all-gather", out.shape, out.dtype)
        return out

    def reduce_scatter(self, rank: int, x, dim: int):
        """The rank's block (of ``x.shape[dim] / size`` along ``dim``) of
        every rank's tensor summed in rank order."""
        parts = self._exchange(rank, x)
        n = x.shape[dim] // self.size
        wide = x.dtype in (torch.bfloat16, torch.float16)
        acc = None
        for p in parts:
            blk = p.narrow(dim, rank * n, n)
            blk = blk.float() if wide else blk
            acc = blk.clone() if acc is None else acc + blk
        self._done()
        if rank == 0:
            self._record("reduce-scatter", acc.shape, x.dtype)
        return acc.to(x.dtype) if wide else acc


# seconds a mesh rank waits at a barrier: a training step's rank may wait
# there for another's whole forward or backward at full width
MESH_TIMEOUT = 300.0


class MeshGroup:
    """One rank thread per position of ``mesh`` (a ``sharding.Mesh`` with
    devices, positions in row-major order), and a ``Group`` for every set
    of mesh axes and every line of positions along them: ``group(axes,
    coords)`` is the group of the ranks that share ``coords`` off
    ``axes``, and the rank's index in it (row-major over ``axes``)."""

    def __init__(self, mesh):
        if mesh.devices is None:
            raise ValueError(f"{mesh} holds shapes only, no devices")
        self.mesh = mesh
        names = mesh.axis_names
        self.positions = [dict(zip(names, idx)) for idx in itertools.product(
            *(range(mesh.shape[a]) for a in names))]
        self.runner = Group(mesh.devices, MESH_TIMEOUT)
        self._lines = {}
        for k in range(1, len(names) + 1):
            for axes in itertools.combinations(names, k):
                members = {}
                for i, pos in enumerate(self.positions):
                    key = tuple(pos[a] for a in names if a not in axes)
                    members.setdefault(key, []).append(i)
                for key, idx in members.items():
                    g = Group([mesh.devices[i] for i in idx], MESH_TIMEOUT,
                              threads=False)
                    self.runner._members.append(g)
                    self._lines[axes, key] = g

    def group(self, axes, coords) -> tuple:
        names = self.mesh.axis_names
        axes = tuple(a for a in names if a in axes)
        key = tuple(coords[a] for a in names if a not in axes)
        rank = 0
        for a in axes:
            rank = rank * self.mesh.shape[a] + coords[a]
        return self._lines[axes, key], rank

    def run(self, fn: Callable[[int], object]) -> list:
        """``fn(i)`` for every mesh position i at once, each on its own
        thread (and its own stream on a card); results in position order.
        Raises as ``Group.run`` does."""
        return self.runner.run(fn)

    @property
    def ledger(self) -> dict:
        zero = {a: 0 for a in self.mesh.axis_names}
        return merge_ledgers(self.group(axes, zero)[0].ledger
                             for axes, key in self._lines
                             if not any(key))

    def close(self):
        self.runner.close()


# --------------------------------------------- differentiable collectives --

class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, rank, grad_sum):
        ctx.group, ctx.rank, ctx.grad_sum = group, rank, grad_sum
        return group.all_reduce(rank, x)

    @staticmethod
    def backward(ctx, g):
        if ctx.grad_sum:
            g = ctx.group.all_reduce(ctx.rank, g.contiguous())
        return g, None, None, None


class _Conjugate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, rank):
        ctx.group, ctx.rank = group, rank
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce(ctx.rank, g.contiguous()), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, rank, dim):
        ctx.group, ctx.rank, ctx.dim = group, rank, dim
        return group.all_gather(rank, x.contiguous(), dim)

    @staticmethod
    def backward(ctx, g):
        return (ctx.group.reduce_scatter(ctx.rank, g.contiguous(), ctx.dim),
                None, None, None)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, rank, dim):
        ctx.group, ctx.rank, ctx.dim = group, rank, dim
        return group.reduce_scatter(rank, x.contiguous(), dim)

    @staticmethod
    def backward(ctx, g):
        return (ctx.group.all_gather(ctx.rank, g.contiguous(), ctx.dim),
                None, None, None)


def _graph(x) -> bool:
    """Whether autograd records an op on ``x``: otherwise the functions
    below call the group directly."""
    return torch.is_grad_enabled() and x.requires_grad


def all_reduce(x, group, rank: int, *, op: str = "sum",
               grad: str = "identity"):
    """The all-reduce of ``x`` over ``group``.  A sum's backward is the
    identity (``grad="identity"``: each rank's copy of the result is the
    one value the loss sees, so its gradient is replicated) or an
    all-reduce (``grad="sum"``: every rank's copy feeds a loss the ranks
    average, as the data group's).  A max takes no gradient."""
    if op == "max":
        return group.all_reduce(rank, x.detach(), "max")
    if grad not in ("identity", "sum"):
        raise ValueError(f"grad {grad!r}")
    if not _graph(x):
        return group.all_reduce(rank, x)
    return _AllReduce.apply(x, group, rank, grad == "sum")


def conjugate(x, group, rank: int):
    """Megatron's ``f``: ``x`` forward, its gradient all-reduced backward
    (a replicated activation feeding each rank's block of a split
    product, whose rank holds its share of the gradient only)."""
    return _Conjugate.apply(x, group, rank) if _graph(x) else x


def all_gather(x, group, rank: int, dim: int):
    """Every rank's ``x`` concatenated on ``dim``; backward, the rank's
    block of the gradient summed over the ranks (a reduce-scatter: the
    gradient reaching a gather is a partial sum on each rank)."""
    if not _graph(x):
        return group.all_gather(rank, x, dim)
    return _AllGather.apply(x, group, rank, dim)


def reduce_scatter(x, group, rank: int, dim: int):
    """The rank's block on ``dim`` of every rank's ``x`` summed; backward,
    an all-gather."""
    if not _graph(x):
        return group.reduce_scatter(rank, x, dim)
    return _ReduceScatter.apply(x, group, rank, dim)


def _record_streams(tree):
    """``record_stream`` on the caller's current stream for every CUDA
    tensor of a result tree (dicts, lists, tuples, a module's parameters),
    so the rank stream's
    allocator does not hand its memory out again while the caller's work
    on it is pending."""
    if torch.is_tensor(tree):
        if tree.is_cuda:
            tree.record_stream(torch.cuda.current_stream(tree.device))
    elif isinstance(tree, torch.nn.Module):
        _record_streams(list(tree.parameters()))
    elif isinstance(tree, dict):
        for v in tree.values():
            _record_streams(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _record_streams(v)
