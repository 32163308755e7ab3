"""In-process collectives for tensor-parallel execution, and the ledger of
what they move.

The reference needs no counterpart: XLA partitions its program and inserts
the collectives, which ``launch/dryrun.py::collective_bytes`` reads back
from the compiled HLO.  The port runs a partitioned program as a single
controller: ``Group.run`` calls one function on every rank, each on a
worker thread of its own (on its own CUDA stream where the rank's device
is a card), and the ranks meet in ``all_reduce`` and ``all_gather`` at a
barrier.  The devices may repeat: ``[cuda:0] * 4`` runs four ranks aliased
on one card, as ``launch/mesh.disagg_groups`` aliases it.

  * ``all_reduce``: every rank gets the sum of every rank's tensor, added
    in rank order on its own device (16-bit tensors in float32, rounded
    once), so the result is the same on every rank and from run to run.
  * ``all_gather``: every rank's tensor concatenated in rank order.
  * Between two cards a rank reads another's tensor with
    ``.to(device, non_blocking=True)`` after waiting on the event its owner
    recorded; ranks aliased on one card each run on their own stream, and
    a reader's stream waits on the owner's event before it reads.
  * A barrier that is not met within ``timeout`` seconds raises, and a
    rank that raises breaks the barrier for the others, so a failed rank
    never hangs the caller.

``ShapeGroup`` is the same interface for one rank on the meta device (the
dry run): it returns each result's shape and records the bytes.

The ledger, ``{"bytes": {type: B}, "counts": {type: n}}`` over the
reference's five collective types, counts each collective once however
many ranks take part: bytes are the per-device result shape, as
``collective_bytes`` counts them, and counts are executions (the
reference's are HLO sites).
"""
from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Sequence

import torch

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


def new_ledger() -> dict:
    return {"bytes": {k: 0.0 for k in COLLECTIVES},
            "counts": {k: 0 for k in COLLECTIVES}}


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

    def all_reduce(self, rank: int, x):
        self._record("all-reduce", x.shape, x.dtype)
        return x

    def all_gather(self, rank: int, x, dim: int):
        shape = list(x.shape)
        shape[dim] *= self.size
        self._record("all-gather", shape, x.dtype)
        return x.new_empty(shape)


class Group(_Base):
    """``len(devices)`` ranks, rank ``r`` on ``devices[r]``."""

    def __init__(self, devices: Sequence, timeout: float = 120.0):
        super().__init__()
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a group needs at least one device")
        self.size = len(self.devices)
        self.timeout = float(timeout)
        self._barrier = threading.Barrier(self.size, timeout=self.timeout)
        self._slots = [None] * self.size
        self._pool = ThreadPoolExecutor(max_workers=self.size,
                                        thread_name_prefix="tp-rank")
        self._streams = [torch.cuda.Stream(d) if d.type == "cuda" else None
                         for d in self.devices]

    def close(self):
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
        self._slots = [None] * self.size
        self._barrier.reset()
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
            self._barrier.abort()              # the others stop waiting
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

    def all_reduce(self, rank: int, x):
        parts = self._exchange(rank, x)
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


def _record_streams(tree):
    """``record_stream`` on the caller's current stream for every CUDA
    tensor of a result tree (dicts, lists, tuples), so the rank stream's
    allocator does not hand its memory out again while the caller's work
    on it is pending."""
    if torch.is_tensor(tree):
        if tree.is_cuda:
            tree.record_stream(torch.cuda.current_stream(tree.device))
    elif isinstance(tree, dict):
        for v in tree.values():
            _record_streams(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _record_streams(v)
