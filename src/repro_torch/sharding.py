"""Logical-axis sharding rules (port of ``repro/sharding.py``): model code
names the axes of its parameters and caches (``models.model.param_axes``,
``models.kvcache.cache_logical_axes``), and a rule set maps each logical
axis to mesh axes.

The port keeps the reference's rules and its spec algorithm line for line,
on a ``Mesh`` of named axes that holds shapes only unless given devices,
so the launch surface (``launch/specs.py``, ``launch/dryrun.py``) reckons
every leaf's per-device block on any machine.  A spec is a tuple with one
entry per leading dim: None (replicated), a mesh axis name, or a tuple of
names (one dim over their product); trailing dims it does not name are
replicated, as in a ``PartitionSpec``.

Partitioned execution runs the same model code on every rank, each rank
on its own thread under a ``RankContext`` (``rank_context``), which holds
the group of each set of mesh axes (``collectives.MeshGroup``; a
``collectives.Group`` over ``model`` alone for the TP prefill):
``shard_params`` gives each rank its block of every parameter, cut by
``sharding_for``'s spec, as the reference's train cell lays out its
``in_shardings``: a mesh axis that does not divide a dim is skipped before
it is marked used, so it stays free for a later dim (granite's 40
experts at 16 ranks leave ``model`` to the expert hidden dim).
``constrain`` is the reference's
``with_sharding_constraint``: the identity with no rank context, and
under one it makes a tensor hold the layout its logical axes name -- a
partial sum is all-reduced, or reduce-scattered where the target splits
a dim it holds whole, a dim held split that the target keeps whole is
all-gathered, a dim held whole that the target splits is cut to the
rank's block.  Only the ``model`` axis moves activations: the rank's
other dims (the batch over ``data``, or over ``data`` and ``model`` under
``dp_only``) are already its own.  Under Megatron-SP rules
(``tp_dp_rules(seq_parallel=True)``) the residual stream's sequence
(``seq_res``) is on ``model``: each sublayer's output comes back to the
rank's block of the rows (``to_residual``) and each pre-norm's output is
gathered whole (``seq_whole``), where the sequence divides; elsewhere
``rules.spec`` keeps it whole and the step is plain TP.  Under
``serve_rules(seq_shard=True)`` (``long_500k``) the attention caches'
``kv_seq`` is on the data axes: a rank's cache holds its block of the
rows (``local_shape``, ``kv_seq_block``), and the decode merges the
ranks' partial softmaxes over those axes (``models/attention.py``).
Under grad the collectives are the differentiable ones of
``collectives``; ``to_split`` is Megatron's ``f``
at the input of a split product, ``fsdp_call`` gathers a layer's FSDP
leaves over the data axes for its call, and ``gather_params`` puts the
ranks' blocks back together.
"""
from __future__ import annotations

import contextlib
import copy
import math
import threading
from dataclasses import dataclass
from typing import Any, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch import collectives

_state = threading.local()


class Mesh:
    """Named mesh axes and their sizes (``shape``, a dict in axis order, as
    ``jax.sharding.Mesh.shape``), and optionally the devices, one per mesh
    position in row-major order.  A device may repeat: its positions then
    alias one device, as ``launch/mesh.disagg_groups`` aliases one card."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 devices=None):
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {tuple(shape)} and axes "
                             f"{tuple(axis_names)} differ in length")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(n) for n in shape)))
        if devices is not None:
            devices = list(devices)
            if len(devices) != self.size:
                raise ValueError(f"{len(devices)} devices for a mesh of "
                                 f"{self.size}")
        self.devices = devices

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __repr__(self):
        dims = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        return f"Mesh({dims})"


@dataclass(frozen=True)
class Sharding:
    """A leaf's layout: ``spec`` over ``mesh``, and where it lives
    (``memory_kind``: None for the device, or "pinned_host")."""
    mesh: Mesh
    spec: tuple
    memory_kind: Optional[str] = None

    def with_memory_kind(self, kind: str) -> "Sharding":
        return Sharding(self.mesh, self.spec, kind)

    def shard_shape(self, shape: Sequence[int]) -> tuple:
        return shard_shape(shape, self.spec, self.mesh)


def is_axes_leaf(x) -> bool:
    """A logical-axes annotation: tuple of axis names / None."""
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def map_axes(fn, tree, path: str = ""):
    """A tree of dicts, lists and tuples with each axes leaf replaced by
    ``fn(path, axes)``, ``path`` its keys joined by "/"."""
    if is_axes_leaf(tree):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: map_axes(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_axes(fn, v, f"{path}/{i}" if path else str(i))
                          for i, v in enumerate(tree))
    raise TypeError(f"not an axes tree: {tree!r}")


def _axes_of(entry) -> tuple:
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


class AxisRules:
    """Maps logical axis names -> mesh axis name(s) or None (replicated)."""

    def __init__(self, mesh: Mesh, rules: Mapping[str, object]):
        self.mesh = mesh
        self.rules = dict(rules)

    def spec(self, logical: Sequence[Optional[str]],
             shape: Optional[Sequence[int]] = None) -> tuple:
        """The spec for logical axes. With a concrete shape, entries whose
        mesh-axis product doesn't divide the dim are dropped *before*
        marking the mesh axis used — so e.g. a 16-way model axis skipped on
        a 40-expert dim remains available for the per-expert hidden dim."""
        out = []
        used = set()
        for i, ax in enumerate(logical):
            m = self.rules.get(ax) if ax is not None else None
            if m is None:
                out.append(None)
                continue
            # a list rule holds fallback candidates (tried in order); a
            # tuple is a single joint-axes mapping
            candidates = m if isinstance(m, list) else [m]
            chosen = None
            for cand in candidates:
                key = tuple(cand) if isinstance(cand, tuple) else (cand,)
                if any(k in used for k in key):
                    continue
                if shape is not None:
                    size = 1
                    for a in key:
                        size *= self.mesh.shape[a]
                    if shape[i] % size != 0:
                        continue
                chosen = cand
                used.update(key)
                break
            out.append(chosen)
        return tuple(out)

    def sharding(self, logical: Sequence[Optional[str]]) -> Sharding:
        return Sharding(self.mesh, self.spec(logical))


@contextlib.contextmanager
def axis_rules(rules: Optional[AxisRules]):
    prev = getattr(_state, "rules", None)
    _state.rules = rules
    try:
        yield
    finally:
        _state.rules = prev


def current_rules() -> Optional[AxisRules]:
    return getattr(_state, "rules", None)


def sharding_for(shape: Tuple[int, ...], logical: Sequence[Optional[str]],
                 rules: AxisRules) -> Sharding:
    """The sharding for a concrete shape: logical axes mapped through the
    rules, dropping any entry whose mesh-axis product doesn't divide the
    dim (e.g. 40 experts on a 16-way model axis, kv_heads=5)."""
    return Sharding(rules.mesh, rules.spec(logical, shape))


def shard_shape(shape: Sequence[int], spec: tuple, mesh: Mesh) -> tuple:
    """Each device's block of a leaf of ``shape`` laid out by ``spec``:
    every sharded dim divided by its mesh-axis product, which must divide
    it (``NamedSharding.shard_shape`` raises there too)."""
    out = list(shape)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        size = 1
        for a in _axes_of(entry):
            size *= mesh.shape[a]
        if out[i] % size:
            raise ValueError(f"dim {i} of {tuple(shape)} does not divide "
                             f"over {entry} ({size})")
        out[i] //= size
    return tuple(out)


# Default logical->mesh rule sets ---------------------------------------------

def tp_dp_rules(mesh: Mesh, fsdp: bool = False, seq_parallel: bool = False,
                dp_only: bool = False) -> AxisRules:
    """Megatron TP over 'model', DP over ('pod','data') (pod axis optional).

    fsdp=True additionally shards the big param dim over the data axes
    (ZeRO-3 style).
    seq_parallel=True shards the residual-stream sequence dim over 'model'
    (Megatron-SP).
    dp_only=True folds the model axis into data parallelism (small models:
    no TP collectives at all, grads all-reduce only).
    """
    data_axes = tuple(a for a in ("pod", "data") if a in mesh.shape)
    data = data_axes if len(data_axes) > 1 else \
        (data_axes[0] if data_axes else None)
    if dp_only:
        full = data_axes + (("model",) if "model" in mesh.shape else ())
        # fallback chain: widest DP product that divides the batch
        cands = [full[i:] for i in range(len(full))] + \
                [full[:j] for j in range(len(full) - 1, 0, -1)]
        r = {k: None for k in ("seq", "seq_res", "embed", "heads",
                               "kv_heads", "head_dim", "mlp", "vocab",
                               "experts", "expert_mlp", "kv_latent", "fsdp",
                               "kv_seq", "ssm_heads", "ssm_state", "layers",
                               "capacity")}
        r["batch"] = cands
        return AxisRules(mesh, r)
    rules = {
        "batch": data,
        "seq": None,
        # residual-stream sequence dim: sharded over 'model' it is
        # Megatron-SP
        "seq_res": "model" if seq_parallel else None,
        # FSDP: the d_model dim of *weights* shards over the data axes
        "embed": data if fsdp else None,
        "heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "mlp": "model",
        "vocab": "model",
        "experts": "model",
        "expert_mlp": "model",   # when the expert dim can't shard
        "kv_latent": "model",    # MLA compressed cache
        "fsdp": data if fsdp else None,
        # decode-time sequence parallelism (KV cache length); enabled by
        # the serve rules below, replicated under training rules
        "kv_seq": None,
        "ssm_heads": "model",
        "ssm_state": None,
        "layers": None,
        "capacity": None,
    }
    return AxisRules(mesh, rules)


def serve_rules(mesh: Mesh, seq_shard: bool = False) -> AxisRules:
    """Inference rules: optionally shard the KV cache over the data axes
    (long context)."""
    r = tp_dp_rules(mesh)
    if seq_shard:
        data_axes = tuple(a for a in ("pod", "data") if a in mesh.shape)
        r.rules["kv_seq"] = data_axes if len(data_axes) > 1 else data_axes[0]
        r.rules["batch"] = None
    return r


# Partitioned execution -------------------------------------------------------

@dataclass
class RankContext:
    """One rank of a partitioned program: its ``group`` over the ``model``
    axis (``collectives.Group``, or ``ShapeGroup`` on meta), its ``rank``
    in it (``coords["model"]``), the ``rules`` and its ``coords`` on every
    mesh axis.  ``mesh`` (``collectives.MeshGroup`` or ``ShapeMesh``)
    gives the group of any other set of mesh axes; ``batch_axes`` are the
    mesh axes the rank's batch is one block of; ``specs`` maps ``id`` of
    each of the rank's parameters to its spec (``shard_params``)."""
    group: Any
    rank: int
    rules: AxisRules
    coords: Mapping[str, int]
    mesh: Any = None
    batch_axes: tuple = ()
    specs: Optional[Mapping[int, tuple]] = None

    @property
    def size(self) -> int:
        return self.rules.mesh.shape["model"]

    def on(self, axes) -> Optional[tuple]:
        """(group, rank in it) over the mesh axes ``axes``, or None where
        their product is 1 (no collective)."""
        mesh = self.rules.mesh
        axes = tuple(a for a in mesh.axis_names if a in axes)
        if math.prod(mesh.shape[a] for a in axes) == 1:
            return None
        if self.mesh is None:
            if axes != ("model",):
                raise NotImplementedError(
                    f"a collective over {axes}: this rank context holds "
                    f"the model group alone")
            return self.group, self.rank
        return self.mesh.group(axes, self.coords)

    @property
    def batch_shards(self) -> int:
        mesh = self.rules.mesh
        return math.prod(mesh.shape[a] for a in self.batch_axes)


def mesh_rank(groups, rules: AxisRules, coords: Mapping[str, int], *,
              batch_axes: Sequence[str] = (), params=None) -> RankContext:
    """The rank context of mesh position ``coords`` over ``groups`` (a
    ``collectives.MeshGroup`` or ``ShapeMesh``); ``params``: the rank's
    module from ``shard_params``, whose blocks' specs it records."""
    group, rank = groups.group(("model",), coords)
    specs = None
    if params is not None:
        specs = {id(p): params.shard_specs[n]
                 for n, p in params.named_parameters()}
    return RankContext(group, rank, rules, dict(coords), groups,
                       tuple(batch_axes), specs)


@contextlib.contextmanager
def rank_context(ctx: Optional[RankContext]):
    """Run the body as ``ctx``'s rank (thread-local, like ``axis_rules``)."""
    prev = getattr(_state, "rank", None)
    _state.rank = ctx
    try:
        yield
    finally:
        _state.rank = prev


def current_rank() -> Optional[RankContext]:
    return getattr(_state, "rank", None)


def refuse_partitioned(what: str):
    """Raise under a rank context: ``what`` has no partitioned program,
    as the reference's has none (the page pools: the reference runs
    ``_pool_prefill_core`` and ``_pool_decode_core`` on one device only;
    its TP prefill runs the dense prefill, and each decode shard holds
    whole slots)."""
    if current_rank() is not None:
        raise NotImplementedError(
            f"{what} under a rank context: the reference runs it on one "
            f"device only (its tensor-parallel prefill runs the dense "
            f"prefill, and each decode shard holds whole slots), so it "
            f"has no partitioned program")


def _index(entry, coords: Mapping[str, int], mesh: Mesh) -> int:
    """A position's block index along ``entry``'s mesh axes (row-major)."""
    idx = 0
    for a in _axes_of(entry):
        idx = idx * mesh.shape[a] + coords.get(a, 0)
    return idx


def _on_group(spec: tuple) -> list:
    """Per dim: whether ``spec`` splits it over the ``model`` axis alone.
    A dim split over ``model`` with another axis (the batch under
    ``dp_only``) is the rank's own data and moves none."""
    return [e is not None and _axes_of(e) == ("model",) for e in spec]


def batch_split(rules: AxisRules, coords: Mapping[str, int],
                batch: int) -> tuple:
    """(the mesh axes a batch of ``batch`` rows splits over under
    ``rules``, the block of them that mesh position ``coords`` holds): ((),
    0) where the batch stays whole."""
    entry = rules.spec(("batch",), (batch,))[0]
    if entry is None:
        return (), 0
    return _axes_of(entry), _index(entry, coords, rules.mesh)


def rank_block(logical: str) -> int:
    """The rank's block index along the mesh axes the rules map the
    logical axis to (0 with no rank context or where they keep it
    whole)."""
    ctx = current_rank()
    if ctx is None:
        return 0
    entry = ctx.rules.spec((logical,))[0]
    return 0 if entry is None else _index(entry, ctx.coords, ctx.rules.mesh)


def local_shape(shape: Sequence[int], logical: Sequence[Optional[str]]):
    """The rank's block of a tensor the rank makes itself (a cache):
    ``shape``'s dims that the rules split over the ``model`` axis divided by
    its size, and a ``kv_seq`` dim that they split (over the data axes,
    ``serve_rules(seq_shard=True)``) divided by their product; ``shape``
    itself with no rank context.  A ``kv_seq`` dim the rules split but its
    axes do not divide raises: no rank would know its rows."""
    ctx = current_rank()
    if ctx is None:
        return tuple(shape)
    mesh = ctx.rules.mesh
    spec = ctx.rules.spec(logical, shape)
    out = []
    seq = ctx.rules.spec(("kv_seq",))[0]
    for n, ax, e in zip(shape, logical, spec):
        if ax == "kv_seq" and seq is not None:
            axes = _axes_of(seq)
            if e is None:
                raise ValueError(f"{n} cache rows do not divide over "
                                 f"{axes}")
            n //= math.prod(mesh.shape[a] for a in axes)
        elif e is not None and _axes_of(e) == ("model",):
            n //= ctx.size
        out.append(n)
    return tuple(out) + tuple(shape[len(out):])


def kv_seq_block(rows: int) -> Optional[tuple]:
    """Where the current rank's rules split ``kv_seq`` (the long-context
    decode's ``serve_rules(seq_shard=True)``): (the mesh axes of the
    split, the offset in the whole cache of the first row of the rank's
    block of ``rows`` rows).  None with no rank context or where the
    cache is whole."""
    ctx = current_rank()
    if ctx is None:
        return None
    entry = ctx.rules.spec(("kv_seq",))[0]
    mesh = ctx.rules.mesh
    if entry is None or \
            math.prod(mesh.shape[a] for a in _axes_of(entry)) == 1:
        return None
    return _axes_of(entry), _index(entry, ctx.coords, mesh) * rows


def constrain(x, logical: Sequence[Optional[str]], *, partial: bool = False,
              held: Optional[Sequence[Optional[str]]] = None,
              grad: str = "sum"):
    """The reference's ``constrain``: ``x`` itself with no rank context or
    on a model axis of 1.  Under one, ``x`` (this rank's tensor, laid out
    as the logical axes ``held`` name, default ``logical``) is made to hold
    ``logical``'s layout.  A ``partial`` sum (a product whose contracted
    dim the rank holds a block of) is reduce-scattered onto the rank's
    block of the first dim it holds whole that ``logical`` splits
    (Megatron-SP's residual), else all-reduced; then each dim it holds
    split that ``logical`` keeps whole is all-gathered, and each dim it
    holds whole that ``logical`` splits is cut to the rank's block.
    ``grad``: what the gradient of a gathered or cut tensor is on each
    rank.  "sum": a partial sum, so a gather's backward is a
    reduce-scatter and a cut's pads the other blocks with zeros; "split":
    the whole gradient, as where every rank computes the same tensor, so
    a gather's backward takes the rank's block and a cut's all-gathers
    the blocks (``collectives.split``)."""
    ctx = current_rank()
    if ctx is None or ctx.size == 1:
        return x
    if held is None or tuple(held) == tuple(logical):
        if partial:
            x = collectives.all_reduce(x, ctx.group, ctx.rank)
        return x
    n = ctx.size
    full = [d * n if s else d
            for d, s in zip(x.shape, _on_group(ctx.rules.spec(held)))]
    cur = _on_group(ctx.rules.spec(held, full))
    tgt = _on_group(ctx.rules.spec(logical, full))
    if partial:
        cut = [i for i, (c, t) in enumerate(zip(cur, tgt)) if t and not c]
        if cut:
            x = collectives.reduce_scatter(x, ctx.group, ctx.rank, cut[0])
            cur[cut[0]] = True
        else:
            x = collectives.all_reduce(x, ctx.group, ctx.rank)
    for i, (c, t) in enumerate(zip(cur, tgt)):
        if c and not t:
            x = collectives.all_gather(x, ctx.group, ctx.rank, i, grad=grad)
        elif t and not c:
            if grad == "split":
                x = collectives.split(x, ctx.group, ctx.rank, i)
            else:
                x = x.narrow(i, ctx.rank * (full[i] // n), full[i] // n)
    return x


# the residual stream's layout (the reference's ``seq_res`` sites): its
# sequence on the model axis under Megatron-SP rules, whole otherwise
RESIDUAL = ("batch", "seq_res", "embed")
WHOLE = ("batch", "seq", "embed")


def to_residual(y, *, partial: bool = False):
    """A sublayer's output ``y`` (B, S, d), held whole on the sequence (a
    partial sum over ``model`` where ``partial``), in the residual stream's
    layout: under Megatron-SP rules (``seq_res`` on ``model``, S divisible
    by it) the rank's block of the sequence, reduce-scattered from a
    partial sum, or cut from a ``y`` every rank computed whole (its
    backward an all-gather); otherwise all-reduced where ``partial``."""
    return constrain(y, RESIDUAL, partial=partial, held=WHOLE, grad="split")


def seq_whole(h, rows: int):
    """``h`` (B, S_h, ...), the rank's block of a sequence of ``rows`` rows
    (Megatron-SP's residual stream) where S_h < rows, gathered whole over
    ``model``; its backward takes the rank's block of the gradient, since
    what the whole sequence feeds runs on every rank and passes
    ``to_split`` where it enters the rank's share of a product.  ``h``
    itself where it holds every row."""
    if h.shape[1] == rows:
        return h
    return all_gather_over(h, ("model",), 1, grad="split")


def to_split(x):
    """Megatron's ``f`` where a replicated tensor ``x`` enters the rank's
    block of a product split over ``model`` (or a computation on the
    rank's share of the heads, experts or vocab): ``x`` itself forward,
    its gradient all-reduced over ``model`` backward, since each rank
    holds only its share of it.  The identity with no rank context, with
    no grad or on a model axis of 1."""
    ctx = current_rank()
    if ctx is None or not torch.is_grad_enabled():
        return x
    on = ctx.on(("model",))
    return x if on is None else collectives.conjugate(x, *on)


def all_reduce_over(x, axes, *, op: str = "sum", grad: str = "identity"):
    """``x`` all-reduced over the mesh axes ``axes`` of the current rank
    (``collectives.all_reduce``); ``x`` itself with no rank context or
    where their product is 1."""
    ctx = current_rank()
    on = None if ctx is None else ctx.on(axes)
    return x if on is None else \
        collectives.all_reduce(x, *on, op=op, grad=grad)


def all_gather_over(x, axes, dim: int, *, grad: str = "sum"):
    """``x``'s blocks over the mesh axes ``axes`` of the current rank
    concatenated on ``dim`` (``collectives.all_gather``, its backward by
    ``grad``); ``x`` itself with no rank context or where their product
    is 1."""
    ctx = current_rank()
    on = None if ctx is None else ctx.on(axes)
    return x if on is None else \
        collectives.all_gather(x, *on, dim, grad=grad)


def reduce_scatter_over(x, axes, dim: int):
    """The current rank's block on ``dim`` of ``x`` summed over the mesh
    axes ``axes`` (``collectives.reduce_scatter``: a partial sum cut onto
    the rank's share); ``x`` itself with no rank context or where their
    product is 1."""
    ctx = current_rank()
    on = None if ctx is None else ctx.on(axes)
    return x if on is None else collectives.reduce_scatter(x, *on, dim)


def _leaf_spec(ctx, w) -> Optional[tuple]:
    return None if ctx is None or ctx.specs is None else \
        ctx.specs.get(id(w))


def _fsdp_dims(ctx, spec) -> list:
    """(dim, its mesh axes) for each dim of a leaf laid out by ``spec``
    that FSDP splits: over the data axes alone (``embed``/``fsdp`` under
    ``tp_dp_rules(fsdp=True)``), of more than one position."""
    mesh = ctx.rules.mesh
    return [(i, _axes_of(e)) for i, e in enumerate(spec)
            if e is not None and "model" not in _axes_of(e)
            and math.prod(mesh.shape[a] for a in _axes_of(e)) > 1]


def fsdp_call(module, args: tuple, kwargs: dict, *, recurse: bool = True):
    """``module(*args, **kwargs)``, with FSDP: under a rank context each
    of ``module``'s parameters (its own alone with ``recurse=False``)
    that FSDP splits is all-gathered over the data axes for the call, its
    block on every other axis kept, as FSDP gathers a layer's leaves at
    its entry.  The gather's backward is the reduce-scatter that also
    sums the leaf's gradient over the data group."""
    ctx = current_rank()
    whole = {}
    if ctx is not None and ctx.specs is not None:
        for name, w in module.named_parameters(recurse=recurse):
            for i, axes in _fsdp_dims(ctx, ctx.specs.get(id(w), ())):
                w = collectives.all_gather(w, *ctx.on(axes), i)
                whole[name] = w
    if not whole:
        return module(*args, **kwargs)
    return torch.func.functional_call(module, whole, args, kwargs)


def split_axes(w) -> tuple:
    """The mesh axes of more than one position that the current rank
    holds a block of parameter ``w`` over (() with no rank context, or
    where ``w`` is whole)."""
    ctx = current_rank()
    spec = _leaf_spec(ctx, w)
    if spec is None:
        return ()
    axes = {a for e in spec if e is not None for a in _axes_of(e)}
    mesh = ctx.rules.mesh
    return tuple(a for a in mesh.axis_names
                 if a in axes and mesh.shape[a] > 1)


def fsdp_axes(w) -> tuple:
    """The mesh axes ``fsdp_call`` gathers ``w`` over (() if none)."""
    ctx = current_rank()
    spec = _leaf_spec(ctx, w)
    if spec is None:
        return ()
    return tuple(a for _, axes in _fsdp_dims(ctx, spec) for a in axes)


def block_coords(spec: tuple, coords: Mapping[str, int], mesh: Mesh) -> tuple:
    """Per dim, the block of a leaf laid out by ``spec`` that mesh
    position ``coords`` holds (0 on a whole dim): positions with equal
    block coordinates hold the same block, replicas of each other."""
    return tuple(0 if e is None else _index(e, coords, mesh) for e in spec)


def _block_of(t, spec: tuple, coords: Mapping[str, int], mesh: Mesh):
    """The view of ``t`` that mesh position ``coords`` holds under
    ``spec``."""
    for i, e in enumerate(spec):
        if e is None:
            continue
        n = t.shape[i] // math.prod(mesh.shape[a] for a in _axes_of(e))
        t = t.narrow(i, _index(e, coords, mesh) * n, n)
    return t


def _specs(module, rules: AxisRules) -> dict:
    from repro_torch.models.layers import param_axes
    axes = param_axes(module)
    return {name: sharding_for(tuple(p.shape), axes[name], rules).spec
            for name, p in module.named_parameters()}


def shard_params(module, rules: AxisRules, coords: Mapping[str, int],
                 device=None, *, train: bool = False):
    """A copy of ``module`` whose every parameter is the block the mesh
    position ``coords`` holds under ``rules`` (``sharding_for`` on the
    leaf's shape and logical axes, so a dim the mesh-axis product does not
    divide stays whole and leaves the axis to a later dim), on ``device`` (default: where it is); the module's
    structure, shared blocks included, is kept, and its ``shard_specs``
    name each parameter's spec.  Serving (``train=False``): the blocks
    are frozen views of the module's parameters where they stay on its
    device.  Training: each block is a fresh leaf of its own that
    requires grad."""
    from repro_torch.models.layers import frozen
    specs = _specs(module, rules)
    memo = {}
    for name, p in module.named_parameters():
        blk = _block_of(p.detach(), specs[name], coords, rules.mesh)
        if train:
            blk = blk.to(device or blk.device, copy=True,
                         memory_format=torch.contiguous_format)
            memo[id(p)] = torch.nn.Parameter(blk, requires_grad=True)
            continue
        if device is not None:
            blk = blk.to(device)
        memo[id(p)] = frozen(blk.contiguous())
    out = copy.deepcopy(module, memo)
    out.shard_specs = specs
    return out


def gather_params(blocks: Sequence, positions: Sequence[Mapping[str, int]],
                  rules: AxisRules, like, device=None):
    """One module of the whole parameters from the ranks' ``blocks``
    (``shard_params``'s modules of the mesh positions ``positions``,
    covering every block): a copy of ``like`` (a module of the whole
    shapes, on any device, meta included) whose every parameter is the
    blocks put in place, frozen, on ``device`` (default: the first
    block's)."""
    from repro_torch.models.layers import frozen
    specs = _specs(like, rules)
    named = [dict(b.named_parameters()) for b in blocks]
    memo = {}
    for name, p in like.named_parameters():
        first = named[0][name]
        out = torch.empty(p.shape, dtype=first.dtype,
                          device=device or first.device)
        for pos, nm in zip(positions, named):
            _block_of(out, specs[name], pos, rules.mesh).copy_(
                nm[name].detach())
        memo[id(p)] = frozen(out)
    return copy.deepcopy(like, memo)
