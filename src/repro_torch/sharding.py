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

Not here: ``constrain`` (the reference's ``with_sharding_constraint`` on
activations) and any partitioned execution.  An eager program on one card
has no counterpart for them; they wait for tensor-parallel execution
(ROADMAP item 11b).
"""
from __future__ import annotations

import contextlib
import math
import threading
from dataclasses import dataclass
from typing import Mapping, Optional, Sequence, Tuple

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


def _divisible(shape: Tuple[int, ...], spec: tuple, mesh: Mesh) -> tuple:
    """Drop spec entries whose mesh-axis product doesn't divide the dim."""
    out = []
    for dim, entry in zip(shape,
                          tuple(spec) + (None,) * (len(shape) - len(spec))):
        if entry is None:
            out.append(None)
            continue
        size = 1
        for a in _axes_of(entry):
            size *= mesh.shape[a]
        out.append(entry if dim % size == 0 else None)
    return tuple(out)


def sharding_for(shape: Tuple[int, ...], logical: Sequence[Optional[str]],
                 rules: AxisRules) -> Sharding:
    """The sharding for a concrete shape: logical axes mapped through the
    rules, dropping any entry whose mesh-axis product doesn't divide the
    dim (e.g. 40 experts on a 16-way model axis, kv_heads=5)."""
    return Sharding(rules.mesh, rules.spec(logical, shape))


def param_spec(path: Tuple[str, ...], leaf_logical: Sequence[Optional[str]],
               shape: Tuple[int, ...], rules: AxisRules) -> Sharding:
    spec = _divisible(shape, rules.spec(leaf_logical), rules.mesh)
    return Sharding(rules.mesh, spec)


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
