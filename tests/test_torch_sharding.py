"""The port's sharding surface against the reference's on the CPU: the
logical axes of every parameter (``model.param_axes``) and cache leaf
(``kvcache.cache_logical_axes``) against the reference's ``split_params``
and ``cache_logical_axes`` leaf by leaf, without the stacked ``layers``
axis; ``AxisRules.spec`` and ``sharding_for`` against the
reference's for every rule set on three meshes; the batch specs; and
each device's bytes of a cell's arguments (``specs.argument_bytes``, by
``shard_shape``) against the sum of the reference's
``NamedSharding.shard_shape`` on a 2 x 4 mesh of forced host devices in
a subprocess (nothing is compiled).

The reference's specs read only ``mesh.shape``, so a
``jax.sharding.AbstractMesh`` serves as its mesh in this process."""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import sharding as ref_shd
from repro.configs.base import ShapeConfig as RefShapeConfig
from repro.configs.base import get_config as ref_config
from repro.configs.base import list_archs as ref_list_archs
from repro.launch import specs as ref_specs
from repro.models import kvcache as ref_kvcache
from repro.models import model as ref_model
from repro.models.layers import split_params
from repro_torch import sharding as shd
from repro_torch.configs.base import ShapeConfig, get_config, list_archs
from repro_torch.core.offload import SentinelConfig, opt_state_sharding
from repro_torch.launch import specs
from repro_torch.launch.mesh import make_production_mesh, make_rules
from repro_torch.models import kvcache, model
from repro_torch.weights import reference_leaf

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model"))}
RULES = {
    "train": lambda m, r: r.tp_dp_rules(m),
    "fsdp": lambda m, r: r.tp_dp_rules(m, fsdp=True),
    "seq_parallel": lambda m, r: r.tp_dp_rules(m, seq_parallel=True),
    "dp_only": lambda m, r: r.tp_dp_rules(m, dp_only=True),
    "serve": lambda m, r: r.serve_rules(m),
    "serve_seq_shard": lambda m, r: r.serve_rules(m, seq_shard=True),
}


def _both_rules(mesh_name, rules_name):
    shape, axes = MESHES[mesh_name]
    return (RULES[rules_name](shd.Mesh(shape, axes), shd),
            RULES[rules_name](AbstractMesh(shape, axes), ref_shd))


def _ref_param_tree(cfg_j):
    """(shape tree, axes tree) of the reference's parameters, from
    ``eval_shape`` (no weight is drawn)."""
    return split_params(jax.eval_shape(
        lambda: ref_model.init_params(jax.random.PRNGKey(0), cfg_j)))


def _ref_leaf(cfg, tree, name):
    """The reference's leaf for the port's parameter ``name``; a period
    layer's leaf without its stacked ``layers`` axis (an axes tuple) or
    dim (a shape)."""
    path = name.split(".")
    if path[0] != "layers":
        return reference_leaf(cfg, tree, name)
    leaf = tree["stack"]["slots"][int(path[1]) % cfg.period_len]
    for key in path[2:]:
        leaf = leaf[key]
    if isinstance(leaf, tuple):
        assert leaf[0] == "layers", (name, leaf)
        return leaf[1:]
    return tuple(leaf.shape[1:])


_CACHE = {}


def _archs(arch, reduced):
    key = (arch, reduced)
    if key not in _CACHE:
        cfg_j, cfg_t = ref_config(arch), get_config(arch)
        if reduced:
            cfg_j, cfg_t = cfg_j.reduced(), cfg_t.reduced()
        _CACHE[key] = (cfg_j, cfg_t, *_ref_param_tree(cfg_j))
    return _CACHE[key]


def test_archs_equal_the_reference():
    assert list_archs() == ref_list_archs()


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ref_list_archs())
def test_param_axes_match_reference(arch, reduced):
    """Every parameter's logical axes and shape equal the reference's
    leaf, without the stacked layers axis; the port names every leaf
    once (zamba2's shared block as ``shared.*``)."""
    cfg_j, cfg_t, shapes_j, axes_j = _archs(arch, reduced)
    axes = model.param_axes(cfg_t)
    params = model.init_params(cfg_t, device="meta")
    assert set(axes) == {n for n, _ in params.named_parameters()}
    for name, p in params.named_parameters():
        assert axes[name] == _ref_leaf(cfg_t, axes_j, name), name
        want = _ref_leaf(cfg_t, shapes_j, name)
        want = want if isinstance(want, tuple) else tuple(want.shape)
        assert tuple(p.shape) == want, name
        assert len(axes[name]) == p.dim(), name
    # as many leaves as the reference's tree holds, period layers counted
    # once a period
    n_ref = len(jax.tree.leaves(axes_j, is_leaf=ref_shd.is_axes_leaf))
    stacked = sum(1 for a in jax.tree.leaves(
        axes_j["stack"]["slots"], is_leaf=ref_shd.is_axes_leaf))
    assert len(axes) == n_ref - stacked + stacked * cfg_t.num_periods


@pytest.mark.parametrize("rules_name", list(RULES))
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_param_specs_match_reference(mesh_name, rules_name):
    """``AxisRules.spec`` (with and without a shape) and ``sharding_for``
    (which the rank program cuts parameters by) equal the reference's on
    every parameter of every arch at full width."""
    rules, ref_rules = _both_rules(mesh_name, rules_name)
    for arch in ref_list_archs():
        cfg_t = get_config(arch)
        params = model.init_params(cfg_t, device="meta")
        axes = model.param_axes(cfg_t)
        for name, p in params.named_parameters():
            ax, shape = axes[name], tuple(p.shape)
            what = (arch, name, ax, shape)
            assert rules.spec(ax) == tuple(ref_rules.spec(ax)), what
            want = tuple(ref_rules.spec(ax, shape))
            assert rules.spec(ax, shape) == want, what
            assert shd.sharding_for(shape, ax, rules).spec == want, what


def _ref_cache_axes(cfg, tree, layer):
    """The reference's axes of the port's cache entry ``layer``: the
    prologue's, or its period slot's without the layers axis; a
    recurrent state tuple's members under the port's flat names."""
    n_pro = len(cfg.prologue)
    if layer < n_pro:
        entry = dict(tree["prologue"][layer])
    else:
        entry = jax.tree.map(lambda ax: ax[1:], tree["slots"][
            (layer - n_pro) % cfg.period_len], is_leaf=ref_shd.is_axes_leaf)
    if "state" in entry:
        names = ("C", "n", "m") if len(entry["state"]) == 3 else \
            ("c", "n", "m", "h")
        entry.update(zip(names, entry.pop("state")))
    return entry


@pytest.mark.parametrize("arch", ref_list_archs())
def test_cache_axes_and_specs_match_reference(arch):
    """Each cache leaf's axes equal the reference's; under the serving
    rules (with and without seq_shard) on each mesh, its spec at its
    shape (B 32, 1024 rows) equals the reference's."""
    cfg_j, cfg_t = ref_config(arch), get_config(arch)
    axes = kvcache.cache_logical_axes(cfg_t)
    ref_axes = ref_kvcache.cache_logical_axes(cfg_j)
    caches = kvcache.init_cache(cfg_t, 32, 1024, torch.bfloat16, "meta")
    assert len(axes) == len(caches) == cfg_t.num_layers
    for l, (entry, cache) in enumerate(zip(axes, caches)):
        assert entry == _ref_cache_axes(cfg_t, ref_axes, l), (arch, l)
        assert set(entry) == set(cache)
    for mesh_name in MESHES:
        for rules_name in ("serve", "serve_seq_shard"):
            rules, ref_rules = _both_rules(mesh_name, rules_name)
            for entry, cache in zip(axes, caches):
                for k, ax in entry.items():
                    shape = tuple(cache[k].shape)
                    assert rules.spec(ax, shape) == \
                        tuple(ref_rules.spec(ax, shape)), (arch, k)


@pytest.mark.parametrize("arch", ["smollm-360m", "musicgen-medium",
                                  "paligemma-3b"])
def test_batch_specs_match_reference(arch):
    """Token, label and prefix leaves: shapes, dtypes and specs equal the
    reference's (codebooks and the prefix included), train and decode."""
    cfg_j, cfg_t = ref_config(arch), get_config(arch)
    rules, ref_rules = _both_rules("16x16", "train")
    shape_t = ShapeConfig("train_4k", 4096, 256, "train")
    shape_j = RefShapeConfig("train_4k", 4096, 256, "train")
    for decode in (False, True):
        got = specs.batch_specs(cfg_t, shape_t, decode=decode)
        want = ref_specs.batch_specs(cfg_j, shape_j, decode=decode)
        assert set(got) == set(want)
        for k in got:
            assert tuple(got[k].shape) == want[k].shape, k
            assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), k
        got_sh = specs.batch_shardings(cfg_t, shape_t, rules, decode=decode)
        want_sh = ref_specs.batch_shardings(cfg_j, shape_j, ref_rules,
                                            decode=decode)
        assert {k: v.spec for k, v in got_sh.items()} == \
            {k: tuple(v.spec) for k, v in want_sh.items()}


def test_opt_state_sharding_places_the_moments():
    """Each moment leaf's spec is the rules' spec of its axes, in
    pinned_host memory when offloaded and on the device otherwise, as
    the reference's ``opt_state_sharding``."""
    rules, ref_rules = _both_rules("16x16", "fsdp")
    axes = model.param_axes(get_config("granite-moe-3b-a800m"))
    for offload in (False, True):
        out = opt_state_sharding(rules, {"m": axes, "v": axes},
                                 offload=offload)
        for k in ("m", "v"):
            for name, ax in axes.items():
                s = out[k][name]
                assert s.spec == tuple(ref_rules.spec(ax))
                assert s.memory_kind == ("pinned_host" if offload
                                         else None)


def test_mesh_and_shard_shape():
    """A shape-only mesh; devices may repeat (aliases); shard_shape
    divides each sharded dim by its mesh-axis product and refuses one
    that does not divide, as ``NamedSharding.shard_shape`` does."""
    mesh = make_production_mesh(multi_pod=True)
    assert mesh.shape == {"pod": 2, "data": 16, "model": 16}
    assert mesh.devices is None and mesh.size == 512
    assert make_production_mesh().shape == {"data": 16, "model": 16}
    aliased = shd.Mesh((2, 2), ("data", "model"),
                       [torch.device("cpu")] * 4)
    assert aliased.size == 4 and len(set(aliased.devices)) == 1
    with pytest.raises(ValueError):
        shd.Mesh((2, 2), ("data", "model"), [torch.device("cpu")] * 3)
    assert shd.shard_shape((256, 4096, 960), (("pod", "data"), None,
                                              "model"), mesh) == \
        (8, 4096, 60)
    with pytest.raises(ValueError, match="divide"):
        shd.shard_shape((5, 64), ("model",), mesh)
    rules = make_rules(mesh, kind="decode", seq_shard=True)
    assert rules.rules["kv_seq"] == ("pod", "data")
    assert rules.rules["batch"] is None
    with shd.axis_rules(rules):
        assert shd.current_rules() is rules
    assert shd.current_rules() is None


# -------------------------------------------- per-device bytes, 2 x 4 mesh --

_REF_BYTES = r"""
import os, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
from repro.configs.base import ShapeConfig, get_config
from repro.core.offload import SentinelConfig
from repro.launch import specs
from repro.launch.mesh import make_rules
assert len(jax.devices()) == 8
mesh = jax.make_mesh((2, 4), ("data", "model"))
out = {}
for arch in ARCHS:
    cfg = get_config(arch).reduced()
    for kind in ("train", "prefill", "decode"):
        shape = ShapeConfig("tiny", 64, 8, kind)
        rules = make_rules(mesh, kind=kind)
        if kind == "train":
            fn, args, sh = specs.build_train_cell(
                cfg, shape, rules, SentinelConfig("offload", 1))
        elif kind == "prefill":
            fn, args, sh = specs.build_prefill_cell(cfg, shape, rules)
        else:
            fn, args, sh = specs.build_decode_cell(cfg, shape, rules)
        leaves = jax.tree.leaves(args)
        shards = jax.tree.leaves(sh, is_leaf=lambda x: hasattr(x, "spec"))
        assert len(leaves) == len(shards), (arch, kind)
        total = 0
        for a, s in zip(leaves, shards):
            n = 1
            for d in s.shard_shape(a.shape):
                n *= d
            total += n * a.dtype.itemsize
        out[f"{arch}/{kind}"] = total
print(json.dumps(out))
"""


def test_per_device_bytes_match_reference():
    """Each device's bytes of the train, prefill and decode cells of every
    arch, reduced, at B 8 x S 64 on the 2 x 4 mesh: the port's
    ``argument_bytes`` equals the sum of the reference's
    ``NamedSharding.shard_shape`` over its arguments."""
    archs = ref_list_archs()
    code = _REF_BYTES.replace("ARCHS", repr(archs))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    want = json.loads(res.stdout.strip().splitlines()[-1])
    mesh = shd.Mesh((2, 4), ("data", "model"))
    for arch in archs:
        cfg = get_config(arch).reduced()
        for kind in ("train", "prefill", "decode"):
            shape = ShapeConfig("tiny", 64, 8, kind)
            rules = make_rules(mesh, kind=kind)
            if kind == "train":
                _, args, sh = specs.build_train_cell(
                    cfg, shape, rules, SentinelConfig("offload", 1))
            elif kind == "prefill":
                _, args, sh = specs.build_prefill_cell(cfg, shape, rules)
            else:
                _, args, sh = specs.build_decode_cell(cfg, shape, rules)
            assert specs.argument_bytes(args, sh) == \
                want[f"{arch}/{kind}"], (arch, kind)
