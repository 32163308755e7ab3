"""``long_500k``'s decode on the CPU: the attention caches' sequence split
over the data axes (``sharding.serve_rules(seq_shard=True)``), the heads
over ``model``, the recurrent states whole on every data rank.  Reduced
gemma2-2b, gemma3-12b (LOCAL layers whose window lies in one block),
zamba2-7b (its shared attention beside Mamba) and xlstm-1.3b (no
attention) decode one token a slot on ``[cpu] * n`` as (2, 2) and (2, 1)
(data, model) meshes against one device and against the reference's own
compiled ``long_500k``-style cell (``build_decode_cell`` under
``make_rules(seq_shard=True)``) run in one subprocess of 8 forced JAX
devices on the same parameters and cache, with XLA's bytes pinned beside
the port's ledger (ROADMAP R16).  Also ROADMAP F5 (a rank's cache held
the whole sequence) and its repair.

Every rank is a thread; torch runs on one thread in this module.
Tolerances are fp32's, stated with each test."""
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch import collectives
from repro_torch import sharding as shd
from repro_torch.configs import get_config
from repro_torch.configs.base import LOCAL, ShapeConfig
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import make_rules
from repro_torch.models import attention, kvcache, model

CPU = torch.device("cpu")
ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ("gemma2-2b", "gemma3-12b", "zamba2-7b", "xlstm-1.3b")
MESHES = ((2, 2), (2, 1))
# the cache's rows; a data axis of 2 holds rows 0-31 and 32-63
S = 64
# an index in the first data block and one in the last: at 3 the last
# block sees no key, at 60 a LOCAL layer's window of 8 (53-60) lies in
# the last block alone, so the first sees none there
FIRST, LAST = 3, 60
# against one device: fp32 on both sides, the softmax merged over the
# data ranks and the heads' products summed in another order
ONE_TOL = dict(atol=1e-5, rtol=1e-5)
# against the reference's compiled cell: two frameworks' fp32
REF_TOL = dict(atol=1e-4, rtol=0.0)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# The reference's side, in one subprocess of 8 forced CPU devices.  For
# each reduced config: its parameters from PRNGKey(0); a 64-token prompt
# of one row from seed 5 prefilled on one device into a 64-row cache
# (saved in the port's layer-by-layer layout, the xLSTM states' tuples as
# named leaves); then on each mesh its ``build_decode_cell`` (B 1 x S 64)
# under ``make_rules(mesh, kind="decode", seq_shard=True)``, compiled,
# its ``collective_bytes``, and its output at each index (the token from
# seed 6): the logits and the new cache
REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro import sharding as shd
    from repro.configs.base import MLSTM, ShapeConfig, get_config
    from repro.launch import specs
    from repro.launch.dryrun import collective_bytes
    from repro.launch.mesh import make_rules
    from repro.models import model
    from repro.models.layers import split_params

    out_dir, archs, meshes, indices, S = json.loads(sys.argv[1])
    devs = jax.devices()

    def port_layout(c, caches):
        layers = [(kind, dict(x))
                  for kind, x in zip(c.prologue, caches["prologue"])]
        for p in range(c.num_periods):
            for s, kind in enumerate(c.period):
                layers.append((kind, {k: tuple(a[p] for a in v)
                                      if isinstance(v, tuple) else v[p]
                                      for k, v in caches["slots"][s].items()}))
        out = {}
        for l, (kind, layer) in enumerate(layers):
            for k, v in layer.items():
                if k == "state":
                    names = ("C", "n", "m") if kind == MLSTM \\
                        else ("c", "n", "m", "h")
                    for nm, a in zip(names, v):
                        out[f"{l}/{nm}"] = np.asarray(a)
                else:
                    out[f"{l}/{k}"] = np.asarray(v)
        return out

    rec = {}
    for arch in archs:
        c = get_config(arch).reduced()
        params, _ = split_params(model.init_params(jax.random.PRNGKey(0), c))
        prompt = np.random.default_rng(5).integers(
            0, c.vocab_size, (1, S)).astype(np.int32)
        _, caches = jax.jit(lambda p, t: model.prefill(
            p, c, {"tokens": t}, max_seq=S))(params, jnp.asarray(prompt))
        np.savez(os.path.join(out_dir, f"cache_{arch}.npz"),
                 **port_layout(c, caches))
        tok = np.random.default_rng(6).integers(
            0, c.vocab_size, (1, 1)).astype(np.int32)
        np.save(os.path.join(out_dir, f"tok_{arch}.npy"), tok)
        rec[arch] = {}
        for shape in meshes:
            mesh = jax.sharding.Mesh(
                np.asarray(devs[:shape[0] * shape[1]]).reshape(shape),
                ("data", "model"))
            rules = make_rules(mesh, kind="decode", seq_shard=True)
            with mesh, shd.axis_rules(rules):
                fn, args, in_sh = specs.build_decode_cell(
                    c, ShapeConfig("long", S, 1, "decode"), rules)
                compiled = jax.jit(fn, in_shardings=in_sh).lower(
                    *args).compile()
                p = jax.device_put(params, in_sh[0])
                t = jax.device_put(jnp.asarray(tok), in_sh[1])
                for i in indices:
                    cc = jax.device_put(caches, in_sh[2])
                    ix = jax.device_put(jnp.int32(i), in_sh[3])
                    logits, new = compiled(p, t, cc, ix)
                    key = f"{arch}_{shape[0]}x{shape[1]}_{i}"
                    np.savez(os.path.join(out_dir, f"out_{key}.npz"),
                             logits=np.asarray(logits),
                             **port_layout(c, new))
            rec[arch][f"{shape[0]}x{shape[1]}"] = collective_bytes(
                compiled.as_text(),
                loop_trips=float(c.num_periods))["bytes"]
    print(json.dumps(rec))
""")


@pytest.fixture(scope="module", autouse=True)
def reference_run(tmp_path_factory):
    """The REFERENCE script, started when the module starts so that it
    runs beside the port's tests; ``reference`` waits for it."""
    out = tmp_path_factory.mktemp("ref_long")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["JAX_PLATFORMS"] = "cpu"
    args = json.dumps([str(out), ARCHS, MESHES, (FIRST, LAST), S])
    proc = subprocess.Popen([sys.executable, "-c", REFERENCE, args],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)
    yield proc, out
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def reference(reference_run):
    proc, out = reference_run
    stdout, stderr = proc.communicate(timeout=900)
    assert proc.returncode == 0, stderr[-3000:]
    return json.loads(stdout.strip().splitlines()[-1]), out


def ref_params(arch, cfg):
    """The reference's reduced parameters from PRNGKey(0), as the port's."""
    import jax
    from repro.configs.base import get_config as ref_config
    from repro.models import model as ref_model
    from repro.models.layers import split_params
    from repro_torch.weights import params_from_jax
    tree, _ = split_params(ref_model.init_params(jax.random.PRNGKey(0),
                                                 ref_config(arch).reduced()))
    return params_from_jax(cfg, jax.tree.map(np.asarray, tree), device="cpu")


def load_cache(cfg, path, batch=1):
    """A cache of the port's layout (``init_cache``) filled from ``path``'s
    "<layer>/<leaf>" arrays."""
    data = np.load(path)
    caches = kvcache.init_cache(cfg, batch, S, torch.float32, CPU)
    for l, layer in enumerate(caches):
        for k in layer:
            layer[k] = torch.from_numpy(np.array(data[f"{l}/{k}"]))
    return caches


def cache_specs(cfg, caches, rules):
    axes = kvcache.cache_logical_axes(cfg)
    return [{k: shd.sharding_for(tuple(v.shape), axes[l][k], rules).spec
             for k, v in layer.items()} for l, layer in enumerate(caches)]


def decode_partitioned(cfg, params, tokens, caches, index, shape):
    """One decode step on ``[cpu] * n`` as the (data, model) mesh
    ``shape`` under ``serve_rules(seq_shard=True)``: each rank its blocks
    of the parameters and of every cache leaf (``sharding_for`` of
    ``cache_logical_axes``), the batch whole.  Returns (the logits, the
    vocab blocks of the model ranks joined, the new cache, every rank's
    blocks put back in place, each rank's cache blocks, the mesh's
    ledger)."""
    mesh = shd.Mesh(shape, ("data", "model"),
                    devices=[CPU] * (shape[0] * shape[1]))
    rules = shd.serve_rules(mesh, seq_shard=True)
    specs_ = cache_specs(cfg, caches, rules)
    groups = collectives.MeshGroup(mesh)
    pos = groups.positions
    ranks = [shd.shard_params(params, rules, p) for p in pos]
    mine = [[{k: shd._block_of(v, specs_[l][k], p, mesh).clone()
              for k, v in layer.items()} for l, layer in enumerate(caches)]
            for p in pos]

    def rank(i):
        with shd.rank_context(shd.mesh_rank(groups, rules, pos[i])):
            return model.decode_step(ranks[i], cfg, tokens, mine[i], index)

    try:
        outs = groups.run(rank)
    finally:
        groups.close()
    logits = torch.cat([outs[i][0] for i in range(shape[1])], dim=-1)
    whole = []
    for l, layer in enumerate(caches):
        whole.append({})
        for k, v in layer.items():
            t = torch.empty_like(v)
            for i, p in enumerate(pos):
                shd._block_of(t, specs_[l][k], p, mesh).copy_(
                    outs[i][1][l][k])
            whole[-1][k] = t
    return logits, whole, [o[1] for o in outs], groups.ledger


def one_device(cfg, params, tokens, caches, index):
    fresh = [{k: v.clone() for k, v in layer.items()} for layer in caches]
    return model.decode_step(params, cfg, tokens, fresh, index)


def assert_caches(got, want, tol, what):
    for l, (a, b) in enumerate(zip(got, want)):
        assert a.keys() == b.keys()
        for k in a:
            torch.testing.assert_close(a[k], b[k], **tol,
                                       msg=f"{what}: layer {l} {k}")


# ---------------------------------------------------------------- F5 --

def test_a_ranks_cache_holds_its_block_of_the_sequence():
    """ROADMAP F5: on a (2, 2) mesh under ``serve_rules(seq_shard=True)``
    reduced gemma2-2b's ``init_cache(cfg, 1, 64)`` gave each rank k and v
    of (1, 64, 16), the whole sequence, while ``sharding_for`` lays them
    out as (None, 'data', 'model'): ``local_shape`` divided only the dims
    split over ``model``.  Each rank now holds its block of the rows, (1,
    32, 16), as ``shard_shape`` of that spec; every other leaf, zamba2's
    Mamba states and the xLSTM's among them, keeps its shape, and so does
    every cache under rules without ``seq_shard``."""
    mesh = shd.Mesh((2, 2), ("data", "model"))
    for arch in ARCHS:
        cfg = get_config(arch).reduced()
        axes = kvcache.cache_logical_axes(cfg)
        for seq_shard in (True, False):
            rules = shd.serve_rules(mesh, seq_shard=seq_shard)
            whole = kvcache.init_cache(cfg, 1, S, torch.float32, "meta")
            model_only = shd.serve_rules(mesh)
            for coords in ({"data": 0, "model": 0}, {"data": 1, "model": 1}):
                ctx = shd.mesh_rank(collectives.ShapeMesh(mesh), rules,
                                    coords)
                with shd.rank_context(ctx):
                    got = kvcache.init_cache(cfg, 1, S, torch.float32,
                                             "meta")
                for l, layer in enumerate(got):
                    for k, v in layer.items():
                        spec = shd.sharding_for(
                            tuple(whole[l][k].shape), axes[l][k], rules).spec
                        want = shd.shard_shape(tuple(whole[l][k].shape),
                                               spec, mesh)
                        assert tuple(v.shape) == want, (arch, l, k)
                        if k not in kvcache.SEQ_KEYS or not seq_shard:
                            # the shape the model axis alone gives
                            m = shd.sharding_for(tuple(whole[l][k].shape),
                                                 axes[l][k], model_only).spec
                            assert want == shd.shard_shape(
                                tuple(whole[l][k].shape), m, mesh)
    cfg = get_config("gemma2-2b").reduced()
    ctx = shd.mesh_rank(collectives.ShapeMesh(mesh),
                        shd.serve_rules(mesh, seq_shard=True),
                        {"data": 1, "model": 0})
    with shd.rank_context(ctx):
        got = kvcache.init_cache(cfg, 1, S, torch.float32, "meta")
    assert tuple(got[0]["k"].shape) == tuple(got[0]["v"].shape) == (1, 32,
                                                                     16)
    with shd.rank_context(ctx), pytest.raises(ValueError,
                                              match="do not divide"):
        kvcache.init_cache(cfg, 1, 63, torch.float32, "meta")


def test_a_seq_sharded_cache_refuses_what_has_no_program():
    """Under ``seq_shard`` rules a write of more than one row a slot (a
    prefill into the split cache) raises, and so does MLA's latent cache
    (MLA is not subquadratic: no ``long_500k`` cell reaches it), rather
    than run on the wrong rows."""
    mesh = shd.Mesh((2, 1), ("data", "model"), devices=[CPU] * 2)
    rules = shd.serve_rules(mesh, seq_shard=True)
    for arch, match in (("gemma2-2b", "only a decode"),
                        ("deepseek-v2-lite-16b", "not subquadratic")):
        cfg = get_config(arch).reduced()
        params = model.init_params(cfg, seed=0, device="cpu")
        groups = collectives.MeshGroup(mesh)

        def rank(i):
            with shd.rank_context(shd.mesh_rank(groups, rules,
                                                groups.positions[i])):
                caches = kvcache.init_cache(cfg, 1, S, torch.float32, CPU)
                if arch == "gemma2-2b":
                    return model.prefill(params, cfg, {
                        "tokens": torch.zeros(1, 4, dtype=torch.long)},
                        max_seq=S)
                return model.decode_step(params, cfg, torch.zeros(
                    1, 1, dtype=torch.long), caches, torch.tensor([3]))

        try:
            with pytest.raises(NotImplementedError, match=match):
                groups.run(rank)
        finally:
            groups.close()


# ------------------------------------------- against one device alone --

@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_equals_one_device_at_mixed_indices(arch, shape):
    """Two slots, one at an index in the first data block and one in the
    last, from a prefilled 64-row cache (seed 3's parameters): the
    logits and every cache leaf within 1e-5 of one device's.  Each rank
    writes only the rows its block holds (a negative local offset is
    dropped, not wrapped): every rank's k and v block equals one device's
    rows."""
    cfg = get_config(arch).reduced()
    params = model.init_params(cfg, seed=3, device="cpu")
    toks = torch.as_tensor(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (2, S)))
    _, caches = model.prefill(params, cfg, {"tokens": toks}, max_seq=S)
    index = torch.tensor([FIRST, LAST])
    nxt = toks[:, :1]
    want, want_c = one_device(cfg, params, nxt, caches, index)
    got, got_c, blocks, led = decode_partitioned(cfg, params, nxt, caches,
                                                 index, shape)
    torch.testing.assert_close(got, want, **ONE_TOL)
    assert_caches(got_c, want_c, ONE_TOL, arch)
    half = S // shape[0]
    for i, blk in enumerate(blocks):
        d = i // shape[1]
        for l, layer in enumerate(blk):
            if "k" in layer:
                rows = want_c[l]["k"][:, d * half:(d + 1) * half]
                cols = layer["k"].shape[-1]
                m = i % shape[1]
                torch.testing.assert_close(
                    layer["k"], rows[..., m * cols:(m + 1) * cols],
                    **ONE_TOL)
    # the softmax merged over the data ranks where a layer attends
    assert (led["counts"]["all-reduce"] > 0) == \
        (any("k" in c for c in caches) or shape[1] > 1)


def test_a_local_layer_whose_block_sees_no_key():
    """Reduced gemma3-12b's LOCAL layers (window 8) at index 60 on (2, 1):
    the keys 53-60 lie in the last data block, so every score of the
    first block is masked (its partial max sits at NEG_INF's bias).  Its
    weight in the merge is exactly 0, not the empty row's mean over its
    values that the oracles give (ROADMAP R5): the layer's output equals
    one device's, and so does the merge with the first block's values
    replaced by garbage."""
    cfg = get_config("gemma3-12b").reduced()
    assert cfg.layer_kind(0) == LOCAL and cfg.sliding_window == 8
    half = S // 2
    pos = torch.tensor([[LAST]])
    rng = np.random.default_rng(11)
    KV, hd = cfg.num_kv_heads, cfg.head_dim
    G = cfg.num_heads // KV
    q = torch.as_tensor(rng.standard_normal((1, 1, KV, G, hd),
                                            dtype=np.float32))
    k, v = (torch.as_tensor(rng.standard_normal((1, S, KV, hd),
                                                dtype=np.float32))
            for _ in range(2))
    bias = attention.attn_bias(pos, torch.arange(S), window=8)
    want = attention._gqa_core(q, k, v, bias, cfg.attn_softcap)
    parts = []
    for d in range(2):
        rows = slice(d * half, (d + 1) * half)
        vd = v[:, rows] if d else torch.full_like(v[:, rows], 1e30)
        b = attention.attn_bias(pos, torch.arange(S)[rows], window=8)
        parts.append(attention._gqa_partial(q, k[:, rows], vd, b,
                                            cfg.attn_softcap))
    assert bool((parts[0][0] <= attention.NEG_INF / 2).all())
    mesh = shd.Mesh((2, 1), ("data", "model"), devices=[CPU] * 2)
    groups = collectives.MeshGroup(mesh)
    rules = shd.serve_rules(mesh, seq_shard=True)

    def rank(i):
        with shd.rank_context(shd.mesh_rank(groups, rules,
                                            groups.positions[i])):
            return attention._merge_partials(*parts[i], ("data",),
                                             torch.float32)

    try:
        outs = groups.run(rank)
    finally:
        groups.close()
    for out in outs:
        torch.testing.assert_close(out, want, **ONE_TOL)


# ------------------------------------------------------ the reference --

# XLA's collective bytes of the reference's compiled decode cell (B 1 x S
# 64, reduced, fp32, ``make_rules(kind="decode", seq_shard=True)``) on this
# JAX (0.9.0, forced CPU devices), beside the port's ledger of the same
# step (ROADMAP R16).  The port all-reduces each attention layer's row
# maxima and its weighted (o, l) over the data axis, and its model-axis
# collectives are its TP decode's (R14, R15): its all-reduce bytes equal
# XLA's but for the xLSTM, which XLA reshards with collective-permute as
# it does Mamba's blocks, where the port gathers ``x @ w_in`` and the
# conv's weights (zamba2) and reduce-scatters q, k, v and the gates onto
# the rank's heads (xlstm)
XLA_CELL = {
    ("gemma2-2b", (2, 2)): {"all-reduce": 2880.0},
    ("gemma2-2b", (2, 1)): {"all-reduce": 1152.0},
    ("gemma3-12b", (2, 2)): {"all-reduce": 8128.0},
    ("gemma3-12b", (2, 1)): {"all-reduce": 3456.0},
    ("zamba2-7b", (2, 2)): {"all-gather": 1152.0, "all-reduce": 3908.0,
                            "collective-permute": 7200.0},
    ("zamba2-7b", (2, 1)): {"all-reduce": 576.0},
    ("xlstm-1.3b", (2, 2)): {"all-gather": 512.0, "all-reduce": 11808.0,
                             "collective-permute": 7872.0},
    ("xlstm-1.3b", (2, 1)): {}}
PORT_CELL = {
    ("gemma2-2b", (2, 2)): {"all-reduce": 2880.0},
    ("gemma2-2b", (2, 1)): {"all-reduce": 1152.0},
    ("gemma3-12b", (2, 2)): {"all-reduce": 8128.0},
    ("gemma3-12b", (2, 1)): {"all-reduce": 3456.0},
    ("zamba2-7b", (2, 2)): {"all-gather": 57024.0, "all-reduce": 3908.0},
    ("zamba2-7b", (2, 1)): {"all-reduce": 576.0},
    ("xlstm-1.3b", (2, 2)): {"all-gather": 5120.0, "all-reduce": 3896.0,
                             "reduce-scatter": 7392.0},
    ("xlstm-1.3b", (2, 1)): {}}


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_equals_the_reference_cell(reference, arch, shape):
    """From the reference's parameters and its prefilled cache, one
    token at an index in the first data block and one in the last: the
    port's partitioned decode and one device's within 1e-5 of each other
    and within 1e-4 of the reference's compiled cell (logits and every
    cache leaf); the port's ledger equals the dry run's
    (``rank_collectives`` of the same cell on meta); both ledgers
    pinned."""
    rec, out = reference
    cfg = get_config(arch).reduced()
    params = ref_params(arch, cfg)
    caches = load_cache(cfg, out / f"cache_{arch}.npz")
    tok = torch.from_numpy(np.load(out / f"tok_{arch}.npy").astype(np.int64))
    name = f"{shape[0]}x{shape[1]}"
    ledgers = []
    for i in (FIRST, LAST):
        index = torch.tensor([i])
        want, want_c = one_device(cfg, params, tok, caches, index)
        got, got_c, _, led = decode_partitioned(cfg, params, tok, caches,
                                                index, shape)
        torch.testing.assert_close(got, want, **ONE_TOL)
        assert_caches(got_c, want_c, ONE_TOL, f"{arch} {name} at {i}")
        ref = np.load(out / f"out_{arch}_{name}_{i}.npz")
        torch.testing.assert_close(got, torch.from_numpy(ref["logits"]),
                                   **REF_TOL)
        ref_c = [{k: torch.from_numpy(np.array(ref[f"{l}/{k}"]))
                  for k in layer} for l, layer in enumerate(got_c)]
        assert_caches(got_c, ref_c, REF_TOL, f"{arch} {name} at {i} (ref)")
        ledgers.append(led)
    assert ledgers[0] == ledgers[1]
    rules = make_rules(shd.Mesh(shape, ("data", "model")), kind="decode",
                       seq_shard=True)
    fn, args, in_sh = specs.build_decode_cell(
        cfg, ShapeConfig("long", S, 1, "decode"), rules)
    dry = dryrun.rank_collectives(fn, args, in_sh, rules)
    assert dry == ledgers[0]
    nonzero = {k: v for k, v in dry["bytes"].items() if v}
    print(f"{arch} {name}: XLA {rec[arch][name]}, port {nonzero}")
    assert {k: v for k, v in rec[arch][name].items() if v} == \
        XLA_CELL[arch, shape]
    assert nonzero == PORT_CELL[arch, shape]


@pytest.mark.parametrize("multi_pod", [False, True])
def test_long_500k_cells_carry_collectives(multi_pod):
    """The dry run's ``long_500k`` cells at full width, on 16 x 16 and 2 x
    16 x 16: every subquadratic arch's record carries ``collectives``;
    the attention archs' include the data axes' merges (gemma2-2b's and
    gemma3-12b's cut KV heads also gather their rank's block of the
    cache over ``model``), xlstm-1.3b's no attention."""
    for arch in ARCHS:
        rec = dryrun.run_cell(arch, "long_500k", multi_pod=multi_pod)
        assert rec["ok"] and "collectives_note" not in rec
        assert rec["collectives"]["counts"]["all-reduce"] > 0
        assert rec["mesh"] == ("2x16x16" if multi_pod else "16x16")
