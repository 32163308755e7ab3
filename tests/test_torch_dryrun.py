"""The port's dry-run surface against the reference's on the CPU: the
shapes and cells it walks, ``costing.step_cost`` (eager loops counted
every trip, a backward counted because it runs, mirroring
``tests/test_costing.py``), a small train cell's matmul FLOPs against the
reference's ``jaxpr_cost`` of its jitted step, and the CLI on meta."""
import json

import jax
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import sharding as ref_shd
from repro.configs.base import SHAPES as REF_SHAPES
from repro.configs.base import ShapeConfig as RefShapeConfig
from repro.configs.base import cells as ref_cells
from repro.configs.base import get_config as ref_config
from repro.core.offload import SentinelConfig as RefSentinelConfig
from repro.launch import specs as ref_specs
from repro.launch.costing import jaxpr_cost
from repro_torch.configs.base import SHAPES, ShapeConfig, cells, get_config
from repro_torch.core.offload import SentinelConfig
from repro_torch.launch import dryrun, specs
from repro_torch.launch.costing import step_cost
from repro_torch.launch.mesh import make_production_mesh, make_rules

TINY = ("tiny", 64, 8, "train")


def test_shapes_and_cells_equal_the_reference():
    assert {k: (v.name, v.seq_len, v.global_batch, v.kind)
            for k, v in SHAPES.items()} == \
        {k: (v.name, v.seq_len, v.global_batch, v.kind)
         for k, v in REF_SHAPES.items()}
    for skips in (False, True):
        assert cells(include_skips=skips) == ref_cells(include_skips=skips)


def test_eager_loop_counts_every_trip():
    """8 products of 64 x 64, and 3 x 4 nested ones of 32 x 32, counted
    exactly (the reference multiplies its scans' trip counts)."""
    def f(x, w):
        for _ in range(8):
            x = torch.tanh(x @ w)
        return x.sum()
    x = torch.ones(64, 64, device="meta")
    assert step_cost(f, x, x)["matmul_flops"] == 8 * 2 * 64 ** 3

    def g(x, w):
        for _ in range(3):
            for _ in range(4):
                x = x @ w
        return x.sum()
    y = torch.ones(32, 32, device="meta")
    assert step_cost(g, y, y)["matmul_flops"] == 12 * 2 * 32 ** 3


def test_backward_adds_its_flops():
    """A backward through x @ w with w alone differentiated adds the dW
    product: at least 1.9 times the forward's matmul FLOPs in all."""
    x = torch.ones(64, 64, device="meta")
    w = torch.ones(64, 64, device="meta", requires_grad=True)

    def fwd(w, x):
        return torch.tanh(x @ w).sum()

    def grad(w, x):
        return torch.autograd.grad(fwd(w, x), w)

    f = step_cost(fwd, w, x)["matmul_flops"]
    assert step_cost(grad, w, x)["matmul_flops"] >= 1.9 * f
    assert step_cost(fwd, w, x)["bytes"] > 0


def _tiny_costs(arch, mode):
    """(the port's step_cost, the reference's jaxpr_cost) of one train
    step of ``arch`` reduced at B 8 x S 64 in ``mode`` at MI 1."""
    mesh = AbstractMesh((16, 16), ("data", "model"))
    fn, args, _ = ref_specs.build_train_cell(
        ref_config(arch).reduced(), RefShapeConfig(*TINY),
        ref_shd.tp_dp_rules(mesh), RefSentinelConfig(mode, 1))
    want = jaxpr_cost(jax.make_jaxpr(fn)(*args))
    fn, args, _ = specs.build_train_cell(
        get_config(arch).reduced(), ShapeConfig(*TINY),
        make_rules(make_production_mesh()), SentinelConfig(mode, 1))
    return step_cost(fn, *args), want


@pytest.mark.parametrize("arch", ["smollm-360m", "internlm2-1.8b",
                                  "gemma2-2b"])
def test_train_cell_matmul_flops_match_reference(arch):
    """Mode full: the step's matmul FLOPs within 1% of the reference's
    (the same products, forward and backward); all FLOPs within 5%."""
    got, want = _tiny_costs(arch, "full")
    assert abs(got["matmul_flops"] - want["matmul_flops"]) <= \
        0.01 * want["matmul_flops"]
    assert abs(got["flops"] - want["flops"]) <= 0.05 * want["flops"]


@pytest.mark.parametrize("arch,mode", [
    ("granite-moe-3b-a800m", "full"), ("deepseek-v2-lite-16b", "full"),
    ("zamba2-7b", "full"), ("smollm-360m", "remat"),
    ("smollm-360m", "offload")])
def test_other_cells_report_both_counts(arch, mode):
    """No gate: the MoE layers dispatch by gathers here and by one-hot
    products in the reference, and a blocked step recomputes each block
    once here; both counts are printed, each positive."""
    got, want = _tiny_costs(arch, mode)
    ratio = got["matmul_flops"] / want["matmul_flops"]
    print(f"{arch} {mode}: matmul {got['matmul_flops']:.6g} against "
          f"{want['matmul_flops']:.6g}, {ratio:.4f} of it")
    assert got["matmul_flops"] > 0 and want["matmul_flops"] > 0


def test_dryrun_on_a_reduced_cell(tmp_path, capsys):
    """One reduced cell of each kind exits 0 and writes its record with
    the reference's keys that have a counterpart."""
    for arch, shape in (("granite-moe-3b-a800m", "decode_32k"),
                        ("musicgen-medium", "prefill_32k")):
        out = tmp_path / f"{arch}.json"
        assert dryrun.main(["--arch", arch, "--shape", shape, "--reduced",
                            "--out", str(out)]) == 0
        rec = json.loads(out.read_text())[0]
        assert rec["ok"] and rec["chips"] == 256 and rec["mesh"] == "16x16"
        assert rec["memory"]["argument_bytes"] > 0
        assert set(rec["cost_analytic"]) == {
            "flops_per_chip", "matmul_flops_per_chip", "bytes_per_chip"}
    assert "1/1 cells passed" in capsys.readouterr().out


def test_dryrun_smollm_train_4k_at_full_width(tmp_path):
    """python -m repro_torch.launch.dryrun --arch smollm-360m --shape
    train_4k on meta, no card: exit 0; each device holds a 256th of the
    batch and its share of the parameters and moments."""
    out = tmp_path / "smollm.json"
    assert dryrun.main(["--arch", "smollm-360m", "--shape", "train_4k",
                        "--out", str(out)]) == 0
    rec = json.loads(out.read_text())[0]
    assert rec["kind"] == "train" and rec["mi_periods"] == \
        specs.default_mi(get_config("smollm-360m"))
    assert rec["cost_analytic"]["matmul_flops_per_chip"] > 1e12
    assert 0 < rec["memory"]["argument_bytes"] < 1e9


THREE_CELLS = (("smollm-360m", "train_4k"),
               ("granite-moe-3b-a800m", "decode_32k"),
               ("gemma2-2b", "prefill_32k"))


def _ref_record(arch, shape_name):
    """The reference's per-chip analytic cost (``jaxpr_cost`` of its step)
    and each device's argument bytes (``NamedSharding.shard_shape`` summed)
    for one full-width cell on the 16 x 16 mesh, nothing compiled."""
    from repro.launch.mesh import make_rules as ref_make_rules
    cfg = ref_config(arch)
    shape = REF_SHAPES[shape_name]
    rules = ref_make_rules(AbstractMesh((16, 16), ("data", "model")),
                           kind=shape.kind)
    if shape.kind == "train":
        fn, args, sh = ref_specs.build_train_cell(
            cfg, shape, rules,
            RefSentinelConfig("offload", ref_specs.default_mi(cfg)))
    elif shape.kind == "prefill":
        fn, args, sh = ref_specs.build_prefill_cell(cfg, shape, rules)
    else:
        fn, args, sh = ref_specs.build_decode_cell(cfg, shape, rules)
    cost = jaxpr_cost(jax.make_jaxpr(fn)(*args))
    total = 0
    for a, s in zip(jax.tree.leaves(args),
                    jax.tree.leaves(sh, is_leaf=lambda x: hasattr(x,
                                                                  "spec"))):
        n = 1
        for d in s.shard_shape(a.shape):
            n *= d
        total += n * a.dtype.itemsize
    return {k: v / 256 for k, v in cost.items()}, total


@pytest.mark.parametrize("arch,shape_name", THREE_CELLS)
def test_full_width_cells_beside_the_reference(arch, shape_name):
    """Three cells at full width: each device's argument bytes equal the
    reference's; the per-chip FLOPs, matmul FLOPs and bytes of both are
    printed, smollm's train step's matmul FLOPs (offload at MI 4, every
    block recomputed in both) within 1% of the reference's."""
    rec = dryrun.run_cell(arch, shape_name)
    ref_cost, ref_bytes = _ref_record(arch, shape_name)
    got = rec["cost_analytic"]
    print(f"{arch} x {shape_name}: argument bytes a device "
          f"{rec['memory']['argument_bytes']} (reference {ref_bytes}); per "
          f"chip: FLOPs {got['flops_per_chip']:.6g} (reference "
          f"{ref_cost['flops']:.6g}), matmul FLOPs "
          f"{got['matmul_flops_per_chip']:.6g} (reference "
          f"{ref_cost['matmul_flops']:.6g}), bytes "
          f"{got['bytes_per_chip']:.6g} (reference {ref_cost['bytes']:.6g})")
    assert rec["memory"]["argument_bytes"] == ref_bytes
    if arch == "smollm-360m":
        assert abs(got["matmul_flops_per_chip"] - ref_cost["matmul_flops"]) \
            <= 0.01 * ref_cost["matmul_flops"]


PARTITIONED = ("smollm-360m", "gemma2-2b", "gemma3-12b", "internlm2-1.8b",
               "granite-moe-3b-a800m")


@pytest.mark.parametrize("arch", PARTITIONED)
def test_train_cells_carry_collectives_backward_included(arch):
    """Each pure-attention arch's ``train_4k`` cell (reduced, the 16 x 16
    mesh, offload at its default MI) carries ``collectives``: at 16 model
    ranks the reduced heads are cut, so every layer gathers q, k and v in
    its forward and again in its backward's recompute, and each gather's
    backward is a reduce-scatter; ``--fsdp`` adds the parameters' gathers
    and reduce-scatters over ``data``, and ``--dp-only`` leaves
    all-reduces alone (the batch over data x model, the gradients and the
    loss summed over it, the clip's norm local)."""
    cfg = get_config(arch).reduced()
    got = {}
    for kw in ({}, {"fsdp": True}, {"dp_only": True}):
        rec = dryrun.run_cell(arch, "train_4k", cfg=cfg, **kw)
        assert rec["ok"] and "collectives_note" not in rec
        got[tuple(kw)] = rec["collectives"]["counts"]
    plain = got[()]
    assert plain["reduce-scatter"] > 0
    assert plain["all-gather"] == 2 * plain["reduce-scatter"]
    assert got[("fsdp",)]["reduce-scatter"] > plain["reduce-scatter"]
    assert {k for k, v in got[("dp_only",)].items() if v} == {"all-reduce"}
