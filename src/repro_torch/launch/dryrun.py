"""Dry run of every (arch x shape x mesh) cell on the meta device (port of
``repro/launch/dryrun.py``): ``python -m repro_torch.launch.dryrun``.

Each cell's step runs once on meta tensors, on any machine: no card, no
allocation.  Its record keeps the reference's keys that have a
counterpart here: arch, shape, mesh, chips, kind, mode, mi_periods, the
rule flags, ``cost_analytic`` per chip (``launch/costing.py``: the aten
ops the step runs, its backward and recomputes included) and
``memory.argument_bytes``, each device's bytes of the step's arguments
(parameters, optimizer state, batch, cache) by ``sharding.shard_shape``
under the cell's rules.  Every cell also carries ``collectives`` in the
reference's format (``{"bytes": {type: B}, "counts": {type: n}}``): the
partitioned step of mesh position (0, ..., 0) runs on meta tensors
under a ``collectives.ShapeMesh`` (a ``ShapeGroup`` for each set of mesh
axes a collective spans: ``model``; ``data`` for a train step's
data-parallel reductions and FSDP's gathers, and for ``long_500k``'s
merge of the attention softmax over its sequence split on the data
axes), whose ledger counts each collective's per-device result bytes,
a train step's backward collectives included (Megatron-SP's under
``--seq-parallel``), and its executions in ``counts`` (the reference
counts HLO sites).  The token loops of the recurrent layers
(``kernels/ref.step_loop``) run there as under ``step_cost``: trip 0,
then one trip whose collectives, and its backward's, count for the
other S - 1 (the groups' ``Trips``).  There is no ``temp_bytes`` or
``cost``: those are XLA's.

Exit code 0 when every cell passes.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import time
import traceback

import torch

from repro_torch import sharding as shd
from repro_torch.collectives import ShapeMesh
from repro_torch.configs.base import SHAPES, cells, get_config
from repro_torch.core.offload import SentinelConfig
from repro_torch.kernels import ref
from repro_torch.launch import specs
from repro_torch.launch.costing import step_cost
from repro_torch.launch.mesh import make_production_mesh, make_rules

def _blocks(tree, shardings):
    """Meta tensors of each leaf's per-device block (``shard_shape``)."""
    if torch.is_tensor(tree):
        return torch.empty(shardings.shard_shape(tuple(tree.shape)),
                           dtype=tree.dtype, device="meta")
    if isinstance(tree, dict):
        return {k: _blocks(v, shardings[k]) for k, v in tree.items()}
    return type(tree)(_blocks(v, s) for v, s in zip(tree, shardings))


def rank_collectives(fn, args, in_sh, rules) -> dict:
    """The collectives ledger of the step ``fn`` run as mesh position (0,
    ..., 0): its parameter blocks (``sharding.shard_params``) and argument
    blocks on meta, under a rank context whose ``ShapeMesh`` gives a
    group over any set of mesh axes (a serve cell's collectives span
    ``model``, and the data axes for ``long_500k``'s sequence split).  A
    train step (``args`` (state, batch)) runs forward and backward on its
    rows of the batch (``sharding.batch_split``).  The groups' ``Trips``
    is ``kernels/ref.step_loop``'s counter meanwhile, so a token loop's
    trip counts its collectives S - 1 times."""
    mesh = rules.mesh
    coords = {a: 0 for a in mesh.axis_names}
    if isinstance(args[0], dict) and "params" in args[0]:
        state, batch = args
        params = shd.shard_params(state["params"], rules, coords, train=True)
        # the moments follow the rank's blocks (``sharding_for``'s spec,
        # as the partitioned step's do)
        opt = {k: {n: torch.empty_like(p)
                   for n, p in params.named_parameters()}
               for k in state["opt"] if k != "count"}
        opt["count"] = state["opt"]["count"]
        rank_state = {"params": params, "opt": opt, "step": state["step"]}
        B = batch["tokens"].shape[0]
        axes, _ = shd.batch_split(rules, coords, B)
        rows = B // math.prod(mesh.shape[a] for a in axes)
        groups = ShapeMesh(mesh)
        ctx = shd.mesh_rank(groups, rules, coords, batch_axes=axes,
                            params=params)
        with shd.rank_context(ctx), _loops_counted(groups.trips):
            fn(rank_state, {k: v[:rows] for k, v in batch.items()})
        return groups.ledger
    params = shd.shard_params(args[0], rules, coords)
    rest = [_blocks(a, sh) for a, sh in zip(args[1:], in_sh[1:])]
    groups = ShapeMesh(mesh)
    with shd.rank_context(shd.mesh_rank(groups, rules, coords)), \
            _loops_counted(groups.trips):
        fn(params, *rest)
    return groups.ledger


@contextlib.contextmanager
def _loops_counted(trips):
    """``trips`` as ``kernels/ref.step_loop``'s counter for the body."""
    ref.counting(trips)
    try:
        yield
    finally:
        ref.counting(None)


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             mode: str = "offload", mi: int = 0, fsdp: bool = False,
             compress_grads: bool = False, seq_parallel: bool = False,
             dp_only: bool = False, moe_group: int = 0, cfg=None) -> dict:
    """One cell's record; ``cfg`` replaces the registered config (the
    reduced one)."""
    cfg = cfg or get_config(arch)
    if moe_group and cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, group_size=moe_group))
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    kind = shape.kind
    rules = make_rules(mesh, kind=kind,
                       seq_shard=(shape_name == "long_500k"), fsdp=fsdp,
                       seq_parallel=seq_parallel, dp_only=dp_only)
    scfg = SentinelConfig(mode=mode,
                          mi_periods=mi or specs.default_mi(cfg))
    t0 = time.time()
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "2x16x16" if multi_pod else "16x16",
           "chips": mesh.size, "kind": kind, "mode": mode,
           "mi_periods": scfg.mi_periods, "fsdp": fsdp,
           "seq_parallel": seq_parallel, "dp_only": dp_only}
    if kind == "train":
        opt_cfg = None
        if compress_grads:
            from repro_torch.optim import adamw
            opt_cfg = adamw.OptConfig(compress_grads=True)
        fn, args, in_sh = specs.build_train_cell(cfg, shape, rules, scfg,
                                                 opt_cfg)
    elif kind == "prefill":
        fn, args, in_sh = specs.build_prefill_cell(cfg, shape, rules)
    else:
        fn, args, in_sh = specs.build_decode_cell(cfg, shape, rules)
    rec["memory"] = {"argument_bytes": specs.argument_bytes(args, in_sh)}
    cost = step_cost(fn, *args)
    rec["cost_analytic"] = {
        "flops_per_chip": cost["flops"] / rec["chips"],
        "matmul_flops_per_chip": cost["matmul_flops"] / rec["chips"],
        "bytes_per_chip": cost["bytes"] / rec["chips"],
    }
    rec["collectives"] = rank_collectives(fn, args, in_sh, rules)
    rec["run_s"] = round(time.time() - t0, 1)
    rec["ok"] = True
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--mode", default="offload",
                    choices=["offload", "save_hbm", "remat", "full"])
    ap.add_argument("--mi", type=int, default=0)
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--seq-parallel", action="store_true",
                    help="Megatron-SP residual sharding")
    ap.add_argument("--dp-only", action="store_true",
                    help="fold the model axis into DP (small models)")
    ap.add_argument("--mlstm-chunk", type=int, default=0,
                    help="chunkwise-parallel mLSTM")
    ap.add_argument("--moe-group", type=int, default=0,
                    help="MoE dispatch group size override")
    ap.add_argument("--reduced", action="store_true",
                    help="the smoke-scale configs (default: full width)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    if args.mlstm_chunk:
        from repro_torch.kernels import ops as kops
        kops.mlstm_chunk_mode(args.mlstm_chunk)

    if args.arch:
        todo = [(args.arch, args.shape or "train_4k", False)]
    else:
        todo = cells()

    mesh_name = "2x16x16" if args.multipod else "16x16"
    results = []
    for arch, shape_name, _skip in todo:
        try:
            cfg = get_config(arch)
            rec = run_cell(arch, shape_name, multi_pod=args.multipod,
                           mode=args.mode, mi=args.mi, fsdp=args.fsdp,
                           compress_grads=args.compress_grads,
                           seq_parallel=args.seq_parallel,
                           dp_only=args.dp_only, moe_group=args.moe_group,
                           cfg=cfg.reduced() if args.reduced else cfg)
        except Exception as e:
            rec = {"arch": arch, "shape": shape_name, "ok": False,
                   "error": f"{type(e).__name__}: {e}",
                   "trace": traceback.format_exc()[-2000:]}
        results.append(rec)
        status = "ok" if rec.get("ok") else "FAIL"
        print(f"[dryrun] {arch} x {shape_name} ({mesh_name}): {status}",
              flush=True)
        if not rec.get("ok"):
            print(rec.get("error"), flush=True)

    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"[dryrun] wrote {args.out}")
    ok = sum(1 for r in results if r.get("ok"))
    print(f"[dryrun] {ok}/{len(results)} cells passed")
    return 0 if ok == len(results) else 1


if __name__ == "__main__":
    raise SystemExit(main())
