"""The port's tracer (``core.profiler.trace_profile``) against the
reference's on ``test_sentinel_core.py``'s config (smollm-360m cut to 8
layers of d_model 128, B 4 x S 64, fp32): the timeline, the period count,
the weight bytes and the matmul FLOPs equal the reference's; the paper's
observations 1-3, Table 5's footprint bound, RS stable across MI and every
forward and backward period present hold on the port's own profile, with
the limits ``test_sentinel_core.py`` asserts; and the MI each package plans
on its own profile (on the paper's machine at 0.3 of the peak), pinned;
the simulator's claims on the port's profile; and the profile -> plan ->
execute pipeline of ``test_system.py``.  Also zamba2-7b reduced (the SSD
scan's plain version under the trace)."""
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from repro import runtime as ref_runtime
from repro.configs.base import get_config as ref_config
from repro.core import offload as ref_offload
from repro.core import profiler as ref_profiler
from repro.core.hardware import PAPER_HM as REF_PAPER_HM
from repro.models import model as ref_model
from repro.models.layers import split_params
from repro_torch import runtime
from repro_torch.configs import get_config
from repro_torch.core import allocator, offload, profiler
from repro_torch.core.hardware import PAPER_HM
from repro_torch.launch.train import profile_step
from repro_torch.models import model

CORE = dict(num_layers=8, d_model=128, num_heads=8, num_kv_heads=4,
            d_ff=512, head_dim=16, vocab_size=1024, dtype="float32")


def _ref_dot_flops(jaxpr_eqns) -> float:
    """2 M N K over every dot_general of a jaxpr, calls included."""
    total = 0.0
    for eqn in jaxpr_eqns:
        subs = ref_profiler._sub_jaxprs(eqn)
        if subs:
            total += sum(_ref_dot_flops(s.eqns) for s in subs)
        elif eqn.primitive.name == "dot_general":
            total += ref_profiler._dot_flops(eqn)
    return total


def _both(cfg_j, cfg_t, B, S):
    """(reference profile, its dot FLOPs, port profile) of one step."""
    params, _ = split_params(ref_model.init_params(jax.random.PRNGKey(0),
                                                   cfg_j))
    pshapes = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                           params)
    batch = {k: jax.ShapeDtypeStruct((B, S), jnp.int32)
             for k in ("tokens", "labels")}
    fn = jax.grad(lambda p, b: ref_model.loss_fn(p, cfg_j, b,
                                                 unroll_periods=True))
    prof_j = ref_profiler.trace_profile(fn, pshapes, batch,
                                        num_periods=cfg_j.num_periods)
    dots_j = _ref_dot_flops(jax.make_jaxpr(fn)(pshapes, batch).jaxpr.eqns)
    prof_t = profiler.trace_profile(
        lambda p, b: model.loss_fn(p, cfg_t, b, unroll_periods=True),
        model.init_params(cfg_t, device="meta", requires_grad=True),
        {k: torch.empty(B, S, dtype=torch.int32, device="meta")
         for k in ("tokens", "labels")}, num_periods=cfg_t.num_periods)
    return prof_j, dots_j, prof_t


@pytest.fixture(scope="module")
def core():
    return _both(dataclasses.replace(ref_config("smollm-360m"), **CORE),
                 dataclasses.replace(get_config("smollm-360m"), **CORE),
                 4, 64)


@pytest.fixture(scope="module")
def prof(core):
    return core[2]


def test_timeline_periods_and_weights_match_reference(core):
    prof_j, _, prof_t = core
    assert prof_t.num_periods == prof_j.num_periods == 8
    assert prof_t.num_steps == prof_j.num_steps == 19
    assert sorted(prof_t.layers) == sorted(prof_j.layers)
    # parameters and the batch (the jaxpr's inputs) are the weights
    assert sum(o.size for o in prof_t.weights()) == \
        sum(o.size for o in prof_j.weights())
    assert all(o.birth == 0 for o in prof_t.weights())


def test_matmul_flops_match_reference(core):
    """Within 1% (they come out equal: the same products, forward and
    backward)."""
    _, dots_j, prof_t = core
    assert prof_t.matmul_flops == pytest.approx(dots_j, rel=0.01)
    assert prof_t.matmul_flops <= prof_t.total_flops


def test_observation1_short_lived_dominance(prof):
    """Paper Obs. 1: the large majority of data objects are short-lived."""
    short = prof.short_lived(include_fused=True)
    acts = [o for o in prof.objects if o.kind == "activation"]
    assert len(short) / len(acts) > 0.75


def test_observation2_hot_cold_skew(prof):
    """Paper Obs. 2: few objects account for most accesses."""
    acts = sorted((o for o in prof.objects if o.kind == "activation"),
                  key=lambda o: -o.reads)
    hot = acts[:len(acts) // 10]
    assert sum(o.reads for o in hot) > 0.2 * sum(o.reads for o in acts)


def test_observation3_false_sharing(prof):
    """Paper Obs. 3: bump allocation mixes short- and long-lived objects in
    the same pages."""
    assert allocator.false_sharing_stats(prof)["false_shared_pages"] > 0


def test_profiling_footprint_overhead_small(prof):
    """Paper Table 5: one-object-per-page grows the footprint only
    modestly; small objects blow up relatively."""
    o = allocator.profiling_overhead(prof)
    assert o["profiled_bytes"] > o["orig_bytes"]
    assert o["overhead_frac"] < 0.35
    assert o["small_obj_profiled_bytes"] > 2 * o["small_obj_bytes"]


def test_rs_stable_across_mi(prof):
    """Paper §4.4: RS is nearly constant in MI."""
    vals = [prof.rs_bytes(mi) for mi in (1, 2, 4, 8)]
    assert max(vals) <= min(vals) * 1.05 + 1


def test_timeline_layers_cover_fwd_and_bwd(prof):
    fwd = [s for s in prof.layers if 1 <= s <= prof.num_periods]
    bwd = [s for s in prof.layers
           if prof.num_periods + 2 <= s <= 2 * prof.num_periods + 1]
    assert len(fwd) == prof.num_periods
    assert len(bwd) == prof.num_periods
    # every period's forward and backward does its share of the products
    per = [prof.layers[s].flops for s in fwd + bwd]
    assert min(per) > 0.5 * max(per[:len(fwd)])


def test_planned_mi_on_each_profile_pinned(core):
    """Each package plans on its own profile.  They differ, so both values
    are pinned: the reference's stacked parameters give its profile
    objects the port's per-layer parameters do not have (each period's
    slice of a stacked weight, and that slice's gradient scattered into a
    zero array of the whole stack, ``add_any`` of (8, ...)), which lift
    its RS to 23.0 MB, above 0.3 of its peak (18.4 MB): no candidate fits,
    every candidate simulates the same step time, and the last-digit
    minimum picks MI 8.  The port's RS is 6.4 MB, MI 1 fits, and only MI 1
    fits."""
    prof_j, _, prof_t = core
    plan_j = ref_runtime.plan(prof_j, REF_PAPER_HM, 0.3 * prof_j.peak_bytes())
    plan_t = runtime.plan(prof_t, PAPER_HM, 0.3 * prof_t.peak_bytes())
    assert ref_offload.from_plan(prof_j, plan_j).mi_periods == 8
    assert offload.from_plan(prof_t, plan_t).mi_periods == 1
    assert not any(c.space_ok for c in plan_j.candidates)
    assert [c.mi for c in plan_t.candidates if c.space_ok] == [1]
    assert prof_j.rs_bytes(1) > 0.3 * prof_j.peak_bytes() > \
        prof_t.rs_bytes(1)


def test_simulator_claims_on_the_port_profile(prof):
    """test_system.py's Fig. 10 shape on the port's own profile:
    fast-only <= Sentinel <= 1.5 x slow-only and Sentinel no worse than
    IAL at 0.3 of the peak; and test_sentinel_core.py's "never beats
    fast-only" at 0.2, 0.4 and 0.8 of it.  Its "more fast memory never
    hurts" and headline-band claims do not hold on this profile: at 0.2
    of the peak no MI fits and plan_training simulates every MI, while
    from 0.25 it picks among the one or two that fit (PERF.md §7)."""
    peak = prof.peak_bytes()
    fast = runtime.simulate(prof, PAPER_HM, 0.0, "all_fast").step_time
    slow = runtime.simulate(prof, PAPER_HM, 0.0, "all_slow").step_time
    sent = runtime.plan(prof, PAPER_HM, 0.3 * peak).sim.step_time
    ial = runtime.simulate(prof, PAPER_HM, 0.3 * peak, "ial").step_time
    assert fast <= sent <= slow * 1.5
    assert sent <= ial
    for frac in (0.2, 0.4, 0.8):
        assert runtime.plan(prof, PAPER_HM, frac * peak).sim.step_time >= \
            fast * 0.999


@pytest.mark.parametrize("arch", ["smollm-360m", "zamba2-7b"])
def test_profile_plan_execute_pipeline(arch):
    """Mirrors test_system.py::test_profile_plan_execute_pipeline: profile
    one step on the meta device, plan, and run the planned config on real
    parameters: the MI tiles the stack, and the planned (offload) loss and
    its gradients equal the full mode's (fp32, at rounding: 1e-6)."""
    cfg = get_config(arch).reduced()
    prof = profile_step(cfg, 2, 16)
    scfg = offload.from_plan(prof, runtime.plan(prof, PAPER_HM,
                                                0.3 * prof.peak_bytes()))
    assert scfg.mode == "offload" and cfg.num_periods % scfg.mi_periods == 0
    params = model.init_params(cfg, device="cpu", requires_grad=True)
    batch = {k: torch.ones(2, 16, dtype=torch.int32)
             for k in ("tokens", "labels")}
    got = {}
    for kw in (offload.loss_kwargs(scfg), {}):
        loss = model.loss_fn(params, cfg, batch, **kw)
        got[bool(kw)] = (loss.detach(),
                         torch.autograd.grad(loss, list(params.parameters())))
    assert torch.isfinite(got[True][0])
    torch.testing.assert_close(got[True][0], got[False][0], atol=1e-6,
                               rtol=1e-6)
    for a, b in zip(got[True][1], got[False][1]):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


def test_trace_of_the_hybrid():
    """zamba2-7b reduced (B 2 x S 32): the same timeline and weight bytes
    as the reference's; the SSD scan's plain version runs under the trace,
    so its chunk tensors are objects.  Its three-operand einsums contract
    in another order than the reference's, so the products count 5.9 %
    more FLOPs there (held within 10 %)."""
    prof_j, dots_j, prof_t = _both(ref_config("zamba2-7b").reduced(),
                                   get_config("zamba2-7b").reduced(), 2, 32)
    assert sorted(prof_t.layers) == sorted(prof_j.layers)
    assert prof_t.num_steps == prof_j.num_steps
    assert sum(o.size for o in prof_t.weights()) == \
        sum(o.size for o in prof_j.weights())
    assert prof_t.matmul_flops == pytest.approx(dots_j, rel=0.10)
    assert any(o.prim == "cumsum" for o in prof_t.objects)


def test_trace_allocates_nothing_and_does_not_nest():
    cfg = dataclasses.replace(get_config("smollm-360m"), **CORE)
    params = model.init_params(cfg, device="meta", requires_grad=True)
    assert all(p.device.type == "meta" for p in params.parameters())
    batch = {k: torch.empty(1, 8, dtype=torch.int32, device="meta")
             for k in ("tokens", "labels")}

    def nested(p, b):
        profiler.trace_profile(lambda q, c: model.loss_fn(q, cfg, c), p, b,
                               num_periods=cfg.num_periods)

    with pytest.raises(RuntimeError, match="nest"):
        profiler.trace_profile(nested, params, batch,
                               num_periods=cfg.num_periods)
    x = torch.ones(2)
    assert profiler.mark(x, 1, 2) is x       # no tracer: the tensor itself
