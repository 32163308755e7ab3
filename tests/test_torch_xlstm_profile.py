"""The xLSTM and LSTM stacks' profiles and CLIs (xlstm-1.3b, the paper's
lstm-ptb, reduced): test_system.py's Fig. 10 shape on the port's own
profile of lstm-ptb, with the MI each package plans pinned; the meta
device's profile through the LSTM and mLSTM loops; the training and
serving CLIs on both archs.  Kept apart from ``tests/test_torch_xlstm.py``
(its parity tests) so that the test runner's workers share the two
files' time."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import runtime as ref_runtime
from repro.configs.base import get_config as ref_config
from repro.core import offload as ref_offload
from repro.core import profiler as ref_profiler
from repro.core.hardware import PAPER_HM as REF_PAPER_HM
from repro.models import model as ref_model
from repro.models.layers import split_params
from repro_torch import runtime
from repro_torch.configs import get_config
from repro_torch.core import offload
from repro_torch.core.hardware import PAPER_HM
from repro_torch.launch.train import profile_step
from test_torch_xlstm import ARCHS, ROOT, chunk_mode  # noqa: F401 (fixture)
from test_torch_xlstm import one_torch_thread  # noqa: F401 (autouse)


def test_fig10_shape_on_the_port_profile():
    """test_system.py's Fig. 10 shape (lstm-ptb reduced, B 4 x S 32, the
    paper's machine) on each package's own profile: fast-only <= Sentinel
    <= 1.5 x slow-only and Sentinel no worse than IAL at 0.3 of the peak.
    The MI each plans is pinned: both fit MI 1 at 0.3 of the peak (ROADMAP
    D1 is about the reference's stacked weights, which this two-layer
    stack of one period slot does not lift past the budget)."""
    cfg_t = get_config("lstm-ptb").reduced()
    prof = profile_step(cfg_t, 4, 32)
    peak = prof.peak_bytes()
    fast = runtime.simulate(prof, PAPER_HM, 0.0, "all_fast").step_time
    slow = runtime.simulate(prof, PAPER_HM, 0.0, "all_slow").step_time
    plan = runtime.plan(prof, PAPER_HM, 0.3 * peak)
    ial = runtime.simulate(prof, PAPER_HM, 0.3 * peak, "ial").step_time
    assert fast <= plan.sim.step_time <= slow * 1.5
    assert plan.sim.step_time <= ial

    cfg_j = ref_config("lstm-ptb").reduced()
    params_j, _ = split_params(ref_model.init_params(jax.random.PRNGKey(0),
                                                     cfg_j))
    pshapes = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                           params_j)
    batch_s = {k: jax.ShapeDtypeStruct((4, 32), jnp.int32)
               for k in ("tokens", "labels")}
    prof_j = ref_profiler.trace_profile(
        jax.grad(lambda p, b: ref_model.loss_fn(p, cfg_j, b,
                                                unroll_periods=True)),
        pshapes, batch_s, num_periods=cfg_j.num_periods)
    plan_j = ref_runtime.plan(prof_j, REF_PAPER_HM, 0.3 * prof_j.peak_bytes())
    assert ref_offload.from_plan(prof_j, plan_j).mi_periods == 1
    assert offload.from_plan(prof, plan).mi_periods == 1


@pytest.mark.parametrize("arch", ARCHS)
def test_profile_traces_the_recurrences(arch, chunk_mode):
    """trace_profile on the meta device through the LSTM and mLSTM loops
    (sequential and chunked): every forward and backward period is
    present, each with its products."""
    cfg = get_config(arch).reduced()
    for chunk in (0, 8):
        chunk_mode(chunk)
        prof = profile_step(cfg, 2, 16)
        P = prof.num_periods
        assert P == cfg.num_periods == 2
        fwd = [s for s in prof.layers if 1 <= s <= P]
        bwd = [s for s in prof.layers if P + 2 <= s <= 2 * P + 1]
        assert len(fwd) == len(bwd) == P
        assert all(prof.layers[s].flops > 0 for s in fwd + bwd)


# ------------------------------------------------------------------ CLIs ----

@pytest.mark.parametrize("arch", ARCHS)
def test_training_and_serving_clis(arch, tmp_path):
    """python -m repro_torch.launch.train and .serve --arch <arch>
    --reduced --device cpu exit 0 (the trainer profiles, plans on
    H100_COST and trains; its losses are finite)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         "--reduced", "--device", "cpu", "-n", "4"], capture_output=True,
        text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert f"[serve] {arch}: 16 tokens in" in res.stdout
    from repro_torch.launch import train
    out = train.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--steps", "2", "--seq", "16", "--batch", "2",
                      "--ckpt-dir", str(tmp_path)])
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
