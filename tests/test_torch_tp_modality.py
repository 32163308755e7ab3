"""The modality stubs under a rank context, on the CPU: reduced
musicgen-medium (K codebook tables (K, V, d) and K heads, split on the
vocab: the lookup masked and all-reduced, the logits and the loss
vocab-parallel) and reduced paligemma-3b (a prefix of patch embeddings
through ``vision_proj``, whole on the model axis, its labels (B, P + S);
its single KV head, whose columns a model axis cuts inside the head, so
k and v are gathered beside its split query heads) in the partitioned
training step against the
one-device step, in the tensor-parallel prefill and a decode step under
a rank context against one device, and against the reference's own
partitioned programs in one subprocess of forced JAX devices, with XLA's
own resharding pinned beside the port's ledger (ROADMAP R15).  Neither
reaches the disaggregated engine (R9, R10), so the TP prefill is gated
through ``TensorParallelPrefill`` directly.

The helpers are ``tests/test_torch_tp_recurrent.py``'s; torch runs on one
thread in this module.  Tolerances are fp32's, stated with each test."""
import pytest

from repro_torch import sharding as shd
from repro_torch.configs import get_config
from repro_torch.models import model
from test_torch_tp_recurrent import (MODES, check_against_reference,
                                     check_cell_against_reference,
                                     check_decode, check_partitioned_step,
                                     check_tp_against_reference,
                                     check_tp_prefill, run_reference)
from test_torch_tp_recurrent import one_torch_thread  # noqa: F401 (autouse)

ARCHS = ("musicgen-medium", "paligemma-3b")


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
@pytest.mark.parametrize("arch", ARCHS)
def test_partitioned_step_equals_one_device(arch, shape, mode, fsdp):
    """TP alone and TP with DP, in Sentinel's four modes at MI 1, FSDP off
    and on, B 4 x S 16 (paligemma with its 4-patch prefix and labels
    over P + S rows): losses and gradient norms within 1e-5 of one
    device's, every parameter within 1e-5."""
    check_partitioned_step(arch, shape, mode, fsdp)


@pytest.mark.parametrize("n", [2, 4])
def test_the_vocab_and_head_cuts(n):
    """At full width under ``serve_rules`` at n model ranks: musicgen's
    table and head (4, 2048, 1536) split their vocab (``(None, "model",
    None)``), so each rank holds every codebook's block; paligemma's 8
    query heads split whole, while ``wk``'s (2048, 256) columns, its one
    KV head, split inside the head (256 / n of its 256 dims), so the rank
    program gathers k and v; ``vision_proj`` (``embed`` on both dims) is
    whole."""
    rules = shd.serve_rules(shd.Mesh((n,), ("model",)))
    for arch in ARCHS:
        cfg = get_config(arch)
        axes = model.param_axes(cfg)
        named = dict(model.init_params(cfg, device="meta")
                     .named_parameters())

        def spec(name):
            return shd.sharding_for(tuple(named[name].shape), axes[name],
                                    rules).spec

        if arch == "musicgen-medium":
            assert named["table"].shape == (4, 2048, 1536)
            assert spec("table") == spec("head") == (None, "model", None)
        else:
            assert named["layers.0.attn.wk"].shape == (2048, 256)
            assert spec("layers.0.attn.wk") == (None, "model")
            assert 256 // n < cfg.head_dim == 256
            assert spec("layers.0.attn.wq") == (None, "model")
            assert (cfg.num_heads * cfg.head_dim // n) % cfg.head_dim == 0
            assert spec("vision_proj") == (None, None)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_tp_prefill_equals_the_one_device_prefill(arch, n):
    """A 12-token prompt (paligemma's behind its 4 patches, max_seq 32)
    on ``[cpu] * n`` against ``model.prefill`` on one device: the last
    row's logits ((1, K, V) for musicgen) and every cache leaf within
    1e-4, the KV joined over the heads where the rules split them; a
    decode step from the joined caches within 1e-4."""
    check_tp_prefill(arch, n)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_under_a_rank_context_equals_one_device(arch, n):
    """One decode step of 2 slots on every rank under ``serve_rules``
    from a prefilled cache cut into each rank's blocks: the ranks' vocab
    blocks of the logits and their cache blocks, joined, within 1e-4 of
    one device's."""
    check_decode(arch, n)


# (name, the train cell's (data, model) mesh, its B x S, TP prefill sizes)
REF_CASES = (("musicgen-medium", (2, 2), (8, 64), (2, 4)),
             ("paligemma-3b", (2, 2), (8, 64), (2, 4)))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref_modality")
    return run_reference(out, REF_CASES), out


# XLA's collective bytes of the reference's compiled train cells on this
# JAX (0.9.0, forced CPU devices) beside the port's ledger of the same
# step (ROADMAP R15)
XLA_TRAIN = {
    "musicgen-medium": {"all-reduce": 2062120.0},
    "paligemma-3b": {"all-gather": 139264.0, "all-reduce": 1610892.0,
        "all-to-all": 104448.0, "collective-permute": 52224.0}}
PORT_TRAIN = {
    "musicgen-medium": {"all-reduce": 1602824.0},
    "paligemma-3b": {"all-gather": 139264.0, "all-reduce": 1196488.0,
        "reduce-scatter": 34816.0}}


@pytest.mark.parametrize("name", ARCHS)
def test_partitioned_step_equals_the_reference(reference, name):
    """From the reference's parameters and batch on (2, 2), offload at MI
    1: loss within 1e-5 and grad_norm within 1e-5 of it of the
    reference's compiled cell, every updated parameter within 1e-4."""
    check_against_reference(reference, name, (2, 2), XLA_TRAIN[name],
                            PORT_TRAIN[name])


XLA_TP = {
    ("musicgen-medium", 2): {"all-reduce": 24576.0},
    ("musicgen-medium", 4): {"all-gather": 8192.0, "all-reduce": 24576.0,
        "all-to-all": 1536.0, "collective-permute": 768.0},
    ("paligemma-3b", 2): {"all-gather": 8192.0, "all-reduce": 19456.0,
        "all-to-all": 2048.0, "collective-permute": 1024.0},
    ("paligemma-3b", 4): {"all-gather": 8192.0, "all-reduce": 19456.0,
        "all-to-all": 1024.0, "collective-permute": 1280.0}}
PORT_TP = {
    ("musicgen-medium", 2): {"all-reduce": 15360.0},
    ("musicgen-medium", 4): {"all-gather": 6144.0, "all-reduce": 15360.0},
    ("paligemma-3b", 2): {"all-gather": 4096.0, "all-reduce": 19456.0},
    ("paligemma-3b", 4): {"all-gather": 4096.0, "all-reduce": 19456.0}}


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", ARCHS)
def test_tp_prefill_equals_the_reference(reference, name, n):
    """The last row's logits within 1e-4 of the reference's TP prefill
    over n forced devices, from its parameters and prompt."""
    check_tp_against_reference(reference, name, n, XLA_TP[name, n],
                               PORT_TP[name, n])


XLA_CELLS = {
    ("musicgen-medium", "prefill"): {"all-reduce": 65536.0},
    ("musicgen-medium", "decode"): {"all-reduce": 4096.0},
    ("paligemma-3b", "prefill"): {"all-gather": 10240.0, "all-reduce": 49152.0,
        "all-to-all": 5120.0, "collective-permute": 2560.0},
    ("paligemma-3b", "decode"): {"all-gather": 8192.0, "all-reduce": 2560.0,
        "all-to-all": 256.0, "collective-permute": 128.0}}
PORT_CELLS = {
    ("musicgen-medium", "prefill"): {"all-reduce": 40960.0},
    ("musicgen-medium", "decode"): {"all-reduce": 2560.0},
    ("paligemma-3b", "prefill"): {"all-gather": 10240.0,
        "all-reduce": 49152.0},
    ("paligemma-3b", "decode"): {"all-gather": 8704.0, "all-reduce": 2560.0}}


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("name", ARCHS)
def test_dryrun_cell_collectives_beside_the_reference(reference, name,
                                                      kind):
    """The dry run's serve cells at (2, 2), B 4 x S 16, beside the
    reference's compiled cells."""
    check_cell_against_reference(reference, name, kind,
                                 XLA_CELLS[name, kind],
                                 PORT_CELLS[name, kind])
