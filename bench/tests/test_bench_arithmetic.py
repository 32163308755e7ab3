"""The yardstick's arithmetic on hand-worked cases: FLOPs and bytes from
shapes, the K1 roofline bound, the rate, the median and the idle share."""
import pytest

from benchkit import flops, stats, trace

# a toy decoder: d 4, 2 query heads and 1 KV head of 2, ffn 8, vocab 10,
# 3 layers
TOY = {"hidden_size": 4, "num_attention_heads": 2, "num_key_value_heads": 1,
       "head_dim": 2, "intermediate_size": 8, "vocab_size": 10,
       "num_hidden_layers": 3}


def test_matmul_params_by_hand():
    # wq 4x4, wk 4x2, wv 4x2, wo 4x4, gate/up 4x8, down 8x4
    assert flops.layer_matmul_params(TOY) == 16 + 8 + 8 + 16 + 96
    assert flops.body_matmul_params(TOY) == 3 * 144
    assert flops.head_params(TOY) == 40
    # 2 flops a pair for the score and 2 for the value, per head and layer
    assert flops.attn_pair_flops(TOY) == 4 * 2 * 2 * 3


def test_train_step_counts_half_the_square():
    B, S = 2, 5
    fwd = 2 * (B * S * 432 + B * S * 40) + B * S * S / 2 * 48
    assert flops.train_step_flops(TOY, B, S) == pytest.approx(3 * fwd)


def test_decode_flops():
    # two slots of 3 and 7 tokens of context: one row each
    assert flops.decode_step_flops(TOY, [3, 7]) == pytest.approx(
        2 * 2 * (432 + 40) + 10 * 48)


def test_paged_decode_bound_takes_the_largest():
    kv = flops.kv_bytes_per_token(TOY)          # 2 * 1 * 2 * 2 B
    assert kv == 8
    # hot only: bytes at HBM's rate
    t = flops.paged_decode_bound_s(TOY, [100, 50], [0, 0])
    qo = 2 * 2 * 2 * 2 * 2
    assert t == pytest.approx((150 * kv + qo) / flops.PEAK_HBM_BYTES)
    # cold pages dominate at the host link's rate
    t = flops.paged_decode_bound_s(TOY, [16, 16], [4096, 4096])
    assert t == pytest.approx(8192 * kv / flops.PEAK_PCIE_BYTES)


def test_rate_and_median():
    assert stats.rate(1000, 4.0) == 250.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)
    xs = list(range(1, 11))                       # 1..10
    assert stats.median(xs) == pytest.approx(5.5)


def test_idle_share_shows_a_stall():
    # device busy [0, 1) and [3, 4) in a window [0, 5): a 2 s stall inside
    busy = [(0.0, 1.0), (0.5, 0.8), (3.0, 4.0)]
    assert stats.union_length(busy) == pytest.approx(2.0)
    assert stats.gaps(busy, 0.0, 5.0) == [(1.0, 3.0), (4.0, 5.0)]


def test_trace_summary_names_gaps_by_host_span():
    us = 1e6
    dev = [(0, 1 * us, "kernelA"), (4 * us, 6 * us, "kernelB"),
           (-2 * us, -1 * us, "before")]
    spans = [(-3 * us, 7 * us, "window"), (0, 2 * us, "decode_step"),
             (2 * us, 4 * us, "plan")]
    s = trace.summarize(dev, 0.0, 5 * us, spans)
    assert s["busy_s"] == pytest.approx(2.0)
    assert s["window_s"] == pytest.approx(5.0)
    # an operation is clipped to the window; one outside it is left out
    assert s["ops"] == pytest.approx({"kernelA": 1.0, "kernelB": 1.0})
    # [1, 2) under decode_step, [2, 4) under plan
    assert s["idle"] == pytest.approx({"decode_step": 1.0, "plan": 2.0})
    b = trace.breakdown(s)
    assert b["idle_gaps"][0] == ["plan", pytest.approx(2.0)]
    assert trace.summarize(dev[2:], 0.0, 5 * us, spans) == {}
    assert trace.device_seconds(s, "kernelB") == pytest.approx(1.0)
