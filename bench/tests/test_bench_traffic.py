"""The traffic generators: a seed gives the same stream, lengths stay in
their bounds, and the seed changes the order and the ids, not the work."""
import json

import numpy as np

from bench_tiny import BENCH
from benchkit import traffic

CFG = {"vocab_size": 92544}


def mix(name):
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


def test_train_batches_repeat_and_differ():
    m = mix("train.offload")
    big = 2 ** 31 + 12345
    a = traffic.train_batch(m, CFG, big, 4)
    b = traffic.train_batch(m, CFG, big, 4)
    c = traffic.train_batch(m, CFG, big, 5)
    assert a["tokens"].shape == (8, 1024) and a["labels"].shape == (8, 1024)
    assert np.array_equal(a["tokens"], b["tokens"])
    assert not np.array_equal(a["tokens"], c["tokens"])
    # labels are the next token of each row
    assert np.array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    assert len({r.tobytes() for r in a["tokens"]}) == 8
    assert a["tokens"].min() >= 0 and a["tokens"].max() < CFG["vocab_size"]


def test_sessions_same_kv_for_every_seed():
    m = mix("serve.decode")
    runs = [traffic.sessions(m, CFG, s) for s in (1, 2, 2 ** 33 + 1)]
    lengths = [[len(t) for t, _ in r] for r in runs]
    assert sorted(lengths[0]) == sorted(lengths[1]) == sorted(lengths[2])
    assert lengths[0] != lengths[1]                    # another order
    assert all(n % 16 == 0 and 2048 <= n <= 6144 for n in lengths[0])
    assert len(set(lengths[0])) == 16
    assert sum(lengths[0]) == sum(traffic.session_lengths(m))
    again = traffic.sessions(m, CFG, 2)
    assert all(np.array_equal(a, b) for (a, _), (b, _) in zip(runs[1], again))
    assert all(a == m["answer_tokens"] for _, a in runs[0])
    assert max(len(t) + a for t, a in runs[0]) <= m["max_seq"]

