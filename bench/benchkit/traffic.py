"""The general traffic generators.  A mix (``bench/traffic/<mix>.json``)
gives their parameters, and its ``driver`` and ``loop`` pick them; the seed
draws the tokens and the order, never the amount of work: every seed gets
the same set of sizes, in another order."""
from __future__ import annotations

import numpy as np


def rng(seed: int, *stream: int) -> np.random.Generator:
    """A generator for one stream of one seed (any non-negative whole
    number, 64 bits and more)."""
    return np.random.default_rng([int(seed), *stream])


def train_batch(mix: dict, cfg: dict, seed: int, step: int) -> dict:
    """Step ``step``'s batch: B rows of S + 1 uniform token ids, tokens the
    first S, labels the last S (every row and step differs)."""
    B, S = mix["batch"], mix["seq"]
    x = rng(seed, 1, step).integers(0, cfg["vocab_size"], (B, S + 1),
                                    dtype=np.int64)
    return {"tokens": x[:, :-1], "labels": x[:, 1:]}


def _paged(n: int, page: int) -> int:
    return max(page, int(round(n / page)) * page)


def session_lengths(mix: dict) -> list:
    """``n`` prompt lengths evenly spaced over [lo, hi], in whole pages."""
    p = mix["prompts"]
    return [_paged(x, p["page"])
            for x in np.linspace(p["lo"], p["hi"], p["n"])]


def sessions(mix: dict, cfg: dict, seed: int) -> list:
    """The sessions of a decode mix: [(prompt ids, answer budget)], the
    lengths of ``session_lengths`` permuted by the seed, the ids drawn
    from it."""
    g = rng(seed, 2)
    lengths = [session_lengths(mix)[i]
               for i in g.permutation(mix["prompts"]["n"])]
    return [(g.integers(0, cfg["vocab_size"], n, dtype=np.int64),
             mix["answer_tokens"]) for n in lengths]
