"""The numbers that decide ``correct``: a run's outputs against the plain
reference's.

Training: the first clipped gradient
(as the optimizer's first moment holds it after one step) and the change
of the parameters after three steps, each as a norm per leaf, taken by the
worst leaf: the gap between the two norms against the reference's norm of
that leaf or of the median leaf, whichever is larger.  Leaves whose
reference gradient is under a thousandth of the median leaf's are left
out of both (they move by round-off alone).  Each of the first three
steps' loss is read beside them (``loss_gap``).

Serving: over a sample of the served tokens, the widest gap by which a
served token's reference logit lies below the reference's best at its
position."""
from __future__ import annotations

import statistics

import torch

SMALL_LEAF = 1e-3


def leaf_norms(tree: dict) -> dict:
    return {k: float(t.float().norm()) for k, t in tree.items()}


def worst_leaf_gap(prog: dict, ref: dict, keep) -> float:
    names = [k for k in ref if k in keep]
    floor = statistics.median(ref[k] for k in names)
    return max(abs(prog[k] - ref[k]) / max(ref[k], floor) for k in names)


def kept_leaves(raw_grad_norms: dict) -> set:
    med = statistics.median(raw_grad_norms.values())
    return {k for k, v in raw_grad_norms.items() if v >= SMALL_LEAF * med}


def train_checks(prog: dict, ref: dict, limits: dict) -> list:
    """``prog``/``ref``: {"losses": [3 floats], "grad": {leaf: norm},
    "change": {leaf: norm}}, ``ref`` also "raw_grad" {leaf: norm}."""
    keep = kept_leaves(ref["raw_grad"])
    return [("grad_gap", worst_leaf_gap(prog["grad"], ref["grad"], keep),
             limits["grad_gap"]),
            ("change_gap", worst_leaf_gap(prog["change"], ref["change"],
                                          keep), limits["change_gap"])]


def loss_gap(prog: dict, ref: dict) -> float:
    """The widest relative gap of the three steps' losses: read and
    printed, not compared (neither the control nor a fault the cell can
    have reads three or ten times what sound runs read; see PERF.md)."""
    return max(abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                    ref["losses"]))


def served_gap(ref_logits: torch.Tensor, served: torch.Tensor) -> float:
    """The widest gap, over the rows, between the best reference logit and
    the served token's (``ref_logits`` (n, V), ``served`` (n,))."""
    best = ref_logits.max(dim=-1).values
    got = ref_logits.gather(-1, served[:, None].long())[:, 0]
    return float((best - got).max())
