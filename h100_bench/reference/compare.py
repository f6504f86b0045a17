"""The comparison that decides ``correct``: the numbers below, each held
to the limit that the configuration file states for it (``limits``; a
number without a limit there is read, by calibrate.py, and not held).

Eval cells: for every clip served in the window (its last request), the
widest gap between the program's output and the reference's, over a_theta,
the 7 + 7 heads and card, as a share of the reference tensor's largest
magnitude (``out_rel_gap``); the count of actors whose decoded group id
differs (``group_id_mismatches``).

Train cells (readings of the first updates, taken by set-up through the
window's own step): the widest relative gap of a micro-step's loss, over
all (``loss_rel_gap``) and over those before the first update
(``first_loss_rel_gap``); the gap between the program's and the
reference's norm of a leaf's first gradient as the optimizer got it and of
its change over the updates, against the reference's norm of that leaf or
of the median leaf, whichever is larger: by the worst leaf
(``grad_norm_gap``, ``change_norm_gap``) and the median one
(``median_grad_norm_gap``, ``median_change_norm_gap``). Leaves whose
reference gradient norm is under a thousandth of the median leaf's are
left out: they move under Adam by round-off alone.
"""
from __future__ import annotations

import contextlib
import statistics
from typing import Dict, List

import torch

NEGLIGIBLE = 1e-3


@contextlib.contextmanager
def precision(tf32: bool):
    """TF32 on (the control) or off (the reference) for matmuls and cuDNN,
    restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def flat_outputs(out) -> Dict[str, torch.Tensor]:
    """The outputs of an MGAR request that are compared, on the host:
    a_theta, the 7 + 7 heads, card and group_ids."""
    flat = {"a_theta": out.a_theta, "card": out.card,
            "group_ids": out.group_ids}
    for key in ("pose", "interaction", "sg_pose", "sg_interaction"):
        for i, t in enumerate(getattr(out, key)):
            flat[f"{key}[{i}]"] = t
    return {k: v.detach().cpu() for k, v in flat.items()}


def rel_gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    got, ref = got.double(), ref.double()
    scale = max(float(ref.abs().max()), 1e-30)
    return float((got - ref).abs().max()) / scale


def _check(name: str, value, limits: dict) -> dict:
    limit = limits.get(name)
    ok = limit is not None and value == value and value <= limit
    return {"name": name, "value": value, "limit": limit, "ok": bool(ok)}


def eval_numbers(got: Dict[int, dict], want: Dict[int, dict]) -> dict:
    # a window that served nothing has nothing right
    worst, mism = (0.0 if want else float("inf")), 0
    for idx, ref in want.items():
        out = got[idx]
        for name, r in ref.items():
            if name == "group_ids":
                mism += int((out[name] != r).sum())
            else:
                worst = max(worst, rel_gap(out[name], r))
    return {"out_rel_gap": worst, "group_id_mismatches": mism}


def eval_checks(got, want, limits: dict) -> List[dict]:
    nums = eval_numbers(got, want)
    return [_check(k, v, limits) for k, v in nums.items()
            if k in limits]


def _leaf_gaps(got: List[float], ref: List[float],
               keep: List[bool]) -> List[float]:
    """Each kept leaf's gap of norms against the larger of its reference
    norm and the median kept leaf's (0 for a leaf left out)."""
    kept = [r for r, k in zip(ref, keep) if k]
    med = statistics.median(kept) if kept else 0.0
    return [abs(g - r) / max(r, med, 1e-30) if k else 0.0
            for g, r, k in zip(got, ref, keep)]


def train_readings(model, params, adam, micro_step, steps: int,
                   first_window: int, pool: int) -> dict:
    """Readings of a training run's first ``steps`` micro-steps, each
    ``micro_step(i % pool)`` returning its metrics: each micro-step's loss;
    each trainable leaf's first gradient norm as the optimizer got it,
    from ``adam``'s first moment after its first update at micro-step
    ``first_window`` (the moment is then (1 - b1) g); and each leaf's
    change over the micro-steps. The program's driver and the reference
    read alike."""
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    start = [p.detach().clone() for p in params]
    losses, first_grad = [], None
    for i in range(steps):
        losses.append(float(micro_step(i % pool)["loss"]))
        if i + 1 == first_window:
            first_grad = [float(adam.state[p]["exp_avg"].norm() / 0.1)
                          if p in adam.state else 0.0 for p in params]
    change = [float((p.detach() - q).norm()) for p, q in zip(params, start)]
    return {"names": names, "losses": losses, "grad_norms": first_grad,
            "change_norms": change, "first_window": first_window}


def train_numbers(got: dict, want: dict) -> dict:
    if got["names"] != want["names"]:
        raise ValueError("the program's and the reference's trainable "
                         "leaves differ")
    gaps = [abs(a - b) / max(abs(b), 1e-30)
            for a, b in zip(got["losses"], want["losses"])]
    first = want["first_window"]
    ref_g = want["grad_norms"]
    med = statistics.median(ref_g)
    keep = [r >= NEGLIGIBLE * med for r in ref_g]
    grad = _leaf_gaps(got["grad_norms"], ref_g, keep)
    change = _leaf_gaps(got["change_norms"], want["change_norms"], keep)
    names = want["names"]
    kept_grad = [g for g, k in zip(grad, keep) if k]
    kept_change = [g for g, k in zip(change, keep) if k]

    def worst(gap):
        order = sorted(range(len(gap)), key=lambda i: -gap[i])[:3]
        return [[names[i], gap[i]] for i in order]
    return {"loss_rel_gap": max(gaps),
            "first_loss_rel_gap": max(gaps[:first]),
            "grad_norm_gap": max(grad),
            "median_grad_norm_gap": statistics.median(kept_grad),
            "change_norm_gap": max(change),
            "median_change_norm_gap": statistics.median(kept_change),
            "worst_grad_leaves": worst(grad),
            "worst_change_leaves": worst(change),
            "left_out_leaves": [n for n, k in zip(names, keep) if not k]}


def train_checks(got, want, limits: dict) -> List[dict]:
    nums = train_numbers(got, want)
    return [_check(k, v, limits) for k, v in nums.items() if k in limits]
