"""Plain PyTorch reference of the MAPF-GPT training step: the mean last-token
cross-entropy over an iteration's rows, its gradient, a global-norm clip and
AdamW on a warmup-cosine learning rate (the nanoGPT recipe of the MAPF-GPT
training configs, in optax's arithmetic: the clip divides by the norm with no
epsilon, the decay on matrices is added to the normalised update, the first
update uses the schedule's value at count 0, which is 0).

Returns the readings the benchmark compares: each step's loss, each leaf's
first (clipped) gradient and its norm, and the norm of each leaf's change after
the steps.
"""

from __future__ import annotations

import math

import torch

from perfbench.reference import gpt


def learning_rate(count: int, hp: dict) -> float:
    """Linear warmup from 0 to the peak, then cosine decay to the floor."""
    peak = hp["learning_rate"]
    warmup = min(hp["warmup_iters"], max(hp["lr_decay_iters"] // 10, 1))
    if count < warmup:
        return peak * count / warmup
    decay = max(hp["lr_decay_iters"], warmup + 1) - warmup
    frac = min(count - warmup, decay) / decay
    return hp["min_lr"] + (peak - hp["min_lr"]) * 0.5 * (1.0 + math.cos(math.pi * frac))


def run_steps(weights: dict, cfg: dict, hp: dict, batches: list, rows: int,
              precision: str = "fp32", half_batch: bool = False) -> dict:
    """The reference's readings over `batches` [(tokens [N, T], targets [N])],
    one step each.  With half_batch each step sees only the first half of its
    rows (a fault planted in the reference, for the limits' upper readings)."""
    params = {k: v.detach().clone() for k, v in weights.items() if k != "lm_head.weight"}
    start = {k: v.clone() for k, v in params.items()}
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    b1, b2 = hp["beta1"], hp["beta2"]
    losses, first_grad = [], {}
    for count, (tokens, targets) in enumerate(batches):
        if half_batch:
            tokens, targets = tokens[:len(tokens) // 2], targets[:len(targets) // 2]
        total, grads = gpt.loss_and_grads(params, tokens, targets, cfg, rows, precision)
        n = len(tokens)
        losses.append(float(total) / n)
        grads = {k: g / n for k, g in grads.items()}
        norm = math.sqrt(sum(float((g.double() ** 2).sum()) for g in grads.values()))
        if norm >= hp["grad_clip"]:
            grads = {k: g / norm * hp["grad_clip"] for k, g in grads.items()}
        if count == 0:
            first_grad = {k: float(g.double().norm()) for k, g in grads.items()}
            first_vectors = {k: g.clone() for k, g in grads.items()}
        lr = learning_rate(count, hp)
        t = count + 1
        for k, p in params.items():
            g = grads[k]
            mu[k] = b1 * mu[k] + (1.0 - b1) * g
            nu[k] = b2 * nu[k] + (1.0 - b2) * g * g
            u = (mu[k] / (1.0 - b1 ** t)) / (torch.sqrt(nu[k] / (1.0 - b2 ** t)) + 1e-8)
            if p.ndim >= 2:
                u = u + hp["weight_decay"] * p
            params[k] = p - lr * u
    change = {k: float((params[k] - start[k]).double().norm()) for k in params}
    return {"losses": losses, "first_grad": first_grad, "first_grad_vectors": first_vectors,
            "change": change}


def gaps(prog: dict, ref: dict) -> dict[str, float]:
    """The compared numbers of a training cell, each by its worst case:

    - ``loss_gap``: the largest relative gap of a step's loss;
    - ``grad_gap``: over leaves, the gap between the program's and the
      reference's norms of the first gradient, over the larger of the
      reference's norm of that leaf and of the median leaf;
    - ``grad_diff``: the same of the norm of the difference of the two first
      gradients, where `prog` holds them (``first_grad_vectors``): a batch
      left half out moves the norm only at second order, the difference at
      first;
    - ``change_gap``: as ``grad_gap``, of the change of the parameters, over
      the leaves whose reference gradient is at least a thousandth of the
      median leaf's (the others move by round-off under AdamW's normalisation
      alone)."""
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"]))
    g_median = float(torch.tensor(list(ref["first_grad"].values()), dtype=torch.float64)
                     .median())

    def worst(key: str, keep) -> float:
        ref_norms = {k: ref[key][k] for k in keep}
        median = float(torch.tensor(list(ref_norms.values()), dtype=torch.float64).median())
        return max(abs(prog[key][k] - r) / max(r, median) for k, r in ref_norms.items())

    moving = [k for k, g in ref["first_grad"].items() if g >= 1e-3 * g_median]
    out = {"loss_gap": loss, "grad_gap": worst("first_grad", list(ref["first_grad"]))}
    if "first_grad_vectors" in prog:
        vectors = ref["first_grad_vectors"]
        out["grad_diff"] = max(
            float((prog["first_grad_vectors"][k].to(r.device).double() - r.double()).norm())
            / max(ref["first_grad"][k], g_median) for k, r in vectors.items())
    out["change_gap"] = worst("change", moving)
    return out
