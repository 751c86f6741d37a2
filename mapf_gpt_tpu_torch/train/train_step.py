"""Training step: gradient accumulation, global-norm clip and AdamW on a
warmup-cosine schedule.

Port of ``mapf_gpt_tpu/train/train_step.py``, with the same semantics:

- AdamW(0.9, 0.95), eps 1e-8, weight decay 0.1 on parameters with two or
  more dimensions (the tied token embedding is one parameter), global-norm
  clip 1.0 before it;
- the learning rate of ``optax.warmup_cosine_decay_schedule`` with the JAX
  package's short-run clamp of the warmup; the first update uses lr(0) = 0,
  as optax's does;
- gradient accumulation: the micro-batches' gradients summed, then scaled
  by 1/grad_accum, the loss likewise;
- the loss: cross-entropy at the last position.  ``select_loss_fn`` makes
  the JAX package's choice: the fused kernels (``ops/fused_gpt_train.py``)
  on CUDA for bias-free, dropout-0 configs, the module with autograd
  elsewhere (the CPU, ``bias=True``).

The optimizer is written out rather than taken from ``torch.optim.AdamW``
so that its arithmetic is optax's: the clip divides by the norm with no
epsilon (``torch.nn.utils.clip_grad_norm_`` adds 1e-6), the decay is
added to the normalised update before the learning rate scales it, and the
schedule's count starts at 0.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from mapf_gpt_tpu_torch.models.gpt import GPT, uses_fused
from mapf_gpt_tpu_torch.utils.profiling import span


class TrainConfig(NamedTuple):
    """Optimization hyperparameters (the JAX package's defaults)."""

    learning_rate: float = 6e-4
    min_lr: float = 6e-5
    warmup_iters: int = 2000
    lr_decay_iters: int = 30000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    grad_accum: int = 16


def lr_schedule(tc: TrainConfig) -> Callable[[int], float]:
    """count -> learning rate: linear warmup from 0, then cosine decay to
    min_lr, the values of ``optax.warmup_cosine_decay_schedule`` with its
    fp32 arithmetic, step for step.  The warmup is clamped to 10 % of the
    decay horizon for short runs."""
    f32 = np.float32
    warmup = min(tc.warmup_iters, max(tc.lr_decay_iters // 10, 1))
    decay = max(tc.lr_decay_iters, warmup + 1) - warmup
    peak = tc.learning_rate
    alpha = 0.0 if peak == 0.0 else tc.min_lr / peak

    def schedule(count: int) -> float:
        if count < warmup:
            frac = f32(1) - f32(max(count, 0)) / f32(warmup)
            return float(f32(0.0 - peak) * frac + f32(peak))
        c = f32(min(count - warmup, decay))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * c / f32(decay)))
        return float(f32(peak) * (f32(1.0 - alpha) * cosine + f32(alpha)))

    return schedule


class AdamW:
    """optax.chain(clip_by_global_norm, adamw(mask=ndim >= 2)) on a list of
    parameters, updated in place."""

    def __init__(self, params: list[torch.Tensor], tc: TrainConfig):
        self.params = list(params)
        self.tc = tc
        self.schedule = lr_schedule(tc)
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def update(self, grads: list[torch.Tensor]) -> None:
        tc = self.tc
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        # clip: g / norm * max_norm unless norm < max_norm (no epsilon)
        clipped = [torch.where(norm < tc.grad_clip, g, g / norm * tc.grad_clip) for g in grads]
        lr = self.schedule(self.count)
        self.count += 1
        bc1 = 1.0 - tc.beta1 ** self.count
        bc2 = 1.0 - tc.beta2 ** self.count
        for p, g, m, v in zip(self.params, clipped, self.mu, self.nu):
            m.copy_((1.0 - tc.beta1) * g + tc.beta1 * m)
            v.copy_((1.0 - tc.beta2) * (g * g) + tc.beta2 * v)
            u = (m / bc1) / (torch.sqrt(v / bc2) + 1e-8)
            if p.ndim >= 2:
                u = u + tc.weight_decay * p
            p.add_(u * -lr)

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": [m.clone() for m in self.mu],
                "nu": [v.clone() for v in self.nu]}

    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        for dst, src in zip(self.mu + self.nu, list(state["mu"]) + list(state["nu"])):
            dst.copy_(src)


def make_optimizer(model: GPT, tc: TrainConfig) -> AdamW:
    """The optimizer over the model's parameters (the tied head once)."""
    return AdamW(list(model.parameters()), tc)


def loss_fn(model: GPT, tokens: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """tokens int [B, T]; targets int [B] (the expert's action id).  The
    module runs deterministic, as the JAX ``loss_fn`` applies it: a dropout
    config drops nothing here."""
    return F.cross_entropy(model(tokens), targets.long())


def select_loss_fn(model: GPT, use_fused: bool | None = None) -> Callable:
    """The fused kernels' loss on CUDA for bias-free, dropout-0 configs
    whose heads divide the width (``models.gpt.uses_fused``), the module's
    loss with autograd otherwise: the CPU, and ``bias=True`` on CUDA, whose
    Linears run on ``torch.matmul`` and whose attention is the plain
    version ("auto", "einsum"); "pallas" raises there, as the JAX kernel
    has no gradient."""
    if use_fused is None:
        use_fused = uses_fused(model.cfg, model.lm_head.weight.device.type)
    if use_fused:
        from mapf_gpt_tpu_torch.ops.fused_gpt_train import fused_loss_fn

        return lambda x, y: fused_loss_fn(model, x, y)
    return lambda x, y: loss_fn(model, x, y)


def make_train_step(model: GPT, tc: TrainConfig, optimizer: AdamW | None = None,
                    use_fused: bool | None = None,
                    sync: Callable[[list[torch.Tensor]], None] | None = None) -> Callable:
    """Returns train_step(tokens int [accum, B, T], targets int [accum, B])
    -> the mean loss (a 0-d tensor; reading it waits for the device).  It
    updates the model's parameters in place through `optimizer` (a new
    :func:`make_optimizer` if None).  `sync`, when given, is called once a
    step, after the accumulation, on the mean loss and the gradients, and
    reduces them in place across processes (``parallel/mesh.all_reduce_mean``)."""
    opt = optimizer or make_optimizer(model, tc)
    grad_loss = select_loss_fn(model, use_fused)
    scale = 1.0 / tc.grad_accum

    @span("mapf.train.step")
    def train_step(tokens: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        for p in opt.params:
            p.grad = None
        loss_sum = torch.zeros((), device=tokens.device)
        for x, y in zip(tokens, targets):
            with span("mapf.train.forward"):
                loss = grad_loss(x, y)
            with span("mapf.train.backward"):
                loss.backward()
            loss_sum = loss_sum + loss.detach()
        with span("mapf.train.optimizer"):         # with the all-reduce, where `sync` is given
            loss, grads = loss_sum * scale, [p.grad * scale for p in opt.params]
            if sync is not None:
                sync([loss, *grads])
            opt.update(grads)
        return loss

    train_step.optimizer = opt
    return train_step


def make_eval_step(model: GPT) -> Callable:
    """eval_step(tokens [B, T], targets [B]) -> (loss, accuracy) through the
    module, with no graph."""

    def eval_step(tokens: torch.Tensor, targets: torch.Tensor):
        with torch.inference_mode():
            logits = model(tokens)
            loss = F.cross_entropy(logits, targets.long())
            acc = (logits.argmax(-1) == targets.long()).float().mean()
        return loss, acc

    return eval_step
