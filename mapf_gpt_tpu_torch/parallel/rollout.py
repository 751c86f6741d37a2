"""Batched rollout: env -> tokens -> policy -> act -> step, for B envs.

Port of ``mapf_gpt_tpu/parallel/rollout.py`` (``_tokens_of``,
``make_batch_rollout``, ``batch_reset``).  The JAX package scans the episode
inside one jitted call; here a Python loop runs ``max_episode_steps`` steps,
each one tokenize -> one policy forward over all B*A contexts (on CUDA one
launch of the fused kernel) -> act -> step.  Input masking (``mask_cfg``)
waits for a port of ``ops/masking.py``.
"""

from __future__ import annotations

from typing import Callable

import torch

from mapf_gpt_tpu_torch.envs import env as menv
from mapf_gpt_tpu_torch.envs.metrics import EpisodeMetrics, episode_metrics
from mapf_gpt_tpu_torch.models.gpt import GPT, act, make_forward
from mapf_gpt_tpu_torch.ops.obs import observe


def _tokens_of(state: menv.EnvState) -> torch.Tensor:
    """int32 [B, A, 256] contexts of every agent."""
    return observe(menv.current_c2g(state), state.pos, state.goal, state.hist,
                   state.active)


def make_batch_rollout(spec: menv.MapfEnvSpec, model: GPT, do_sample: bool = True,
                       policy_batch: int | None = None) -> Callable:
    """Build a full-episode runner over a batch of env instances.

    Returns run(states, generator=None) -> (final_states, EpisodeMetrics)
    with per-env metrics.  The policy forward takes all B*A contexts of a
    step at once, or `policy_batch` contexts at a time to bound memory."""
    forward = make_forward(model)

    def policy(tokens2d: torch.Tensor) -> torch.Tensor:
        if policy_batch is None or tokens2d.shape[0] <= policy_batch:
            return forward(tokens2d)
        return torch.cat([forward(c) for c in tokens2d.split(policy_batch)])

    @torch.no_grad()
    def run(states: menv.EnvState, generator: torch.Generator | None = None
            ) -> tuple[menv.EnvState, EpisodeMetrics]:
        b, a = states.pos.shape[:2]
        for _ in range(spec.max_episode_steps):
            logits = policy(_tokens_of(states).reshape(b * a, -1))
            actions = act(logits, generator, do_sample=do_sample)
            states = menv.step(spec, states, actions.reshape(b, a))
        return states, episode_metrics(states)

    return run


def batch_reset(spec: menv.MapfEnvSpec, grids, starts, goals, actives,
                device: str | torch.device = "cuda") -> menv.EnvState:
    """Reset over stacked instance arrays (grids [B,H,W], starts/goals
    [B,A,2], actives [B,A]) on `device`."""
    return menv.reset(spec, grids, starts, goals, actives, device=device)
