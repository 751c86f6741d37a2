"""Rollouts: env -> tokens -> policy -> act -> step, for B envs.

Port of ``mapf_gpt_tpu/parallel/rollout.py``.  The JAX package scans an
episode inside one jitted call; here a Python loop runs the steps, each one
tokenize (with the input masks, when asked) -> one policy forward over all
B*A contexts (on CUDA one launch of the fused kernel) -> act -> step.

- :func:`replay_rollout` replays a fixed commanded-action sequence through
  one instance, returning its positions and token contexts at every step
  (parity tests).
- :func:`make_batch_rollout` runs B instances for a whole episode and
  returns the per-env metrics.
- :func:`make_recorded_rollout` runs one instance and also returns its
  trajectory (animation export).
- :func:`batch_reset` resets stacked instances.

The policy is a ``models.gpt.GPT`` or a ``models.moonlight.MoonlightPolicy``;
``models.gpt.make_forward`` gives each family's forward.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Callable

import torch

from mapf_gpt_tpu_torch.envs import env as menv
from mapf_gpt_tpu_torch.envs.metrics import EpisodeMetrics, episode_metrics
from mapf_gpt_tpu_torch.models.gpt import GPT, act, make_forward
from mapf_gpt_tpu_torch.ops.masking import MaskConfig, apply_masks
from mapf_gpt_tpu_torch.ops.obs import observe
from mapf_gpt_tpu_torch.utils.profiling import span

if TYPE_CHECKING:
    from mapf_gpt_tpu_torch.models.moonlight import MoonlightPolicy


def _tokens_of(state: menv.EnvState, mask_cfg: MaskConfig | None = None) -> torch.Tensor:
    """int32 [B, A, 256] contexts of every agent, masked as `mask_cfg` says
    (the reference's input-ablation switches, right after tokenization)."""
    tokens = observe(menv.current_c2g(state), state.pos, state.goal, state.hist,
                     state.active)
    if mask_cfg is not None and mask_cfg.any:
        tokens = apply_masks(tokens, mask_cfg)
    return tokens


@torch.no_grad()
def replay_rollout(spec: menv.MapfEnvSpec, state: menv.EnvState,
                   actions_seq: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Replay commanded actions through one env instance (a batch of one).

    actions_seq: int [S, A].  Returns (positions [S+1, A, 2], tokens [S+1,
    A, 256]); index 0 is the state after reset."""
    positions, tokens = [], []
    for acts in actions_seq:
        positions.append(state.pos[0])
        tokens.append(_tokens_of(state)[0])
        state = menv.step(spec, state, acts[None])
    positions.append(state.pos[0])
    tokens.append(_tokens_of(state)[0])
    return torch.stack(positions), torch.stack(tokens)


def make_batch_rollout(spec: menv.MapfEnvSpec, model: GPT | MoonlightPolicy,
                       do_sample: bool = True, policy_batch: int | None = None,
                       mask_cfg: MaskConfig | None = None) -> Callable:
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
            with span("mapf.rollout.step"):
                logits = policy(_tokens_of(states, mask_cfg).reshape(b * a, -1))
                actions = act(logits, generator, do_sample=do_sample)
                states = menv.step(spec, states, actions.reshape(b, a))
        return states, episode_metrics(states)

    return run


def batch_reset(spec: menv.MapfEnvSpec, grids, starts, goals_queues, actives,
                device: str | torch.device = "cuda") -> menv.EnvState:
    """Reset over stacked instance arrays (grids [B,H,W], starts [B,A,2],
    goal queues [B,A,K,2] or one goal each [B,A,2], actives [B,A]) on
    `device`."""
    return menv.reset(spec, grids, starts, goals_queues, actives, device=device)


def make_recorded_rollout(spec: menv.MapfEnvSpec, model: GPT | MoonlightPolicy,
                          do_sample: bool = True, mask_cfg: MaskConfig | None = None) -> Callable:
    """Single-instance episode runner that also records the trajectory.

    Returns run(state, generator=None) -> (final_state, metrics, positions
    [T+1, A, 2]) for a state of one instance (batch of one), for animation
    export (eval/animation.py) and trajectory-parity tests."""
    forward = make_forward(model)

    @torch.no_grad()
    def run(state: menv.EnvState, generator: torch.Generator | None = None):
        positions = [state.pos[0]]
        for _ in range(spec.max_episode_steps):
            with span("mapf.rollout.step"):
                logits = forward(_tokens_of(state, mask_cfg)[0])
                actions = act(logits, generator, do_sample=do_sample)
                state = menv.step(spec, state, actions[None])
            positions.append(state.pos[0])
        return state, episode_metrics(state), torch.stack(positions)

    return run
