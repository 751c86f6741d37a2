"""The batched MAPF environment: functional reset/step over [B, ...] tensors.

Port of ``mapf_gpt_tpu/envs/env.py`` for one-shot MAPF
(``on_target="nothing"``, one goal per agent, dense cost2go fields): agents
stay on their goals, an env terminates when every active agent is on its
goal at once and truncates at ``max_episode_steps``.  The action history
records the *commanded* action.  An env's state is frozen once its episode
is over, so a fixed-length loop over ``max_episode_steps`` gives exact
metrics.  The lifelong mode (``restart``, queued goals, ``lazy_c2g``) is not
ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mapf_gpt_tpu_torch.envs.dynamics import step_positions
from mapf_gpt_tpu_torch.ops.cost2go import cost2go_device
from mapf_gpt_tpu_torch.ops.vocab import NUM_PREV_ACTIONS


class EnvState(NamedTuple):
    """State of B env instances; every tensor has a leading batch dim."""

    pos: torch.Tensor         # int32 [B, A, 2] padded coords
    goal: torch.Tensor        # int32 [B, A, 2]
    hist: torch.Tensor        # int32 [B, A, P] action symbols 0..5, oldest first
    t: torch.Tensor           # int32 [B] steps taken
    done: torch.Tensor        # bool [B] all active agents on goal (terminal)
    cost: torch.Tensor        # int32 [B, A] last timestep the agent was
                              # off-goal (0 incl. reset; -1 = never off-goal)
    ep_len: torch.Tensor      # int32 [B] step at which done fired (else max steps)
    grid: torch.Tensor        # bool [B, H, W] obstacles incl. border
    c2g: torch.Tensor         # int32 [B, A, H, W] cost2go field of each agent's goal
    active: torch.Tensor      # bool [B, A]


class MapfEnvSpec(NamedTuple):
    """Static configuration."""

    height: int
    width: int
    num_agents: int           # padded agent slot count A
    max_episode_steps: int = 128


def reset(spec: MapfEnvSpec, grids, starts, goals, active,
          device: str | torch.device = "cuda") -> EnvState:
    """Build the initial state and the dense cost2go fields on `device`.

    grids: bool [B, H, W]; starts, goals: int [B, A, 2]; active: bool
    [B, A] (numpy arrays or tensors).  Inactive (padding) slots should carry
    starts == goals on free cells; they never move and are masked out of
    observations."""
    grids = torch.as_tensor(grids, dtype=torch.bool, device=device)
    starts = torch.as_tensor(starts, device=device).to(torch.int32)
    goals = torch.as_tensor(goals, device=device).to(torch.int32)
    active = torch.as_tensor(active, dtype=torch.bool, device=device)
    b, a = starts.shape[:2]
    h, w = spec.height, spec.width
    if (tuple(grids.shape) != (b, h, w) or a != spec.num_agents
            or goals.shape != starts.shape or tuple(active.shape) != (b, a)):
        raise ValueError(
            f"reset: expected grids [B, {h}, {w}], starts/goals [B, "
            f"{spec.num_agents}, 2], active [B, {spec.num_agents}]; got "
            f"{tuple(grids.shape)}, {tuple(starts.shape)}, {tuple(goals.shape)}, "
            f"{tuple(active.shape)}")
    c2g = cost2go_device(
        grids[:, None].expand(b, a, h, w).reshape(b * a, h, w),
        goals.reshape(b * a, 2)).reshape(b, a, h, w)
    settled = (starts == goals).all(-1) | ~active
    return EnvState(
        pos=starts,
        goal=goals,
        hist=torch.zeros((b, a, NUM_PREV_ACTIONS), dtype=torch.int32,
                         device=device),                   # 'n' * P
        t=torch.zeros((b,), dtype=torch.int32, device=device),
        done=settled.all(-1),
        cost=torch.where(settled, -1, 0).to(torch.int32),
        ep_len=torch.full((b,), spec.max_episode_steps, dtype=torch.int32,
                          device=device),
        grid=grids,
        c2g=c2g,
        active=active,
    )


def current_c2g(state: EnvState) -> torch.Tensor:
    """The [B, A, H, W] cost2go fields of each agent's current goal (with
    one goal per agent, the fields computed at reset)."""
    return state.c2g


def step(spec: MapfEnvSpec, state: EnvState, actions: torch.Tensor) -> EnvState:
    """One environment transition. actions: int [B, A] in 0..4."""
    frozen = state.done | (state.t >= spec.max_episode_steps)       # [B]
    act = torch.where(frozen[:, None], 0, actions.to(torch.int32))

    new_pos = step_positions(state.grid, state.pos, act, state.active)
    new_pos = torch.where(frozen[:, None, None], state.pos, new_pos)

    # action history records the commanded action: 0..4 -> 'w'..'r' = 1..5
    hist_sym = torch.where(act < 0, 0, act + 1).to(torch.int32)
    new_hist = torch.cat([state.hist[..., 1:], hist_sym[..., None]], dim=-1)
    new_hist = torch.where(frozen[:, None, None], state.hist, new_hist)

    t = torch.where(frozen, state.t, state.t + 1)

    on_goal_now = (new_pos == state.goal).all(-1)                  # [B, A]
    cost = torch.where(on_goal_now | frozen[:, None], state.cost, t[:, None])
    all_done = (on_goal_now | ~state.active).all(-1)
    done = state.done | all_done
    ep_len = torch.where(done & ~state.done, t, state.ep_len)
    return state._replace(pos=new_pos, hist=new_hist, t=t, done=done,
                          cost=cost, ep_len=ep_len)
