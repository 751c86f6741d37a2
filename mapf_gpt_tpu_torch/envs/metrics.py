"""Episode metrics per env: CSR / ISR / SoC / makespan / ep_length.

Port of ``mapf_gpt_tpu/envs/metrics.py``:

- ISR: fraction of active agents standing on their goal at episode end.
- CSR: 1.0 iff every active agent is on its goal at episode end.
- SoC: sum over agents of the step at which the agent finally arrives at
  its goal and stays (the episode length for an agent never resting on its
  goal, 0 for one that starts there and never leaves).
- makespan: max over agents of that same per-agent cost.
- ep_length: the step at which all agents were first on goal at once, or
  ``max_episode_steps`` on truncation.
- agents_density: active agents / free cells.
- throughput: lifelong goals reached per step (pogema's avg_throughput; 0
  for on_target="nothing").
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mapf_gpt_tpu_torch.envs.env import EnvState


class EpisodeMetrics(NamedTuple):
    csr: torch.Tensor             # f32 [B]
    isr: torch.Tensor             # f32 [B]
    soc: torch.Tensor             # f32 [B]
    makespan: torch.Tensor        # f32 [B]
    ep_length: torch.Tensor       # f32 [B]
    agents_density: torch.Tensor  # f32 [B]
    throughput: torch.Tensor      # f32 [B]


def episode_metrics(state: EnvState) -> EpisodeMetrics:
    active = state.active
    n_active = active.sum(-1).clamp(min=1)
    on_goal = (state.pos == state.goal).all(-1)
    solved = on_goal & active
    # state.cost = last step off-goal (-1 if never): arrival cost = cost+1,
    # capped at the number of executed steps for agents that never arrive.
    cost = torch.minimum(state.cost + 1, state.t[:, None])
    cost = torch.where(active & (state.cost >= 0), cost, 0)
    free_cells = (~state.grid).sum((-2, -1)).clamp(min=1)
    return EpisodeMetrics(
        csr=(on_goal | ~active).all(-1).float(),
        isr=solved.sum(-1).float() / n_active,
        soc=cost.sum(-1).float(),
        makespan=cost.max(-1).values.float(),
        ep_length=state.ep_len.float(),
        agents_density=active.sum(-1).float() / free_cells,
        throughput=state.goals_reached.sum(-1).float() / state.t.clamp(min=1).float(),
    )
