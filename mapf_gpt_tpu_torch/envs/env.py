"""The batched MAPF environment: functional reset/step over [B, ...] tensors.

Port of ``mapf_gpt_tpu/envs/env.py``.  Semantics:

- ``on_target="nothing"`` (one-shot MAPF): agents stay on their goals, an
  env terminates when every active agent is on its goal at once and
  truncates at ``max_episode_steps``.
- ``on_target="restart"`` (lifelong): an agent reaching its goal advances
  to the next of its K queued goals (``goal_idx``, held at K-1 once the
  queue is spent); ``goals_reached`` counts each queued goal once.  A
  lifelong episode only truncates.
- The action history records the *commanded* action.
- An env's state is frozen once its episode is over, so a fixed-length loop
  over ``max_episode_steps`` gives exact metrics.

Cost-to-go fields: dense, one per queued goal ([B, A, K, H, W], computed at
reset, ``c2g_chunk`` goals at a time when set), or with ``lazy_c2g`` (lifelong
only) the current goal's alone ([B, A, 1, H, W]), re-seeded for an agent
whose queue advanced and relaxed in every step (``ops/cost2go``'s warm-start
fixpoint: one round when no agent advanced).  The two layouts give the same
fields, tokens and trajectories (``tests/test_torch_lifelong.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mapf_gpt_tpu_torch.envs.dynamics import step_positions
from mapf_gpt_tpu_torch.ops.cost2go import INF, cost2go_device, goal_seed, relax_fixpoint
from mapf_gpt_tpu_torch.ops.vocab import NUM_PREV_ACTIONS
from mapf_gpt_tpu_torch.utils.profiling import span


class EnvState(NamedTuple):
    """State of B env instances; every tensor has a leading batch dim."""

    pos: torch.Tensor         # int32 [B, A, 2] padded coords
    goal: torch.Tensor        # int32 [B, A, 2] current goal
    goal_idx: torch.Tensor    # int32 [B, A] index into the goal queue
    hist: torch.Tensor        # int32 [B, A, P] action symbols 0..5, oldest first
    t: torch.Tensor           # int32 [B] steps taken
    done: torch.Tensor        # bool [B] all active agents on goal (terminal)
    cost: torch.Tensor        # int32 [B, A] last timestep the agent was
                              # off-goal (0 incl. reset; -1 = never off-goal)
    ep_len: torch.Tensor      # int32 [B] step at which done fired (else max steps)
    goals_reached: torch.Tensor  # int32 [B, A] queued goals achieved (each once)
    grid: torch.Tensor        # bool [B, H, W] obstacles incl. border
    c2g: torch.Tensor         # int32 [B, A, K or 1, H, W] cost2go fields
    goals_queue: torch.Tensor  # int32 [B, A, K, 2]
    active: torch.Tensor      # bool [B, A]


class MapfEnvSpec(NamedTuple):
    """Static configuration."""

    height: int
    width: int
    num_agents: int           # padded agent slot count A
    max_episode_steps: int = 128
    on_target: str = "nothing"   # "nothing" | "restart"
    num_queued_goals: int = 1    # K; > 1 only with on_target="restart"
    c2g_chunk: int = 0        # dense reset: fields for this many goals at a time (0 = all)
    lazy_c2g: bool = False    # lifelong only: the current goal's field alone


def _fields(grids: torch.Tensor, goals: torch.Tensor, chunk: int = 0) -> torch.Tensor:
    """int32 [B, N, H, W] cost2go fields of goals [B, N, 2] on grids [B, H, W],
    `chunk` (grid, goal) pairs at a time when chunk > 0."""
    b, n = goals.shape[:2]
    h, w = grids.shape[-2:]
    flat_grids = grids[:, None].expand(b, n, h, w).reshape(b * n, h, w)
    flat_goals = goals.reshape(b * n, 2)
    if not chunk or chunk >= b * n:
        return cost2go_device(flat_grids, flat_goals).reshape(b, n, h, w)
    return torch.cat([cost2go_device(flat_grids[i:i + chunk], flat_goals[i:i + chunk])
                      for i in range(0, b * n, chunk)]).reshape(b, n, h, w)


@span("mapf.env.reset")
def reset(spec: MapfEnvSpec, grids, starts, goals, active,
          device: str | torch.device = "cuda") -> EnvState:
    """Build the initial state and the cost2go fields on `device`.

    grids: bool [B, H, W]; starts: int [B, A, 2]; goals: the goal queues
    int [B, A, K, 2], or int [B, A, 2] for one goal each (K = 1); active:
    bool [B, A] (numpy arrays or tensors).  Inactive (padding) slots should
    carry starts == goals on free cells; they never move and are masked out
    of observations."""
    grids = torch.as_tensor(grids, dtype=torch.bool, device=device)
    starts = torch.as_tensor(starts, device=device).to(torch.int32)
    queue = torch.as_tensor(goals, device=device).to(torch.int32)
    active = torch.as_tensor(active, dtype=torch.bool, device=device)
    if queue.dim() == 3:
        queue = queue[:, :, None]
    b, a = starts.shape[:2]
    h, w, k = spec.height, spec.width, spec.num_queued_goals
    if (tuple(grids.shape) != (b, h, w) or a != spec.num_agents
            or tuple(queue.shape) != (b, a, k, 2) or tuple(active.shape) != (b, a)):
        raise ValueError(
            f"reset: expected grids [B, {h}, {w}], starts [B, {a}, 2], goals [B, {a}, {k}, 2] "
            f"(or [B, {a}, 2] when K = 1), active [B, {a}]; got {tuple(grids.shape)}, "
            f"{tuple(starts.shape)}, {tuple(queue.shape)}, {tuple(active.shape)}")
    if spec.lazy_c2g and spec.on_target == "restart":
        c2g = _fields(grids, queue[:, :, 0])[:, :, None]   # current goals; step() recomputes
    else:
        c2g = _fields(grids, queue.reshape(b, a * k, 2), spec.c2g_chunk).reshape(b, a, k, h, w)
    settled = (starts == queue[:, :, 0]).all(-1) | ~active
    zeros = torch.zeros((b, a), dtype=torch.int32, device=device)
    return EnvState(
        pos=starts,
        goal=queue[:, :, 0].contiguous(),
        goal_idx=zeros,
        hist=torch.zeros((b, a, NUM_PREV_ACTIONS), dtype=torch.int32,
                         device=device),                   # 'n' * P
        t=torch.zeros((b,), dtype=torch.int32, device=device),
        done=settled.all(-1),
        cost=torch.where(settled, -1, 0).to(torch.int32),
        ep_len=torch.full((b,), spec.max_episode_steps, dtype=torch.int32,
                          device=device),
        goals_reached=zeros.clone(),
        grid=grids,
        c2g=c2g,
        goals_queue=queue,
        active=active,
    )


def current_c2g(state: EnvState) -> torch.Tensor:
    """The [B, A, H, W] cost2go fields of each agent's current goal, in
    either layout: dense [B, A, K, H, W] indexed by goal_idx, or lazy
    [B, A, 1, H, W] (the one slot is the current field)."""
    idx = state.goal_idx.clamp(max=state.c2g.shape[2] - 1).long()
    return torch.gather(state.c2g, 2, idx[:, :, None, None, None].expand(
        *idx.shape, 1, *state.c2g.shape[-2:])).squeeze(2)


def _relax_changed(state: EnvState, changed: torch.Tensor, new_goal: torch.Tensor
                   ) -> torch.Tensor:
    """The lazy layout's fields after a step: agents whose queue advanced are
    re-seeded from their new goal, every field relaxed to its fixpoint (one
    round for the unchanged ones).  Returns int32 [B, A, 1, H, W]."""
    b, a = changed.shape
    h, w = state.grid.shape[-2:]
    grids = state.grid[:, None].expand(b, a, h, w).reshape(b * a, h, w)
    fresh, free = goal_seed(grids, new_goal.reshape(b * a, 2))
    old = state.c2g[:, :, 0].reshape(b * a, h, w)
    seed = torch.where(changed.reshape(b * a, 1, 1), fresh, torch.where(old < 0, INF, old))
    dist = relax_fixpoint(seed, free)
    return torch.where(dist >= INF, -1, dist).to(torch.int32).reshape(b, a, 1, h, w)


@span("mapf.env.step")
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

    new_idx, new_goal = state.goal_idx, state.goal
    goals_reached, c2g = state.goals_reached, state.c2g
    if spec.on_target == "restart":
        advance = (new_pos == state.goal).all(-1) & state.active
        new_idx = torch.where(frozen[:, None], state.goal_idx,
                              (state.goal_idx + advance.int()).clamp(
                                  max=spec.num_queued_goals - 1))
        new_goal = torch.gather(state.goals_queue, 2, new_idx[:, :, None, None].long().expand(
            *new_idx.shape, 1, 2)).squeeze(2)
        # each of the K queued goals counts once: standing on the spent
        # queue's last goal does not count again
        achieved = advance & ~frozen[:, None] & (state.goals_reached < spec.num_queued_goals)
        goals_reached = state.goals_reached + achieved.int()
        if spec.lazy_c2g:
            c2g = _relax_changed(state, (new_idx != state.goal_idx) & ~frozen[:, None], new_goal)

    on_goal_now = (new_pos == new_goal).all(-1)                    # [B, A]
    cost = torch.where(on_goal_now | frozen[:, None], state.cost, t[:, None])
    all_done = (on_goal_now | ~state.active).all(-1)
    if spec.on_target == "restart":
        all_done = torch.zeros_like(all_done)   # lifelong episodes only truncate
    done = state.done | all_done
    ep_len = torch.where(done & ~state.done, t, state.ep_len)
    return state._replace(pos=new_pos, goal=new_goal, goal_idx=new_idx, hist=new_hist, t=t,
                          done=done, cost=cost, ep_len=ep_len, goals_reached=goals_reached,
                          c2g=c2g)
