"""Plain NumPy reference of one MAPF episode: reset, observation tokens, transition
and episode metrics, one env instance at a time.

Written from the semantics of the MAPF-GPT environment (POGEMA one-shot MAPF,
``on_target="nothing"``) and tokenizer, with no code of the program under test:

- Cost-to-go: breadth-first distance from the goal over free cells,
  4-connected, -1 on obstacles and unreachable cells.
- Tokens (256 a context): the 11 x 11 cost-to-go window around the agent,
  relative to its centre (clamped to +-20, +-40 sentinels, -80 unreachable);
  then 13 agent records, nearest first by (Manhattan distance, agent id) within
  Chebyshev radius 5, self included: relative position, relative goal (clamped
  to +-20), the last 5 commanded actions, the greedy-move bits (u, d, l, r
  weighted 8, 4, 2, 1, set where a move strictly lowers the cost-to-go); then
  padding.
- Transition: a move into an obstacle waits; movers that share a target cell
  (a waiting agent claims its own cell) or swap cells are cancelled, round
  after round until nothing changes.  Finished episodes are frozen.
- Metrics: CSR, ISR, sum of costs, makespan, episode length.
"""

from __future__ import annotations

from collections import deque

import numpy as np

# vocabulary (67 ids) and context layout of the MAPF-GPT tokenizer
LIMIT = 20
RADIUS = 5
NEIGHBOURS = 13
HISTORY = 5
CONTEXT = 256
ID_ZERO = LIMIT                    # value v in [-20, 20] -> v + 20
ID_UNREACHABLE = 2 * LIMIT + 1     # 41
ID_FAR_NEG = 2 * LIMIT + 2         # 42
ID_FAR_POS = 2 * LIMIT + 3         # 43
ID_ACTION = 2 * LIMIT + 4          # 44: 'n', then 'w' 'u' 'd' 'l' 'r'
ID_GREEDY = ID_ACTION + 6          # 50 .. 65
ID_PAD = ID_GREEDY + 16            # 66
VOCAB = ID_PAD + 1
MOVES = np.array([(0, 0), (-1, 0), (1, 0), (0, -1), (0, 1)], dtype=np.int64)


def cost_to_go(grid: np.ndarray, goal) -> np.ndarray:
    """int32 [H, W] breadth-first distances to `goal`; -1 where unreachable."""
    h, w = grid.shape
    dist = np.full((h, w), -1, dtype=np.int32)
    gi, gj = int(goal[0]), int(goal[1])
    if grid[gi, gj]:
        return dist
    dist[gi, gj] = 0
    queue = deque([(gi, gj)])
    while queue:
        i, j = queue.popleft()
        for ni, nj in ((i - 1, j), (i + 1, j), (i, j - 1), (i, j + 1)):
            if 0 <= ni < h and 0 <= nj < w and not grid[ni, nj] and dist[ni, nj] < 0:
                dist[ni, nj] = dist[i, j] + 1
                queue.append((ni, nj))
    return dist


class Episode:
    """One env instance: grid bool [H, W] (with its obstacle border), starts and
    goals int [A, 2], every agent active."""

    def __init__(self, grid: np.ndarray, starts: np.ndarray, goals: np.ndarray,
                 max_steps: int):
        self.grid = np.asarray(grid, dtype=bool)
        self.pos = np.asarray(starts, dtype=np.int64).copy()
        self.goal = np.asarray(goals, dtype=np.int64).copy()
        self.max_steps = max_steps
        self.fields = np.stack([cost_to_go(self.grid, g) for g in self.goal])
        a = len(self.pos)
        self.hist = np.zeros((a, HISTORY), dtype=np.int64)    # 0 = 'n'
        self.t = 0
        on_goal = (self.pos == self.goal).all(-1)
        self.done = bool(on_goal.all())
        self.ep_len = max_steps
        self.last_off = np.where(on_goal, -1, 0)             # last step off its goal

    # ------------------------------------------------------------------ tokens
    def tokens(self) -> np.ndarray:
        """int32 [A, 256] contexts of every agent."""
        a = len(self.pos)
        out = np.full((a, CONTEXT), ID_PAD, dtype=np.int32)
        greedy = np.zeros(a, dtype=np.int64)
        windows = []
        for i in range(a):
            r, c = self.pos[i]
            win = self.fields[i, r - RADIUS:r + RADIUS + 1, c - RADIUS:c + RADIUS + 1]
            windows.append(win)
            centre = win[RADIUS, RADIUS]
            bits = 0
            for weight, (dr, dc) in zip((8, 4, 2, 1), ((-1, 0), (1, 0), (0, -1), (0, 1))):
                v = win[RADIUS + dr, RADIUS + dc]
                if v >= 0 and centre > v:
                    bits += weight
            greedy[i] = bits
        for i in range(a):
            win = windows[i].astype(np.int64)
            rel = win - win[RADIUS, RADIUS]
            tok = np.where(rel > LIMIT, ID_FAR_POS,
                           np.where(rel < -LIMIT, ID_FAR_NEG, rel + ID_ZERO))
            tok = np.where(win < 0, ID_UNREACHABLE, tok)
            out[i, :121] = tok.reshape(-1)
            d = self.pos - self.pos[i]
            near = np.flatnonzero(np.abs(d).max(-1) <= RADIUS)
            key = np.abs(d[near]).sum(-1) * a + near
            chosen = near[np.argsort(key, kind="stable")][:NEIGHBOURS]
            for slot, j in enumerate(chosen):
                rec = np.empty(10, dtype=np.int64)
                rec[0:2] = self.pos[j] - self.pos[i] + ID_ZERO
                rec[2:4] = np.clip(self.goal[j] - self.pos[i], -LIMIT, LIMIT) + ID_ZERO
                rec[4:9] = ID_ACTION + self.hist[j]
                rec[9] = ID_GREEDY + greedy[j]
                out[i, 121 + 10 * slot:121 + 10 * slot + 10] = rec
        return out

    # -------------------------------------------------------------- transition
    def step(self, actions: np.ndarray) -> None:
        """Apply int [A] actions 0..4 (wait, up, down, left, right)."""
        if self.done or self.t >= self.max_steps:
            return
        actions = np.asarray(actions, dtype=np.int64)
        desired = self.pos + MOVES[actions]
        blocked = self.grid[desired[:, 0], desired[:, 1]]
        desired[blocked] = self.pos[blocked]
        while True:
            moving = (desired != self.pos).any(-1)
            cells = [tuple(p) for p in desired]
            claims: dict[tuple, int] = {}
            for cell in cells:
                claims[cell] = claims.get(cell, 0) + 1
            where = {tuple(p): j for j, p in enumerate(self.pos)}
            cancel = np.zeros(len(self.pos), dtype=bool)
            for i in np.flatnonzero(moving):
                if claims[cells[i]] > 1:
                    cancel[i] = True
                    continue
                j = where.get(cells[i])
                if j is not None and (desired[j] == self.pos[i]).all():
                    cancel[i] = True
            if not cancel.any():
                break
            desired[cancel] = self.pos[cancel]
        self.pos = desired
        self.hist = np.concatenate([self.hist[:, 1:], actions[:, None] + 1], axis=1)
        self.t += 1
        on_goal = (self.pos == self.goal).all(-1)
        self.last_off = np.where(on_goal, self.last_off, self.t)
        if on_goal.all():
            self.done = True
            self.ep_len = self.t

    # ----------------------------------------------------------------- metrics
    def metrics(self) -> dict[str, float]:
        on_goal = (self.pos == self.goal).all(-1)
        cost = np.where(self.last_off >= 0, np.minimum(self.last_off + 1, self.t), 0)
        return {"csr": float(on_goal.all()), "isr": float(on_goal.sum()) / len(on_goal),
                "soc": float(cost.sum()), "makespan": float(cost.max()),
                "ep_length": float(self.ep_len)}
