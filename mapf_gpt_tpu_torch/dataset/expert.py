"""LaCAM* expert bridge: ctypes over the native solver.

Port of ``mapf_gpt_tpu/dataset/expert.py``, numpy only, over the port's own
copy of the solver's sources (``native/lacam/``), built with ``g++`` by
``dataset/_lacam_build.py`` rather than ``cmake``.  The same C ABI
(``lacam_solve`` in ``capi.cpp``) and the reference's expert-side
robustness (ref:dataset/lacam/inference.py):

- auto-build of the shared lib if missing (ref:inference.py:11-16),
- escalating time limits [1, 5, 10, 60] s (ref:inference.py:98-103),
- wait-in-place fallback when the solver fails (ref:inference.py:202),
- per-agent path followers emitting env action ids
  (``LacamAgent.get_action``, ref:inference.py:84-91),
- conflicting-goal deduplication for lifelong instances: a goal already
  claimed by another agent is remapped to a nearby free cell
  (ref:inference.py:128-146).

Positions are in the engine's padded coordinate frame; the map text handed to
the solver includes the border, so coordinates pass through unchanged.
"""

from __future__ import annotations

import ctypes
from collections import deque

import numpy as np

from mapf_gpt_tpu_torch.dataset import _lacam_build
from mapf_gpt_tpu_torch.maps import grid_to_str

TIME_LIMITS = (1.0, 5.0, 10.0, 60.0)
# action ids: 0=wait, 1=up, 2=down, 3=left, 4=right (ops/vocab.MOVES)
_DELTA_TO_ACTION = {(0, 0): 0, (-1, 0): 1, (1, 0): 2, (0, -1): 3, (0, 1): 4}


class LacamLib:
    """Thin ctypes wrapper; one instance per process."""

    def __init__(self, lib_path: str | None = None):
        self._lib = ctypes.CDLL(lib_path or str(_lacam_build.build()))
        self._lib.lacam_solve.restype = ctypes.c_int32
        self._lib.lacam_solve.argtypes = [
            ctypes.c_char_p, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_double, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
        ]

    def solve(self, grid: np.ndarray, starts: np.ndarray, goals: np.ndarray,
              time_limit_s: float = 10.0, seed: int = 0,
              anytime: bool = True, max_configs: int = 4096
              ) -> np.ndarray | None:
        """Returns configs [T+1, A, 2] (row, col) or None if unsolved."""
        a = len(starts)
        map_text = grid_to_str(np.asarray(grid, dtype=bool)).encode()
        s = np.ascontiguousarray(starts, dtype=np.int32)
        g = np.ascontiguousarray(goals, dtype=np.int32)
        out = np.zeros((max_configs, a, 2), dtype=np.int32)
        rc = self._lib.lacam_solve(
            map_text, a,
            s.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            g.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            float(time_limit_s), int(seed), int(anytime),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            max_configs)
        if rc <= 0:
            return None
        return out[:rc].copy()


_global_lib: LacamLib | None = None


def get_lib() -> LacamLib:
    global _global_lib
    if _global_lib is None:
        _global_lib = LacamLib()
    return _global_lib


def solve_with_escalation(grid, starts, goals, seed: int = 0,
                          time_limits=TIME_LIMITS) -> np.ndarray | None:
    lib = get_lib()
    for tl in time_limits:
        paths = lib.solve(grid, starts, goals, time_limit_s=tl, seed=seed)
        if paths is not None:
            return paths
    return None


def paths_to_actions(paths: np.ndarray) -> np.ndarray:
    """configs [T+1, A, 2] -> env actions [T, A]."""
    delta = paths[1:] - paths[:-1]
    t, a, _ = delta.shape
    actions = np.zeros((t, a), dtype=np.int32)
    for i in range(t):
        for j in range(a):
            actions[i, j] = _DELTA_TO_ACTION[tuple(delta[i, j])]
    return actions


def dedup_goals(grid: np.ndarray, goals: np.ndarray) -> np.ndarray:
    """Remap duplicate goals to the nearest unclaimed free cell (BFS ring),
    for lifelong instances where two agents may momentarily share a target
    (ref:dataset/lacam/inference.py:128-146)."""
    grid = np.asarray(grid, dtype=bool)
    out = np.array(goals, dtype=np.int32, copy=True)
    used: set[tuple[int, int]] = set()
    h, w = grid.shape
    for i, goal in enumerate(out):
        cell = (int(goal[0]), int(goal[1]))
        if cell not in used:
            used.add(cell)
            continue
        q = deque([cell])
        seen = {cell}
        while q:
            ci, cj = q.popleft()
            for ni, nj in ((ci - 1, cj), (ci + 1, cj), (ci, cj - 1),
                           (ci, cj + 1)):
                if not (0 <= ni < h and 0 <= nj < w) or grid[ni, nj]:
                    continue
                if (ni, nj) in seen:
                    continue
                if (ni, nj) not in used:
                    out[i] = (ni, nj)
                    used.add((ni, nj))
                    q.clear()
                    break
                seen.add((ni, nj))
                q.append((ni, nj))
            else:
                continue
            break
    return out


class LacamExpert:
    """Episode-level expert policy with the reference's fallback semantics:
    solve at reset, then follow the per-agent paths; if unsolved, everyone
    waits in place.  For lifelong episodes, pass the current (positions,
    goals) to :meth:`act` — any goal change triggers a fresh solve from the
    current positions, matching ref:dataset/lacam/inference.py:148-188
    (which rebuilds the scen string and re-runs LaCAM whenever an agent's
    ``global_target_xy`` advances)."""

    def __init__(self, grid: np.ndarray, starts: np.ndarray,
                 goals: np.ndarray, seed: int = 0,
                 time_limits=TIME_LIMITS):
        self.grid = np.asarray(grid, dtype=bool)
        self.seed = seed
        self.time_limits = time_limits
        self.resolves = 0
        self._solve(np.asarray(starts, dtype=np.int32),
                    np.array(goals, dtype=np.int32))

    def _solve(self, starts: np.ndarray, goals: np.ndarray) -> None:
        self.goals = goals
        self.t = 0
        paths = solve_with_escalation(self.grid, starts,
                                      dedup_goals(self.grid, goals),
                                      seed=self.seed,
                                      time_limits=self.time_limits)
        self.failed = paths is None
        self.actions = (None if self.failed else paths_to_actions(paths))
        self.paths = paths

    def act(self, pos: np.ndarray | None = None,
            goals: np.ndarray | None = None) -> np.ndarray:
        if goals is not None and not np.array_equal(goals, self.goals):
            assert pos is not None, "lifelong re-solve needs positions"
            self.resolves += 1
            self._solve(np.asarray(pos, dtype=np.int32),
                        np.array(goals, dtype=np.int32))
        a = len(self.goals)
        if self.failed or self.t >= len(self.actions):
            return np.zeros((a,), dtype=np.int32)  # wait in place
        acts = self.actions[self.t]
        self.t += 1
        return acts
