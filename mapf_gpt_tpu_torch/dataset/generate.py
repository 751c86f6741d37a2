"""Imitation-dataset generation: LaCAM expert -> on-device tokenizer -> Arrow.

Port of ``mapf_gpt_tpu/dataset/generate.py``: the same instances, solver
calls, dedup, balancing and shards (file names and schema), the replay on
``device`` (default ``"cuda"``) through the port's env and tokenizer.  The
JAX replay pads an episode's length to a multiple of 32 so that its jit
compiles once per bucket; the port replays exactly the episode's steps,
which gives the same samples.

The reference pipeline (ref:dataset/generate_dataset.py:258-278) runs the
expert through pogema + a second, offline C++ tokenizer, then dedups,
balances and shards.  Here the expert's joint paths are replayed through the
*same* env + tokenizer used at inference (parallel/rollout.replay_rollout),
eliminating the reference's subtle train/inference tokenizer mismatch
(SURVEY §1 note: the two reference implementations sort neighbors by
different keys; ours is single-sourced).

Steps per map shard (matching ref:generate_dataset.py semantics):
  1. sample instances, solve with escalating LaCAM budgets; skip failures
     (the reference skips CSR<1 episodes, ref:generate_observations.py:44-45),
  2. replay expert actions -> per-agent 256-token contexts; gt action per
     step; steps after an agent's last real move are marked 5 = "wait on
     goal" (ref:generate_observations.py:66-91),
  3. global sha256 dedup of contexts (ref:generate_dataset.py:43-45,65-80),
  4. action balancing: keep waits (ids 0 and 5) under `max_wait_frac`,
     relabeling kept 5s to 0 (ref:generate_dataset.py:81-96),
  5. shuffle and write Arrow shards in the reference schema.
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass

import numpy as np
import torch

from mapf_gpt_tpu_torch.dataset import expert as expert_mod
from mapf_gpt_tpu_torch.envs import env as menv
from mapf_gpt_tpu_torch.maps import Instance, maze_grid, random_grid, sample_instance
from mapf_gpt_tpu_torch.parallel.rollout import replay_rollout
from mapf_gpt_tpu_torch.train.data import write_arrow_shard

WAIT_MARKER = 5  # temporary label for "waiting on goal" before balancing


@dataclass
class GenConfig:
    num_agents: int = 8
    map_size: int = 17
    maze_fraction: float = 0.9      # 90:10 maze:random (ref:README.md:84)
    max_wait_frac: float = 0.2
    samples_per_shard: int = 2 ** 17
    seed: int = 0
    expert_time_limits: tuple = expert_mod.TIME_LIMITS
    # optional per-episode variation, matching the reference's training
    # distribution (agents {16,24,32}, ~17-21 cell maps,
    # ref:dataset/dataset_configs/10-medium-mazes/10-medium-mazes-part1.yaml)
    agent_counts: tuple | None = None    # overrides num_agents when set
    map_sizes: tuple | None = None       # overrides map_size when set
    random_density: tuple = (0.25, 0.4)  # uniform range for random maps
    stop_file: str | None = None         # graceful-stop sentinel path
    device: str = "cuda"                 # where the replay runs


def episode_samples(inst: Instance, paths: np.ndarray,
                    device: str | torch.device = "cuda"
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Replay an expert solution on `device` -> (tokens int8 [N, 256], gt
    int8 [N]), N = (T + 1) * A: every agent's context at each of the
    episode's T + 1 snapshots (ref:generate_observations.py:66-91 replays
    exactly the episode)."""
    actions = expert_mod.paths_to_actions(paths)           # [T, A]
    t_true, a = actions.shape
    h, w = inst.grid.shape
    spec = menv.MapfEnvSpec(height=h, width=w, num_agents=a,
                            max_episode_steps=10 ** 6)
    state = menv.reset(spec, inst.grid[None], inst.starts[None],
                       inst.goals[None, :, None, :], np.ones((1, a), bool), device=device)
    _, tokens = replay_rollout(spec, state,
                               torch.as_tensor(actions, dtype=torch.int32, device=device))
    tokens = tokens.cpu().numpy()                          # [T+1, A, 256]

    # gt action per snapshot; final snapshot gets a trailing wait
    # (ref:generate_observations.py:66)
    gts = np.vstack([actions, np.zeros((1, a), dtype=np.int32)])   # [T+1, A]
    # steps after the agent's last non-wait action = waiting on goal
    for j in range(a):
        nz = np.nonzero(gts[:, j])[0]
        goal_t = nz[-1] if len(nz) else -1
        gts[goal_t + 1:, j] = WAIT_MARKER
    n = (t_true + 1) * a
    return (tokens.reshape(n, -1).astype(np.int8),
            gts.reshape(n).astype(np.int8))


def dedup(tokens: np.ndarray, gts: np.ndarray,
          seen: set | None = None) -> tuple[np.ndarray, np.ndarray, set]:
    """sha256-of-bytes dedup (ref:generate_dataset.py:43-45)."""
    seen = set() if seen is None else seen
    keep = []
    for i in range(len(tokens)):
        h = hashlib.sha256(tokens[i].tobytes()).digest()
        if h not in seen:
            seen.add(h)
            keep.append(i)
    return tokens[keep], gts[keep], seen


def balance_waits(tokens: np.ndarray, gts: np.ndarray, rng: np.random.RandomState,
                  max_wait_frac: float = 0.2) -> tuple[np.ndarray, np.ndarray]:
    """Cap the share of wait samples (gt 0 or 5) at `max_wait_frac`,
    relabeling kept wait-on-goal markers to action 0
    (ref:generate_dataset.py:81-96)."""
    is_wait = (gts == 0) | (gts == WAIT_MARKER)
    n_moves = int((~is_wait).sum())
    max_waits = int(max_wait_frac / max(1e-9, 1 - max_wait_frac) * n_moves)
    wait_idx = np.nonzero(is_wait)[0]
    keep_mask = np.ones(len(gts), dtype=bool)
    if len(wait_idx) > max_waits:
        drop = rng.choice(wait_idx, size=len(wait_idx) - max_waits,
                          replace=False)
        keep_mask[drop] = False
    tokens, gts = tokens[keep_mask], gts[keep_mask].copy()
    gts[gts == WAIT_MARKER] = 0
    return tokens, gts


def generate_shards(out_dir: str, total_samples: int, cfg: GenConfig,
                    progress=lambda *_: None) -> dict:
    """Generate Arrow shards until `total_samples` are collected."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.RandomState(cfg.seed)
    seen: set = set()
    buf_toks, buf_gts = [], []
    collected = 0
    shard_idx = 0
    episodes = solved = 0
    inst_seed = cfg.seed * 1_000_003

    def flush(n: int):
        nonlocal shard_idx, collected
        toks = np.concatenate(buf_toks)
        gts = np.concatenate(buf_gts)
        buf_toks.clear()
        buf_gts.clear()
        perm = rng.permutation(len(toks))
        toks, gts = toks[perm][:n], gts[perm][:n]
        if len(toks) > n:
            buf_toks.append(toks[n:])
            buf_gts.append(gts[n:])
        path = os.path.join(out_dir, f"chunk_{cfg.seed}_part_{shard_idx}.arrow")
        write_arrow_shard(path, toks, gts)
        shard_idx += 1
        collected += len(toks)

    maze_samples = total_typed = 0
    while collected + sum(len(t) for t in buf_toks) < total_samples:
        if cfg.stop_file and os.path.exists(cfg.stop_file):
            break
        inst_seed += 1
        episodes += 1
        # exact proportional maze:random steering: pick the type whose
        # realized sample share trails its target — the online equivalent of
        # the reference's proportional per-file pick
        # (ref:generate_dataset.py:105-133,143-179)
        use_maze = maze_samples <= cfg.maze_fraction * total_typed
        size = (cfg.map_sizes[rng.randint(len(cfg.map_sizes))]
                if cfg.map_sizes else cfg.map_size)
        n_agents = (cfg.agent_counts[rng.randint(len(cfg.agent_counts))]
                    if cfg.agent_counts else cfg.num_agents)
        lo, hi = cfg.random_density
        grid = (maze_grid(size, inst_seed) if use_maze
                else random_grid(size, lo + (hi - lo) * rng.rand(), inst_seed))
        try:
            inst = sample_instance(grid, n_agents, inst_seed)
        except ValueError:
            continue
        paths = expert_mod.solve_with_escalation(
            inst.grid, inst.starts,
            expert_mod.dedup_goals(inst.grid, inst.goals),
            seed=inst_seed, time_limits=cfg.expert_time_limits)
        if paths is None:
            continue  # expert failed: skip instance (CSR<1 rule)
        solved += 1
        toks, gts = episode_samples(inst, paths, cfg.device)
        toks, gts, seen = dedup(toks, gts, seen)
        toks, gts = balance_waits(toks, gts, rng, cfg.max_wait_frac)
        if len(toks):
            buf_toks.append(toks)
            buf_gts.append(gts)
            total_typed += len(toks)
            if use_maze:
                maze_samples += len(toks)
        buffered = sum(len(t) for t in buf_toks)
        progress(collected + buffered, total_samples)
        if buffered >= cfg.samples_per_shard:
            flush(cfg.samples_per_shard)
    if buf_toks:
        flush(min(sum(len(t) for t in buf_toks),
                  total_samples - collected))
    return {"episodes": episodes, "solved": solved, "samples": collected,
            "shards": shard_idx,
            "maze_share": round(maze_samples / max(total_typed, 1), 4)}


def main(argv=None):
    """CLI: python -m mapf_gpt_tpu_torch.dataset.generate --out dataset/train \
       --samples 1000000 --seed 1 [--workers 2] [--agent-counts 16 24 32] \
       [--device cuda|cpu]

    The reference drives generation through pogema-toolbox + mp.Pool(8)
    (ref:dataset/generate_dataset.py:267-268); here ``--workers N`` starts N
    independent shard producers, each a new process (never a fork of one
    that has initialised CUDA), with distinct seeds (shard filenames embed
    the seed so outputs never collide).  The replay runs on ``--device``
    (default cuda); the expert solver is host-side."""
    import argparse
    import time

    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("--samples", type=int, required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num-agents", type=int, default=8)
    p.add_argument("--agent-counts", type=int, nargs="*", default=None,
                   help="sample the agent count per episode (the reference "
                        "trains on {16,24,32})")
    p.add_argument("--map-size", type=int, default=17)
    p.add_argument("--map-sizes", type=int, nargs="*", default=None)
    p.add_argument("--maze-fraction", type=float, default=0.9)
    p.add_argument("--samples-per-shard", type=int, default=2 ** 17)
    p.add_argument("--expert-budget", type=float, nargs="*",
                   default=[1.0, 5.0])
    p.add_argument("--workers", type=int, default=1)
    p.add_argument("--stop-file", default=None,
                   help="touch this file to stop generation gracefully")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    if args.workers > 1:
        import subprocess
        import sys

        procs = []
        per = -(-args.samples // args.workers)
        for w in range(args.workers):
            sub = [sys.executable, "-m", "mapf_gpt_tpu_torch.dataset.generate",
                   "--out", args.out, "--samples", str(per),
                   "--seed", str(args.seed + w * 7919),
                   "--num-agents", str(args.num_agents),
                   "--map-size", str(args.map_size),
                   "--maze-fraction", str(args.maze_fraction),
                   "--samples-per-shard", str(args.samples_per_shard),
                   "--expert-budget", *map(str, args.expert_budget),
                   "--device", args.device]
            if args.agent_counts:
                sub += ["--agent-counts", *map(str, args.agent_counts)]
            if args.map_sizes:
                sub += ["--map-sizes", *map(str, args.map_sizes)]
            if args.stop_file:
                sub += ["--stop-file", args.stop_file]
            procs.append(subprocess.Popen(sub))
        rc = max(pr.wait() for pr in procs)
        raise SystemExit(rc)

    cfg = GenConfig(num_agents=args.num_agents, map_size=args.map_size,
                    maze_fraction=args.maze_fraction, seed=args.seed,
                    samples_per_shard=args.samples_per_shard,
                    expert_time_limits=tuple(args.expert_budget),
                    agent_counts=(tuple(args.agent_counts)
                                  if args.agent_counts else None),
                    map_sizes=(tuple(args.map_sizes)
                               if args.map_sizes else None),
                    stop_file=args.stop_file, device=args.device)
    t0 = time.time()
    last = [t0]

    def progress(done, total):
        now = time.time()
        if now - last[0] > 30:
            last[0] = now
            rate = done / max(now - t0, 1e-9)
            print(f"{done}/{total} samples ({rate:.0f}/s)", flush=True)

    stats = generate_shards(args.out, args.samples, cfg, progress=progress)
    stats["wall_s"] = time.time() - t0
    print(stats, flush=True)


if __name__ == "__main__":
    main()
