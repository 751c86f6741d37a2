"""The rollout benchmark of ``bench.py`` on the port: env-steps/s on one card.

    python -m mapf_gpt_tpu_torch.bench [--device cuda]

Workload (``bench.py``'s, with its procedural maps): 256 env instances x 32
agents on ``random_grid(21, 0.3, s)`` maps with ``sample_instance(..., 32,
seed=s)``, 128-step episodes, the 2M policy with ``init_params`` weights
(seed 0), sampled actions; the whole env -> tokenize -> GPT -> sample ->
step loop of ``parallel/rollout.make_batch_rollout``, the forward through
the e2e kernel on CUDA.  The reset, which builds the cost2go fields, is
outside the timed episode, as in ``bench.py``.  One warm-up episode, then
the best of 3, each timed on the host clock ending in
``torch.cuda.synchronize()``.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}; the
baseline of ``bench.py`` is measured from the reference sources, which are
not in this repository, so ``vs_baseline`` is null.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from mapf_gpt_tpu_torch.envs.env import MapfEnvSpec
from mapf_gpt_tpu_torch.maps import random_grid, sample_instance
from mapf_gpt_tpu_torch.models.convert import load_model
from mapf_gpt_tpu_torch.models.gpt import CONFIGS, init_params
from mapf_gpt_tpu_torch.parallel.rollout import batch_reset, make_batch_rollout

B = 256          # env instances
A = 32           # agents per instance
STEPS = 128
MAP_SIZE, DENSITY = 21, 0.3


def build_states(b: int, a: int, steps: int, device):
    insts = [sample_instance(random_grid(MAP_SIZE, DENSITY, s), a, seed=s) for s in range(b)]
    h, w = insts[0].grid.shape
    spec = MapfEnvSpec(height=h, width=w, num_agents=a, max_episode_steps=steps)
    states = batch_reset(spec, np.stack([i.grid for i in insts]),
                         np.stack([i.starts for i in insts]),
                         np.stack([i.goals for i in insts]), np.ones((b, a), bool),
                         device=device)
    return spec, states


def measure(device, b: int = B, a: int = A, steps: int = STEPS, reps: int = 3) -> float:
    """Best env-steps/s of `reps` episodes after one warm-up."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    spec, states = build_states(b, a, steps, device)
    cfg = CONFIGS["2M"]
    model = load_model(cfg, init_params(cfg, torch.Generator().manual_seed(0)), device=device)
    run = make_batch_rollout(spec, model, do_sample=True)
    best = float("inf")
    for i in range(reps + 1):           # the first episode warms up (and builds the kernel)
        gen = torch.Generator(device=device).manual_seed(i)
        if cuda:
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        _, metrics = run(states, gen)
        if cuda:
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        if not torch.isfinite(metrics.soc).all():
            raise RuntimeError("bench: the episode's metrics are not finite")
        if i:
            best = min(best, dt)
    return b * steps / best


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    value = measure(args.device)
    print(json.dumps({
        "metric": "env_steps_per_s_per_chip_2M",
        "value": round(value, 1),
        "unit": f"env-steps/s (B={B} envs x {A} agents, {STEPS}-step episodes)",
        "vs_baseline": None,
    }))


if __name__ == "__main__":
    main()
