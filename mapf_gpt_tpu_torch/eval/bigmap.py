"""256x256-map batched rollout benchmark, on the port.

    python -m mapf_gpt_tpu_torch.eval.bigmap --map city-256 --procedural --model 85M \
        [--weights ...] [--envs 8] [--agents 256] [--steps 256] [--device cuda]
    python -m mapf_gpt_tpu_torch.eval.bigmap --suite <04-movingai dir> --map Berlin_1_256
    python -m mapf_gpt_tpu_torch.eval.bigmap --map path/to/file.map

Port of ``mapf_gpt_tpu/eval/bigmap.py``.  The full 256x256 MovingAI city maps
are the scale the reference's hierarchical cost2go exists for; this engine
holds dense per-goal fields instead, so this tier needs its own proof: reset
sweeps, shape tiers and policy microbatching at once.  The map comes from
the suite's 64x64 tiles (``maps.MapRegistry.stitch_tiles``), a MovingAI
``.map`` file, or with ``--procedural`` the :func:`maps.city_grid` stand-in
(size from a ``city-<N>`` name).  Runs batched episodes through the
standard :class:`eval.harness.Evaluator` and prints env-steps/s and the
card's peak memory as one JSON line; writes the eval rows.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from mapf_gpt_tpu_torch.eval.harness import EpisodeSpec, Evaluator
from mapf_gpt_tpu_torch.maps import MapRegistry
from mapf_gpt_tpu_torch.models.gpt import CONFIGS


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--suite", default=None, help="suite dir holding the map's tiles")
    p.add_argument("--map", default="Berlin_1_256")
    p.add_argument("--model", default="85M", choices=list(CONFIGS))
    p.add_argument("--weights", default=None)
    p.add_argument("--envs", type=int, default=8)
    p.add_argument("--agents", type=int, default=256)
    p.add_argument("--steps", type=int, default=256)
    p.add_argument("--policy-batch", type=int, default=8192)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out-dir", default="results")
    p.add_argument("--argmax", action="store_true")
    p.add_argument("--procedural", action="store_true",
                   help="use the procedural city_grid stand-in (size parsed "
                        "from a 'city-<N>' --map name, default 256)")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    reg = MapRegistry()
    if args.procedural:
        from mapf_gpt_tpu_torch.maps import city_grid

        size = int(args.map.rsplit("-", 1)[1]) if "-" in args.map else 256
        grid = city_grid(size, seed=args.seed)
        reg.register(args.map, grid)
    elif os.path.isfile(args.map):  # a MovingAI .map file
        from mapf_gpt_tpu_torch.maps import parse_movingai_map

        with open(args.map) as f:
            grid = parse_movingai_map(f.read())
        args.map = os.path.splitext(os.path.basename(args.map))[0]
        reg.register(args.map, grid)
    elif args.suite:
        reg.load_reference_suite(args.suite)
        grid = reg.stitch_tiles(args.map)   # registers under args.map
    else:
        raise SystemExit("give --suite, a .map file as --map, or --procedural")
    print(f"{args.map}: {grid.shape[0]}x{grid.shape[1]}, "
          f"obstacle density {grid.mean():.3f}")

    if args.weights:
        from mapf_gpt_tpu_torch.eval.run import load_policy

        ns = argparse.Namespace(weights=args.weights, random_init=None, weights_root=None,
                                device=args.device)
        model, _ = load_policy(ns)
    else:
        from mapf_gpt_tpu_torch.models.convert import load_model
        from mapf_gpt_tpu_torch.models.gpt import init_params

        cfg = CONFIGS[args.model]
        model = load_model(cfg, init_params(cfg, torch.Generator().manual_seed(0)),
                           device=args.device)

    specs = [EpisodeSpec(args.map, args.agents, s, max_episode_steps=args.steps)
             for s in range(args.envs)]
    ev = Evaluator(reg, model, batch_envs=args.envs, do_sample=not args.argmax,
                   policy_batch=args.policy_batch,
                   max_contexts=args.envs * args.agents, device=args.device)
    cuda = torch.device(args.device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    result = ev.run(specs, progress=lambda d, t: print(f"  {d}/{t} episodes", flush=True))

    runtime = float(np.mean([r["runtime"] for r in result.rows]))
    env_steps_per_s = args.steps / runtime if runtime > 0 else float("nan")
    os.makedirs(os.path.join(args.out_dir, "bigmap"), exist_ok=True)
    out_json = os.path.join(args.out_dir, "bigmap", f"{args.map}-{args.model}.json")
    result.save_json(out_json, f"MAPF-GPT-{args.model}-{args.map}")
    summary = {
        "map": args.map, "model": args.model, "envs": args.envs,
        "agents": args.agents, "steps": args.steps, "device": args.device,
        "env_steps_per_s": env_steps_per_s,
        "agent_steps_per_s": env_steps_per_s * args.agents,
        "runtime_per_episode_s": runtime,
        # the card's memory; not measured on the host
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else None,
        "memory_limit_gb": (torch.cuda.get_device_properties(0).total_memory / 2 ** 30
                            if cuda else None),
        "mean_ISR": float(np.mean([r["ISR"] for r in result.rows])),
        "artifact": out_json,
    }
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
