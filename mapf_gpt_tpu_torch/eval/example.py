"""Single-episode CLI with an SVG animation — the ``example.py`` equivalent, on the port.

    python -m mapf_gpt_tpu_torch.eval.example --suite <dir with maps.yaml> \
        --map validation-random-seed-000 [--weights ... [--model 2M] | --random-init 2M] \
        --num-agents 32 --seed 0 [--device cuda] --svg out/episode.svg

Port of ``mapf_gpt_tpu/eval/example.py``: one episode on a named map
(``parallel/rollout.make_recorded_rollout``), its metrics printed as one
JSON line and its trajectory saved as an animated SVG.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from mapf_gpt_tpu_torch.maps import MapRegistry, sample_instance
from mapf_gpt_tpu_torch.models.gpt import CONFIGS


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--suite", required=True, help="suite dir containing maps.yaml")
    p.add_argument("--map", dest="map_name", default="validation-random-seed-000")
    p.add_argument("--num-agents", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-episode-steps", type=int, default=128)
    p.add_argument("--weights", default=None)
    p.add_argument("--model", default=None, choices=list(CONFIGS))
    p.add_argument("--random-init", default=None, choices=list(CONFIGS))
    p.add_argument("--weights-root", default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--argmax", action="store_true")
    p.add_argument("--svg", default="out/episode.svg")
    args = p.parse_args(argv)

    from mapf_gpt_tpu_torch.envs import env as menv
    from mapf_gpt_tpu_torch.eval.animation import save_episode_svg
    from mapf_gpt_tpu_torch.eval.run import load_policy
    from mapf_gpt_tpu_torch.parallel.rollout import batch_reset, make_recorded_rollout

    reg = MapRegistry()
    reg.load_reference_suite(args.suite)
    inst = sample_instance(reg[args.map_name], args.num_agents, args.seed,
                           map_name=args.map_name, masks=reg.masks(args.map_name))
    model, name = load_policy(args)

    h, w = inst.grid.shape
    spec = menv.MapfEnvSpec(height=h, width=w, num_agents=args.num_agents,
                            max_episode_steps=args.max_episode_steps)
    state = batch_reset(spec, inst.grid[None], inst.starts[None], inst.goals[None],
                        np.ones((1, args.num_agents), bool), device=args.device)
    run = make_recorded_rollout(spec, model, do_sample=not args.argmax)
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    _, metrics, positions = run(state, gen)
    m = {k: float(v[0]) for k, v in metrics._asdict().items()}
    print(json.dumps({"algo": name, "map": args.map_name, **m}))
    os.makedirs(os.path.dirname(args.svg) or ".", exist_ok=True)
    save_episode_svg(args.svg, inst.grid, positions.cpu().numpy(), inst.goals, trim_border=0)
    print(f"wrote {args.svg}")


if __name__ == "__main__":
    main()
