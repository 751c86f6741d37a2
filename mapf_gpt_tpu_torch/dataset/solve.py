"""Standalone expert-solver CLI — the reference LaCAM binary's file mode
(ref:dataset/lacam/main.cpp:99-138); the port of
``mapf_gpt_tpu/dataset/solve.py``, over the port's own solver library:

    python -m mapf_gpt_tpu_torch.dataset.solve --map city.map --scen city.scen \
        -N 32 [--time-limit 10] [--seed 0] [--out solution.txt]

Reads MovingAI ``.map`` + ``.scen`` files, runs the native LaCAM* solver,
validates feasibility, prints metrics, and optionally writes the solution as
``t:(x,y)(x,y)...`` lines (x = column, y = row, unpadded frame — the
visualizer-compatible layout of ref:lacam3/src/post_processing.cpp:88-130).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from mapf_gpt_tpu_torch.maps import C2G_RADIUS, scen_instance


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--map", required=True, dest="map_file")
    p.add_argument("--scen", required=True)
    p.add_argument("-N", "--num-agents", type=int, required=True)
    p.add_argument("--time-limit", type=float, default=10.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    from mapf_gpt_tpu_torch.dataset import expert

    with open(args.map_file) as f:
        map_text = f.read()
    with open(args.scen) as f:
        scen_text = f.read()
    inst = scen_instance(map_text, scen_text, num_agents=args.num_agents)

    t0 = time.perf_counter()
    paths = expert.solve_with_escalation(
        inst.grid, inst.starts, inst.goals, seed=args.seed,
        time_limits=(args.time_limit,))
    wall = time.perf_counter() - t0
    if paths is None:
        print(f"failed to solve within {args.time_limit}s")
        return 1

    goals = paths[-1]
    off = np.any(paths != goals[None], axis=-1)
    t_idx = np.arange(paths.shape[0])[:, None]
    costs = np.where(off, t_idx, -1).max(axis=0) + 1
    print(f"solved: agents={len(inst.starts)} makespan={len(paths) - 1} "
          f"soc={int(costs.sum())} comp_time={wall * 1e3:.0f}ms")

    if args.out:
        b = C2G_RADIUS  # back to the unpadded frame
        with open(args.out, "w") as f:
            for t, cfg_t in enumerate(paths):
                cells = "".join(f"({c - b},{r - b})" for r, c in cfg_t)
                f.write(f"{t}:{cells}\n")
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
