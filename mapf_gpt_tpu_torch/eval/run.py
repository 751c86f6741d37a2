"""Suite-evaluation CLI — the ``benchmark.py`` equivalent, on the port.

    python -m mapf_gpt_tpu_torch.eval.run --suite <dir with maps.yaml and <suite>.yaml> \
        [--weights path/to/MAPF-GPT-2M.pt | --weights <trainer out dir> | --random-init 2M] \
        [--model 2M] [--algo MAPF-GPT-2M] [--mask greed_action ...] [--device cuda] \
        [--batch-envs 128] [--out-dir results] [--argmax] [--limit N]

Port of ``mapf_gpt_tpu/eval/run.py``: loads the suite's ``maps.yaml`` and
``<suite>.yaml`` (the reference's format; PyYAML is imported only here, when
the files are read), expands the grid search, runs batched episodes on
``--device``, writes ``<out>/<suite>/<algo>.json`` and prints the tabular
view.

``--algo KEY`` selects an entry of the suite yaml's ``algorithms`` block:
``path_to_weights`` resolves the checkpoint (``--weights`` still
overrides), ``mask_*`` flags switch on the input ablations, and
``parallel_backend``/``num_process`` are not used: episodes are batched on
the device instead (``--batch-envs``).

``--model SIZE`` (a ``CONFIGS`` name, as the reference takes it) names the
checkpoint's size: inferred from ``path_to_weights`` when not given, checked
against the config a checkpoint holds (a mismatch exits naming both), and
naming a trainer directory's rows ``MAPF-GPT-<size>-ckpt``.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os

import numpy as np
import torch

from mapf_gpt_tpu_torch.eval.harness import (
    Evaluator, expand_grid_search, plot_view, tabular_view)
from mapf_gpt_tpu_torch.maps import MapRegistry
from mapf_gpt_tpu_torch.models.gpt import CONFIGS

MASK_KEYS = ("mask_actions_history", "mask_cost2go", "mask_goal",
             "mask_greed_action")


def resolve_algorithm(suite_cfg: dict, args) -> tuple[dict, object]:
    """Pick an ``algorithms``-block entry and build the MaskConfig.

    Returns (algo_cfg, mask_cfg).  CLI ``--mask`` flags OR into the yaml's
    mask_* switches."""
    from mapf_gpt_tpu_torch.ops.masking import MaskConfig

    algo_cfg: dict = {}
    if args.algo:
        algos = suite_cfg.get("algorithms") or {}
        if args.algo not in algos:
            raise SystemExit(
                f"algorithm {args.algo!r} not in suite yaml "
                f"(available: {sorted(algos)})")
        algo_cfg = dict(algos[args.algo])
    cli_masks = {f"mask_{m}" for m in (args.mask or [])}
    unknown = cli_masks - set(MASK_KEYS)
    if unknown:
        raise SystemExit(f"unknown --mask flags: {sorted(unknown)}; "
                         f"choose from {[k[5:] for k in MASK_KEYS]}")
    mask_cfg = MaskConfig(**{k: bool(algo_cfg.get(k, False)) or k in cli_masks
                             for k in MASK_KEYS})
    return algo_cfg, mask_cfg


def config_name(cfg) -> str | None:
    """The ``CONFIGS`` name whose architecture `cfg` has, or None."""
    for name, ref in CONFIGS.items():
        if dataclasses.replace(cfg, dtype=ref.dtype, attn_impl=ref.attn_impl,
                               dropout=ref.dropout) == ref:
            return name
    return None


def _checked_config(cfg, model: str | None, path: str) -> str | None:
    """The size of a checkpoint's config: `model` (``--model``) where given,
    which the config must equal, else the ``CONFIGS`` name it equals."""
    found = config_name(cfg)
    if model is not None and found != model:
        held = found or f"n_layer={cfg.n_layer}, n_head={cfg.n_head}, n_embd={cfg.n_embd}"
        raise SystemExit(f"--model {model} does not match the checkpoint {path}, "
                         f"which holds {held}")
    return found


def load_policy(args, algo_cfg: dict | None = None):
    """Returns (model on args.device, name).

    ``--weights`` is a reference-layout ``.pt`` file
    (``models/convert.load_reference_checkpoint``) or a trainer's output
    directory, whose newest ``ckpt_<step>.pt`` is read
    (``utils/checkpoint``) and whose rows are named ``MAPF-GPT-<size>-ckpt``
    (``<size>`` is ``--model``, or else the ``CONFIGS`` name of the
    checkpoint's config); ``--random-init SIZE`` draws ``init_params``
    weights from seed 0.  ``--model`` (``args.model``, may be absent) is
    inferred from ``path_to_weights`` as the reference does, and a
    checkpoint whose config differs from it exits naming both."""
    from mapf_gpt_tpu_torch.models.convert import load_model, load_reference_checkpoint
    from mapf_gpt_tpu_torch.models.gpt import init_params
    from mapf_gpt_tpu_torch.utils import checkpoint as ckpt

    algo_cfg = algo_cfg or {}
    if not args.weights and not args.random_init:
        # fall back to the algorithms block's path_to_weights
        ptw = algo_cfg.get("path_to_weights")
        if ptw:
            cand = [ptw] + ([os.path.join(args.weights_root, ptw)]
                            if args.weights_root else [])
            found = [c for c in cand if os.path.exists(c)]
            if not found:
                raise SystemExit(f"path_to_weights {ptw!r} not found (tried {cand}); "
                                 "pass --weights to override")
            args.weights = found[0]
            if getattr(args, "model", None) is None:   # infer the size from the name
                for size in CONFIGS:
                    if size in os.path.basename(ptw):
                        args.model = size
                        break
    model = getattr(args, "model", None)
    if args.random_init:
        cfg = CONFIGS[args.random_init]
        sd = init_params(cfg, torch.Generator().manual_seed(0))
        return load_model(cfg, sd, device=args.device), f"MAPF-GPT-{args.random_init}-random"
    if args.weights and os.path.isdir(args.weights):   # a trainer's checkpoints
        step = ckpt.latest_step(args.weights)
        if step is None:
            raise SystemExit(f"no checkpoints in {args.weights}")
        path = ckpt.checkpoint_path(args.weights, step)
        cfg, sd = load_reference_checkpoint(path)
        size = _checked_config(cfg, model, path)
        name = f"MAPF-GPT-{size}-ckpt" if size else f"MAPF-GPT-ckpt-{step}"
        return load_model(cfg, sd, device=args.device), name
    if args.weights:
        cfg, sd = load_reference_checkpoint(args.weights)
        _checked_config(cfg, model, args.weights)
        name = os.path.splitext(os.path.basename(args.weights))[0]
        return load_model(cfg, sd, device=args.device), name
    raise SystemExit("provide --weights or --random-init")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--suite", required=True,
                   help="suite dir containing maps.yaml and <suite>.yaml")
    p.add_argument("--weights", default=None,
                   help="a reference-layout .pt file or a trainer's output directory")
    p.add_argument("--model", default=None, choices=list(CONFIGS),
                   help="the checkpoint's size (inferred from path_to_weights)")
    p.add_argument("--random-init", default=None, choices=list(CONFIGS))
    p.add_argument("--algo", default=None,
                   help="key into the suite yaml's algorithms block")
    p.add_argument("--weights-root", default=None,
                   help="directory to resolve the yaml's path_to_weights in")
    p.add_argument("--mask", nargs="*", default=None,
                   help="input ablations: actions_history cost2go goal "
                        "greed_action (also honored from the yaml)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--batch-envs", type=int, default=128)
    p.add_argument("--out-dir", default="results")
    p.add_argument("--argmax", action="store_true")
    p.add_argument("--limit", type=int, default=None,
                   help="cap the number of episodes (smoke runs)")
    p.add_argument("--agents", type=int, nargs="*", default=None,
                   help="restrict the grid search to these num_agents values")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--policy-batch", type=int, default=8192,
                   help="microbatch the per-step policy forward (0 = off)")
    p.add_argument("--max-contexts", type=int, default=None,
                   help="cap env x agent contexts per batch; default: sized from the "
                        "card's free memory (harness.default_max_contexts)")
    p.add_argument("--on-target", default=None, choices=["nothing", "restart"],
                   help="override the suite's on_target (pogema's lifelong protocol "
                        "uses 'restart'); results land under <suite>-lifelong/")
    p.add_argument("--queued-goals", type=int, default=16,
                   help="lifelong goal-queue depth K with --on-target restart")
    p.add_argument("--max-seeds", type=int, default=None,
                   help="restrict the grid search to seeds < N")
    args = p.parse_args(argv)
    import yaml

    suite_name = os.path.basename(os.path.normpath(args.suite))
    reg = MapRegistry()
    reg.load_yaml(os.path.join(args.suite, "maps.yaml"))
    cfg_files = [f for f in glob.glob(os.path.join(args.suite, "*.yaml"))
                 if not f.endswith("maps.yaml")]
    if not cfg_files:
        raise SystemExit(f"no suite yaml in {args.suite}")
    with open(cfg_files[0]) as f:
        suite_cfg = yaml.safe_load(f)

    specs = expand_grid_search(suite_cfg["environment"])
    if args.agents:
        specs = [s for s in specs if s.num_agents in set(args.agents)]
    if args.max_seeds is not None:
        specs = [s for s in specs if s.seed < args.max_seeds]
    if args.on_target:
        specs = [dataclasses.replace(
            s, on_target=args.on_target,
            num_queued_goals=(args.queued_goals if args.on_target == "restart" else 1))
            for s in specs]
        if args.on_target == "restart":
            suite_name += "-lifelong"
    if args.limit:
        specs = specs[: args.limit]
    algo_cfg, mask_cfg = resolve_algorithm(suite_cfg, args)
    model, algo_name = load_policy(args, algo_cfg)
    if args.algo:
        algo_name = args.algo
    if mask_cfg.any:
        algo_name += "-" + "-".join(
            k[5:] for k in MASK_KEYS if getattr(mask_cfg, k))
    print(f"suite {suite_name}: {len(specs)} episodes, algo {algo_name}"
          + (f" masks={[k for k in MASK_KEYS if getattr(mask_cfg, k)]}"
             if mask_cfg.any else ""))

    ev = Evaluator(reg, model, batch_envs=args.batch_envs,
                   do_sample=not args.argmax, sample_seed=args.seed,
                   policy_batch=args.policy_batch or None,
                   max_contexts=args.max_contexts,
                   mask_cfg=mask_cfg if mask_cfg.any else None, device=args.device)
    out_json = os.path.join(args.out_dir, suite_name, f"{algo_name}.json")
    result = ev.run(specs,
                    progress=lambda d, t: print(f"  {d}/{t} episodes", flush=True),
                    # persist incrementally so long runs survive interruption
                    on_chunk=lambda r: r.save_json(out_json, algo_name))
    result.save_json(out_json, algo_name)
    print(f"wrote {out_json}")

    views = suite_cfg.get("results_views", {})
    for name, view in views.items():
        if view.get("type") == "tabular":
            print(f"== {name} ==")
            print(tabular_view(result.rows, view.get("drop_keys", [])))
        elif view.get("type") == "plot":
            path = os.path.join(args.out_dir, suite_name, f"{name}.png")
            made = plot_view(result.rows, view["x"], view["y"], path,
                             ticks=view.get("ticks"),
                             width=view.get("width", 3.0),
                             height=view.get("height", 2.5),
                             line_width=view.get("line_width", 2),
                             use_log_scale_x=view.get("use_log_scale_x"))
            if made:
                print(f"wrote {made}")
    summary = {m: float(np.mean([r[m] for r in result.rows]))
               for m in ("CSR", "ISR", "SoC", "makespan", "ep_length")}
    print(json.dumps({"suite": suite_name, "algo": algo_name,
                      "episodes": len(result.rows), **summary}))


if __name__ == "__main__":
    main()
