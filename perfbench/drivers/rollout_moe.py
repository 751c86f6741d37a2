"""Rollout traffic for the DeepSeek-V3-type policy (the Moonlight configuration):
whole episodes of batched MAPF instances through the program's
``parallel/rollout.make_batch_rollout``, as ``drivers/rollout.py`` drives the
MAPF-GPT policies, with that driver's tap, instances, window and episode
reference; what differs is the model, its weights and its comparison.

Traffic keys: those of ``drivers/rollout.py`` (``map_size``, ``density``,
``envs``, ``agents``, ``steps``, ``sample``, ``warmup_steps``,
``check_envs``, ``check_rows``: contexts a block of the reference's layers).

The weights are drawn on the card one layer at a time from the seed
(``moe_weights.draw``) and copied into the program's layout as they come, so
one copy (30.6 GB at the published sizes) is held.  The window also reads
the program's tokens-per-expert counter (``counts["expert_counts"]``, [layer,
expert]) once, after the window.

The comparison: tokens, final state and metrics of the checked instances
exactly, as ``drivers/rollout.py`` compares them.  Then the logits.  A
bf16 program and a float32 reference order near-tied router scores
differently (an expert choice differs where the k-th and the next biased
scores lie within the rounding), and a different expert moves that token's
stream by far more than rounding does.  So the comparison is made in two
parts, each with its own limit:

- before the program is released, it runs the checked contexts again (the
  same batch shape as a step; the logits must equal the window's bit for
  bit, ``replay_logit_gap``) and records every MoE layer's choices;
- the float32 reference runs the same contexts with the program's choices
  forced on its rows and reads, for each forced row, how far the program's
  least chosen expert's biased score lies below the reference's k-th
  (``route_gap``: 0 where the choices agree, small at a near-tie, large for
  a wrong choice) and the action logits' largest gap (``logit_err``).

``python3 -m perfbench.drivers.rollout_moe --workload <cell> --seeds <n> ...``
prints, on the card, the readings the cell's limits are set from: the
program's, and the float8 control's (the reference in float8 routing by
itself, held to the float32 reference forced with its choices), with the
count of choices that differed and their gaps.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

if not __package__:              # run as a script: the checkout's root
    sys.path[0] = str(Path(__file__).resolve().parent.parent.parent)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from perfbench import moe_weights  # noqa: E402
from perfbench.drivers import rollout as base  # noqa: E402
from perfbench.harness import Check  # noqa: E402
from perfbench.reference import moonlight as ref_moon  # noqa: E402
from perfbench.reference.gpt import fp32_exact  # noqa: E402


@dataclass
class Session(base.Session):
    model: object = None
    run: object = None
    replay: dict = field(default_factory=dict)     # tokens, logits, choices, gap
    compared: dict = field(default_factory=dict)   # what compare() read


def program_config(cfg: dict):
    """The program's config for a configuration file's sizes."""
    from mapf_gpt_tpu_torch.models.moonlight import MoonlightConfig

    return MoonlightConfig(
        block_size=cfg["block_size"], vocab_size=cfg["vocab_size"],
        n_layer=cfg["num_hidden_layers"], hidden_size=cfg["hidden_size"],
        n_head=cfg["num_attention_heads"], kv_lora_rank=cfg["kv_lora_rank"],
        qk_nope_head_dim=cfg["qk_nope_head_dim"], qk_rope_head_dim=cfg["qk_rope_head_dim"],
        v_head_dim=cfg["v_head_dim"], intermediate_size=cfg["intermediate_size"],
        moe_intermediate_size=cfg["moe_intermediate_size"],
        n_routed_experts=cfg["n_routed_experts"], num_experts_per_tok=cfg["num_experts_per_tok"],
        n_shared_experts=cfg["n_shared_experts"],
        first_k_dense_replace=cfg["first_k_dense_replace"],
        routed_scaling_factor=cfg["routed_scaling_factor"], rms_norm_eps=cfg["rms_norm_eps"],
        rope_theta=float(cfg["rope_theta"]))


def build_model(cfg: dict, seed: int, device):
    """The program's policy with the seed's weights, copied in a layer at a time."""
    from mapf_gpt_tpu_torch.models.moonlight import MoonlightPolicy

    model = MoonlightPolicy(program_config(cfg), device=device)
    embed = None
    for key, part in moe_weights.draw(cfg, seed, device):
        if key == "embed":
            embed = part
        elif key == "head":
            model.load_globals(embed | part)
        else:
            model.load_layer(key, part)
        del part
    return model.eval()


def _build_kernels(device) -> None:
    """Compile the policy's kernel libraries side by side before the warm-up."""
    if torch.device(device).type != "cuda":
        return
    from mapf_gpt_tpu_torch.ops import _build

    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        for f in [pool.submit(_build.load, name) for name in ("moe", "attention")]:
            f.result()


def setup(run) -> Session:
    # the program's modules first: a checkout without this policy stops here, at once
    from mapf_gpt_tpu_torch.envs.env import MapfEnvSpec
    from mapf_gpt_tpu_torch.models import moonlight  # noqa: F401
    from mapf_gpt_tpu_torch.parallel import rollout

    tr, dev = run.traffic, torch.device(run.device)
    side = tr["map_size"] + 2 * base.BORDER
    spec = MapfEnvSpec(height=side, width=side, num_agents=tr["agents"],
                       max_episode_steps=tr["steps"])
    _build_kernels(dev)
    model = build_model(run.config, run.seed, dev)
    tap = base.Tap(rollout, tr["agents"])
    tap.install()
    actives = np.ones((tr["envs"], tr["agents"]), dtype=bool)
    seq = np.random.SeedSequence([run.seed, 3]).generate_state(64)

    # warm-up: a few steps of one batch, then a timed pass for the pace of a
    # step and of a reset
    warm_spec = spec._replace(max_episode_steps=tr["warmup_steps"])
    warm = rollout.make_batch_rollout(warm_spec, model, do_sample=tr["sample"])
    grids, starts, goals = base._instances(run, -1)
    gen = torch.Generator(device=dev).manual_seed(int(seq[0]))
    warm(rollout.batch_reset(warm_spec, grids, starts, goals, actives, device=dev), gen)
    base._sync(dev)
    t0 = time.perf_counter()
    states = rollout.batch_reset(warm_spec, grids, starts, goals, actives, device=dev)
    base._sync(dev)
    t1 = time.perf_counter()
    warm(states, gen)
    base._sync(dev)
    step_s = (time.perf_counter() - t1) / tr["warmup_steps"]
    episode_s = (t1 - t0) + tr["steps"] * step_s
    count = max(2, int(run.seconds // episode_s))

    rng = np.random.default_rng(np.random.SeedSequence([run.seed, 2]))
    episodes = [base._instances(run, e) for e in range(count)]
    check_idx = [np.sort(rng.choice(tr["envs"], tr["check_envs"], replace=False))
                 for _ in range(count)]
    generators = [torch.Generator(device=dev).manual_seed(int(seq[1 + e])) for e in range(count)]
    run_fn = rollout.make_batch_rollout(spec, model, do_sample=tr["sample"])
    return Session(run_fn=run_fn, spec=spec, tap=tap, weights=None, episodes=episodes,
                   check_idx=check_idx, generators=generators, actives=actives, model=model,
                   run=run)


def window(s: Session, run):
    s.model.expert_counts.zero_()
    win = base.window(s, run)
    win.counts["expert_counts"] = s.model.expert_counts.cpu().tolist()
    return win


def _checked(s: Session):
    """The checked contexts' tokens [n, T] and program logits [n, 5], in the
    order the comparison reads them: episode, env, step, agent."""
    tokens, logits = [], []
    for rec in s.records:
        for j in range(rec["tokens"].shape[1]):
            tokens.append(rec["tokens"][:, j].reshape(-1, rec["tokens"].shape[-1]))
            logits.append(rec["logits"][:, j].reshape(-1, 5))
    return np.concatenate(tokens), np.concatenate(logits)


def replay(s: Session, run) -> dict:
    """The program on the checked contexts again, a step's batch at a time:
    its logits' largest gap to the window's, and each MoE layer's choices as
    the reference's rows take them ([n T, k], -1 where the thinned last layer
    computed no choice)."""
    tr, dev = run.traffic, torch.device(run.device)
    cfg = s.model.cfg
    tokens, logits = _checked(s)
    batch = tr["envs"] * tr["agents"]
    got, captured = [], []
    s.model.capture = []
    with torch.inference_mode():
        for blk in range(0, len(tokens), batch):
            s.model.capture = []
            x = torch.from_numpy(tokens[blk:blk + batch]).to(dev)
            got.append(s.model(x)[:, :5].float().cpu())
            captured.append(s.model.capture)
    s.model.capture = None
    n, t, k = len(tokens), cfg.block_size, cfg.num_experts_per_tok
    layers = range(cfg.first_k_dense_replace, cfg.n_layer)
    choices = {}
    for j, layer in enumerate(layers):
        parts = [c[j] for c in captured]
        if layer < cfg.n_layer - 1:
            choices[layer] = torch.cat(parts)
        else:
            full = torch.full((n, t, k), -1, dtype=torch.int32, device=dev)
            full[:, -1] = torch.cat(parts)
            choices[layer] = full.view(n * t, k)
    gap = float(np.abs(torch.cat(got).numpy() - logits).max())
    return {"tokens": tokens, "logits": logits, "choices": choices, "gap": gap}


def release(s: Session) -> None:
    s.tap.uninstall()
    s.run_fn = None
    if s.model is not None:
        s.replay = replay(s, s.run)
    s.model = None
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _episode_checks(s: Session, run) -> tuple[int, int, int]:
    """(token, state, bad action) mismatches of the checked instances against
    the reference episode, as ``drivers/rollout.check`` counts them."""
    tr = run.traffic
    token_diff = state_diff = bad = 0
    for e, rec in enumerate(s.records):
        grids, starts, goals = s.episodes[e]
        for j, env in enumerate(s.check_idx[e]):
            tokens, state, metrics, n_bad = base.reference_episode(
                grids[env], starts[env], goals[env], tr["steps"], rec["actions"][:, j])
            bad += n_bad
            token_diff += int((tokens != rec["tokens"][:, j]).sum())
            for f in base.STATE_FIELDS:
                state_diff += int((np.asarray(state[f]) != rec["state"][f][j]).sum())
            for f in base.METRIC_FIELDS:
                state_diff += int(np.float32(metrics[f]) != rec["metrics"][f][j])
    return token_diff, state_diff, bad


def compare(run, tokens: np.ndarray, logits: np.ndarray, choices: dict) -> dict:
    """The float32 reference on `tokens` with `choices` forced: logit_err
    (action logits against `logits`), route_gap (the largest), and the rows
    whose choices differ from the reference's own with their gaps."""
    tr, dev = run.traffic, torch.device(run.device)
    x = torch.from_numpy(tokens).to(dev)
    with fp32_exact():
        ref, _, gaps = ref_moon.logits_streamed(moe_weights.draw(run.config, run.seed, dev), x,
                                                run.config, tr["check_rows"], force=choices)
    flips = torch.cat(list(gaps.values()))
    flips = flips[flips > 0]
    return {"logit_err": float(np.abs(logits.astype(np.float64)
                                      - ref[:, :5].double().cpu().numpy()).max()),
            "route_gap": float(torch.cat(list(gaps.values())).max()),
            "choices_differ": int(len(flips)),
            "flip_gaps": sorted(flips.tolist(), reverse=True)[:10]}


def bad_choices(choices: dict, experts: int) -> tuple[int, int]:
    """(rows that choose an expert twice, rows that choose one outside [0,
    experts)) among the rows of `choices` that the program routed (rows of -1,
    where the thinned last layer chose nothing, left out)."""
    twice = outside = 0
    for c in choices.values():
        c = c[(c != -1).any(-1)].long()
        twice += int((c.sort(-1).values.diff(dim=-1) == 0).any(-1).sum())
        outside += int(((c < 0) | (c >= experts)).any(-1).sum())
    return twice, outside


def check(s: Session, run) -> list[Check]:
    token_diff, state_diff, bad = _episode_checks(s, run)
    twice, outside = bad_choices(s.replay["choices"], run.config["n_routed_experts"])
    got = s.compared = compare(run, s.replay["tokens"], s.replay["logits"],
                               s.replay["choices"])
    print(f"rollout_moe: {got['choices_differ']} expert choices differ from the reference's "
          f"(largest gaps {got['flip_gaps'][:5]})", file=sys.stderr, flush=True)
    return [Check("token_mismatch", token_diff, 0), Check("state_mismatch", state_diff, 0),
            Check("bad_actions", bad, 0),
            Check("replay_logit_gap", s.replay["gap"], 0.0),
            Check("duplicate_choices", twice, 0), Check("choice_out_of_range", outside, 0),
            Check("route_gap", got["route_gap"], run.limits["route_gap"]),
            Check("logit_err", got["logit_err"], run.limits["logit_err"])]


def readings(run) -> dict:
    """The program's compared numbers and the float8 control's, for the limits."""
    s = setup(run)
    window(s, run)
    release(s)
    program = {c.name: c.value for c in check(s, run)}
    got = s.compared
    tr, dev = run.traffic, torch.device(run.device)
    x = torch.from_numpy(s.replay["tokens"]).to(dev)
    with fp32_exact():
        low, low_choices, _ = ref_moon.logits_streamed(
            moe_weights.draw(run.config, run.seed, dev), x, run.config, tr["check_rows"], "fp8")
    control = compare(run, s.replay["tokens"], low[:, :5].float().cpu().numpy(), low_choices)
    return {"program": program, "program_routes": {k: got[k] for k in
                                                    ("choices_differ", "flip_gaps")},
            "control": control}


def main() -> int:
    from perfbench import harness

    p = argparse.ArgumentParser(description="Readings for the limits of a rollout_moe cell.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("rollout_moe: needs a CUDA device", file=sys.stderr)
        return 2
    config, traffic, limits, _, _, _ = harness.load_cell(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        run = harness.Run(workload=args.workload, config=config, traffic=traffic,
                          limits=limits, seed=seed, seconds=0.0, trace=False)
        got = readings(run)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t0, **got}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
