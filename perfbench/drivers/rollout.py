"""Rollout traffic: whole episodes of batched MAPF instances through the program's
``parallel/rollout.make_batch_rollout`` (tokenize -> policy forward -> act ->
env step, every step of the episode), each episode reset inside the window.

Traffic keys: ``map_size``, ``density`` (random grids), ``envs``, ``agents``,
``steps`` (episode length), ``sample`` (sampled or argmax actions),
``warmup_steps``, ``check_envs`` (instances a episode compared with the
reference), ``check_rows`` (contexts a reference forward call).

The comparison: for ``check_envs`` instances of each episode, drawn from the
seed, the benchmark records what the timed path produced (every step's tokens,
action logits and actions, the final state and metrics) through a tap on the
rollout module's ``observe`` and ``act``; the plain reference resets the same
instances, replays the program's actions, and must give the same tokens, final
state and metrics exactly, and action logits within the cell's limit.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from perfbench.harness import MARK, Check, Window
from perfbench.instances import BORDER, instance_batch
from perfbench.reference import env as ref_env
from perfbench.reference import gpt as ref_gpt
from perfbench.weights import make_weights

STATE_FIELDS = ("pos", "t", "done", "cost", "ep_len")
METRIC_FIELDS = ("csr", "isr", "soc", "makespan", "ep_length")


class Tap:
    """Records, for the env instances `idx`, the tokens that ``observe`` returns
    and the action logits and actions of ``act``, by wrapping the rollout
    module's own references to the two functions."""

    def __init__(self, module, agents: int):
        self.module, self.agents = module, agents
        self.observe, self.act = module.observe, module.act
        self.idx = None
        self.tokens, self.logits, self.actions = [], [], []

    def install(self) -> None:
        self.module.observe, self.module.act = self._observe, self._act

    def uninstall(self) -> None:
        self.module.observe, self.module.act = self.observe, self.act

    def _observe(self, *args, **kwargs):
        tokens = self.observe(*args, **kwargs)
        if self.idx is not None:
            self.tokens.append(tokens.index_select(0, self.idx))
        return tokens

    def _act(self, logits, *args, **kwargs):
        actions = self.act(logits, *args, **kwargs)
        if self.idx is not None:
            rows = logits.view(-1, self.agents, logits.shape[-1]).index_select(0, self.idx)
            self.logits.append(rows[..., :5].float())
            self.actions.append(actions.view(-1, self.agents).index_select(0, self.idx))
        return actions

    def start(self, idx: torch.Tensor) -> None:
        self.idx, self.tokens, self.logits, self.actions = idx, [], [], []

    def stop(self) -> dict:
        got = {"tokens": torch.stack(self.tokens), "logits": torch.stack(self.logits),
               "actions": torch.stack(self.actions)}
        self.idx = None
        return got


@dataclass
class Session:
    run_fn: object
    spec: object
    tap: Tap
    weights: dict
    episodes: list                     # (grids, starts, goals) per window episode
    check_idx: list                    # numpy env indices per episode
    generators: list
    actives: np.ndarray
    records: list = field(default_factory=list)


def _instances(run, episode: int):
    tr = run.traffic
    seeds = np.random.SeedSequence([run.seed, 1, episode + 1]).generate_state(tr["envs"])
    return instance_batch(tr["map_size"], tr["density"], tr["envs"], tr["agents"], seeds)


def setup(run) -> Session:
    from mapf_gpt_tpu_torch.envs.env import MapfEnvSpec
    from mapf_gpt_tpu_torch.parallel import rollout

    from perfbench.program import build_model

    tr, dev = run.traffic, torch.device(run.device)
    side = tr["map_size"] + 2 * BORDER
    spec = MapfEnvSpec(height=side, width=side, num_agents=tr["agents"],
                       max_episode_steps=tr["steps"])
    weights = make_weights(run.config, run.seed, dev)
    model = build_model(run.config, weights, dev, train=False)
    tap = Tap(rollout, tr["agents"])
    tap.install()
    actives = np.ones((tr["envs"], tr["agents"]), dtype=bool)
    seq = np.random.SeedSequence([run.seed, 3]).generate_state(64)

    # warm-up: the same batch for a few steps (the first call builds the kernels),
    # then a timed pass for the pace of a step and of a reset
    warm_spec = spec._replace(max_episode_steps=tr["warmup_steps"])
    warm = rollout.make_batch_rollout(warm_spec, model, do_sample=tr["sample"])
    grids, starts, goals = _instances(run, -1)
    gen = torch.Generator(device=dev).manual_seed(int(seq[0]))
    warm(rollout.batch_reset(warm_spec, grids, starts, goals, actives, device=dev), gen)
    _sync(dev)
    t0 = time.perf_counter()
    states = rollout.batch_reset(warm_spec, grids, starts, goals, actives, device=dev)
    _sync(dev)
    t1 = time.perf_counter()
    warm(states, gen)
    _sync(dev)
    step_s = (time.perf_counter() - t1) / tr["warmup_steps"]
    episode_s = (t1 - t0) + tr["steps"] * step_s
    count = max(2, int(run.seconds // episode_s))

    rng = np.random.default_rng(np.random.SeedSequence([run.seed, 2]))
    episodes = [_instances(run, e) for e in range(count)]
    check_idx = [np.sort(rng.choice(tr["envs"], tr["check_envs"], replace=False))
                 for _ in range(count)]
    generators = [torch.Generator(device=dev).manual_seed(int(seq[1 + e])) for e in range(count)]
    run_fn = rollout.make_batch_rollout(spec, model, do_sample=tr["sample"])
    return Session(run_fn=run_fn, spec=spec, tap=tap, weights=weights, episodes=episodes,
                   check_idx=check_idx, generators=generators, actives=actives)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def window(s: Session, run) -> Window:
    from mapf_gpt_tpu_torch.parallel import rollout

    tr, dev = run.traffic, torch.device(run.device)
    cuda = dev.type == "cuda"
    idx = [torch.as_tensor(i, device=dev) for i in s.check_idx]
    events, episode_ends, socs = [], [], []
    _sync(dev)
    t0 = time.perf_counter()
    for e, (grids, starts, goals) in enumerate(s.episodes):
        s.tap.start(idx[e])
        with torch.profiler.record_function(MARK + "reset"):
            if cuda:
                ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                ev[0].record()
            states = rollout.batch_reset(s.spec, grids, starts, goals, s.actives, device=dev)
            if cuda:
                ev[1].record()
                events.append(ev)
        with torch.profiler.record_function(MARK + "episode"):
            final, metrics = s.run_fn(states, s.generators[e])
        if cuda:
            done = torch.cuda.Event(enable_timing=True)
            done.record()
            episode_ends.append(done)
        rec = s.tap.stop()
        rec["state"] = {f: getattr(final, f).index_select(0, idx[e]) for f in STATE_FIELDS}
        rec["metrics"] = {f: getattr(metrics, f).index_select(0, idx[e]) for f in METRIC_FIELDS}
        s.records.append(rec)
        socs.append(metrics.soc)
    _sync(dev)
    seconds = time.perf_counter() - t0
    s.records = [_to_host(r) for r in s.records]
    episodes = len(s.episodes)
    failed = int(sum((~torch.isfinite(x)).sum().item() for x in socs))
    reset_ms = [a.elapsed_time(b) for a, b in events]
    counts = {"episodes": episodes, "steps": episodes * tr["steps"],
              "contexts_per_step": tr["envs"] * tr["agents"],
              "reset_ms": float(np.mean(reset_ms)) if reset_ms else None,
              "phase_ms": [ev[1].elapsed_time(end) for ev, end in zip(events, episode_ends)]}
    rate = episodes * tr["envs"] * tr["agents"] * tr["steps"] / seconds
    return Window(seconds=seconds, metrics={"rollout_agent_steps_per_s": rate},
                  attempted=episodes * tr["envs"], failed=failed, counts=counts)


def _to_host(x):
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    return x.cpu().numpy()


def release(s: Session) -> None:
    s.tap.uninstall()
    s.run_fn = None
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def reference_episode(grid, starts, goals, steps: int, actions: np.ndarray):
    """The reference's tokens [steps, A, 256] along the program's actions
    [steps, A], its final state and metrics, and the number of actions outside
    0..4."""
    ep = ref_env.Episode(grid, starts, goals, steps)
    tokens = []
    bad = int(((actions < 0) | (actions > 4)).sum())
    for s in range(steps):
        tokens.append(ep.tokens())
        ep.step(np.clip(actions[s], 0, 4))
    state = {"pos": ep.pos, "t": ep.t, "done": ep.done, "cost": ep.last_off, "ep_len": ep.ep_len}
    return np.stack(tokens), state, ep.metrics(), bad


def check(s: Session, run) -> list[Check]:
    tr, dev = run.traffic, torch.device(run.device)
    token_diff = state_diff = bad = 0
    ref_tokens, prog_logits = [], []
    for e, rec in enumerate(s.records):
        grids, starts, goals = s.episodes[e]
        for j, env in enumerate(s.check_idx[e]):
            tokens, state, metrics, n_bad = reference_episode(
                grids[env], starts[env], goals[env], tr["steps"], rec["actions"][:, j])
            bad += n_bad
            token_diff += int((tokens != rec["tokens"][:, j]).sum())
            for f in STATE_FIELDS:
                state_diff += int((np.asarray(state[f]) != rec["state"][f][j]).sum())
            for f in METRIC_FIELDS:
                state_diff += int(np.float32(metrics[f]) != rec["metrics"][f][j])   # float32 metrics
            ref_tokens.append(tokens.reshape(-1, tokens.shape[-1]))
            prog_logits.append(rec["logits"][:, j].reshape(-1, 5))
    tokens = torch.from_numpy(np.concatenate(ref_tokens)).to(dev)
    with ref_gpt.fp32_exact():
        ref = ref_gpt.logits_in_blocks(s.weights, tokens, run.config, tr["check_rows"])
    gap = np.abs(np.concatenate(prog_logits).astype(np.float64)
                 - ref[:, :5].double().cpu().numpy()).max()
    return [Check("token_mismatch", token_diff, 0), Check("state_mismatch", state_diff, 0),
            Check("bad_actions", bad, 0),
            Check("logit_err", float(gap), run.limits["logit_err"])]
