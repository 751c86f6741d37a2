"""Benchmark harness: suite configs -> batched episodes on the device -> metrics.

Port of ``mapf_gpt_tpu/eval/harness.py``.  The reference delegates this to
pogema-toolbox (YAML ``grid_search`` expansion over map, agent count and
seed, process fan-out, metric aggregation, tabular and plot views).  Here
the fan-out is a batch dimension: episodes are grouped by shape (padded map
tier, agent-slot tier, steps, on-target mode, queue depth) and each group
runs in chunks of up to ``batch_envs`` envs through
``parallel/rollout.make_batch_rollout``, the policy once per step for every
agent of every episode in the chunk.

Suite YAML schema matches the reference's eval configs: an ``environment``
block whose scalar values may be replaced by ``{grid_search: [...]}``, an
``algorithms`` block, and ``results_views``.

On CUDA the model's kernels are built when the :class:`Evaluator` is made,
and each chunk's ``runtime`` is the host clock around its episode, ending in
``torch.cuda.synchronize()``: no ``nvcc`` time falls into a row.  Sampled
actions draw from a ``torch.Generator`` seeded from ``(sample_seed,
episodes done)``, so sampled rows cannot match the JAX package's bit for
bit; argmax rows do (``tests/test_torch_eval.py``).
"""

from __future__ import annotations

import itertools
import json
import os
import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from mapf_gpt_tpu_torch.maps import MapRegistry, pad_grid, sample_instance

METRIC_KEYS = ("CSR", "ISR", "SoC", "makespan", "ep_length", "runtime",
               "avg_agents_density", "avg_throughput")


@dataclass(frozen=True)
class EpisodeSpec:
    map_name: str
    num_agents: int
    seed: int
    max_episode_steps: int = 128
    on_target: str = "nothing"
    # lifelong goal-queue depth; pogema issues unlimited goals, here a
    # static queue (K) approximates it: agents that exhaust the queue hold
    # their last goal and stop counting toward throughput
    num_queued_goals: int = 1


def expand_grid_search(env_cfg: dict) -> list[EpisodeSpec]:
    """Expand ``{key: {grid_search: [...]}}`` into the cartesian product
    (the pogema-toolbox semantics)."""
    keys, choices = [], []
    scalars: dict[str, Any] = {}
    for k, v in env_cfg.items():
        if isinstance(v, dict) and "grid_search" in v:
            keys.append(k)
            choices.append(v["grid_search"])
        else:
            scalars[k] = v
    specs = []
    for combo in itertools.product(*choices) if keys else [()]:
        cfg = dict(scalars)
        cfg.update(dict(zip(keys, combo)))
        on_target = str(cfg.get("on_target", "nothing"))
        k = int(cfg.get("num_queued_goals",
                        16 if on_target == "restart" else 1))
        specs.append(EpisodeSpec(
            map_name=str(cfg.get("map_name", "")),
            num_agents=int(cfg.get("num_agents", 1)),
            seed=int(cfg.get("seed", 0)),
            max_episode_steps=int(cfg.get("max_episode_steps", 128)),
            on_target=on_target,
            num_queued_goals=k,
        ))
    return specs


def _tier(n: int, step: int = 32) -> int:
    return -(-n // step) * step


@dataclass
class EvalResult:
    rows: list[dict] = field(default_factory=list)

    def save_json(self, path: str, algorithm: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump([{"algorithm": algorithm, **r} for r in self.rows],
                      f, indent=1)


CPU_MAX_CONTEXTS = 4096     # a fixed cap on the host, where memory is not measured
MEMORY_SHARE = 0.5          # of the card's free memory a chunk may plan to take


def context_bytes(model_cfg, hw: tuple[int, int], kq: int, lazy: bool) -> int:
    """Device bytes one agent context of a chunk costs, counted from shapes:
    its cost2go fields (int32, K per agent, or one in the lazy layout) and
    the relaxation's int64 work tensors when they are rebuilt (at reset, and
    in every lazy step), its tokens and the observation's work tensors
    (int64 [256] a few times over), and the policy's residual stream and
    per-layer work for one context (bf16 [T, E] times the q|k|v, attention
    and MLP widths, 9E; a policy whose config gives
    ``forward_bytes_per_context()`` counts that instead)."""
    cells = hw[0] * hw[1]
    fields = 4 * cells * (1 if lazy else kq)
    relax = 5 * 8 * cells                # keys, offsets and the sweeps' outputs
    tokens = 8 * 256 * 8
    if model_cfg is None:
        forward = 0
    elif hasattr(model_cfg, "forward_bytes_per_context"):
        forward = model_cfg.forward_bytes_per_context()
    else:
        forward = 2 * model_cfg.block_size * 9 * model_cfg.n_embd
    return fields + relax + tokens + forward


def default_max_contexts(model_cfg, device: str | torch.device, hw: tuple[int, int],
                         kq: int = 1, lazy: bool = False) -> int:
    """Env x agent contexts a chunk may hold: on CUDA, MEMORY_SHARE of the
    card's free memory (``torch.cuda.mem_get_info``) over
    :func:`context_bytes`; on the CPU, CPU_MAX_CONTEXTS."""
    device = torch.device(device)
    if device.type != "cuda":
        return CPU_MAX_CONTEXTS
    free, _ = torch.cuda.mem_get_info(device)
    return max(1, int(MEMORY_SHARE * free) // context_bytes(model_cfg, hw, kq, lazy))


def _chunk_generator(device: torch.device, sample_seed: int, done: int) -> torch.Generator:
    """The sampling generator of the chunk that starts after `done` episodes."""
    return torch.Generator(device=device).manual_seed(
        ((sample_seed & 0xFFFFFFFF) << 32) | (done & 0xFFFFFFFF))


class Evaluator:
    """Runs episode specs against a policy (a ``models.gpt.GPT``) with
    shape-tier batching, on the model's device."""

    def __init__(self, registry: MapRegistry, model, batch_envs: int = 128,
                 do_sample: bool = True, sample_seed: int = 0,
                 policy_batch: int | None = 8192, max_contexts: int | None = None,
                 mask_cfg=None, lazy_lifelong: bool = True,
                 device: str | torch.device = "cuda"):
        self.registry = registry
        self.model = model
        self.device = torch.device(device)
        self.batch_envs = batch_envs
        self.do_sample = do_sample
        self.sample_seed = sample_seed
        # chunk the per-step policy forward (the reference's batch_size
        # chunking); max_contexts bounds a chunk's env x agent contexts, and
        # None sizes it per group from the device's memory
        self.policy_batch = policy_batch
        self.max_contexts = max_contexts
        # input-ablation switches (the reference's mask_* inference options),
        # applied inside the rollout
        self.mask_cfg = mask_cfg
        # lifelong episodes hold [A, 1, H, W] current-goal cost2go and
        # recompute on queue-advance (equal to the dense layout,
        # tests/test_torch_lifelong.py)
        self.lazy_lifelong = lazy_lifelong
        self._runners: dict = {}
        if model is not None:
            dev = next(model.parameters()).device
            if dev.type != self.device.type or self.device.index not in (None, dev.index):
                raise ValueError(f"Evaluator: the model is on {dev}, not on {self.device}")
            self.device = dev
            self._build_kernels()

    def _build_kernels(self) -> None:
        """Build (on CUDA) and warm the policy's forward on one context, so
        that no build falls into a row's runtime."""
        from mapf_gpt_tpu_torch.models.gpt import make_forward

        tokens = torch.zeros((1, self.model.cfg.block_size), dtype=torch.int32,
                             device=self.device)
        make_forward(self.model)(tokens)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- internal ---------------------------------------------------------
    def _group_key(self, spec: EpisodeSpec):
        grid = self.registry[spec.map_name]
        h, w = pad_grid(grid).shape
        return (_tier(h), _tier(w), _tier(spec.num_agents, 8),
                spec.max_episode_steps, spec.on_target,
                spec.num_queued_goals)

    def _build_instance(self, spec: EpisodeSpec, hw: tuple[int, int],
                        slots: int):
        """Returns (grid, starts [slots,2], goals_queue [slots,K,2], active).
        K>1 queues come from sample_instance's lifelong goal sampling."""
        kq = spec.num_queued_goals
        inst = sample_instance(self.registry[spec.map_name], spec.num_agents,
                               spec.seed, map_name=spec.map_name,
                               num_lifelong_goals=kq if kq > 1 else 0,
                               masks=self.registry.masks(spec.map_name))
        h, w = inst.grid.shape
        th, tw = hw
        grid = np.pad(inst.grid, ((0, th - h), (0, tw - w)),
                      constant_values=True)
        starts = np.zeros((slots, 2), dtype=np.int32)
        goals = np.zeros((slots, kq, 2), dtype=np.int32)
        a = inst.num_agents
        starts[:a] = inst.starts
        goals[:a] = (inst.lifelong_goals if kq > 1
                     else inst.goals[:, None, :])
        if slots > a:  # park padding slots on free cells, goal=start
            free = np.argwhere(~grid)
            used = {tuple(x) for x in inst.starts}
            extras = [c for c in map(tuple, free) if c not in used]
            if not extras:
                # dense layouts (5x5 puzzles at the 8-slot tier) can host an
                # agent on every free cell; inactive slots are invisible to
                # dynamics and observations, so reusing occupied cells is safe
                extras = [tuple(inst.starts[0])]
            for k in range(slots - a):
                starts[a + k] = extras[k % len(extras)]
                goals[a + k] = extras[k % len(extras)]
        active = np.zeros((slots,), dtype=bool)
        active[:a] = True
        return grid, starts, goals, active

    def _runner(self, spec_key, slots):
        from mapf_gpt_tpu_torch.envs.env import MapfEnvSpec
        from mapf_gpt_tpu_torch.parallel.rollout import make_batch_rollout

        th, tw, _, max_steps, on_target, kq = spec_key
        if spec_key not in self._runners:
            lazy = on_target == "restart" and self.lazy_lifelong
            # dense lifelong resets build A*K fields per env; relax them
            # about 2^30 / 64 bytes of cells at a time, so that the sweeps'
            # work tensors stay near 1 GiB at any batch size (the lazy layout
            # builds A fields and needs no chunks)
            chunk = max(kq, 2 ** 24 // (th * tw)) if kq > 1 and not lazy else 0
            env_spec = MapfEnvSpec(height=th, width=tw, num_agents=slots,
                                   max_episode_steps=max_steps,
                                   on_target=on_target,
                                   num_queued_goals=kq,
                                   c2g_chunk=chunk,
                                   lazy_c2g=lazy)
            run = make_batch_rollout(env_spec, self.model,
                                     do_sample=self.do_sample,
                                     policy_batch=self.policy_batch,
                                     mask_cfg=self.mask_cfg)
            self._runners[spec_key] = (env_spec, run)
        return self._runners[spec_key]

    def _max_contexts(self, spec_key) -> int:
        if self.max_contexts is not None:
            return self.max_contexts
        th, tw, _, _, on_target, kq = spec_key
        return default_max_contexts(None if self.model is None else self.model.cfg,
                                    self.device, (th, tw), kq,
                                    on_target == "restart" and self.lazy_lifelong)

    # -- public -----------------------------------------------------------
    def run(self, specs: list[EpisodeSpec], progress=lambda *_: None,
            on_chunk=None) -> EvalResult:
        from mapf_gpt_tpu_torch.parallel.rollout import batch_reset

        result = EvalResult()
        groups: dict = {}
        for spec in specs:
            groups.setdefault(self._group_key(spec), []).append(spec)

        done = 0
        cuda = self.device.type == "cuda"
        for key, group in groups.items():
            th, tw, slots = key[0], key[1], key[2]
            env_spec, run = self._runner(key, slots)
            # bound the total env x agent product; the per-step forward is
            # further chunked by policy_batch inside the rollout
            batch_envs = max(1, min(self.batch_envs, self._max_contexts(key) // slots))
            for lo in range(0, len(group), batch_envs):
                chunk = group[lo:lo + batch_envs]
                n_real = len(chunk)
                # tier the final short chunk to a multiple of 8 instead of
                # padding to the full batch (duplicate episodes re-simulate
                # for nothing)
                bt = min(batch_envs, _tier(n_real, 8))
                padded = chunk + [chunk[-1]] * (bt - n_real) \
                    if n_real < bt else chunk
                built = [self._build_instance(s, (th, tw), slots)
                         for s in padded]
                states = batch_reset(env_spec, *(np.stack([b[i] for b in built])
                                                 for i in range(4)), device=self.device)
                gen = _chunk_generator(self.device, self.sample_seed, done) \
                    if self.do_sample else None
                if cuda:
                    torch.cuda.synchronize(self.device)
                t0 = time.perf_counter()
                final, metrics = run(states, gen)
                if cuda:
                    torch.cuda.synchronize(self.device)
                # per-episode runtime = the chunk's wall time split evenly
                # over its episodes: every episode runs max_episode_steps, so
                # the marginal cost per episode is uniform
                runtime = (time.perf_counter() - t0) / bt
                m = {k: v.cpu().numpy() for k, v in metrics._asdict().items()}
                for i, spec in enumerate(chunk):
                    result.rows.append({
                        "map_name": spec.map_name,
                        "num_agents": spec.num_agents,
                        "seed": spec.seed,
                        "CSR": float(m["csr"][i]),
                        "ISR": float(m["isr"][i]),
                        "SoC": float(m["soc"][i]),
                        "makespan": float(m["makespan"][i]),
                        "ep_length": float(m["ep_length"][i]),
                        "runtime": runtime,
                        "avg_agents_density": float(m["agents_density"][i]),
                        "avg_throughput": float(m["throughput"][i]),
                    })
                done += n_real
                progress(done, len(specs))
                if on_chunk is not None:
                    on_chunk(result)
        return result


# -- views ---------------------------------------------------------------

def tabular_view(rows: list[dict], drop_keys: list[str],
                 group_keys: tuple = ("map_name", "num_agents", "seed")
                 ) -> str:
    """Aggregate + format like pogema-toolbox's TabularView."""
    keep = [k for k in group_keys if k not in drop_keys]
    metrics = [m for m in METRIC_KEYS
               if m not in drop_keys and (not rows or m in rows[0])]
    buckets: dict = {}
    for r in rows:
        k = tuple(r[g] for g in keep)
        buckets.setdefault(k, []).append(r)
    header = keep + metrics
    lines = ["  ".join(f"{h:>12}" for h in header)]
    for k in sorted(buckets):
        vals = buckets[k]
        cells = [f"{v:>12}" for v in k]
        for mname in metrics:
            cells.append(f"{np.mean([v[mname] for v in vals]):>12.4f}")
        lines.append("  ".join(cells))
    return "\n".join(lines)


def plot_view(rows: list[dict], x: str, y: str, out_path: str,
              ticks=None, **style) -> str | None:
    """A results view as a PNG plot; None where matplotlib is not installed."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from matplotlib.ticker import ScalarFormatter
    except ImportError:
        return None
    xs = sorted({r[x] for r in rows})
    ys = [np.mean([r[y] for r in rows if r[x] == v]) for v in xs]
    fig, ax = plt.subplots(figsize=(style.get("width", 3.0),
                                    style.get("height", 2.5)))
    ax.plot(xs, ys, lw=style.get("line_width", 2))
    if style.get("use_log_scale_x"):
        ax.set_xscale("log")
        ax.set_xticks(ticks or xs)
        ax.get_xaxis().set_major_formatter(ScalarFormatter())
    ax.set_xlabel(x)
    ax.set_ylabel(y)
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path
