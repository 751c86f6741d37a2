"""The port's profiler spans (``utils/profiling.span``) on the CPU.

- Under ``torch.profiler``, a rollout step holds one tokenization, one
  policy forward, one act and one env step; an env step holds its arbiter
  rounds, a reset its relaxation rounds (``make_batch_rollout`` and
  ``make_recorded_rollout``).
- A training step with ``grad_accum=2`` holds two forwards, two backwards
  and one optimizer span; the shard feed opens one ``mapf.data.batch`` a
  batch and closes it before the batch reaches the caller.
- With no profiler recording, no span enters ``record_function``; with one
  or without, a seeded rollout and a training step give the same bits.
"""

import numpy as np
import pytest
import torch

from mapf_gpt_tpu_torch.envs import env as menv
from mapf_gpt_tpu_torch.maps import random_grid, sample_instance
from mapf_gpt_tpu_torch.models.convert import load_model
from mapf_gpt_tpu_torch.models.gpt import GPTConfig, init_params
from mapf_gpt_tpu_torch.parallel import rollout
from mapf_gpt_tpu_torch.train import data
from mapf_gpt_tpu_torch.train import train_step as ts
from mapf_gpt_tpu_torch.utils.profiling import span

CFG = GPTConfig(n_layer=2, n_head=2, n_embd=32, dtype=torch.float32)
STEP_PARTS = ("mapf.obs.observe", "mapf.policy.forward", "mapf.policy.act", "mapf.env.step")


def _model(train=False):
    model = load_model(CFG, init_params(CFG, torch.Generator().manual_seed(0)), device="cpu")
    return model.train().requires_grad_() if train else model


def _instances(envs, agents, steps=3):
    insts = [sample_instance(random_grid(12, 0.3, s), agents, seed=s) for s in range(envs)]
    grids = np.stack([i.grid for i in insts])
    spec = menv.MapfEnvSpec(height=grids.shape[1], width=grids.shape[2], num_agents=agents,
                            max_episode_steps=steps)
    return spec, (grids, np.stack([i.starts for i in insts]), np.stack([i.goals for i in insts]),
                  np.ones((envs, agents), bool))


def _profile(fn):
    """fn()'s result and the (name, start ns, end ns) of each ``mapf.``
    range the profiler recorded while it ran."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = sorted((e.name(), e.start_ns(), e.end_ns())
                   for e in prof.profiler.kineto_results.events() if e.name().startswith("mapf."))
    return out, spans


def _named(spans, name):
    return [s for s in spans if s[0] == name]


def _inside(spans, name, outer):
    return [s for s in _named(spans, name) if outer[1] <= s[1] and s[2] <= outer[2]]


def _rollout(kind, generator_seed=5):
    envs = 2 if kind == "batch" else 1
    spec, inst = _instances(envs, 4)
    make = rollout.make_batch_rollout if kind == "batch" else rollout.make_recorded_rollout
    run = make(spec, _model(), do_sample=True)

    def go():
        states = rollout.batch_reset(spec, *inst, device="cpu")
        return run(states, torch.Generator().manual_seed(generator_seed))
    return spec, go


@pytest.mark.parametrize("kind", ["batch", "recorded"])
def test_a_rollout_step_holds_one_of_each_part(kind):
    spec, go = _rollout(kind)
    _, spans = _profile(go)
    steps = _named(spans, "mapf.rollout.step")
    assert len(steps) == spec.max_episode_steps
    for step in steps:
        for part in STEP_PARTS:
            assert len(_inside(spans, part, step)) == 1, (part, step)
    for part in STEP_PARTS:
        assert len(_named(spans, part)) == spec.max_episode_steps, part
    for step in _named(spans, "mapf.env.step"):
        assert _inside(spans, "mapf.env.arbiter_round", step)
    resets = _named(spans, "mapf.env.reset")
    assert len(resets) == 1 and _inside(spans, "mapf.cost2go.relax_round", resets[0])
    # every round is inside the layer that runs it
    rounds = _named(spans, "mapf.env.arbiter_round")
    assert sum(len(_inside(spans, "mapf.env.arbiter_round", s))
               for s in _named(spans, "mapf.env.step")) == len(rounds)
    relax = _named(spans, "mapf.cost2go.relax_round")
    assert len(_inside(spans, "mapf.cost2go.relax_round", resets[0])) == len(relax)


def test_a_relaxation_round_span_is_one_round():
    """A field that is already a fixpoint costs one round; a fresh seed more."""
    from mapf_gpt_tpu_torch.ops.cost2go import cost2go_device, goal_seed, relax_fixpoint

    grid = torch.from_numpy(random_grid(9, 0.2, 3))
    goals = torch.tensor([[0, 0], [4, 4]])
    dist0, free = goal_seed(grid, goals)
    fixed, spans = _profile(lambda: relax_fixpoint(dist0, free))
    assert len(spans) > 1 and {s[0] for s in spans} == {"mapf.cost2go.relax_round"}
    again, spans = _profile(lambda: relax_fixpoint(fixed, free))
    assert len(spans) == 1 and torch.equal(again, fixed)
    assert torch.equal(torch.where(fixed >= 1 << 20, -1, fixed), cost2go_device(grid, goals))


def _train_step(tc=ts.TrainConfig(grad_accum=2, warmup_iters=1, lr_decay_iters=10,
                                  learning_rate=1e-3)):
    model = _model(train=True)
    step = ts.make_train_step(model, tc)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randint(0, 67, size=(2, 8, 256)).astype(np.int32))
    y = torch.from_numpy(rng.randint(0, 5, size=(2, 8)).astype(np.int32))
    # the first update's learning rate is 0: two steps move the weights
    return lambda: ([step(x, y) for _ in range(2)], list(model.parameters()))


def test_a_train_step_holds_its_micro_batches_and_one_optimizer():
    _, spans = _profile(_train_step())
    steps = _named(spans, "mapf.train.step")
    assert len(steps) == 2
    for step in steps:
        assert len(_inside(spans, "mapf.train.forward", step)) == 2
        assert len(_inside(spans, "mapf.train.backward", step)) == 2
        assert len(_inside(spans, "mapf.train.optimizer", step)) == 1
    assert len(_named(spans, "mapf.train.forward")) == 4


def test_the_feed_closes_its_batch_span_before_the_caller_runs(tmp_path):
    rng = np.random.RandomState(0)
    data.write_arrow_shard(str(tmp_path / "s.arrow"),
                           rng.randint(0, 67, size=(64, 256)).astype(np.int8),
                           rng.randint(0, 5, size=64).astype(np.int8))
    stream = iter(data.ArrowShardStream(str(tmp_path), batch_size=8, grad_accum=2, seed=1))

    def go():
        probes = []
        for _ in range(3):
            x, y = next(stream)
            assert x.shape == (2, 8, 256) and y.shape == (2, 8)
            with torch.profiler.record_function("mapf.test.probe"):
                probes.append(torch.zeros(1))
        return probes
    _, spans = _profile(go)
    batches, probes = _named(spans, "mapf.data.batch"), _named(spans, "mapf.test.probe")
    assert len(batches) == 3 and len(_named(spans, "mapf.data.load_shard")) == 1
    for batch, probe in zip(batches, probes):
        assert batch[2] <= probe[1]


def test_a_span_closes_when_its_body_raises():
    @span("mapf.test.raises")
    def boom():
        raise ValueError("inside")

    def go():
        with pytest.raises(ValueError):
            boom()
        with span("mapf.test.after"):
            pass
    _, spans = _profile(go)
    (raised,), (after,) = _named(spans, "mapf.test.raises"), _named(spans, "mapf.test.after")
    assert raised[2] <= after[1]


def test_without_a_profiler_no_span_enters_record_function(monkeypatch, tmp_path):
    def refuse(name, *args):
        raise AssertionError(f"record_function({name!r}) entered with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    _, go = _rollout("batch")
    go()
    _train_step()()
    data.write_arrow_shard(str(tmp_path / "s.arrow"), np.zeros((16, 256), np.int8),
                           np.zeros(16, np.int8))
    next(iter(data.ArrowShardStream(str(tmp_path), batch_size=8, grad_accum=2)))


def _bits(x):
    if isinstance(x, torch.Tensor):
        return [x.detach().clone()]
    if isinstance(x, (tuple, list)):
        return [b for v in x for b in _bits(v)]
    return [b for v in x._asdict().values() for b in _bits(v)]      # states, metrics


@pytest.mark.parametrize("path", ["rollout", "train"])
def test_a_profiler_changes_no_bit(path):
    make = (lambda: _rollout("batch")[1]) if path == "rollout" else _train_step
    plain = _bits(make()())
    traced = _bits(_profile(make())[0])
    assert len(plain) == len(traced) > 3
    for a, b in zip(plain, traced):
        assert a.dtype == b.dtype and torch.equal(a, b)
