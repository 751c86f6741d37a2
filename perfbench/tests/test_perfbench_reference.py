"""The plain reference agrees with the port on the CPU at small sizes; the
reference itself imports nothing of the port."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import instances, weights
from perfbench.program import build_model
from perfbench.reference import env as ref_env
from perfbench.reference import gpt as ref_gpt
from perfbench.reference import train as ref_train

ROOT = Path(__file__).resolve().parents[2]
TINY = {"n_layer": 2, "n_head": 2, "n_embd": 32, "block_size": 256, "vocab_size": 67,
        "bias": False, "dropout": 0.0, "dtype": "float32", "gelu": "erf"}


@pytest.mark.parametrize("seed", [1, 2])
def test_episode_tokens_states_and_metrics_equal_the_ports(seed):
    from mapf_gpt_tpu_torch.envs import env as menv
    from mapf_gpt_tpu_torch.envs.metrics import episode_metrics
    from mapf_gpt_tpu_torch.parallel.rollout import _tokens_of

    grids, starts, goals = instances.instance_batch(9, 0.3, 3, 12, [seed, seed + 10, seed + 20])
    steps = 24
    spec = menv.MapfEnvSpec(height=19, width=19, num_agents=12, max_episode_steps=steps)
    state = menv.reset(spec, grids, starts, goals, np.ones((3, 12), bool), device="cpu")
    refs = [ref_env.Episode(g, s, t, steps) for g, s, t in zip(grids, starts, goals)]
    rng = np.random.default_rng(seed)
    for _ in range(steps + 2):
        tokens = _tokens_of(state).numpy()
        for i, ep in enumerate(refs):
            np.testing.assert_array_equal(ep.tokens(), tokens[i])
        actions = rng.integers(0, 5, size=(3, 12))
        state = menv.step(spec, state, torch.from_numpy(actions))
        for i, ep in enumerate(refs):
            ep.step(actions[i])
            np.testing.assert_array_equal(ep.pos, state.pos[i].numpy())
            np.testing.assert_array_equal(ep.last_off, state.cost[i].numpy())
            assert (ep.t, ep.done, ep.ep_len) == (int(state.t[i]), bool(state.done[i]),
                                                  int(state.ep_len[i]))
    got = episode_metrics(state)
    got_k = lambda m, k: getattr(m, k).numpy()
    for i, ep in enumerate(refs):
        for k, v in ep.metrics().items():
            assert np.float32(v) == got_k(got, k)[i], k   # the port's metrics are float32


def test_episode_that_finishes_is_frozen():
    grid = np.zeros((11, 11), bool)
    grid = np.pad(grid, 5, constant_values=True)
    ep = ref_env.Episode(grid, np.array([[6, 6]]), np.array([[6, 8]]), 10)
    for _ in range(4):
        ep.step(np.array([4]))
    assert ep.done and ep.ep_len == 2 and ep.t == 2 and ep.metrics()["soc"] == 2.0


def test_forward_equals_the_ports_module_in_float32():
    w = weights.make_weights(TINY, 5, "cpu")
    model = build_model(TINY, w, "cpu", train=False)
    tokens = torch.randint(0, 67, (6, 256), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        got = model(tokens)
    ref = ref_gpt.logits(w, tokens, TINY)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


def test_tanh_forward_follows_the_fused_routes_plain_version():
    from mapf_gpt_tpu_torch.ops.fused_gpt import fused_logits, stack_weights

    cfg = dict(TINY, gelu="tanh", dtype="bfloat16")
    w = weights.make_weights(cfg, 6, "cpu")
    model = build_model(cfg, w, "cpu", train=False)
    tokens = torch.randint(0, 67, (6, 256), generator=torch.Generator().manual_seed(1))
    got = fused_logits(stack_weights(model), tokens)
    ref = ref_gpt.logits(w, tokens, cfg)
    assert (got - ref).abs().max() < 0.01 * ref.abs().max()


def test_training_steps_equal_the_ports_in_float32():
    from mapf_gpt_tpu_torch.train.train_step import TrainConfig, make_train_step

    hp = {"learning_rate": 6e-4, "min_lr": 6e-5, "warmup_iters": 3, "lr_decay_iters": 30,
          "weight_decay": 0.1, "beta1": 0.9, "beta2": 0.95, "grad_clip": 1.0}
    w = weights.make_weights(TINY, 7, "cpu")
    model = build_model(TINY, w, "cpu", train=True)
    step = make_train_step(model, TrainConfig(grad_accum=2, **hp))
    gen = torch.Generator().manual_seed(2)
    batches = [(torch.randint(0, 67, (8, 256), generator=gen),
                torch.randint(0, 5, (8,), generator=gen)) for _ in range(3)]
    names = [n for n, _ in model.named_parameters()]
    prog = {"losses": [], "first_grad": {}, "change": {}}
    for k, (x, y) in enumerate(batches):
        prog["losses"].append(float(step(x.view(2, 4, 256), y.view(2, 4))))
        if k == 0:
            prog["first_grad"] = {n: float((m / 0.1).double().norm())
                                  for n, m in zip(names, step.optimizer.mu)}
    prog["change"] = {n: float((p.detach() - w[n]).double().norm())
                      for n, p in zip(names, step.optimizer.params)}
    ref = ref_train.run_steps(w, TINY, hp, batches, rows=3)
    gaps = ref_train.gaps(prog, ref)
    assert gaps["loss_gap"] < 1e-5 and gaps["grad_gap"] < 1e-4 and gaps["change_gap"] < 1e-3


def test_learning_rate_schedule():
    hp = {"learning_rate": 6e-4, "min_lr": 6e-5, "warmup_iters": 2000, "lr_decay_iters": 30000}
    assert ref_train.learning_rate(0, hp) == 0.0
    assert ref_train.learning_rate(1, hp) == pytest.approx(3e-7)
    assert ref_train.learning_rate(2000, hp) == pytest.approx(6e-4)
    assert ref_train.learning_rate(30000, hp) == pytest.approx(6e-5)


def test_fp8_rounding_keeps_about_three_mantissa_bits():
    x = torch.randn(4096, generator=torch.Generator().manual_seed(3))
    q = ref_gpt.fp8_round(x)
    rel = ((q - x).abs() / x.abs().clamp(min=1e-2)).max()
    assert 0 < rel <= 2 ** -4 + 1e-6 and (q - x).abs().max() > 0


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; import perfbench.reference.env, perfbench.reference.gpt, "
            "perfbench.reference.train; "
            "bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'mapf_gpt_tpu_torch', 'mapf_gpt_tpu', 'jax', 'jaxlib', 'flax'}); "
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
