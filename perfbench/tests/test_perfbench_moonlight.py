"""The Moonlight cell's pieces on the CPU at a small size that keeps every
shape relation (MLA 2 heads of 16 | 8 | 16 over a latent of 32, a dense first
layer, 8 routed experts top 3 and 2 shared, 3 layers): whole runs of
``drivers/rollout_moe.py`` through the harness, ``correct`` false with the
timed path broken, the float8 control against the limits, the frozen counts
against a hand count, and the benchmark's reference against the program's
own (``mapf_gpt_tpu_torch/models/moonlight_reference.py``)."""

import json
from pathlib import Path

import pytest
import torch

from perfbench import frozen_moe, harness, moe_weights
from perfbench.drivers import rollout_moe
from perfbench.reference import moonlight as ref_moon

ROOT = Path(__file__).resolve().parents[2]
CELL = "rollout-moonlight-random21"
TINY = {"num_hidden_layers": 3, "hidden_size": 64, "num_attention_heads": 2, "kv_lora_rank": 32,
        "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16, "intermediate_size": 64,
        "moe_intermediate_size": 16, "n_routed_experts": 8, "num_experts_per_tok": 3}
# Limits at this size on the CPU (the ops' plain versions in bfloat16), between the
# program's readings here (seeds 4000000011, 3000000017, 123456789012: route_gap
# up to 3.4e-4, logit_err up to 2.5e-3) and the float8 control's (at least 8.9e-4
# and 0.0153): the cell's own limits are set on the card at its own size
# (limits/rollout-moonlight-random21.json).
SMALL = {"config": TINY, "limits": {"route_gap": 0.0006, "logit_err": 0.006},
         "traffic": {"envs": 2, "agents": 4, "steps": 3, "warmup_steps": 2, "check_envs": 1,
                     "check_rows": 4}}
SEED = 3000000017


def run_cell(capsys, trace: int = 0) -> dict:
    rc = harness.main(["--workload", CELL, "--seed", str(SEED), "--seconds", "0.5", "--trace",
                       str(trace)], require_chip=False, device="cpu", overrides=SMALL)
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    return json.loads(out[-1])


def test_the_cell_runs_correct_with_its_metrics(capsys):
    got = run_cell(capsys)
    assert got["correct"] is True and got["failed"] == 0 and got["attempted"] > 0
    assert set(got["metrics"]) == {"setup_s", "rollout_agent_steps_per_s"}
    assert set(got["compared"]) == {"token_mismatch", "state_mismatch", "bad_actions",
                                    "replay_logit_gap", "duplicate_choices",
                                    "choice_out_of_range", "route_gap", "logit_err"}


def test_a_traced_run_reads_the_counter_and_the_rate_of_products(capsys):
    got = run_cell(capsys, trace=1)
    assert got["correct"] is True
    # on the CPU no kernel runs: the rooflines and the route's device time read nothing
    assert set(got["metrics"]) == {"moe_rollout_mfu", "moe_load_max_over_mean.rollout"}
    assert got["metrics"]["moe_load_max_over_mean.rollout"]["value"] >= 1.0


def _wrong_experts(monkeypatch):
    from mapf_gpt_tpu_torch.ops import moe

    real = moe.route
    monkeypatch.setattr(moe, "route", lambda b, w3, *a, **k: real(b, -w3, *a, **k))


def _top_expert_twice(monkeypatch):
    """The top expert taken twice in place of the last choice: the reference,
    forced with the same choices, computes the same sum, and the forced
    duplicate lies above the reference's k-th score."""
    from mapf_gpt_tpu_torch.ops import moe

    real = moe.route

    def twice(*args, **kwargs):
        a, table, slot, w, idx = real(*args, **kwargs)
        idx, slot = idx.clone(), slot.clone()
        idx[:, -1], slot[:, -1] = idx[:, 0], slot[:, 0]
        return a, table, slot, w, idx
    monkeypatch.setattr(moe, "route", twice)


def _no_shared_expert(monkeypatch):
    from mapf_gpt_tpu_torch.ops import moe

    real = moe.combine
    monkeypatch.setattr(moe, "combine", lambda h, ys, *a: real(h, ys * 0, *a))


def _token_altered(monkeypatch):
    from mapf_gpt_tpu_torch.parallel import rollout

    real = rollout.observe

    def altered(*args):
        tokens = real(*args).clone()
        tokens[..., 0] = (tokens[..., 0] + 1) % 67
        return tokens
    monkeypatch.setattr(rollout, "observe", altered)


@pytest.mark.parametrize("fault,fails", [(_wrong_experts, "route_gap"),
                                         (_top_expert_twice, "duplicate_choices"),
                                         (_no_shared_expert, "logit_err"),
                                         (_token_altered, "token_mismatch")],
                         ids=lambda x: x if isinstance(x, str) else x.__name__.strip("_"))
def test_a_broken_timed_path_is_not_correct(capsys, monkeypatch, fault, fails):
    fault(monkeypatch)
    got = run_cell(capsys)
    assert got["correct"] is False
    c = got["compared"][fails]
    assert c["value"] > c["limit"], got["compared"]


def test_the_float8_control_fails_the_limits():
    config, traffic, limits, _, _, _ = harness.load_cell(CELL)
    run = harness.Run(workload=CELL, config=dict(config, **SMALL["config"]),
                      traffic=dict(traffic, **SMALL["traffic"]),
                      limits=dict(limits, **SMALL["limits"]), seed=4000000011, seconds=0.0,
                      trace=False, device="cpu")
    got = rollout_moe.readings(run)
    lim = SMALL["limits"]
    assert all(got["program"][k] <= v for k, v in lim.items()), got["program"]
    assert any(got["control"][k] > v for k, v in lim.items()), got["control"]


def test_the_frozen_count_against_a_hand_count():
    cfg = json.loads((ROOT / "perfbench/configs/moonlight-16B-A3B-mapf.json").read_text())
    assert frozen_moe.forward_flops(cfg) == 1125443973120        # 1.12544 TFLOP a context
    # by hand at the small size, multiply-adds a row: q 64x48, latent 64x40,
    # keys|values 32x64, scores 256x48 and P V 256x32, output 32x64; dense
    # 3x64x64; MoE router 64x8, 3 experts 3x64x16 each, shared 3x64x32; head 64x67
    small = dict(cfg, **TINY)
    attn = 64 * 48 + 64 * 40 + 32 * 64 + 256 * 48 + 256 * 32 + 32 * 64
    moe = 64 * 8 + 3 * 3 * 64 * 16 + 3 * 64 * 32
    full = 256 * (attn + 3 * 64 * 64) + 256 * (attn + moe)
    last = 256 * (64 * 40 + 32 * 64) + (64 * 48 + 256 * 48 + 256 * 32 + 32 * 64) + moe
    assert frozen_moe.forward_flops(small) == 2 * (full + last + 64 * 67)
    assert frozen_moe.experts_flops(small, 2) == 2 * 3 * 3 * 64 * 16 * (2 * 256 + 2)
    assert moe_weights.parameter_count(cfg) == 15289296000      # 30.6 GB in bf16


def test_the_benchmarks_reference_equals_the_programs_own():
    from mapf_gpt_tpu_torch.models import moonlight, moonlight_reference

    cfg = dict(json.loads((ROOT / "perfbench/configs/moonlight-16B-A3B-mapf.json").read_text()),
               **TINY)
    pcfg = rollout_moe.program_config(cfg)
    sd = {}
    for key, part in moe_weights.draw(cfg, 11, "cpu"):
        prefix = "" if isinstance(key, str) else f"model.layers.{key}."
        sd.update({prefix + k: (v * 4 if v.dim() >= 2 else v) for k, v in part.items()})
    for i in range(1, cfg["num_hidden_layers"]):
        sd[f"model.layers.{i}.mlp.gate.e_score_correction_bias"] = torch.linspace(-0.2, 0.2, 8)
    tokens = torch.randint(0, 67, (3, 256), generator=torch.Generator().manual_seed(2))

    def parts():
        yield "embed", {"model.embed_tokens.weight": sd["model.embed_tokens.weight"]}
        for i in range(cfg["num_hidden_layers"]):
            p = f"model.layers.{i}."
            yield i, {k[len(p):]: v for k, v in sd.items() if k.startswith(p)}
        yield "head", {k: sd[k] for k in ("model.norm.weight", "lm_head.weight")}

    got, _, _ = ref_moon.logits_streamed(parts(), tokens, cfg, 2)
    want = moonlight_reference.logits(sd, tokens, pcfg)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)
    assert isinstance(moonlight.CONFIGS["Moonlight-16B-A3B"], moonlight.MoonlightConfig)


def test_the_configuration_keeps_the_published_sizes():
    entry = next(c for c in json.loads((ROOT / "BENCHMARK.json").read_text())["configs"]
                 if c["name"] == "moonlight-16B-A3B-mapf")
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert entry["reduced"] == cfg["reduced"] == ["vocab_size"]
    published = {"num_hidden_layers": 27, "hidden_size": 2048, "num_attention_heads": 16,
                 "kv_lora_rank": 512, "q_lora_rank": None, "qk_nope_head_dim": 128,
                 "qk_rope_head_dim": 64, "v_head_dim": 128, "intermediate_size": 11264,
                 "moe_intermediate_size": 1408, "n_routed_experts": 64, "n_shared_experts": 2,
                 "num_experts_per_tok": 6, "first_k_dense_replace": 1,
                 "routed_scaling_factor": 2.446, "rms_norm_eps": 1e-5, "rope_theta": 50000,
                 "scoring_func": "sigmoid", "topk_method": "noaux_tc", "n_group": 1,
                 "topk_group": 1, "norm_topk_prob": True, "tie_word_embeddings": False,
                 "num_nextn_predict_layers": 0}
    assert {k: cfg[k] for k in published} == published
    assert cfg["vocab_size"] == 67 and cfg["reduced_from"] == {"vocab_size": 163840}


def test_the_cells_code_loads_nothing_of_jax():
    import subprocess
    import sys

    code = ("import sys, json; sys.path.insert(0, '.'); from perfbench import harness; "
            "import perfbench.drivers.rollout_moe; "
            "[harness.metric_reader(m['name']) for m in "
            "json.load(open('BENCHMARK.json'))['per_layer']]; "
            "import mapf_gpt_tpu_torch.models.moonlight; print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
