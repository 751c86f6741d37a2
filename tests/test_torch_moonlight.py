"""The Moonlight-16B-A3B policy (``models/moonlight.py``, ``ops/moe.py``) on the
CPU, against the plain float32 reference (``models/moonlight_reference.py``)
at a small size that keeps every shape relation of the published one: MLA
with 2 heads of 16 | 8 nope | rope columns and 16 value columns over a latent
of 32, a dense first layer, then 8 routed experts of which 3 are chosen and 2
shared ones, 3 layers.  The ops run their plain versions here (the kernels of
``csrc/moe.cu`` only on the card), rounding where the kernels round.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mapf_gpt_tpu_torch.envs import env as menv
from mapf_gpt_tpu_torch.maps import random_grid, sample_instance
from mapf_gpt_tpu_torch.models import moonlight as ml
from mapf_gpt_tpu_torch.models import moonlight_reference as ref
from mapf_gpt_tpu_torch.models.gpt import make_forward
from mapf_gpt_tpu_torch.ops import moe
from mapf_gpt_tpu_torch.parallel import rollout

CFG = ml.MoonlightConfig(n_layer=3, hidden_size=64, n_head=2, kv_lora_rank=32,
                         qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
                         intermediate_size=64, moe_intermediate_size=16, n_routed_experts=8,
                         num_experts_per_tok=3, n_shared_experts=2)
GAIN = 4.0   # the weights scaled up, so that every layer moves the logits


def _weights(seed=0, bias=False):
    sd = ml.init_params(CFG, torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    for k, v in sd.items():
        if v.dim() >= 2:
            sd[k] = v * GAIN
        elif k.endswith("e_score_correction_bias") and bias:
            sd[k] = torch.randn(v.shape, generator=g) * 0.3
    return sd


def _model(sd):
    return ml.load_state(CFG, dict(sd))


def _tokens(n=4, seed=0):
    return torch.randint(0, 67, (n, CFG.block_size), generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("bias", [False, True], ids=["bias0", "bias"])
def test_logits_against_the_reference_at_the_last_position(bias):
    sd = _weights(bias=bias)
    tokens = _tokens()
    got = _model(sd)(tokens)
    want = ref.logits(sd, tokens, CFG)
    # bf16 between ops against float32 throughout: about 1 % of the logits' size
    assert (got - want).abs().max() <= 0.02 * want.abs().max()
    # the layers matter at this size: leaving the last one out misses by more
    short = dataclasses.replace(CFG, n_layer=2)
    h = ref.hidden(sd, tokens, short)[:, -1]
    skipped = ref.rms_norm(h, sd["model.norm.weight"], 1e-5) @ sd["lm_head.weight"].float().t()
    assert (skipped - want).abs().max() > 5 * (got - want).abs().max()


def test_logits_against_the_reference_at_every_position():
    """Where a position's expert choices agree with the reference's in every
    layer, its logits are within the bound; the others are near-ties of the
    reference's biased scores (the k-th and the next within 0.005), which
    bf16 rounding may order the other way, and rare."""
    sd = _weights(bias=True)
    tokens = _tokens(2)
    model = _model(sd)
    model.capture = []
    got = model(tokens, last_only=False)
    record = []
    h = sd["model.embed_tokens.weight"].float()[tokens.long()]
    for i in range(CFG.n_layer):
        h = ref.layer(h, sd, i, CFG, record=record)
    want = ref.rms_norm(h, sd["model.norm.weight"], 1e-5) @ sd["lm_head.weight"].float().t()
    assert got.shape == want.shape == (2, CFG.block_size, 67)
    k = CFG.num_experts_per_tok
    flipped = torch.zeros(2 * CFG.block_size, dtype=torch.bool)
    for idx, (want_idx, biased) in zip(model.capture, record):
        differ = (idx.long().sort(-1).values != want_idx.sort(-1).values).any(-1)
        ranked = biased.sort(-1, descending=True).values
        assert bool((ranked[differ, k - 1] - ranked[differ, k] < 0.005).all())
        flipped |= differ
    assert int(flipped.sum()) <= 0.01 * len(flipped)
    err = (got - want).abs().amax(-1).reshape(-1)
    assert err[~flipped].max() <= 0.02 * want.abs().max()


def test_the_thinned_last_layer_equals_the_full_one():
    model = _model(_weights(bias=True))
    tokens = _tokens(3)
    assert torch.equal(model(tokens), model(tokens, last_only=False)[:, -1])


def test_router_choices_and_weights_equal_the_references():
    g = torch.Generator().manual_seed(5)
    b = torch.randn((500, CFG.hidden_size), generator=g).to(torch.bfloat16)
    weight = torch.randn((CFG.n_routed_experts, CFG.hidden_size), generator=g) * 0.05
    scratch = torch.zeros(2 * CFG.n_routed_experts, dtype=torch.int32)
    k, scale = CFG.num_experts_per_tok, CFG.routed_scaling_factor
    no_bias = torch.zeros(CFG.n_routed_experts)
    bias = torch.randn(CFG.n_routed_experts, generator=g) * 0.3
    for bb in (no_bias, bias):
        _, _, _, w, idx = moe.route(b, moe.split3(weight), bb, k, scale, scratch)
        want_idx, want_w, _ = ref.route(b.float(), weight, bb, CFG)
        assert torch.equal(idx.long(), want_idx)
        assert torch.allclose(w, want_w, rtol=1e-6, atol=1e-7)
    # the bias changes the choice (and the weights stay those of the unbiased scores)
    assert not torch.equal(ref.route(b.float(), weight, bias, CFG)[0],
                           ref.route(b.float(), weight, no_bias, CFG)[0])
    assert torch.equal(scratch[:CFG.n_routed_experts], torch.zeros(CFG.n_routed_experts,
                                                                   dtype=torch.int32))


def test_the_router_weight_splits_exactly_into_three_bf16_terms():
    w = torch.randn((8, 64), generator=torch.Generator().manual_seed(2))
    w3 = moe.split3(w).float()
    assert torch.equal(w3[:, :8] + w3[:, 8:16] + w3[:, 16:], w.t())


def test_two_shared_experts_are_one_swiglu_of_twice_the_width():
    g = torch.Generator().manual_seed(3)
    x = torch.randn((40, 64), generator=g)
    f = CFG.moe_intermediate_size
    gate, up, down = (torch.randn(s, generator=g) for s in ((2 * f, 64), (2 * f, 64), (64, 2 * f)))
    both = ref.swiglu(x, gate, up, down)
    apart = sum(ref.swiglu(x, gate[j * f:(j + 1) * f], up[j * f:(j + 1) * f],
                           down[:, j * f:(j + 1) * f]) for j in range(2))
    assert torch.allclose(both, apart, rtol=1e-5, atol=1e-4)


def _route(m=300, seed=7):
    g = torch.Generator().manual_seed(seed)
    b = torch.randn((m, CFG.hidden_size), generator=g).to(torch.bfloat16)
    w3 = moe.split3(torch.randn((CFG.n_routed_experts, CFG.hidden_size), generator=g) * 0.05)
    bias = torch.randn(CFG.n_routed_experts, generator=g) * 0.1
    counter = torch.zeros(CFG.n_routed_experts, dtype=torch.int64)
    scratch = torch.zeros(2 * CFG.n_routed_experts, dtype=torch.int32)
    out = moe.route(b, w3, bias, CFG.num_experts_per_tok, CFG.routed_scaling_factor, scratch,
                    counter)
    return b, counter, out


def test_the_permutation_groups_every_pair_by_expert_in_padded_segments():
    b, counter, (a, table, slot, w, idx) = _route()
    x, k = CFG.n_routed_experts, CFG.num_experts_per_tok
    assert a.shape[0] == moe.capacity(b.shape[0], k, x)
    counts = torch.bincount(idx.reshape(-1).long(), minlength=x)
    assert torch.equal(counter, counts)
    tile_start, row0 = table[:x + 1].long(), table[x + 1:].long()
    assert torch.equal(tile_start[1:] - tile_start[:-1], (counts + moe.BM - 1) // moe.BM)
    assert torch.equal(row0, tile_start[:-1] * moe.BM)
    flat = slot.reshape(-1).long()
    assert len(set(flat.tolist())) == len(flat)                       # one row a pair
    e = idx.reshape(-1).long()
    assert bool(((flat >= row0[e]) & (flat < row0[e] + counts[e])).all())   # in its segment
    assert torch.equal(a[flat], b.repeat_interleave(k, dim=0))


def test_the_grouped_products_run_each_segment_on_its_own_experts_weights():
    b, _, (a, table, slot, w, idx) = _route()
    x, e, f = CFG.n_routed_experts, CFG.hidden_size, CFG.moe_intermediate_size
    g = torch.Generator().manual_seed(9)
    gate, up = (torch.randn((x, f, e), generator=g).to(torch.bfloat16) for _ in range(2))
    down = torch.randn((x, e, f), generator=g).to(torch.bfloat16)
    wgu = ml.interleave_gate_up(gate, up).reshape(x * e, 2 * f)
    wd = down.transpose(1, 2).reshape(x * f, e)
    y = moe.grouped(moe.swiglu(a, wgu, table, x), wd, table, x)
    for row in range(0, b.shape[0], 37):
        for j in range(CFG.num_experts_per_tok):
            ex = int(idx[row, j])
            gg = (b[row].float() @ gate[ex].float().t()).to(torch.bfloat16).float()
            uu = (b[row].float() @ up[ex].float().t()).to(torch.bfloat16).float()
            hm = (torch.nn.functional.silu(gg) * uu).to(torch.bfloat16).float()
            want = (hm @ down[ex].float().t()).to(torch.bfloat16)
            assert torch.equal(y[slot[row, j]], want)


def test_combine_adds_the_shared_and_the_weighted_experts_in_order():
    b, _, (a, table, slot, w, idx) = _route(m=50)
    g = torch.Generator().manual_seed(4)
    y = torch.randn((a.shape[0], CFG.hidden_size), generator=g).to(torch.bfloat16)
    ys = torch.randn((50, CFG.hidden_size), generator=g).to(torch.bfloat16)
    h = torch.randn((50, CFG.hidden_size), generator=g).to(torch.bfloat16)
    want = h.float() + ys.float()
    for j in range(CFG.num_experts_per_tok):
        want = want + w[:, j:j + 1] * y[slot[:, j].long()].float()
    got = moe.combine(h.clone(), ys, y, slot, w)
    assert (got.float() - want).abs().max() <= 0.01 * want.abs().max()


def test_rope_rotates_pairs_as_the_reference():
    g = torch.Generator().manual_seed(6)
    t, hh, d, dn, r = 8, CFG.n_head, CFG.head_dim, CFG.qk_nope_head_dim, CFG.kv_lora_rank
    q = torch.randn((t, hh * d), generator=g).to(torch.bfloat16)
    kva = torch.randn((t, r + d - dn), generator=g).to(torch.bfloat16)
    kv = torch.zeros((t, hh * 2 * d), dtype=torch.bfloat16)
    cos, sin = moe.rope_tables(t, d - dn, CFG.rope_theta)
    want_q = ref.rope(q.float().view(t, hh, d)[..., dn:].transpose(0, 1), *ref.rope_tables(
        t, d - dn, CFG.rope_theta))
    want_k = ref.rope(kva.float()[:, r:], *ref.rope_tables(t, d - dn, CFG.rope_theta))
    moe.rope(q, kva, kv, cos, sin, hh, d, dn, r, t)
    assert torch.allclose(q.view(t, hh, d)[..., dn:].float().transpose(0, 1), want_q, atol=0.02)
    for head in range(hh):
        assert torch.allclose(kv.view(t, hh, 2 * d)[:, head, dn:d].float(), want_k, atol=0.02)


def _instances(envs=2, agents=4, steps=4):
    insts = [sample_instance(random_grid(10, 0.3, s), agents, seed=s) for s in range(envs)]
    grids = np.stack([i.grid for i in insts])
    spec = menv.MapfEnvSpec(height=grids.shape[1], width=grids.shape[2], num_agents=agents,
                            max_episode_steps=steps)
    return spec, (grids, np.stack([i.starts for i in insts]), np.stack([i.goals for i in insts]),
                  np.ones((envs, agents), bool))


def test_a_seeded_batch_rollout_is_deterministic_and_tokenizes_as_the_gpt_path(monkeypatch):
    model = _model(_weights(bias=True))
    spec, inst = _instances()
    seen, acted = [], []
    real_observe, real_act = rollout.observe, rollout.act

    def observe(*args):
        tokens = real_observe(*args)
        seen.append(tokens.clone())
        return tokens

    def act(logits, *args, **kwargs):
        actions = real_act(logits, *args, **kwargs)
        acted.append(actions.clone())
        return actions

    monkeypatch.setattr(rollout, "observe", observe)
    monkeypatch.setattr(rollout, "act", act)
    runs = []
    for _ in range(2):
        seen.clear()
        acted.clear()
        run = rollout.make_batch_rollout(spec, model, do_sample=True)
        final, metrics = run(rollout.batch_reset(spec, *inst, device="cpu"),
                             torch.Generator().manual_seed(11))
        runs.append((torch.stack(seen), torch.stack(acted), final.pos, metrics.soc))
    for x, y in zip(*runs):
        assert torch.equal(x, y)
    tokens, actions = runs[0][0], runs[0][1].view(spec.max_episode_steps, 2, -1)
    # the same states through the model-free replay give the same tokens
    for env in range(2):
        one = rollout.batch_reset(spec, *(x[env:env + 1] for x in inst), device="cpu")
        _, replayed = rollout.replay_rollout(spec, one, actions[:, env])
        assert torch.equal(replayed[:-1], tokens[:, env])


def test_make_forward_takes_the_policy_by_the_same_entry():
    model = _model(_weights())
    tokens = _tokens(2)
    assert torch.equal(make_forward(model)(tokens), model(tokens))
    assert ml.CONFIGS["Moonlight-16B-A3B"].n_embd == 2048


def test_the_published_sizes_count_fifteen_billion_parameters():
    cfg = ml.CONFIGS["Moonlight-16B-A3B"]
    n = 2 * cfg.vocab_size * cfg.hidden_size + cfg.hidden_size + sum(
        int(np.prod(s)) for i in range(cfg.n_layer) for _, s in ml.layer_shapes(cfg, i))
    assert 15.2e9 < n < 15.4e9


def test_the_evaluator_and_the_clis_random_init_take_the_policy_by_name(monkeypatch):
    import argparse

    from mapf_gpt_tpu_torch.eval import harness as th
    from mapf_gpt_tpu_torch.eval import run as erun
    from mapf_gpt_tpu_torch.maps import MapRegistry

    monkeypatch.setitem(ml.CONFIGS, "moonlight-small", CFG)
    args = argparse.Namespace(weights=None, random_init="moonlight-small", weights_root=None,
                              device="cpu", model=None)
    model, name = erun.load_policy(args)
    assert isinstance(model, ml.MoonlightPolicy) and name == "moonlight-small-random"
    reg = MapRegistry()
    reg.register("tiny", random_grid(8, 0.1, 0))
    ev = th.Evaluator(reg, model, batch_envs=4, do_sample=False, device="cpu")
    rows = ev.run([th.EpisodeSpec("tiny", 2, s, max_episode_steps=3) for s in range(3)]).rows
    assert [r["seed"] for r in rows] == [0, 1, 2] and all(r["runtime"] > 0 for r in rows)
    assert th.context_bytes(CFG, (10, 10), 1, False) > th.context_bytes(None, (10, 10), 1, False)
