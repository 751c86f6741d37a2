"""The benchmark's one door into the program under test (``mapf_gpt_tpu_torch``):
the policy built from the benchmark's weights."""

from __future__ import annotations

import torch


def build_model(cfg: dict, weights: dict, device, train: bool):
    """The program's ``GPT`` for a configuration file's sizes, on `device`, with
    the benchmark's weights copied in: in train mode with gradients for
    training, frozen in eval mode otherwise."""
    from mapf_gpt_tpu_torch.models.gpt import GPT, GPTConfig

    gpt_cfg = GPTConfig(block_size=cfg["block_size"], vocab_size=cfg["vocab_size"],
                        n_layer=cfg["n_layer"], n_head=cfg["n_head"], n_embd=cfg["n_embd"],
                        dropout=cfg["dropout"], bias=cfg["bias"],
                        dtype=getattr(torch, cfg["dtype"]))
    with torch.device(device):
        model = GPT(gpt_cfg)
    model.load_state_dict(weights, strict=True)
    return model.train() if train else model.eval().requires_grad_(False)
