"""Weights carried across: JAX params or reference ``.pt`` -> the port's GPT.

- :func:`params_to_state_dict` takes the JAX package's flax params (a nested
  dict of numpy arrays, with or without the top ``"params"`` level) and
  returns the port's state dict in the reference key layout (the inverse of
  ``mapf_gpt_tpu/models/convert.py::torch_state_dict_to_params``); with
  ``bias=True`` the Dense and LayerNorm ``bias`` leaves become the
  ``.bias`` keys.
- :func:`state_dict_to_params` is its inverse: a state dict (or a model's
  gradients, :func:`grads_to_params`) -> the flax layout as numpy arrays,
  under a top ``"params"`` level, so port and JAX trees compare key by key.
- :func:`load_reference_checkpoint` reads a reference-layout ``.pt``
  (``{"model": state_dict, "model_args": {...}, ...}``) with torch alone,
  ``bias`` taken from its ``model_args``.
- :func:`load_model` builds the :class:`GPT` from either on a device, for
  inference (frozen parameters).

Torch ``nn.Linear`` stores [out, in]; flax Dense kernels are [in, out],
hence the transposes.  A ``_orig_mod.`` prefix from torch.compile
checkpoints is stripped.
"""

from __future__ import annotations

import numpy as np
import torch

from mapf_gpt_tpu_torch.models.gpt import GPT, GPTConfig


def strip_prefix(state_dict: dict, prefix: str = "_orig_mod.") -> dict:
    return {k[len(prefix):] if k.startswith(prefix) else k: v
            for k, v in state_dict.items()}


_LINEARS = (("attn", "c_attn"), ("attn", "c_proj"), ("mlp", "c_fc"), ("mlp", "c_proj"))


def params_to_state_dict(params: dict, cfg: GPTConfig) -> dict[str, torch.Tensor]:
    """Flax params (nested dict of numpy arrays) -> reference-layout state
    dict, with the biases when ``cfg.bias``."""
    p = params["params"] if "params" in params else params
    t32 = lambda a: torch.from_numpy(np.array(a, dtype=np.float32))

    def ln(key: str, leaf: dict) -> None:
        sd[f"{key}.weight"] = t32(leaf["scale"])
        if cfg.bias:
            sd[f"{key}.bias"] = t32(leaf["bias"])

    sd = {"transformer.wte.weight": t32(p["wte"]), "transformer.wpe.weight": t32(p["wpe"])}
    ln("transformer.ln_f", p["ln_f"])
    for i in range(cfg.n_layer):
        b, t = p[f"h_{i}"], f"transformer.h.{i}"
        ln(f"{t}.ln_1", b["ln_1"])
        ln(f"{t}.ln_2", b["ln_2"])
        for mod, sub in _LINEARS:
            sd[f"{t}.{mod}.{sub}.weight"] = t32(np.asarray(b[mod][sub]["kernel"]).T)
            if cfg.bias:
                sd[f"{t}.{mod}.{sub}.bias"] = t32(b[mod][sub]["bias"])
    sd["lm_head.weight"] = sd["transformer.wte.weight"]
    return sd


def state_dict_to_params(sd: dict, cfg: GPTConfig) -> dict:
    """Reference-layout state dict -> ``{"params": flax params}`` of fp32
    numpy arrays (the inverse of :func:`params_to_state_dict`)."""
    sd = strip_prefix(sd)
    a = lambda k: sd[k].detach().float().cpu().numpy()

    def ln(key: str) -> dict:
        leaf = {"scale": a(f"{key}.weight")}
        if cfg.bias:
            leaf["bias"] = a(f"{key}.bias")
        return leaf

    p = {"wte": a("transformer.wte.weight"), "wpe": a("transformer.wpe.weight"),
         "ln_f": ln("transformer.ln_f")}
    for i in range(cfg.n_layer):
        t = f"transformer.h.{i}"
        b = {"ln_1": ln(f"{t}.ln_1"), "ln_2": ln(f"{t}.ln_2"), "attn": {}, "mlp": {}}
        for mod, sub in _LINEARS:
            key = f"{t}.{mod}.{sub}"
            b[mod][sub] = {"kernel": np.ascontiguousarray(a(f"{key}.weight").T)}
            if cfg.bias:
                b[mod][sub]["bias"] = a(f"{key}.bias")
        p[f"h_{i}"] = b
    return {"params": p}


def grads_to_params(model: GPT) -> dict:
    """A model's parameter gradients in the flax layout (the tied head's
    gradient is the token embedding's, counted once)."""
    sd = {name: p.grad for name, p in model.named_parameters()}
    sd["lm_head.weight"] = sd["transformer.wte.weight"]
    return state_dict_to_params(sd, model.cfg)


def load_reference_checkpoint(path: str) -> tuple[GPTConfig, dict[str, torch.Tensor]]:
    """Read a reference ``.pt`` -> (GPTConfig, fp32 state dict on the CPU)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    args = dict(ckpt["model_args"])
    cfg = GPTConfig(block_size=args.get("block_size", 256),
                    vocab_size=args.get("vocab_size", 67),
                    n_layer=args["n_layer"], n_head=args["n_head"],
                    n_embd=args["n_embd"], bias=bool(args.get("bias", False)))
    sd = {k: v.detach().float() for k, v in strip_prefix(ckpt["model"]).items()}
    return cfg, sd


def load_model(cfg: GPTConfig, state_dict: dict, device: str | torch.device = "cuda") -> GPT:
    """A GPT with these weights on `device` for inference: in eval mode,
    its parameters frozen (``requires_grad_()`` makes them trainable)."""
    model = GPT(cfg)
    model.load_state_dict(state_dict, strict=True)
    return model.to(device).eval().requires_grad_(False)
