"""Checkpoints as torch files in the reference layout, with resume.

The port's counterpart of ``mapf_gpt_tpu/utils/checkpoint.py`` (orbax
there): one file per step, ``<dir>/ckpt_<step>.pt``, holding
``{"model": state_dict, "optimizer": ..., "model_args": {...},
"iter_num": step, "best_val_loss": ..., "metadata": {...}}``, the
reference trainer's layout, so ``models/convert.load_reference_checkpoint``
reads a saved file and the port's rollout runs it.  The newest ``keep``
files are kept (3, as the JAX package's ``max_to_keep``).  A file is
written under a temporary name and renamed, so a reader never sees half of
one.
"""

from __future__ import annotations

import os
import re

import torch

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


def _steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(ckpt_dir)) if m)


def checkpoint_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"ckpt_{step:08d}.pt")


def save_checkpoint(ckpt_dir: str, step: int, model, optimizer_state: dict | None = None,
                    metadata: dict | None = None, best_val_loss: float | None = None,
                    keep: int = 3) -> str:
    """Write the model (fp32 state dict on the CPU, reference keys), the
    optimizer's state and the step; drop all but the newest `keep` files.
    Returns the file's path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    cfg = model.cfg
    state = {
        "model": {k: v.detach().float().cpu() for k, v in model.state_dict().items()},
        "optimizer": optimizer_state,
        "model_args": {"n_layer": cfg.n_layer, "n_head": cfg.n_head, "n_embd": cfg.n_embd,
                       "block_size": cfg.block_size, "vocab_size": cfg.vocab_size,
                       "bias": cfg.bias, "dropout": cfg.dropout},
        "iter_num": step,
        "best_val_loss": best_val_loss,
        "metadata": metadata or {},
    }
    path = checkpoint_path(ckpt_dir, step)
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)
    for old in _steps(ckpt_dir)[:-keep]:
        os.remove(checkpoint_path(ckpt_dir, old))
    return path


def latest_step(ckpt_dir: str) -> int | None:
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def restore_checkpoint(ckpt_dir: str, step: int | None = None) -> dict:
    """The saved dict of `step` (the newest if None), tensors on the CPU."""
    if step is None:
        step = latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    return torch.load(checkpoint_path(ckpt_dir, step), map_location="cpu", weights_only=False)
