"""Imitation-training loop and CLI: the port of ``mapf_gpt_tpu/train/loop.py``.

Usage:

    python -m mapf_gpt_tpu_torch.train.loop --model 6M \\
        --train-data dataset/train --valid-data dataset/validation \\
        --out-dir out [--max-iters 30000] [--batch-size 2048] [--resume] \\
        [--device cuda|cpu]

The JAX trainer's behaviour and flags: cosine learning rate with warmup,
eval every ``--eval-interval`` iterations over ``--eval-iters`` batches, a
checkpoint at each eval after the first iteration (the newest 3 kept),
resume from the newest checkpoint, gradient accumulation, loss / it/s / MFU
logging, a ``--config`` file and ``--key=value`` overrides.  Parameters
start from ``models.gpt.init_params`` under ``--seed``.  On CUDA the loss
and its gradients run through the fused training kernels
(``train/train_step.select_loss_fn``); on the CPU through the module.
``--wandb-project`` logs to wandb where it is installed and is ignored
otherwise.

``--distributed`` runs one process per device on ``torch.distributed``
(``parallel/mesh.py``: NCCL on CUDA, gloo on the CPU), with the coordinates
the JAX loop reads (``MAPF_GPT_TPU_COORDINATOR``,
``MAPF_GPT_TPU_NUM_PROCESSES``, ``MAPF_GPT_TPU_PROCESS_ID``) or torchrun's.
Parameters start from rank 0's; each process reads its own shard files and
micro-batches of ``--batch-size``; the gradients and the loss are averaged
once a step, after the accumulation; the eval means are averaged across
processes; rank 0 saves the checkpoints and logs, the others wait at a
barrier.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
import torch.distributed as dist

from mapf_gpt_tpu_torch.models.gpt import CONFIGS, GPT, init_params
from mapf_gpt_tpu_torch.parallel import mesh
from mapf_gpt_tpu_torch.train.data import ArrowShardStream
from mapf_gpt_tpu_torch.train.train_step import (TrainConfig, make_eval_step, make_optimizer,
                                                 make_train_step)
from mapf_gpt_tpu_torch.utils import checkpoint as ckpt
from mapf_gpt_tpu_torch.utils.profiling import Meter, chip_peak_flops, transformer_flops_per_token

# reference schedules (the JAX package's configs/config-{2M,6M,85M}.py)
DEFAULTS = {
    "2M": dict(batch_size=4096, max_iters=30000),
    "6M": dict(batch_size=2048, max_iters=30000),
    "85M": dict(batch_size=512, max_iters=400000),
}


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model", default="6M", choices=list(CONFIGS))
    p.add_argument("--train-data", required=True)
    p.add_argument("--valid-data", default=None)
    p.add_argument("--out-dir", default="out")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--max-iters", type=int, default=None)
    p.add_argument("--grad-accum", type=int, default=16)
    p.add_argument("--eval-interval", type=int, default=500)
    p.add_argument("--eval-iters", type=int, default=40)
    p.add_argument("--log-interval", type=int, default=10)
    p.add_argument("--learning-rate", type=float, default=6e-4)
    p.add_argument("--seed", type=int, default=1337)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--wandb-project", default=None,
                   help="optional wandb logging; ignored if wandb is not installed")
    p.add_argument("--distributed", action="store_true",
                   help="one process per device on torch.distributed")
    p.add_argument("--config", default=None,
                   help="python config file exec'd over the parsed args "
                        "(the reference configurator semantics)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args, extra = p.parse_known_args(argv)
    from mapf_gpt_tpu_torch.utils.configurator import apply_config

    apply_config(args, config_file=args.config,
                 overrides=[e for e in extra if e.startswith("--")])
    return args


def train(args) -> dict:
    """Run the loop; with --distributed inside a process group that it
    joins here and leaves at the end."""
    if not args.distributed:
        return _train(args, 0, 1, torch.device(args.device))
    rank, world, device = mesh.init_process_group(args.device)
    try:
        return _train(args, rank, world, device)
    finally:
        dist.destroy_process_group()


def _train(args, rank: int, world: int, device: torch.device) -> dict:
    is_main = rank == 0
    cfg = CONFIGS[args.model]
    d = DEFAULTS[args.model]
    batch_size = args.batch_size or d["batch_size"]
    max_iters = args.max_iters or d["max_iters"]
    tc = TrainConfig(learning_rate=args.learning_rate, min_lr=args.learning_rate / 10,
                     lr_decay_iters=max_iters, grad_accum=args.grad_accum)

    model = GPT(cfg)
    gen = torch.Generator().manual_seed(args.seed)
    model.load_state_dict(init_params(cfg, gen), strict=True)
    model.to(device).train()
    optimizer = make_optimizer(model, tc)
    start_iter = 0
    if args.resume:
        saved = ckpt.restore_checkpoint(args.out_dir)
        model.load_state_dict(saved["model"], strict=True)
        optimizer.load_state_dict(saved["optimizer"])
        start_iter = int(saved["iter_num"])
        if is_main:
            print(f"resumed from {args.out_dir} at iter {start_iter}")
    sync = None
    if args.distributed:
        mesh.broadcast_parameters(optimizer.params)
        sync = mesh.all_reduce_mean

    step_fn = make_train_step(model, tc, optimizer, sync=sync)
    eval_fn = make_eval_step(model)
    train_stream = iter(ArrowShardStream(args.train_data, batch_size, args.grad_accum,
                                         process_index=rank, process_count=world,
                                         seed=args.seed))
    valid_stream = (iter(ArrowShardStream(args.valid_data, batch_size, 1, process_index=rank,
                                          process_count=world, seed=args.seed + 1))
                    if args.valid_data else None)

    # 6N + 12LHQT is already the fwd+bwd per-token estimate (PaLM appendix B)
    flops_per_step = (transformer_flops_per_token(
        model.num_params(), cfg.n_layer, cfg.n_head, cfg.n_embd // cfg.n_head,
        cfg.block_size) * cfg.block_size * batch_size * args.grad_accum)
    meter = Meter(flops_per_step, chip_peak_flops(device))
    history, evals = [], []

    wandb = None
    if getattr(args, "wandb_project", None) and is_main:
        try:
            import wandb as _wandb

            wandb = _wandb
            wandb.init(project=args.wandb_project,
                       config={"model": args.model, "batch": batch_size,
                               "max_iters": max_iters, **tc._asdict()})
        except ImportError:
            print("wandb not installed; --wandb-project ignored")

    def on_device(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(device, non_blocking=True)

    def run_eval():
        if valid_stream is None:
            return None
        losses, accs = [], []
        for _ in range(args.eval_iters):
            x, y = next(valid_stream)
            loss, acc = eval_fn(on_device(x[0]), on_device(y[0]))
            losses.append(loss.item())
            accs.append(acc.item())
        means = [float(np.mean(losses)), float(np.mean(accs))]
        if args.distributed:
            means = torch.tensor(means, dtype=torch.float64, device=device)
            mesh.all_reduce_mean([means])
            means = means.tolist()
        return means[0], means[1]

    t_start = time.time()
    for it in range(start_iter, max_iters + 1):
        if it % args.eval_interval == 0:
            ev = run_eval()
            if ev:
                evals.append({"iter": it, "val_loss": ev[0], "val_acc": ev[1]})
                if is_main:
                    print(f"iter {it}: val_loss {ev[0]:.4f} val_acc {ev[1]:.4f}")
                if wandb:
                    wandb.log({"val/loss": ev[0], "val/acc": ev[1]}, step=it)
            if it > start_iter:
                if is_main:
                    ckpt.save_checkpoint(args.out_dir, it, model, optimizer.state_dict(),
                                         metadata={"model": args.model,
                                                   "val_loss": ev[0] if ev else None})
                if args.distributed:
                    dist.barrier()   # no process reads on before rank 0's file is written
        if it == max_iters:
            break
        x, y = next(train_stream)
        loss = step_fn(on_device(x), on_device(y))
        if it % args.log_interval == 0:
            loss = loss.item()  # host sync point
            sps, mfu = meter.tick(steps=args.log_interval)
            history.append({"iter": it, "loss": loss})
            mfu_text = "n/a" if mfu is None else f"{mfu * 100:.1f}%"
            if is_main:
                print(f"iter {it}: loss {loss:.4f} | {sps:.2f} it/s | mfu {mfu_text}")
            if wandb:
                wandb.log({"train/loss": loss, "perf/steps_per_s": sps,
                           **({"perf/mfu": mfu} if mfu is not None else {})}, step=it)
    return {"iters": max_iters, "history": history, "evals": evals,
            "wall_s": time.time() - t_start, "meter": meter}


if __name__ == "__main__":
    result = train(parse_args())
    print(json.dumps({"final_loss": result["history"][-1]["loss"]
                      if result["history"] else None,
                      "wall_s": result["wall_s"]}))
