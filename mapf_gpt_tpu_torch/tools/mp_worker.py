"""One process of a multi-process check of ``parallel/mesh.py``, on the CPU
over gloo: ``tests/test_torch_distributed.py`` runs it alone and as two
processes and compares what they save.

    python -m mapf_gpt_tpu_torch.tools.mp_worker --mode train|rollout|loop \\
        --out result.npz [--rank R --world N --port P] [--data DIR]

Modes:

- ``train``: two ``train_step`` calls of a small fp32 config on one global
  batch [2, 64, 64]: alone on all of it, or each process on its
  ``local_slice`` with ``mesh.all_reduce_mean`` as the step's sync.  Saves
  the losses, the parameters and the Adam moments.
- ``rollout``: 8 maze instances stepped by ``make_batch_rollout`` (argmax),
  alone, or each process on its slice through ``mesh.sharded_rollout``.
  Saves the gathered per-env metrics.
- ``loop``: ``train.loop.train`` with ``--distributed`` for 2 iterations on
  the shards under ``--data`` (``train/`` and ``valid/``).  Saves the
  logged losses and the eval means, rank by rank.

With ``--rank`` the process joins a group of ``--world`` at
``localhost:--port``, through the JAX loop's environment variables.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def _small_cfg(block_size: int):
    from mapf_gpt_tpu_torch.models.gpt import GPTConfig

    return GPTConfig(n_layer=2, n_head=2, n_embd=64, block_size=block_size, dtype=torch.float32)


def _train(rank: int, world: int) -> dict:
    from mapf_gpt_tpu_torch.models.gpt import GPT, init_params
    from mapf_gpt_tpu_torch.parallel import mesh
    from mapf_gpt_tpu_torch.train import train_step as ts

    cfg = _small_cfg(64)
    tc = ts.TrainConfig(grad_accum=2, warmup_iters=1, lr_decay_iters=4, learning_rate=1e-3)
    model = GPT(cfg)
    model.load_state_dict(init_params(cfg, torch.Generator().manual_seed(7)))
    step = ts.make_train_step(model, tc, sync=mesh.all_reduce_mean if world > 1 else None)
    rng = np.random.RandomState(0)
    part = mesh.local_slice(64, rank, world)
    losses = []
    for _ in range(2):
        x = rng.randint(0, cfg.vocab_size, size=(2, 64, 64)).astype(np.int64)
        y = rng.randint(0, 5, size=(2, 64)).astype(np.int64)
        losses.append(step(torch.from_numpy(x[:, part]), torch.from_numpy(y[:, part])).item())
    out = {"loss": np.asarray(losses)}
    for name, p in model.named_parameters():
        out[f"param:{name}"] = p.detach().numpy()
    opt = step.optimizer
    for i, (m, v) in enumerate(zip(opt.mu, opt.nu)):
        out[f"mu:{i}"], out[f"nu:{i}"] = m.numpy(), v.numpy()
    return out


def _rollout(rank: int, world: int) -> dict:
    from mapf_gpt_tpu_torch.envs.env import MapfEnvSpec
    from mapf_gpt_tpu_torch.maps import maze_grid, sample_instance
    from mapf_gpt_tpu_torch.models.convert import load_model
    from mapf_gpt_tpu_torch.models.gpt import init_params
    from mapf_gpt_tpu_torch.parallel import mesh
    from mapf_gpt_tpu_torch.parallel.rollout import batch_reset, make_batch_rollout

    cfg = _small_cfg(256)   # the tokenizer's contexts
    model = load_model(cfg, init_params(cfg, torch.Generator().manual_seed(3)), device="cpu")
    insts = [sample_instance(maze_grid(9, seed=s), 4, seed=s) for s in range(8)]
    h, w = insts[0].grid.shape
    spec = MapfEnvSpec(height=h, width=w, num_agents=4, max_episode_steps=8)
    part = mesh.local_slice(8, rank, world)
    stack = lambda f: np.stack([f(i) for i in insts])[part]
    states = batch_reset(spec, stack(lambda i: i.grid), stack(lambda i: i.starts),
                         stack(lambda i: i.goals[:, None, :]), np.ones((8, 4), bool)[part],
                         device="cpu")
    run = make_batch_rollout(spec, model, do_sample=False)
    if world > 1:
        run = mesh.sharded_rollout(run)
    _, metrics = run(states)
    return {k: v.numpy() for k, v in metrics._asdict().items()}


def _loop(rank: int, data: str, out_dir: str) -> dict:
    from mapf_gpt_tpu_torch.train import loop

    args = loop.parse_args([
        "--model", "2M", "--device", "cpu", "--distributed", "--train-data",
        os.path.join(data, "train"), "--valid-data", os.path.join(data, "valid"),
        "--out-dir", out_dir, "--batch-size", "4", "--grad-accum", "1", "--max-iters", "2",
        "--eval-interval", "1", "--eval-iters", "1", "--log-interval", "1", "--seed", "5"])
    result = loop.train(args)
    return {"loss": np.asarray([h["loss"] for h in result["history"]]),
            "val": np.asarray([[e["val_loss"], e["val_acc"]] for e in result["evals"]])}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["train", "rollout", "loop"], required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--rank", type=int, default=-1)
    ap.add_argument("--world", type=int, default=1)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--data", default=None)
    args = ap.parse_args(argv)
    torch.manual_seed(0)
    distributed = args.rank >= 0
    rank, world = (args.rank, args.world) if distributed else (0, 1)
    if distributed:
        os.environ.update(MAPF_GPT_TPU_COORDINATOR=f"localhost:{args.port}",
                          MAPF_GPT_TPU_NUM_PROCESSES=str(world),
                          MAPF_GPT_TPU_PROCESS_ID=str(rank))
    if args.mode == "loop":
        out = _loop(rank, args.data, os.path.dirname(os.path.abspath(args.out)))
    else:
        if distributed:
            from mapf_gpt_tpu_torch.parallel import mesh

            mesh.init_process_group("cpu")
        try:
            out = _train(rank, world) if args.mode == "train" else _rollout(rank, world)
        finally:
            if distributed:
                torch.distributed.destroy_process_group()
    if rank == 0 or args.mode == "loop":
        path = args.out if args.mode != "loop" else f"{args.out[:-4]}.rank{rank}.npz"
        np.savez(path, **out)
    print(f"worker rank={rank} done", flush=True)


if __name__ == "__main__":
    main()
