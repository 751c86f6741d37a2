"""Data parallelism over processes on ``torch.distributed``.

Port of ``mapf_gpt_tpu/parallel/mesh.py``.  The JAX package puts every chip
in one mesh with a ``data`` axis: the batch sharded over it, parameters
replicated, XLA inserting the gradient psum and the eval means' reduction.
Here each process drives one device (a card on CUDA over NCCL, the CPU
over gloo) and the same reductions are explicit:

- :func:`init_process_group` joins the group from the coordinates the JAX
  loop reads (``MAPF_GPT_TPU_COORDINATOR``, ``MAPF_GPT_TPU_NUM_PROCESSES``,
  ``MAPF_GPT_TPU_PROCESS_ID``) or from torchrun's (``MASTER_ADDR``,
  ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``);
- :func:`broadcast_parameters` makes every process start from rank 0's
  parameters;
- :func:`all_reduce_mean` averages a list of tensors across processes in
  one collective: the accumulated gradients and the loss, once per training
  step; the eval means;
- :func:`local_slice` is a process's contiguous share of a global batch,
  and :func:`sharded_rollout` steps a process's slice of envs and gathers
  every env's metrics, in rank order, on every process.

Training reads per-process files (``train/data.ArrowShardStream``'s
``process_index`` / ``process_count``), so each process's micro-batch is
its own ``batch_size`` contexts, as in the JAX loop, where the global batch
is ``batch_size`` x processes.
"""

from __future__ import annotations

import os
from typing import Callable

import torch
import torch.distributed as dist

from mapf_gpt_tpu_torch.envs.metrics import EpisodeMetrics


def init_process_group(device: str | torch.device) -> tuple[int, int, torch.device]:
    """Join the process group (NCCL for a CUDA `device`, gloo otherwise) and
    return (rank, world size, this process's device: for CUDA without an
    index, the card of its local rank, made the current device before the
    group starts).  Raises RuntimeError when the environment names no
    coordinates."""
    env = os.environ
    if env.get("MAPF_GPT_TPU_COORDINATOR"):
        init = f"tcp://{env['MAPF_GPT_TPU_COORDINATOR']}"
        world = int(env["MAPF_GPT_TPU_NUM_PROCESSES"])
        rank = int(env["MAPF_GPT_TPU_PROCESS_ID"])
    elif all(k in env for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")):
        init, world, rank = "env://", int(env["WORLD_SIZE"]), int(env["RANK"])
    else:
        raise RuntimeError(
            "--distributed needs the process group's coordinates: MAPF_GPT_TPU_COORDINATOR "
            "(host:port), MAPF_GPT_TPU_NUM_PROCESSES and MAPF_GPT_TPU_PROCESS_ID, or "
            "torchrun's MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK")
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        # torchrun's LOCAL_RANK, else the rank modulo the cards
        device = torch.device("cuda", int(os.environ.get(
            "LOCAL_RANK", rank % max(torch.cuda.device_count(), 1))))
    if device.type == "cuda":
        torch.cuda.set_device(device)   # NCCL's communicators and barriers use it
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo", init_method=init,
                            world_size=world, rank=rank)
    return rank, world, device


@torch.no_grad()
def broadcast_parameters(params: list[torch.Tensor], src: int = 0) -> None:
    """Overwrite every process's `params` with rank `src`'s."""
    for p in params:
        dist.broadcast(p.data, src)


@torch.no_grad()
def all_reduce_mean(tensors: list[torch.Tensor]) -> None:
    """Replace each tensor by its mean across the processes, in place, with
    one all-reduce over a flat buffer (of the first tensor's dtype)."""
    flat = torch.cat([t.reshape(-1).to(tensors[0].dtype) for t in tensors])
    dist.all_reduce(flat)
    flat /= dist.get_world_size()
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view(t.shape))
        offset += t.numel()


def local_slice(n: int, rank: int, world: int) -> slice:
    """Rank's contiguous share of n items (n a multiple of world)."""
    if n % world:
        raise ValueError(f"{n} items do not split evenly over {world} processes")
    per = n // world
    return slice(rank * per, (rank + 1) * per)


def sharded_rollout(run: Callable) -> Callable:
    """Wrap a batch rollout (``parallel/rollout.make_batch_rollout``): each
    process runs its own slice of envs (equal counts), and the metrics come
    back gathered for all envs in rank order.  Returns run(states,
    generator=None) -> (this process's final states, the global
    EpisodeMetrics)."""

    def gather(x: torch.Tensor) -> torch.Tensor:
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, x.contiguous())
        return torch.cat(parts)

    def go(states, generator: torch.Generator | None = None):
        final, metrics = run(states, generator)
        return final, EpisodeMetrics(*(gather(x) for x in metrics))

    return go
