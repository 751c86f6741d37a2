#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``mapf_gpt_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed S]

Drives the port's main path, the batched rollout, for each published model
(2M, 6M, 85M) and for a ``bias=True`` model on the module route through
the attention kernel, the 6M trainer, the suite evaluator (one-shot and
lifelong episodes), and the expert-data path (the LaCAM* solver, shards
generated on the card, the 85M trainer on them, ``--distributed``) through
the entry points a user calls, and the Moonlight-16B-A3B policy's rollout
at its published size, and holds every CUDA kernel of those paths against
its plain PyTorch version.  Phases, one line each (flushed); phase 12 runs right
after phase 2, so that a faulty attention kernel fails within seconds, and
phases 23 and 24 right after phase 16:

1. device: the card's name and power limit (nvidia-smi) and torch's CUDA.
2. build: every kernel source under ``mapf_gpt_tpu_torch/csrc``, and the
   widths of phases 7 and 8, one nvcc each, and the LaCAM* solver library
   (``dataset/_lacam_build.py``, g++), all started together; build
   seconds and ptxas' register report; a ``[tile regs]`` line for each
   build of the attention tile (``csrc/attn_wgmma.cuh``: attention.cu's,
   the training forward's, the 85M stack's) with its registers, spill
   bytes and shared-memory bytes, failing on a spill at head dims 32 and 64
   (the stack's build at 64 may spill its earlier 80 bytes); and ptxas's
   "Potential Performance Loss" notes (a serialised wgmma).  Then (phase 2b) the layer
   kernels' shared GEMM (``csrc/gemm_tile.cuh``, through
   ``fused_gpt_train.gemm_tile``) against an fp32 product of the same bf16
   operands in all four orientations (A K- or MN-major, B MN- or K-major),
   at shapes with ragged M, N and K tails, bf16 out within 0.01 * max|ref|
   + 1e-3 and split fp32 partials within 1e-4 * max|ref| + 1e-3; and timed
   at the largest product of each layer kernel (the 85M's fc, [65536, 768]
   x [768, 3072], and the 6M backward's dh Wfc^T, [65536, 1024] x [1024,
   256]) beside one ``torch.matmul`` of the same operands, a cuBLAS
   yardstick that nothing of the port calls.
3. 2M kernel vs plain version: the trained 2M
   (``checkpoints/MAPF-GPT-2M-r4.pt``) at full width on 512 contexts,
   random tokens from ``--seed`` and the real tokens of a reset batch.
   Logits within atol 0.02 * max|ref| + 0.02 and argmax agreement over the
   5 action logits >= 95 % (the tolerances of ``tests/test_fused_gpt.py``);
   then 300 random contexts (not a multiple of the grid) cut to T = 200.
4. 2M rollout: 16 envs x 32 agents x 64 steps on ``random_grid(21, 0.3, s)``
   maps, argmax actions.  Every agent on a free cell, positions unique per
   env, metrics in range, and the e2e kernel's launch counter exactly one
   per step (the layer-stack and attention kernels' 0).  Prints CSR, ISR,
   SoC and env-steps/s.
5. 2M timing: the kernel on the rollout's 512 contexts beside a whole
   rollout step and its bound; then one forward at 8192 contexts (the
   rollout benchmark's 256 envs x 32 agents), kernel and plain version,
   beside the card's bound and the special-function floor (the
   attention's exp2s and GELU's ex2 and reciprocal, ``e2e_mufu_ms``).
6. 6M: phases 3-5 for the trained 6M (``checkpoints/MAPF-GPT-6M-r5.pt``,
   E=256) through the same e2e kernel: 512 contexts compared, T = 200, the
   same 16 x 32 x 64 rollout, timing at 512 and 8192 contexts.  Then the
   e2e kernel at the shapes it takes beyond the 2M's and 6M's
   (``E2E_SHAPES``: head dims 16, 64 and 128, 12 heads, T = 130 and 1,
   n_embd 144), random weights, 300 contexts each, phase 3's tolerances,
   its counter exactly one a forward; the last two shapes (head dims 128
   and 32, T = 130) with the layers' matrices scaled 3x, so that the layers
   and not the embedding set the logits.  The build phase prints the e2e
   kernel's ptxas registers, spill bytes and shared-memory bytes at every
   width it built (``[e2e regs]``) and fails on a spill at the 2M's or 6M's
   width.
7. 85M at full width and depth (12L/12H/768d), weights from
   ``models.gpt.init_params`` under ``--seed``, on the chunked route (plain
   embedding and head, the layer-stack kernel): 128 contexts compared with
   the plain route, random and reset-batch tokens, and 300 random contexts
   (a group of 256 and one of 44, whose thinned layer fills part of a row
   tile), same tolerances; one
   3-layer chunk of the layer-stack kernel alone against
   ``blocks_reference`` (stream within atol 0.02 * max|ref|); the
   chunked route at T = 200, and the layer-stack kernel alone at the
   shapes its lifted limits admit (``BLOCK_SHAPES``: the 85M's width at T
   = 200, head dims 8 and 24, n_embd 336 with 21 heads, 256 heads of
   head dim 8 at n_embd 2048, whose thin attention was past the shared
   memory before, and head dim 48 at T = 130, whose wgmma attention reads
   a 64-wide box), and the widths the padded layouts admit (n_embd 250 with 5
   heads, stored padded to 256 with LayerNorm over 250; n_embd 1032 with
   4 heads of 258 columns, run in three slabs of 96), both ways of
   ``last_only``, the repaired widths' stacks timed at 256 contexts; a 4 x 32 x 32
   rollout with the layer-stack counter exactly one per step and the e2e
   counter 0; timing at 2048 contexts (the JAX harness's 85M cap) and the
   stack's device time by kernel (``torch.profiler``).
8. Widths built on demand: eight widths no published model has, random
   weights from ``init_params``, 64 contexts each against
   ``fused_logits_reference`` with phase 3's tolerances: E=192/6 heads/4
   layers, 160/10 and 256/16 (head dim 16) on the e2e route and kernel
   (built with -D defines), E=384/6/8 (e2e route on the layer-stack kernel:
   n_embd past the e2e kernel's 256), E=512/8/12 (chunked route), and on
   the layer-stack kernel the widths its N-tile mask and head dims of 16 to
   128 admit: E=320/10 (n_embd not a multiple of 128), 384/4 (head dim 96),
   4 layers each, and 512/32/12 (head dim 16, chunked route); each kernel's
   counter exactly one.  Each width's whole forward timed at 2048 contexts
   beside its plain version and its bound.
9. Training kernels (``csrc/fused_train.cu``) against their plain versions
   on the reset batch's tokens: the trained 2M on 512 contexts (two groups
   of 256) and the 6M on 300 (a group of 256 and one of 44), at full width
   and depth (forward over all layers: ``out`` and ``xsave`` within
   0.02 * max|ref| + 0.02, the max taken per channel and, for ``xsave``,
   per save, so that the residual stream's outlier channels set no other
   channel's tolerance; backward in 2-layer chunks: dx and the six
   gradients each within 0.08 * max|ref| + 1e-4, the tolerances of
   ``tests/test_fused_gpt.py`` and ``tests/test_fused_gpt_train.py``), and
   the 85M's width (E=768, 12 heads), head dim 16 (E=256, 16 heads), head
   dim 96 (E=384, 4 heads), T=200 (the 6M's width), head dim 8 with
   n_embd 200 at T = 300 (heads padded to 16 columns, T past 256), and
   head dim 128 at T = 300 (the attention backward's key and query windows
   reloaded in turn), and the repaired widths (n_embd 250 with 5 heads;
   n_embd 1032 with 4 heads at T = 256 and 300), and n_embd 2304 with 18
   heads at T = 64 (past the LN epilogue's 2048 columns: the separate LN
   kernels) on a 2-layer forward and a 1-layer backward chunk each, the
   repaired ones timed at T = 256; a second backward launch must equal the
   first bit for bit, and the backward's epilogue kernels
   (``csrc/train_bwd_gemm.cuh``, ``fused_gpt_train.bwd_gemm_launches``),
   counted around the first, one MLP front a layer and group of 256
   contexts and two LN epilogues where ``ln_route`` takes the width (each
   compare names the route: one CTA a row, a cluster, or the kernels),
   exactly.
10. The trainer through its entry point: ``train.loop.train`` with
   ``--model 6M --device cuda``, batch 256, grad-accum 2, 20 iterations,
   eval every 10, on shards written here with ``write_arrow_shard``: the
   tokens the tokenizer makes on the reset instances stepped with the
   trained 6M's argmax actions, and those actions as targets.  The
   training kernels' counters, set to 0 just before, must read one forward
   per micro-batch and four backward chunks per micro-batch, the wgmma
   attention's and the backward epilogue kernels' counters theirs; every loss
   finite; the last logged loss below the first by ``LOSS_DROP``; the
   newest checkpoint loads with ``load_reference_checkpoint`` and drives
   one rollout step through the e2e kernel.
11. Training timing: one forward + backward of the 6M at the reference
   micro-batch of 2048 contexts, the kernels alone and the whole
   ``fused_loss_fn`` + backward, beside the plain versions and the bound;
   the backward's device time by kernel (``torch.profiler``), its epilogue
   kernels' launches counted around one call; the backward workspace's
   bytes; the trainer's it/s and MFU.
12. The attention kernel (``csrc/attention.cu``, for ``attn_impl="pallas"``)
   against its plain version ``attention_einsum``, fp32, bf16 and fp16, at
   [B, H, T, D] = [64, 5, 256, 32] (2M-like), [32, 8, 256, 32] (6M-like),
   [16, 12, 256, 64] (85M-like), [1, 3, 256, 32] (3 pairs), [4, 10, 256,
   16] (D=16), [4, 4, 256, 128] (D=128), [4, 5, 200, 32] (a masked T),
   [4, 5, 300, 32] and [2, 4, 1024, 32] (T past 256; K and V in two
   windows at 1024), [1, 4, 1024, 128] (four windows), head dims 8, 24 and
   72 (zero columns in bf16), PR 13's [4, 6, 256, 48], [6, 5, 130, 16]
   (three query tiles), [16, 4, 64, 64] and [32, 3, 1, 32], head dims 144
   and 256 (bf16 slabs, fp16 and fp32 on FMA), and, so that the wgmma
   kernel's ring of stages wraps (more pairs than 132 CTAs x its stages)
   at every head width it takes, [512, 8, 256, 32] (the bias=True 6M
   rollout's shape), [48, 12, 256, 64], [64, 6, 130, 48] and [128, 8, 130,
   16]; the 6M-like, 85M-like, a D=24, a D=48 and the [512, 8, 256, 32]
   shape also as the module's strided views of a q|k|v product: fp32
   within rtol = atol = 1e-4 (``tests/test_attention.py``), bf16 and fp16
   within 0.01 * max|ref| + 1e-3.  Each compare names its route (the C
   launcher's ``attention_route``: the wgmma kernel of
   ``csrc/attn_wgmma.cuh``, the mma.sync tiles, the bf16 slabs or FMA),
   and all four must occur.
13. The module route at full width: the trained 6M with
   ``attn_impl="pallas"`` through ``make_forward(model, use_fused=False)``
   on phase 6's 512 contexts against the same model with "einsum", phase
   3's tolerances; the attention counter exactly 8 a forward.
14. The slice through its entry point: a ``bias=True``,
   ``attn_impl="pallas"`` model at the 6M's width and depth (8L/8H/256d,
   ``init_params`` weights under ``--seed``, the biases drawn nonzero from
   the same generator): its logits against "einsum" on 512 reset contexts,
   then ``make_batch_rollout`` over 16 envs x 32 agents x 64 steps, argmax,
   phase 4's invariants, the attention counter exactly 8 x 64 and both
   fused counters 0; CSR, ISR, SoC and env-steps/s; the module's forward
   on the rollout's 512 contexts timed beside a rollout step.
15. Attention timing by CUDA events at [8192, 5, 256, 32] (the 2M rollout
   at 256 envs x 32 agents) and [2048, 12, 256, 64] (the 85M at the
   harness cap), bf16: the kernel, its plain version (in chunks, each
   chunk held against the kernel's output there, phase 12's tolerance),
   one ``scaled_dot_product_attention`` call (a yardstick, never on the
   port's path), the bound and, in the log, the exp2s' floor (16 a clock
   an SM at the card's highest clock); the kernel, held against the plain
   version the same way, and the library call again in fp16.  Then the layer stack's attention alone
   (``fused_blocks.blocks_attention``) at [2048, 12, 256, 64], held against
   its plain version and timed beside the same bound, floor and SDPA; and
   the host time of one call of the wrapper at [1, 1, 64, 32] (bf16 encodes
   three tensor maps, fp32 none).
16. The suite evaluator (``eval/harness.Evaluator``) with the trained 2M,
   argmax, on maps registered from ``random_grid``, ``maze_grid`` and
   ``warehouse_grid``: 16 one-shot specs of 64 steps (CSR, ISR, SoC,
   makespan and ep_length held to their invariants; the e2e kernel once a
   step and chunk); 4 lifelong warehouse specs (64 agents, K = 16, 64
   steps) with lazy and with dense cost2go, whose rows must be equal but
   for ``runtime``, with ``avg_throughput`` above 0; a lazy lifelong
   step split into tokenizer, forward, act and env step (CUDA events),
   ``relax_fixpoint`` timed alone beside its row-loop plain version
   (``relax_fixpoint_rows``, the JAX ``lax.scan``'s form; equal); the bench
   workload's step (256 envs x 32 agents) split the same way; and one
   ``make_recorded_rollout`` with ``mask_greed_action`` on.  About 5 s.
17. The solver: its build seconds (phase 2), then a 21-cell maze with 32
   agents solved (first solution, anytime off) and its paths checked:
   from the starts to the goals, moves to neighbours on free cells, no
   shared cell, no swap.  About 1 s.
18. Generation on the card: ``dataset.generate.generate_shards`` in the
   reference's training distribution (agents 16, 24 or 32, maps 17, 19 or
   21, 90 % mazes, one anytime solve of 1 s an instance) into 4,096 train
   and 1,024 validation samples; episodes, samples/s and the solver's and
   the replay's shares of the wall time.  Every target in 0..4 (no wait
   marker left), every token in the vocabulary, every episode's wait
   share at most ``max_wait_frac`` after ``balance_waits``, and the
   shards' share within 3 binomial standard deviations of it (a shard is
   a random subset of the balanced samples); one episode's replay on the
   card equal to the CPU's, tokens and targets.  Host-bound: about 20 s.
19. The 85M trainer on those shards: ``train.loop.train --model 85M
   --batch-size 512 --grad-accum 2``, 6 iterations, eval every 3; the
   training kernels' counters, set to 0 just before, one forward and 12
   backward chunks a micro-batch; every loss finite, the last
   ``LOSS_DROP_85M`` below the first; peak memory beside
   ``MEM_85M_ESTIMATE``; the newest checkpoint loads with
   ``load_reference_checkpoint`` and drives one rollout step through the
   layer-stack kernel.  Then iterations at the reference shape (512 x
   16): a first, untimed, with the counters set to 0 before it and read
   after it (16 forward and 192 backward launches; 384 MLP fronts and 768
   LN epilogues), and two timed, their
   median giving it/s and MFU.  Last the kernels alone at the 512
   contexts a micro-batch the trainer gives them, 12 layers: the forward's
   out and saves against its plain version (``TRAIN_PLAIN_CHUNK``
   contexts a call, within 0.02 * max|ref| + 0.02 per channel), each of
   the 12 backward chunks against its plain version (within 0.08 *
   max|ref| + 1e-4, the second launch equal to the first), then timed
   beside the plain versions and their bounds.
20. ``--distributed`` at world size 1 over NCCL: two 6M iterations whose
   losses equal a run without it from the same seed.
21. The training attention alone (run right after phase 2b), on the
   route ``csrc/fused_train.cu``'s ``attention_route`` picks (named for
   each compare, and held equal to ``fused_gpt_train.attention_route``):
   the wgmma forward with row statistics (``csrc/attn_wgmma.cuh`` through
   TrainIo) and the backward's query and key sides
   (``csrc/attn_wgmma_bwd.cuh``: ``attn_bwd_q_wgmma``,
   ``attn_bwd_kv_wgmma``) against their plain versions
   (``train_attention_reference``, ``train_attention_backward_reference``)
   at ``TRAIN_ATT_SHAPES`` [contexts, heads, T, head dim]: the 2M's, 6M's
   and 85M's heads at T = 1, 64, 130, 200 and 256, head dims 16 and 48,
   and shapes with more pairs than the grid's rings hold, so that every
   slot is refilled; att within 0.02 * max|ref| + 0.02, m and l within
   1e-3 * max|ref| + 1e-3, dq, dk and dv each within 0.08 * max|ref| +
   1e-4; a second backward call equal to the first bit for bit.  Then
   timed at ``TRAIN_ATT_TIME`` ([2048, 8, 256, 32], the 6M's micro-batch;
   [512, 12, 256, 64], the 85M's), its outputs there held against the
   plain versions chunk by chunk: each kernel beside its bound, the
   exp2s' floor and the plain version, and the library's flash attention
   on the same inputs (``scaled_dot_product_attention``'s forward, its
   forward plus backward, and the backward alone,
   ``aten._scaled_dot_product_flash_attention_backward`` from the
   forward's logsumexp: yardsticks, never on the port's path).  The
   trainer phases (9, 10, 19) read the wgmma kernels' launch counters
   (``fused_gpt_train.wgmma_launches``) around their runs.
22. The backward's epilogue kernels alone (run right after phase 21;
   ``csrc/train_bwd_gemm.cuh``), at the shapes a backward call gives them
   (``BWD_GEMM_SHAPES``: a group of 256 contexts at T = 256, the 6M's E =
   256 and the 85M's 768): ``mlp_front_kernel``'s hact equal bit for bit to
   ``gemm_tile``'s product of the same operands through the forward's GELU
   epilogue (the two-GEMM route's K order), hact and dh each within one
   bf16 step of its plain version elementwise (``check_bf16_step``);
   ``ln_dx_kernel`` at both sites (dh Wfc^T and dqkv Wqkv^T; one CTA a row
   at 256, a cluster of three at 768) against its plain version: the
   update dx_out - dx_in within 1e-3 * max|ref| + 1e-5 (the dx carried in
   left out of the scale, so that the mean terms count), dxb equal to
   bf16(dx_out), dg within 1e-4 * max|ref| + 1e-6, a second call equal to
   the first bit for bit; then each timed beside its bound and its plain
   version, the MLP front beside two ``gemm_tile`` products of the same
   operands (bf16 out: the old route's products without their fp32
   stores), the LN epilogue beside ``gemm_tile``'s product alone and as a
   multiple of it.  Under a second.
23. The Moonlight policy's ops (``ops/moe.py`` on ``csrc/moe.cu`` and
   ``csrc/grouped_gemm.cuh``) and its attention at head width 192
   (``attention.cu``'s slab route, v zero-padded) against their plain
   versions on the card (``moe.<op>_plain``, ``attention_einsum``; TF32 off)
   at the Moonlight cell's shapes: 512 contexts x 256 positions, hidden
   2048, 64 experts of 1408, top 6.  A 2-layer policy from ``init_params``
   under ``--seed`` (the dense layer and one MoE layer, its correction bias
   drawn nonzero); each op fed what the kernels before it gave, in the
   forward's order: the dense layer whole, the MoE layer's MLP, then its
   attention as the thinned last layer runs it.  Every element within one
   bf16 step (2^-7 |ref|) of the plain version plus 1e-3 of the output's
   rms, and plus one step of each rounding inside the op where it rounds
   twice (the residual add: one step of the product; SwiGLU: one of the
   gate, carried through silu, and one of the up); the two attentions
   within one step plus 0.02 of the rms (their probabilities rounded to
   bf16), the router's three product terms within 1e-4 of their rms,
   ``compact`` equal.  The router (``check_route``): each row's chosen set
   equal to the plain one's but at near-ties within twice the logits'
   largest gap, the choices in descending order of score, none twice, the
   weights within 1e-5; the device counter, the segment table, the slots
   and the experts' input rows exactly what the kernel's own choices give.
   The grouped products compared on the segments' rows.
24. The Moonlight-16B-A3B policy whole (27 layers, weights drawn on the card
   under ``--seed``, 30.6 GB in bf16): one ``make_batch_rollout`` step over
   16 envs x 32 agents (``random_grid(21, 0.3)``, argmax), the kernels'
   launch counters (``moe.kernel_launches()``, ``attention.launches``) set
   to 0 just before and read just after, each exactly its count a forward
   (``moonlight_launches``) and the GPT kernels' 0; the experts' device
   counter, every MoE layer's sum its rows x 6; phase 4's invariants.  Then
   the forward on the step's 512 contexts timed (CUDA events), its peak
   memory, its device time by kernel (``torch.profiler``), and the host
   calls that wait for the device inside its 52 ``mapf.moe.*`` spans:
   none.

Then an ``[expert data]`` line with phases 17-20's numbers, an
``[evaluator]`` line with phase 16's, the card's name and power limit, the
kernels' JSON line (the training kernels' entries with their 85M numbers
under ``"85M"``, the training attention's three wgmma kernels and the
backward's two epilogue kernels with theirs under ``"at_85m_shape"``; the
backward's entry keys its epilogue kernels' device time in the 6M split by
``profiling.kernel_key``; the ``moe`` entry phases 23 and 24's numbers) and,
last, ``{"ok": true, "device": {...}}``.
Any failed check raises, and the script exits non-zero with no result line;
so it does without a GPU, and outside a checkout of the repository.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import json
import math
import os
import re
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from mapf_gpt_tpu_torch.dataset import _lacam_build, expert, generate  # noqa: E402
from mapf_gpt_tpu_torch.envs import env as menv  # noqa: E402
from mapf_gpt_tpu_torch.eval.harness import EpisodeSpec, Evaluator  # noqa: E402
from mapf_gpt_tpu_torch.maps import (MapRegistry, maze_grid, random_grid,  # noqa: E402
                                     sample_instance, warehouse_grid)
from mapf_gpt_tpu_torch.models.convert import (load_model,  # noqa: E402
                                               load_reference_checkpoint)
from mapf_gpt_tpu_torch.models import moonlight as ml  # noqa: E402
from mapf_gpt_tpu_torch.models.gpt import (CONFIGS, GPT, GPTConfig, act,  # noqa: E402
                                           init_params, make_forward)
from mapf_gpt_tpu_torch.ops import _build, fused_blocks, fused_gpt, moe  # noqa: E402
from mapf_gpt_tpu_torch.ops import attention as tatt  # noqa: E402
from mapf_gpt_tpu_torch.ops import fused_gpt_train as fgt  # noqa: E402
from mapf_gpt_tpu_torch.ops.cost2go import (INF, relax_fixpoint,  # noqa: E402
                                            relax_fixpoint_rows)
from mapf_gpt_tpu_torch.ops.masking import MaskConfig  # noqa: E402
from mapf_gpt_tpu_torch.ops.vocab import VOCAB_SIZE  # noqa: E402
from mapf_gpt_tpu_torch.parallel.rollout import (_tokens_of,  # noqa: E402
                                                 batch_reset, make_batch_rollout,
                                                 make_recorded_rollout)
from mapf_gpt_tpu_torch.train import loop as train_loop  # noqa: E402
from mapf_gpt_tpu_torch.train.data import read_arrow_shard, write_arrow_shard  # noqa: E402
from mapf_gpt_tpu_torch.train.train_step import TrainConfig, make_train_step  # noqa: E402
from mapf_gpt_tpu_torch.utils import checkpoint as ckpt  # noqa: E402
from mapf_gpt_tpu_torch.utils import profiling  # noqa: E402

CKPT = os.path.join(ROOT, "checkpoints", "MAPF-GPT-2M-r4.pt")
CKPT_6M = os.path.join(ROOT, "checkpoints", "MAPF-GPT-6M-r5.pt")
B, A, STEPS, MAP_SIZE, DENSITY = 16, 32, 64, 21, 0.3
B_85M, STEPS_85M = 4, 32         # 128 contexts a step
N_TIME = 8192                    # 256 envs x 32 agents
N_TIME_85M = 2048                # the JAX harness's 85M context cap
PLAIN_CHUNK = {"2M": 1024, "6M": 1024, "85M": 256}   # contexts per plain-version call
WIDTHS = ((192, 6, 4), (384, 6, 8), (512, 8, 12),   # (n_embd, heads, layers) built on demand
          (320, 10, 4), (160, 10, 4), (256, 16, 4), (384, 4, 4), (512, 32, 12))
# shapes the e2e kernel takes beyond the 2M's and 6M's, (n_embd, heads, layers, T,
# scale of the layers' matrices): head dims 16, 64 and 128, 12 heads, T = 200, 130
# and 1 (T = 200 at the 6M's width is phase 6's, on the trained 6M), n_embd 144
# (not a multiple of 32: a K slab of 16 rows, a q|k|v tile of 48 columns); the last
# at head dim 128 and T = 130 (keys 130 .. 191 of the last chunk masked), and at
# head dim 32 and T = 130 (keys 130 .. 255 of the tile masked), with the layers'
# matrices 3x init_params', so that the layers set the logits and a wrong
# attention (a denominator counting the masked keys) moves them by several
# tolerances, which at std 0.02 it may not
E2E_SHAPES = ((160, 10, 4, 200, 1.0), (256, 4, 4, 256, 1.0), (192, 12, 3, 256, 1.0),
              (128, 1, 2, 100, 1.0), (192, 3, 3, 130, 1.0), (160, 5, 3, 1, 1.0),
              (144, 9, 3, 200, 1.0), (256, 2, 2, 130, 3.0),
              # the 2M's width (head dim 32: the wgmma attention) at T = 130, 3x
              (160, 5, 3, 130, 3.0))
N_E2E_SHAPES = 300               # not a multiple of the grid's 132 CTAs
N_WIDTHS = 64                    # contexts of each width's compare
N_WIDTHS_TIME = 2048             # contexts of each width's timing
# contexts of the training kernels' compares: the kernels run groups of
# fgt.GROUP = 256, so the 2M's two full groups and the 6M's 256 + 44 check the
# group offsets, the gradients summed across groups and a partial group
N_TRAIN_CMP = {"2M": 512, "6M": 300, "85M": 64}
TRAIN_WIDTHS = {"85M width": (768, 12, 256), "head dim 16": (256, 16, 256),   # (E, heads, T)
                "head dim 96": (384, 4, 256), "T 200": (256, 8, 200),
                "head dim 8, n_embd 200, T 300": (200, 25, 300),
                "head dim 128, T 300": (256, 2, 300),
                # repaired: n_embd not a multiple of 8 (stored padded to 256), and a head
                # dim past 128 (258: three slabs of 96 columns), at T = 256 and 300
                "n_embd 250, 5 heads": (250, 5, 256), "n_embd 1032, 4 heads": (1032, 4, 256),
                "n_embd 1032, 4 heads, T 300": (1032, 4, 300),
                # past the LN epilogue's 2048 columns: the separate LN kernels
                "n_embd 2304, 18 heads, T 64": (2304, 18, 64)}
# the layer-stack kernel past its old limits, (n_embd, heads, layers, T): the 85M's
# width at T = 200, head dims 8 and 24 (padded to 16 and 32 columns), n_embd 336 with
# 21 heads, and 256 heads of head dim 8, whose thin attention's H x T scores were
# past a block's shared memory
BLOCK_SHAPES = ((768, 12, 2, 200), (96, 12, 2, 200), (96, 4, 2, 200), (336, 21, 2, 200),
                (2048, 256, 1, 256),
                # PR 13: head dim 48 on the wgmma attention (a 64-wide box over the
                # next head's columns, 48 of them used) at T = 130 (three query tiles)
                (288, 6, 2, 130),
                # repaired: n_embd 250 (stored padded to 256, LayerNorm over 250) and head
                # dim 258 (three slabs of 96 columns)
                (250, 5, 2, 256), (1032, 4, 2, 256), (1032, 4, 1, 200))
N_BLOCK_SHAPES = 40              # contexts of each shape's compare (4 at n_embd 2048)
N_REPAIRED_TIME = 256            # contexts of the repaired widths' timings (one group)
# the shared GEMM's compares, (M, N, K): ragged tails on every side, N of one and
# of several output tiles, K of one k-tile and of many
GEMM_SHAPES = ((200, 136, 72), (256, 256, 128), (1000, 600, 304), (64, 8, 16),
               (136, 264, 520), (520, 776, 1032))
GEMM_TIME = {"85M fc": (65536, 3072, 768, False, False),   # (M, N, K, A MN-major, B K-major)
             "6M backward dh Wfc^T": (65536, 256, 1024, False, True)}
N_TRAIN_TIME = 2048              # the 6M's reference micro-batch
TRAIN_PLAIN_CHUNK = 256          # contexts per plain training-version call
TRAIN_ITERS, TRAIN_BATCH, TRAIN_ACCUM = 20, 256, 2
LOSS_DROP = 0.5                  # the trainer's last logged loss must be this far below its first
ATT_SHAPES = ((64, 5, 256, 32), (32, 8, 256, 32), (16, 12, 256, 64), (1, 3, 256, 32),
              (4, 10, 256, 16), (4, 4, 256, 128), (4, 5, 200, 32),   # [B, H, T, D] compared
              (4, 5, 300, 32), (2, 4, 1024, 32), (1, 4, 1024, 128), (8, 5, 256, 8),
              (8, 5, 256, 24), (4, 4, 256, 72),
              # PR 13: the wgmma route's D = 48 (a 64-wide box), T = 130 (three query
              # tiles: the two warpgroups' turns alternate across pairs), 64 and 1; the
              # heads past 128 (bf16 slabs of 80 and 128 columns, fp16 and fp32 FMA)
              (4, 6, 256, 48), (6, 5, 130, 16), (16, 4, 64, 64), (32, 3, 1, 32),
              (2, 3, 256, 144), (1, 2, 200, 256),
              # more pairs than 132 CTAs x the ring's stages (4 at D <= 32, 2 above),
              # so that each stage is refilled under a direct compare
              (512, 8, 256, 32), (48, 12, 256, 64), (64, 6, 130, 48), (128, 8, 130, 16))
ATT_STRIDED = ((32, 8, 256, 32), (8, 5, 256, 24),   # also as views of a q|k|v product
               (16, 12, 256, 64), (8, 6, 200, 48), (512, 8, 256, 32))
ATT_TIME = {"2M": (8192, 5, 256, 32), "85M": (2048, 12, 256, 64)}   # [B, H, T, D] timed
# the training attention alone, [contexts, heads, T, head dim]: the 2M's, 6M's and
# 85M's heads at T = 256, 200, 130, 64 and 1, head dims 16 and 48; then more pairs
# than 132 CTAs x the pairs a ring holds (3 at D = 32, 4 at 16, 1.5 at 48 and 64)
TRAIN_ATT_SHAPES = ((16, 5, 256, 32), (16, 8, 256, 32), (8, 12, 256, 64), (8, 8, 200, 32),
                    (8, 8, 130, 32), (8, 8, 64, 32), (8, 8, 1, 32), (4, 12, 200, 64),
                    (4, 12, 130, 64), (4, 12, 64, 64), (4, 12, 1, 64), (8, 16, 256, 16),
                    (4, 6, 130, 48), (64, 8, 256, 32), (32, 12, 256, 64), (48, 6, 200, 48),
                    (64, 16, 130, 16))
TRAIN_ATT_TIME = {"6M": (2048, 8, 256, 32), "85M": (512, 12, 256, 64)}
TRAIN_ATT_PLAIN = 256            # contexts per plain-version call at the timing shapes
# the backward's epilogue kernels alone at a group of 256 contexts x T = 256 rows,
# (n_embd, 4 n_embd): the 6M's and the 85M's
BWD_GEMM_SHAPES = {"6M": (65536, 256, 1024), "85M": (65536, 768, 3072)}
ATT_PLAIN_PAIRS = 2560           # (batch, head) pairs per plain-version call
# the evaluator phase: one-shot specs (map, agents, seeds) of EVAL_STEPS steps, and
# lifelong specs on the warehouse map, K = EVAL_K queued goals
EVAL_ONE_SHOT = (("random-21", 16, 4), ("maze-21", 16, 4), ("random-21", 32, 4),
                 ("maze-21", 32, 4))
EVAL_STEPS, EVAL_BATCH = 64, 8
EVAL_LIFELONG = ("warehouse", 64, 4)
EVAL_K, EVAL_LIFELONG_STEPS = 16, 64
SPLIT_STEPS = 8                  # steps of the bench shape's split (256 envs x 32 agents)
# the expert-data phases: train and validation samples in the reference's training
# distribution (the JAX GenConfig's comment), one anytime solve of 1 s an instance
GEN_SAMPLES = (4096, 1024)
GEN_CFG = dict(agent_counts=(16, 24, 32), map_sizes=(17, 19, 21), maze_fraction=0.9,
               max_wait_frac=0.2, expert_time_limits=(1.0,))
TRAIN_85M = (6, 512, 2)          # the 85M trainer's iterations, micro-batch, accumulation
REF_ACCUM_85M = 16               # configs/config-85M.py's grad_accum, for the timed iteration
LOSS_DROP_85M = 0.5
# an estimate made before measuring: the saves, the backward workspace for a group of
# 256 contexts (fused_train_workspace), and parameters, gradients and AdamW state of
# about 1.4 GB
MEM_85M_ESTIMATE = 24 * 512 * 256 * 768 * 2 + 3_051_094_016 + 1_400_000_000
DIST_ITERS = 2                   # the 6M iterations of the world-size-1 --distributed check
MOON_ENVS = 16                   # the Moonlight cell's envs: x A agents, 512 contexts a step
# host calls that wait for the device, none of which may run inside a mapf.moe.* span
MOON_SYNCS = {"cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy", "aten::item", "aten::_local_scalar_dense"}
PEAK_BF16 = 989e12               # H100 SXM dense bf16 FLOP/s
PEAK_FP32 = 67e12                # H100 SXM fp32 FLOP/s outside the tensor cores
MUFU_PER_CLOCK = 16              # exp2s an SM's special-function units issue a clock (sm_90)
HBM_BYTES_PER_S = 3.35e12


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over `reps` runs, after one warm-up run."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def layer_ops(t: int, e: int, h: int, layers: int, last_only: bool) -> tuple[int, int]:
    """(bf16 product FLOP, fp32 exp2 count) of a layer stack on one context,
    the final layer thinned to one query row when last_only."""
    f = 4 * e
    full = 2 * t * e * 3 * e + 2 * 2 * t * t * e + 2 * t * e * e + 2 * 2 * t * e * f
    last = 2 * t * e * 2 * e + 2 * e * e + 2 * 2 * t * e + 2 * e * e + 2 * 2 * e * f
    if not last_only:
        return layers * full, layers * h * t * t
    return (layers - 1) * full + last, (layers - 1) * h * t * t + h * t


def bound(bf16_ops: float, fp32_ops: float, nbytes: float) -> tuple[float, str]:
    """Least time (ms) for this work on the card, and what bounds it."""
    t_ops = bf16_ops / PEAK_BF16 + fp32_ops / PEAK_FP32
    t_bytes = nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def mufu_floor_ms(exps: float) -> float:
    """Least time (ms) of `exps` exp2s on the special-function units: 16 a
    clock an SM at the card's highest SM clock (nvidia-smi).  bound() counts
    them at the fp32 rate, 16x too cheaply for the attention's; it stays as
    it is, so that earlier rows stay comparable, and this floor sits beside
    it."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return 1e3 * exps / (sms * MUFU_PER_CLOCK * mhz * 1e6)


def nbytes(*tensors) -> int:
    return sum(x.numel() * x.element_size() for x in tensors)


def e2e_bound(n: int, w: fused_gpt.FusedWeights, t: int) -> tuple[float, str]:
    """Least time (ms) of the e2e forward on n contexts, and what bounds it.

    Operations: the bf16 products the forward needs (the last layer thinned
    to one query row) at the bf16 tensor rate, plus the fp32 head and one
    exp2 per attention score at the fp32 rate.  Bytes: tokens and the
    weights the kernel reads once, logits written once."""
    layers, e, _ = w.wqkv.shape
    vocab = w.wte.shape[0]
    prod, exps = layer_ops(t, e, w.n_head, layers, last_only=True)
    io_bytes = n * t * 4 + n * vocab * 4
    weights = nbytes(w.wte, w.wpe, w.wht, *w.stacks()[:6], w.gf)
    return bound(n * prod, n * (exps + 2 * e * vocab), weights + io_bytes)


def e2e_mufu_ms(n: int, w: fused_gpt.FusedWeights, t: int) -> float:
    """Least time (ms) of the e2e forward's special-function work on n
    contexts (mufu_floor_ms): an exp2 a score of the full layers and of the
    thinned row, and an ex2 and a reciprocal a GELU (4E a row, one row in
    the thinned layer)."""
    layers, e, _ = w.wqkv.shape
    exps = (layers - 1) * w.n_head * t * t + w.n_head * t
    gelus = (layers - 1) * t * 4 * e + 4 * e
    return mufu_floor_ms(n * (exps + 2 * gelus))


def e2e_ptxas(log_text: str) -> list[tuple[int, int, int, int, int]]:
    """(n_embd, heads, registers, spill store bytes, spill load bytes) of each
    e2e kernel in a build's ptxas output."""
    out, width = [], None
    for line in log_text.splitlines():
        m = re.search(r"FwdILi(\d+)ELi(\d+)E", line)
        if m and "Compiling entry function" in line:
            width = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and width:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and width:
            out.append((*width, int(m.group(1)), *spills))
            width = None
    return out


def tile_ptxas(log_text: str) -> list[tuple[str, str, int, int, int]]:
    """(kernel name, its (D, type, Io) as in the mangled name, registers,
    spill store bytes, spill load bytes) of each attn_wgmma.cuh kernel in a
    build's ptxas output."""
    out, name = [], None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S*attn_wgmma_kernelILi(\d+)E(\w+?)Lb([01])E"
                      r"NS_(\d+)(\w+?)EEEv\S*)'", line)
        if m:
            name = (m.group(2), "bf16" if "bfloat16" in m.group(3) else "fp16", m.group(6))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((*name, int(m.group(1)), *spills))
            name = None
    return out


def blocks_bound(n: int, stacks: fused_blocks.LayerStacks, t: int,
                 last_only: bool) -> tuple[float, str]:
    """Least time (ms) of the layer stack on n contexts: its bf16 products
    and exp2s, against x read once, the output written once and the
    weights read once."""
    layers, e, _ = stacks.wqkv.shape
    prod, exps = layer_ops(t, e, stacks.n_head, layers, last_only)
    io_bytes = n * t * e * 2 + n * (1 if last_only else t) * e * 2
    return bound(n * prod, n * exps, nbytes(*stacks[:6]) + io_bytes)


def check_close(name: str, got: torch.Tensor, ref: torch.Tensor, floor: float,
                argmax: bool, rel: float = 0.02) -> float:
    """got vs ref within atol rel * max|ref| + floor (and >= 95 % argmax
    agreement over the 5 action logits); returns max |got - ref|."""
    if got.shape != ref.shape or not torch.isfinite(got.float()).all():
        raise RuntimeError(f"{name}: kernel output {tuple(got.shape)} not finite or "
                           f"not of shape {tuple(ref.shape)}")
    err = (got.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    tol = rel * scale + floor
    msg = f"[compare] {name}: n={got.shape[0]} max|err|={err:.5f} tol={tol:.5f} " \
          f"(max|ref|={scale:.3f})"
    agree = 1.0
    if argmax:
        agree = (got[:, :5].argmax(-1) == ref[:, :5].argmax(-1)).float().mean().item()
        msg += f" argmax agreement={agree:.4f}"
    log(msg)
    if err > tol or agree < 0.95:
        raise RuntimeError(f"{name}: kernel disagrees with the plain version")
    return err


def check_close_channels(name: str, got: torch.Tensor, ref: torch.Tensor, lead: int,
                         rel: float = 0.02, floor: float = 0.02) -> float:
    """got vs ref within atol rel * max|ref| + floor, the max taken per
    channel (the last dim) and per index of the first `lead` dims, over the
    dims between; returns max |got - ref|."""
    if got.shape != ref.shape or not torch.isfinite(got.float()).all():
        raise RuntimeError(f"{name}: kernel output {tuple(got.shape)} not finite or "
                           f"not of shape {tuple(ref.shape)}")
    parts = int(np.prod(ref.shape[:lead]))
    diff = (got.float() - ref.float()).reshape(parts, -1, ref.shape[-1])
    err = diff.abs().amax(1)
    scale = ref.float().reshape(parts, -1, ref.shape[-1]).abs().amax(1)
    tol = rel * scale + floor
    worst = (err / tol).max().item()
    rms = (diff.square().mean() / ref.float().square().mean()).sqrt().item()
    log(f"[compare] {name}: n={got.shape[lead]} max|err|={err.max().item():.5f} "
        f"per-channel tol {tol.min().item():.5f}..{tol.max().item():.5f} "
        f"(median {tol.median().item():.5f}), worst err/tol={worst:.4f}, "
        f"relative rms err={rms:.2e}")
    if worst > 1.0:
        raise RuntimeError(f"{name}: kernel disagrees with the plain version")
    return err.max().item()


def compare(name: str, w, tokens: torch.Tensor) -> float:
    """The forward's kernel route vs its plain version on the card."""
    got = fused_gpt.fused_logits(w, tokens)
    torch.cuda.synchronize()
    ref = fused_gpt.fused_logits_reference(w, tokens)
    return check_close(name, got, ref, floor=0.02, argmax=True)


def instances(seed: int, b: int):
    insts = [sample_instance(random_grid(MAP_SIZE, DENSITY, seed + s), A, seed=seed + s)
             for s in range(b)]
    return (np.stack([i.grid for i in insts]), np.stack([i.starts for i in insts]),
            np.stack([i.goals for i in insts]))


def check_rollout(final: menv.EnvState, met, steps: int) -> None:
    pos = final.pos.long()
    bi = torch.arange(pos.shape[0], device=pos.device)[:, None]
    if final.grid[bi, pos[..., 0], pos[..., 1]].any():
        raise RuntimeError("rollout: an agent stands on an obstacle")
    lin = pos[..., 0] * final.grid.shape[-1] + pos[..., 1]
    if (lin.sort(-1).values.diff(dim=-1) == 0).any():
        raise RuntimeError("rollout: two agents share a cell")
    for name, vals, hi in (("csr", met.csr, 1.0), ("isr", met.isr, 1.0),
                           ("soc", met.soc, float(A * steps)),
                           ("makespan", met.makespan, float(steps)),
                           ("ep_length", met.ep_length, float(steps))):
        if not torch.isfinite(vals).all() or (vals < 0).any() or (vals > hi).any():
            raise RuntimeError(f"rollout: {name} outside [0, {hi}]: {vals.tolist()}")
    solved = (final.pos == final.goal).all(-1).float().mean(-1)
    if not torch.allclose(solved, met.isr, rtol=0, atol=1e-6):
        raise RuntimeError("rollout: ISR does not match the final positions")


def reset_batch(seed: int, b: int, steps: int, dev):
    grids, starts, goals = instances(seed, b)
    spec = menv.MapfEnvSpec(height=grids.shape[1], width=grids.shape[2], num_agents=A,
                            max_episode_steps=steps)
    states = batch_reset(spec, grids, starts, goals, np.ones((b, A), bool), device=dev)
    return spec, states, _tokens_of(states).reshape(b * A, -1)


def random_tokens(seed: int, n: int, cfg, dev) -> torch.Tensor:
    return torch.from_numpy(np.random.RandomState(seed).randint(
        0, cfg.vocab_size, size=(n, cfg.block_size))).to(dev, torch.int32)


def rollout(label: str, spec, model, states, b: int, steps: int, e2e: int,
            blocks: int, attn: int = 0) -> tuple[float, tuple[int, int, int]]:
    """The rollout with the inference kernels' launch counters set to 0 just
    before it; checks they read (e2e, blocks, attn) just after.  Returns its
    seconds and the counts."""
    run = make_batch_rollout(spec, model, do_sample=False)
    torch.cuda.synchronize()
    fused_gpt.launches = fused_blocks.launches = tatt.launches = 0
    t0 = time.perf_counter()
    final, met = run(states)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    got = (fused_gpt.launches, fused_blocks.launches, tatt.launches)
    log(f"[rollout] {label} B={b} A={A} steps={steps}: {dt:.3f} s, "
        f"{b * steps / dt:.1f} env-steps/s, kernel launches e2e {got[0]} blocks {got[1]} "
        f"attention {got[2]}")
    if got != (e2e, blocks, attn):
        raise RuntimeError(f"rollout {label}: kernel launches (e2e, blocks, attention) {got}, "
                           f"expected {(e2e, blocks, attn)}")
    check_rollout(final, met, steps)
    log(f"[rollout] {label} CSR {met.csr.mean().item():.4f} ISR {met.isr.mean().item():.4f} "
        f"SoC {met.soc.mean().item():.2f} makespan {met.makespan.mean().item():.2f} "
        f"ep_length {met.ep_length.mean().item():.2f}")
    return dt, got


def e2e_model(label: str, model, seed: int, dev) -> dict:
    """Compare, rollout and timing of a model on the e2e route."""
    cfg = model.cfg
    w = fused_gpt.stack_weights(model)
    spec, states, real = reset_batch(seed, B, STEPS, dev)
    rand = random_tokens(seed, B * A, cfg, dev)
    max_err = max(compare(f"{label} random tokens", w, rand),
                  compare(f"{label} reset-batch tokens", w, real))
    dt, (launches, _, _) = rollout(label, spec, model, states, B, STEPS, e2e=STEPS, blocks=0)

    # T = 200 on the trained weights, 300 contexts (a partial wave of the grid)
    short = random_tokens(seed + 1, N_E2E_SHAPES, cfg, dev)[:, :200].contiguous()
    max_err = max(max_err, compare(f"{label} random tokens, T=200", w, short))

    # timing: the rollout's own 512 contexts, then the benchmark's 8192
    ms_step = cuda_ms(lambda: fused_gpt.fused_logits(w, real), reps=10)
    bound_step, _ = e2e_bound(real.shape[0], w, cfg.block_size)
    log(f"[timing] {label} N={real.shape[0]}: kernel {ms_step:.3f} ms of a "
        f"{1e3 * dt / STEPS:.3f} ms rollout step, bound {bound_step:.3f} ms, "
        f"{100 * bound_step / ms_step:.2f} % of bound, special-function floor "
        f"{e2e_mufu_ms(real.shape[0], w, cfg.block_size):.3f} ms")
    tokens = real.repeat(N_TIME // real.shape[0], 1)
    ms = cuda_ms(lambda: fused_gpt.fused_logits(w, tokens), reps=5)
    plain_ms = cuda_ms(lambda: [fused_gpt.fused_logits_reference(w, c)
                                for c in tokens.split(PLAIN_CHUNK[label])], reps=2)
    bound_ms, bound_by = e2e_bound(N_TIME, w, cfg.block_size)
    log(f"[timing] {label} N={N_TIME}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"bound {bound_ms:.3f} ms ({bound_by}), {100 * bound_ms / ms:.2f} % of bound, "
        f"special-function floor {e2e_mufu_ms(N_TIME, w, cfg.block_size):.3f} ms")
    return {"name": "fused_gpt_e2e", "model": label, "route": "cuda",
            "source": "mapf_gpt_tpu_torch/csrc/fused_gpt.cu",
            "replaces": "mapf_gpt_tpu/ops/fused_gpt.py:182",
            "launches": launches, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "n_contexts": N_TIME, "ms_at_512": ms_step, "bound_ms_at_512": bound_step}


def e2e_shapes_phase(seed: int, dev) -> float:
    """The e2e kernel at E2E_SHAPES on N_E2E_SHAPES contexts, random
    weights from init_params, against fused_logits_reference; the e2e
    counter exactly one a forward.  Returns the largest max |err|."""
    err = 0.0
    for e, h, layers, t, scale in E2E_SHAPES:
        cfg = GPTConfig(n_layer=layers, n_head=h, n_embd=e)
        sd = init_params(cfg, torch.Generator().manual_seed(seed + e + h + t))
        for k in sd:
            if k.startswith("transformer.h.") and ".ln_" not in k:
                sd[k] = sd[k] * scale
        model = load_model(cfg, sd, device=dev)
        w = fused_gpt.stack_weights(model)
        if fused_gpt.cuda_plan(e, h, layers, t) != ("e2e", "fused_gpt"):
            raise RuntimeError(f"e2e shape E={e} H={h} T={t}: not planned on the e2e kernel")
        tokens = random_tokens(seed + e + t, N_E2E_SHAPES, cfg, dev)[:, :t].contiguous()
        fused_gpt.launches = fused_blocks.launches = 0
        err = max(err, compare(f"e2e E={e} H={h} (head dim {e // h}) L={layers} T={t} "
                               f"weights x{scale:g}", w, tokens))
        if (fused_gpt.launches, fused_blocks.launches) != (1, 0):
            raise RuntimeError(f"e2e shape E={e} H={h} T={t}: launches (e2e, blocks) "
                               f"{(fused_gpt.launches, fused_blocks.launches)}, expected (1, 0)")
    return err


def repaired(e: int, h: int) -> bool:
    """A width the layer kernels take only through their padded layouts:
    n_embd not a multiple of 8, or a head dim past 128."""
    return e % 8 != 0 or e // h > 128


def block_shapes_phase(seed: int, dev) -> float:
    """The layer-stack kernel alone at BLOCK_SHAPES, random weights from
    init_params, both ways of last_only, against blocks_reference (stream
    within atol 0.02 * max|ref|); the repaired widths' stacks then timed
    at N_REPAIRED_TIME contexts beside the plain version and the bound.
    Returns the largest max |err|."""
    err = 0.0
    for e, h, layers, t in BLOCK_SHAPES:
        cfg = GPTConfig(n_layer=layers, n_head=h, n_embd=e)
        model = load_model(cfg, init_params(cfg, torch.Generator().manual_seed(seed + e + h)),
                           device=dev)
        w = fused_gpt.stack_weights(model)
        n = 4 if e >= 2048 else N_BLOCK_SHAPES
        tokens = random_tokens(seed + e + t, n, cfg, dev)[:, :t]
        x = (w.wte32[tokens.long()] + w.wpe32[:t]).to(torch.bfloat16)
        for last_only in (False, True):
            got = fused_blocks.fused_blocks(x, w.stacks(), last_only)
            torch.cuda.synchronize()
            err = max(err, check_close(
                f"blocks E={e} H={h} (head dim {e // h}) L={layers} T={t} last_only={last_only}, "
                "stream", got, fused_blocks.blocks_reference(x, w.stacks(), last_only),
                floor=0.0, argmax=False))
        if repaired(e, h) and t == 256:
            tokens = random_tokens(seed + e, N_REPAIRED_TIME, cfg, dev)
            x = (w.wte32[tokens.long()] + w.wpe32).to(torch.bfloat16)
            ms = cuda_ms(lambda: fused_blocks.fused_blocks(x, w.stacks(), False), reps=3)
            plain_ms = cuda_ms(lambda: [fused_blocks.blocks_reference(c, w.stacks(), False)
                                        for c in x.split(64)], reps=1)
            bound_ms, bound_by = blocks_bound(N_REPAIRED_TIME, w.stacks(), t, last_only=False)
            log(f"[timing] blocks E={e} H={h} L={layers} T={t} N={N_REPAIRED_TIME}: kernel "
                f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}), "
                f"{100 * bound_ms / ms:.2f} % of bound")
    return err


def log_split(label: str, fn) -> list:
    """fn()'s device time by kernel (torch.profiler, one warm call), logged."""
    split = profiling.kernel_times(fn, reps=1)
    traced = sum(r[0] for r in split)
    log(f"[timing] {label} by kernel ({traced:.3f} ms traced):")
    for ms_k, calls, name in split[:12]:
        log(f"[timing]   {ms_k:10.3f} ms {100 * ms_k / traced:5.1f} % {calls:6.1f} launches  "
            f"{name[:100]}")
    return split


def gemm_phase(seed: int, dev) -> dict:
    """The shared GEMM against an fp32 product of the same bf16 operands in
    every orientation at GEMM_SHAPES, then timed at GEMM_TIME beside one
    torch.matmul (cuBLAS, a yardstick only).  Returns the timings."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    for m, n, k in GEMM_SHAPES:
        a = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        b = torch.randn((k, n), generator=gen, device=dev).to(torch.bfloat16)
        ref = a.float() @ b.float()
        scale = ref.abs().max().item()
        for a_mn in (False, True):
            for b_k in (False, True):
                args = (a.t().contiguous() if a_mn else a, b.t().contiguous() if b_k else b,
                        a_mn, b_k)
                for splits in (0, 3):
                    got = fgt.gemm_tile(*args, splits=splits)
                    got = got.sum(0) if splits else got.float()
                    tol = (1e-4 if splits else 0.01) * scale + 1e-3
                    err = (got - ref).abs().max().item()
                    if not err <= tol:
                        raise RuntimeError(f"gemm M={m} N={n} K={k} A {'MN' if a_mn else 'K'}-"
                                           f"major, B {'K' if b_k else 'MN'}-major, splits "
                                           f"{splits}: max|err| {err:.5f} > tol {tol:.5f}")
    log(f"[compare] gemm_tile: {len(GEMM_SHAPES)} shapes x 4 orientations x (bf16, 3 fp32 "
        "splits) within tolerance")
    rows = {}
    for label, (m, n, k, a_mn, b_k) in GEMM_TIME.items():
        a = torch.randn((k, m) if a_mn else (m, k), generator=gen, device=dev).to(torch.bfloat16)
        b = torch.randn((n, k) if b_k else (k, n), generator=gen, device=dev).to(torch.bfloat16)
        ta, tb = (a.t() if a_mn else a), (b.t() if b_k else b)
        ms = cuda_ms(lambda: fgt.gemm_tile(a, b, a_mn, b_k), reps=20)
        lib_ms = cuda_ms(lambda: torch.matmul(ta, tb), reps=20)
        tflops = 2 * m * n * k / 1e9
        log(f"[timing] gemm {label} [{m}, {k}] x [{k}, {n}]: gemm_tile {ms:.3f} ms "
            f"({tflops / ms:.1f} TFLOP/s), torch.matmul {lib_ms:.3f} ms ({tflops / lib_ms:.1f} "
            f"TFLOP/s), bound {bound(2 * m * n * k, 0, 2 * (m * k + k * n + m * n))[0]:.3f} ms")
        rows[label] = {"shape": [m, n, k], "gemm_ms": ms, "cublas_ms": lib_ms}
    return rows


def blocks_model(seed: int, dev) -> dict:
    """The 85M on the chunked route: compare, the layer-stack kernel alone,
    rollout and timing."""
    cfg = CONFIGS["85M"]
    gen = torch.Generator().manual_seed(seed)
    model = load_model(cfg, init_params(cfg, gen), device=dev)
    w = fused_gpt.stack_weights(model)
    stacks = w.stacks()
    spec, states, real = reset_batch(seed, B_85M, STEPS_85M, dev)
    rand = random_tokens(seed, B_85M * A, cfg, dev)
    odd = random_tokens(seed + 1, 300, cfg, dev)
    max_err = max(compare("85M random tokens", w, rand),
                  compare("85M reset-batch tokens", w, real),
                  compare("85M random tokens, groups of 256 + 44", w, odd))

    # the layer-stack kernel alone: one 3-layer chunk, every position out
    x = (w.wte32[real.long()] + w.wpe32).to(torch.bfloat16)
    chunk = stacks.chunk(0, 3)
    got = fused_blocks.fused_blocks(x, chunk, last_only=False)
    torch.cuda.synchronize()
    ref = fused_blocks.blocks_reference(x, chunk, last_only=False)
    check_close("85M blocks 3-layer chunk, stream", got, ref, floor=0.0, argmax=False)
    max_err = max(max_err, compare("85M random tokens, T=200", w, odd[:, :200].contiguous()),
                  block_shapes_phase(seed, dev))

    # one layer-stack launch per forward: the chunked route runs all 12 layers in one call
    dt, (_, launches, _) = rollout("85M", spec, model, states, B_85M, STEPS_85M, e2e=0,
                                   blocks=STEPS_85M)

    ms_step = cuda_ms(lambda: fused_gpt.fused_logits(w, real), reps=5)
    log(f"[timing] 85M N={real.shape[0]}: forward {ms_step:.3f} ms of a "
        f"{1e3 * dt / STEPS_85M:.3f} ms rollout step")
    tokens = real.repeat(N_TIME_85M // real.shape[0], 1)
    x = (w.wte32[tokens.long()] + w.wpe32).to(torch.bfloat16)
    ms = cuda_ms(lambda: fused_blocks.fused_blocks(x, stacks, last_only=True), reps=3)
    fwd_ms = cuda_ms(lambda: fused_gpt.fused_logits(w, tokens), reps=2)
    plain_ms = cuda_ms(lambda: [fused_blocks.blocks_reference(c, stacks, last_only=True)
                                for c in x.split(PLAIN_CHUNK["85M"])], reps=2)
    bound_ms, bound_by = blocks_bound(N_TIME_85M, stacks, cfg.block_size, last_only=True)
    log(f"[timing] 85M N={N_TIME_85M}: kernel {ms:.3f} ms (whole forward {fwd_ms:.3f} ms), "
        f"plain {plain_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}), "
        f"{100 * bound_ms / ms:.2f} % of bound")
    split = log_split(f"85M N={N_TIME_85M} layer stack",
                      lambda: fused_blocks.fused_blocks(x, stacks, last_only=True))
    return {"name": "fused_blocks", "model": "85M", "route": "cuda",
            "source": "mapf_gpt_tpu_torch/csrc/fused_blocks.cu",
            "replaces": "mapf_gpt_tpu/ops/fused_gpt.py:167",
            "launches": launches, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "n_contexts": N_TIME_85M, "at_t_200_and_block_shapes": True,
            "attention_kernels_ms": {profiling.kernel_key(name): ms_k
                                     for ms_k, _, name in split if "attn" in name}}


def widths_phase(seed: int, dev) -> None:
    """Widths no published model has, each on the kernel cuda_plan names,
    against the plain version, that kernel's counter exactly one; then the
    whole forward timed at N_WIDTHS_TIME contexts beside its plain version
    and its bound."""
    for e, h, layers in WIDTHS:
        cfg = GPTConfig(n_layer=layers, n_head=h, n_embd=e)
        model = load_model(cfg, init_params(cfg, torch.Generator().manual_seed(seed + e)),
                           device=dev)
        w = fused_gpt.stack_weights(model)
        route, kernel = fused_gpt.cuda_plan(e, h, layers)
        tokens = random_tokens(seed + e, N_WIDTHS, cfg, dev)
        fused_gpt.launches = fused_blocks.launches = 0
        check_close(f"width E={e} H={h} L={layers} ({route} route, {kernel})",
                    fused_gpt.fused_logits(w, tokens), fused_gpt.fused_logits_reference(w, tokens),
                    floor=0.02, argmax=True)
        got = (fused_gpt.launches, fused_blocks.launches)
        want = (1, 0) if kernel == "fused_gpt" else (0, 1)
        if got != want:
            raise RuntimeError(f"width {e}: launches (e2e, blocks) {got}, expected {want}")
        tokens = random_tokens(seed + e, N_WIDTHS_TIME, cfg, dev)
        ms = cuda_ms(lambda: fused_gpt.fused_logits(w, tokens), reps=2)
        plain_ms = cuda_ms(lambda: [fused_gpt.fused_logits_reference(w, c)
                                    for c in tokens.split(256)], reps=1)
        bound_ms, bound_by = e2e_bound(N_WIDTHS_TIME, w, cfg.block_size)
        log(f"[timing] width E={e} H={h} L={layers} ({kernel}) N={N_WIDTHS_TIME}: forward "
            f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}), "
            f"{100 * bound_ms / ms:.2f} % of bound")


def train_stacks(model) -> fgt.TrainStacks:
    """The model's training stacks, detached (the kernels alone)."""
    st = fgt.build_train_stacks(model)
    return fgt.TrainStacks(*(t.detach() for t in st[:6]), n_head=st.n_head)


def embed(model, tokens: torch.Tensor) -> torch.Tensor:
    """The trainer's embedding: bf16(wte[tokens] + wpe), fp32 tables."""
    tr = model.transformer
    with torch.no_grad():
        return (tr.wte.weight[tokens.long()] + tr.wpe.weight[:tokens.shape[1]]).to(torch.bfloat16)


def top_gradient(model, out: torch.Tensor, seed: int) -> torch.Tensor:
    """The loss's gradient at the last position, as the trainer's backward
    receives it: bf16 [N, T, E], zero but at position T-1, for random
    targets in 0..4."""
    n, e = out.shape
    targets = torch.from_numpy(np.random.RandomState(seed).randint(0, 5, n)).to(out.device)
    xl = out.float().requires_grad_()
    tr = model.transformer
    logits = fused_blocks.ln_f32(xl, tr.ln_f.weight.detach()) @ tr.wte.weight.detach().T
    (dxl,) = torch.autograd.grad(torch.nn.functional.cross_entropy(logits, targets), xl)
    dx = torch.zeros((n, model.cfg.block_size, e), dtype=torch.bfloat16, device=out.device)
    dx[:, -1] = dxl.to(torch.bfloat16)
    return dx


GRAD_NAMES = ("dx", "dwqkv", "dwproj", "dwfc", "dwfc2", "dg1", "dg2")


def plain_backward_chunks(xsave, dxin, stacks, chunk: int):
    """train_bwd_reference over `chunk` contexts a call: the contexts' dx
    joined, the weight and gain gradients summed."""
    dxs, grads = [], None
    for c0 in range(0, dxin.shape[0], chunk):
        dx, g = fgt.train_bwd_reference(xsave[:, c0:c0 + chunk], dxin[c0:c0 + chunk], stacks)
        dxs.append(dx)
        grads = list(g) if grads is None else [a + b for a, b in zip(grads, g)]
    return torch.cat(dxs), tuple(grads)


def compare_backward(label: str, xsave, dxin, stacks,
                     chunk: int | None = None) -> tuple[float, torch.Tensor]:
    """One backward chunk, kernel vs plain version (`chunk` contexts a
    plain call, all when None), and the kernel twice: the second launch
    must equal the first bit for bit; the backward's epilogue kernels
    counted around the first, exactly.  Returns (max |err|, the kernel's
    dx)."""
    n, _, e = dxin.shape
    torch.cuda.synchronize()
    fgt.reset_bwd_gemm_launches()
    got = fgt.train_backward(xsave, dxin, stacks)
    torch.cuda.synchronize()
    counts = fgt.bwd_gemm_launches()
    want = fgt.bwd_gemm_launch_count(stacks.wqkv.shape[0], n, e)
    log(f"[compare] {label}: LayerNorm backward route {ln_route(e)}; epilogue kernel launches "
        f"{counts}")
    if counts != want:
        raise RuntimeError(f"{label}: backward epilogue kernel launches {counts}, expected {want}")
    again = fgt.train_backward(xsave, dxin, stacks)
    torch.cuda.synchronize()
    ref = plain_backward_chunks(xsave, dxin, stacks, chunk or dxin.shape[0])
    err = max(check_close(f"{label} {name}", a, b, floor=1e-4, argmax=False, rel=0.08)
              for name, a, b in zip(GRAD_NAMES, (got[0], *got[1]), (ref[0], *ref[1])))
    if not all(torch.equal(a, b) for a, b in zip((got[0], *got[1]), (again[0], *again[1]))):
        raise RuntimeError(f"{label}: a second backward launch differs from the first")
    log(f"[compare] {label}: a second launch equals the first bit for bit")
    return err, got[0]


def ln_route(e: int) -> str:
    """The backward's LayerNorm route for n_embd e as csrc/fused_train.cu
    picks it (the library's cluster ranks), held equal to
    fused_gpt_train.ln_route (its mirror on the CPU)."""
    ranks = fgt._library().fused_train_ln_route(fused_blocks.stored_width(e))
    route = fgt.LN_ROUTES[2 if ranks == 0 else 0 if ranks == 1 else 1]
    if route != fgt.ln_route(e) or (ranks and ranks != fgt.ln_cluster_ranks(e)):
        raise RuntimeError(f"n_embd {e}: the library's LayerNorm route ({ranks} ranks) is not "
                           f"{fgt.ln_route(e)} ({fgt.ln_cluster_ranks(e)})")
    return route if ranks <= 1 else f"cluster of {ranks}"


def train_kernels_phase(models: dict, seed: int, dev) -> tuple[float, float]:
    """The training kernels against their plain versions: the 2M and 6M at
    full width and depth, the 85M's width on one chunk each way.  Returns
    the max |err| of the forward and of the backward."""
    fwd_err = bwd_err = 0.0
    for label, model in models.items():
        n = N_TRAIN_CMP[label]
        stacks = train_stacks(model)
        layers = stacks.wqkv.shape[0]
        _, _, real = reset_batch(seed, B, STEPS, dev)
        x = embed(model, real[:n])
        cfg = model.cfg
        route = train_attention_route(cfg.block_size, cfg.n_embd, cfg.n_head)
        torch.cuda.synchronize()
        fgt.reset_wgmma_launches()
        out, xsave = fgt.train_forward(x, stacks, last_only=True)
        torch.cuda.synchronize()
        ref_out, ref_xsave = fgt.train_fwd_reference(x, stacks, True)
        fwd_err = max(fwd_err,
                      check_close_channels(f"{label} train forward out", out, ref_out, 0),
                      check_close_channels(f"{label} train forward xsave", xsave, ref_xsave, 1))
        dx = top_gradient(model, out, seed)
        for lo in reversed(range(0, layers, 2)):
            hi = min(lo + 2, layers)
            err, dx = compare_backward(f"{label} train backward layers {lo}-{hi - 1}",
                                       xsave[2 * lo:2 * hi], dx, stacks.chunk(lo, hi))
            bwd_err = max(bwd_err, err)
        counts = fgt.wgmma_launches()
        log(f"[compare] {label} training kernels: attention route {route}, wgmma kernel "
            f"launches {counts}")
        if route == "wgmma" and min(counts.values()) == 0:
            raise RuntimeError(f"{label}: the training kernels ran no wgmma attention kernel")

    # other widths (the 85M's, head dims 8, 16, 96 and 128, n_embd 200, T=200 and
    # 300): a 2-layer forward chunk, a 1-layer backward chunk
    _, _, real = reset_batch(seed, B_85M, STEPS_85M, dev)
    for label, (e, h, t) in TRAIN_WIDTHS.items():
        cfg = GPTConfig(n_layer=2, n_head=h, n_embd=e, block_size=t)
        gen = torch.Generator().manual_seed(seed if label == "85M width" else seed + e + h + t)
        model = load_model(cfg, init_params(cfg, gen), device=dev)
        stacks = train_stacks(model)
        n = N_TRAIN_CMP["85M"]
        tokens = real[:n, :t] if t <= real.shape[1] else random_tokens(seed + t, n, cfg, dev)
        x = embed(model, tokens)
        label = f"{label} ({train_attention_route(t, e, h)} attention)"
        out, xsave = fgt.train_forward(x, stacks, last_only=False)
        torch.cuda.synchronize()
        ref_out, ref_xsave = fgt.train_fwd_reference(x, stacks, False)
        fwd_err = max(fwd_err,
                      check_close_channels(f"{label} train forward 2 layers, stream", out,
                                           ref_out, 0),
                      check_close_channels(f"{label} train forward xsave", xsave, ref_xsave, 1))
        gen = torch.Generator(device=dev).manual_seed(seed)
        dxin = (torch.randn(out.shape, generator=gen, device=dev) * 0.01).to(torch.bfloat16)
        err, _ = compare_backward(f"{label} train backward layer 1", xsave[2:4].contiguous(),
                                  dxin, stacks.chunk(1, 2))
        bwd_err = max(bwd_err, err)
        if repaired(e, h) and t == 256:
            xs, top = xsave[2:4].contiguous(), stacks.chunk(1, 2)
            fwd_ms = cuda_ms(lambda: fgt.train_forward(x, stacks, last_only=False), reps=3)
            bwd_ms = cuda_ms(lambda: fgt.train_backward(xs, dxin, top), reps=3)
            plain_fwd = cuda_ms(lambda: fgt.train_fwd_reference(x, stacks, False), reps=1)
            plain_bwd = cuda_ms(lambda: fgt.train_bwd_reference(xs, dxin, top), reps=1)
            stream = n * t * e * 2
            ops, exps = train_ops(t, e, h, 2, False, False)
            fwd_bound = bound(n * ops, n * exps, 6 * stream + nbytes(*stacks[:6]))
            ops, exps = train_ops(t, e, h, 1, False, True)
            bwd_bound = bound(n * ops, n * exps,
                              4 * stream + nbytes(*top[:6]) + sum(4 * g.numel() for g in top[:6]))
            log(f"[timing] {label} train N={n} T={t}: forward (2 layers) {fwd_ms:.3f} ms (plain "
                f"{plain_fwd:.3f} ms, bound {fwd_bound[0]:.3f} ms {fwd_bound[1]}), backward (1 "
                f"layer) {bwd_ms:.3f} ms (plain {plain_bwd:.3f} ms, bound {bwd_bound[0]:.3f} ms "
                f"{bwd_bound[1]})")
    return fwd_err, bwd_err


def distill_shard(path: str, model, seed: int, b: int, steps: int, dev) -> int:
    """Write a shard of the tokenizer's contexts on reset instances stepped
    with `model`'s argmax actions, the actions as targets.  Returns its
    contexts."""
    spec, states, _ = reset_batch(seed, b, steps, dev)
    forward = make_forward(model)
    tokens, actions = [], []
    for _ in range(steps):
        tok = _tokens_of(states).reshape(b * A, -1)
        a = act(forward(tok), do_sample=False)
        tokens.append(tok.cpu())
        actions.append(a.cpu())
        states = menv.step(spec, states, a.reshape(b, A))
    write_arrow_shard(path, torch.cat(tokens).numpy().astype(np.int8),
                      torch.cat(actions).numpy().astype(np.int8))
    return b * A * steps


def trainer_phase(teacher, seed: int, dev) -> dict:
    """The 6M trainer through train.loop.train on shards made here, the
    training kernels' counters set to 0 just before and read just after;
    then the newest checkpoint drives one rollout step."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        for name, s, steps in (("train", seed + 100, 8), ("valid", seed + 200, 4)):
            os.makedirs(os.path.join(tmp, name))
            n = distill_shard(os.path.join(tmp, name, "chunk_0_part_0.arrow"), teacher, s, B,
                              steps, dev)
            log(f"[trainer] {name} shard: {n} contexts")
        out_dir = os.path.join(tmp, "out")
        args = train_loop.parse_args([
            "--model", "6M", "--device", str(dev), "--train-data", os.path.join(tmp, "train"),
            "--valid-data", os.path.join(tmp, "valid"), "--out-dir", out_dir,
            "--batch-size", str(TRAIN_BATCH), "--grad-accum", str(TRAIN_ACCUM),
            "--max-iters", str(TRAIN_ITERS), "--eval-interval", "10", "--eval-iters", "4",
            "--log-interval", "5", "--seed", str(seed)])
        torch.cuda.synchronize()
        fgt.fwd_launches = fgt.bwd_launches = 0
        fused_gpt.launches = fused_blocks.launches = 0
        fgt.reset_wgmma_launches()
        fgt.reset_bwd_gemm_launches()
        t0 = time.perf_counter()
        result = train_loop.train(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = (fgt.fwd_launches, fgt.bwd_launches)
        att_launches = fgt.wgmma_launches()
        epi_launches = fgt.bwd_gemm_launches()
        micro = TRAIN_ITERS * TRAIN_ACCUM
        bwd_per_micro = -(-CONFIGS["6M"].n_layer // fgt._bwd_layers_per_call(CONFIGS["6M"]))
        log(f"[trainer] 6M {TRAIN_ITERS} iterations x {TRAIN_ACCUM} micro-batches of "
            f"{TRAIN_BATCH}: {wall:.2f} s, launches forward {launches[0]} backward "
            f"{launches[1]} (inference kernels {fused_gpt.launches}, {fused_blocks.launches})")
        if launches != (micro, micro * bwd_per_micro):
            raise RuntimeError(f"trainer: training kernel launches {launches}, expected "
                               f"{(micro, micro * bwd_per_micro)}")
        check_wgmma_launches("trainer 6M", att_launches, CONFIGS["6M"], micro, TRAIN_BATCH)
        check_bwd_gemm_launches("trainer 6M", epi_launches, CONFIGS["6M"], micro, TRAIN_BATCH)
        losses = [h["loss"] for h in result["history"]]
        evals = [(e["val_loss"], e["val_acc"]) for e in result["evals"]]
        log(f"[trainer] losses {losses}; evals (val_loss, val_acc) {evals}")
        if not all(np.isfinite(v) for v in losses + [x for e in evals for x in e]):
            raise RuntimeError("trainer: a loss is not finite")
        if not losses[-1] < losses[0] - LOSS_DROP:
            raise RuntimeError(f"trainer: last loss {losses[-1]:.4f} is not {LOSS_DROP} below "
                               f"the first {losses[0]:.4f}")
        meter = result["meter"]
        its = meter.smoothed or 0.0
        mfu = its * meter.flops_per_step / meter.peak_flops if meter.peak_flops else None
        mfu_text = "not measured" if mfu is None else f"{100 * mfu:.3f} %"
        log(f"[trainer] {its:.3f} it/s, MFU {mfu_text} against {meter.peak_flops} FLOP/s "
            f"(the trainer's meter); {micro * TRAIN_BATCH / wall:.1f} contexts/s over the run")

        step = ckpt.latest_step(out_dir)
        cfg, sd = load_reference_checkpoint(ckpt.checkpoint_path(out_dir, step))
        spec, states, _ = reset_batch(seed, B, 1, dev)
        rollout(f"6M trained here (iter {step})", spec, load_model(cfg, sd, device=dev), states,
                B, 1, e2e=1, blocks=0)
    return {"launches": launches, "it_per_s": its, "mfu": mfu,
            "losses": losses, "wall_s": wall, "wgmma_launches": att_launches,
            "bwd_gemm_launches": epi_launches}


def check_wgmma_launches(label: str, got: dict, cfg, micro: int, batch: int) -> None:
    """The training attention's wgmma kernels, counted over `micro`
    micro-batches of `batch` contexts of cfg's trainer: a forward and a
    recompute a layer and group of contexts, each backward side once."""
    route = fgt.attention_route(cfg.block_size, cfg.n_embd, cfg.n_head)
    per = micro * cfg.n_layer * -(-batch // fgt.GROUP)
    want = dict(zip(fgt.WGMMA_KERNELS, (2 * per, per, per)))
    log(f"[trainer] {label}: training attention route {route}; wgmma kernel launches {got}")
    if route != "wgmma" or got != want:
        raise RuntimeError(f"{label}: wgmma attention launches {got}, expected {want}")


def check_bwd_gemm_launches(label: str, got: dict, cfg, micro: int, batch: int) -> None:
    """The backward's epilogue kernels, counted over `micro` micro-batches
    of `batch` contexts of cfg's trainer: an MLP front a layer and group of
    contexts, two LN epilogues where the width takes them."""
    per = fgt.bwd_gemm_launch_count(cfg.n_layer, batch, cfg.n_embd)
    want = {k: micro * v for k, v in per.items()}
    log(f"[trainer] {label}: LayerNorm backward route {ln_route(cfg.n_embd)}; backward epilogue "
        f"kernel launches {got}")
    if got != want or min(got.values()) == 0:
        raise RuntimeError(f"{label}: backward epilogue kernel launches {got}, expected {want}")


def train_ops(t: int, e: int, h: int, layers: int, last_only: bool, backward: bool
              ) -> tuple[int, int]:
    """(bf16 product FLOP, exp count) of a training chunk on one context.

    Forward, a layer: q|k|v 6TE^2, scores and P@V 4T^2E, projection 2TE^2,
    MLP 16TE^2 (for the last row alone in a last_only chunk's final layer).
    Backward, a layer (recompute included): q|k|v, attention and fc
    recomputed 14TE^2 + 4T^2E, dX and dW of the five products 48TE^2, the
    four attention-backward products 8T^2E.  One exp per score a layer."""
    if backward:
        return layers * (62 * t * e * e + 12 * t * t * e), layers * h * t * t
    attn = 8 * t * e * e + 4 * t * t * e
    ops = layers * (attn + 16 * t * e * e)
    if last_only:
        ops -= 16 * t * e * e - 16 * e * e
    return ops, layers * h * t * t


def train_bounds(n: int, t: int, h: int, stacks: fgt.TrainStacks, chunks: int
                 ) -> tuple[tuple[float, str], tuple[float, str]]:
    """(forward, backward) bounds of the whole stack on n contexts, last
    position out: x read, out and xsave written; xsave read once, the top
    gradient and the chunks' dx in and out, weights, fp32 gradients."""
    layers, e, _ = stacks.wqkv.shape
    weights = nbytes(*stacks[:6])
    stream = n * t * e * 2
    ops, exps = train_ops(t, e, h, layers, True, False)
    fwd = bound(n * ops, n * exps, stream + 2 * layers * stream + n * e * 2 + weights)
    ops, exps = train_ops(t, e, h, layers, True, True)
    grads = sum(4 * g.numel() for g in stacks[:6])
    bwd = bound(n * ops, n * exps, 2 * layers * stream + 2 * chunks * stream + weights + grads)
    return fwd, bwd


def stack_runs(model, tokens: torch.Tensor, seed: int):
    """The training stack alone on `tokens`: (stacks, backward chunks,
    callables running the forward kernel, the backward chunks' kernels
    and the plain versions of both, TRAIN_PLAIN_CHUNK contexts a call, and
    the forward kernel's (x, out, xsave) with the top gradient dxin)."""
    cfg = model.cfg
    stacks = train_stacks(model)
    x = embed(model, tokens)
    out, xsave = fgt.train_forward(x, stacks, last_only=True)
    dxin = top_gradient(model, out, seed)
    blpc = fgt._bwd_layers_per_call(cfg)
    chunks = [(lo, min(lo + blpc, cfg.n_layer)) for lo in reversed(range(0, cfg.n_layer, blpc))]

    def forward():
        fgt.train_forward(x, stacks, last_only=True)

    def backward():
        dx = dxin
        for lo, hi in chunks:
            dx, _ = fgt.train_backward(xsave[2 * lo:2 * hi], dx, stacks.chunk(lo, hi))

    def plain_forward():
        for c in x.split(TRAIN_PLAIN_CHUNK):
            fgt.train_fwd_reference(c, stacks, True)

    def plain_backward():
        dx = dxin
        for lo, hi in chunks:
            dx, _ = plain_backward_chunks(xsave[2 * lo:2 * hi], dx, stacks.chunk(lo, hi),
                                          TRAIN_PLAIN_CHUNK)

    return (stacks, chunks, forward, backward, plain_forward, plain_backward,
            (x, out, xsave, dxin))


def train_timing(model, seed: int, dev, fwd_err: float, bwd_err: float,
                 trainer: dict) -> list[dict]:
    """One forward + backward of the 6M at N_TRAIN_TIME contexts: the
    kernels alone, the whole fused loss + backward, the plain versions."""
    cfg = model.cfg
    _, _, real = reset_batch(seed, B, STEPS, dev)
    tokens = real.repeat(N_TRAIN_TIME // real.shape[0], 1)
    stacks, chunks, forward, backward, plain_forward, plain_backward, _ = stack_runs(
        model, tokens, seed)

    targets = torch.from_numpy(np.random.RandomState(seed).randint(0, 5, tokens.shape[0])).to(dev)

    def whole():
        model.zero_grad(set_to_none=True)
        fgt.fused_loss_fn(model, tokens, targets).backward()

    fwd_ms = cuda_ms(forward, reps=3)
    bwd_ms = cuda_ms(backward, reps=3)
    torch.cuda.synchronize()
    fgt.reset_bwd_gemm_launches()
    backward()
    torch.cuda.synchronize()
    check_bwd_gemm_launches(f"6M backward at N={N_TRAIN_TIME}", fgt.bwd_gemm_launches(), cfg, 1,
                            N_TRAIN_TIME)
    lib = fgt._library()
    workspace = {label: lib.fused_train_workspace(1, fgt.GROUP, 256, e_, h_)
                 for label, (e_, h_) in (("6M", (256, 8)), ("85M", (768, 12)))}
    log("[timing] backward workspace for groups of 256 contexts: " + ", ".join(
        f"{label} {b} bytes" for label, b in workspace.items()))
    split = log_split(f"6M train N={N_TRAIN_TIME} backward", backward)   # warmed up above
    whole_ms = cuda_ms(whole, reps=3)
    plain_fwd_ms = cuda_ms(plain_forward, reps=1)
    plain_bwd_ms = cuda_ms(plain_backward, reps=1)
    n = N_TRAIN_TIME
    (fwd_bound, fwd_by), (bwd_bound, bwd_by) = train_bounds(n, cfg.block_size, cfg.n_head,
                                                            stacks, len(chunks))
    log(f"[timing] 6M train N={n}: forward kernel {fwd_ms:.3f} ms (plain {plain_fwd_ms:.3f} ms, "
        f"bound {fwd_bound:.3f} ms {fwd_by}, {100 * fwd_bound / fwd_ms:.2f} % of bound); "
        f"backward kernels {bwd_ms:.3f} ms in {len(chunks)} calls (plain {plain_bwd_ms:.3f} ms, "
        f"bound {bwd_bound:.3f} ms {bwd_by}, {100 * bwd_bound / bwd_ms:.2f} % of bound); "
        f"fused_loss_fn + backward {whole_ms:.3f} ms (bound of both {fwd_bound + bwd_bound:.3f} ms)")
    common = {"model": "6M", "route": "cuda", "source": "mapf_gpt_tpu_torch/csrc/fused_train.cu",
              "library_ms": None, "n_contexts": n}
    return [
        {"name": "fused_train_fwd", **common,
         "replaces": "mapf_gpt_tpu/ops/fused_gpt_train.py:98", "launches": trainer["launches"][0],
         "max_abs_err": fwd_err, "ms": fwd_ms, "plain_ms": plain_fwd_ms, "bound_ms": fwd_bound,
         "bound_by": fwd_by, "whole_loss_and_backward_ms": whole_ms},
        {"name": "fused_train_bwd", **common,
         "replaces": "mapf_gpt_tpu/ops/fused_gpt_train.py:133",
         "launches": trainer["launches"][1], "max_abs_err": bwd_err, "ms": bwd_ms,
         "plain_ms": plain_bwd_ms, "bound_ms": bwd_bound, "bound_by": bwd_by,
         "calls": len(chunks), "workspace_bytes": workspace,
         "attention_kernels_ms": {profiling.kernel_key(name): ms_k
                                  for ms_k, _, name in split if "attn" in name},
         "bwd_gemm_kernels_ms": {profiling.kernel_key(name): ms_k for ms_k, _, name in split
                                 if profiling.kernel_key(name) in fgt.BWD_GEMM_KERNELS}},
    ]


def check_attention(name: str, got: torch.Tensor, ref: torch.Tensor) -> float:
    """fp32 within rtol = atol = 1e-4 (tests/test_attention.py), bf16 within
    0.01 * max|ref| + 1e-3; returns max |got - ref|."""
    if got.shape != ref.shape or got.dtype != ref.dtype or not torch.isfinite(got).all():
        raise RuntimeError(f"{name}: kernel output {got.dtype} {tuple(got.shape)} not finite "
                           f"or not {ref.dtype} {tuple(ref.shape)}")
    diff = (got.float() - ref.float()).abs()
    if got.dtype == torch.float32:
        tol = 1e-4 + 1e-4 * ref.abs()
    else:
        tol = torch.full_like(diff, 0.01 * ref.float().abs().max().item() + 1e-3)
    worst = (diff / tol).max().item()
    log(f"[compare] {name}: max|err|={diff.max().item():.6f} worst err/tol={worst:.4f} "
        f"(max|ref|={ref.float().abs().max().item():.3f})")
    if worst > 1.0:
        raise RuntimeError(f"{name}: kernel disagrees with the plain version")
    return diff.max().item()


ATT_ROUTES = ("wgmma", "tile", "wide", "fma")   # csrc/attention.cu's attention_route codes


def attention_route(t: int, d: int, dtype: torch.dtype) -> str:
    """The kernel the C launcher (attention_route) takes for this shape."""
    code = tatt._library().attention_route(tatt._DTYPES[dtype], t, tatt.kernel_width(d, dtype))
    if code not in range(len(ATT_ROUTES)):
        raise RuntimeError(f"attention T={t} D={d} {dtype}: no route ({code})")
    return ATT_ROUTES[code]


def attention_phase(seed: int, dev) -> float:
    """The attention kernel against its plain version at ATT_SHAPES, fp32,
    bf16 and fp16, and at ATT_STRIDED as the module's strided views, on
    every route.  Returns the largest max |err|."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    err = 0.0
    routes = set()
    for shape in ATT_SHAPES:
        q, k, v = (torch.randn(shape, generator=gen, device=dev) for _ in range(3))
        scale = 1.0 / math.sqrt(shape[-1])
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            x = [t.to(dtype) for t in (q, k, v)]
            route = attention_route(shape[2], shape[3], dtype)
            routes.add(route)
            got = tatt.attention_pallas(*x, scale)
            torch.cuda.synchronize()
            err = max(err, check_attention(f"attention {list(shape)} {dtype} ({route})", got,
                                           tatt.attention_einsum(*x, scale)))
    if routes != set(ATT_ROUTES):
        raise RuntimeError(f"attention: routes {sorted(routes)} compared, not all four")
    for b, h, t, d in ATT_STRIDED:
        qkv = torch.randn((b, t, 3 * h * d), generator=gen, device=dev)
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            x = [z.reshape(b, t, h, d).transpose(1, 2) for z in qkv.to(dtype).split(h * d, dim=-1)]
            got = tatt.attention_pallas(*x, 1.0 / math.sqrt(d))
            torch.cuda.synchronize()
            err = max(err, check_attention(
                f"attention {[b, h, t, d]} {dtype} ({attention_route(t, d, dtype)}), "
                "strided views of q|k|v", got,
                tatt.attention_einsum(*x, 1.0 / math.sqrt(d))))
    return err


def module_route_phase(seed: int, dev) -> None:
    """The trained 6M on the module route, attn_impl "pallas" against
    "einsum", on phase 6's 512 contexts; 8 attention launches a forward."""
    cfg, sd = load_reference_checkpoint(CKPT_6M)
    forwards = {impl: make_forward(load_model(dataclasses.replace(cfg, attn_impl=impl), sd,
                                              device=dev), use_fused=False)
                for impl in ("pallas", "einsum")}
    _, _, real = reset_batch(seed, B, STEPS, dev)
    for label, tokens in (("reset-batch", real), ("random", random_tokens(seed, B * A, cfg, dev))):
        torch.cuda.synchronize()
        tatt.launches = 0
        got = forwards["pallas"](tokens)
        torch.cuda.synchronize()
        if tatt.launches != cfg.n_layer:
            raise RuntimeError(f"module route: {tatt.launches} attention launches in a "
                               f"forward, expected {cfg.n_layer}")
        check_close(f"6M module route, attn_impl pallas vs einsum, {label} tokens", got,
                    forwards["einsum"](tokens), floor=0.02, argmax=True)


def bias_rollout_phase(seed: int, dev) -> tuple[int, float]:
    """A bias=True, attn_impl="pallas" model at the 6M's width and depth
    through make_batch_rollout: the attention kernel once a layer and step,
    neither fused kernel.  Returns the attention launches and the rollout's
    seconds."""
    cfg = dataclasses.replace(CONFIGS["6M"], bias=True, attn_impl="pallas")
    gen = torch.Generator().manual_seed(seed)
    sd = init_params(cfg, gen)
    for name in sd:
        if name.endswith(".bias"):
            sd[name] = torch.randn(sd[name].shape, generator=gen) * 0.02
    model = load_model(cfg, sd, device=dev)
    spec, states, real = reset_batch(seed, B, STEPS, dev)
    einsum = load_model(dataclasses.replace(cfg, attn_impl="einsum"), sd, device=dev)
    check_close("6M-width bias=True, attn_impl pallas vs einsum, reset-batch tokens",
                make_forward(model)(real), make_forward(einsum)(real), floor=0.02, argmax=True)
    dt, (_, _, launches) = rollout("6M-width bias=True attn_impl=pallas (module route)", spec,
                                   model, states, B, STEPS, e2e=0, blocks=0,
                                   attn=cfg.n_layer * STEPS)
    forward = make_forward(model)
    ms = cuda_ms(lambda: forward(real), reps=10)
    log(f"[timing] 6M-width bias=True module route N={real.shape[0]}: forward {ms:.3f} ms of a "
        f"{1e3 * dt / STEPS:.3f} ms rollout step")
    return launches, dt


def host_us_per_call(fn, calls: int = 2000) -> float:
    """Host microseconds a call of fn() takes to enqueue, at a shape whose
    device work is far shorter (the wrapper's checks, tensor maps, launch)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = 1e6 * (time.perf_counter() - t0) / calls
    torch.cuda.synchronize()
    return us


def blocks_attention_timing(seed: int, dev, b: int, h: int, t: int, d: int) -> dict:
    """The layer stack's attention alone (fused_blocks.blocks_attention, the
    85M's width) on a random q|k|v workspace [b, t, 3 h d], W_q's scale and
    log2(e) folded into q as the stack folds them: held against its plain
    version (ATT_PLAIN_PAIRS // h contexts a call), then timed beside the
    bound and the exp2s' floor."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn((b, t, 3 * h * d), generator=gen, device=dev)
    qkv[..., :h * d] *= math.log2(math.e) / math.sqrt(d)
    qkv = qkv.to(torch.bfloat16)
    chunk = max(1, ATT_PLAIN_PAIRS // h)
    got = fused_blocks.blocks_attention(qkv, h)
    torch.cuda.synchronize()
    err = 0.0
    for i in range(0, b, chunk):
        err = max(err, check_attention(
            f"blocks attention [{b}, {h}, {t}, {d}] contexts {i}..{min(b, i + chunk) - 1}",
            got[i:i + chunk], fused_blocks.attention_reference(qkv[i:i + chunk], h)))
    ms = cuda_ms(lambda: fused_blocks.blocks_attention(qkv, h), reps=5)
    plain_ms = cuda_ms(lambda: [fused_blocks.attention_reference(qkv[i:i + chunk], h)
                                for i in range(0, b, chunk)], reps=1)
    n = b * h
    bound_ms, bound_by = bound(4 * n * t * t * d, n * t * t, 4 * n * t * d * 2)
    floor_ms = mufu_floor_ms(n * t * t)
    log(f"[timing] blocks attention (the 85M stack's) [{b}, {h}, {t}, {d}]: kernel {ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}), exp2 floor "
        f"{floor_ms:.3f} ms, {100 * bound_ms / ms:.2f} % of bound")
    return {"shape": [b, h, t, d], "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "max_abs_err": err}


def check_attention_chunks(name: str, got: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, scale: float, chunk: int) -> float:
    """got, the kernel's output on q, k, v, held against attention_einsum
    `chunk` batch entries at a time; returns max |got - ref|."""
    return max(check_attention(f"{name} batch {i}..{min(got.shape[0], i + chunk) - 1}",
                               got[i:i + chunk], tatt.attention_einsum(
                                   q[i:i + chunk], k[i:i + chunk], v[i:i + chunk], scale))
               for i in range(0, got.shape[0], chunk))


def attention_timing(seed: int, dev, launches: int, max_err: float) -> tuple[dict, dict]:
    """The attention kernel at ATT_TIME in bf16 and fp16, its outputs there
    held against its plain version chunk by chunk, timed beside the plain
    version, one scaled_dot_product_attention call, the bound and the
    exp2s' floor; the layer stack's attention alone at the 85M's shape; the
    host time of a call.  Returns the attention's entry and the stack's
    attention timing."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows = {}
    for label, (b, h, t, d) in ATT_TIME.items():
        q, k, v = (torch.randn((b, h, t, d), generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(3))
        scale = 1.0 / math.sqrt(d)
        chunk = max(1, ATT_PLAIN_PAIRS // h)
        qh, kh, vh = (z.half() for z in (q, k, v))
        for x in ((q, k, v), (qh, kh, vh)):
            got = tatt.attention_pallas(*x, scale)
            torch.cuda.synchronize()
            max_err = max(max_err, check_attention_chunks(
                f"attention {label} [{b}, {h}, {t}, {d}] {x[0].dtype} "
                f"({attention_route(t, d, x[0].dtype)})", got, *x, scale, chunk))
            del got
        ms = cuda_ms(lambda: tatt.attention_pallas(q, k, v, scale), reps=5)
        plain_ms = cuda_ms(lambda: [tatt.attention_einsum(q[i:i + chunk], k[i:i + chunk],
                                                          v[i:i + chunk], scale)
                                    for i in range(0, b, chunk)], reps=1)
        sdpa_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, scale=scale), reps=5)
        fp16_ms = cuda_ms(lambda: tatt.attention_pallas(qh, kh, vh, scale), reps=5)
        sdpa16_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, scale=scale), reps=5)
        n = b * h
        bound_ms, bound_by = bound(4 * n * t * t * d, n * t * t, 4 * n * t * d * 2)
        floor_ms = mufu_floor_ms(n * t * t)
        log(f"[timing] attention {label} [{b}, {h}, {t}, {d}] bf16 "
            f"({attention_route(t, d, torch.bfloat16)}): kernel {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms, scaled_dot_product_attention {sdpa_ms:.3f} ms, bound "
            f"{bound_ms:.3f} ms ({bound_by}), exp2 floor {floor_ms:.3f} ms, "
            f"{100 * bound_ms / ms:.2f} % of bound")
        log(f"[timing] attention {label} [{b}, {h}, {t}, {d}] fp16: kernel {fp16_ms:.3f} ms, "
            f"scaled_dot_product_attention {sdpa16_ms:.3f} ms")
        rows[label] = {"shape": [b, h, t, d], "ms": ms, "plain_ms": plain_ms,
                       "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": sdpa_ms,
                       "fp16_ms": fp16_ms, "fp16_library_ms": sdpa16_ms}
    blocks_att = blocks_attention_timing(seed, dev, *ATT_TIME["85M"])
    blocks_att["library_ms"] = rows["85M"]["library_ms"]
    # host time of a call, at one pair of 64 keys: bf16 encodes three tensor maps, fp32 none
    tiny = torch.randn((1, 1, 64, 32), generator=gen, device=dev)
    host_us = {}
    for dtype in (torch.bfloat16, torch.float32):
        x = tiny.to(dtype)
        host_us[str(dtype).split(".")[-1]] = host_us_per_call(
            lambda: tatt.attention_pallas(x, x, x, 0.2))
    log(f"[timing] attention host time a call at [1, 1, 64, 32] (wrapper, tensor maps, launch): "
        + ", ".join(f"{k} {v:.1f} us" for k, v in host_us.items()))
    return ({"name": "attention", "model": "bias=True 6M width, attn_impl=pallas",
             "route": "cuda", "source": "mapf_gpt_tpu_torch/csrc/attention.cu",
             "replaces": "mapf_gpt_tpu/ops/attention.py:37", "launches": launches,
             "max_abs_err": max_err, **rows["2M"], "at_85m_shape": rows["85M"],
             "host_us_per_call": host_us}, blocks_att)


def train_attention_route(t: int, e: int, h: int) -> str:
    """The training attention's route as csrc/fused_train.cu picks it, held
    equal to fused_gpt_train.attention_route (its mirror on the CPU)."""
    code = fgt._library().fused_train_attention_route(t, e, h)
    route = fgt.ROUTES[code] if code in range(len(fgt.ROUTES)) else None
    if route != fgt.attention_route(t, e, h):
        raise RuntimeError(f"training attention T={t} n_embd={e} {h} heads: the library's "
                           f"route {code} is not {fgt.attention_route(t, e, h)}")
    return route


def check_train_attention(label: str, qkv, datt, h: int, chunk: int) -> dict[str, float]:
    """The training attention's kernels on qkv, datt against their plain
    versions (`chunk` contexts a plain call), and the backward twice, bit
    for bit.  Returns the max |err| of each kernel's output: "fwd" (att),
    "q" (dq), "kv" (dk and dv)."""
    att, m, l = fgt.train_attention(qkv, h)
    dqkv = fgt.train_attention_backward(qkv, datt, att, m, l, h)
    again = fgt.train_attention_backward(qkv, datt, att, m, l, h)
    torch.cuda.synchronize()
    if not torch.equal(dqkv, again):
        raise RuntimeError(f"{label}: a second backward call differs from the first")
    e = qkv.shape[-1] // 3
    errs = dict.fromkeys(("fwd", "q", "kv"), 0.0)
    for c0 in range(0, qkv.shape[0], chunk):
        c = slice(c0, c0 + chunk)
        part = f"{label} contexts {c0}..{min(c0 + chunk, qkv.shape[0]) - 1}"
        ref_att, ref_m, ref_l = fgt.train_attention_reference(qkv[c], h)
        errs["fwd"] = max(errs["fwd"], check_close(f"{part} att", att[c], ref_att, floor=0.02,
                                                   argmax=False))
        check_close(f"{part} m", m[c], ref_m, floor=1e-3, argmax=False, rel=1e-3)
        check_close(f"{part} l", l[c], ref_l, floor=1e-3, argmax=False, rel=1e-3)
        ref = fgt.train_attention_backward_reference(qkv[c], datt[c], h)
        for i, name in enumerate(("dq", "dk", "dv")):
            sl = slice(i * e, (i + 1) * e)
            kern = "q" if name == "dq" else "kv"
            errs[kern] = max(errs[kern], check_close(f"{part} {name}", dqkv[c, :, sl],
                                                     ref[..., sl], floor=1e-4, argmax=False,
                                                     rel=0.08))
        del ref_att, ref_m, ref_l, ref
    log(f"[compare] {label}: a second backward call equals the first bit for bit")
    return errs


def train_attention_phase(seed: int, dev) -> dict:
    """21. The training attention's kernels alone: compared at
    TRAIN_ATT_SHAPES, then compared and timed at TRAIN_ATT_TIME beside the
    bounds, the exp2s' floor, the plain versions and the library's flash
    attention.  Returns the timings and each kernel's largest error."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(seed)
    errs = dict.fromkeys(("fwd", "q", "kv"), 0.0)
    routes = set()

    def inputs(n, h, t, d):
        qkv = torch.randn((n, t, 3 * h * d), generator=gen, device=dev).to(torch.bfloat16)
        datt = torch.randn((n, t, h * d), generator=gen, device=dev).to(torch.bfloat16)
        return qkv, datt

    for n, h, t, d in TRAIN_ATT_SHAPES:
        route = train_attention_route(t, h * d, h)
        routes.add(route)
        qkv, datt = inputs(n, h, t, d)
        got = check_train_attention(f"training attention [{n}, {h}, {t}, {d}] ({route})", qkv,
                                    datt, h, n)
        errs = {k_: max(errs[k_], got[k_]) for k_ in errs}
    if routes != {"wgmma"}:
        raise RuntimeError(f"training attention: routes {sorted(routes)}, not the wgmma kernels")
    rows = {}
    for label, (n, h, t, d) in TRAIN_ATT_TIME.items():
        route = train_attention_route(t, h * d, h)
        qkv, datt = inputs(n, h, t, d)
        got = check_train_attention(f"training attention {label} [{n}, {h}, {t}, {d}] ({route})",
                                    qkv, datt, h, TRAIN_ATT_PLAIN)
        errs = {k_: max(errs[k_], got[k_]) for k_ in errs}
        att, m, l = fgt.train_attention(qkv, h)
        scratch = torch.empty(fgt._library().fused_train_attention_scratch(n, t, h * d, h),
                              dtype=torch.float32, device=dev)
        dqkv = fgt.train_attention_backward(qkv, datt, att, m, l, h, scratch=scratch)

        def side(sides):
            return lambda: fgt.train_attention_backward(qkv, datt, att, m, l, h, sides=sides,
                                                        scratch=scratch)

        ms = {"fwd": cuda_ms(lambda: fgt.train_attention(qkv, h), reps=5),
              "q": cuda_ms(side(1), reps=5), "kv": cuda_ms(side(2), reps=5)}
        ms["plain_fwd"] = cuda_ms(lambda: [fgt.train_attention_reference(
            qkv[i:i + TRAIN_ATT_PLAIN], h) for i in range(0, n, TRAIN_ATT_PLAIN)], reps=1)
        ms["plain_bwd"] = cuda_ms(lambda: [fgt.train_attention_backward_reference(
            qkv[i:i + TRAIN_ATT_PLAIN], datt[i:i + TRAIN_ATT_PLAIN], h)
            for i in range(0, n, TRAIN_ATT_PLAIN)], reps=1)
        q, k, v = (z.reshape(n, t, h, d).transpose(1, 2).detach().requires_grad_()
                   for z in qkv.split(h * d, dim=-1))
        do = datt.reshape(n, t, h, d).transpose(1, 2)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        scale = 1.0 / math.sqrt(d)
        with torch.no_grad():
            ms["sdpa_fwd"] = cuda_ms(lambda: sdpa(q, k, v, scale=scale), reps=5)
        ms["sdpa_fwd_bwd"] = cuda_ms(lambda: torch.autograd.grad(
            sdpa(q, k, v, scale=scale), (q, k, v), do), reps=5)
        ms["sdpa_bwd"], grads = flash_backward(q.detach(), k.detach(), v.detach(), do, scale)
        flash_diff = (torch.cat([g.transpose(1, 2).reshape(n, t, h * d) for g in grads], -1)
                      .float() - dqkv.float()).abs().max().item()
        del q, k, v, do, grads, dqkv
        # bounds: each input read once, each output written once; T^2 exp2s a pair a kernel
        pairs, act, stat = n * h, n * t * h * d * 2, n * h * t * 4
        exps = pairs * t * t
        # (q side: q, k, v, dA, m and l in, dq and each row's lse and delta out; the
        # forward's att, which the kernel reads for delta, is no input dq needs)
        bounds = {"fwd": bound(4 * pairs * t * t * d, exps, 3 * act + act + 2 * stat),
                  "q": bound(6 * pairs * t * t * d, exps, 4 * act + 2 * stat + act + 2 * stat),
                  "kv": bound(8 * pairs * t * t * d, exps, 4 * act + 2 * stat + 2 * act)}
        floor_ms = mufu_floor_ms(exps)
        for kern, name in (("fwd", "forward with statistics"), ("q", "attn_bwd_q_wgmma"),
                           ("kv", "attn_bwd_kv_wgmma")):
            log(f"[timing] training attention {label} [{n}, {h}, {t}, {d}] {name}: "
                f"{ms[kern]:.3f} ms, bound {bounds[kern][0]:.3f} ms ({bounds[kern][1]}), exp2 "
                f"floor {floor_ms:.3f} ms, {100 * bounds[kern][0] / ms[kern]:.2f} % of bound")
        log(f"[timing] training attention {label}: plain forward {ms['plain_fwd']:.3f} ms, plain "
            f"backward {ms['plain_bwd']:.3f} ms; scaled_dot_product_attention forward "
            f"{ms['sdpa_fwd']:.3f} ms, forward + backward {ms['sdpa_fwd_bwd']:.3f} ms against "
            f"{ms['fwd'] + ms['q'] + ms['kv']:.3f}; the flash backward alone "
            f"{ms['sdpa_bwd']:.3f} ms against {ms['q'] + ms['kv']:.3f} (its dq|dk|dv within "
            f"{flash_diff:.3g} of ours)")
        rows[label] = {"shape": [n, h, t, d], "ms": ms,
                       "bound_ms": {k_: b[0] for k_, b in bounds.items()},
                       "bound_by": {k_: b[1] for k_, b in bounds.items()},
                       "exp2_floor_ms": floor_ms}
        del qkv, datt, att, m, l, scratch
    seconds = time.perf_counter() - t0
    log(f"[done] training attention phase {seconds:.1f} s")
    return {"rows": rows, "err": errs, "seconds": seconds}


def flash_backward(q, k, v, do, scale: float) -> tuple[float, tuple]:
    """ms of one call of aten's flash-attention backward (dq, dk and dv of
    [B, H, T, D] q, k, v from the forward's output and logsumexp), the
    library call for the pair of training backward kernels, and its
    (dq, dk, dv); the forward that feeds it is run once, untimed."""
    aten = torch.ops.aten
    out, lse, cq, ck, mq, mk, seed_, offset, _ = aten._scaled_dot_product_flash_attention(
        q, k, v, 0.0, False, False, scale=scale)

    def call():
        return aten._scaled_dot_product_flash_attention_backward(
            do, q, k, v, out, lse, cq, ck, mq, mk, 0.0, False, seed_, offset, scale=scale)

    return cuda_ms(call, reps=5), call()


def train_attention_entries(phase: dict, launches: dict) -> list[dict]:
    """The kernels JSON line's entries of the training attention's wgmma
    kernels: the 6M shape's numbers, the 85M's beside them, `launches` from
    the 6M trainer's run (phase 10)."""
    out = []
    for kern, name, source, replaces in (
            ("fwd", "attn_wgmma_kernel", "mapf_gpt_tpu_torch/csrc/attn_wgmma.cuh",
             "mapf_gpt_tpu/ops/fused_gpt_train.py:98"),
            ("q", "attn_bwd_q_wgmma", "mapf_gpt_tpu_torch/csrc/attn_wgmma_bwd.cuh",
             "mapf_gpt_tpu/ops/fused_gpt_train.py:133"),
            ("kv", "attn_bwd_kv_wgmma", "mapf_gpt_tpu_torch/csrc/attn_wgmma_bwd.cuh",
             "mapf_gpt_tpu/ops/fused_gpt_train.py:133")):
        # library_ms: the flash forward for the forward; the flash backward, which
        # computes dq, dk and dv at once, for each of the two backward kernels
        def row(r):
            return {"ms": r["ms"][kern], "plain_ms": r["ms"]["plain_" + ("fwd" if kern == "fwd"
                                                                         else "bwd")],
                    "bound_ms": r["bound_ms"][kern], "bound_by": r["bound_by"][kern],
                    "library_ms": r["ms"]["sdpa_fwd" if kern == "fwd" else "sdpa_bwd"],
                    "exp2_floor_ms": r["exp2_floor_ms"],
                    "sdpa_fwd_bwd_ms": r["ms"]["sdpa_fwd_bwd"], "shape": r["shape"]}
        out.append({"name": name, "model": "6M trainer (training attention)", "route": "cuda",
                    "source": source, "replaces": replaces, "launches": launches[name],
                    "max_abs_err": phase["err"][kern], **row(phase["rows"]["6M"]),
                    "at_85m_shape": row(phase["rows"]["85M"])})
    return out


def check_bf16_step(name: str, got: torch.Tensor, ref: torch.Tensor) -> float:
    """bf16 got vs bf16 ref, each the rounding of an fp32 value that differs
    only by the order of a product's sum: every element within one bf16
    step of ref (|got - ref| <= 2^-7 |ref|, plus 1e-5 * max|ref| where a
    value is near 0).  Returns max |got - ref|."""
    if got.shape != ref.shape or not torch.isfinite(got.float()).all():
        raise RuntimeError(f"{name}: kernel output {tuple(got.shape)} not finite or "
                           f"not of shape {tuple(ref.shape)}")
    diff = (got.float() - ref.float()).abs()
    scale = ref.float().abs().max().item()
    bad = (diff > ref.float().abs() * 2.0 ** -7 + 1e-5 * scale).sum().item()
    err = diff.max().item()
    log(f"[compare] {name}: n={got.numel()} max|err|={err:.6f} (max|ref|={scale:.3f}); "
        f"{bad} elements more than one bf16 step from the plain version")
    if bad:
        raise RuntimeError(f"{name}: kernel disagrees with the plain version")
    return err


def bwd_gemm_phase(seed: int, dev) -> dict:
    """22. The backward's epilogue kernels alone at BWD_GEMM_SHAPES: the MLP
    front's hact against gemm_tile's GELU epilogue bit for bit, hact and dh
    within a bf16 step of the plain version, the LN epilogue at both sites
    against its plain version (the update, dxb, dg; twice, bit for bit),
    then each timed beside its bound, its plain version and the gemm_tile
    products of the same operands.  Returns the timings and each kernel's
    largest error."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(torch.bfloat16)

    errs = {"mlp_front_kernel": 0.0, "ln_dx_kernel": 0.0}
    rows = {}
    for label, (m, e, f) in BWD_GEMM_SHAPES.items():
        row = {"shape": [m, e, f]}
        # the MLP front: xn2, dxb [M, E], Wfc [E, F], Wfc2 [F, E]
        xn2, dxb = rand(m, e), rand(m, e, scale=0.1)
        wfc, wfc2 = rand(e, f, scale=0.05), rand(f, e, scale=0.05)
        hact, dh = fgt.mlp_front(xn2, wfc, dxb, wfc2)
        g_h = fgt.gemm_tile(xn2, wfc, gelu=True)
        torch.cuda.synchronize()
        ref_h, ref_d = fgt.mlp_front_reference(xn2, wfc, dxb, wfc2)
        name = f"MLP front {label} [{m}, {e}, {f}]"
        if not torch.equal(hact, g_h):
            raise RuntimeError(f"{name}: hact differs from gemm_tile's GELU epilogue on the same "
                               f"operands (max diff {(hact.float() - g_h.float()).abs().max()})")
        log(f"[compare] {name}: hact equals gemm_tile's product of the same operands through the "
            f"forward's GELU epilogue bit for bit")
        errs["mlp_front_kernel"] = max(errs["mlp_front_kernel"],
                                       check_bf16_step(f"{name} hact", hact, ref_h),
                                       check_bf16_step(f"{name} dh", dh, ref_d))
        del g_h, ref_h, ref_d
        ms_front = cuda_ms(lambda: fgt.mlp_front(xn2, wfc, dxb, wfc2), reps=10)
        ms_two = cuda_ms(lambda: (fgt.gemm_tile(xn2, wfc), fgt.gemm_tile(dxb, wfc2, b_k=True)),
                         reps=10)
        ms_plain = cuda_ms(lambda: fgt.mlp_front_reference(xn2, wfc, dxb, wfc2), reps=1)
        # operations: the two products (an exp2 a hidden value); bytes: each input once,
        # hact and dh written
        b_front = bound(4 * m * e * f, m * f, nbytes(xn2, dxb, wfc, wfc2) + 2 * m * f * 2)
        row["mlp_front_kernel"] = {
            "ms": ms_front, "plain_ms": ms_plain, "bound_ms": b_front[0], "bound_by": b_front[1],
            "two_gemm_tile_ms": ms_two, "hact_bit_equal_to_gemm_tile_gelu": True}
        log(f"[timing] MLP front {label} [{m}, {e}, {f}]: {ms_front:.4f} ms, bound "
            f"{b_front[0]:.4f} ms ({b_front[1]}, {100 * b_front[0] / ms_front:.2f} % of bound); "
            f"two gemm_tile products of the same operands (bf16 out) {ms_two:.4f} ms; plain "
            f"{ms_plain:.3f} ms")
        del xn2, dxb, hact, dh
        # the LN epilogue at its two sites: dh Wfc^T (K = F) and dqkv Wqkv^T (K = 3E)
        for site, k, w in (("LN2 (dh Wfc^T)", f, wfc),
                           ("LN1 (dqkv Wqkv^T)", 3 * e, rand(e, 3 * e, scale=0.05))):
            a = rand(m, k, scale=0.1)
            x = rand(m, e, scale=0.5)
            g = 1.0 + 0.1 * torch.randn(e, generator=gen, device=dev)
            dx = torch.randn((m, e), generator=gen, device=dev) * 0.1
            mu = x.float().mean(-1)
            rstd = torch.rsqrt((x.float() - mu[:, None]).square().mean(-1) + 1e-5)
            got = fgt.ln_backward_dx(a, w, x, g, dx.clone(), mu, rstd, e)
            again = fgt.ln_backward_dx(a, w, x, g, dx.clone(), mu, rstd, e)
            torch.cuda.synchronize()
            if not all(torch.equal(p_, q_) for p_, q_ in zip(got, again)):
                raise RuntimeError(f"LN epilogue {label} {site}: a second call differs")
            ref = fgt.ln_backward_dx_reference(a, w, x, g, dx, mu, rstd, e)
            name = f"LN epilogue {label} {site} [{m}, {e}, {k}] ({ln_route(e)})"
            # the update itself: dx carried in would swell max|ref| past the mean terms
            errs["ln_dx_kernel"] = max(
                errs["ln_dx_kernel"],
                check_close(f"{name} dx update", got[0] - dx, ref[0] - dx, floor=1e-5,
                            argmax=False, rel=1e-3),
                check_close(f"{name} dg", got[2], ref[2], floor=1e-6, argmax=False, rel=1e-4))
            if not torch.equal(got[1], got[0].to(torch.bfloat16)):
                raise RuntimeError(f"{name}: dxb is not bf16(dx)")
            log(f"[compare] {name}: dxb equals bf16(dx); a second call equals the first bit "
                f"for bit")
            del got, again, ref
            # dx updated in place, as the backward does (its values drift; its time does not)
            ms_ln = cuda_ms(lambda: fgt.ln_backward_dx(a, w, x, g, dx, mu, rstd, e), reps=10)
            ms_mm = cuda_ms(lambda: fgt.gemm_tile(a, w, b_k=True), reps=10)
            ms_plain = cuda_ms(lambda: fgt.ln_backward_dx_reference(a, w, x, g, dx, mu, rstd, e),
                               reps=1)
            # bytes: A, W, x, g, mu and rstd read once, dx read and written, dxb and dg written
            b_ln = bound(2 * m * e * k, 0, nbytes(a, w, x, g, mu, rstd) + 2 * nbytes(dx)
                         + m * e * 2 + e * 4)
            row[f"ln_dx_kernel {site.split()[0]}"] = {
                "ms": ms_ln, "plain_ms": ms_plain, "bound_ms": b_ln[0], "bound_by": b_ln[1],
                "gemm_tile_ms": ms_mm, "over_gemm_tile": ms_ln / ms_mm}
            log(f"[timing] {name}: {ms_ln:.4f} ms, bound {b_ln[0]:.4f} ms ({b_ln[1]}, "
                f"{100 * b_ln[0] / ms_ln:.2f} % of bound); gemm_tile's product alone (bf16 out) "
                f"{ms_mm:.4f} ms, the kernel {ms_ln / ms_mm:.2f}x that; plain {ms_plain:.3f} ms")
            del a, x, dx
        rows[label] = row
    seconds = time.perf_counter() - t0
    log(f"[done] backward epilogue kernels phase {seconds:.1f} s")
    return {"rows": rows, "err": errs, "seconds": seconds}


def bwd_gemm_entries(phase: dict, launches: dict) -> list[dict]:
    """The kernels JSON line's entries of the backward's epilogue kernels:
    the 6M shape's numbers (the LN epilogue's at its LN2 site), the 85M's
    beside them, `launches` from the 6M trainer's run (phase 10)."""
    out = []
    for name, key in (("mlp_front_kernel", "mlp_front_kernel"),
                      ("ln_dx_kernel", "ln_dx_kernel LN2")):
        def row(r):
            return {**r[key], "shape": r["shape"]}
        out.append({"name": name, "model": "6M trainer (backward epilogues)", "route": "cuda",
                    "source": "mapf_gpt_tpu_torch/csrc/train_bwd_gemm.cuh",
                    "replaces": "mapf_gpt_tpu/ops/fused_gpt_train.py:133",
                    "launches": launches[name], "max_abs_err": phase["err"][name],
                    "library_ms": None, **row(phase["rows"]["6M"]),
                    "at_85m_shape": row(phase["rows"]["85M"])})
        if name == "ln_dx_kernel":
            out[-1]["ln1_site"] = {k_: phase["rows"][k_]["ln_dx_kernel LN1"]
                                   for k_ in phase["rows"]}
    return out


def check_rows(label: str, rows: list, steps: int, lifelong: bool) -> None:
    """The evaluator's rows against the metrics' invariants."""
    for r in rows:
        a = r["num_agents"]
        bad = [not 0.0 <= r["ISR"] <= 1.0, r["CSR"] not in (0.0, 1.0),
               r["CSR"] == 1.0 and r["ISR"] != 1.0, not 0.0 <= r["makespan"] <= steps,
               not r["makespan"] <= r["SoC"] <= a * steps, not r["runtime"] > 0,
               not 0 < r["ep_length"] <= steps, not r["avg_agents_density"] > 0]
        if lifelong:
            bad += [r["ep_length"] != steps, not r["avg_throughput"] >= 0.0]
        else:
            bad += [r["ep_length"] < steps and r["CSR"] != 1.0, r["avg_throughput"] != 0.0]
        if any(bad):
            raise RuntimeError(f"evaluator {label}: a row breaks the metrics' invariants: {r}")


def step_split(model, states, spec, reps: int) -> dict:
    """Device-timeline ms of one rollout step's parts (tokenizer, policy
    forward, act, env step), CUDA events between the parts, averaged over
    `reps` steps."""
    forward = make_forward(model)
    b, a = states.pos.shape[:2]
    names = ("tokens", "forward", "act", "env_step")
    total = dict.fromkeys(names, 0.0)
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        tokens = _tokens_of(states).reshape(b * a, -1)
        ev[1].record()
        logits = forward(tokens)
        ev[2].record()
        actions = act(logits, do_sample=False)
        ev[3].record()
        states = menv.step(spec, states, actions.reshape(b, a))
        ev[4].record()
        torch.cuda.synchronize()
        for i, n in enumerate(names):
            total[n] += ev[i].elapsed_time(ev[i + 1]) / reps
    return total


def evaluator_phase(model, seed: int, dev) -> dict:
    """16. The suite evaluator on CUDA with the trained 2M, argmax: one-shot
    specs on procedural random and maze maps, lifelong specs on the
    warehouse map (K = EVAL_K, lazy and dense cost2go, rows equal), the e2e
    kernel's launches one per step and chunk; the lazy step split into its
    parts with relax_fixpoint timed beside its row-loop plain version; the
    bench workload's step split; and one recorded rollout with an input
    mask."""
    t0 = time.perf_counter()
    reg = MapRegistry()
    reg.register("random-21", random_grid(21, DENSITY, seed))
    reg.register("maze-21", maze_grid(21, seed))
    reg.register("warehouse", warehouse_grid())
    out = {}

    ev = Evaluator(reg, model, batch_envs=EVAL_BATCH, do_sample=False, device=dev)
    specs = [EpisodeSpec(m, a, s, max_episode_steps=EVAL_STEPS) for m, a, n in EVAL_ONE_SHOT
             for s in range(seed, seed + n)]
    chunks = sum(-(-sum(1 for s in specs if ev._group_key(s) == key) // EVAL_BATCH)
                 for key in {ev._group_key(s) for s in specs})
    fused_gpt.launches = fused_blocks.launches = tatt.launches = 0
    rows = ev.run(specs).rows
    torch.cuda.synchronize()
    launches = (fused_gpt.launches, fused_blocks.launches, tatt.launches)
    log(f"[evaluator] one-shot: {len(rows)} episodes in {chunks} chunks, kernel launches e2e "
        f"{launches[0]} blocks {launches[1]} attention {launches[2]}")
    if launches != (chunks * EVAL_STEPS, 0, 0) or len(rows) != len(specs):
        raise RuntimeError(f"evaluator one-shot: launches {launches}, expected "
                           f"{(chunks * EVAL_STEPS, 0, 0)}")
    check_rows("one-shot", rows, EVAL_STEPS, lifelong=False)
    for r in rows:
        log(f"[evaluator]   {r['map_name']} A={r['num_agents']} seed {r['seed']}: CSR {r['CSR']} "
            f"ISR {r['ISR']:.4f} SoC {r['SoC']} makespan {r['makespan']} ep_length "
            f"{r['ep_length']} runtime {r['runtime']:.4f} s")
    out["one_shot"] = {"episodes": len(rows), "e2e_launches": launches[0],
                       "CSR": float(np.mean([r["CSR"] for r in rows])),
                       "ISR": float(np.mean([r["ISR"] for r in rows])),
                       "runtime_s_per_episode": float(np.mean([r["runtime"] for r in rows]))}

    name, agents, n = EVAL_LIFELONG
    lspecs = [EpisodeSpec(name, agents, s, max_episode_steps=EVAL_LIFELONG_STEPS,
                          on_target="restart", num_queued_goals=EVAL_K)
              for s in range(seed, seed + n)]
    lrows = {}
    for lazy in (True, False):
        lev = Evaluator(reg, model, batch_envs=EVAL_BATCH, do_sample=False, lazy_lifelong=lazy,
                        device=dev)
        fused_gpt.launches = 0
        lrows[lazy] = lev.run(lspecs).rows
        torch.cuda.synchronize()
        if fused_gpt.launches != EVAL_LIFELONG_STEPS:
            raise RuntimeError(f"evaluator lifelong: {fused_gpt.launches} e2e launches, "
                               f"expected {EVAL_LIFELONG_STEPS}")
        check_rows(f"lifelong lazy={lazy}", lrows[lazy], EVAL_LIFELONG_STEPS, lifelong=True)
        for r in lrows[lazy]:
            log(f"[evaluator]   lifelong lazy={lazy} {r['map_name']} A={r['num_agents']} K="
                f"{EVAL_K} seed {r['seed']}: avg_throughput {r['avg_throughput']:.6f} ISR "
                f"{r['ISR']:.4f} runtime {r['runtime']:.4f} s")
    strip = [[{k: v for k, v in r.items() if k != "runtime"} for r in lrows[lazy]]
             for lazy in (True, False)]
    if strip[0] != strip[1]:
        raise RuntimeError("evaluator lifelong: the lazy rows differ from the dense rows")
    throughput = float(np.mean([r["avg_throughput"] for r in lrows[True]]))
    if not throughput > 0:
        raise RuntimeError("evaluator lifelong: avg_throughput is 0")
    log(f"[evaluator] lifelong: lazy rows equal dense rows (runtime aside); mean avg_throughput "
        f"{throughput:.6f}; runtime a episode lazy "
        f"{np.mean([r['runtime'] for r in lrows[True]]):.4f} s, dense "
        f"{np.mean([r['runtime'] for r in lrows[False]]):.4f} s")
    out["lifelong"] = {"episodes": len(lspecs), "K": EVAL_K, "avg_throughput": throughput,
                       "runtime_s_per_episode_lazy": float(np.mean([r["runtime"]
                                                                    for r in lrows[True]])),
                       "runtime_s_per_episode_dense": float(np.mean([r["runtime"]
                                                                     for r in lrows[False]]))}

    # the lazy lifelong step split: tokenizer, forward, act, env step (the
    # relaxation inside it), then relax_fixpoint alone on the step's fields
    # (one verification round) beside its row-loop plain version
    lev = Evaluator(reg, model, batch_envs=EVAL_BATCH, do_sample=False, device=dev)
    key = lev._group_key(lspecs[0])
    spec, _ = lev._runner(key, key[2])
    built = [lev._build_instance(s, key[:2], key[2]) for s in lspecs]
    states = batch_reset(spec, *(np.stack([b[i] for b in built]) for i in range(4)), device=dev)
    forward = make_forward(model)
    for _ in range(8):              # into the episode, so that queues have advanced
        b, a = states.pos.shape[:2]
        states = menv.step(spec, states, act(forward(_tokens_of(states).reshape(b * a, -1)),
                                             do_sample=False).reshape(b, a))
    split = step_split(model, states, spec, reps=4)
    h, w = states.grid.shape[-2:]
    fields = states.c2g[:, :, 0].reshape(-1, h, w)
    seed_d = torch.where(fields < 0, INF, fields)
    free = (~states.grid)[:, None].expand(*states.pos.shape[:2], h, w).reshape(-1, h, w)
    if not torch.equal(relax_fixpoint(seed_d, free), relax_fixpoint_rows(seed_d, free)):
        raise RuntimeError("relax_fixpoint differs from the row loop on the lifelong fields")
    relax_ms = cuda_ms(lambda: relax_fixpoint(seed_d, free), reps=5)
    rows_ms = cuda_ms(lambda: relax_fixpoint_rows(seed_d, free), reps=2)
    log(f"[timing] lifelong lazy step, {len(lspecs)} envs x {agents} agents on the {h} x {w} "
        f"warehouse tier: tokens {split['tokens']:.3f} ms, forward {split['forward']:.3f} ms, "
        f"act {split['act']:.3f} ms, env step {split['env_step']:.3f} ms (its relaxation "
        f"inside); relax_fixpoint alone {relax_ms:.3f} ms (one round), its row-loop plain "
        f"version relax_fixpoint_rows {rows_ms:.3f} ms")
    out["lifelong_step_ms"] = {**split, "relax_fixpoint": relax_ms, "relax_row_loop": rows_ms,
                               "fields": int(seed_d.shape[0]), "grid": [int(h), int(w)]}

    # the bench workload's step split: 256 envs x 32 agents on 21 x 21 random maps
    insts = [sample_instance(random_grid(MAP_SIZE, DENSITY, s), A, seed=s) for s in range(256)]
    bspec = menv.MapfEnvSpec(height=insts[0].grid.shape[0], width=insts[0].grid.shape[1],
                             num_agents=A, max_episode_steps=SPLIT_STEPS + 1)
    bstates = batch_reset(bspec, np.stack([i.grid for i in insts]),
                          np.stack([i.starts for i in insts]), np.stack([i.goals for i in insts]),
                          np.ones((256, A), bool), device=dev)
    step_split(model, bstates, bspec, reps=1)   # warm
    bsplit = step_split(model, bstates, bspec, reps=SPLIT_STEPS)
    log(f"[timing] bench step split, 256 envs x {A} agents: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in bsplit.items()) + f"; {sum(bsplit.values()):.3f} ms a step")
    out["bench_step_ms"] = bsplit

    # one recorded rollout with an input mask
    inst = sample_instance(random_grid(MAP_SIZE, DENSITY, seed), A, seed=seed)
    rspec = menv.MapfEnvSpec(height=inst.grid.shape[0], width=inst.grid.shape[1], num_agents=A,
                             max_episode_steps=STEPS_85M)
    rstate = batch_reset(rspec, inst.grid[None], inst.starts[None], inst.goals[None],
                         np.ones((1, A), bool), device=dev)
    fused_gpt.launches = 0
    final, met, positions = make_recorded_rollout(
        rspec, model, do_sample=False, mask_cfg=MaskConfig(mask_greed_action=True))(rstate)
    torch.cuda.synchronize()
    if fused_gpt.launches != STEPS_85M or positions.shape != (STEPS_85M + 1, A, 2):
        raise RuntimeError(f"recorded rollout: {fused_gpt.launches} e2e launches, positions "
                           f"{tuple(positions.shape)}")
    check_rollout(final, met, STEPS_85M)
    if not torch.equal(positions[-1], final.pos[0]):
        raise RuntimeError("recorded rollout: the trajectory does not end at the final state")
    log(f"[evaluator] recorded rollout, mask_greed_action: {STEPS_85M} steps, ISR "
        f"{met.isr.item():.4f}, e2e launches {fused_gpt.launches}")
    out["seconds"] = time.perf_counter() - t0
    log(f"[done] evaluator phase {out['seconds']:.1f} s")
    return out


def check_paths(grid: np.ndarray, starts: np.ndarray, goals: np.ndarray,
                paths: np.ndarray) -> None:
    """A joint solution is feasible: it starts at the starts and ends at the
    goals, every move is to a neighbour or a wait, on free cells, with no
    two agents on one cell and no two swapping."""
    if paths is None:
        raise RuntimeError("solver: no solution")
    if not (np.array_equal(paths[0], starts) and np.array_equal(paths[-1], goals)):
        raise RuntimeError("solver: the paths do not run from the starts to the goals")
    if (np.abs(np.diff(paths, axis=0)).sum(-1) > 1).any():
        raise RuntimeError("solver: a move is not to a neighbouring cell")
    if grid[paths[..., 0], paths[..., 1]].any():
        raise RuntimeError("solver: an agent stands on an obstacle")
    lin = paths[..., 0] * grid.shape[1] + paths[..., 1]   # [T+1, A]
    if (np.diff(np.sort(lin, axis=1), axis=1) == 0).any():
        raise RuntimeError("solver: two agents share a cell")
    prev, cur = lin[:-1], lin[1:]
    swap = (cur[:, :, None] == prev[:, None, :]) & (prev[:, :, None] == cur[:, None, :])
    swap &= cur[:, :, None] != cur[:, None, :]
    if swap.any():
        raise RuntimeError("solver: two agents swap cells")


def solver_phase(seed: int, build_s: float):
    """17. One instance at the training distribution's largest shape solved
    by the library built in phase 2 (first solution, anytime off) and its
    paths checked.  Returns (instance, paths)."""
    t0 = time.perf_counter()
    inst = sample_instance(maze_grid(21, seed), 32, seed)
    paths = expert.get_lib().solve(inst.grid, inst.starts, inst.goals, time_limit_s=10.0,
                                   seed=seed, anytime=False)
    check_paths(inst.grid, inst.starts, inst.goals, paths)
    log(f"[solver] built with g++ in {build_s:.1f} s ({_lacam_build.library_path().name}); maze 21 "
        f"x 32 agents: makespan {len(paths) - 1}, feasible, {time.perf_counter() - t0:.2f} s")
    return inst, paths


def read_shards(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Every shard under `path`: (tokens int8 [N, 256], targets int8 [N])."""
    toks, gts = zip(*(read_arrow_shard(os.path.join(path, name))
                      for name in sorted(os.listdir(path))))
    return np.concatenate(toks), np.concatenate(gts)


@contextlib.contextmanager
def generation_tracing(spent: dict, episode_waits: list):
    """The smoke's own tracing of generate_shards: while open, the solver's
    and the replay's seconds add up in `spent`, and each episode's (waits,
    samples) after balance_waits joins `episode_waits`.  The package's
    functions are wrapped, not changed, and restored on exit."""
    solve, samples, balance = (expert.solve_with_escalation, generate.episode_samples,
                               generate.balance_waits)

    def timed(key, fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spent[key] += time.perf_counter() - t0
        return run

    def balanced(toks, gts, rng, frac):
        toks, gts = balance(toks, gts, rng, frac)
        episode_waits.append((int((gts == 0).sum()), len(gts)))
        return toks, gts

    expert.solve_with_escalation = timed("solve", solve)
    generate.episode_samples = timed("replay", samples)
    generate.balance_waits = balanced
    try:
        yield
    finally:
        expert.solve_with_escalation = solve
        generate.episode_samples = samples
        generate.balance_waits = balance


def generation_phase(inst, paths, seed: int, dev, data_dir: str) -> dict:
    """18. Expert shards in the reference's training distribution, the replay
    on the card: GEN_SAMPLES train and validation samples, the solver's and
    the replay's shares of the wall time; the shards' targets, tokens and
    wait share checked; one episode's replay on the card equal to the CPU's."""
    got = generate.episode_samples(inst, paths, dev)
    want = generate.episode_samples(inst, paths, "cpu")
    if not all(np.array_equal(a, b) for a, b in zip(got, want)):
        raise RuntimeError("generation: the replay on the card differs from the CPU's")
    log(f"[generation] one episode's replay, cuda against cpu: {len(got[0])} samples, tokens and "
        f"targets equal")

    spent = {"solve": 0.0, "replay": 0.0}
    episode_waits = []   # (waits, samples) after balance_waits, per episode
    out = {}
    with generation_tracing(spent, episode_waits):
        for split, total, offset in (("train", GEN_SAMPLES[0], 10), ("valid", GEN_SAMPLES[1], 20)):
            cfg = generate.GenConfig(**GEN_CFG, seed=seed + offset, samples_per_shard=total,
                                     device=str(dev))
            spent.update(solve=0.0, replay=0.0)
            t0 = time.perf_counter()
            stats = generate.generate_shards(os.path.join(data_dir, split), total, cfg)
            wall = time.perf_counter() - t0
            out[split] = {**stats, "wall_s": wall, "samples_per_s": stats["samples"] / wall,
                          "solve_share": spent["solve"] / wall,
                          "replay_share": spent["replay"] / wall}
            log(f"[generation] {split}: {json.dumps(out[split])}")

    frac = GEN_CFG["max_wait_frac"]
    worst = max(w / n for w, n in episode_waits if n)
    if worst > frac:
        raise RuntimeError(f"generation: an episode kept a wait share {worst} > {frac}")
    for split in out:
        toks, gts = read_shards(os.path.join(data_dir, split))
        if len(gts) != out[split]["samples"] or toks.shape[1] != 256:
            raise RuntimeError(f"generation: {split} shards hold {toks.shape}, expected "
                               f"{out[split]['samples']} contexts")
        if not ((gts >= 0) & (gts <= 4)).all():
            raise RuntimeError(f"generation: {split} targets outside 0..4 (a wait marker left?)")
        if not ((toks >= 0) & (toks < VOCAB_SIZE)).all():
            raise RuntimeError(f"generation: {split} tokens outside the vocabulary")
        # the shards are a random subset of the balanced episodes' samples, so
        # their share may pass the episodes' cap by sampling noise: 3 sigma
        share = float((gts == 0).mean())
        limit = frac + 3 * math.sqrt(frac * (1 - frac) / len(gts))
        out[split]["wait_share"] = share
        log(f"[generation] {split}: {len(gts)} samples, targets in 0..4, tokens in the "
            f"vocabulary, wait share {share:.4f} (limit {limit:.4f}; every episode's at most "
            f"{frac}, the largest {worst:.4f})")
        if share > limit:
            raise RuntimeError(f"generation: {split} wait share {share} > {limit}")
    return out


def trainer_85m_phase(seed: int, dev, data_dir: str) -> dict:
    """19. The 85M trainer through train.loop.train on phase 18's shards,
    the training kernels' counters set to 0 just before and read just
    after, peak memory beside its estimate; its checkpoint drives one
    rollout step through the layer-stack kernel; then iterations at the
    reference shape (512 x 16), the first counted and the next two timed;
    last the kernels alone at 512 contexts, checked against their plain
    versions and timed."""
    cfg = CONFIGS["85M"]
    out_dir = os.path.join(data_dir, "out_85m")
    iters, batch, accum = TRAIN_85M
    args = train_loop.parse_args([
        "--model", "85M", "--device", str(dev), "--train-data", os.path.join(data_dir, "train"),
        "--valid-data", os.path.join(data_dir, "valid"), "--out-dir", out_dir,
        "--batch-size", str(batch), "--grad-accum", str(accum), "--max-iters", str(iters),
        "--eval-interval", "3", "--eval-iters", "2", "--log-interval", "1", "--seed", str(seed)])
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    fgt.fwd_launches = fgt.bwd_launches = 0
    fgt.reset_bwd_gemm_launches()
    t0 = time.perf_counter()
    result = train_loop.train(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    launches = (fgt.fwd_launches, fgt.bwd_launches)
    check_bwd_gemm_launches("trainer 85M", fgt.bwd_gemm_launches(), cfg, iters * accum, batch)
    micro = iters * accum
    bwd_per_micro = -(-cfg.n_layer // fgt._bwd_layers_per_call(cfg))
    log(f"[trainer 85M] {iters} iterations x {accum} micro-batches of {batch}: {wall:.2f} s, "
        f"launches forward {launches[0]} backward {launches[1]} ({bwd_per_micro} a micro-batch); "
        f"peak memory {peak} bytes against the estimate {MEM_85M_ESTIMATE} bytes")
    if launches != (micro, micro * bwd_per_micro):
        raise RuntimeError(f"trainer 85M: training kernel launches {launches}, expected "
                           f"{(micro, micro * bwd_per_micro)}")
    losses = [h["loss"] for h in result["history"]]
    evals = [(e["val_loss"], e["val_acc"]) for e in result["evals"]]
    log(f"[trainer 85M] losses {losses}; evals (val_loss, val_acc) {evals}")
    if not all(np.isfinite(v) for v in losses + [x for e in evals for x in e]):
        raise RuntimeError("trainer 85M: a loss is not finite")
    if not losses[-1] < losses[0] - LOSS_DROP_85M:
        raise RuntimeError(f"trainer 85M: last loss {losses[-1]:.4f} is not {LOSS_DROP_85M} "
                           f"below the first {losses[0]:.4f}")
    step = ckpt.latest_step(out_dir)
    ckpt_cfg, sd = load_reference_checkpoint(ckpt.checkpoint_path(out_dir, step))
    spec, states, _ = reset_batch(seed, B_85M, 1, dev)
    rollout(f"85M trained here (iter {step})", spec, load_model(ckpt_cfg, sd, device=dev), states,
            B_85M, 1, e2e=0, blocks=1)
    del result, sd
    torch.cuda.empty_cache()

    # one iteration at the reference shape, on the generated samples
    toks, gts = read_shards(os.path.join(data_dir, "train"))
    pick = np.random.RandomState(seed).randint(0, len(gts), size=REF_ACCUM_85M * batch)
    x = torch.from_numpy(toks[pick].astype(np.int32)).to(dev).reshape(REF_ACCUM_85M, batch, -1)
    y = torch.from_numpy(gts[pick].astype(np.int64)).to(dev).reshape(REF_ACCUM_85M, batch)
    model = GPT(cfg)
    model.load_state_dict(init_params(cfg, torch.Generator().manual_seed(seed)))
    model.to(dev).train()
    step_fn = make_train_step(model, TrainConfig(grad_accum=REF_ACCUM_85M))
    # a first iteration, untimed (it allocates the AdamW moments), with the
    # training kernels' counters set to 0 just before and read just after
    torch.cuda.synchronize()
    fgt.fwd_launches = fgt.bwd_launches = 0
    fgt.reset_wgmma_launches()
    fgt.reset_bwd_gemm_launches()
    losses_ref = [step_fn(x, y).item()]
    torch.cuda.synchronize()
    ref_launches = (fgt.fwd_launches, fgt.bwd_launches)
    ref_att_launches = fgt.wgmma_launches()
    ref_epi_launches = fgt.bwd_gemm_launches()
    check_wgmma_launches("trainer 85M, reference iteration", ref_att_launches, cfg,
                         REF_ACCUM_85M, batch)
    check_bwd_gemm_launches("trainer 85M, reference iteration", ref_epi_launches, cfg,
                            REF_ACCUM_85M, batch)
    if ref_launches != (REF_ACCUM_85M, REF_ACCUM_85M * bwd_per_micro):
        raise RuntimeError(f"trainer 85M: {ref_launches} training kernel launches in an iteration "
                           f"at {batch} x {REF_ACCUM_85M}, expected "
                           f"{(REF_ACCUM_85M, REF_ACCUM_85M * bwd_per_micro)}")
    iter_times = []
    for _ in range(2):
        t0 = time.perf_counter()
        losses_ref.append(step_fn(x, y).item())
        iter_times.append(time.perf_counter() - t0)
    iter_s = statistics.median(iter_times)
    flops = (profiling.transformer_flops_per_token(
        model.num_params(), cfg.n_layer, cfg.n_head, cfg.n_embd // cfg.n_head, cfg.block_size)
        * cfg.block_size * batch * REF_ACCUM_85M)
    mfu = flops / iter_s / PEAK_BF16
    log(f"[trainer 85M] iterations at the reference shape {batch} x {REF_ACCUM_85M}: launches "
        f"forward {ref_launches[0]} backward {ref_launches[1]} in the first (untimed); then "
        f"{iter_times[0]:.3f} and {iter_times[1]:.3f} s, median {iter_s:.3f} s ({1 / iter_s:.4f} "
        f"it/s, {batch * REF_ACCUM_85M / iter_s:.1f} contexts/s), MFU {100 * mfu:.3f} % of "
        f"{PEAK_BF16:.3g} FLOP/s; losses {losses_ref}")
    if not all(math.isfinite(v) for v in losses_ref):
        raise RuntimeError("trainer 85M: a reference-shape loss is not finite")

    # the kernels alone at the micro-batch the trainer gives them (one
    # forward, the 12 backward chunks), against their plain versions, then
    # timed beside them
    stacks, chunks, forward, backward, plain_forward, plain_backward, (xe, out, xsave, dxin) = \
        stack_runs(model, x[0], seed)
    torch.cuda.synchronize()
    fwd_err = 0.0
    for c0 in range(0, batch, TRAIN_PLAIN_CHUNK):
        c1 = min(c0 + TRAIN_PLAIN_CHUNK, batch)
        ref_out, ref_xsave = fgt.train_fwd_reference(xe[c0:c1], stacks, True)
        fwd_err = max(fwd_err,
                      check_close_channels(f"85M train forward N={batch}, contexts {c0}-{c1 - 1}, "
                                           f"out", out[c0:c1], ref_out, 0),
                      check_close_channels(f"85M train forward N={batch}, contexts {c0}-{c1 - 1}, "
                                           f"xsave", xsave[:, c0:c1], ref_xsave, 1))
        del ref_out, ref_xsave
    bwd_err, dx = 0.0, dxin
    for lo, hi in chunks:
        err, dx = compare_backward(f"85M train backward N={batch} layer {lo}",
                                   xsave[2 * lo:2 * hi], dx, stacks.chunk(lo, hi),
                                   chunk=TRAIN_PLAIN_CHUNK)
        bwd_err = max(bwd_err, err)
    del xe, out, dxin, dx
    fwd_ms = cuda_ms(forward, reps=2)
    bwd_ms = cuda_ms(backward, reps=2)
    plain_fwd_ms = cuda_ms(plain_forward, reps=1)
    plain_bwd_ms = cuda_ms(plain_backward, reps=1)
    (fwd_bound, fwd_by), (bwd_bound, bwd_by) = train_bounds(batch, cfg.block_size, cfg.n_head,
                                                            stacks, len(chunks))
    log(f"[timing] 85M train N={batch}: forward kernel {fwd_ms:.3f} ms (plain {plain_fwd_ms:.3f} "
        f"ms, bound {fwd_bound:.3f} ms {fwd_by}, {100 * fwd_bound / fwd_ms:.2f} % of bound); "
        f"backward kernels {bwd_ms:.3f} ms in {len(chunks)} calls (plain {plain_bwd_ms:.3f} ms, "
        f"bound {bwd_bound:.3f} ms {bwd_by}, {100 * bwd_bound / bwd_ms:.2f} % of bound)")
    return {"launches": launches, "losses": losses, "evals": evals, "wall_s": wall,
            "peak_memory_bytes": peak, "memory_estimate_bytes": MEM_85M_ESTIMATE,
            "ref_iteration_s": iter_times, "ref_it_per_s": 1 / iter_s, "ref_mfu": mfu,
            "ref_wgmma_launches": ref_att_launches, "ref_bwd_gemm_launches": ref_epi_launches,
            "fwd": {"n_contexts": batch, "ms": fwd_ms, "plain_ms": plain_fwd_ms,
                    "bound_ms": fwd_bound, "bound_by": fwd_by, "max_abs_err": fwd_err,
                    "launches_per_iteration": launches[0] // iters,
                    "launches_per_reference_iteration": ref_launches[0]},
            "bwd": {"n_contexts": batch, "ms": bwd_ms, "plain_ms": plain_bwd_ms,
                    "bound_ms": bwd_bound, "bound_by": bwd_by, "max_abs_err": bwd_err,
                    "launches_per_iteration": launches[1] // iters,
                    "launches_per_reference_iteration": ref_launches[1]}}


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def distributed_phase(seed: int, dev, data_dir: str) -> dict:
    """20. ``--distributed`` at world size 1 over NCCL: DIST_ITERS 6M
    iterations on phase 18's shards, whose losses must equal a run without
    it from the same seed; the training kernels' counters one forward a
    micro-batch in each."""
    runs = {}
    for name in ("single", "distributed"):
        argv = ["--model", "6M", "--device", dev.type, "--train-data",
                os.path.join(data_dir, "train"), "--out-dir", os.path.join(data_dir, name),
                "--batch-size", "256", "--grad-accum", "1", "--max-iters", str(DIST_ITERS),
                "--eval-interval", "1000", "--log-interval", "1", "--seed", str(seed)]
        coords = {}
        if name == "distributed":
            argv.append("--distributed")
            coords = {"MAPF_GPT_TPU_COORDINATOR": f"localhost:{free_port()}",
                      "MAPF_GPT_TPU_NUM_PROCESSES": "1", "MAPF_GPT_TPU_PROCESS_ID": "0"}
        os.environ.update(coords)
        fgt.fwd_launches = 0
        try:
            result = train_loop.train(train_loop.parse_args(argv))
        finally:
            for key in coords:
                os.environ.pop(key)
        runs[name] = ([h["loss"] for h in result["history"]], fgt.fwd_launches)
    backend = "NCCL" if dev.type == "cuda" else "gloo"
    log(f"[distributed] world size 1 over {backend}: losses {runs['distributed'][0]} against "
        f"{runs['single'][0]} without --distributed; forward launches {runs['distributed'][1]}")
    if runs["distributed"] != runs["single"] or runs["single"][1] != DIST_ITERS:
        raise RuntimeError(f"distributed: {runs['distributed']} differs from {runs['single']}")
    return {"losses": runs["distributed"][0], "equal": True}


def check_steps(name: str, got: torch.Tensor, ref: torch.Tensor, steps: float = 1.0,
                floor: float = 1e-3, extra=None, chunk: int = 1 << 15) -> float:
    """got vs its plain version ref (same shape, rows first), elementwise:
    within `steps` bf16 steps of ref (2^-7 |ref| each), plus extra(rows) where
    given (an allowance for a rounding inside the op, for those rows), plus
    `floor` times the rms of ref, a share of a typical value.  Row chunks
    bound the memory.  Returns the worst |err| / tol."""
    if got.shape != ref.shape:
        raise RuntimeError(f"{name}: kernel output {tuple(got.shape)} not of shape "
                           f"{tuple(ref.shape)}")
    g2, r2 = got.reshape(got.shape[0], -1), ref.reshape(ref.shape[0], -1)
    rms = math.sqrt(sum(r.float().square().sum().item() for r in r2.split(chunk)) / ref.numel())
    worst = err = 0.0
    for i in range(0, g2.shape[0], chunk):
        rows = slice(i, i + chunk)
        g, r = g2[rows].float(), r2[rows].float()
        if not torch.isfinite(g).all():
            raise RuntimeError(f"{name}: kernel output not finite")
        diff = (g - r).abs()
        tol = steps * 2.0 ** -7 * r.abs() + floor * rms
        if extra is not None:
            tol += extra(rows).reshape(tol.shape)
        worst = max(worst, (diff / tol).max().item())
        err = max(err, diff.max().item())
    log(f"[moe] {name}: n={got.shape[0]} max|err|={err:.6f} worst err/tol={worst:.4f} "
        f"(rms|ref|={rms:.4f}; {steps:g} bf16 steps + {floor:g} rms)")
    if worst > 1.0:
        raise RuntimeError(f"{name}: kernel disagrees with the plain version")
    return worst


def swiglu_allowance(gu: torch.Tensor):
    """extra(rows) of a SwiGLU epilogue, bf16(silu(bf16 g) bf16 u), from the
    plain product gu (bf16 [rows, 2f], columns in blocks of 8 gate then 8
    up): one bf16 step of g carried through silu and one of u,
    2^-7 (|silu'(g) g| + |silu(g)|) |u|."""
    def extra(rows):
        x = gu[rows].float()
        m = x.shape[0]
        x = x.view(m, -1, 2, 8)
        g, u = x[:, :, 0].reshape(m, -1), x[:, :, 1].reshape(m, -1)
        sg = torch.sigmoid(g)
        return 2.0 ** -7 * ((sg * (1 + g * (1 - sg)) * g).abs() + (sg * g).abs()) * u.abs()
    return extra


def resid_allowance(y: torch.Tensor):
    """extra(rows) of bf16(r + bf16(a W)): one bf16 step of the plain product y."""
    return lambda rows: 2.0 ** -7 * y[rows].float().abs()


def both(op: str, *args):
    """ops/moe's `op` on the kernels, then its plain version, on the same inputs."""
    return getattr(moe, op)(*args), getattr(moe, op + "_plain")(*args)


def router_z(logits3: torch.Tensor, x: int) -> torch.Tensor:
    """The router's fp32 logits from its three terms, summed as the kernel sums them."""
    return (logits3[:, 2 * x:] + logits3[:, x:2 * x]) + logits3[:, :x]


def check_route(got, want, b: torch.Tensor, z: torch.Tensor, z_gap: float, bias: torch.Tensor,
                counter: torch.Tensor, scratch: torch.Tensor, cfg) -> dict:
    """The router's kernels (topk, route_offsets, scatter) against the plain
    route on the same rows, with eps = 2 z_gap + 1e-6 (z_gap the logits'
    largest gap to the plain ones, which can swap two scores that close):
    each row's chosen set equal to the plain one's but where the plain k-th
    and (k+1)-th biased scores lie within eps; the choices in descending
    order of the plain biased score, within eps; no row choosing an expert
    twice or one outside [0, X); the weights within 1e-5, expert by expert,
    where the sets are equal.  And the kernels against their own choices,
    exactly: the device counter and the segment table from the choices'
    counts (the table equal to the plain one's when no set differs), every
    pair's slot distinct and inside its expert's segment, the experts' input
    row at each slot the token's row, the scratch's counts zero again."""
    a, table, slot, w, idx = got
    _, ptable, _, pw, pidx = want
    x, k = cfg.n_routed_experts, cfg.num_experts_per_tok
    idx, pidx = idx.long(), pidx.long()
    if ((idx < 0) | (idx >= x)).any() or (idx.sort(-1).values.diff(dim=-1) == 0).any():
        raise RuntimeError("route: a row chooses an expert outside [0, X) or one twice")
    eps = 2 * z_gap + 1e-6
    biased = torch.sigmoid(z) + bias
    mine, plain_ = idx.sort(-1), pidx.sort(-1)
    differ = (mine.values != plain_.values).any(-1)
    out = {"rows": int(idx.shape[0]), "sets_differ": int(differ.sum()),
           "order_differs": int(((idx != pidx).any(-1) & ~differ).sum()), "tie_eps": eps}
    sel = biased.gather(1, idx)
    out["largest_rise_in_order"] = (sel[:, 1:] - sel[:, :-1]).max().item()
    if out["largest_rise_in_order"] > eps:
        raise RuntimeError(f"route: choices not in descending order of score: {out}")
    if out["sets_differ"]:
        ranked = biased.sort(-1, descending=True).values
        margin = (ranked[:, k - 1] - ranked[:, k])[differ]
        out["largest_margin_of_a_differing_set"] = margin.max().item()
        if margin.max().item() > eps:
            raise RuntimeError(f"route: chosen sets differ from the plain version's on a row "
                               f"that is no near-tie: {out}")
    ws, pws = w.gather(1, mine.indices), pw.gather(1, plain_.indices)
    out["w_err"] = (ws[~differ] - pws[~differ]).abs().max().item()
    if out["w_err"] > 1e-5:
        raise RuntimeError(f"route: weights off the plain version's by {out['w_err']}")
    counts = torch.bincount(idx.flatten(), minlength=x)
    tiles = (counts + moe.BM - 1) // moe.BM
    tile_start = torch.cat([tiles.new_zeros(1), tiles.cumsum(0)])
    own_table = torch.cat([tile_start, tile_start[:-1] * moe.BM]).int()
    if not torch.equal(counter, counts) or not torch.equal(table, own_table):
        raise RuntimeError("route: the device counter or the segment table is not the "
                           "choices' counts")
    if not out["sets_differ"] and not torch.equal(table, ptable):
        raise RuntimeError("route: the segment table differs from the plain version's")
    sl = slot.long()
    row0 = own_table[x + 1:].long()
    inside = (sl >= row0[idx]) & (sl < row0[idx] + counts[idx])
    if not inside.all() or (sl.flatten().sort().values.diff() == 0).any():
        raise RuntimeError("route: a pair's slot lies outside its expert's segment or is shared")
    if not torch.equal(a[sl.flatten()], b.repeat_interleave(k, dim=0)):
        raise RuntimeError("route: the experts' input rows are not the tokens' rows")
    if (scratch[:x] != 0).any():
        raise RuntimeError("route: the scratch's counts are not zero after the route")
    out["load_max_over_mean"] = (counts.max() / counts.float().mean()).item()
    log(f"[moe] route: {json.dumps(out)}")
    return out


def moe_attention(h: torch.Tensor, lay, cfg, n: int, rope_cs) -> tuple[torch.Tensor, dict]:
    """One MLA block at every position, each op against its plain version on
    the inputs the kernels before it gave.  Returns (h after the block, the
    worst err / tol by op)."""
    hh, d, dn, dv, r = (cfg.n_head, cfg.head_dim, cfg.qk_nope_head_dim, cfg.v_head_dim,
                        cfg.kv_lora_rank)
    t, eps = cfg.block_size, cfg.rms_norm_eps
    worst = {}
    a, want = both("rms_norm", h, lay["ln1"], eps)
    worst["rms_norm"] = check_steps("rms_norm (attention)", a, want)
    kva, want = both("linear", a, lay["wkva"])
    worst["linear"] = check_steps(f"linear {tuple(a.shape)} x {tuple(lay['wkva'].shape)}",
                                  kva, want)
    c, want = both("rms_norm", kva[:, :r], lay["kv_ln"], eps)
    worst["rms_norm_latent"] = check_steps("rms_norm (the latent, a strided view)", c, want)
    kv, want = both("linear", c, lay["wkvb"])
    check_steps(f"linear {tuple(c.shape)} x {tuple(lay['wkvb'].shape)}", kv, want)
    q, want = both("linear", a, lay["wq"])
    check_steps(f"linear {tuple(a.shape)} x {tuple(lay['wq'].shape)}", q, want)
    qp, kvp = q.clone(), kv.clone()
    moe.rope(q, kva, kv, *rope_cs, hh, d, dn, r, t)
    moe.rope_plain(qp, kva, kvp, *rope_cs, hh, d, dn, r, t)
    worst["rope"] = max(check_steps("rope q", q, qp), check_steps("rope k (into k|v)", kv, kvp))
    del qp, kvp
    kvh = kv.view(n, t, hh, 2 * d)
    qkv = (q.view(n, t, hh, d).transpose(1, 2), kvh[..., :d].transpose(1, 2),
           kvh[..., d:].transpose(1, 2))
    scale = 1.0 / math.sqrt(d)
    tatt.launches = 0
    o = tatt.attention_pallas(*qkv, scale)
    if tatt.launches != 1:
        raise RuntimeError(f"attention D={d}: {tatt.launches} launches, expected 1")
    worst["attention"] = check_steps(
        f"attention [{n}, {hh}, {t}, {d}] bf16 ({attention_route(t, d, torch.bfloat16)}), "
        "strided views of q and k|v, v zero-padded", o, tatt.attention_einsum(*qkv, scale),
        floor=0.02)
    o3 = o.transpose(1, 2).reshape(n * t, hh, d)
    oc, want = both("compact", o3, dv)
    if not torch.equal(oc, want):
        raise RuntimeError("compact: differs from its plain version")
    del o, o3, q, kv, kvh, qkv
    y = moe.linear_plain(oc, lay["wo"])
    h2, want = moe.linear(oc, lay["wo"], h.clone()), moe.linear_plain(oc, lay["wo"], h.clone())
    worst["linear_resid"] = check_steps("linear + residual (the output projection)", h2, want,
                                        extra=resid_allowance(y))
    return h2, worst


def moe_ops_phase(seed: int, dev) -> dict:
    """23. The Moonlight policy's ops (ops/moe.py) and its attention at D =
    192 on the card against their plain versions (the ``_plain`` functions) at the
    Moonlight cell's shapes: 512 contexts x 256 positions, hidden 2048, 64
    experts of 1408, top 6.  Weights of a 2-layer policy from init_params
    under --seed (the dense layer and one MoE layer, its correction bias
    drawn nonzero); each op is fed what the kernels before it gave, in the
    forward's order: the dense layer whole, the MoE layer's MLP, then its
    attention as the thinned last layer runs it."""
    cfg = dataclasses.replace(ml.CONFIGS["Moonlight-16B-A3B"], n_layer=2)
    gen = torch.Generator(device=dev).manual_seed(seed)
    sd = ml.init_params(cfg, gen)
    x, k = cfg.n_routed_experts, cfg.num_experts_per_tok
    hh, d, dn, dv, r = (cfg.n_head, cfg.head_dim, cfg.qk_nope_head_dim, cfg.v_head_dim,
                        cfg.kv_lora_rank)
    bias = torch.randn(x, generator=gen, device=dev) * 0.01
    sd["model.layers.1.mlp.gate.e_score_correction_bias"] = bias
    model = ml.load_state(cfg, sd, device=dev)
    n, t, eps = MOON_ENVS * A, cfg.block_size, cfg.rms_norm_eps
    rope_cs = (model.rope_cos, model.rope_sin)
    tokens = torch.randint(0, cfg.vocab_size, (n, t), generator=gen, device=dev)
    h = model.embed[tokens.reshape(-1)]
    log(f"[moe] ops at {n} contexts x {t}: {n * t} rows, {x} experts of "
        f"{cfg.moe_intermediate_size}, top {k}")
    # the dense layer
    lay = model.layers[0]
    h, worst = moe_attention(h, lay, cfg, n, rope_cs)
    b, want = both("rms_norm", h, lay["ln2"], eps)
    check_steps("rms_norm (MLP)", b, want)
    gu = moe.linear_plain(b, lay["wgu"])
    hm, want = both("swiglu", b, lay["wgu"])
    worst["swiglu_dense"] = check_steps(f"swiglu dense {tuple(b.shape)} x "
                                        f"{tuple(lay['wgu'].shape)}", hm, want,
                                        extra=swiglu_allowance(gu))
    del gu
    y = moe.linear_plain(hm, lay["wd"])
    h2, want = moe.linear(hm, lay["wd"], h.clone()), moe.linear_plain(hm, lay["wd"], h.clone())
    check_steps(f"linear + residual {tuple(hm.shape)} x {tuple(lay['wd'].shape)}", h2, want,
                extra=resid_allowance(y))
    h = h2
    del hm, y, want, h2
    # the MoE layer's MLP
    lay = model.layers[1]
    b, want = both("rms_norm", h, lay["ln2"], eps)
    check_steps("rms_norm (MoE)", b, want)
    l3, want = both("router_logits", b, lay["wr3"])
    worst["router_logits"] = max(check_steps(f"router logits, term {j}", l3[:, j * x:(j + 1) * x],
                                             want[:, j * x:(j + 1) * x], steps=0, floor=1e-4)
                                 for j in range(3))
    z = router_z(want, x)
    z_gap = (router_z(l3, x) - z).abs().max().item()
    del l3, want
    scratch = torch.zeros(2 * x, dtype=torch.int32, device=dev)
    counter = torch.zeros(x, dtype=torch.int64, device=dev)
    got = moe.route(b, lay["wr3"], lay["bias"], k, cfg.routed_scaling_factor, scratch, counter)
    want = moe.route_plain(b, lay["wr3"], lay["bias"], k, cfg.routed_scaling_factor)
    route = check_route(got, want, b, z, z_gap, lay["bias"], counter, scratch, cfg)
    del want, z
    a, table, slot, w, _ = got
    used = torch.zeros(a.shape[0], dtype=torch.bool, device=dev)
    used[slot.long().flatten()] = True
    a[~used] = 0                                  # the segments' padding rows: read, not used
    end = int(table[x]) * moe.BM                  # rows past the last segment: never written
    gu = moe.grouped_plain(a, lay["wgu"], table, x)
    hm, want = both("swiglu", a, lay["wgu"], table, x)
    worst["swiglu_experts"] = check_steps(
        f"swiglu grouped {tuple(a.shape)} x {x} x {tuple(lay['wgu'].shape[1:])}, the "
        f"segments' {end} rows", hm[:end], want[:end], extra=swiglu_allowance(gu[:end]))
    del gu, want, a
    y, want = both("grouped", hm, lay["wd"], table, x)
    worst["grouped"] = check_steps(f"grouped {tuple(hm.shape)} x {x} x "
                                   f"{tuple(lay['wd'].shape[1:])}, the segments' rows",
                                   y[:end], want[:end])
    del hm, want
    gu = moe.linear_plain(b, lay["wsgu"])
    hs, want = both("swiglu", b, lay["wsgu"])
    check_steps(f"swiglu shared {tuple(b.shape)} x {tuple(lay['wsgu'].shape)}", hs, want,
                extra=swiglu_allowance(gu))
    del gu
    ys, want = both("linear", hs, lay["wsd"])
    check_steps(f"linear {tuple(hs.shape)} x {tuple(lay['wsd'].shape)}", ys, want)
    h2, want = moe.combine(h.clone(), ys, y, slot, w), moe.combine_plain(h.clone(), ys, y, slot, w)
    worst["combine"] = check_steps("combine", h2, want)
    h = h2
    del y, ys, hs, want, got, b
    # the MoE layer's attention as the thinned last layer runs it
    a = moe.rms_norm(h, lay["ln1"], eps)
    kva = moe.linear(a, lay["wkva"])
    kv = moe.linear(moe.rms_norm(kva[:, :r], lay["kv_ln"], eps), lay["wkvb"])
    kvp = kv.clone()
    moe.rope(None, kva, kv, *rope_cs, hh, d, dn, r, t)
    moe.rope_plain(None, kva, kvp, *rope_cs, hh, d, dn, r, t)
    check_steps("rope k alone (thinned layer)", kv, kvp)
    del kvp
    ql, want = both("linear", a.view(n, t, -1)[:, -1], lay["wq"])
    check_steps("linear, the last position's rows (a strided view)", ql, want)
    qp = ql.clone()
    moe.rope(ql, None, None, *rope_cs, hh, d, dn, r, t, fixed=t - 1)
    moe.rope_plain(qp, None, None, *rope_cs, hh, d, dn, r, t, fixed=t - 1)
    check_steps("rope q at the last position", ql, qp)
    scale = 1.0 / math.sqrt(d)
    ot, want = both("thin_attention", ql, kv, hh, d, dv, t, scale)
    worst["thin_attention"] = check_steps(f"thin_attention [{n}, {hh}, {t}, {d}]", ot, want,
                                          floor=0.02)
    last = h.view(n, t, -1)[:, -1].contiguous()
    y = moe.linear_plain(ot, lay["wo"])
    h2 = moe.linear(ot, lay["wo"], last.clone())
    want = moe.linear_plain(ot, lay["wo"], last.clone())
    check_steps("linear + residual (thinned layer's output projection)", h2, want,
                extra=resid_allowance(y))
    del model, sd
    torch.cuda.empty_cache()
    return {"worst_err_over_tol": worst, "route": route}


def moonlight_launches(cfg) -> dict[str, int]:
    """Each kernel's launches in one forward of the policy, the last layer
    thinned (ops/moe's counters by op, and the attention kernel's)."""
    layers, dense = cfg.n_layer, cfg.first_k_dense_replace
    routed, full = layers - dense, layers - 1
    return {"rms_norm": 3 * layers, "linear": 4 * layers + dense + 2 * routed,
            "swiglu": dense + 2 * routed, "grouped": routed, "topk": routed,
            "offsets": routed, "scatter": routed, "combine": routed, "rope": full + 2,
            "compact": full, "thin_attention": 1, "attention": full}


def moonlight_phase(seed: int, dev) -> dict:
    """24. The Moonlight-16B-A3B policy at its published size, weights drawn
    on the card under --seed: one make_batch_rollout step over the cell's
    16 envs x 32 agents, argmax; the kernels' launch counters set to 0 just
    before it and read just after against moonlight_launches; the experts'
    device counter, every MoE layer's sum its rows x top k; the step's
    invariants.  Then the forward on the step's 512 contexts timed (CUDA
    events), its device time by kernel, its peak memory, and the host calls
    that wait for the device inside the mapf.moe.* spans: none."""
    cfg = ml.CONFIGS["Moonlight-16B-A3B"]
    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    model = ml.MoonlightPolicy(cfg, device=dev)
    embed = ml.draw_globals(cfg, gen, "embed")
    for i in range(cfg.n_layer):
        model.load_layer(i, ml.draw_layer(cfg, i, gen))
    model.load_globals(embed | ml.draw_globals(cfg, gen, "head"))
    model.eval()
    torch.cuda.synchronize()
    out = {"weights_bytes": sum(p.numel() * p.element_size() for p in model.parameters()),
           "load_s": time.perf_counter() - t0}
    spec, states, tokens = reset_batch(seed, MOON_ENVS, 1, dev)
    run = make_batch_rollout(spec, model, do_sample=False)
    torch.cuda.synchronize()
    moe.reset_kernel_launches()
    fused_gpt.launches = fused_blocks.launches = tatt.launches = 0
    t0 = time.perf_counter()
    final, met = run(states)
    torch.cuda.synchronize()
    out["step_s"] = time.perf_counter() - t0
    got = {**moe.kernel_launches(), "attention": tatt.launches}
    want = moonlight_launches(cfg)
    log(f"[moe] Moonlight rollout step, {MOON_ENVS} envs x {A} agents: {out['step_s']:.3f} s "
        f"(first call), launches {got}")
    if got != want or fused_gpt.launches or fused_blocks.launches:
        raise RuntimeError(f"Moonlight step: launches {got}, expected {want} (and no GPT "
                           "kernel)")
    check_rollout(final, met, 1)
    n, t, k = tokens.shape[0], cfg.block_size, cfg.num_experts_per_tok
    dense = cfg.first_k_dense_replace
    rows = [0] * dense + [n * t * k] * (cfg.n_layer - dense - 1) + [n * k]
    if model.expert_counts.sum(1).tolist() != rows:
        raise RuntimeError(f"Moonlight step: the experts' counter reads "
                           f"{model.expert_counts.sum(1).tolist()}, expected {rows}")
    forward = model.policy_forward()
    torch.cuda.reset_peak_memory_stats()
    out["forward_ms"] = cuda_ms(lambda: forward(tokens), 3)
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        forward(tokens)
        torch.cuda.synchronize()
    events = [ev for ev in prof.profiler.kineto_results.events()
              if ev.device_type() == torch.autograd.DeviceType.CPU]   # not the ranges' copies
    spans = [(ev.start_ns(), ev.end_ns()) for ev in events if ev.name().startswith("mapf.moe.")]
    waits = sorted({ev.name() for ev in events if ev.name() in MOON_SYNCS
                    and any(s <= ev.start_ns() <= f for s, f in spans)})
    kernels = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0) or 0
        if dev_us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA \
                and not ev.key.startswith("mapf."):
            key = profiling.kernel_key(ev.key)
            kernels[key] = kernels.get(key, 0.0) + dev_us / 1e3
    out["kernels_ms"] = dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:12])
    log(f"[moe] Moonlight forward on {n} contexts: {out['forward_ms']:.1f} ms, peak "
        f"{out['peak_memory_bytes'] / 1e9:.2f} GB, weights {out['weights_bytes'] / 1e9:.2f} GB; "
        f"{len(spans)} mapf.moe spans, host waits inside them {waits}; device ms by kernel "
        f"{json.dumps(out['kernels_ms'])}")
    if len(spans) != 2 * (cfg.n_layer - dense) or waits:
        raise RuntimeError(f"Moonlight forward: {len(spans)} mapf.moe spans, host waits "
                           f"inside them {waits}")
    out["launches_per_step"] = got
    del model, run, forward
    torch.cuda.empty_cache()
    return out



def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.stdout.reconfigure(line_buffering=True)   # the trainer's own lines in order
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False   # plain version in full fp32
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    smi = nvidia_smi_line()
    log(f"[device] {smi} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # 2. build: every source (attention.cu among them), and the widths of phase 8, one
    # nvcc each, together
    sources = sorted(p[:-3] for p in os.listdir(_build.CSRC) if p.endswith(".cu"))
    jobs = [(name, None) for name in sources]
    for e, h, layers in WIDTHS:
        kernel = fused_gpt.cuda_plan(e, h, layers)[1]
        jobs.append((kernel, fused_gpt.e2e_defines(e, h) if kernel == "fused_gpt"
                     else fused_blocks.kernel_defines(e, h)))
    jobs += [("fused_gpt", fused_gpt.e2e_defines(e, h)) for e, h, *_ in E2E_SHAPES]
    jobs += [("fused_blocks", fused_blocks.kernel_defines(e, h)) for e, h, *_ in BLOCK_SHAPES]
    jobs = list({_build.library_path(*job): job for job in jobs}.values())   # each library once
    t0 = time.perf_counter()

    def build_solver() -> float:
        _lacam_build.build()
        return time.perf_counter() - t0

    with ThreadPoolExecutor(len(jobs) + 1) as pool:
        solver_build = pool.submit(build_solver)   # g++, beside the nvcc jobs
        list(pool.map(lambda job: _build.build(*job), jobs))
        solver_s = solver_build.result()
    log(f"[build] {sources} and {len(jobs) - len(sources)} widths in "
        f"{time.perf_counter() - t0:.1f} s; the LaCAM* solver (g++) in {solver_s:.1f} s")
    for name, text in _build.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    log(f"[build] fused_gpt kernel config {fused_gpt.kernel_config()}")
    consumer_regs = re.search(r"CONSUMER_REGS = (\d+)",
                              (_build.CSRC / "fused_gpt.cu").read_text()).group(1)
    for name, text in _build.build_log.items():
        if not name.startswith("fused_gpt"):
            continue
        for e, h, regs, stores, loads in e2e_ptxas(text):
            smem = fused_gpt.kernel_config(e, h)[(e, h)]["smem_bytes"]
            log(f"[e2e regs] E={e} H={h}: {regs} registers at launch (consumers "
                f"{consumer_regs} after setmaxnreg), spill stores {stores} B, spill loads "
                f"{loads} B, shared memory {smem} B")
            if (e, h) in fused_gpt._DEFAULT_WIDTHS and stores + loads:
                raise RuntimeError(f"e2e kernel E={e} H={h}: ptxas spills {stores} + {loads} "
                                   "bytes")
    log(f"[build] fused_blocks kernel config {fused_blocks.kernel_config()}")
    # the attention tile's builds (csrc/attn_wgmma.cuh): attention.cu's, the
    # training forward's (fused_train.cu) and the 85M stack's (fused_blocks.cu); no
    # spill at head dims 32 and 64 but the stack's, whose first build spilled 80
    # bytes and which may not spill more
    lib = tatt._library()
    lib.attention_wgmma_smem.argtypes = [ctypes.c_int]
    for name in ("attention", "fused_train", "fused_blocks"):
        for d, ty, io, regs, stores, loads in tile_ptxas(_build.build_log.get(name, "")):
            log(f"[tile regs] {name} D={d} {ty} {io}: {regs} registers at launch, spill stores "
                f"{stores} B, spill loads {loads} B, shared memory "
                f"{lib.attention_wgmma_smem(int(d))} B")
            limit = 80 if io == "BlocksIo" else 0
            if d in ("32", "64") and (stores > limit or (not limit and loads)):
                raise RuntimeError(f"attention tile {name} D={d} {ty}: ptxas spills {stores} + "
                                   f"{loads} bytes")
    for name, text in _build.build_log.items():
        for line in text.splitlines():
            if "Potential Performance Loss" in line:
                log(f"[build] {name}: {line.strip()}")

    # 12. the attention kernel against its plain version, first; 2b. the layer kernels' GEMM
    att_err = attention_phase(args.seed, dev)
    gemm_rows = gemm_phase(args.seed, dev)
    # 21. the training attention's wgmma kernels alone; 22. the backward's epilogue kernels
    train_att = train_attention_phase(args.seed, dev)
    bwd_gemm = bwd_gemm_phase(args.seed, dev)

    # 3-5. the trained 2M at full width; 6. the trained 6M; 7. the 85M
    cfg, sd = load_reference_checkpoint(CKPT)
    model_2m = load_model(cfg, sd, device=dev)
    entries = [e2e_model("2M", model_2m, args.seed, dev)]
    cfg, sd = load_reference_checkpoint(CKPT_6M)
    model_6m = load_model(cfg, sd, device=dev)
    entries.append(e2e_model("6M", model_6m, args.seed, dev))
    e2e_shapes_err = e2e_shapes_phase(args.seed, dev)
    for entry in entries:
        entry["max_abs_err_other_shapes"] = e2e_shapes_err
    entries.append({**blocks_model(args.seed, dev), "gemm_yardstick": gemm_rows["85M fc"]})
    log(f"[done] inference phases {time.perf_counter() - t_start:.1f} s")

    # 8. widths built on demand; 9. training kernels; 10. the trainer; 11. timing
    widths_phase(args.seed, dev)
    fwd_err, bwd_err = train_kernels_phase({"2M": model_2m, "6M": model_6m}, args.seed, dev)
    trainer = trainer_phase(model_6m, args.seed, dev)
    entries += train_timing(model_6m.train().requires_grad_(), args.seed, dev, fwd_err, bwd_err,
                            trainer)
    entries[-1]["gemm_yardstick"] = gemm_rows["6M backward dh Wfc^T"]
    entries += train_attention_entries(train_att, trainer["wgmma_launches"])
    entries += bwd_gemm_entries(bwd_gemm, trainer["bwd_gemm_launches"])
    log(f"[done] trainer phases {time.perf_counter() - t_start:.1f} s")

    # 13. the module route with attn_impl="pallas"; 14. the bias=True rollout; 15. timing
    module_route_phase(args.seed, dev)
    att_launches, _ = bias_rollout_phase(args.seed, dev)
    att_entry, blocks_att = attention_timing(args.seed, dev, att_launches, att_err)
    entries.append(att_entry)
    for entry in entries:
        if entry["name"] == "fused_blocks":
            entry["attention"] = blocks_att

    # 16. the suite evaluator
    evaluator = evaluator_phase(model_2m, args.seed, dev)
    log(f"[done] evaluator {time.perf_counter() - t_start:.1f} s")

    # 17. the solver; 18. expert shards on the card; 19. the 85M trainer on them;
    # 20. --distributed at world size 1
    del model_2m, model_6m
    torch.cuda.empty_cache()

    # 23. the Moonlight policy's ops at its cell's shapes; 24. its rollout step
    moe_ops = moe_ops_phase(args.seed, dev)
    entries.append({"name": "moe", "model": "Moonlight-16B-A3B", "route": "cuda",
                    "source": "mapf_gpt_tpu_torch/csrc/moe.cu, csrc/grouped_gemm.cuh",
                    "n_contexts": MOON_ENVS * A, **moonlight_phase(args.seed, dev), **moe_ops})
    log(f"[done] Moonlight phases {time.perf_counter() - t_start:.1f} s")
    slice_out = {"seconds": {}}

    def timed_phase(name: str, fn):
        t0 = time.perf_counter()
        result = fn()
        slice_out["seconds"][name] = time.perf_counter() - t0
        log(f"[done] {name} phase {slice_out['seconds'][name]:.1f} s")
        return result

    with tempfile.TemporaryDirectory(prefix="chip_smoke_expert_") as data_dir:
        inst, paths = timed_phase("solver", lambda: solver_phase(args.seed, solver_s))
        slice_out["generation"] = timed_phase(
            "generation", lambda: generation_phase(inst, paths, args.seed, dev, data_dir))
        slice_out["trainer_85m"] = timed_phase(
            "trainer_85m", lambda: trainer_85m_phase(args.seed, dev, data_dir))
        slice_out["distributed"] = timed_phase(
            "distributed", lambda: distributed_phase(args.seed, dev, data_dir))
    for entry in entries:
        if entry["name"] in ("fused_train_fwd", "fused_train_bwd"):
            entry["85M"] = slice_out["trainer_85m"][entry["name"][-3:]]
    log(f"[done] {time.perf_counter() - t_start:.1f} s")

    log(f"[expert data] {json.dumps(slice_out)}")
    log(f"[evaluator] {json.dumps(evaluator)}")
    log(nvidia_smi_line())
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
