"""The wgmma attention tile and the kernels that include it, timed from two
or more source trees in turns in one process.

    python3 -m mapf_gpt_tpu_torch.tools.attn_ab --tree parent=<dir> --tree change=<dir>
        [--runs 5] [--only attention,train,blocks,stack,e2e] [--seed 0]

Each ``--tree NAME=DIR`` names a checkout (``DIR/mapf_gpt_tpu_torch/csrc``
holds its kernel sources; the rest of the checkout is not read).  Every
tree's libraries are built with ``nvcc`` into ``csrc/build/ab/<NAME>/``, all
at once, and each is driven through this checkout's wrappers (their C
interfaces must agree), so that every tree runs on the same inputs.
Measurements, CUDA events, the mean of a few launches after a warm-up:

- ``attention``: ``attention_pallas`` (csrc/attention.cu) at both
  ``chip_smoke.ATT_TIME`` shapes, bf16 and fp16;
- ``train``: ``fused_gpt_train.train_attention`` (the training forward's
  attention with each row's statistics, csrc/fused_train.cu) at both
  ``chip_smoke.TRAIN_ATT_TIME`` shapes;
- ``blocks``: ``fused_blocks.blocks_attention`` (the 85M stack's
  attention alone) at [2048, 12, 256, 64];
- ``stack``: ``fused_blocks.fused_blocks``, the 85M's 12 layers
  (``init_params`` weights) on 2048 contexts, the last position out;
- ``e2e``: ``fused_gpt.fused_logits``, the trained 2M and 6M on 8192
  random contexts (csrc/fused_gpt.cu).

Runs alternate the trees' order (A B, B A, ...), and each run also times
one ``scaled_dot_product_attention`` call at the attention shapes as a
yardstick (no kernel of the port calls it).  Prints every run's numbers,
then each measurement's mean, least, largest and spread per tree.  Needs
a CUDA GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

import numpy as np
import torch

from mapf_gpt_tpu_torch.models.convert import load_model, load_reference_checkpoint
from mapf_gpt_tpu_torch.models.gpt import CONFIGS, init_params
from mapf_gpt_tpu_torch.ops import _build, fused_blocks, fused_gpt
from mapf_gpt_tpu_torch.ops import attention as tatt
from mapf_gpt_tpu_torch.ops import fused_gpt_train as fgt
from mapf_gpt_tpu_torch.tools.kernel_phases import CHECKPOINTS

ATT_TIME = {"2M": (8192, 5, 256, 32), "85M": (2048, 12, 256, 64)}     # chip_smoke's
TRAIN_ATT_TIME = {"6M": (2048, 8, 256, 32), "85M": (512, 12, 256, 64)}
N_E2E, N_STACK = 8192, 2048
GROUPS = ("attention", "train", "blocks", "stack", "e2e")
# group -> (module, its library's source)
LIBS = {"attention": (tatt, "attention"), "train": (fgt, "fused_train"),
        "blocks": (fused_blocks, "fused_blocks"), "stack": (fused_blocks, "fused_blocks"),
        "e2e": (fused_gpt, "fused_gpt")}


def build(tag: str, csrc: Path, name: str) -> ctypes.CDLL:
    """csrc/<name>.cu of one tree, built as ops/_build.py builds it (no
    defines: the 2M's, 6M's and 85M's widths), bound by its wrapper."""
    out_dir = _build.BUILD_DIR / "ab" / tag
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / f"lib{name}.so"
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                           str(csrc / f"{name}.cu")], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"attn_ab: nvcc failed on {csrc / name}.cu:\n{proc.stderr}")
    return ctypes.CDLL(str(so))


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def workloads(groups: set[str], seed: int, dev) -> tuple[dict, dict]:
    """(measurement -> (group, callable, reps), yardstick -> (callable, reps))
    on inputs made once from `seed`."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    runs, sdpa = {}, {}
    sdpa_fn = torch.nn.functional.scaled_dot_product_attention
    if "attention" in groups:
        for label, (b, h, t, d) in ATT_TIME.items():
            q, k, v = (torch.randn((b, h, t, d), generator=gen, device=dev).to(torch.bfloat16)
                       for _ in range(3))
            scale = 1.0 / math.sqrt(d)
            qh, kh, vh = (z.half() for z in (q, k, v))
            runs[f"attention {label} {[b, h, t, d]} bf16"] = (
                "attention", lambda q=q, k=k, v=v, s=scale: tatt.attention_pallas(q, k, v, s), 5)
            runs[f"attention {label} {[b, h, t, d]} fp16"] = (
                "attention",
                lambda q=qh, k=kh, v=vh, s=scale: tatt.attention_pallas(q, k, v, s), 5)
            sdpa[f"SDPA {[b, h, t, d]} bf16"] = (lambda q=q, k=k, v=v, s=scale: sdpa_fn(
                q, k, v, scale=s), 5)
            sdpa[f"SDPA {[b, h, t, d]} fp16"] = (lambda q=qh, k=kh, v=vh, s=scale: sdpa_fn(
                q, k, v, scale=s), 5)
    if "train" in groups:
        for label, (n, h, t, d) in TRAIN_ATT_TIME.items():
            qkv = torch.randn((n, t, 3 * h * d), generator=gen, device=dev).to(torch.bfloat16)
            runs[f"training attention {label} {[n, h, t, d]}"] = (
                "train", lambda x=qkv, h=h: fgt.train_attention(x, h), 5)
            q, k, v = (z.reshape(n, t, h, d).transpose(1, 2) for z in qkv.split(h * d, dim=-1))
            sdpa[f"SDPA forward {[n, h, t, d]} (q|k|v views)"] = (
                lambda q=q, k=k, v=v, s=1.0 / math.sqrt(d): sdpa_fn(q, k, v, scale=s), 5)
    if "blocks" in groups:
        b, h, t, d = ATT_TIME["85M"]
        qkv = torch.randn((b, t, 3 * h * d), generator=gen, device=dev)
        qkv[..., :h * d] *= math.log2(math.e) / math.sqrt(d)   # W_q's folded scale
        qkv = qkv.to(torch.bfloat16)
        runs[f"blocks attention 85M {[b, h, t, d]}"] = (
            "blocks", lambda x=qkv, h=h: fused_blocks.blocks_attention(x, h), 5)
    if "stack" in groups:
        cfg = CONFIGS["85M"]
        model = load_model(cfg, init_params(cfg, torch.Generator().manual_seed(seed)), device=dev)
        w = fused_gpt.stack_weights(model)
        tokens = torch.from_numpy(np.random.RandomState(seed).randint(
            0, cfg.vocab_size, size=(N_STACK, cfg.block_size))).to(dev)
        x = (w.wte32[tokens.long()] + w.wpe32).to(torch.bfloat16)
        stacks = w.stacks()
        runs[f"85M layer stack N={N_STACK}"] = (
            "stack", lambda: fused_blocks.fused_blocks(x, stacks, last_only=True), 3)
    if "e2e" in groups:
        for label, path in sorted(CHECKPOINTS.items()):
            cfg, sd = load_reference_checkpoint(path)
            w = fused_gpt.stack_weights(load_model(cfg, sd, device=dev))
            tokens = torch.from_numpy(np.random.RandomState(seed).randint(
                0, cfg.vocab_size, size=(N_E2E, cfg.block_size))).to(dev, torch.int32)
            runs[f"e2e {label} N={N_E2E}"] = (
                "e2e", lambda w=w, x=tokens: fused_gpt.fused_logits(w, x), 5)
    return runs, sdpa


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", action="append", required=True, metavar="NAME=DIR")
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--only", default=",".join(GROUPS))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("attn_ab: needs a CUDA GPU")
    groups = set(args.only.split(","))
    if groups - set(GROUPS):
        raise SystemExit(f"attn_ab: --only takes {','.join(GROUPS)}")
    trees = dict(t.split("=", 1) for t in args.tree)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"[attn_ab] {smi} | trees {trees}", flush=True)
    names = sorted({LIBS[g][1] for g in groups})
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(trees) * len(names)) as pool:
        jobs = {(tag, name): pool.submit(build, tag, Path(d) / "mapf_gpt_tpu_torch" / "csrc", name)
                for tag, d in trees.items() for name in names}
        libs = {key: job.result() for key, job in jobs.items()}
    print(f"[attn_ab] built {names} for {len(trees)} trees in {time.perf_counter() - t0:.1f} s",
          flush=True)
    bound = {key: next(m for m, n in LIBS.values() if n == key[1]).bind(lib)
             for key, lib in libs.items()}
    dev = torch.device("cuda", 0)
    runs, sdpa = workloads(groups, args.seed, dev)
    times = {(m, tag): [] for m in runs for tag in trees}
    yard = {m: [] for m in sdpa}
    order = list(trees)
    for r in range(args.runs):
        for tag in (order if r % 2 == 0 else order[::-1]):
            for m, (group, fn, reps) in runs.items():
                module, name = LIBS[group]
                with mock.patch.object(module, "_library", lambda *_, lib=bound[(tag, name)]: lib):
                    ms = cuda_ms(fn, reps)
                times[(m, tag)].append(ms)
                print(f"[attn_ab] run {r} {tag:10s} {m}: {ms:.4f} ms", flush=True)
        for m, (fn, reps) in sdpa.items():
            yard[m].append(cuda_ms(fn, reps))
            print(f"[attn_ab] run {r} {m}: {yard[m][-1]:.4f} ms", flush=True)
    print(f"[attn_ab] {smi}: mean / least / largest (spread) over {args.runs} runs, ms")
    for m in runs:
        for tag in trees:
            v = times[(m, tag)]
            print(f"[attn_ab] {m} {tag:10s} {np.mean(v):.4f} / {min(v):.4f} / {max(v):.4f} "
                  f"({max(v) - min(v):.4f})")
    for m, v in yard.items():
        print(f"[attn_ab] {m} {np.mean(v):.4f} / {min(v):.4f} / {max(v):.4f} "
              f"({max(v) - min(v):.4f})")


if __name__ == "__main__":
    main()
