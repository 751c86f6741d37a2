"""Where the fused kernel's time goes: time it with one phase compiled out.

    python3 -m mapf_gpt_tpu_torch.tools.kernel_phases [--model 2M] [--n 8192] [--seed 0]

Builds ``csrc/fused_gpt.cu`` as it is and in variants that each leave one
phase out (QKV products, attention, projection + MLP, the thinned last
position), all with the same nvcc flags and started together, then times
each on the same tokens with the trained weights of ``--model`` (2M or
6M, the kernel's two widths).  A phase's share is
the full kernel's time minus the time without it.  The variants' logits
are wrong by construction; only their times are used.  Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy as np
import torch

from mapf_gpt_tpu_torch.models.convert import load_model, load_reference_checkpoint
from mapf_gpt_tpu_torch.ops import _build, fused_gpt

CHECKPOINTS = {
    name: os.path.normpath(os.path.join(_build.CSRC, os.pardir, os.pardir, "checkpoints", f))
    for name, f in (("2M", "MAPF-GPT-2M-r4.pt"), ("6M", "MAPF-GPT-6M-r5.pt"))}

# phase -> (text that opens it, text that closes it) in the kernel body
PHASES = {
    "qkv": ("          qkv_rows(a, Wqkv,", "qkv + r0 * E3, stage);\n"),
    "attention": ("          for (int h = 0; h < H; ++h)\n",
                  "attention_item(qkv, r0, h, xw, stage, pbuf);\n"),
    "proj_mlp": ("          proj_mlp_rows(r0,", "g2 + l * E, stage, pbuf);\n"),
    "last_position": ("          last_position(qkv,", "thin, out + (size_t)c * vocab);\n"),
}


def variant_source(src: str, phase: str) -> str:
    """The kernel source with `phase` removed by the preprocessor."""
    begin, end = PHASES[phase]
    if src.count(begin) != 1 or src.count(end) != 1 or src.index(begin) > src.index(end):
        raise RuntimeError(f"phase {phase!r} not found once in fused_gpt.cu")
    i = src.index(begin)
    j = src.index(end) + len(end)
    return src[:i] + "#if 0\n" + src[i:j] + "#endif\n" + src[j:]


def build_variants(out_dir: str) -> dict[str, str]:
    src = (_build.CSRC / "fused_gpt.cu").read_text()
    os.makedirs(out_dir, exist_ok=True)
    sources = {"full": src, **{p: variant_source(src, p) for p in PHASES}}
    nvcc = _build.find_nvcc()

    def build(item):
        name, text = item
        cu, so = os.path.join(out_dir, f"{name}.cu"), os.path.join(out_dir, f"lib{name}.so")
        with open(cu, "w") as f:
            f.write(text)
        proc = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-o", so, cu],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the {name} variant:\n{proc.stderr}")
        return name, so

    with ThreadPoolExecutor(len(sources)) as pool:
        return dict(pool.map(build, sources.items()))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", choices=sorted(CHECKPOINTS), default="2M")
    ap.add_argument("--n", type=int, default=8192, help="contexts per forward")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_phases: needs a CUDA GPU")
    libs = build_variants(str(_build.BUILD_DIR / "phases"))
    cfg, sd = load_reference_checkpoint(CHECKPOINTS[args.model])
    w = fused_gpt.stack_weights(load_model(cfg, sd, device="cuda"))
    tokens = torch.from_numpy(np.random.RandomState(args.seed).randint(
        0, cfg.vocab_size, size=(args.n, cfg.block_size))).to("cuda", torch.int32)
    times = {}
    for name, path in libs.items():
        lib = fused_gpt.bind(ctypes.CDLL(path))
        with mock.patch.object(fused_gpt, "_library", lambda *_: lib):
            fused_gpt.fused_logits(w, tokens)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(args.reps):
                fused_gpt.fused_logits(w, tokens)
            end.record()
            torch.cuda.synchronize()
        times[name] = start.elapsed_time(end) / args.reps
    full = times.pop("full")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"{smi} | {args.model} N={args.n} | full kernel {full:.3f} ms")
    for name, t in times.items():
        print(f"  {name:14s} {full - t:8.3f} ms  {100 * (full - t) / full:5.1f} %  "
              f"(kernel without it {t:.3f} ms)")
    rest = full - sum(full - t for t in times.values())
    print(f"  {'rest':14s} {rest:8.3f} ms  {100 * rest / full:5.1f} %  "
          "(embedding, LayerNorms, barriers)")


if __name__ == "__main__":
    main()
