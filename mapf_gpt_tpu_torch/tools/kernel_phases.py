"""Where the fused kernel's time goes: time it with one phase compiled out.

    python3 -m mapf_gpt_tpu_torch.tools.kernel_phases [--model 2M] [--n 8192] [--seed 0]

Builds ``csrc/fused_gpt.cu`` as it is and in variants that each leave one
phase's products and epilogues out (the LN1 + q|k|v products, attention,
the projection, the LN2 + MLP, the thinned last position: the source's
``FUSED_GPT_SKIP`` bits, ``-DFUSED_GPT_SKIP=<bit>``; the phase's weight
tiles still stream through the ring, so the producer and every barrier see
the same sequence), and one whose producer issues no TMA copies of the
weights (the products then read stale tiles: what streaming the weights
from L2 costs), all with the same nvcc flags and started together, then
times each on the same tokens with the trained weights of ``--model`` (2M
or 6M, the kernel's two default widths).  A phase's share is the full
kernel's time minus the time without it; removing a phase also changes the
registers the compiler gives the rest, so the shares need not add up.  The
variants' logits are wrong by construction; only their times are used.
Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import os
import re
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

# phase -> the name of its bit in csrc/fused_gpt.cu (constexpr int SKIP_<NAME> = <bit>)
PHASES = {"qkv": "SKIP_QKV", "attention": "SKIP_ATTENTION", "proj": "SKIP_PROJ",
          "mlp": "SKIP_MLP", "last_position": "SKIP_LAST"}
WEIGHT_LOADS = "SKIP_LOADS"


def skip_bits(src: str) -> dict[str, int]:
    """The source's SKIP_<NAME> = <bit> constants; each phase's name must be
    declared once and tested by the code at least once."""
    bits = {}
    for name in (*PHASES.values(), WEIGHT_LOADS):
        decl = re.findall(rf"\b{name} = (\d+)", src)
        if len(decl) != 1 or not re.search(rf"SKIP & {name}\b", src):
            raise RuntimeError(f"{name} is not declared once and tested in fused_gpt.cu")
        bits[name] = int(decl[0])
    if len(set(bits.values())) != len(bits) or any(b & (b - 1) for b in bits.values()):
        raise RuntimeError(f"fused_gpt.cu's skip bits are not distinct powers of 2: {bits}")
    return bits


def variant_defines(src: str) -> dict[str, dict[str, int]]:
    """name -> the -D defines of each build: the kernel as it is ("full"),
    each phase left out, and the weights' copies left out."""
    bits = skip_bits(src)
    return {"full": {}, **{p: {"FUSED_GPT_SKIP": bits[n]} for p, n in PHASES.items()},
            "weight_loads": {"FUSED_GPT_SKIP": bits[WEIGHT_LOADS]}}


def ptxas_summary(log: str) -> list[str]:
    """ptxas' registers and spills of each kernel in a build's output."""
    return [line.strip() for line in log.splitlines() if "registers" in line or "spill" in line]


def build_variants() -> dict[str, object]:
    """Each variant's library (built together), its ptxas summary printed."""
    variants = variant_defines((_build.CSRC / "fused_gpt.cu").read_text())
    with ThreadPoolExecutor(len(variants)) as pool:
        libs = dict(zip(variants, pool.map(lambda d: _build.load("fused_gpt", d),
                                           variants.values())))
    for name, defines in variants.items():
        log = _build.build_log.get(" ".join(("fused_gpt",) + _build.define_flags(defines)), "")
        for line in ptxas_summary(log):
            print(f"  [ptxas] {name}: {line}")
    return {name: fused_gpt.bind(lib) for name, lib in libs.items()}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", choices=sorted(CHECKPOINTS), default="2M")
    ap.add_argument("--n", type=int, default=8192, help="contexts per forward")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_phases: needs a CUDA GPU")
    libs = build_variants()
    cfg, sd = load_reference_checkpoint(CHECKPOINTS[args.model])
    w = fused_gpt.stack_weights(load_model(cfg, sd, device="cuda"))
    tokens = torch.from_numpy(np.random.RandomState(args.seed).randint(
        0, cfg.vocab_size, size=(args.n, cfg.block_size))).to("cuda", torch.int32)
    times = {}
    for name, lib in libs.items():
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
    loads = times.pop("weight_loads")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"{smi} | {args.model} N={args.n} | full kernel {full:.3f} ms")
    for name, t in times.items():
        print(f"  {name:14s} {full - t:8.3f} ms  {100 * (full - t) / full:5.1f} %  "
              f"(kernel without it {t:.3f} ms)")
    rest = full - sum(full - t for t in times.values())
    print(f"  {'rest':14s} {rest:8.3f} ms  {100 * rest / full:5.1f} %  "
          "(embedding, LN, the 6M's half swaps, waits)")
    print(f"  {'weight loads':14s} {full - loads:8.3f} ms  {100 * (full - loads) / full:5.1f} %  "
          f"(kernel without the ring's copies {loads:.3f} ms; across the phases above)")


if __name__ == "__main__":
    main()
