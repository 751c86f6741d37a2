"""Where the wgmma attention tile's time goes, by the SM clock.

    python3 -m mapf_gpt_tpu_torch.tools.attn_clock [--seed 0] [--smi]

Builds ``csrc/attention.cu`` and ``csrc/fused_blocks.cu`` with
``-DAW_CLOCK=1``, which turns on the marks of ``csrc/attn_wgmma.cuh``:
thread 0 of each consumer warpgroup reads ``clock64()`` at the boundaries
of a tile's phases and adds each phase's clocks to a counter in device
memory.  Runs the tile on random inputs once to warm up and once counted,
at both ``ATT_TIME`` shapes with ``_attn_kernel``'s arithmetic
(``attention_pallas``, bf16) and at the 85M's with the layer stack's
(``fused_blocks.blocks_attention``), and prints each phase's share of a
consumer warpgroup's clocks and that share of the counted run's time.
The marks add a clock read and an atomic at each boundary, so the
instrumented kernel runs a little slower than the built one; ptxas may
move instructions across a mark, so a phase's clocks are those between
its marks as scheduled.  With ``--smi``, it also samples ``nvidia-smi``'s
SM clock and power draw while the library as built runs the attention in
a loop, for the clock the bounds assume.  The libraries go to
``csrc/build/`` under their own keys.  Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import subprocess
import threading
import time
from unittest import mock

import torch

from mapf_gpt_tpu_torch.ops import _build
from mapf_gpt_tpu_torch.ops import attention as tatt
from mapf_gpt_tpu_torch.ops import fused_blocks

# attn_wgmma.cuh's ClockPhase, in its order
PHASES = ("stage wait", "S = Q K^T", "ticket wait", "max pass", "exp2s", "sums and packing",
          "P V", "epilogue and O store", "free the stage")
SHAPES = {"2M": (8192, 5, 256, 32), "85M": (2048, 12, 256, 64)}   # chip_smoke.ATT_TIME


def load(name: str) -> ctypes.CDLL:
    """The library of csrc/<name>.cu built with the tile's clock marks."""
    lib = ctypes.CDLL(str(_build.build(name, {"AW_CLOCK": 1})))
    lib.aw_clock_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.aw_clock_read.restype = ctypes.c_int
    return lib


def counted(lib: ctypes.CDLL, fn) -> tuple[float, list[int]]:
    """(ms of one run of fn, the counters of that run) after a warm-up run."""
    counts = (ctypes.c_ulonglong * len(PHASES))()
    fn()
    lib.aw_clock_read(counts, 1)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    rc = lib.aw_clock_read(counts, 1)
    if rc:
        raise RuntimeError(f"attn_clock: reading the counters failed ({rc})")
    return start.elapsed_time(end), list(counts)


def sm_clock(fn, seconds: float = 1.5) -> str:
    """nvidia-smi's SM clock and power draw, sampled while fn() runs in a
    loop for about `seconds`: their least, mean and largest readings."""
    samples, stop = [], threading.Event()

    def poll():
        while not stop.is_set():
            out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                                  "--format=csv,noheader,nounits"], capture_output=True,
                                 text=True, timeout=60).stdout.split(",")
            samples.append((float(out[0]), float(out[1])))
            time.sleep(0.05)

    fn()
    torch.cuda.synchronize()
    watcher = threading.Thread(target=poll)
    watcher.start()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
    stop.set()
    watcher.join()
    clk, watts = zip(*samples[1:] or samples)
    return (f"SM clock {min(clk):.0f} / {sum(clk) / len(clk):.0f} / {max(clk):.0f} MHz, power "
            f"{min(watts):.1f} / {sum(watts) / len(watts):.1f} / {max(watts):.1f} W (least / "
            f"mean / largest of {len(clk)} readings)")


def report(label: str, ms: float, vals: list[int]) -> None:
    whole = sum(vals)
    clocks = whole / (2 * torch.cuda.get_device_properties(0).multi_processor_count)
    print(f"{label}: instrumented kernel {ms:.3f} ms, {clocks:.0f} clocks a consumer "
          f"warpgroup ({clocks / ms / 1e3:.0f} MHz over the kernel's time)", flush=True)
    for name, v in zip(PHASES, vals):
        print(f"  {name:22s} {100 * v / whole:6.2f} %  {ms * v / whole:8.3f} ms", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smi", action="store_true",
                    help="also sample nvidia-smi's SM clock and power while the kernel as built "
                         "(no marks) runs in a loop at each attention shape")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("attn_clock: needs a CUDA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"[attn_clock] {smi}", flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    att = tatt.bind(load("attention"))
    for label, (b, h, t, d) in SHAPES.items():
        q, k, v = (torch.randn((b, h, t, d), generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(3))
        with mock.patch.object(tatt, "_library", lambda: att):
            ms, vals = counted(att, lambda: tatt.attention_pallas(q, k, v, 1.0 / math.sqrt(d)))
        report(f"[attn_clock] attention {label} [{b}, {h}, {t}, {d}] bf16", ms, vals)
        if args.smi:   # the library as built, without the marks
            print("[attn_clock]   the built kernel in a loop: " + sm_clock(
                lambda: tatt.attention_pallas(q, k, v, 1.0 / math.sqrt(d))), flush=True)
        del q, k, v
    blocks = fused_blocks.bind(load("fused_blocks"))
    b, h, t, d = SHAPES["85M"]
    qkv = torch.randn((b, t, 3 * h * d), generator=gen, device=dev)
    qkv[..., :h * d] *= math.log2(math.e) / math.sqrt(d)   # W_q's folded scale
    qkv = qkv.to(torch.bfloat16)
    with mock.patch.object(fused_blocks, "_library", lambda *_: blocks):
        ms, vals = counted(blocks, lambda: fused_blocks.blocks_attention(qkv, h))
    report(f"[attn_clock] layer stack's attention [{b}, {h}, {t}, {d}]", ms, vals)


if __name__ == "__main__":
    main()
