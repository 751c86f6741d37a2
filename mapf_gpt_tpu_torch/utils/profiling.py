"""Throughput and MFU meters, the program's profiler spans and device time by
kernel.

The port's counterpart of ``mapf_gpt_tpu/utils/profiling.py``: MFU is
measured against the card's dense bf16 peak with the PaLM appendix-B flop
model.  A device with no known peak (the CPU, an unlisted card) gets no
MFU: :class:`Meter` returns None for it rather than a number that is not
the device's.

:class:`span` marks a layer of the program (the rollout step, tokenization,
the policy forward and act, the env step and reset, each arbiter and
relaxation round, the training step and its parts, the shard feed) with a
``torch.profiler`` range named ``mapf.<layer>.<part>``, on the profiler's
clock beside the device's activities.  A span is recorded only while a
profiler records on the calling thread; otherwise it costs one flag check.
"""

from __future__ import annotations

import contextlib
import time

import torch

# dense bf16 tensor-core peaks (NVIDIA's data sheets, SXM parts)
GPU_PEAK_FLOPS = {
    "h100": 989e12,
    "h200": 989e12,
    "a100": 312e12,
}


def chip_peak_flops(device: torch.device | str = "cuda") -> float | None:
    """Dense bf16 FLOP/s of `device` by its name, or None (the CPU, a card
    not listed)."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device).lower()
    for key, val in GPU_PEAK_FLOPS.items():
        if key in name:
            return val
    return None


def transformer_flops_per_token(n_params: int, n_layer: int, n_head: int,
                                head_dim: int, seq_len: int) -> float:
    """PaLM appendix-B estimate of training FLOP a token: 6N + 12 L H Q T."""
    return 6 * n_params + 12 * n_layer * n_head * head_dim * seq_len


class Meter:
    """Exponentially smoothed steps/s and MFU."""

    def __init__(self, flops_per_step: float, peak_flops: float | None, beta: float = 0.9):
        self.flops_per_step = flops_per_step
        self.peak_flops = peak_flops
        self.beta = beta
        self.smoothed = None
        self._t = None

    def tick(self, steps: int = 1) -> tuple[float, float | None]:
        """Call where the host has waited for the device, with the steps run
        since the previous call.  Returns (steps_per_s, mfu), smoothed; mfu
        is None without a peak."""
        now = time.perf_counter()
        if self._t is None:
            self._t = now
            return 0.0, (0.0 if self.peak_flops else None)
        dt = now - self._t
        self._t = now
        sps = steps / max(dt, 1e-9)
        self.smoothed = sps if self.smoothed is None else (
            self.beta * self.smoothed + (1 - self.beta) * sps)
        if not self.peak_flops:
            return self.smoothed, None
        return self.smoothed, self.smoothed * self.flops_per_step / self.peak_flops


class span(contextlib.ContextDecorator):
    """A ``torch.profiler.record_function`` range named `name` while a
    profiler is recording, nothing otherwise; a context manager, or a
    decorator that opens the span on each call.

    Names are fixed strings under ``mapf.``, never formatted with shapes or
    ids: a span's parent is the span it nests in.  With no profiler recording
    the range is not entered (an idle ``record_function`` costs a call into
    the profiler each time), so the program's results and, within that flag
    check, its speed are the same with spans or without."""

    def __init__(self, name: str):
        self.name = name
        self._range = None

    def _recreate_cm(self):
        return span(self.name)

    def __enter__(self):
        if torch._C._autograd._profiler_enabled():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        return False


def kernel_times(fn, reps: int) -> list[tuple[float, float, str]]:
    """(device ms per call, launches per call, name) of each CUDA kernel
    that `reps` calls of fn() run, from a ``torch.profiler`` trace, largest
    first; empty where the profiler records no device time.  Warm fn up
    before: the trace counts whatever the calls do."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0) or 0
        if dev_us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((dev_us / 1e3 / reps, ev.count / reps, ev.key))
    return sorted(rows, reverse=True)


def kernel_key(name: str) -> str:
    """A kernel's short name from the demangled name the profiler records:
    the function's own name, after the last ``::`` of its qualified name and
    before its template arguments or parameters, so that
    ``void (anonymous namespace)::attn_bwd_q_kernel<32>(...)`` gives
    ``attn_bwd_q_kernel`` and kernels of one namespace stay apart."""
    head = name.replace("(anonymous namespace)", "").split("(")[0].split("<")[0]
    return head.split("::")[-1].split()[-1] if head.split() else name
