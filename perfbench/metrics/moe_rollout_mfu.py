"""moe_rollout_mfu (%): the DeepSeek-V3-type policy's forward products over
every step of the rollout window (``frozen_moe.forward_flops`` a context: the
layers with the last thinned to the last position, and the head; 1.1254
TFLOP at the Moonlight configuration's sizes), over the window's time and the
card's dense bf16 peak.  Layer: the whole rollout step.  Moves
``rollout_agent_steps_per_s``."""

from perfbench import frozen_moe


def read(trace):
    steps = trace.counts.get("steps")
    if not steps or trace.window_s <= 0 or "moe_intermediate_size" not in trace.config:
        return None
    flops = steps * trace.counts["contexts_per_step"] * frozen_moe.forward_flops(trace.config)
    return 100.0 * flops / trace.window_s / frozen_moe.PEAK_BF16
