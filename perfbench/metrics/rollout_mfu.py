"""rollout_mfu (%): the policy forward's products over every step of the
rollout window (``frozen.forward_model_flops`` a context: the layers with the
last thinned to the last position, and the head), over the window's time and
the card's dense bf16 peak.  Layer: the whole rollout step.  Moves
``rollout_agent_steps_per_s``."""

from perfbench import frozen


def read(trace):
    steps = trace.counts.get("steps")
    if not steps or trace.window_s <= 0:
        return None
    flops = steps * trace.counts["contexts_per_step"] * frozen.forward_model_flops(trace.config)
    return 100.0 * flops / trace.window_s / frozen.PEAK_BF16
