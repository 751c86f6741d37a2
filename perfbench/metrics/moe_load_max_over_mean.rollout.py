"""moe_load_max_over_mean.rollout (ratio): how unevenly the router loads the
experts in the rollout window: for each MoE layer, the busiest expert's
token rows over the mean expert's, from the program's device-side counter of
tokens per expert per layer (``models/moonlight.MoonlightPolicy.
expert_counts``, added by ``csrc/moe.cu``'s router on the card and read once
after the window, ``counts["expert_counts"]``), averaged over the layers.
1 is an even load; the grouped GEMMs' tiles follow it.  Layer:
``ops/moe.route``.  Moves ``rollout_agent_steps_per_s``.  No counter: None."""


def read(trace):
    counts = trace.counts.get("expert_counts")
    if not counts:
        return None
    ratios = [max(row) * len(row) / sum(row) for row in counts if sum(row) > 0]
    return sum(ratios) / len(ratios) if ratios else None
