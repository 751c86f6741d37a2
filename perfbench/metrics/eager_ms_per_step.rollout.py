"""eager_ms_per_step.rollout (ms): the device time a rollout step of every
operation not on the forward kernels' list: the eager PyTorch work of
``ops/obs.observe``, ``models/gpt.act``, ``envs/env.step`` (and the chunked
route's embedding and head, and the episodes' resets, which the window also
holds).  Layer: the eager step.  Moves ``rollout_agent_steps_per_s``.  No
forward kernel of the list ran (a stale list): None."""

FORWARD = {"fused_gpt_kernel", "ln_kernel", "gemm::gemm_kernel", "aw::attn_wgmma_kernel",
           "thin_attention_kernel", "blocks_attention", "blocks_attention_wide",
           "attn::attn_fwd_resident", "attn::attn_fwd_stream", "attn::attn_fwd_wide"}


def read(trace):
    steps = trace.counts.get("steps")
    if not steps or trace.device_seconds(FORWARD) <= 0:
        return None
    return 1e3 * trace.device_seconds(FORWARD, exclude=True) / steps
