"""forward_roofline (%): the policy forward's least time on the
card over the device time of the program's forward kernels, in the rollout
window.  Layer: ``models/gpt.make_forward`` -> ``ops/fused_gpt`` (the e2e kernel,
``csrc/fused_gpt.cu``, 2M and 6M) or ``ops/fused_blocks`` (the layer-stack
kernels, ``csrc/fused_blocks.cu``, 85M).  Moves ``rollout_agent_steps_per_s``.

The least time is ``frozen.e2e_bound`` (layers with the last thinned, embedding
and head, all inside the e2e kernel) where the e2e kernel ran, else
``frozen.blocks_bound`` (the layer stack; the chunked route's embedding and head
are eager PyTorch and count under ``eager_ms_per_step.rollout``), at the step's
contexts, times the window's steps.  No kernel of the list ran: None."""

from perfbench import frozen

FORWARD = {"fused_gpt_kernel", "ln_kernel", "gemm::gemm_kernel", "aw::attn_wgmma_kernel",
           "thin_attention_kernel", "blocks_attention", "blocks_attention_wide",
           "attn::attn_fwd_resident", "attn::attn_fwd_stream", "attn::attn_fwd_wide"}


def read(trace):
    busy = trace.device_seconds(FORWARD)
    if busy <= 0:
        return None
    n, steps = trace.counts["contexts_per_step"], trace.counts["steps"]
    e2e = any(k == "fused_gpt_kernel" for k, _, _ in trace.kernels)
    ms = (frozen.e2e_bound if e2e else frozen.blocks_bound)(trace.config, n)[0]
    return 100.0 * steps * ms * 1e-3 / busy
