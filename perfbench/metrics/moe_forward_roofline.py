"""moe_forward_roofline (%): the DeepSeek-V3-type policy's forward, its least
time on the card (``frozen_moe.forward_bound``: the products at the bf16
rate against the weights read once) at the step's contexts times the
window's steps, over the device time of the family's forward kernels.
Layer: ``models/moonlight`` -> ``ops/moe`` (``csrc/moe.cu``,
``csrc/grouped_gemm.cuh``, ``csrc/gemm_tile.cuh``) and ``ops/attention``
(``csrc/attention.cu``'s slab kernel at the heads' 192 columns).  The
embedding, the final norm and the head are eager PyTorch and are not on the
list.  Moves ``rollout_agent_steps_per_s``.  No kernel of the list ran: None."""

from perfbench import frozen_moe

FORWARD = {"gemm::gemm_kernel", "grouped::expert_gemm_kernel", "grouped::dense_gemm_kernel",
           "rms_norm_kernel", "topk_kernel", "route_offsets_kernel", "scatter_kernel",
           "combine_kernel", "rope_kernel", "compact_kernel", "thin_attention_kernel",
           "attn::attn_fwd_wide"}


def read(trace):
    busy = trace.device_seconds(FORWARD)
    if busy <= 0 or "moe_intermediate_size" not in trace.config:
        return None
    ms = frozen_moe.forward_bound(trace.config, trace.counts["contexts_per_step"])[0]
    return 100.0 * trace.counts["steps"] * ms * 1e-3 / busy
