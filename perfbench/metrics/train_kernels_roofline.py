"""train_kernels_roofline (%): the training kernels' least time on the card
(``frozen.train_bounds``: the forward and the backward with its recompute, at
the cell's micro-batch), times the window's micro-batches, over the device time
of the program's training kernels (``ops/fused_gpt_train`` ->
``csrc/fused_train.cu`` and its headers).  Layer: the training kernels.  Moves
``train_samples_per_s``.  No kernel of the list ran: None."""

from perfbench import frozen

TRAIN = {"ln_kernel", "ln_bwd_kernel", "dg_partial_kernel", "reduce_add_kernel",
         "to_f32_kernel", "attn_bwd_q_kernel", "attn_bwd_kv_kernel", "attn_bwd_q_wide",
         "attn_bwd_kv_wide", "attn::attn_fwd_resident", "attn::attn_fwd_stream",
         "attn::attn_fwd_wide", "aw::attn_wgmma_kernel", "awb::attn_bwd_q_wgmma",
         "awb::attn_bwd_kv_wgmma", "gemm::gemm_kernel", "tbg::mlp_front_kernel",
         "tbg::ln_dx_kernel"}


def read(trace):
    busy = trace.device_seconds(TRAIN)
    if busy <= 0:
        return None
    fwd, bwd = frozen.train_bounds(trace.config, trace.counts["micro_batch"])
    return 100.0 * trace.counts["micro_batches"] * (fwd[0] + bwd[0]) * 1e-3 / busy
