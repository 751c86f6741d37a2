"""eager_ms_per_iter.train (ms): the device time an iteration of every operation
not on the training kernels' list: ``train/train_step``'s AdamW, clip and loss,
the embedding's and head's eager ops, the feed's copies.  Layer:
``train/train_step``.  Moves ``train_samples_per_s``.  No training kernel of the
list ran (a stale list): None."""

TRAIN = {"ln_kernel", "ln_bwd_kernel", "dg_partial_kernel", "reduce_add_kernel",
         "to_f32_kernel", "attn_bwd_q_kernel", "attn_bwd_kv_kernel", "attn_bwd_q_wide",
         "attn_bwd_kv_wide", "attn::attn_fwd_resident", "attn::attn_fwd_stream",
         "attn::attn_fwd_wide", "aw::attn_wgmma_kernel", "awb::attn_bwd_q_wgmma",
         "awb::attn_bwd_kv_wgmma", "gemm::gemm_kernel", "tbg::mlp_front_kernel",
         "tbg::ln_dx_kernel"}


def read(trace):
    iterations = trace.counts.get("iterations")
    if not iterations or trace.device_seconds(TRAIN) <= 0:
        return None
    return 1e3 * trace.device_seconds(TRAIN, exclude=True) / iterations
