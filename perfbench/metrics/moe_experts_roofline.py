"""moe_experts_roofline (%): the routed experts' grouped GEMMs alone
(``grouped::expert_gemm_kernel``, ``csrc/grouped_gemm.cuh``: the gate|up
product with its SwiGLU epilogue and the down product, over the router's
segments): their least time (``frozen_moe.experts_bound``: 2 k 3 E f FLOP a
token and MoE layer at the bf16 rate, against each layer's expert weights,
permuted rows, hidden rows and outputs) at the step's contexts times the
window's steps, over their device time.  Layer: ``ops/moe`` grouped expert
GEMMs.  Moves ``rollout_agent_steps_per_s``.  No such kernel ran: None."""

from perfbench import frozen_moe

EXPERTS = {"grouped::expert_gemm_kernel"}


def read(trace):
    busy = trace.device_seconds(EXPERTS)
    if busy <= 0 or "moe_intermediate_size" not in trace.config:
        return None
    ms = frozen_moe.experts_bound(trace.config, trace.counts["contexts_per_step"])[0]
    return 100.0 * trace.counts["steps"] * ms * 1e-3 / busy
