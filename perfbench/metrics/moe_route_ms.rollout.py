"""moe_route_ms.rollout (ms): the device time a rollout step of the router's
own kernels and the combine (``csrc/moe.cu``: ``topk_kernel``,
``route_offsets_kernel``, ``scatter_kernel`` -- the choice, the segment
table and the permutation -- and ``combine_kernel``), summed over the MoE
layers.  The router's product itself runs on ``gemm::gemm_kernel`` with the
dense projections, whose name it shares, and is not in it.  Layer:
``ops/moe.route``.  Moves ``rollout_agent_steps_per_s``.  No such kernel
ran: None."""

ROUTE = {"topk_kernel", "route_offsets_kernel", "scatter_kernel", "combine_kernel"}


def read(trace):
    steps = trace.counts.get("steps")
    busy = trace.device_seconds(ROUTE)
    if not steps or busy <= 0:
        return None
    return 1e3 * busy / steps
