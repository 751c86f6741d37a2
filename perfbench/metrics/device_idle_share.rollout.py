"""device_idle_share.rollout (%): the share of the rollout window in which no
operation ran on the device (1 minus the union of the device's operation
intervals over the window).  Layer: the device under
``parallel/rollout.make_batch_rollout``.  Moves ``rollout_agent_steps_per_s``."""


def read(trace):
    if not trace.kernels or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
