"""observe_idle_ms.rollout (ms): the device's idle time while the host is
inside ``mapf.obs.observe`` (``ops/obs.observe``, the tokenizer), a rollout
step.  Layer: ``ops/obs.observe``.  Moves ``rollout_agent_steps_per_s``.  No
device operation or no ``mapf.obs.observe`` span in the window: None."""

from perfbench import spans


def read(trace):
    return spans.idle_ms(trace, spans.span_intervals(trace, "mapf.obs.observe"), "steps")
