"""env_step_idle_ms.rollout (ms): the device's idle time while the host is
inside ``mapf.env.step`` (``envs/env.step``, with the arbiter's rounds and
their flag reads), a rollout step.  Layer: ``envs/env.step + envs/dynamics``.
Moves ``rollout_agent_steps_per_s``.  No device operation or no
``mapf.env.step`` span in the window: None."""

from perfbench import spans


def read(trace):
    return spans.idle_ms(trace, spans.span_intervals(trace, "mapf.env.step"), "steps")
