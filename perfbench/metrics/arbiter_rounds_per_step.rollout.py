"""arbiter_rounds_per_step.rollout (rounds): the collision arbiter's rounds a
env step in the rollout window: ``mapf.env.arbiter_round`` spans over
``mapf.env.step`` spans.  Each round reads a flag back to the host, so each
waits for the device.  Layer: ``envs/dynamics.resolve_collisions``.  Moves
``rollout_agent_steps_per_s``.  No ``mapf.env.step`` span in the window (a
program without spans): None."""

from perfbench import spans


def read(trace):
    steps = spans.count(trace, "mapf.env.step")
    if not steps:
        return None
    return spans.count(trace, "mapf.env.arbiter_round", within="mapf.env.step") / steps
