"""relax_rounds_per_reset.rollout (rounds): the cost-to-go relaxation's rounds
an env reset in the rollout window: ``mapf.cost2go.relax_round`` spans inside
``mapf.env.reset`` spans, over the resets.  Each round runs four sweeps over
every field and reads a flag back to the host.  Layer: env reset
(``envs/env.reset`` -> ``ops/cost2go.relax_fixpoint``).  Moves
``rollout_agent_steps_per_s``.  No ``mapf.env.reset`` span in the window: None."""

from perfbench import spans


def read(trace):
    resets = spans.count(trace, "mapf.env.reset")
    if not resets:
        return None
    return spans.count(trace, "mapf.cost2go.relax_round", within="mapf.env.reset") / resets
