"""reset_ms.rollout (ms): an episode's reset, ``parallel/rollout.batch_reset``
(``envs/env.reset`` and the cost-to-go fields of ``ops/cost2go``), between CUDA
events around the benchmark's own call, the mean over the window's episodes.
Layer: the env reset.  Moves ``rollout_agent_steps_per_s``."""


def read(trace):
    return trace.counts.get("reset_ms")
