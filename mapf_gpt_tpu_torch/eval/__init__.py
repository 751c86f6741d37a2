"""Suite evaluation: the batched evaluator, its CLIs, report tables and
episode animations (the port of ``mapf_gpt_tpu/eval``)."""
