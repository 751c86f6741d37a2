"""mapf_gpt_tpu_torch — the PyTorch/CUDA port of ``mapf_gpt_tpu``.

The batched MAPF rollout of the 2M, 6M and 85M policies on an NVIDIA H100,
one-shot and lifelong: reset (``envs/env.py``, cost2go fields from
``ops/cost2go.py``) -> tokenize (``ops/obs.py``, input masks from
``ops/masking.py``) -> policy forward
(``models/gpt.py``; on CUDA through ``ops/fused_gpt.py`` the hand-written
kernels of ``csrc/fused_gpt.cu`` for the 2M and 6M and of
``csrc/fused_blocks.cu``, via ``ops/fused_blocks.py``, for the 85M) -> act
-> step (``envs/dynamics.py``) -> episode metrics (``envs/metrics.py``),
driven by ``parallel/rollout.py``; the suite evaluator and its CLIs over
it (``eval/``), the root ``bench.py``'s workload (``bench.py``), and the
trainer (``train/``).

The package imports torch and numpy only (PyYAML and matplotlib only inside
the functions that read suite files and draw plots): nothing of JAX and
nothing of ``mapf_gpt_tpu``, of which it keeps its own copies
(``ops/vocab.py``, ``maps.py``, ``eval/report.py``, ``eval/animation.py``).  Entry points take an explicit ``device`` that defaults to
``"cuda"``; CPU tensors take the plain PyTorch versions of the kernels.
"""

__version__ = "0.1.0"
