"""The port runs where JAX is absent: ``mapf_gpt_tpu_torch`` and
``chip_smoke.py`` import neither JAX, flax nor anything of ``mapf_gpt_tpu``,
and, since the GPU machine has neither, they import without PyYAML,
matplotlib and huggingface_hub (which only the functions that read suite
files, draw plots and download import).

The import check runs in a subprocess with those modules blocked (a
``None`` entry in ``sys.modules`` makes their import fail), which is the
GPU machine's environment; it has to be a subprocess because this test
session's conftest has imported JAX already."""

import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "mapf_gpt_tpu_torch")

_BLOCKED_IMPORTS = f"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "optax", "orbax", "mapf_gpt_tpu", "yaml", "matplotlib",
             "huggingface_hub"):
    sys.modules[name] = None
sys.path.insert(0, {ROOT!r})
import mapf_gpt_tpu_torch
names = [m.name for m in pkgutil.walk_packages(mapf_gpt_tpu_torch.__path__,
                                               "mapf_gpt_tpu_torch.")]
for name in names:
    importlib.import_module(name)
# the modules of the kernels, the attention kernel's (the module route) among them
assert {{"mapf_gpt_tpu_torch.ops.attention", "mapf_gpt_tpu_torch.ops.fused_gpt",
         "mapf_gpt_tpu_torch.ops.fused_blocks", "mapf_gpt_tpu_torch.ops.fused_gpt_train",
         "mapf_gpt_tpu_torch.models.gpt", "mapf_gpt_tpu_torch.ops.masking",
         "mapf_gpt_tpu_torch.bench", "mapf_gpt_tpu_torch.eval.harness",
         "mapf_gpt_tpu_torch.eval.run", "mapf_gpt_tpu_torch.eval.benchmark",
         "mapf_gpt_tpu_torch.eval.example", "mapf_gpt_tpu_torch.eval.report",
         "mapf_gpt_tpu_torch.eval.animation", "mapf_gpt_tpu_torch.eval.bigmap",
         "mapf_gpt_tpu_torch.dataset.expert", "mapf_gpt_tpu_torch.dataset.generate",
         "mapf_gpt_tpu_torch.dataset.solve", "mapf_gpt_tpu_torch.dataset.download",
         "mapf_gpt_tpu_torch.dataset._lacam_build", "mapf_gpt_tpu_torch.parallel.mesh",
         "mapf_gpt_tpu_torch.tools.mp_worker"}} <= set(names), names
import chip_smoke
leaked = sorted(n for n in sys.modules
                if n.split(".")[0] in ("jax", "flax", "mapf_gpt_tpu", "yaml", "matplotlib",
                                       "huggingface_hub")
                and sys.modules[n] is not None)
assert not leaked, leaked
print(len(names))
"""


def test_port_imports_without_jax():
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORTS], cwd=ROOT,
                          capture_output=True, text=True, timeout=120,
                          env={k: v for k, v in os.environ.items()
                               if k != "PYTHONPATH"})
    assert proc.returncode == 0, proc.stderr
    # every module and subpackage: each .py file but the package's own __init__
    expected = sum(f.endswith(".py") for _, _, fs in os.walk(PORT) for f in fs) - 1
    assert int(proc.stdout.split()[-1]) == expected >= 13


def test_no_port_file_names_jax_or_the_jax_package():
    pattern = re.compile(r"\bmapf_gpt_tpu\.|\bimport jax\b"
                         r"|^\s*(import|from)\s+(jax|flax|mapf_gpt_tpu)\b", re.M)
    files = [os.path.join(d, f) for d, _, fs in os.walk(PORT) for f in fs
             if f.endswith((".py", ".cu"))] + [os.path.join(ROOT, "chip_smoke.py")]
    offenders = {}
    for path in files:
        with open(path) as fh:
            hits = [m.group(0) for m in pattern.finditer(fh.read())]
        if hits:
            offenders[os.path.relpath(path, ROOT)] = hits
    assert not offenders, offenders
