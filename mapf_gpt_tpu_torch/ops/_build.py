"""Build and load the port's CUDA kernels: ``nvcc`` into a plain shared
library, loaded with ``ctypes``.

Each source ``csrc/<name>.cu`` exports ``extern "C"`` functions and includes
no PyTorch header, so a build takes seconds.  The library goes to
``csrc/build/lib<name>-<hash>.so`` (listed in ``.gitignore``), keyed by a
hash of the source, of the headers it includes from ``csrc/`` (``#include
"x.cuh"``, followed through nested includes), the flags and the ``-D``
defines a caller passes (a kernel built for one width is a library of its
own): a second load in the
same process, or in a later process on the same checkout, does not
rebuild.  A missing ``nvcc`` or a failed build raises with the compiler's
output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[tuple, ctypes.CDLL] = {}
_lock = threading.Lock()
build_log: dict[str, str] = {}   # name and -D flags -> the compiler's output in this process


def find_nvcc() -> str:
    """Path of nvcc: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found (looked on PATH and in "
                       f"{home}/bin); the CUDA kernels need the CUDA toolkit")


def define_flags(defines: dict[str, int] | None) -> tuple[str, ...]:
    """``-DKEY=VALUE`` flags, in sorted key order."""
    return tuple(f"-D{k}={v}" for k, v in sorted((defines or {}).items()))


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def source_files(name: str) -> list[Path]:
    """csrc/<name>.cu and every header it includes with quotes, nested
    includes too, each once, in the order first reached."""
    files, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in files:
            continue
        files.append(path)
        for inc in _LOCAL_INCLUDE.findall(path.read_bytes()):
            todo.append(path.parent / inc.decode())
    return files


def library_path(name: str, defines: dict[str, int] | None = None) -> Path:
    """Where the library of csrc/<name>.cu goes, keyed by its source and
    included headers, the flags and the defines."""
    h = hashlib.sha256()
    for path in source_files(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    h.update(" ".join(NVCC_FLAGS + define_flags(defines)).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str, defines: dict[str, int] | None = None) -> Path:
    """Compile csrc/<name>.cu with `defines` unless that library exists."""
    out = library_path(name, defines)
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, *define_flags(defines), "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_log[" ".join((name,) + define_flags(defines))] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building {name}:\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)   # atomic: a concurrent loader sees all or nothing
    return out


def load(name: str, defines: dict[str, int] | None = None) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu with `defines`, built on first use."""
    key = (name, define_flags(defines))
    with _lock:
        if key not in _loaded:
            _loaded[key] = ctypes.CDLL(str(build(name, defines)))
        return _loaded[key]
