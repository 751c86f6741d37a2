"""Build the native LaCAM* solver (``native/lacam/``) with ``g++`` into a
shared library, loaded by ``dataset/expert.py`` with ``ctypes``.

The 13 library sources (``main.cpp`` is the standalone binary and is not
built) compile in parallel, one ``g++ -c`` each, then link with ``-O3
-std=c++17 -fPIC -shared -pthread``.  The library goes to
``native/lacam/build/liblacam-<hash>.so`` (listed in ``.gitignore``), keyed
by a hash of the sources, ``lacam.hpp`` and the flags, so a later process on
the same checkout does not rebuild.  Objects go to a directory of the
building process's own, and the library is written under a temporary name
and renamed, so several processes may build at once.  A missing ``g++`` or
a failed compile raises with the compiler's output.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

LACAM_DIR = Path(__file__).resolve().parent.parent / "native" / "lacam"
BUILD_DIR = LACAM_DIR / "build"
# the library's sources, as the JAX package's CMakeLists.txt lists them
SOURCES = ("graph.cpp", "utils.cpp", "dist_table.cpp", "metrics.cpp", "translator.cpp",
           "collision_table.cpp", "sipp.cpp", "scatter.cpp", "pibt.cpp", "planner.cpp",
           "refiner.cpp", "post_processing.cpp", "capi.cpp")
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread")


def find_gxx() -> str:
    """Path of g++ on PATH."""
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found on PATH; the LaCAM* solver library is built with g++")
    return found


def library_path() -> Path:
    """Where the library goes, keyed by the sources, the header and the flags."""
    h = hashlib.sha256()
    for name in SOURCES + ("lacam.hpp",):
        h.update(name.encode() + b"\0" + (LACAM_DIR / name).read_bytes() + b"\0")
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"liblacam-{h.hexdigest()[:16]}.so"


def _check(proc: subprocess.CompletedProcess | subprocess.Popen, cmd: list, out: str) -> None:
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")


def build() -> Path:
    """Compile and link the library unless it exists; returns its path."""
    out = library_path()
    if out.exists():
        return out
    gxx = find_gxx()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    obj_dir = BUILD_DIR / f"obj.{os.getpid()}"
    obj_dir.mkdir(exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        jobs = []
        for name in SOURCES:
            cmd = [gxx, *CXX_FLAGS, "-c", str(LACAM_DIR / name), "-o",
                   str(obj_dir / (name[:-4] + ".o"))]
            jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.STDOUT, text=True)))
        outputs = [proc.communicate()[0] for _, proc in jobs]   # all finish before a raise
        for (cmd, proc), text in zip(jobs, outputs):
            _check(proc, cmd, text)
        cmd = [gxx, *CXX_FLAGS, "-shared", "-o", str(tmp),
               *(str(obj_dir / (name[:-4] + ".o")) for name in SOURCES)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        _check(proc, cmd, proc.stdout + proc.stderr)
        os.replace(tmp, out)   # atomic: a concurrent loader sees all or nothing
    finally:
        shutil.rmtree(obj_dir, ignore_errors=True)
        tmp.unlink(missing_ok=True)
    return out
