"""Arrow-shard streaming input pipeline for imitation training.

A copy of ``mapf_gpt_tpu/train/data.py`` (the port imports nothing of the
JAX package): pyarrow memory-mapped shards of int8 contexts [*, 256] with
int8 expert actions, schema ``{input_tensors: list<int8>[256], gt_actions:
int8}``, a contiguous split of the files by global process index, a
per-file permutation shuffle, an infinite iterator yielding numpy
micro-batch stacks ``[accum, B, 256]`` / ``[accum, B]``; moving them to the
device is the caller's job.  ``pyarrow`` is imported inside the functions
that need it, and its absence raises ``ImportError`` saying so.
"""

from __future__ import annotations

import glob
import os
import zlib
from typing import Iterator

import numpy as np

from mapf_gpt_tpu_torch.utils.profiling import span


def _pyarrow():
    try:
        import pyarrow
    except ImportError as err:
        raise ImportError("the Arrow shard reader and writer need the pyarrow package, "
                          "which is not installed") from err
    return pyarrow


class ArrowShardStream:
    """Infinite shuffled stream over Arrow shard files."""

    def __init__(self, path: str, batch_size: int, grad_accum: int = 1,
                 process_index: int = 0, process_count: int = 1,
                 seed: int = 1337, context: int = 256):
        self._path = path
        self._process_index = process_index
        self._process_count = process_count
        self._initial_files = None  # pinned on first scan (slice stability)
        self.files = self._scan()
        if not self.files:
            raise FileNotFoundError(f"no .arrow shards under {path}")
        self.batch_size = batch_size
        self.grad_accum = grad_accum
        self.context = context
        self.rng = np.random.RandomState(seed + process_index)

    def _scan(self) -> list:
        """List this process's shard slice; re-run each epoch so shards
        written by a concurrently-running generator join the stream at the
        next epoch boundary (contiguous split by global process index —
        the reference splits by LOCAL_RANK, ref:fast_data_loader.py:20-28)."""
        if os.path.isdir(self._path):
            files = sorted(glob.glob(os.path.join(self._path, "*.arrow")))
        else:
            files = [self._path]
        # pin the initial assignment as a FROZEN file list so later rescans
        # (shard count growing under a concurrent generator) never shift
        # another process's slice — sorting is irrelevant once frozen, so
        # chunk_10 vs chunk_2 lexicographic quirks can't reshuffle slices.
        # Files appearing after init are assigned by a stable per-name hash
        # (crc32 of basename), which every process computes identically and
        # which never changes as more files appear.
        if self._initial_files is None:
            self._initial_files = tuple(files)
        initial = set(self._initial_files)
        base = list(self._initial_files)
        per = max(len(base) // self._process_count, 1)
        lo = self._process_index * per
        hi = (len(base) if self._process_index == self._process_count - 1
              else lo + per)
        mine = base[lo:hi] or base[:1]
        mine += [f for f in files if f not in initial
                 and zlib.crc32(os.path.basename(f).encode())
                 % self._process_count == self._process_index]
        return mine

    @span("mapf.data.load_shard")
    def _load_file(self, path: str) -> tuple[np.ndarray, np.ndarray]:
        tokens, actions = read_arrow_shard(path, self.context)
        perm = self.rng.permutation(len(tokens))
        return tokens[perm], actions[perm]

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """Yields (tokens int32 [accum, B, 256], targets int32 [accum, B])."""
        need = self.batch_size * self.grad_accum
        while True:
            self.files = self._scan() or self.files
            order = self.rng.permutation(len(self.files))
            for fi in order:
                tokens, actions = self._load_file(self.files[fi])
                n = (len(tokens) // need) * need
                for i in range(0, n, need):
                    with span("mapf.data.batch"):     # closed before the consumer runs
                        x = tokens[i:i + need].astype(np.int32).reshape(
                            self.grad_accum, self.batch_size, self.context)
                        y = actions[i:i + need].astype(np.int32).reshape(
                            self.grad_accum, self.batch_size)
                    yield x, y


def read_arrow_shard(path: str, context: int = 256
                     ) -> tuple[np.ndarray, np.ndarray]:
    """One shard in file order: (tokens int8 [N, context], actions int8
    [N])."""
    pa = _pyarrow()

    with pa.memory_map(path) as source:
        table = pa.ipc.open_file(source).read_all()
    tokens = np.asarray(table["input_tensors"].combine_chunks()
                        .flatten(), dtype=np.int8)
    tokens = tokens.reshape(-1, context)
    actions = np.asarray(table["gt_actions"].combine_chunks(),
                         dtype=np.int8)
    return tokens, actions


def write_arrow_shard(path: str, tokens: np.ndarray,
                      actions: np.ndarray) -> None:
    """Write a shard in the reference schema
    (ref:dataset/generate_dataset.py:188-212)."""
    pa = _pyarrow()

    tokens = np.ascontiguousarray(tokens, dtype=np.int8)
    actions = np.ascontiguousarray(actions, dtype=np.int8)
    # reference uses list<int8>; keep variable-size list for schema parity
    offsets = np.arange(0, (len(tokens) + 1) * tokens.shape[1],
                        tokens.shape[1], dtype=np.int32)
    larr = pa.ListArray.from_arrays(pa.array(offsets),
                                    pa.array(tokens.reshape(-1),
                                             type=pa.int8()))
    table = pa.table({"input_tensors": larr,
                      "gt_actions": pa.array(actions, type=pa.int8())})
    # write to a temp name and atomically rename so a concurrently-running
    # trainer's epoch re-scan (ArrowShardStream._scan globs *.arrow) never
    # memory-maps a partially-written shard
    tmp = path + ".tmp"
    with pa.OSFile(tmp, "wb") as sink:
        with pa.ipc.new_file(sink, table.schema) as writer:
            writer.write_table(table)
    os.rename(tmp, path)
