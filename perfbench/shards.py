"""Training rows from a seed, written as Arrow shards in the layout the program's
``train/data.py`` reads: a frozen copy of its ``write_arrow_shard`` (schema
``{input_tensors: list<int8>[256], gt_actions: int8}``, one file each)."""

from __future__ import annotations

import os

import numpy as np


def make_rows(seed: int, rows: int, context: int, vocab: int, actions: int
              ) -> tuple[np.ndarray, np.ndarray]:
    """(tokens int8 [rows, context] uniform over the vocabulary, targets int8
    [rows] uniform over the actions), from `seed`."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0x5EED]))
    tokens = rng.integers(0, vocab, size=(rows, context), dtype=np.int8)
    targets = rng.integers(0, actions, size=rows, dtype=np.int8)
    return tokens, targets


def write_arrow_shard(path: str, tokens: np.ndarray, actions: np.ndarray) -> None:
    """Write one shard in the reference schema."""
    import pyarrow as pa

    tokens = np.ascontiguousarray(tokens, dtype=np.int8)
    actions = np.ascontiguousarray(actions, dtype=np.int8)
    offsets = np.arange(0, (len(tokens) + 1) * tokens.shape[1], tokens.shape[1],
                        dtype=np.int32)
    larr = pa.ListArray.from_arrays(pa.array(offsets),
                                    pa.array(tokens.reshape(-1), type=pa.int8()))
    table = pa.table({"input_tensors": larr, "gt_actions": pa.array(actions, type=pa.int8())})
    tmp = path + ".tmp"
    with pa.OSFile(tmp, "wb") as sink:
        with pa.ipc.new_file(sink, table.schema) as writer:
            writer.write_table(table)
    os.rename(tmp, path)


class RowIndex:
    """Finds rows of `tokens` by content: the benchmark's own record of which of
    its rows the program's feed served."""

    def __init__(self, tokens: np.ndarray):
        self.tokens = tokens
        rng = np.random.default_rng(0)
        self._mix = rng.integers(1, 2 ** 62, size=tokens.shape[1], dtype=np.int64)
        keys = self._keys(tokens)
        self._order = np.argsort(keys, kind="stable")
        self._sorted = keys[self._order]

    def _keys(self, rows: np.ndarray) -> np.ndarray:
        with np.errstate(over="ignore"):
            return (rows.astype(np.int64) * self._mix).sum(-1)

    def find(self, rows: np.ndarray) -> np.ndarray:
        """Indices into `tokens` of each of `rows` [n, context]; -1 where a row
        is not one of them."""
        keys = self._keys(rows)
        at = np.searchsorted(self._sorted, keys).clip(max=len(self._sorted) - 1)
        idx = self._order[at]
        same = (self._sorted[at] == keys) & (self.tokens[idx] == rows).all(-1)
        return np.where(same, idx, -1)
