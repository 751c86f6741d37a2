"""The attention kernels' routes over a grid of shapes, held to a recorded
table: which (T, head dim, dtype) the wgmma tile (``csrc/attn_wgmma.cuh``)
admits and which go to ``csrc/attn_tile.cuh``'s tiles, the slabs or the
FMA kernel, for ``csrc/attention.cu`` and for the training attention
(``csrc/fused_train.cu``, through its mirror
``ops.fused_gpt_train.attention_route``).

T runs from 1 to 300 and the head dim from 8 to 144.  ``attention.cu``'s
route lives in C (``attention_route``), which no CPU test can call: the
test holds the text of that function to its recorded digest and
transcribes it with the constants it reads from the headers (``T_MAX``,
``takes()``, ``D_TILE``), over ``check_shape`` and ``kernel_width``.  Each
table's route counts and digest are those of the tree before the tile's
rebuild, so a change to the tile leaves every shape on the route it had.
"""

import collections
import hashlib
import re

import pytest
import torch

from mapf_gpt_tpu_torch.ops import _build
from mapf_gpt_tpu_torch.ops import attention as tatt
from mapf_gpt_tpu_torch.ops import fused_gpt_train as fgt

TS = range(1, 301)
DS = range(8, 145)
WG = (_build.CSRC / "attn_wgmma.cuh").read_text()
ATT = (_build.CSRC / "attention.cu").read_text()
T_MAX = int(re.search(r"constexpr int T_MAX = (\d+);", WG)[1])
TAKES = tuple(int(w) for w in re.findall(
    r"d == (\d+)", re.search(r"constexpr bool takes\(int d\) \{\s*return ([^;]*);", WG)[1]))
D_TILE = int(re.search(r"constexpr int D_TILE = (\d+);", ATT)[1])


def _table_digest(rows: list[str]) -> tuple[dict, str]:
    counts = collections.Counter(r.rsplit(",", 1)[1] for r in rows)
    return dict(counts), hashlib.sha256("\n".join(rows).encode()).hexdigest()


def test_launcher_route_text_is_unchanged():
    """attention_route in csrc/attention.cu, which the table below
    transcribes, and the tile's limits it reads."""
    body = re.search(r"int attention_route\(int dtype, int T, int D\) \{(.*?)\n\}", ATT, re.S)[1]
    assert hashlib.sha256(body.encode()).hexdigest()[:16] == "f260164170c6791c"
    assert (T_MAX, TAKES, D_TILE) == (256, (16, 32, 48, 64), 128)


def _route(t: int, d: int, dtype: torch.dtype) -> str:
    """csrc/attention.cu's attention_route at the width the wrapper passes
    (kernel_width), for head dims up to 144: at those the slabs' window and
    the FMA staging always fit."""
    w = tatt.kernel_width(d, dtype)
    if dtype == torch.float32 or (dtype == torch.float16 and w > D_TILE):
        return "fma"
    if w > D_TILE:
        return "wide"
    return "wgmma" if t <= T_MAX and w in TAKES else "tile"


ATTENTION_TABLES = {   # dtype -> (route counts, digest of the table)
    "bfloat16": ({"wgmma": 14592, "tile": 21708, "wide": 4800},
                 "1fc0a02f94ae1aa12ee9338f1788d2cc94c681a90f212c011c7e9e474b4e6085"),
    "float16": ({"wgmma": 14592, "tile": 21708, "fma": 4800},
                "6322413f05746d32963c2aedd012d9c6a0d8bda669af6e0f832637c7530caf7d"),
    "float32": ({"fma": 41100},
                "98f95cde245633cc78db9cbf3e4e39083cff896a1d06dbfa4240c232a066a49b"),
}


@pytest.mark.parametrize("dtype", sorted(ATTENTION_TABLES))
def test_attention_routes_admit_exactly_the_recorded_shapes(dtype, monkeypatch):
    monkeypatch.setattr(_build, "build", lambda *a, **k: pytest.fail("built"))
    dt = getattr(torch, dtype)
    rows = []
    for t in TS:
        for d in DS:
            tatt.check_shape(t, d, dt)   # every shape of the grid is taken
            rows.append(f"{t},{d},{tatt.kernel_width(d, dt)},{_route(t, d, dt)}")
    assert _table_digest(rows) == ATTENTION_TABLES[dtype]


TRAIN_TABLES = {   # heads -> (route counts, digest of the table)
    1: ({"wgmma": 14592, "tile": 21708, "wide": 4800},
        "c66365b2374f07bc83d3b980ac1b73677b24cf083927f21db778dd046137e0de"),
    4: ({"wgmma": 14592, "tile": 21708, "wide": 4800},
        "c66365b2374f07bc83d3b980ac1b73677b24cf083927f21db778dd046137e0de"),
    12: ({"wgmma": 14592, "tile": 21708, "wide": 4800},
         "c66365b2374f07bc83d3b980ac1b73677b24cf083927f21db778dd046137e0de"),
}


@pytest.mark.parametrize("heads", sorted(TRAIN_TABLES))
def test_training_routes_admit_exactly_the_recorded_shapes(heads, monkeypatch):
    monkeypatch.setattr(_build, "build", lambda *a, **k: pytest.fail("built"))
    rows = []
    for t in TS:
        for d in DS:
            route = fgt.attention_route(t, heads * d, heads)
            assert fgt.check_train_width(t, heads * d, heads) == route
            rows.append(f"{t},{d},{route}")
    assert _table_digest(rows) == TRAIN_TABLES[heads]
