"""The port's copy of ``maps.py`` equals the JAX package's exactly: every
parser on inline ASCII and MovingAI text, the registry (placement masks,
YAML suites, tile stitching), every generator from seeds, and
``sample_instance`` with lifelong goal queues and placement masks."""

import numpy as np
import pytest

from mapf_gpt_tpu import maps as jmaps
from mapf_gpt_tpu_torch import maps as tmaps

ASCII = """
.....#....
.##..#.##.
....@@....
.#$$..!!#.
..........
"""

MOVINGAI = """type octile
height 5
width 7
map
..@....
.T..##.
.......
##.@...
......."""

SCEN = "\n".join([
    "version 1",
    "0\tm.map\t7\t5\t0\t0\t6\t4\t9.0",
    "0\tm.map\t7\t5\t1\t0\t5\t2\t5.0",
    "0\tm.map\t7\t5\t2\t0\t0\t2\t2.0",     # start on '@' (blocked in MovingAI files)
    "0\tm.map\t7\t5\t9\t0\t0\t2\t2.0",     # out of range
    "0\tm.map\t7\t5\t6\t0\t2\t4\t7.0",
    "bad line",
    "0\tm.map\t7\t5\t0\t4\t6\t2\t6.0",
])


def _equal(a, b):
    assert type(a) is type(b) or (isinstance(a, np.ndarray) and isinstance(b, np.ndarray))
    np.testing.assert_array_equal(a, b)
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype


def test_ascii_and_movingai_parsers():
    for got, ref in zip(tmaps.parse_ascii_map_ex(ASCII), jmaps.parse_ascii_map_ex(ASCII)):
        _equal(got, ref)
    _equal(tmaps.parse_ascii_map(ASCII), jmaps.parse_ascii_map(ASCII))
    for got, ref in zip(tmaps.parse_ascii_map_ex(MOVINGAI.split("map\n")[1], movingai=True),
                        jmaps.parse_ascii_map_ex(MOVINGAI.split("map\n")[1], movingai=True)):
        _equal(got, ref)
    grid = tmaps.parse_movingai_map(MOVINGAI)
    _equal(grid, jmaps.parse_movingai_map(MOVINGAI))
    assert tmaps.grid_to_str(grid) == jmaps.grid_to_str(grid)
    for bad in ("..x", "...\n..", ):
        with pytest.raises(ValueError):
            tmaps.parse_ascii_map(bad)
        with pytest.raises(ValueError):
            jmaps.parse_ascii_map(bad)


@pytest.mark.parametrize("num_agents", [None, 2, 3])
def test_scen_parser_and_instance(num_agents):
    grid = tmaps.parse_movingai_map(MOVINGAI)
    for got, ref in zip(tmaps.parse_scen(SCEN, grid, num_agents),
                        jmaps.parse_scen(SCEN, grid, num_agents)):
        _equal(got, ref)
    for pad in (True, False):
        got = tmaps.scen_instance(MOVINGAI, SCEN, num_agents, map_name="m", pad=pad)
        ref = jmaps.scen_instance(MOVINGAI, SCEN, num_agents, map_name="m", pad=pad)
        for f in ("grid", "starts", "goals"):
            _equal(getattr(got, f), getattr(ref, f))
        assert got.map_name == ref.map_name and got.num_agents == ref.num_agents
    with pytest.raises(ValueError, match="valid pairs"):
        tmaps.scen_instance(MOVINGAI, SCEN, 10)


def test_registry_masks_yaml_and_stitching(tmp_path):
    tiles = {f"city_{k:02d}": tmaps.grid_to_str(tmaps.random_grid(6, 0.3, k)) for k in range(4)}
    path = tmp_path / "maps.yaml"
    path.write_text("".join(f"{name}: |-\n" + "".join(f"  {row}\n" for row in text.split("\n"))
                            for name, text in {**tiles, "wh": ASCII.strip()}.items()))
    regs = []
    for maps in (tmaps, jmaps):
        reg = maps.MapRegistry()
        reg.load_reference_suite(str(tmp_path))
        reg.register("plain", maps.random_grid(5, 0.2, 1))
        regs.append(reg)
    got, ref = regs
    assert got.names() == ref.names() and len(got) == len(ref) == 6
    assert "wh" in got and "nope" not in got
    for name in got.names():
        _equal(got[name], ref[name])
        assert (got.masks(name) is None) == (ref.masks(name) is None), name
    for a, b in zip(got.masks("wh"), ref.masks("wh")):
        _equal(a, b)
    _equal(got.stitch_tiles("city", 2), ref.stitch_tiles("city", 2))
    _equal(got["city"], ref["city"])


@pytest.mark.parametrize("seed", [0, 3, 2**33 + 1])
def test_generators(seed):
    for size in (9, 10, 15):
        _equal(tmaps.maze_grid(size, seed), jmaps.maze_grid(size, seed))
    _equal(tmaps.maze_grid(12, seed, wall_components=4, obstacle_density=0.3),
           jmaps.maze_grid(12, seed, wall_components=4, obstacle_density=0.3))
    _equal(tmaps.city_grid(48, seed), jmaps.city_grid(48, seed))
    _equal(tmaps.random_grid(11, 0.25, seed), jmaps.random_grid(11, 0.25, seed))
    _equal(tmaps.warehouse_grid(), jmaps.warehouse_grid())
    _equal(tmaps.warehouse_grid(3, 4, 1, 3, 2, 1), jmaps.warehouse_grid(3, 4, 1, 3, 2, 1))


@pytest.mark.parametrize("k,masked", [(0, False), (5, False), (4, True)])
def test_sample_instance_with_queues_and_masks(k, masked):
    grid, smask, gmask = tmaps.parse_ascii_map_ex(ASCII)
    masks = (smask, gmask) if masked else None
    for seed in (0, 7):
        got = tmaps.sample_instance(grid, 4, seed, map_name="wh", num_lifelong_goals=k,
                                    masks=masks)
        ref = jmaps.sample_instance(grid, 4, seed, map_name="wh", num_lifelong_goals=k,
                                    masks=masks)
        for f in ("grid", "starts", "goals"):
            _equal(getattr(got, f), getattr(ref, f))
        assert (got.lifelong_goals is None) == (k == 0)
        if k:
            _equal(got.lifelong_goals, ref.lifelong_goals)
        assert (got.map_name, got.seed) == (ref.map_name, ref.seed)
    padded = tmaps.pad_grid(grid)
    got = tmaps.sample_instance(padded, 3, 1, pad=False)
    ref = jmaps.sample_instance(padded, 3, 1, pad=False)
    _equal(got.starts, ref.starts)
    with pytest.raises(ValueError, match="border"):
        tmaps.sample_instance(grid, 2, 0, pad=False)
