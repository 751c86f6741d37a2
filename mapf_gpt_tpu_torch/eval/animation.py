"""SVG episode animation — the AnimationMonitor equivalent.

The port's copy of ``mapf_gpt_tpu/eval/animation.py`` (numpy only).

The reference saves SMIL-animated SVG renders of episodes via pogema's
AnimationMonitor (ref:example.py:68-70, ref:experiment_setup/create_env.py:42-45).
This is an independent renderer over recorded position histories: obstacles as
rounded squares, agents as colored circles animated along their trajectories,
goals as rings in the agent's color.
"""

from __future__ import annotations

import numpy as np

_CELL = 10.0
_R = 3.5
_PALETTE = ["#c1433c", "#2e6f9e", "#6db753", "#b0883f", "#8d5fd3",
            "#d077b0", "#52b8ad", "#8a8a33", "#d2742f", "#5f74d3"]


def render_episode_svg(grid: np.ndarray, positions: np.ndarray,
                       goals: np.ndarray, active: np.ndarray | None = None,
                       step_s: float = 0.25, trim_border: int = 0) -> str:
    """Build an animated SVG string.

    grid: bool [H, W]; positions: int [T, A, 2]; goals: int [A, 2];
    active: bool [A] (inactive slots are not drawn); trim_border crops the
    obstacle padding for display.
    """
    grid = np.asarray(grid, dtype=bool)
    positions = np.asarray(positions)
    goals = np.asarray(goals)
    t_len, a, _ = positions.shape
    if active is None:
        active = np.ones((a,), dtype=bool)
    b = trim_border
    h, w = grid.shape
    view = grid[b:h - b if b else h, b:w - b if b else w]
    vh, vw = view.shape

    def cx(col):  # svg x from grid col
        return (col - b + 0.5) * _CELL

    def cy(row):
        return (row - b + 0.5) * _CELL

    parts = [
        f'<svg xmlns="http://www.w3.org/2000/svg" '
        f'width="{vw * _CELL}" height="{vh * _CELL}" '
        f'viewBox="0 0 {vw * _CELL} {vh * _CELL}">',
        f'<rect width="{vw * _CELL}" height="{vh * _CELL}" fill="white"/>',
    ]
    for i in range(vh):
        for j in range(vw):
            if view[i, j]:
                parts.append(
                    f'<rect x="{j * _CELL + 0.6:.1f}" y="{i * _CELL + 0.6:.1f}" '
                    f'width="{_CELL - 1.2:.1f}" height="{_CELL - 1.2:.1f}" '
                    f'rx="1.5" fill="#84a58c"/>')
    dur = max(t_len - 1, 1) * step_s
    for k in range(a):
        if not active[k]:
            continue
        color = _PALETTE[k % len(_PALETTE)]
        parts.append(
            f'<circle cx="{cx(goals[k, 1]):.1f}" cy="{cy(goals[k, 0]):.1f}" '
            f'r="{_R:.1f}" fill="none" stroke="{color}" stroke-width="1.2"/>')
        xs = ";".join(f"{cx(positions[t, k, 1]):.1f}" for t in range(t_len))
        ys = ";".join(f"{cy(positions[t, k, 0]):.1f}" for t in range(t_len))
        parts.append(
            f'<circle cx="{cx(positions[0, k, 1]):.1f}" '
            f'cy="{cy(positions[0, k, 0]):.1f}" r="{_R:.1f}" fill="{color}">'
            f'<animate attributeName="cx" dur="{dur:.2f}s" values="{xs}" '
            f'repeatCount="indefinite"/>'
            f'<animate attributeName="cy" dur="{dur:.2f}s" values="{ys}" '
            f'repeatCount="indefinite"/></circle>')
    parts.append("</svg>")
    return "\n".join(parts)


def save_episode_svg(path: str, *args, **kwargs) -> str:
    svg = render_episode_svg(*args, **kwargs)
    with open(path, "w") as f:
        f.write(svg)
    return path
