"""Chiplet placements (paper §IV, §VI, Figs. 6 & 9).

Two placement families:
  * rectangular grid  — rows x cols of square chiplets (Fig. 6a),
  * brick-wall / hexagonal — odd rows offset by half a pitch so every
    chiplet touches six neighbours (HexaMesh arrangement, Fig. 6b),
  * hex spiral — hexagon-shaped region filled ring by ring (used to check
    the Table-III diameter formulas at perfect-hex N = 3R^2+3R+1).

Positions are chiplet centres in *pitch units*; `pitch_mm()` converts to mm
(pitch = chiplet side + chiplet spacing, per substrate).

Heterogeneous roles (paper §V-C Fig. 6 and §V-E Fig. 9):
  'C' compute, 'M' memory (leftmost/rightmost columns), 'I' IO (top/bottom
  rows; traces experiment only).
"""
from __future__ import annotations

import numpy as np

from .linkmodel import SUBSTRATE_PARAMS


def chiplet_side_mm(chiplet_area_mm2: float) -> float:
    return float(np.sqrt(chiplet_area_mm2))


def pitch_mm(chiplet_area_mm2: float, substrate: str) -> float:
    return chiplet_side_mm(chiplet_area_mm2) + \
        SUBSTRATE_PARAMS[substrate]["chiplet_spacing_mm"]


def grid_dims(n: int) -> tuple[int, int]:
    """Most-square factorization r*c == n (r <= c)."""
    best = (1, n)
    for r in range(1, int(np.sqrt(n)) + 1):
        if n % r == 0:
            best = (r, n // r)
    return best


def grid_positions(rows: int, cols: int, brick: bool = False) -> np.ndarray:
    """[N,2] centre positions in pitch units; brick=True offsets odd rows."""
    pos = np.zeros((rows * cols, 2))
    for i in range(rows):
        for j in range(cols):
            x = j + (0.5 if (brick and i % 2 == 1) else 0.0)
            pos[i * cols + j] = (x, i)
    return pos


def hex_spiral_positions(n: int) -> np.ndarray:
    """Hexagon-shaped region filled ring by ring from the centre.

    Axial coordinates (q, r); position x = q + r/2, y = r (brick-wall
    geometry with square chiplets).  Supports arbitrary n; perfect-hex
    counts are n = 3R^2+3R+1.
    """
    axial = [(0, 0)]
    ring = 1
    # axial direction vectors in ring-walk order for a start at (ring,-ring)
    dirs = [(0, 1), (-1, 1), (-1, 0), (0, -1), (1, -1), (1, 0)]
    while len(axial) < n:
        q, r = ring, -ring  # start corner of this ring (north-east)
        for d in range(6):
            for _ in range(ring):
                if len(axial) < n:
                    axial.append((q, r))
                q, r = q + dirs[d][0], r + dirs[d][1]
        ring += 1
    axial = np.array(axial[:n], dtype=np.float64)
    pos = np.stack([axial[:, 0] + axial[:, 1] / 2.0, axial[:, 1]], axis=-1)
    return pos


def assign_roles(pos: np.ndarray, scheme: str = "homogeneous",
                 mem_cols: int = 1, io_rows: int = 1) -> np.ndarray:
    """Return an array of roles 'C'/'M'/'I' per chiplet.

    'hetero_cm'  — memory chiplets in the leftmost and rightmost columns
                   (Fig. 6); 'hetero_cmi' — additionally IO chiplets in the
                   top and bottom rows (Fig. 9).
    """
    n = pos.shape[0]
    roles = np.full(n, "C", dtype="<U1")
    if scheme == "homogeneous":
        return roles
    xs, ys = pos[:, 0], pos[:, 1]
    # Fractional bands at the extremes; the 0.25 slack keeps brick-wall
    # half-pitch offsets inside the same logical column.
    x_min, x_max = xs.min(), xs.max()
    roles[xs <= x_min + mem_cols - 0.25] = "M"
    roles[xs >= x_max - mem_cols + 0.25] = "M"
    if scheme == "hetero_cmi":
        y_min, y_max = ys.min(), ys.max()
        roles[ys <= y_min + io_rows - 0.75] = "I"
        roles[ys >= y_max - io_rows + 0.75] = "I"
    return roles
