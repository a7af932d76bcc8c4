"""Movement verbalization (a 7-DoF delta -> a movement string), port of
``emmax_tpu/gcot/verbalize.py``.

xyz is scaled by 1000, the orientation by 180/pi, and the gripper is
thresholded at 0.5. The reference's quirk is kept: yaw verbalizes as "yaw
clockwise/counterclockwise", which the Solver's movement grammar does not
parse (it reads "yaw downward/upward" and "rotate_*").
"""

from __future__ import annotations

import math
from typing import Sequence

_NAMES = [
    {False: "move backward", True: "move forward"},
    {False: "move right", True: "move left"},
    {False: "move downward", True: "move upward"},
    {False: "roll downward", True: "roll upward"},
    {False: "pitch downward", True: "pitch upward"},
    {False: "yaw clockwise", True: "yaw counterclockwise"},
    {False: "close gripper", True: "open gripper"},
]


def describe_move(move_vec: Sequence[float]) -> str:
    if len(move_vec) != 7:
        raise ValueError(f"expected a 7-DoF move, got {len(move_vec)} values")
    parts = []
    for i, mv in enumerate(move_vec):
        mv = float(mv)
        if i < 3:  # xyz in metres -> millimetre "steps"
            parts.append(_NAMES[i][mv > 0] + f" {abs(round(mv * 1000))} steps; ")
        elif i < 6:  # orientation in radians -> degree "steps"
            parts.append(_NAMES[i][mv > 0]
                         + f" {abs(round(mv * 180 / math.pi))} steps; ")
        else:  # gripper
            parts.append(_NAMES[i][mv > 0.5] + ";")
    return "".join(parts)
