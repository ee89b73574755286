"""SMPL kinematic-tree tables and level scheduling for the structure encoder.

Mirror of ``posendf_tpu/kinematics.py`` (pure Python, no framework). The
reference walks 21 per-joint MLPs in index order, each consuming its
parent's feature, with the parent table

    [-1, -1, -1, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19]

that trained checkpoints bake in; the corrected SMPL tree is available
behind ``corrected=True``. ``level_schedule`` groups joints into dependency
levels so the module path runs one batched product per level (depth 12
instead of 21).
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Sequence, Tuple

__all__ = [
    "NUM_BODY_JOINTS",
    "REFERENCE_PARENTS",
    "CORRECTED_PARENTS",
    "SMPL_FULL_PARENTS",
    "parent_table",
    "level_schedule",
]

NUM_BODY_JOINTS = 21

# Exact table the pretrained reference checkpoints were trained with. -1 marks
# a root joint. Every parent index is smaller than its child's.
REFERENCE_PARENTS: Tuple[int, ...] = (
    -1, -1, -1, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19,
)

# True SMPL body tree with the pelvis removed and indices shifted down by one.
CORRECTED_PARENTS: Tuple[int, ...] = (
    -1, -1, -1, 0, 1, 2, 3, 4, 5, 6, 7, 8, 8, 8, 11, 12, 13, 15, 16, 17, 18,
)


# The full 24-joint SMPL kinematic tree (pelvis = 0), as smplx's kintree_table;
# the body model's forward kinematics walks it.
SMPL_FULL_PARENTS: Tuple[int, ...] = (
    -1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19,
    20, 21,
)


def parent_table(corrected: bool = False) -> Tuple[int, ...]:
    """The 21-joint parent table for the structure encoder."""
    return CORRECTED_PARENTS if corrected else REFERENCE_PARENTS


@lru_cache(maxsize=None)
def level_schedule(parents: Sequence[int]) -> Tuple[Tuple[Tuple[int, ...], Tuple[int, ...]], ...]:
    """Group joints into dependency levels for batched evaluation.

    Returns a tuple of levels; each level is ``(joint_ids, parent_ids)`` with
    ``parent_ids[i] == 0`` substituted for roots (roots read a zero feature
    vector instead). Every joint appears exactly once, a joint's parent is in
    a strictly earlier level, and levels keep ascending joint order.
    """
    parents = tuple(parents)
    depth = {}
    for j, p in enumerate(parents):
        if p == -1:
            depth[j] = 0
        else:
            if p >= j:
                raise ValueError(f"parent table is not topologically ordered at joint {j}")
            depth[j] = depth[p] + 1

    num_levels = max(depth.values()) + 1
    levels: List[Tuple[Tuple[int, ...], Tuple[int, ...]]] = []
    for d in range(num_levels):
        joint_ids = tuple(j for j in range(len(parents)) if depth[j] == d)
        parent_ids = tuple(max(parents[j], 0) for j in joint_ids)
        levels.append((joint_ids, parent_ids))
    return tuple(levels)
