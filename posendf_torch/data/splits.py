"""AMASS dataset split registry.

A copy of ``posendf_tpu/data/splits.py`` (the port imports nothing of the
JAX package): the reference's split assignment (``data/data_splits.py:2-10``).
"""

from __future__ import annotations

from typing import Dict, List

__all__ = ["AMASS_SPLITS"]

AMASS_SPLITS: Dict[str, List[str]] = {
    "train": [
        "ACCAD", "BMLhandball", "BMLmovi", "BioMotionLab_NTroje", "CMU",
        "EKUT", "Eyes_Japan_Dataset", "KIT", "MPI_Limits", "TCD_handMocap",
        "TotalCapture",
    ],
    "vald": ["HumanEva", "MPI_HDM05", "SFU", "MPI_mosh"],
    "test": ["Transitions_mocap", "SSM_synced"],
}
