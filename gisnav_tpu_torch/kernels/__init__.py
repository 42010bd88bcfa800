"""Hand-written CUDA kernels of the port and their launch counts.

Each kernel wrapper adds one to its entry in ``LAUNCHES`` for every kernel
launch the card accepted (never when it runs the plain PyTorch version for a
CPU tensor), so a run can show that its main path went through them. A stem
call is 1 launch (conv1a inside conv1b), a two-conv stage 2 and a one-conv
stage 1, a fused block 2 (attention, FFN epilogue), a masked attention 2
(row statistics, P.V), and an NMS-select, an NMS cell-max and a shear pass
along either axis 1 each.
"""
from __future__ import annotations

from typing import Dict

__all__ = ["LAUNCHES", "reset_launches"]

LAUNCHES: Dict[str, int] = {
    "stem_stage": 0,
    "conv_stage": 0,
    "nms_select": 0,
    "fused_block": 0,
    "masked_attention": 0,
    "shear_last_axis": 0,
    "shear_first_axis": 0,
    "nms_cellmax": 0,
}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0
