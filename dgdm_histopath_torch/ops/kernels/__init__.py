"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Each wrapper launches its kernel for a CUDA tensor and runs the plain
version for a CPU tensor; nothing else falls back. ``KERNELS`` lists every
kernel with the counter of its launches.
"""

from .gather_agg import KERNEL as GATHER_AGG
from .gather_agg import KERNEL_BWD as GATHER_AGG_BWD
from .gather_rows import KERNEL as GATHER_ROWS
from .gather_rows import KERNEL_BWD as GATHER_ROWS_BWD

KERNELS = {"gather_rows": GATHER_ROWS, "gather_agg": GATHER_AGG,
           "gather_rows_bwd": GATHER_ROWS_BWD, "gather_agg_bwd": GATHER_AGG_BWD}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> dict:
    return {name: k.launches for name, k in KERNELS.items()}
