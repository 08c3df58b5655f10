"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Each wrapper launches its kernel for a CUDA tensor and runs the plain
version for a CPU tensor; nothing else falls back. ``KERNELS`` lists every
kernel with the counter of its launches.
"""

from .flash_spatial import KERNEL_HEADMAJOR as FLASH_SPATIAL
from .flash_spatial import KERNEL_PACKED as FLASH_SPATIAL_PACKED
from .gather_agg import KERNEL as GATHER_AGG
from .gather_agg import KERNEL_BWD as GATHER_AGG_BWD
from .gather_rows import KERNEL as GATHER_ROWS
from .gather_rows import KERNEL_BWD as GATHER_ROWS_BWD
from .neighbor_transpose import KERNEL as NEIGHBOR_TRANSPOSE

KERNELS = {"gather_rows": GATHER_ROWS, "gather_agg": GATHER_AGG,
           "gather_rows_bwd": GATHER_ROWS_BWD, "gather_agg_bwd": GATHER_AGG_BWD,
           "neighbor_transpose": NEIGHBOR_TRANSPOSE,
           "flash_spatial_packed": FLASH_SPATIAL_PACKED, "flash_spatial": FLASH_SPATIAL}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> dict:
    return {name: k.launches for name, k in KERNELS.items()}
