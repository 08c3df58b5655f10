"""Preprocessing: slide reading, tissue detection, patches, stain
normalization, tissue graphs and synthetic slides (the JAX package's
``preprocessing`` exports, from the port's modules)."""

from .slide_io import (
    SlideBackend, ArrayBackend, PILTiffBackend, open_slide, OPENSLIDE_AVAILABLE,
)
from .slide_processor import SlideProcessor, SlideData, PatchInfo
from .tissue_detection import TissueDetector, compute_tissue_mask, TissueStats
from .stain_normalization import (
    StainNormalizer, macenko_normalize_batch, reinhard_normalize_batch,
    estimate_stain_matrix, stain_concentrations, rgb_to_od, od_to_rgb,
)
from .tissue_graph_builder import TissueGraphBuilder
from .synthetic import synthetic_slide, write_synthetic_tiff, generate_tissue_image

__all__ = [
    "SlideBackend", "ArrayBackend", "PILTiffBackend", "open_slide",
    "OPENSLIDE_AVAILABLE",
    "SlideProcessor", "SlideData", "PatchInfo",
    "TissueDetector", "compute_tissue_mask", "TissueStats",
    "StainNormalizer", "macenko_normalize_batch", "reinhard_normalize_batch",
    "estimate_stain_matrix", "stain_concentrations", "rgb_to_od", "od_to_rgb",
    "TissueGraphBuilder",
    "synthetic_slide", "write_synthetic_tiff", "generate_tissue_image",
]
