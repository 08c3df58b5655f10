"""Data layer: graph files, datasets, and the bucketed loader."""

from .datamodule import BucketedLoader, HistopathDataModule
from .dataset import (
    GraphDataset,
    HistopathDataset,
    SlideDataset,
    augment_patches,
    empty_graph,
    load_labels,
)
from .graph_io import GRAPH_SUFFIX, load_graph, load_graph_h5, save_graph

__all__ = [
    "HistopathDataset", "SlideDataset", "GraphDataset", "augment_patches",
    "empty_graph", "load_labels",
    "HistopathDataModule", "BucketedLoader",
    "save_graph", "load_graph", "load_graph_h5", "GRAPH_SUFFIX",
]
