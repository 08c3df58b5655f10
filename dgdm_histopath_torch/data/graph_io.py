"""Tissue graphs on disk: ``.npz`` (this package's and the JAX package's
schema) and the reference's HDF5 layout (read only).

Counterpart of the JAX package's ``data/graph_io.py``. Loaded graphs are
PaddedGraphs of CPU tensors; the caller moves them.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..ops.graph import PaddedGraph, from_edge_index
from ..utils.exceptions import DataError

GRAPH_SUFFIX = "_graph.npz"
_ARRAYS = ("x", "pos", "nbr_idx", "nbr_mask", "edge_attr", "node_mask")


def save_graph(graph: PaddedGraph, path: str | Path) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays = {f: getattr(graph, f).detach().cpu().numpy() for f in _ARRAYS}
    if graph.y is not None:
        arrays["y"] = graph.y.detach().cpu().numpy()
    np.savez_compressed(path, **arrays)
    return path


def load_graph(path: str | Path) -> PaddedGraph:
    path = Path(path)
    if path.suffix == ".npz":
        with np.load(path) as data:
            fields = {f: torch.from_numpy(data[f]) for f in _ARRAYS}
            y = torch.from_numpy(data["y"]) if "y" in data.files else None
        return PaddedGraph(**fields, y=y)
    if path.suffix in (".h5", ".hdf5"):
        return load_graph_h5(path)
    raise DataError("unsupported graph format", {"path": str(path)})


def load_graph_h5(path: str | Path, max_neighbors: int = 16,
                  bucket: Optional[int] = None) -> PaddedGraph:
    """Read the reference's HDF5 graph layout: datasets ``node_features`` /
    ``edge_index`` / optional ``edge_attr`` / ``pos`` / ``label``."""
    import h5py
    with h5py.File(path, "r") as f:
        def pick(*names):
            for n in names:
                if n in f:
                    return f[n][()]
            return None
        x = pick("node_features", "x", "features")
        if x is None:
            raise DataError("h5 graph missing node features", {"path": str(path)})
        edge_index = pick("edge_index", "edges")
        pos = pick("pos", "coordinates", "coords")
        edge_attr = pick("edge_attr", "edge_features")
        y = pick("label", "y")
        if edge_index is None:
            edge_index = np.zeros((2, 0), np.int64)
        if edge_index.shape[0] != 2:
            edge_index = edge_index.T
        return from_edge_index(
            np.asarray(x, np.float32), np.asarray(edge_index, np.int64),
            pos=None if pos is None else np.asarray(pos, np.float32),
            edge_attr=None if edge_attr is None else np.asarray(edge_attr, np.float32),
            max_neighbors=max_neighbors, bucket=bucket,
            y=None if y is None else np.asarray(y))
