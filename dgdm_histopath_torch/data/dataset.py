"""Datasets: graph / slide / patch discovery, loading, caching, augmentation
(counterpart of the JAX package's ``data/dataset.py``).

``HistopathDataset`` discovers files by extension (sorted) and caches loaded
graphs; ``SlideDataset`` turns slides into graphs on the fly through a
``SlideProcessor`` and a ``TissueGraphBuilder`` (or reads preprocessed graph
files), with an all-padding graph of the first bucket when a slide fails;
``GraphDataset`` subsamples nodes by re-masking. Items are ``PaddedGraph``s
of one node bucket each; augmentations are numpy on the host, before the
featurizer. Graphs loaded from files are on the host; graphs built from
slides are on the builder's device.
"""

from __future__ import annotations

import csv
import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..ops.graph import PaddedGraph, gather_scalar
from ..preprocessing.slide_processor import SlideProcessor
from ..preprocessing.tissue_graph_builder import TissueGraphBuilder
from ..utils.exceptions import DataError
from ..utils.logging import get_logger
from .graph_io import GRAPH_SUFFIX, load_graph, save_graph

logger = get_logger("data")

SLIDE_EXTENSIONS = (".svs", ".tiff", ".tif", ".ndpi", ".mrxs", ".wsi")
GRAPH_EXTENSIONS = (".npz", ".h5", ".hdf5")
PATCH_EXTENSIONS = (".png", ".jpg", ".jpeg")


def augment_patches(patches: np.ndarray, level: str, rng: np.random.RandomState
                    ) -> np.ndarray:
    """'none' | 'light' (flips, rot90) | 'strong' (+ brightness/contrast
    jitter and gaussian noise) on [P, H, W, C] uint8 patches."""
    if level == "none" or patches.size == 0:
        return patches
    out = patches
    if rng.rand() < 0.5:
        out = out[:, :, ::-1]           # horizontal flip
    if rng.rand() < 0.5:
        out = out[:, ::-1]              # vertical flip
    k = rng.randint(0, 4)
    if k:
        out = np.rot90(out, k, axes=(1, 2))
    if level == "strong":
        f = out.astype(np.float32)
        f = f * rng.uniform(0.9, 1.1) + rng.uniform(-10, 10)       # brightness/contrast
        f = f + rng.randn(*f.shape).astype(np.float32) * 2.0        # gaussian noise
        out = np.clip(f, 0, 255).astype(np.uint8)
    return np.ascontiguousarray(out)


def empty_graph(feature_dim: int, bucket: int, max_neighbors: int = 24,
                edge_dim: int = 3, y=None) -> PaddedGraph:
    """An all-padding graph (no real node) of one bucket's shape, on the host."""
    return PaddedGraph(
        x=torch.zeros((bucket, feature_dim)), pos=torch.zeros((bucket, 2)),
        nbr_idx=torch.zeros((bucket, max_neighbors), dtype=torch.int32),
        nbr_mask=torch.zeros((bucket, max_neighbors), dtype=torch.bool),
        edge_attr=torch.zeros((bucket, max_neighbors, edge_dim)),
        node_mask=torch.zeros((bucket,), dtype=torch.bool),
        y=None if y is None else torch.as_tensor(y))


def load_labels(metadata_path: str | Path) -> Dict[str, int]:
    """slide_id -> label from a .json or .csv metadata file (csv: the first
    of slide_id / id / name as the key column, else the first column; the
    first of label / y / target / class as the label, else the last)."""
    path = Path(metadata_path)
    if not path.exists():
        raise DataError("metadata file not found", {"path": str(path)})
    if path.suffix == ".json":
        raw = json.loads(path.read_text())
        return {str(k): int(v) for k, v in raw.items()}
    if path.suffix == ".csv":
        out = {}
        with open(path) as f:
            reader = csv.DictReader(f)
            fields = reader.fieldnames or []
            id_col = next((c for c in ("slide_id", "id", "name") if c in fields), fields[0])
            label_col = next((c for c in ("label", "y", "target", "class") if c in fields),
                             fields[-1])
            for row in reader:
                out[str(row[id_col])] = int(float(row[label_col]))
        return out
    raise DataError("unsupported metadata format", {"path": str(path)})


def _with_label(g: PaddedGraph, label) -> PaddedGraph:
    if label is not None and g.y is None:
        return g.replace(y=torch.tensor(label, dtype=torch.int32, device=g.x.device))
    return g


class HistopathDataset:
    """File-discovery dataset over graphs / slides / patches. Labels are
    looked up by file stem with ``_graph`` removed."""

    def __init__(self, data_dir: str | Path, dataset_type: str = "graph",
                 metadata_path: Optional[str | Path] = None, augmentations: str = "none",
                 cache_graphs: bool = True, max_items: Optional[int] = None, seed: int = 0):
        self.data_dir = Path(data_dir)
        if not self.data_dir.exists():
            raise DataError("data directory not found", {"path": str(self.data_dir)})
        self.dataset_type = dataset_type
        self.augmentations = augmentations
        self.cache_graphs = cache_graphs
        self._cache: Dict[int, PaddedGraph] = {}
        self._rng = np.random.RandomState(seed)

        exts = {"graph": GRAPH_EXTENSIONS, "slide": SLIDE_EXTENSIONS,
                "patch": PATCH_EXTENSIONS}.get(dataset_type)
        if exts is None:
            raise DataError(f"unknown dataset_type {dataset_type!r}")
        self.files: List[Path] = sorted(
            p for p in self.data_dir.rglob("*") if p.suffix.lower() in exts)
        if max_items is not None:
            self.files = self.files[:max_items]
        self.labels: Dict[str, int] = {}
        if metadata_path is not None:
            self.labels = load_labels(metadata_path)

    def __len__(self) -> int:
        return len(self.files)

    def label_for(self, path: Path):
        return self.labels.get(path.stem.replace("_graph", ""), None)

    def __getitem__(self, idx: int) -> PaddedGraph:
        if self.cache_graphs and idx in self._cache:
            return self._cache[idx]
        path = self.files[idx]
        if self.dataset_type != "graph":
            raise DataError("use SlideDataset/PatchDataset for non-graph types")
        g = _with_label(load_graph(path), self.label_for(path))
        if self.cache_graphs:
            self._cache[idx] = g
        return g


class SlideDataset:
    """On-the-fly (or preprocessed) slide -> graph dataset."""

    def __init__(self, slide_paths: Sequence[str | Path],
                 processor: Optional[SlideProcessor] = None,
                 graph_builder: Optional[TissueGraphBuilder] = None,
                 labels: Optional[Dict[str, int]] = None,
                 preprocessed_dir: Optional[str | Path] = None, cache_graphs: bool = True,
                 augmentations: str = "none", seed: int = 0):
        self.slide_paths = [Path(p) for p in slide_paths]
        self.processor = processor or SlideProcessor()
        self.graph_builder = graph_builder or TissueGraphBuilder()
        self.labels = labels or {}
        self.preprocessed_dir = Path(preprocessed_dir) if preprocessed_dir else None
        self.cache_graphs = cache_graphs
        self.augmentations = augmentations
        self._cache: Dict[int, PaddedGraph] = {}
        self._rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        return len(self.slide_paths)

    def _graph_path(self, slide_path: Path) -> Optional[Path]:
        if self.preprocessed_dir is None:
            return None
        return self.preprocessed_dir / f"{slide_path.stem}{GRAPH_SUFFIX}"

    def preprocess_all(self, output_dir: str | Path, num_workers: int = 1) -> List[Path]:
        """Offline slide -> graph pass; later items load the written files.
        A slide whose graph file exists is skipped; a slide that fails is
        logged and left out. ``num_workers > 1`` runs slides in that many
        threads (``utils.distributed_processing.process_batch``): decode and
        tiling overlap, the device work of each slide queues on the card."""
        out_dir = Path(output_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        self.preprocessed_dir = out_dir

        def work(path: Path) -> Optional[Path]:
            target = out_dir / f"{path.stem}{GRAPH_SUFFIX}"
            if target.exists():
                return target
            try:
                return save_graph(self._build(path), target)
            except Exception as exc:  # noqa: BLE001 - one bad slide does not stop the pass
                logger.error("preprocess failed for %s: %s", path, exc)
                return None

        if num_workers <= 1:
            results = [work(p) for p in self.slide_paths]
        else:
            from ..utils.distributed_processing import process_batch
            results = process_batch(work, self.slide_paths, num_workers=num_workers)
        return [r for r in results if r is not None]

    def _build(self, slide_path: Path) -> PaddedGraph:
        data = self.processor.process_slide(slide_path)
        if self.augmentations != "none" and data.patches.size:
            data.patches = augment_patches(data.patches, self.augmentations, self._rng)
        return self.graph_builder.build_graph(data, label=self.labels.get(slide_path.stem))

    def __getitem__(self, idx: int) -> PaddedGraph:
        if self.cache_graphs and idx in self._cache:
            return self._cache[idx]
        path = self.slide_paths[idx]
        g: Optional[PaddedGraph] = None
        pre = self._graph_path(path)
        if pre is not None and pre.exists():
            g = _with_label(load_graph(pre), self.labels.get(path.stem))
        if g is None:
            try:
                g = self._build(path)
            except Exception as exc:  # noqa: BLE001 - a failed slide becomes an empty graph
                logger.error("slide %s failed, returning empty graph: %s", path, exc)
                b = self.graph_builder
                g = empty_graph(b.feature_dim, b.node_buckets[0],
                                max_neighbors=b.k_spatial + b.k_morphological,
                                y=self.labels.get(path.stem))
        if self.cache_graphs:
            self._cache[idx] = g
        return g


class GraphDataset:
    """Preprocessed-graph dataset with random node subsampling to
    ``max_nodes``."""

    def __init__(self, graph_paths: Sequence[str | Path],
                 labels: Optional[Dict[str, int]] = None,
                 max_nodes: Optional[int] = None, seed: int = 0):
        self.paths = [Path(p) for p in graph_paths]
        self.labels = labels or {}
        self.max_nodes = max_nodes
        self._rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, idx: int) -> PaddedGraph:
        g = _with_label(load_graph(self.paths[idx]),
                        self.labels.get(self.paths[idx].stem.replace("_graph", "")))
        if self.max_nodes is not None and int(g.node_mask.sum()) > self.max_nodes:
            g = self.subsample_nodes(g, self.max_nodes, self._rng)
        return g

    @staticmethod
    def subsample_nodes(g: PaddedGraph, max_nodes: int,
                        rng: np.random.RandomState) -> PaddedGraph:
        """Keep ``max_nodes`` real nodes drawn at random by re-masking: edges
        from or into a dropped node are masked, the shape stays."""
        mask = g.node_mask.cpu().numpy()
        keep = rng.choice(np.nonzero(mask)[0], max_nodes, replace=False)
        new_mask = np.zeros_like(mask)
        new_mask[keep] = True
        new_mask_t = torch.from_numpy(new_mask).to(g.node_mask.device)
        src_ok = gather_scalar(new_mask_t.int(), g.nbr_idx) > 0
        return g.replace(node_mask=new_mask_t,
                         nbr_mask=g.nbr_mask & src_ok & new_mask_t[..., None])
