"""TissueGraphBuilder: patches -> features -> kNN tissue graph (PaddedGraph).

Counterpart of the JAX package's ``preprocessing/tissue_graph_builder.py``:
features from the patch featurizer in large device batches (or the 5-d
placeholder features of a slide without images: x, y, tissue fraction,
magnification / 40, level), patch centres normalized to [0, 1], uniform
subsampling into the largest bucket, optional Morton ordering and a
Morton-band limit on both searches (for windowed / banded models), the dual
kNN on the device (``ops.knn.build_dual_knn``: 8 spatial + 16 morphological
neighbours), and degree-based coarsening.

Graphs come out on the builder's ``device`` (``None`` means ``"cuda"``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.vit import PatchFeatureExtractor
from ..ops.graph import PaddedGraph, morton_keys, pick_bucket
from ..ops.knn import build_dual_knn
from ..utils.device import resolve_device
from ..utils.exceptions import GraphConstructionError
from .slide_processor import SlideData

PLACEHOLDER_DIM = 5   # imageless node features


class TissueGraphBuilder:
    """Build padded tissue graphs from processed slide data.

    ``extractor``: a featurizer to use; without one, the first call that
    needs features builds ``PatchFeatureExtractor(feature_extractor, ...)``
    on the builder's device, normalizing stains on the device when
    ``stain_normalize_on_device``, computing int8 with ``quant="int8"``.
    """

    def __init__(
        self,
        feature_extractor: str = "dinov2",
        k_spatial: int = 8,
        k_morphological: int = 16,
        spatial_decay: float = 10.0,
        node_buckets: Sequence[int] = (128, 256, 512, 1024, 2048),
        feature_batch_size: int = 256,
        extractor: Optional[PatchFeatureExtractor] = None,
        spatial_sort: bool = False,
        knn_window: Optional[int] = None,
        per_slide_feature_norm: bool = False,
        stain_normalize_on_device: bool = False,
        quant: Optional[str] = None,
        device=None,
    ):
        if knn_window is not None and not spatial_sort:
            raise ValueError("knn_window requires spatial_sort=True")
        self.k_spatial = k_spatial
        self.k_morphological = k_morphological
        self.spatial_decay = spatial_decay
        self.node_buckets = list(node_buckets)
        self.feature_extractor_name = feature_extractor
        self._extractor = extractor
        self._extractor_batch = feature_batch_size
        self.stain_normalize_on_device = stain_normalize_on_device
        self.quant = quant
        # Morton-order the nodes before the searches; with knn_window both
        # searches keep to each node's ±1 Morton block band, so every edge
        # is one a banded model (graph_window=knn_window) addresses
        self.spatial_sort = spatial_sort
        self.knn_window = knn_window
        # z-score node features within each slide (robust centre: median)
        self.per_slide_feature_norm = per_slide_feature_norm
        self.device = resolve_device(device)

    @property
    def extractor(self) -> Optional[PatchFeatureExtractor]:
        if self._extractor is None and self.feature_extractor_name not in ("none", None):
            self._extractor = PatchFeatureExtractor(
                arch=self.feature_extractor_name, batch_size=self._extractor_batch,
                stain_normalize_on_device=self.stain_normalize_on_device,
                quant=self.quant, device=self.device)
        return self._extractor

    @property
    def feature_dim(self) -> int:
        if self.feature_extractor_name in ("none", None):
            return PLACEHOLDER_DIM
        return self.extractor.feature_dim

    def extract_patch_features(self, patches: np.ndarray) -> np.ndarray:
        return self.extractor.extract(patches)

    @staticmethod
    def normalize_coordinates(infos, slide_dims: Tuple[int, int]) -> np.ndarray:
        """Patch centres normalized to [0, 1]."""
        w0, h0 = slide_dims
        out = np.zeros((len(infos), 2), np.float32)
        for i, p in enumerate(infos):
            half = p.size / 2.0
            out[i, 0] = (p.x + half) / max(w0, 1)
            out[i, 1] = (p.y + half) / max(h0, 1)
        return out

    def placeholder_features(self, infos, pos: np.ndarray) -> np.ndarray:
        """5-d imageless node features: (x, y, tissue_frac, mag/40, level)."""
        out = np.zeros((len(infos), PLACEHOLDER_DIM), np.float32)
        out[:, 0:2] = pos
        for i, p in enumerate(infos):
            out[i, 2] = p.tissue_fraction
            out[i, 3] = p.magnification / 40.0
            out[i, 4] = float(p.level)
        return out

    def build_graph(self, slide_data: SlideData, label=None, bucket: Optional[int] = None,
                    features: Optional[np.ndarray] = None) -> PaddedGraph:
        """SlideData -> PaddedGraph on the builder's device. ``features``:
        node features computed already (the pipelined predictor's)."""
        infos = slide_data.patch_info
        n = len(infos)
        if n == 0:
            raise GraphConstructionError("slide has no patches", {"slide": slide_data.slide_id})
        dims = slide_data.metadata.get("dimensions", [1, 1])
        pos = self.normalize_coordinates(infos, (dims[0], dims[1]))

        if features is None:
            if (self.feature_extractor_name in ("none", None)
                    or slide_data.patches.size == 0):
                features = self.placeholder_features(infos, pos)
            else:
                features = self.extract_patch_features(slide_data.patches)
        features = np.asarray(features, np.float32)
        if self.per_slide_feature_norm:
            features = ((features - np.median(features, axis=0))
                        / (features.std(axis=0) + 1e-6))

        target = bucket if bucket is not None else pick_bucket(n, self.node_buckets)
        if n > target:                 # uniform node subsample into the bucket
            idx = np.linspace(0, n - 1, target).astype(int)
            features, pos = features[idx], pos[idx]
            n = target

        pad = target - n
        x = np.pad(features, ((0, pad), (0, 0)))
        p = np.pad(pos, ((0, pad), (0, 0)))
        node_mask = np.zeros((target,), bool)
        node_mask[:n] = True
        if self.spatial_sort:          # pad rows keep the largest key: still last
            order = np.argsort(morton_keys(p, node_mask), kind="stable")
            x, p = x[order], p[order]

        dev = self.device
        x_t, p_t = torch.from_numpy(x).to(dev), torch.from_numpy(p).to(dev)
        mask_t = torch.from_numpy(node_mask).to(dev)
        knn = build_dual_knn(p_t, x_t, mask_t, k_spatial=self.k_spatial,
                             k_morph=self.k_morphological, decay=self.spatial_decay,
                             band_window=self.knn_window)
        y = None if label is None else torch.as_tensor(label, device=dev)
        return PaddedGraph(x=x_t, pos=p_t, nbr_idx=knn["nbr_idx"], nbr_mask=knn["nbr_mask"],
                           edge_attr=knn["edge_attr"], node_mask=mask_t, y=y)

    def coarsen_graph(self, graph: PaddedGraph, ratio: float = 0.5) -> PaddedGraph:
        """Keep the top-``ratio`` real nodes by degree and rebuild the kNN
        over them; the padded shape stays, dropped nodes become padding."""
        deg = graph.nbr_mask.sum(-1).int().cpu().numpy()
        mask = graph.node_mask.cpu().numpy()
        keep_n = max(1, int(round(int(mask.sum()) * ratio)))
        order = np.argsort(np.where(mask, deg, -1))[::-1]
        new_mask = np.zeros_like(mask)
        new_mask[order[:keep_n]] = True
        mask_t = torch.from_numpy(new_mask).to(graph.x.device)
        knn = build_dual_knn(graph.pos, graph.x, mask_t, k_spatial=self.k_spatial,
                             k_morph=self.k_morphological, decay=self.spatial_decay)
        return graph.replace(nbr_idx=knn["nbr_idx"], nbr_mask=knn["nbr_mask"],
                             edge_attr=knn["edge_attr"], node_mask=mask_t)

    def build_hierarchical_graphs(self, slide_data: SlideData, levels: int = 2,
                                  ratio: float = 0.5, **kw) -> List[PaddedGraph]:
        g = self.build_graph(slide_data, **kw)
        out = [g]
        for _ in range(levels - 1):
            g = self.coarsen_graph(g, ratio)
            out.append(g)
        return out
