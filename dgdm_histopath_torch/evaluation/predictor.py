"""DGDMPredictor: checkpoint -> prediction dicts, from a slide or a graph.

Counterpart of the JAX package's ``evaluation/predictor.py``:
``predict_slide`` (slide -> tissue mask -> patch grid -> patch decode ->
featurizer -> kNN graph -> model forward), its pipelined form that decodes
the next batch of patches on a host thread while the device featurizes
this one, ``predict_slides`` (the next slide opened one ahead),
``predict_graph``, ``predict_batch``, ``rank_biomarkers``,
``compute_uncertainty`` and ``get_model_info``.

Everything after the decode runs on the predictor's device: the tissue
mask, stain normalization (fused into the featurizer's call when a neural
extractor is active), the featurizer, the kNN graph and the forward.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..convert import load_jax_bundle
from ..models.dgdm import DGDMModel
from ..models.quantized import float_apply, int8_apply
from ..models.vit import check_quant
from ..ops.graph import PaddedGraph, batch_graphs
from ..preprocessing.slide_io import SlideBackend, open_slide
from ..preprocessing.slide_processor import SlideData, SlideProcessor
from ..preprocessing.tissue_graph_builder import TissueGraphBuilder
from ..utils.device import resolve_device
from ..utils.exceptions import CheckpointError, InferenceError
from ..utils.optimization import PrefetchIterator

logger = logging.getLogger(__name__)


def load_model_checkpoint(path, device=None):
    """Load a JAX ``save_model_bundle`` npz -> (DGDMModel on ``device``, meta).
    ``device=None`` means ``"cuda"``."""
    path = Path(path)
    if not path.exists():
        raise InferenceError("checkpoint not found", {"path": str(path)})
    dev = resolve_device(device)
    try:
        model, _, meta = load_jax_bundle(path)
    except CheckpointError as exc:
        raise InferenceError("checkpoint/model structure mismatch",
                             {"path": str(path), "error": str(exc)}) from exc
    return model.to(dev).eval(), meta


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


class DGDMPredictor:
    """Slide- and graph-level inference on ``device`` (``None`` means
    ``"cuda"``; raises when no card is present, never falls back to the CPU).

    The slide pipeline takes the reference's defaults: 256-px patches at
    20x, at most 1000 patches a slide, the ``"dinov2"`` featurizer, tissue
    fraction 0.8 per patch, Macenko stain normalization, node buckets 128 to
    2048. ``quant="int8"``: w8a8 inference (the graph model's ``Dense``
    layers, and the featurizer when it normalizes stains, as in the JAX
    predictor). A windowed model (``spatial_window`` / ``graph_window``) gets
    Morton-ordered graphs built inside its band. ``decode_workers``: processes
    that decode patches of path-backed slides (at most ``cpu_count() - 1``;
    1 decodes in this process).
    """

    def __init__(self, model_path: Optional[str | Path] = None,
                 model: Optional[DGDMModel] = None, device=None,
                 quant: Optional[str] = None, patch_size: int = 256,
                 magnification: float = 20.0, max_patches: int = 1000,
                 feature_extractor: str = "dinov2", tissue_threshold: float = 0.8,
                 stain_normalize: bool = True,
                 node_buckets: Sequence[int] = (128, 256, 512, 1024, 2048),
                 decode_workers: int = 4):
        if quant not in (None, "int8"):
            raise InferenceError(f"unsupported quant mode: {quant!r}")
        self.quant = quant
        self.device = resolve_device(device)
        if model_path is not None:
            self.model, self.checkpoint_meta = load_model_checkpoint(model_path, self.device)
        elif model is not None:
            self.model, self.checkpoint_meta = model.to(self.device).eval(), {}
        else:
            raise InferenceError("provide model_path or model")
        self.decode_workers = int(decode_workers)
        self._pool = None
        # with a neural extractor, stain normalization runs inside its device
        # call: the processor keeps the patches uint8
        fuse_stain = stain_normalize and feature_extractor not in ("none", None)
        # as in the JAX predictor, the featurizer computes int8 only when it
        # is the one that normalizes stains
        featurizer_quant = quant if fuse_stain else None
        if featurizer_quant:
            check_quant(feature_extractor, featurizer_quant)
        self.processor = SlideProcessor(
            patch_size=patch_size, magnifications=[magnification], max_patches=max_patches,
            tissue_threshold=tissue_threshold,
            stain_normalize=stain_normalize and not fuse_stain, device=self.device)
        gw = getattr(self.model, "graph_window", None)
        sw = getattr(self.model, "spatial_window", None)
        self.graph_builder = TissueGraphBuilder(
            feature_extractor=feature_extractor, node_buckets=list(node_buckets),
            spatial_sort=bool(gw or sw), knn_window=gw,
            stain_normalize_on_device=fuse_stain, quant=featurizer_quant, device=self.device)

    # ------------------------------------------------------------------
    # slides
    # ------------------------------------------------------------------
    def _decode_pool(self):
        """The process pool for patch decode (made at first use), or None:
        one worker or fewer, or workers that cannot start (e.g. a
        ``__main__`` that spawn cannot import), which is remembered. Workers
        start by hiding every CUDA device (``_decode_worker_init``)."""
        if self.decode_workers <= 1 or self._pool is False:
            return None
        workers = min(self.decode_workers, (os.cpu_count() or 1) - 1)
        if workers < 1:
            self._pool = False
            return None
        if self._pool is None:
            import multiprocessing as mp
            from concurrent.futures import ProcessPoolExecutor
            from ..preprocessing.slide_processor import _decode_worker_init
            pool = ProcessPoolExecutor(max_workers=workers, mp_context=mp.get_context("spawn"),
                                       initializer=_decode_worker_init)
            try:
                for f in [pool.submit(time.sleep, 0.3) for _ in range(workers)]:
                    f.result()           # start every worker now, not mid-slide
            except Exception as exc:  # noqa: BLE001 - decode in this process instead
                logger.warning("decode worker pool unavailable (%s); decoding in "
                               "this process", exc)
                pool.shutdown(wait=False, cancel_futures=True)
                self._pool = False
                return None
            self._pool, self._pool_workers = pool, workers
        return self._pool

    def close(self) -> None:
        """Stop the decode workers, if any were started."""
        if self._pool:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None

    def predict_slide(self, slide_path, slide_id: Optional[str] = None,
                      pipelined: bool = True) -> Dict[str, Any]:
        """The whole slide pipeline on one slide (a path or a SlideBackend).
        ``pipelined`` (with a featurizer): decode batch i + 1 on a host
        thread while the device featurizes batch i; else decode every patch,
        then featurize."""
        if pipelined and self.graph_builder.feature_extractor_name not in ("none", None):
            return self._predict_slide_pipelined(slide_path, slide_id)
        slide_data = self.processor.process_slide(slide_path, slide_id=slide_id)
        return self._predict_from_slide_data(slide_data)

    def _predict_from_slide_data(self, slide_data: SlideData,
                                 features: Optional[np.ndarray] = None,
                                 timings: Optional[Dict[str, float]] = None) -> Dict[str, Any]:
        t0 = time.perf_counter()
        graph = self.graph_builder.build_graph(slide_data, features=features)
        if self.device.type == "cuda":          # the stage's time includes its device work
            torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()
        result = self.predict_graph(graph)
        t2 = time.perf_counter()
        result["slide_id"] = slide_data.slide_id
        result["num_patches"] = slide_data.num_patches
        result["patch_info"] = [
            {"x": p.x, "y": p.y, "magnification": p.magnification,
             "tissue_fraction": p.tissue_fraction} for p in slide_data.patch_info]
        if timings is not None:
            timings["graph_s"] = t1 - t0
            timings["forward_s"] = t2 - t1
            result["pipeline_timings"] = timings
        return result

    def _predict_slide_pipelined(self, source, slide_id: Optional[str] = None
                                 ) -> Dict[str, Any]:
        """Decode overlapped with featurization: a prefetch thread decodes
        patch batch i + 1 while the device featurizes batch i; the features
        come back to the host once, at the end. ``pipeline_timings``:
        ``tissue_mask_s``, ``decode_s`` (the decode thread's time),
        ``featurize_s`` (the main thread's: dispatch and the one fetch),
        ``graph_s``, ``forward_s``, ``total_s``."""
        t_total = time.perf_counter()
        slide = open_slide(source)
        try:
            path = (str(source) if not isinstance(source, SlideBackend)
                    else getattr(source, "_path", "") or "")
            sid = slide_id or (Path(path).stem if path else "slide")
            metadata = self.processor.get_metadata(slide, path)
            t0 = time.perf_counter()
            mask, mask_ds = self.processor.detect_tissue_regions(slide)
            infos = self.processor.generate_patch_coordinates(slide, mask, mask_ds)
            if (self.processor.max_patches is not None
                    and len(infos) > self.processor.max_patches):
                idx = np.linspace(0, len(infos) - 1, self.processor.max_patches).astype(int)
                infos = [infos[i] for i in idx]
            t_mask = time.perf_counter() - t0

            ext = self.graph_builder.extractor
            bs = ext.batch_size
            decode_s = [0.0]
            pool = self._decode_pool() if getattr(slide, "_path", None) else None

            def batches():
                for i in range(0, len(infos), bs):
                    t = time.perf_counter()
                    sub = infos[i:i + bs]
                    # the next batch's bytes stream in while this one decodes
                    self.processor.advise_patch_batch(slide, infos[i + bs:i + 2 * bs])
                    if pool is not None:
                        chunk = self.processor.extract_patch_batch_parallel(
                            slide, sub, pool, self._pool_workers)
                    else:
                        chunk = self.processor.extract_patch_batch(slide, sub)
                    decode_s[0] += time.perf_counter() - t
                    yield chunk

            pending = []
            featurize_s = 0.0
            stream = PrefetchIterator(batches(), depth=2)
            try:
                for chunk in stream:
                    t = time.perf_counter()
                    pending.append(ext.dispatch(chunk))
                    featurize_s += time.perf_counter() - t
            finally:
                stream.close()
            t = time.perf_counter()
            features = (ext.materialize(pending) if pending
                        else np.zeros((0, ext.feature_dim), np.float32))
            featurize_s += time.perf_counter() - t

            metadata["num_patches"] = len(infos)
            metadata["tissue_fraction"] = float(mask.mean()) if mask.size else 0.0
            slide_data = SlideData(
                slide_id=sid, slide_path=path,
                patches=np.zeros((0, self.processor.patch_size, self.processor.patch_size, 3),
                                 np.uint8),
                patch_info=infos, metadata=metadata, tissue_mask=mask)
            timings = {"tissue_mask_s": t_mask, "decode_s": decode_s[0],
                       "featurize_s": featurize_s, "total_s": 0.0}
            result = self._predict_from_slide_data(slide_data, features=features,
                                                   timings=timings)
            result["pipeline_timings"]["total_s"] = time.perf_counter() - t_total
            return result
        finally:
            slide.close()

    def predict_slides(self, slide_paths: Sequence, pipelined: bool = True
                       ) -> List[Dict[str, Any]]:
        """Several slides. ``pipelined``: each slide as in
        :meth:`predict_slide`, and slide i + 1 opened on a background thread
        (its file's readahead started) while slide i runs; else each slide
        decoded on a background thread one ahead of the device."""
        if not pipelined:
            produced = PrefetchIterator(
                (self.processor.process_slide(p) for p in slide_paths), depth=1)
            return [self._predict_from_slide_data(sd) for sd in produced]
        results: List[Dict[str, Any]] = []
        nxt = open_slide(slide_paths[0]) if len(slide_paths) else None
        if nxt is not None:
            nxt.prefetch()
        try:
            for i, p in enumerate(slide_paths):
                cur, nxt = nxt, None
                box: Dict[str, Any] = {}
                opener = None
                if i + 1 < len(slide_paths):
                    def _open(path=slide_paths[i + 1], box=box):
                        try:
                            s = open_slide(path)
                            s.prefetch()
                            box["slide"] = s
                        except Exception as e:  # noqa: BLE001 - raised on join below
                            box["err"] = e
                    opener = threading.Thread(target=_open, daemon=True)
                    opener.start()
                results.append(self._predict_slide_pipelined(cur, slide_id=Path(str(p)).stem))
                if opener is not None:
                    opener.join()
                    if "err" in box:
                        raise box["err"]
                    nxt = box["slide"]
        finally:
            if nxt is not None:
                nxt.close()
        return results

    # ------------------------------------------------------------------
    # graphs
    # ------------------------------------------------------------------
    def forward(self, batch: PaddedGraph) -> Dict[str, Any]:
        """The model's inference forward with attention, on the predictor's
        device; with ``quant="int8"`` every eligible ``Dense`` computes int8
        (``models/quantized.py``)."""
        apply = int8_apply if self.quant == "int8" else float_apply
        with torch.inference_mode():
            return apply(self.model, batch.to(self.device), mode="inference",
                         deterministic=True, return_attention=True)

    def predict_graph(self, graph: PaddedGraph) -> Dict[str, Any]:
        """Model forward on a single graph."""
        batched = graph if graph.x.dim() == 3 else graph.unsqueeze()
        out = self.forward(batched)
        result: Dict[str, Any] = {"graph_embedding": _host(out["graph_embedding"])[0]}
        if "classification_logits" in out:
            logits = _host(out["classification_logits"])[0]
            probs = np.exp(logits - logits.max())
            probs = probs / probs.sum()
            result.update({
                "logits": logits,
                "probabilities": probs,
                "predicted_class": int(probs.argmax()),
                "confidence": float(probs.max()),
                "uncertainty": self.compute_uncertainty(probs),
            })
        if "regression" in out:
            result["regression"] = _host(out["regression"]["mean"])[0]
        if "survival" in out:
            result["survival"] = {k: _host(v)[0] for k, v in out["survival"].items()}
        if "attention_weights" in out:
            attn = _host(out["attention_weights"])[0]
            result["attention_weights"] = attn
            result["biomarkers"] = self.rank_biomarkers(
                attn, batched.node_mask[0].cpu().numpy(), _host(batched.pos)[0])
        return result

    def predict_batch(self, graphs: Sequence[PaddedGraph]) -> List[Dict[str, Any]]:
        """Same-bucket graphs are stacked and run in one forward each."""
        results: List[Optional[Dict[str, Any]]] = [None] * len(graphs)
        by_shape: Dict[tuple, List[int]] = {}
        for i, g in enumerate(graphs):
            by_shape.setdefault((g.num_nodes, g.max_neighbors, g.feature_dim), []).append(i)
        for idxs in by_shape.values():
            out = self.forward(batch_graphs([graphs[i] for i in idxs]))
            emb = _host(out["graph_embedding"])
            logits = (_host(out["classification_logits"])
                      if "classification_logits" in out else None)
            attn = _host(out["attention_weights"]) if "attention_weights" in out else None
            for row, i in enumerate(idxs):
                r: Dict[str, Any] = {"graph_embedding": emb[row]}
                if logits is not None:
                    probs = np.exp(logits[row] - logits[row].max())
                    probs /= probs.sum()
                    r.update({"probabilities": probs,
                              "predicted_class": int(probs.argmax()),
                              "confidence": float(probs.max()),
                              "uncertainty": self.compute_uncertainty(probs)})
                if attn is not None:
                    r["attention_weights"] = attn[row]
                results[i] = r
        return results  # type: ignore[return-value]

    @staticmethod
    def rank_biomarkers(attention: np.ndarray, node_mask: np.ndarray,
                        pos: np.ndarray, top_k: int = 10) -> List[Dict[str, Any]]:
        """Rank patches by pooled attention."""
        attn = np.where(node_mask, attention, -np.inf)
        order = np.argsort(-attn)[:top_k]
        out = []
        for rank, i in enumerate(order):
            if not node_mask[i]:
                break
            out.append({
                "rank": rank + 1,
                "node_index": int(i),
                "attention_score": float(attention[i]),
                "position": [float(pos[i, 0]), float(pos[i, 1])],
            })
        return out

    @staticmethod
    def compute_uncertainty(probs: np.ndarray) -> Dict[str, float]:
        """entropy / max-prob / margin."""
        p = np.clip(np.asarray(probs, np.float64), 1e-12, 1.0)
        entropy = float(-(p * np.log(p)).sum())
        top2 = np.sort(p)[-2:]
        return {
            "entropy": entropy,
            "normalized_entropy": entropy / np.log(len(p)) if len(p) > 1 else 0.0,
            "max_probability": float(p.max()),
            "margin": float(top2[1] - top2[0]) if len(p) > 1 else 1.0,
        }

    def get_model_info(self) -> Dict[str, Any]:
        m = self.model
        return {
            "model_type": "DGDMModel",
            "num_parameters": sum(p.numel() for p in m.parameters()),
            "node_features": m.node_features,
            "hidden_dims": list(m.hidden_dims),
            "num_classes": m.num_classes,
            "pooling": m.pooling,
            "compute_dtype": m.compute_dtype,
            "device": str(self.device),
            "feature_extractor": {   # the featurizer is built at first use: not here
                "arch": getattr(self.graph_builder._extractor, "arch",
                                self.graph_builder.feature_extractor_name),
                "weights_loaded": getattr(self.graph_builder._extractor, "weights_loaded", None),
            },
            "checkpoint_meta": {k: v for k, v in self.checkpoint_meta.items()
                                if k != "treedef"},
        }
