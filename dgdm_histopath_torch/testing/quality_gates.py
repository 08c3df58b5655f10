"""Self-contained quality gates: runnable health checks over the port
(counterpart of the JAX package's ``testing/quality_gates.py``).

Each gate runs the port's own modules on synthetic data at the JAX gates'
sizes (16-d features, 32 nodes, 2 graphs, K = 6) and takes the runner's
device: imports, config, model construction, forward, training step,
preprocessing, data loading, checkpointing, input validation, determinism,
``predict_slide``, a preempted and resumed fit, and a ``/predict`` through
the dynamic batcher. On the card the seven model gates launch the gather
kernels. ``LEVEL_REQUIREMENTS`` names the gates that must pass at each
maturity level and the least share of passing gates.
"""

from __future__ import annotations

import copy
import time
import traceback
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.logging import get_logger

logger = get_logger("testing")

# gates required per maturity level
LEVEL_REQUIREMENTS = {
    "greenfield": {"min_score": 0.5,
                   "required": ["imports", "config"]},
    "development": {"min_score": 0.7,
                    "required": ["imports", "config", "model_construction",
                                 "model_forward"]},
    "staging": {"min_score": 0.85,
                "required": ["imports", "config", "model_construction",
                             "model_forward", "training_step", "data_pipeline",
                             "input_validation"]},
    "production": {"min_score": 0.95,
                   "required": ["imports", "config", "model_construction",
                                "model_forward", "training_step",
                                "preprocessing", "data_pipeline",
                                "checkpointing", "input_validation",
                                "determinism", "prediction_end_to_end",
                                "preemption_resume", "serving"]},
}


def _tiny_graph(num_classes=None, feat_dim=16, n=32, b=2, device="cpu"):
    """``b`` graphs of ``n`` real nodes: seeded features and positions, the
    6 nearest neighbours, edge features [d, exp(-10 d), 0]; labels
    ``seed % num_classes``. The kNN runs on the CPU, the batch moves to
    ``device``."""
    from ..ops.graph import PaddedGraph, batch_graphs
    from ..ops.knn import knn_euclidean

    graphs = []
    for seed in range(b):
        rs = np.random.RandomState(seed)
        x = torch.from_numpy(rs.randn(n, feat_dim).astype(np.float32))
        pos = torch.from_numpy(rs.rand(n, 2).astype(np.float32))
        mask = torch.ones(n, dtype=torch.bool)
        idx, dist, valid = knn_euclidean(pos, mask, 6)
        graphs.append(PaddedGraph(
            x=x, pos=pos, nbr_idx=idx, nbr_mask=valid,
            edge_attr=torch.stack([dist, torch.exp(-10 * dist), torch.zeros_like(dist)], -1),
            node_mask=mask,
            y=None if num_classes is None else torch.tensor(seed % num_classes,
                                                            dtype=torch.int32)))
    return batch_graphs(graphs).to(device)


def _model(device, **kw):
    """A ``DGDMModel`` (f32) with parameters drawn from seed 0, on ``device``."""
    from ..models import DGDMModel
    from ..nn.layers import init_parameters

    model = DGDMModel(compute_dtype="float32", **kw)
    init_parameters(model, torch.Generator().manual_seed(0))
    return model.to(device).eval()


SMALL = dict(node_features=16, hidden_dims=(32, 16), attention_heads=4, graph_layers=2)


# ---------------------------------------------------------------------------
# individual gates
# ---------------------------------------------------------------------------

def gate_imports(device) -> None:
    import dgdm_histopath_torch
    from dgdm_histopath_torch import models, ops, parallel, training, utils  # noqa: F401
    assert dgdm_histopath_torch.DGDMModel is models.DGDMModel


def gate_config(device) -> None:
    from ..utils.config import DGDMConfig, config_from_dict, config_to_dict
    cfg = DGDMConfig()
    cfg.validate()
    rt = config_from_dict(config_to_dict(cfg))
    rt.validate()


def gate_model_construction(device) -> None:
    model = _model(device, **SMALL, num_classes=2)
    params = list(model.parameters())
    assert params and all(p.device.type == torch.device(device).type for p in params)
    assert all(bool(torch.isfinite(p).all()) for p in params)


def gate_model_forward(device) -> None:
    model = _model(device, **SMALL, num_classes=2)
    with torch.no_grad():
        logits = model(_tiny_graph(num_classes=2, device=device),
                       mode="inference")["classification_logits"]
    assert tuple(logits.shape) == (2, 2) and bool(torch.isfinite(logits).all())


def gate_training_step(device) -> None:
    from ..training import DGDMTrainer, TrainerConfig
    model = _model(device, **SMALL, num_classes=2, use_hierarchical=False)
    trainer = DGDMTrainer(model, TrainerConfig(warmup_steps=1, pretrain_epochs=1,
                                               steps_per_epoch=2), device=device)
    batch = _tiny_graph(num_classes=2, device=device)
    trainer.init_state(0, batch)
    m = trainer.training_step(batch, epoch=0)
    assert np.isfinite(m["loss"])


def gate_preprocessing(device) -> None:
    from ..preprocessing import SlideProcessor, synthetic_slide
    backend, _ = synthetic_slide(512, 512, num_levels=3, seed=0)
    proc = SlideProcessor(patch_size=32, tissue_threshold=0.3, max_patches=10,
                          stain_normalize=False, device=device)
    data = proc.process_slide(backend)
    assert data.num_patches > 0
    assert data.patches.dtype == np.uint8


def gate_data_pipeline(device) -> None:
    from ..data import BucketedLoader
    singles = []
    for _ in range(4):
        g = _tiny_graph(num_classes=2, b=1)
        singles.append(g.replace(**{f: getattr(g, f)[0] for f in
                                    ("x", "pos", "nbr_idx", "nbr_mask", "edge_attr",
                                     "node_mask", "y")}))
    loader = BucketedLoader(singles, batch_size=2, prefetch=0)
    batches = [b.to(device) for b in loader]
    assert len(batches) == 2


def gate_checkpointing(device) -> None:
    """One training step (the port's ``init_state`` runs no forward, the
    JAX one traces the model), then the state saved, restored and loaded
    back equal to the bit."""
    import tempfile

    from ..training import CheckpointManager, DGDMTrainer, TrainerConfig
    model = _model(device, **SMALL, use_hierarchical=False)
    trainer = DGDMTrainer(model, TrainerConfig(), device=device)
    batch = _tiny_graph(device=device)
    trainer.init_state(0, batch)
    trainer.training_step(batch, epoch=0)
    saved = {k: v.detach().clone() for k, v in model.state_dict().items()}
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        mgr.save(trainer.state_dict(), step=0, metric=1.0)
        restored = mgr.restore()
        assert restored is not None and restored["step"] == 1
        trainer.load_state_dict(restored)
    assert all(torch.equal(v, saved[k]) for k, v in model.state_dict().items())


def gate_input_validation(device) -> None:
    from ..utils.exceptions import ValidationError
    from ..utils.validation import InputValidator
    try:
        InputValidator.validate_integer("x", "field")
        raise AssertionError("should have raised")
    except ValidationError:
        pass
    try:
        InputValidator.validate_path("../../etc/passwd", "p")
        raise AssertionError("should have raised")
    except ValidationError:
        pass
    assert InputValidator.validate_probability(0.5, "p") == 0.5


def gate_prediction_end_to_end(device) -> None:
    """Full ``predict_slide`` on a synthetic slide (the user-facing flow)."""
    from ..evaluation import DGDMPredictor
    from ..preprocessing import synthetic_slide
    model = _model(device, node_features=5, hidden_dims=(16, 8), attention_heads=4,
                   graph_layers=1, num_diffusion_steps=2, num_classes=2,
                   use_hierarchical=False, use_spatial_attention=False)
    predictor = DGDMPredictor(model=model, device=device, patch_size=32, max_patches=20,
                              feature_extractor="none", tissue_threshold=0.3,
                              stain_normalize=False, node_buckets=[32, 64])
    try:
        backend, _ = synthetic_slide(512, 512, num_levels=3, seed=9)
        result = predictor.predict_slide(backend, slide_id="gate")
    finally:
        predictor.close()
    assert result["probabilities"].shape == (2,)
    assert result["uncertainty"]["entropy"] >= 0.0


def gate_determinism(device) -> None:
    model = _model(device, **SMALL, num_classes=2)
    g = _tiny_graph(num_classes=2, device=device)
    with torch.no_grad():
        out1 = model(g, mode="inference")["classification_logits"]
        out2 = model(g, mode="inference")["classification_logits"]
    assert torch.equal(out1, out2)


def gate_preemption_resume(device) -> None:
    """An interrupted fit writes a resumable mid-epoch checkpoint: trigger
    -> emergency save -> restore into a fresh trainer -> finish."""
    import tempfile

    from ..training import CheckpointManager, DGDMTrainer, PreemptionGuard, TrainerConfig
    model = _model(device, **{**SMALL, "graph_layers": 1}, num_diffusion_steps=2,
                   num_classes=2, use_hierarchical=False)
    fresh = copy.deepcopy(model)
    batches = [_tiny_graph(num_classes=2) for _ in range(3)]
    cfg = TrainerConfig(pretrain_epochs=0, warmup_steps=1)
    trainer = DGDMTrainer(model, cfg, device=device)
    trainer.init_state(0, batches[0])
    # signal.signal works on the main thread only: the gate may run in a worker
    guard = PreemptionGuard(install=False)
    guard.trigger()
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        result = trainer.fit(batches, max_epochs=2, checkpoint_manager=mgr,
                             preemption_guard=guard)
        assert result["interrupted"] is True
        info = mgr.record_extra().get("resume")
        assert info and info["mid_epoch"]
        resumed = DGDMTrainer(fresh, cfg, device=device)
        resumed.init_state(0, batches[0])
        resumed.load_state_dict(mgr.restore())
        resumed.current_epoch = info["epoch"]
        done = resumed.fit(batches, max_epochs=2, start_step_in_epoch=info["step_in_epoch"])
        assert done["interrupted"] is False


def gate_serving(device) -> None:
    """The dynamic-batching server answers a predict round trip in-process."""
    from ..deployment import InferenceServer
    from ..evaluation import DGDMPredictor
    model = _model(device, node_features=16, hidden_dims=(16, 8), attention_heads=4,
                   graph_layers=1, num_diffusion_steps=2, num_classes=2,
                   use_hierarchical=False, use_spatial_attention=False)
    g = _tiny_graph(b=1)
    predictor = DGDMPredictor(model=model, device=device, feature_extractor="none")
    server = InferenceServer(predictor, port=0, dynamic_batch=4)
    try:
        out = server.handle_predict({"graph": {
            k: getattr(g, k)[0].numpy().tolist()
            for k in ("x", "pos", "nbr_idx", "nbr_mask", "edge_attr", "node_mask")}})
        assert "probabilities" in out
        assert server.batcher.stats["items"] == 1
        assert "dgdm_batch_size_mean" in server.prometheus_metrics()
    finally:
        server.stop()


GATES: Dict[str, Callable[[torch.device], None]] = {
    "imports": gate_imports,
    "config": gate_config,
    "model_construction": gate_model_construction,
    "model_forward": gate_model_forward,
    "training_step": gate_training_step,
    "preprocessing": gate_preprocessing,
    "data_pipeline": gate_data_pipeline,
    "checkpointing": gate_checkpointing,
    "input_validation": gate_input_validation,
    "determinism": gate_determinism,
    "prediction_end_to_end": gate_prediction_end_to_end,
    "preemption_resume": gate_preemption_resume,
    "serving": gate_serving,
}

# the gates that run the model on the runner's device
MODEL_GATES = ("model_forward", "training_step", "checkpointing", "determinism",
               "prediction_end_to_end", "preemption_resume", "serving")


def run_gate(name: str, device) -> Dict:
    """One gate's result: ``{"name", "status", "duration_s", "error"}``."""
    fn = GATES.get(name)
    if fn is None:
        return {"name": name, "status": "unknown", "duration_s": 0.0, "error": "no such gate"}
    start = time.perf_counter()
    try:
        fn(device)
        status, error = "passed", None
    except Exception as exc:  # noqa: BLE001 - a failed gate is a result
        status, error = "failed", f"{exc}\n{traceback.format_exc()}"
        logger.error("gate %s failed: %s", name, exc)
    return {"name": name, "status": status,
            "duration_s": round(time.perf_counter() - start, 3), "error": error}


def score_report(results: List[Dict], level: str) -> Dict:
    """The share of passing gates and whether ``level``'s rule holds: that
    share at least its ``min_score`` and each of its required gates that
    ran passed."""
    passed_names = {r["name"] for r in results if r["status"] == "passed"}
    score = len(passed_names) / max(len(results), 1)
    req = LEVEL_REQUIREMENTS[level]
    ran = {r["name"] for r in results}
    level_ok = (score >= req["min_score"]
                and all(r in passed_names for r in req["required"] if r in ran))
    return {"score": round(score, 3), "passed": bool(level_ok), "level": level,
            "gates": results}


class QualityGateRunner:
    """Run gates on ``device`` (``None``: the card), produce a scored report."""

    def __init__(self, level: str = "development", fail_fast: bool = False, device=None):
        if level not in LEVEL_REQUIREMENTS:
            raise ValueError(f"unknown maturity level {level!r}")
        self.level = level
        self.fail_fast = fail_fast
        self.device = resolve_device(device)

    def run(self, selected: Optional[List[str]] = None) -> Dict:
        results = []
        for name in selected or list(GATES):
            results.append(run_gate(name, self.device))
            if results[-1]["status"] == "failed" and self.fail_fast:
                break
        return score_report(results, self.level)
