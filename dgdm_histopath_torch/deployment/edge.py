"""Edge deployment: compressed parameters, a packaged inference engine and
resource sampling; the JAX package's ``deployment/edge.py`` on the port.

The bundle is the JAX package's ``edge_npz_v2``: one npz (written and read
with ``allow_pickle=False``) whose leaves are the flax parameter paths
(``p:params/...``, through ``convert.params_to_flax`` / ``params_from_flax``)
and whose ``__meta__`` JSON holds the model config, the ``EdgeConfig`` and
each leaf's storage: ``int8`` (a float leaf of more than 16 elements as
``clip(round(a / s), -127, 127)`` with ``s = max|a| / 127``, or 1), ``bf16``
(stored as a ``uint16`` view) or ``raw``. A bundle written by either package
loads in the other.

Kept from the reference as it is: a quantization named ``"bfloat16"`` (not
``"bf16"``) stores the leaves raw; an int8 bundle is dequantized at load and
then computes through :func:`~..models.quantized.int8_apply` (storage
quantization, then w8a8 on the dequantized weights).

``EdgeModelOptimizer.export_stablehlo`` keeps the JAX name. Where JAX writes
a jitted function's StableHLO text, the port writes a ``torch.export``
program: the gather kernels travel in it as the custom ops
``dgdm::gather_rows`` and ``dgdm::weighted_gather_sum``, so a process that
loads it imports ``dgdm_histopath_torch.ops.kernels`` first (as StableHLO
needs the runtime that provides its custom calls).
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

from ..convert import (KEY_PREFIX, is_bf16_bits, leaf_tensor, load_state, params_from_flax,
                       params_to_flax)
from ..models.quantized import float_apply, int8_apply
from ..quantum.scheduler import read_resources
from ..utils.device import resolve_device
from ..utils.logging import get_logger

logger = get_logger("deployment")


@dataclass
class EdgeConfig:
    """Export configuration: ``quantization`` ``"none"``, ``"bf16"`` or
    ``"int8"`` (any other name stores the leaves raw, as in the reference);
    ``target``, ``max_batch_size`` and ``export_stablehlo`` are recorded,
    not read, as in the reference."""
    quantization: str = "bf16"
    max_batch_size: int = 1
    target: str = "cuda"
    export_stablehlo: bool = False


# ---------------------------------------------------------------------------
# parameter compression (a state dict: name -> tensor)
# ---------------------------------------------------------------------------

def _quantize_leaf(arr: np.ndarray):
    """``(int8 array, scale)``: the JAX package's per-leaf numpy formula."""
    scale = float(np.abs(arr).max() / 127.0) or 1.0
    return np.clip(np.round(arr / scale), -127, 127).astype(np.int8), scale


def _dequantize_leaf(arr: np.ndarray, scale: float) -> np.ndarray:
    return arr.astype(np.float32) * np.float32(scale)


def _to_bf16_bits(arr: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(arr, np.float32)).to(
        torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def _from_bf16_bits(arr: np.ndarray) -> np.ndarray:
    return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).float().numpy()


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def quantize_params_int8(params: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """Per-leaf symmetric int8 of the float parameters of a state dict."""
    names, leaves, scales, kinds = [], [], [], []
    for name, leaf in params.items():
        arr = _host(leaf.float() if leaf.dtype == torch.bfloat16 else leaf)
        names.append(name)
        if arr.dtype.kind == "f" and arr.size > 16:
            q, scale = _quantize_leaf(arr)
            leaves.append(q)
            scales.append(scale)
            kinds.append("int8")
        else:
            leaves.append(arr)
            scales.append(1.0)
            kinds.append("raw")
    return {"names": names, "leaves": leaves, "scales": scales, "kinds": kinds}


def dequantize_params(qdata: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    out = {}
    for name, leaf, scale, kind in zip(qdata["names"], qdata["leaves"], qdata["scales"],
                                       qdata["kinds"]):
        out[name] = torch.from_numpy(_dequantize_leaf(leaf, scale) if kind == "int8"
                                     else np.array(leaf))
    return out


def cast_params(params: Mapping[str, torch.Tensor], dtype=torch.bfloat16
                ) -> Dict[str, torch.Tensor]:
    return {k: v.to(dtype) if v.is_floating_point() else v for k, v in params.items()}


def _nbytes(leaves) -> int:
    return sum(t.numel() * t.element_size() if isinstance(t, torch.Tensor) else t.nbytes
               for t in leaves)


class EdgeModelOptimizer:
    """Compress a model's state dict for edge serving."""

    def __init__(self, config: Optional[EdgeConfig] = None):
        self.config = config or EdgeConfig()

    def optimize(self, params: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
        before = _nbytes(params.values())
        if self.config.quantization == "int8":
            qdata = quantize_params_int8(params)
            after = _nbytes(qdata["leaves"])
            packed: Dict[str, Any] = {"format": "int8", "data": qdata}
        elif self.config.quantization == "bf16":
            cast = cast_params(params, torch.bfloat16)
            after = _nbytes(cast.values())
            packed = {"format": "bf16", "data": cast}
        else:
            packed = {"format": "none", "data": dict(params)}
            after = before
        packed["stats"] = {"bytes_before": before, "bytes_after": after,
                           "compression": before / max(after, 1)}
        logger.info("edge optimize: %.1f MB -> %.1f MB (%.2fx)",
                    before / 1e6, after / 1e6, before / max(after, 1))
        return packed

    @staticmethod
    def restore(packed: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        if packed["format"] == "int8":
            return dequantize_params(packed["data"])
        return dict(packed["data"])

    @staticmethod
    def export_stablehlo(fn, example_args, path) -> Path:
        """Export ``fn`` (a module, or a callable, which is wrapped in one)
        at ``example_args`` with ``torch.export`` under ``torch.no_grad()``,
        save the ``ExportedProgram`` to ``path`` and return ``path``.

        A ``PaddedGraph`` argument is a pytree, so a ``DGDMModel`` exports
        as it is called. The program holds one ``dgdm::gather_rows`` and two
        ``dgdm::weighted_gather_sum`` nodes a graph layer: on CUDA tensors
        they launch the kernels, on CPU tensors they run the plain versions.
        To run it elsewhere: ``import dgdm_histopath_torch.ops.kernels``,
        then ``torch.export.load(path).module()(*example_args)``."""
        module = fn if isinstance(fn, torch.nn.Module) else _Callable(fn)
        path = Path(path)
        with torch.no_grad():
            program = torch.export.export(module, tuple(example_args))
        torch.export.save(program, path)
        return path


class _Callable(torch.nn.Module):
    """A plain callable as a module, for ``torch.export``."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


class EdgeInferenceEngine:
    """One model's packaged inference with latency accounting. The restored
    parameters are loaded into ``model`` (as f32), which moves to ``device``
    (``None`` means ``"cuda"``); an ``int8`` config computes through
    :func:`~..models.quantized.int8_apply`."""

    def __init__(self, model, packed_params: Mapping[str, Any],
                 config: Optional[EdgeConfig] = None, device=None):
        self.config = config or EdgeConfig()
        self.device = resolve_device(device)
        state = EdgeModelOptimizer.restore(packed_params)
        load_state(model, {k: v.float() if v.is_floating_point() else v
                           for k, v in state.items()})
        self.model = model.to(self.device).eval()
        self._apply = int8_apply if self.config.quantization == "int8" else float_apply
        self.stats = {"requests": 0, "total_latency_s": 0.0, "max_latency_s": 0.0}

    def predict(self, graph) -> Dict[str, Any]:
        """A batched ``PaddedGraph`` -> probabilities [B, C], predicted class
        [B] and graph embeddings, with ``latency_s`` (the results fetched)."""
        t0 = time.perf_counter()
        with torch.inference_mode():
            out = self._apply(self.model, graph.to(self.device), mode="inference",
                              deterministic=True)
            logits = out.get("classification_logits")
            arr = None if logits is None else logits.float().cpu().numpy()
            emb = out["graph_embedding"].float().cpu().numpy()
        dt = time.perf_counter() - t0
        self.stats["requests"] += 1
        self.stats["total_latency_s"] += dt
        self.stats["max_latency_s"] = max(self.stats["max_latency_s"], dt)
        result: Dict[str, Any] = {"latency_s": dt}
        if arr is not None:
            probs = np.exp(arr - arr.max(-1, keepdims=True))
            probs /= probs.sum(-1, keepdims=True)
            result.update({"probabilities": probs, "predicted_class": probs.argmax(-1)})
        result["graph_embedding"] = emb
        return result

    @property
    def mean_latency_s(self) -> float:
        n = self.stats["requests"]
        return self.stats["total_latency_s"] / n if n else 0.0


class EdgeResourceMonitor:
    """Host and device resource sampling, the last 1000 samples kept."""

    def __init__(self):
        self.samples: List[Dict[str, float]] = []

    def sample(self) -> Dict[str, float]:
        snap = read_resources()
        s = {"ts": snap.timestamp, "cpu_load": snap.cpu_load_1m,
             "host_mem_used_frac": snap.mem_used_fraction,
             "device_mem_used_mb": snap.device_mem_used_mb}
        self.samples.append(s)
        if len(self.samples) > 1000:
            self.samples = self.samples[-1000:]
        return s

    def report(self) -> Dict[str, float]:
        if not self.samples:
            return {}
        loads = [s["cpu_load"] for s in self.samples]
        return {"samples": len(self.samples), "cpu_load_mean": float(np.mean(loads)),
                "cpu_load_max": float(np.max(loads))}


class EdgeDeploymentManager:
    """Bundle -> load -> serve."""

    def __init__(self, output_dir="./edge_bundle"):
        self.output_dir = Path(output_dir)
        self.output_dir.mkdir(parents=True, exist_ok=True)

    def package(self, model, params: Optional[Mapping[str, torch.Tensor]],
                model_config: Dict[str, Any], config: Optional[EdgeConfig] = None) -> Path:
        """Write ``edge_model.npz`` and ``manifest.json`` for ``model`` with
        ``params`` (a state dict; ``None``: the model's own)."""
        config = config or EdgeConfig()
        flat = params_to_flax(model.state_dict() if params is None else params, model)
        arrays: Dict[str, np.ndarray] = {}
        leaf_meta: Dict[str, Dict[str, Any]] = {}
        before = after = 0
        for name in sorted(flat, key=lambda n: n.split("/")):     # the flax tree's order
            arr = flat[name]
            before += arr.nbytes
            # a bf16 leaf is quantized from its f32 values, as
            # quantize_params_int8 does (the JAX package, whose bf16 leaves
            # are not of kind "f", stores them raw)
            values = leaf_tensor(arr).float().numpy() if is_bf16_bits(arr) else arr
            if config.quantization == "int8" and values.dtype.kind == "f" and values.size > 16:
                stored, scale = _quantize_leaf(values)
                leaf_meta[name] = {"kind": "int8", "scale": scale}
            elif config.quantization == "bf16" and values.dtype.kind == "f":
                stored = _to_bf16_bits(values)
                leaf_meta[name] = {"kind": "bf16"}
            else:
                stored = arr
                leaf_meta[name] = {"kind": "raw"}
            arrays[KEY_PREFIX + name] = stored
            after += stored.nbytes
        stats = {"bytes_before": before, "bytes_after": after,
                 "compression": before / max(after, 1)}
        meta = {"format": "edge_npz_v2", "model_config": model_config,
                "edge_config": config.__dict__, "leaves": leaf_meta, "stats": stats}
        bundle_path = self.output_dir / "edge_model.npz"
        np.savez_compressed(bundle_path, __meta__=json.dumps(meta), **arrays)
        (self.output_dir / "manifest.json").write_text(json.dumps({
            "format": config.quantization, "stats": stats,
            "model_config": model_config, "created": time.time()}, indent=2))
        logger.info("edge bundle: %.1f MB -> %.1f MB (%.2fx) at %s",
                    before / 1e6, after / 1e6, stats["compression"], bundle_path)
        return bundle_path

    @staticmethod
    def load(bundle_path, device=None) -> EdgeInferenceEngine:
        """An engine on ``device`` from an npz edge bundle; never unpickles."""
        from ..models.dgdm import DGDMModel
        bundle_path = Path(bundle_path)
        if bundle_path.suffix == ".pkl":
            raise ValueError(
                "legacy pickle edge bundles are no longer loaded (arbitrary "
                "code execution risk); re-export with "
                "EdgeDeploymentManager.package()")
        with np.load(bundle_path, allow_pickle=False) as data:
            meta = json.loads(str(data["__meta__"]))
            flat = {}
            for name, info in meta["leaves"].items():
                arr = data[KEY_PREFIX + name]
                if info["kind"] == "int8":
                    arr = _dequantize_leaf(arr, info["scale"])
                elif info["kind"] == "bf16":
                    arr = _from_bf16_bits(arr)
                flat[name] = arr
        model = DGDMModel(**meta["model_config"])
        state = params_from_flax(flat)
        return EdgeInferenceEngine(model, {"format": "none", "data": state},
                                   EdgeConfig(**meta["edge_config"]), device=device)
