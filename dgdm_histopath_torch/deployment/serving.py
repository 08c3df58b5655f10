"""Inference server over DGDMPredictor: health probes, graph and slide predict.

Endpoints:
  GET  /healthz | /readyz | /health  — health report
  GET  /info                         — model metadata and serving counters
  POST /predict        — JSON {"graph": {x, pos, nbr_idx, nbr_mask, edge_attr, node_mask}}
                         or {"graph_path": ...}
  POST /predict_batch  — JSON {"graphs": [graph, ...]} or {"graph_paths": [...]};
                         same-bucket graphs run as one batched forward
                         (DGDMPredictor.predict_batch)
  POST /predict_slide  — JSON {"slide_path": ...}: the whole slide pipeline
                         (DGDMPredictor.predict_slide)

Paths are read only under ``data_root`` (resolved; a path that leaves it is
refused), and only when the server was given one.

The server is single-threaded: the card is one device queue, and requests
are served in order. Rate limiting, /metrics and dynamic batching are
ROADMAP work.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, HTTPServer
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..data.graph_io import load_graph
from ..ops.graph import PaddedGraph


def graph_from_json(payload: Dict[str, Any]) -> PaddedGraph:
    """A graph sent as JSON lists -> PaddedGraph of CPU tensors."""
    g = payload
    x = np.asarray(g["x"], np.float32)
    pos = (np.asarray(g["pos"], np.float32) if g.get("pos") is not None
           else np.zeros((len(x), 2), np.float32))
    t = torch.from_numpy
    return PaddedGraph(
        x=t(x), pos=t(pos),
        nbr_idx=t(np.asarray(g["nbr_idx"], np.int32)),
        nbr_mask=t(np.asarray(g["nbr_mask"], bool)),
        edge_attr=t(np.asarray(g["edge_attr"], np.float32)),
        node_mask=t(np.asarray(g["node_mask"], bool)))


def graph_to_json(graph: PaddedGraph) -> Dict[str, Any]:
    """Inverse of :func:`graph_from_json` (for clients and tests)."""
    return {f: getattr(graph, f).cpu().numpy().tolist()
            for f in ("x", "pos", "nbr_idx", "nbr_mask", "edge_attr", "node_mask")}


def _jsonable(obj: Any) -> Any:
    """numpy arrays and scalars -> lists and Python numbers, recursively."""
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    return obj


class InferenceServer:
    """Serves a DGDMPredictor over HTTP. ``port=0`` takes a free port; the
    bound port is ``self.port`` after :meth:`start`."""

    def __init__(self, predictor, port: int = 8080, host: str = "",
                 data_root: Optional[str | Path] = None):
        self.predictor = predictor
        self.host, self.port = host, port
        # path loading is opt-in: without a data_root a client could make the
        # server read any file of the host
        self.data_root = Path(data_root).resolve() if data_root else None
        self.stats = {"requests": 0, "errors": 0, "total_latency_s": 0.0}
        self._stats_lock = threading.Lock()
        self._httpd: Optional[HTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def _count(self, latency_s: float) -> None:
        with self._stats_lock:
            self.stats["requests"] += 1
            self.stats["total_latency_s"] += latency_s

    def health(self) -> Dict[str, Any]:
        checks = {
            "model_loaded": any(True for _ in self.predictor.model.parameters()),
            "device_available": (self.predictor.device.type != "cuda"
                                 or torch.cuda.is_available()),
        }
        return {"healthy": all(checks.values()), "checks": checks,
                "device": str(self.predictor.device), "timestamp": time.time()}

    def _resolve_path(self, path: str) -> Path:
        """A client's path, confined to ``data_root``."""
        if self.data_root is None:
            raise PermissionError("path loading is disabled: the server was started "
                                  "without data_root; send the graph inline")
        resolved = (self.data_root / path).resolve()
        if self.data_root not in resolved.parents and resolved != self.data_root:
            raise PermissionError(f"path escapes data_root: {path!r}")
        return resolved

    def handle_predict(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        t0 = time.perf_counter()
        if "graph_path" in payload:
            graph = load_graph(self._resolve_path(payload["graph_path"]))
        elif "graph" in payload:
            graph = graph_from_json(payload["graph"])
        else:
            raise ValueError("payload must contain 'graph' or 'graph_path'")
        out = _jsonable(self.predictor.predict_graph(graph))
        out["latency_s"] = round(time.perf_counter() - t0, 4)
        self._count(out["latency_s"])
        return out

    def handle_predict_slide(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        """The whole slide pipeline on ``{"slide_path": <under data_root>}``."""
        t0 = time.perf_counter()
        if "slide_path" not in payload:
            raise ValueError("payload must contain 'slide_path'")
        out = _jsonable(self.predictor.predict_slide(self._resolve_path(payload["slide_path"])))
        out["latency_s"] = round(time.perf_counter() - t0, 4)
        self._count(out["latency_s"])
        return out

    def handle_predict_batch(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        t0 = time.perf_counter()
        if "graph_paths" in payload:
            graphs = [load_graph(self._resolve_path(p)) for p in payload["graph_paths"]]
        elif "graphs" in payload:
            graphs = [graph_from_json(g) for g in payload["graphs"]]
        else:
            raise ValueError("payload must contain 'graphs' or 'graph_paths'")
        results = self.predictor.predict_batch(graphs)
        latency = round(time.perf_counter() - t0, 4)
        self._count(latency)
        return {"results": [_jsonable(r) for r in results], "count": len(results),
                "latency_s": latency}

    def _make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def _send(self, code: int, body: Dict[str, Any]):
                data = json.dumps(body).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                if self.path in ("/healthz", "/readyz", "/health"):
                    report = server.health()
                    self._send(200 if report["healthy"] else 503, report)
                elif self.path == "/info":
                    info = server.predictor.get_model_info()
                    with server._stats_lock:
                        info["serving_stats"] = dict(server.stats)
                    self._send(200, info)
                else:
                    self._send(404, {"error": "not found"})

            def do_POST(self):
                routes = {"/predict": server.handle_predict,
                          "/predict_batch": server.handle_predict_batch,
                          "/predict_slide": server.handle_predict_slide}
                handler = routes.get(self.path)
                if handler is None:
                    self._send(404, {"error": "not found"})
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(length) or b"{}")
                    body = handler(payload)
                except Exception as exc:  # noqa: BLE001 - a bad request must not stop the server
                    with server._stats_lock:
                        server.stats["errors"] += 1
                    self._send(400, {"error": f"{type(exc).__name__}: {exc}"})
                    return
                self._send(200, body)

            def log_message(self, *a):
                pass

        return Handler

    def start(self, background: bool = False):
        self._httpd = HTTPServer((self.host, self.port), self._make_handler())
        self.port = self._httpd.server_address[1]
        if background:
            self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
            self._thread.start()
            return self._thread
        self._httpd.serve_forever()

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
