"""Inference server over DGDMPredictor: health probes, metrics, graph and
slide predict, rate limiting and dynamic batching (counterpart of the JAX
package's ``deployment/serving.py``).

Endpoints:
  GET  /healthz | /readyz | /health  — health report (ProductionHealthChecker)
  GET  /info                         — model metadata and serving counters
  GET  /metrics                      — Prometheus text exposition
  POST /predict        — JSON {"graph": {x, pos, nbr_idx, nbr_mask, edge_attr, node_mask}}
                         or {"graph_path": ...}
  POST /predict_batch  — JSON {"graphs": [graph, ...]} or {"graph_paths": [...]};
                         same-bucket graphs run as one batched forward
                         (DGDMPredictor.predict_batch)
  POST /predict_slide  — JSON {"slide_path": ...}: the whole slide pipeline
                         (DGDMPredictor.predict_slide)

Paths are read only under ``data_root`` (resolved; a path that leaves it is
refused), and only when the server was given one. Each caller (client IP) has
a token bucket of ``rate_limit_per_s`` requests a second, burst twice that;
a POST beyond it is answered 429 before its body is read.

Concurrency: the card is one queue of work. By default the server is
single-threaded and serves requests in order. With ``dynamic_batch > 0`` it
runs threaded IO and ONE device thread: concurrent ``/predict`` requests
coalesce into single ``predict_batch`` calls (``deployment/batching.py``).
Every predictor call holds ``_device_lock``, and every kernel launches on the
calling thread's current stream (the default stream).
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, HTTPServer, ThreadingHTTPServer
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..data.graph_io import load_graph
from ..ops.graph import PaddedGraph
from ..utils.logging import get_logger
from ..utils.security import RateLimiter
from .production import ProductionHealthChecker

logger = get_logger("serving")

# arrays above this many elements (pathological heatmaps) leave a response as None
MAX_JSON_ELEMENTS = 4_000_000


class _HTTPServer(HTTPServer):
    # a listen backlog of 5 (the default) drops the connections of a burst of
    # concurrent clients, which then retry after a second
    request_queue_size = 128


class _ThreadingHTTPServer(ThreadingHTTPServer):
    request_queue_size = 128


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
    """numpy arrays and scalars -> lists and Python numbers, recursively; an
    array of more than ``MAX_JSON_ELEMENTS`` elements -> None."""
    if isinstance(obj, np.ndarray):
        return obj.tolist() if obj.size <= MAX_JSON_ELEMENTS else None
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    return obj


def pad_shape_groups(graphs: List[PaddedGraph]) -> tuple:
    """Group ``graphs`` by (nodes, neighbors, features) and pad each group to
    a power of two with one of its own members: (padded list, the slot of
    each input in it). ``predict_batch`` stacks each group into one forward,
    so a group's batch size takes log2(max_batch) + 1 values at most."""
    groups: Dict[tuple, List[int]] = {}
    for i, g in enumerate(graphs):
        groups.setdefault((g.num_nodes, g.max_neighbors, g.feature_dim), []).append(i)
    padded: List[PaddedGraph] = []
    slot = [0] * len(graphs)
    for idxs in groups.values():
        for i in idxs:
            slot[i] = len(padded)
            padded.append(graphs[i])
        m = 1
        while m < len(idxs):
            m *= 2
        padded.extend([graphs[idxs[0]]] * (m - len(idxs)))
    return padded, slot


class InferenceServer:
    """Serves a DGDMPredictor over HTTP. ``port=0`` takes a free port; the
    bound port is ``self.port`` after :meth:`start`. ``dynamic_batch``: the
    largest batch of coalesced ``/predict`` requests (0 serializes them);
    ``batch_wait_ms``: how long a batch waits to fill; ``batch_timeout_s``:
    how long a request waits for its batch's result."""

    def __init__(self, predictor, port: int = 8080, host: str = "",
                 rate_limit_per_s: float = 50.0,
                 data_root: Optional[str | Path] = None,
                 dynamic_batch: int = 0, batch_wait_ms: float = 5.0,
                 batch_timeout_s: float = 60.0):
        self.predictor = predictor
        self.host, self.port = host, port
        self.health = ProductionHealthChecker(predictor)
        self.rate_limiter = RateLimiter(rate=rate_limit_per_s, burst=int(rate_limit_per_s * 2))
        # path loading is opt-in: without a data_root a client could make the
        # server read any file of the host
        self.data_root = Path(data_root).resolve() if data_root else None
        self.stats = {"requests": 0, "errors": 0, "total_latency_s": 0.0}
        self._stats_lock = threading.Lock()
        self._httpd: Optional[HTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self.batch_timeout_s = float(batch_timeout_s)
        # one device queue: every predictor call holds this lock
        self._device_lock = threading.Lock()
        self.batcher = None
        if dynamic_batch > 0:
            from .batching import DynamicBatcher
            self.batcher = DynamicBatcher(self._predict_many, max_batch=dynamic_batch,
                                          max_wait_ms=batch_wait_ms)

    def _predict_many(self, graphs: List[PaddedGraph]) -> List[Dict[str, Any]]:
        """The batcher's call: each shape group padded to a power of two,
        one ``predict_batch``, each result taken back from its own slot."""
        padded, slot = pad_shape_groups(graphs)
        with self._device_lock:
            results = self.predictor.predict_batch(padded)
        return [results[s] for s in slot]

    def _count(self, latency_s: float) -> None:
        with self._stats_lock:
            self.stats["requests"] += 1
            self.stats["total_latency_s"] += latency_s

    def _resolve_path(self, path: str) -> Path:
        """A client's path, confined to ``data_root``."""
        if self.data_root is None:
            raise PermissionError(
                "path-based graph loading is disabled: the server was started "
                "without data_root; send inline 'graph' JSON instead")
        resolved = (self.data_root / path).resolve()
        if self.data_root not in resolved.parents and resolved != self.data_root:
            raise PermissionError(f"graph path escapes data_root: {path!r}")
        return resolved

    def handle_predict(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        t0 = time.perf_counter()
        if "graph_path" in payload:
            graph = load_graph(self._resolve_path(payload["graph_path"]))
        elif "graph" in payload:
            graph = graph_from_json(payload["graph"])
        else:
            raise ValueError("payload must contain 'graph' or 'graph_path'")
        if self.batcher is not None:
            result = self.batcher(graph, timeout=self.batch_timeout_s)
        else:
            with self._device_lock:
                result = self.predictor.predict_graph(graph)
        out = _jsonable(result)
        out["latency_s"] = round(time.perf_counter() - t0, 4)
        self._count(out["latency_s"])
        return out

    def handle_predict_slide(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        """The whole slide pipeline on ``{"slide_path": <under data_root>}``."""
        t0 = time.perf_counter()
        if "slide_path" not in payload:
            raise ValueError("payload must contain 'slide_path'")
        path = self._resolve_path(payload["slide_path"])
        with self._device_lock:
            result = self.predictor.predict_slide(path)
        out = _jsonable(result)
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
        with self._device_lock:
            results = self.predictor.predict_batch(graphs)
        latency = round(time.perf_counter() - t0, 4)
        self._count(latency)
        return {"results": [_jsonable(r) for r in results], "count": len(results),
                "latency_s": latency}

    def warmup(self, num_nodes: int = 1024, max_neighbors: int = 8) -> int:
        """Run ``predict_batch`` on a zero graph of the bucket at each power
        of two up to the largest dynamic batch, before traffic: nothing
        compiles on the card, but this loads the kernels and grows the
        allocator and the cuBLAS workspaces. Returns the number of sizes."""
        model = self.predictor.model
        n, k = int(num_nodes), int(max_neighbors)
        g = PaddedGraph(
            x=torch.zeros(n, int(model.node_features)),
            pos=torch.zeros(n, 2),
            nbr_idx=torch.zeros(n, k, dtype=torch.int32),
            nbr_mask=torch.zeros(n, k, dtype=torch.bool),
            edge_attr=torch.zeros(n, k, int(model.edge_features)),
            node_mask=torch.ones(n, dtype=torch.bool))
        sizes, m = [], 1
        max_b = self.batcher.max_batch if self.batcher is not None else 1
        while m <= max_b:
            sizes.append(m)
            m *= 2
        for b in sizes:
            t0 = time.perf_counter()
            with self._device_lock:
                self.predictor.predict_batch([g] * b)
            logger.info("warmup: nodes=%d batch=%d in %.1fs", n, b, time.perf_counter() - t0)
        return len(sizes)

    def prometheus_metrics(self) -> str:
        """Prometheus text exposition of the serving counters."""
        with self._stats_lock:
            s = dict(self.stats)
        mean_lat = s["total_latency_s"] / max(s["requests"], 1)
        lines = [
            "# HELP dgdm_requests_total Total predict requests served.",
            "# TYPE dgdm_requests_total counter",
            f"dgdm_requests_total {s['requests']}",
            "# HELP dgdm_errors_total Total failed predict requests.",
            "# TYPE dgdm_errors_total counter",
            f"dgdm_errors_total {s['errors']}",
            "# HELP dgdm_request_latency_seconds_sum Cumulative predict latency.",
            "# TYPE dgdm_request_latency_seconds_sum counter",
            f"dgdm_request_latency_seconds_sum {s['total_latency_s']:.6f}",
            "# HELP dgdm_request_latency_seconds_mean Mean predict latency.",
            "# TYPE dgdm_request_latency_seconds_mean gauge",
            f"dgdm_request_latency_seconds_mean {mean_lat:.6f}",
        ]
        if self.batcher is not None:
            b = self.batcher.stats
            lines += [
                "# HELP dgdm_batches_total Dynamic batches executed.",
                "# TYPE dgdm_batches_total counter",
                f"dgdm_batches_total {int(b['batches'])}",
                "# HELP dgdm_batch_size_mean Mean dynamic batch size.",
                "# TYPE dgdm_batch_size_mean gauge",
                f"dgdm_batch_size_mean {self.batcher.mean_batch_size:.3f}",
                "# HELP dgdm_batch_size_max Largest dynamic batch seen.",
                "# TYPE dgdm_batch_size_max gauge",
                f"dgdm_batch_size_max {int(b['max_batch_seen'])}",
            ]
        return "\n".join(lines) + "\n"

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
                    report = server.health.check()
                    self._send(200 if report["healthy"] else 503, report)
                elif self.path == "/info":
                    info = server.predictor.get_model_info()
                    with server._stats_lock:
                        info["serving_stats"] = dict(server.stats)
                    self._send(200, info)
                elif self.path == "/metrics":
                    data = server.prometheus_metrics().encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/plain; version=0.0.4")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
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
                if not server.rate_limiter.allow(self.client_address[0]):
                    self._send(429, {"error": "rate limit exceeded"})
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(length) or b"{}")
                    body = handler(payload)
                except Exception as exc:  # noqa: BLE001 - a bad request must not stop the server
                    with server._stats_lock:
                        server.stats["errors"] += 1
                    logger.error("predict failed: %s", exc)
                    self._send(400, {"error": str(exc)})
                    return
                self._send(200, body)

            def log_message(self, *a):
                pass

        return Handler

    def start(self, background: bool = False):
        # with dynamic batching, IO must be concurrent for requests to
        # coalesce; without it, a serializing server is the device queue
        cls = _ThreadingHTTPServer if self.batcher is not None else _HTTPServer
        self._httpd = cls((self.host, self.port), self._make_handler())
        self.port = self._httpd.server_address[1]
        logger.info("inference server on :%d (dynamic_batch=%s)", self.port,
                    self.batcher.max_batch if self.batcher else "off")
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
        if self.batcher is not None:
            self.batcher.close()
