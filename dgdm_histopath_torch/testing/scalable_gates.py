"""Scalable quality-gate execution: a persistent result cache and parallel
runs (counterpart of the JAX package's ``testing/scalable_gates.py``).

``package_fingerprint`` hashes (path, mtime, size) of the port's sources,
the CUDA kernels' ``.cu`` files among them, so that an edit anywhere
invalidates the cache. ``GateResultCache`` keeps the JAX package's SQLite
schema and key. ``ScalableQualityGateRunner`` runs gates in threads (the
default: they share one process and one card) or, with
``mode="process"``, each chunk in a fresh interpreter that gets the
runner's device.
"""

from __future__ import annotations

import hashlib
import json
import sqlite3
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor, as_completed
from pathlib import Path
from typing import Dict, List, Optional

from ..utils.logging import get_logger
from .quality_gates import GATES, QualityGateRunner, run_gate, score_report

logger = get_logger("testing.scalable")

FINGERPRINT_SUFFIXES = (".py", ".cu", ".cpp", ".h", ".yaml")


def package_fingerprint(root: Optional[Path] = None) -> str:
    """Hash of (path, mtime, size) over the package's source files: the
    cache's invalidation key."""
    root = Path(root) if root else Path(__file__).resolve().parent.parent
    h = hashlib.sha256()
    for p in sorted(root.rglob("*")):
        if p.suffix not in FINGERPRINT_SUFFIXES or not p.is_file():
            continue
        st = p.stat()
        h.update(f"{p.relative_to(root)}:{st.st_mtime_ns}:{st.st_size}\n".encode())
    return h.hexdigest()


class GateResultCache:
    """SQLite cache of gate results keyed by ``(gate_name, fingerprint,
    metadata)``. It serves passed results only by default: a cached failure
    is run again, since running again is how a fix shows."""

    def __init__(self, cache_dir: Path | str):
        self.cache_dir = Path(cache_dir)
        self.cache_dir.mkdir(parents=True, exist_ok=True)
        self.db_path = self.cache_dir / "gate_cache.db"
        self._lock = threading.Lock()
        # one connection shared by the worker threads, every use under _lock
        self._db = sqlite3.connect(str(self.db_path), check_same_thread=False)
        with self._lock, self._db as conn:
            conn.execute("""
                CREATE TABLE IF NOT EXISTS gate_results (
                    key TEXT PRIMARY KEY,
                    gate_name TEXT,
                    result TEXT,
                    timestamp REAL,
                    hits INTEGER DEFAULT 0
                )""")
            conn.execute("""
                CREATE INDEX IF NOT EXISTS idx_gate_ts
                ON gate_results(gate_name, timestamp)""")

    def close(self) -> None:
        with self._lock:
            self._db.close()

    @staticmethod
    def _key(gate_name: str, fingerprint: str, metadata: Dict) -> str:
        raw = json.dumps({"g": gate_name, "f": fingerprint, "m": metadata},
                         sort_keys=True, default=str)
        return hashlib.sha256(raw.encode()).hexdigest()

    def get(self, gate_name: str, fingerprint: str, metadata: Optional[Dict] = None,
            serve_failures: bool = False) -> Optional[Dict]:
        key = self._key(gate_name, fingerprint, metadata or {})
        with self._lock, self._db as conn:
            row = conn.execute("SELECT result, hits FROM gate_results WHERE key = ?",
                               (key,)).fetchone()
            if row is None:
                return None
            result = json.loads(row[0])
            if result.get("status") != "passed" and not serve_failures:
                return None
            conn.execute("UPDATE gate_results SET hits = ? WHERE key = ?", (row[1] + 1, key))
            result["cached"] = True
            result["cache_hits"] = row[1] + 1
            return result

    def put(self, gate_name: str, fingerprint: str, result: Dict,
            metadata: Optional[Dict] = None) -> None:
        key = self._key(gate_name, fingerprint, metadata or {})
        slim = {k: v for k, v in result.items() if k != "cached"}
        with self._lock, self._db as conn:
            conn.execute(
                "INSERT OR REPLACE INTO gate_results "
                "(key, gate_name, result, timestamp, hits) "
                "VALUES (?, ?, ?, ?, COALESCE((SELECT hits FROM gate_results "
                "WHERE key = ?), 0))",
                (key, gate_name, json.dumps(slim), time.time(), key))

    def stats(self) -> Dict:
        with self._lock, self._db as conn:
            row = conn.execute("SELECT COUNT(*), AVG(hits), MAX(hits), "
                               "COUNT(DISTINCT gate_name) FROM gate_results").fetchone()
        return {"total_entries": row[0] or 0, "average_hits": float(row[1] or 0),
                "max_hits": row[2] or 0, "unique_gates": row[3] or 0}

    def clear(self) -> None:
        with self._lock, self._db as conn:
            conn.execute("DELETE FROM gate_results")


def _run_gates_subprocess(names: List[str], device: str) -> List[Dict]:
    """Run a chunk of gates in a fresh interpreter on ``device``."""
    code = ("import json\n"
            "from dgdm_histopath_torch.testing.scalable_gates import run_gate\n"
            f"print(json.dumps([run_gate(n, {device!r}) for n in {names!r}]))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=1800)
    if proc.returncode != 0:
        return [{"name": n, "status": "failed", "duration_s": 0.0,
                 "error": f"worker died: {proc.stderr[-1000:]}"} for n in names]
    return json.loads(proc.stdout.strip().splitlines()[-1])


class ScalableQualityGateRunner(QualityGateRunner):
    """``QualityGateRunner`` + result cache + parallel execution.

    ``max_workers > 1`` runs gates concurrently, in threads by default;
    ``cache_dir`` turns on the persistent cache, keyed also by level and
    device: an unchanged source tree serves the gates that passed before.
    """

    def __init__(self, level: str = "development", fail_fast: bool = False,
                 cache_dir: Optional[Path | str] = None, max_workers: int = 4,
                 mode: str = "thread", device=None):
        super().__init__(level=level, fail_fast=fail_fast, device=device)
        if mode not in ("thread", "process"):
            raise ValueError(f"mode must be thread|process, got {mode!r}")
        self.cache = GateResultCache(cache_dir) if cache_dir else None
        self.max_workers = max(1, int(max_workers))
        self.mode = mode

    def run(self, selected: Optional[List[str]] = None) -> Dict:
        names = selected or list(GATES)
        fingerprint = package_fingerprint() if self.cache else ""
        meta = {"level": self.level, "device": str(self.device)}

        results: List[Optional[Dict]] = [None] * len(names)
        to_run: List[int] = []
        cache_hits = 0
        for i, name in enumerate(names):
            cached = self.cache.get(name, fingerprint, meta) if self.cache else None
            if cached is not None:
                results[i] = cached
                cache_hits += 1
            else:
                to_run.append(i)

        t0 = time.perf_counter()
        if self.mode == "process" and to_run:
            chunks = [c for c in (to_run[j::self.max_workers] for j in range(self.max_workers))
                      if c]
            with ThreadPoolExecutor(max_workers=len(chunks)) as pool:
                futs = {pool.submit(_run_gates_subprocess, [names[i] for i in c],
                                    str(self.device)): c for c in chunks}
                for fut in as_completed(futs):
                    for i, res in zip(futs[fut], fut.result()):
                        results[i] = res
        elif self.max_workers > 1 and len(to_run) > 1:
            with ThreadPoolExecutor(max_workers=self.max_workers) as pool:
                futs = {pool.submit(run_gate, names[i], self.device): i for i in to_run}
                for fut in as_completed(futs):
                    results[futs[fut]] = fut.result()
        else:
            for i in to_run:
                results[i] = run_gate(names[i], self.device)
                if results[i]["status"] == "failed" and self.fail_fast:
                    break
        wall = time.perf_counter() - t0

        results = [r for r in results if r is not None]
        if self.cache:
            for r in results:
                if not r.get("cached"):
                    self.cache.put(r["name"], fingerprint, r, meta)

        report = score_report(results, self.level)
        serial_s = sum(r["duration_s"] for r in results)
        report.update(cache_hits=cache_hits, parallel_wall_s=round(wall, 3),
                      serial_equivalent_s=round(serial_s, 3),
                      parallel_speedup=round(serial_s / wall, 2) if wall > 0.01 else None,
                      cache_stats=self.cache.stats() if self.cache else None)
        return report
