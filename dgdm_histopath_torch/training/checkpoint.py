"""Checkpoints with top-k retention on a monitored metric, and single-file
model bundles (counterpart of the JAX package's ``training/checkpoint.py``).

``CheckpointManager`` keeps the same ``index.json`` as the JAX package
(``records`` of ``{"step", "metric"[, "extra"]}``, ``best_step``,
``last_step``) and the same pruning: the ``save_top_k`` best scored steps
and the last step survive. A step's directory holds one ``state.pt``: the
trainer's ``state_dict()`` (model parameters, AdamW state, ``step``,
``seed``, ``current_epoch``, the gradient-accumulation buffer and
``mini_step``), tensors and plain numbers only, so
``torch.load(weights_only=True)`` reads it. Sidecar metadata stays in the
JSON index. Under data parallelism the state is the same on every rank:
rank 0 alone saves, and every rank restores from the same directory.

Saves run in the background. The optimizer updates parameters and moments
in place, so ``save`` first copies the state to host memory and only then
returns; a thread writes the file (temporary name, then rename), prunes and
writes the index (the same way). ``save``, ``restore`` and
``wait_until_finished`` wait for the save before.

``save_model_bundle`` / ``load_model_bundle`` write and read the JAX
package's ``named_paths_v2`` npz: every parameter under its flax path
(``convert.params_to_flax``), so the JAX package's ``load_model_bundle``
reads a port bundle and ``convert.load_jax_bundle`` reads either.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..convert import KEY_PREFIX, load_state, params_from_flax, params_to_flax
from ..utils.exceptions import CheckpointError
from ..utils.logging import get_logger

logger = get_logger("checkpoint")

STATE_FILE = "state.pt"


def _to_host(state: Any) -> Any:
    """A copy of ``state`` whose tensors live in host memory (a tensor already
    on the host is copied too: the trainer updates it in place)."""
    if isinstance(state, torch.Tensor):
        return state.detach().to("cpu", copy=True)
    if isinstance(state, dict):
        return {k: _to_host(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(_to_host(v) for v in state)
    return state


def _replace_atomically(path: Path, write) -> None:
    """``write(tmp_path)``, then rename over ``path``."""
    tmp = path.with_name(path.name + ".tmp")
    try:
        write(tmp)
        os.replace(tmp, path)
    finally:
        if tmp.exists():
            tmp.unlink()


class CheckpointManager:
    """Top-k + last checkpoint retention on a monitored metric (lower is
    better with ``mode="min"``)."""

    def __init__(self, directory: str | Path, save_top_k: int = 3,
                 monitor: str = "val_loss", mode: str = "min"):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.save_top_k = save_top_k
        self.monitor = monitor
        self.mode = mode
        self._index_path = self.directory / "index.json"
        self._index: Dict[str, Any] = self._load_index()
        self._thread: Optional[threading.Thread] = None
        self._error: List[BaseException] = []
        # per save: host copy (blocking) and write (background) in ms, bytes
        self.save_timings: List[Dict[str, float]] = []

    def _load_index(self) -> Dict[str, Any]:
        if self._index_path.exists():
            return json.loads(self._index_path.read_text())
        return {"records": [], "best_step": None, "last_step": None}

    def _step_dir(self, step: int) -> Path:
        return self.directory / f"step_{step:08d}"

    def save(self, state: Dict[str, Any], step: int, metric: Optional[float] = None,
             extra: Optional[Dict[str, Any]] = None) -> Path:
        """Copy ``state`` to the host, record it in the index and write it
        on a background thread."""
        path = self._step_dir(step)
        t0 = time.perf_counter()
        host = _to_host(state)
        self.wait_until_finished()
        rec: Dict[str, Any] = {"step": step, "metric": metric}
        if extra:
            rec["extra"] = extra
        self._index["records"] = [r for r in self._index["records"] if r["step"] != step]
        self._index["records"].append(rec)
        self._index["last_step"] = step
        pruned = []
        scored = [r for r in self._index["records"] if r["metric"] is not None]
        if scored:
            sign = 1.0 if self.mode == "min" else -1.0
            scored.sort(key=lambda r: sign * r["metric"])
            self._index["best_step"] = scored[0]["step"]
            keep = {r["step"] for r in scored[: self.save_top_k]}   # never prune the last
            keep.add(self._index["last_step"])
            for r in list(self._index["records"]):
                if r["step"] not in keep:
                    pruned.append(r["step"])
                    self._index["records"].remove(r)
        index_text = json.dumps(self._index, indent=2)
        timing: Dict[str, float] = {"step": step}
        self.save_timings.append(timing)

        def write():
            try:
                t1 = time.perf_counter()
                path.mkdir(parents=True, exist_ok=True)
                _replace_atomically(path / STATE_FILE, lambda tmp: torch.save(host, tmp))
                for old in pruned:
                    shutil.rmtree(self._step_dir(old), ignore_errors=True)
                _replace_atomically(self._index_path, lambda tmp: tmp.write_text(index_text))
                timing["background_ms"] = (time.perf_counter() - t1) * 1e3
                timing["bytes"] = (path / STATE_FILE).stat().st_size
            except BaseException as exc:  # noqa: BLE001 - raised by wait_until_finished
                self._error.append(exc)

        self._thread = threading.Thread(target=write, name=f"checkpoint-{step}", daemon=True)
        self._thread.start()
        timing["blocking_ms"] = (time.perf_counter() - t0) * 1e3
        logger.info("saving checkpoint step=%d metric=%s -> %s", step, metric, path)
        return path

    def wait_until_finished(self) -> None:
        """Wait for the save in flight; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error:
            exc = self._error.pop()
            raise CheckpointError("checkpoint write failed",
                                  {"dir": str(self.directory)}) from exc

    def close(self) -> None:
        self.wait_until_finished()

    def restore(self, step: Optional[int] = None, best: bool = False) -> Dict[str, Any]:
        """The state saved at ``step`` (default: the last step, or the best
        with ``best``), tensors on the host."""
        self.wait_until_finished()
        if step is None:
            step = self._index["best_step"] if best else self._index["last_step"]
        if step is None:
            raise CheckpointError("no checkpoint available", {"dir": str(self.directory)})
        path = self._step_dir(step) / STATE_FILE
        if not path.exists():
            raise CheckpointError("checkpoint path missing", {"path": str(path)})
        state = torch.load(path, map_location="cpu", weights_only=True)
        logger.info("restored checkpoint step=%d from %s", step, path.parent)
        return state

    @property
    def best_step(self) -> Optional[int]:
        return self._index["best_step"]

    @property
    def last_step(self) -> Optional[int]:
        return self._index["last_step"]

    def all_steps(self):
        return sorted(r["step"] for r in self._index["records"])

    def record_extra(self, step: Optional[int] = None) -> Dict[str, Any]:
        """Sidecar metadata stored with ``save(extra=...)`` (the mid-epoch
        resume position written on preemption); defaults to the last step."""
        if step is None:
            step = self._index["last_step"]
        for r in self._index["records"]:
            if r["step"] == step:
                return dict(r.get("extra") or {})
        return {}


def save_model_bundle(path: str | Path, model: torch.nn.Module, model_config: Dict[str, Any],
                      extra: Optional[Dict[str, Any]] = None) -> Path:
    """Single-file npz of ``model``'s parameters under their flax paths
    (``p:params/encoder/Dense_0/kernel``) and a ``__meta__`` JSON with
    ``model_config``, in the JAX package's ``named_paths_v2`` format."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays = {KEY_PREFIX + k: v for k, v in params_to_flax(model.state_dict(), model).items()}
    meta = {"model_config": model_config, "format": "named_paths_v2",
            "num_leaves": len(arrays), "extra": extra or {}}
    np.savez_compressed(path, __meta__=json.dumps(meta), **arrays)
    return path


def load_model_bundle(path: str | Path, model: torch.nn.Module) -> Dict[str, Any]:
    """Load a ``named_paths_v2`` bundle into ``model`` strictly (a missing,
    unexpected or misshapen parameter raises ``CheckpointError``); returns
    the bundle's meta."""
    with np.load(Path(path), allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
        if meta.get("format") != "named_paths_v2":
            raise CheckpointError("only named-path bundles (format named_paths_v2) "
                                  "can be loaded", {"format": meta.get("format")})
        flat = {k[len(KEY_PREFIX):]: data[k] for k in data.files if k.startswith(KEY_PREFIX)}
    load_state(model, params_from_flax(flat))
    return meta
