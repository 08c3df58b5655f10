"""Checkpoints, bundles, experiment logging and preemption handling of the
port against the JAX package's, on the CPU.

``index.json`` after the same sequence of saves: equal, and the same steps
kept on disk. A bundle written by the port loads in the JAX package's
``load_model_bundle`` (every flax path, no missing or unexpected name) and
the JAX model's logits on it are within 1e-5 of the port's (f32, the JAX
side at float32 matmul precision); ``params_to_flax`` inverts
``params_from_flax`` bit for bit. ``TrainLogger`` rows: equal but for the
wall-clock ``time`` column.
"""

import json
import os
import signal

import jax
import numpy as np
import pytest
import torch

from conftest import make_synthetic_graph
from dgdm_histopath_tpu.models import DGDMModel as JaxDGDM
from dgdm_histopath_tpu.ops.graph import batch_graphs as j_batch
from dgdm_histopath_tpu.training import checkpoint as jckpt
from dgdm_histopath_tpu.training import experiment_logging as jlog
from dgdm_histopath_tpu.training import preemption as jpre
from dgdm_histopath_tpu.utils.exceptions import CheckpointError as JaxCheckpointError
from dgdm_histopath_torch.convert import load_state, params_from_flax, params_to_flax
from dgdm_histopath_torch.models.dgdm import DGDMModel
from dgdm_histopath_torch.nn.layers import init_parameters
from dgdm_histopath_torch.training import (
    CheckpointManager,
    PreemptionGuard,
    TrainLogger,
    load_model_bundle,
    save_model_bundle,
    skip_batches,
)
from dgdm_histopath_torch.utils.exceptions import CheckpointError
from dgdm_histopath_torch.utils.monitoring import MetricsCollector, monitor_operation
from test_torch_model import KW, RNGS, _flat, to_torch_graph

METRICS = [0.5, 0.3, None, 0.4, 0.2, 0.6, 0.25]


def _save_sequence(mgr, state, extra_at=2):
    for step, metric in enumerate(METRICS):
        mgr.save(state, step=step, metric=metric,
                 extra={"resume": {"epoch": step}} if step == extra_at else None)
    mgr.wait_until_finished()


@pytest.mark.parametrize("top_k,mode", [(3, "min"), (1, "min"), (2, "max")])
def test_index_json_and_kept_steps_equal_jax(tmp_path, top_k, mode):
    ours = CheckpointManager(tmp_path / "port", save_top_k=top_k, mode=mode)
    theirs = jckpt.CheckpointManager(tmp_path / "jax", save_top_k=top_k, mode=mode)
    _save_sequence(ours, {"w": torch.arange(4.0)})
    _save_sequence(theirs, {"w": np.arange(4.0)})
    index = json.loads((tmp_path / "port" / "index.json").read_text())
    assert index == json.loads((tmp_path / "jax" / "index.json").read_text())
    assert ours.all_steps() == theirs.all_steps()
    assert (ours.best_step, ours.last_step) == (theirs.best_step, theirs.last_step)
    assert sorted(p.name for p in (tmp_path / "port").glob("step_*")) == sorted(
        p.name for p in (tmp_path / "jax").glob("step_*"))
    assert ours.record_extra(2) == theirs.record_extra(2)
    # a new manager over the directory reads the same index
    assert CheckpointManager(tmp_path / "port").all_steps() == ours.all_steps()


def test_restore_last_and_best_and_a_host_copy(tmp_path):
    mgr = CheckpointManager(tmp_path, save_top_k=2)
    w = torch.zeros(3)
    for step, metric in enumerate([0.5, 0.1, 0.3]):
        w.fill_(step)
        mgr.save({"w": w, "nested": {"step": step, "t": [w * 2]}}, step=step, metric=metric)
        w.add_(100.0)                  # the in-place update after save changes no checkpoint
    assert torch.equal(mgr.restore()["w"], torch.full((3,), 2.0))
    best = mgr.restore(best=True)
    assert best["nested"]["step"] == 1 and torch.equal(best["nested"]["t"][0], torch.full((3,), 2.0))
    assert mgr.all_steps() == [1, 2] and not (tmp_path / "step_00000000").exists()
    assert [t["step"] for t in mgr.save_timings] == [0, 1, 2]
    assert all(t["bytes"] > 0 and t["background_ms"] >= 0 for t in mgr.save_timings)
    with pytest.raises(CheckpointError, match="checkpoint path missing"):
        mgr.restore(step=0)
    with pytest.raises(CheckpointError, match="no checkpoint available"):
        CheckpointManager(tmp_path / "empty").restore()
    assert not list(tmp_path.rglob("*.tmp"))


@pytest.fixture(scope="module")
def jax_small():
    batch = j_batch([make_synthetic_graph(seed=i, n_nodes=128, n_real=100, feat_dim=16)
                     for i in range(2)])
    jm = JaxDGDM(**KW, gather_impl="xla")
    with jax.default_matmul_precision("float32"):
        params = jax.jit(lambda g: jm.init(RNGS, g, mode="pretrain", deterministic=True))(batch)
    return jm, params, batch


def _port_model(seed=3):
    return init_parameters(DGDMModel(**KW), torch.Generator().manual_seed(seed)).eval()


def test_port_bundle_loads_in_jax_with_the_same_logits(tmp_path, jax_small):
    jm, template, batch = jax_small
    tm = _port_model()
    save_model_bundle(tmp_path / "m.npz", tm, {"node_features": 16}, extra={"k": 1})
    params = jckpt.load_model_bundle(tmp_path / "m.npz", template)
    with jax.default_matmul_precision("float32"):
        ref = jm.apply(params, batch, mode="inference", deterministic=True)
    with torch.inference_mode():
        out = tm(to_torch_graph(batch), mode="inference")
    for key in ("classification_logits", "graph_embedding"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), atol=1e-5,
                                   rtol=1e-5)
    meta = json.loads(str(np.load(tmp_path / "m.npz")["__meta__"]))
    assert meta == {"model_config": {"node_features": 16}, "format": "named_paths_v2",
                    "num_leaves": len(_flat(template)), "extra": {"k": 1}}


def test_jax_bundle_loads_in_the_port_and_files_match(tmp_path, jax_small):
    _, params, _ = jax_small
    jckpt.save_model_bundle(tmp_path / "jax.npz", params, {"a": 1})
    tm = DGDMModel(**KW)
    meta = load_model_bundle(tmp_path / "jax.npz", tm)
    assert meta["model_config"] == {"a": 1}
    ref = params_from_flax(_flat(params))
    assert all(torch.equal(v, ref[k]) for k, v in tm.state_dict().items())
    save_model_bundle(tmp_path / "port.npz", tm, {"a": 1})
    ours, theirs = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    assert sorted(ours.files) == sorted(theirs.files)
    for k in theirs.files:
        if k != "__meta__":
            assert ours[k].dtype == theirs[k].dtype and np.array_equal(ours[k], theirs[k]), k


@pytest.mark.parametrize("loader", ["jax", "port"])
def test_a_renamed_module_fails_loudly(tmp_path, jax_small, loader):
    _, template, _ = jax_small
    save_model_bundle(tmp_path / "m.npz", _port_model(), {})
    data = dict(np.load(tmp_path / "m.npz"))
    renamed = {k.replace("/pool/k_proj/", "/pool/key_proj/"): v for k, v in data.items()}
    assert renamed.keys() != data.keys()
    np.savez(tmp_path / "renamed.npz", **renamed)
    if loader == "jax":
        with pytest.raises(JaxCheckpointError, match="paths mismatch"):
            jckpt.load_model_bundle(tmp_path / "renamed.npz", template)
    else:
        with pytest.raises(CheckpointError, match="paths mismatch"):
            load_model_bundle(tmp_path / "renamed.npz", DGDMModel(**KW))


@pytest.mark.parametrize("extra", [dict(), dict(spatial_window=32, graph_window=32),
                                   dict(survival_mode="cox", pooling="mean",
                                        use_hierarchical=False)])
def test_params_to_flax_inverts_params_from_flax(extra):
    kw = {**KW, **extra}
    batch = j_batch([make_synthetic_graph(seed=0, n_nodes=128, n_real=100, feat_dim=16)])
    jm = JaxDGDM(**kw, gather_impl="xla")
    params = jax.jit(lambda g: jm.init(RNGS, g, mode="pretrain", deterministic=True))(batch)
    flat = _flat(params)
    tm = DGDMModel(**kw)
    load_state(tm, params_from_flax(flat))
    back = params_to_flax(tm.state_dict(), tm)
    assert back.keys() == flat.keys()
    for k, v in flat.items():
        assert back[k].shape == v.shape and np.array_equal(back[k], v), k


SUMMARIES = [{"train_loss": 1.5, "epoch": 0, "phase": "pretrain", "steps": 4, "ok": True},
             {"train_loss": 0.5, "epoch": 1, "phase": "finetune", "val_loss": 0.7,
              "val_accuracy": 0.5}]


@pytest.mark.parametrize("kind", ["csv", "none"])
def test_train_logger_rows_equal_jax(tmp_path, kind):
    rows = {}
    for name, cls in (("port", TrainLogger), ("jax", jlog.TrainLogger)):
        logger = cls(tmp_path / name, logger_type=kind, run_name="r")
        logger.log_hparams({"model": {"hidden_dims": [4, 2]}, "seed": 1})
        for step, summary in enumerate(SUMMARIES):
            logger.log_metrics(summary, step=step)
        logger.close()
        d = tmp_path / name
        rows[name] = ([{k: v for k, v in json.loads(line).items() if k != "time"}
                       for line in (d / "metrics.jsonl").read_text().splitlines()],
                      [[c for i, c in enumerate(line.split(",")) if i != 1]
                       for line in (d / "metrics.csv").read_text().splitlines()],
                      (d / "hparams.json").read_text())
    assert rows["port"] == rows["jax"]
    assert rows["port"][1][0] == ["step", "train_loss", "epoch", "steps", "val_loss",
                                  "val_accuracy"]
    with pytest.raises(ValueError, match="unknown logger_type"):
        TrainLogger(tmp_path / "x", logger_type="mlflow")


def test_train_logger_warns_and_keeps_csv_without_tensorboard(tmp_path, monkeypatch, caplog):
    import logging
    import sys
    # setup_logging (any CLI run in this process) stops the package's records
    # at its own root; let them reach caplog's handler
    monkeypatch.setattr(logging.getLogger("dgdm_histopath_torch"), "propagate", True)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    logger = TrainLogger(tmp_path, logger_type="tensorboard")
    logger.log_metrics({"loss": 1.0}, step=0)
    logger.close()
    assert "tensorboard unavailable" in caplog.text
    assert (tmp_path / "metrics.csv").read_text().startswith("step,time,loss")


def test_preemption_guard_takes_sigterm_and_gives_it_back():
    before = signal.getsignal(signal.SIGTERM)
    with PreemptionGuard() as guard:
        assert not guard.triggered
        os.kill(os.getpid(), signal.SIGTERM)
        assert guard.triggered
        guard.reset()
        assert not guard.triggered
    assert signal.getsignal(signal.SIGTERM) is before
    manual = PreemptionGuard(install=False)
    manual.trigger()
    assert manual.triggered and signal.getsignal(signal.SIGTERM) is before


@pytest.mark.parametrize("n", [0, 2, 5, 9])
def test_skip_batches_matches_jax(n):
    assert list(skip_batches(range(7), n)) == list(jpre.skip_batches(range(7), n))


def test_monitor_operation_records_each_call():
    collector = MetricsCollector()
    for _ in range(2):
        with monitor_operation("epoch", collector=collector):
            pass
    with pytest.raises(RuntimeError):
        with monitor_operation("epoch", collector=collector, trace=False):
            raise RuntimeError("inside")
    summary = collector.summary("epoch")["epoch"]
    assert summary["count"] == 3 and summary["min_s"] >= 0.0
    collector.increment("n", 2)
    assert collector.counters() == {"n": 2.0}
