"""The port's ``train`` and ``predict`` CLIs against the JAX package's, on
the CPU (``--device cpu``), at a tiny width.

The same argv gives the same output files, index and log columns, history
phases and keys, config snapshot (equal text), bundle names, shapes and meta
(so the JAX package's ``load_model_bundle`` takes the port's bundle), and
each step's learning rate (equal within f32 rounding, 1e-6: both keep the
schedule built at construction with the default horizon of 1000 steps an
epoch). ``validate`` prints the same JSON keys. A run stopped by SIGTERM
exits 75 and ``resume`` ends with the uninterrupted run's bundle, equal to
the bit. ``predict`` on the port's bundle: probabilities within 1e-5 of the
JAX CLI's on the same bundle (float32 matmuls on the JAX side), the same CSV
rows.
"""

import contextlib
import csv
import io
import json
import logging
import os
import signal
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from conftest import make_synthetic_graph
from dgdm_histopath_tpu.cli import predict as jpredict
from dgdm_histopath_tpu.cli import train as jtrain
from dgdm_histopath_tpu.training import trainer as jtr
from dgdm_histopath_torch.cli import predict as tpredict
from dgdm_histopath_torch.cli import train as ttrain
from dgdm_histopath_torch.data import save_graph
from dgdm_histopath_torch.training import trainer as ttr
from test_torch_training import to_torch_graph

REPO = Path(__file__).resolve().parents[1]
CONFIG = {"data": {"train_split": 0.5, "val_split": 0.25, "test_split": 0.25, "batch_size": 2},
          "training": {"max_epochs": 2, "pretrain_epochs": 1, "warmup_steps": 2},
          "logging": {"logger_type": "csv"},
          "model": {"node_features": 16, "hidden_dims": [32, 16], "attention_heads": 4,
                    "graph_layers": 1, "num_diffusion_steps": 3, "compute_dtype": "float32",
                    "dropout": 0.0, "use_hierarchical": False, "use_spatial_attention": False}}


@pytest.fixture(autouse=True, scope="module")
def _package_loggers_put_back():
    """``setup_logging`` (the CLIs call it) stops each package's records at
    its own logger; put both loggers back as they were, so that the tests
    after this file still see the records through ``caplog``."""
    loggers = [logging.getLogger(n) for n in ("dgdm_histopath_torch", "dgdm_histopath_tpu")]
    saved = [(lg.level, lg.propagate, list(lg.handlers)) for lg in loggers]
    yield
    for lg, (level, propagate, handlers) in zip(loggers, saved):
        lg.setLevel(level)
        lg.propagate = propagate
        lg.handlers[:] = handlers


def _argv(root, *extra):
    return ["--config", str(root / "config.json"), "--data-dir", str(root / "data"),
            "--dataset-type", "graph", "--metadata", str(root / "labels.json"),
            "--num-classes", "2", "--seed", "0", "--log-level", "WARNING", *extra]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both CLIs' ``train`` and ``validate`` on the same 12 graph files, each
    step's learning rate recorded."""
    root = tmp_path_factory.mktemp("cli")
    labels = {}
    for i in range(12):
        g = make_synthetic_graph(n_nodes=64, n_real=50, feat_dim=16, seed=i)
        save_graph(to_torch_graph(g), root / "data" / f"s{i:02d}_graph.npz")
        labels[f"s{i:02d}"] = i % 2
    (root / "labels.json").write_text(json.dumps(labels))
    (root / "config.json").write_text(json.dumps(CONFIG))
    lrs = {"jax": [], "port": []}
    schedules, steps = [], []
    with pytest.MonkeyPatch.context() as mp:
        make = jtr.make_lr_schedule
        mp.setattr(jtr, "make_lr_schedule", lambda cfg: schedules.append(make(cfg)) or
                   schedules[-1])
        jstep = jtr.DGDMTrainer.training_step
        mp.setattr(jtr.DGDMTrainer, "training_step",
                   lambda self, *a, **k: steps.append(1) or jstep(self, *a, **k))
        tstep = ttr.DGDMTrainer._step              # the step that fit takes

        def port_step(self, *a, **k):
            out = tstep(self, *a, **k)
            lrs["port"].append(self.optimizer.param_groups[0]["lr"])
            return out

        mp.setattr(ttr.DGDMTrainer, "_step", port_step)
        rc = {"jax": jtrain.main(["train", *_argv(root, "--output-dir", str(root / "J"))]),
              "port": ttrain.main(["train", *_argv(root, "--output-dir", str(root / "P"),
                                                   "--device", "cpu")])}
    lrs["jax"] = [float(schedules[0](i)) for i in range(len(steps))]
    printed = {}
    for name, main, ckpt, extra in (("jax", jtrain.main, root / "J", ()),
                                    ("port", ttrain.main, root / "P", ("--device", "cpu"))):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc[f"{name}_validate"] = main(["validate", *_argv(root, *extra),
                                           "--checkpoint-dir", str(ckpt / "checkpoints")])
        printed[name] = json.loads(out.getvalue().strip().splitlines()[-1])
    return {"root": root, "rc": rc, "lrs": lrs, "validate": printed}


def _tree(d: Path):
    return sorted(str(p.relative_to(d)) for p in d.rglob("*")
                  if "step_0" not in str(p.relative_to(d)))


def test_train_cli_writes_the_jax_outputs(runs):
    root = runs["root"]
    J, P = root / "J", root / "P"
    assert runs["rc"]["jax"] == runs["rc"]["port"] == 0
    assert _tree(P) == _tree(J)
    assert (P / "config_snapshot.yaml").read_text() == (J / "config_snapshot.yaml").read_text()
    assert (P / "logs" / "hparams.json").read_text() == (J / "logs" / "hparams.json").read_text()
    ji, pi = (json.loads((d / "checkpoints" / "index.json").read_text()) for d in (J, P))
    assert pi.keys() == ji.keys() and pi["last_step"] == ji["last_step"]
    assert [r["step"] for r in pi["records"]] == [r["step"] for r in ji["records"]]
    assert sorted(p.name for p in (P / "checkpoints").glob("step_*")) == sorted(
        p.name for p in (J / "checkpoints").glob("step_*"))
    for name in ("metrics.csv",):
        assert ((P / "logs" / name).read_text().splitlines()[0]
                == (J / "logs" / name).read_text().splitlines()[0])
    jh, ph = (json.loads((d / "history.json").read_text()) for d in (J, P))
    assert [h["phase"] for h in ph] == [h["phase"] for h in jh] == ["pretrain", "finetune"]
    assert [sorted(h) for h in ph] == [sorted(h) for h in jh]
    with np.load(J / "final_model.npz") as jb, np.load(P / "final_model.npz") as pb:
        assert sorted(pb.files) == sorted(jb.files)
        for k in jb.files:
            assert pb[k].shape == jb[k].shape and pb[k].dtype == jb[k].dtype, k
        assert json.loads(str(pb["__meta__"])) == json.loads(str(jb["__meta__"]))


def test_each_step_learning_rate_equals_the_jax_cli(runs):
    """The schedule is built with the trainer, before the CLI sets
    ``steps_per_epoch``: both keep the horizon of 1000 steps an epoch, so the
    finetune epoch's steps carry no x0.1 drop."""
    ours, theirs = runs["lrs"]["port"], runs["lrs"]["jax"]
    assert len(ours) == len(theirs) == 6                # 3 steps in each of 2 epochs
    np.testing.assert_allclose(ours, theirs, rtol=1e-6, atol=0)
    peak = CONFIG["training"].get("learning_rate", 1e-4)
    assert ours[0] == 0.0 and ours[3] > 0.9 * peak      # no drop at the phase switch


def test_validate_prints_the_jax_json(runs):
    assert runs["rc"]["jax_validate"] == runs["rc"]["port_validate"] == 0
    ours, theirs = runs["validate"]["port"], runs["validate"]["jax"]
    assert ours.keys() == theirs.keys() == {"val_loss", "batches"}
    assert ours["batches"] == theirs["batches"] == 1 and np.isfinite(ours["val_loss"])


def test_sigterm_exits_75_and_resume_ends_with_the_whole_runs_bundle(runs, monkeypatch):
    root = runs["root"]
    before = signal.getsignal(signal.SIGTERM)
    step = ttr.DGDMTrainer._step                   # the step that fit takes

    def step_then_sigterm(self, *a, **k):
        out = step(self, *a, **k)
        if self.step == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    monkeypatch.setattr(ttr.DGDMTrainer, "_step", step_then_sigterm)
    argv = _argv(root, "--output-dir", str(root / "B"), "--device", "cpu")
    assert ttrain.main(["train", *argv]) == 75
    monkeypatch.setattr(ttr.DGDMTrainer, "_step", step)
    index = json.loads((root / "B" / "checkpoints" / "index.json").read_text())
    assert index["records"][-1]["extra"]["resume"] == {"epoch": 0, "step_in_epoch": 2,
                                                       "mid_epoch": True}
    assert ttrain.main(["resume", *argv, "--checkpoint-dir", str(root / "B" / "checkpoints")]) == 0
    with np.load(root / "P" / "final_model.npz") as a, np.load(root / "B" / "final_model.npz") as b:
        assert all(np.array_equal(a[k], b[k]) for k in a.files)
    whole, resumed = (json.loads((root / d / "history.json").read_text()) for d in ("P", "B"))
    assert {k: v for k, v in resumed[-1].items() if k != "epoch_time_s"} == {
        k: v for k, v in whole[-1].items() if k != "epoch_time_s"}
    assert signal.getsignal(signal.SIGTERM) is before     # main gives the handler back


def test_predict_cli_json_and_csv_match_jax(runs):
    root = runs["root"]
    bundle = str(root / "P" / "final_model.npz")
    argv = ["--model", bundle, "--input", str(root / "data"), "--format", "both",
            "--log-level", "WARNING"]
    assert tpredict.main([*argv, "--output-dir", str(root / "TP"), "--device", "cpu"]) == 0
    with jax.default_matmul_precision("float32"):
        assert jpredict.main([*argv, "--output-dir", str(root / "JP")]) == 0
    names = sorted(p.name for p in (root / "JP").glob("*.json"))
    assert names == sorted(p.name for p in (root / "TP").glob("*.json")) and len(names) == 12
    for name in names:
        ours, theirs = (json.loads((root / d / name).read_text()) for d in ("TP", "JP"))
        assert ours.keys() == theirs.keys()
        assert ours["slide_id"] == theirs["slide_id"]
        assert ours["predicted_class"] == theirs["predicted_class"]
        np.testing.assert_allclose(ours["probabilities"], theirs["probabilities"], atol=1e-5)
    rows = [list(csv.reader((root / d / "predictions.csv").open())) for d in ("TP", "JP")]
    assert rows[0][0] == rows[1][0] == ["slide_id", "predicted_class", "confidence", "entropy"]
    for a, b in zip(rows[0][1:], rows[1][1:]):
        assert a[:2] == b[:2]
        np.testing.assert_allclose([float(a[2]), float(a[3])], [float(b[2]), float(b[3])],
                                   atol=1e-5)


@pytest.mark.parametrize("which", ["train", "predict"])
def test_cli_without_a_card_exits_with_an_error(runs, which, capsys):
    assert not torch.cuda.is_available()
    root = runs["root"]
    argv = (["train", *_argv(root, "--output-dir", str(root / "nocard"))] if which == "train"
            else ["--model", str(root / "P" / "final_model.npz"), "--input",
                  str(root / "data"), "--output-dir", str(root / "nocard")])
    main = ttrain.main if which == "train" else tpredict.main
    with pytest.raises(SystemExit) as exc:
        main(argv)
    assert exc.value.code == 2 and "no CUDA device" in capsys.readouterr().err
    assert not (root / "nocard").exists()


@pytest.mark.parametrize("flags", [["--mesh-shape", "2,2"], ["--devices", "4"]])
def test_parallel_flags_of_item_12_work(runs, flags):
    """``--mesh-shape 2,2`` (axes data, model: 4 gloo ranks, 2-way data and
    2-way tensor parallel) writes a bundle of whole tensors within the
    tensor-parallel bounds of the one-process run's: 1e-5 of max(1, the
    tensor's largest entry), the shift-invariant key biases to the steps'
    summed learning rate. ``--devices`` is read by nothing, as in the JAX
    CLI: the run equals the one without it."""
    root = runs["root"]
    argv = ["train", *_argv(root, "--output-dir", str(root / "mesh"), "--device", "cpu",
                            *flags)]
    assert ttrain.main(argv) == 0
    with np.load(root / "P" / "final_model.npz") as a, \
            np.load(root / "mesh" / "final_model.npz") as b:
        assert set(a.files) == set(b.files)
        if flags[0] == "--devices":
            assert all(np.array_equal(a[k], b[k]) for k in a.files)
            return
        lr_sum = sum(runs["lrs"]["port"])
        for k in a.files:
            if k == "__meta__":
                continue
            assert a[k].shape == b[k].shape, k
            bound = lr_sum if k.endswith(("k_proj/bias", "risk/bias")) else \
                1e-5 * max(1.0, float(np.abs(a[k]).max()))
            assert float(np.abs(a[k] - b[k]).max()) <= bound, k


@pytest.mark.parametrize("flags,item", [(["--save-heatmaps"], 11), (["--quant", "int8"], 13)])
def test_predict_flags_of_items_11_and_13_work(runs, flags, item, monkeypatch):
    """``--save-heatmaps`` (item 11) writes a summary PNG and HTML beside each
    graph's JSON. ``--quant int8`` (item 13) predicts each graph through
    ``int8_apply`` (this model's Dense layers are narrower than 64, so none
    is rerouted), as ``DGDMPredictor(quant="int8")`` does."""
    from dgdm_histopath_torch.evaluation import predictor as tpred

    root = runs["root"]
    out = root / f"x{item}"
    argv = ["--model", str(root / "P" / "final_model.npz"), "--input", str(root / "data"),
            "--output-dir", str(out), "--device", "cpu", "--log-level", "WARNING", *flags]
    calls = []
    int8_apply = tpred.int8_apply
    monkeypatch.setattr(tpred, "int8_apply", lambda *a, **k: calls.append(1) or
                        int8_apply(*a, **k))
    assert tpredict.main(argv) == 0
    stems = sorted(p.stem for p in out.glob("*.json"))
    assert len(stems) == 12
    if item == 11:
        assert not calls
        assert all((out / f"{s}_summary.png").exists()
                   and (out / f"{s}_summary.html").exists() for s in stems)
        return
    assert len(calls) == 12
    pred = tpred.DGDMPredictor(model_path=root / "P" / "final_model.npz", device="cpu",
                               feature_extractor="none", quant="int8")
    from dgdm_histopath_torch.data import load_graph
    for s in stems:
        want = pred.predict_graph(load_graph(root / "data" / f"{s}.npz"))
        got = json.loads((out / f"{s}.json").read_text())
        assert got["predicted_class"] == want["predicted_class"]
        np.testing.assert_allclose(got["probabilities"], want["probabilities"], atol=1e-7)


def test_slide_dataset_type_trains_through_the_cli(tmp_path):
    from dgdm_histopath_torch.preprocessing import synthetic
    from dgdm_histopath_torch.preprocessing.tiff import write_tiled_tiff

    for i in range(4):
        img, _ = synthetic.generate_tissue_image(512, 512, seed=30 + i)
        write_tiled_tiff(tmp_path / "slides" / f"case{i}.tif", synthetic.build_pyramid(img, 3),
                         tile=128, compression="deflate", description="Aperio S|AppMag = 20")
    (tmp_path / "labels.json").write_text(json.dumps({f"case{i}": i % 2 for i in range(4)}))
    cfg = {**CONFIG, "model": {**CONFIG["model"], "node_features": 14},
           "data": {**CONFIG["data"], "patch_size": 32, "max_patches": 30,
                    "tissue_threshold": 0.3, "node_buckets": [32], "feature_extractor": "stats"}}
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    rc = ttrain.main(["train", "--config", str(tmp_path / "config.json"), "--data-dir",
                      str(tmp_path / "slides"), "--dataset-type", "slide", "--metadata",
                      str(tmp_path / "labels.json"), "--num-classes", "2", "--device", "cpu",
                      "--output-dir", str(tmp_path / "out"), "--log-level", "WARNING"])
    history = json.loads((tmp_path / "out" / "history.json").read_text())
    assert rc == 0 and [h["phase"] for h in history] == ["pretrain", "finetune"]
    with np.load(tmp_path / "out" / "final_model.npz") as b:
        assert json.loads(str(b["__meta__"]))["model_config"]["node_features"] == 14


def test_clis_run_with_jax_blocked(runs, tmp_path):
    """train, then predict on its bundle, with jax, flax and the JAX package
    unimportable."""
    root = runs["root"]
    code = (
        "import sys\n"
        "for m in ('jax', 'flax', 'dgdm_histopath_tpu'): sys.modules[m] = None\n"
        "from dgdm_histopath_torch.cli import predict, train\n"
        f"args = {_argv(root, '--output-dir', str(tmp_path / 'out'), '--device', 'cpu')!r}\n"
        "assert train.main(['train', *args]) == 0\n"
        f"assert predict.main(['--model', {str(tmp_path / 'out' / 'final_model.npz')!r},"
        f" '--input', {str(root / 'data' / 's00_graph.npz')!r}, '--output-dir',"
        f" {str(tmp_path / 'pred')!r}, '--device', 'cpu']) == 0\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env={**os.environ, "PYTHONPATH": str(REPO)}, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().endswith("ok") and (tmp_path / "pred" / "s00_graph.json").exists()
