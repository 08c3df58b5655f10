"""The port's config system (``utils/config.py``), ``merge_cli_config``,
``TrainerConfig.from_config`` / ``DGDMTrainer.from_config``, logging and
validation against the JAX package's, on the CPU.

Configs are compared as the nested dicts ``config_to_dict`` gives, dict for
dict (equal); errors by type name and message (equal).
"""

import dataclasses
import json
import logging
from pathlib import Path

import pytest
import torch

from dgdm_histopath_tpu.cli import train as jcli
from dgdm_histopath_tpu.training import trainer as jtr
from dgdm_histopath_tpu.utils import config as jconfig
from dgdm_histopath_tpu.utils import validation as jvalid
from dgdm_histopath_tpu.utils.logging import SecurityAuditFilter as JaxFilter
from dgdm_histopath_torch.cli import train as tcli
from dgdm_histopath_torch.training import DGDMTrainer, TrainerConfig
from dgdm_histopath_torch.utils import config as tconfig
from dgdm_histopath_torch.utils import validation as tvalid
from dgdm_histopath_torch.utils.exceptions import ConfigurationError, ValidationError
from dgdm_histopath_torch.utils.logging import SecurityAuditFilter, get_logger, setup_logging

REPO = Path(__file__).resolve().parents[1]
CONFIGS = sorted((REPO / "configs").glob("*.yaml"))


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


@pytest.fixture(autouse=True)
def _no_dgdm_env(monkeypatch):
    import os
    for key in list(os.environ):
        if key.startswith("DGDM_"):
            monkeypatch.delenv(key)


@pytest.mark.parametrize("path", CONFIGS, ids=[p.stem for p in CONFIGS])
def test_every_yaml_config_loads_to_the_jax_dict(path):
    ours = tconfig.config_to_dict(tconfig.load_config(path))
    assert ours == jconfig.config_to_dict(jconfig.load_config(path))


def test_env_overrides_match_jax(monkeypatch):
    for key, value in {"DGDM_MODEL__HIDDEN_DIMS": "[256, 128]",
                       "DGDM_TRAINING__LEARNING_RATE": "3e-4",
                       "DGDM_DATA__BATCH_SIZE": "8", "DGDM_EXPERIMENT__NAME": "run7",
                       "DGDM_DATA__NODE_BUCKETS": "[64, 128]",
                       "DGDM_LOGGING__LOGGER_TYPE": "csv"}.items():
        monkeypatch.setenv(key, value)
    ours = tconfig.config_to_dict(tconfig.load_config(CONFIGS[0]))
    assert ours == jconfig.config_to_dict(jconfig.load_config(CONFIGS[0]))
    assert ours["model"]["hidden_dims"] == [256, 128] and ours["data"]["batch_size"] == 8


INVALID = {
    "node_features": {"model": {"node_features": 0}},
    "hidden_empty": {"model": {"hidden_dims": []}},
    "hidden_negative": {"model": {"hidden_dims": [64, -1]}},
    "heads": {"model": {"hidden_dims": [64, 30], "attention_heads": 8}},
    "dropout": {"model": {"dropout": 1.0}},
    "schedule": {"model": {"diffusion_schedule": "square"}},
    "pooling": {"model": {"pooling": "sum"}},
    "masking": {"training": {"masking_ratio": 0.0}},
    "splits": {"data": {"train_split": 0.5, "val_split": 0.2, "test_split": 0.2}},
    "buckets": {"data": {"node_buckets": [256, 128]}},
    "section": {"model": [1, 2]},
}


@pytest.mark.parametrize("name", sorted(INVALID))
def test_validate_errors_match_jax(name):
    with pytest.raises(Exception) as theirs:
        jconfig.load_config(overrides=INVALID[name])
    with pytest.raises(ConfigurationError) as ours:
        tconfig.load_config(overrides=INVALID[name])
    assert type(ours.value).__name__ == type(theirs.value).__name__
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("suffix", [".yaml", ".json"])
def test_save_load_round_trip_reads_in_both_packages(tmp_path, suffix):
    cfg = tconfig.load_config(CONFIGS[0], overrides={"model": {"num_classes": 3}})
    path = tmp_path / f"snapshot{suffix}"
    if suffix == ".json":
        path.write_text(json.dumps(tconfig.config_to_dict(cfg)))
    else:
        tconfig.save_config(cfg, path)
        tconfig.save_config(cfg, path)                  # the second save keeps a .bak
        assert path.with_suffix(".yaml.bak").exists()
    assert tconfig.config_to_dict(tconfig.load_config(path)) == tconfig.config_to_dict(cfg)
    assert jconfig.config_to_dict(jconfig.load_config(path)) == tconfig.config_to_dict(cfg)
    jpath = tmp_path / f"jax{suffix}"
    if suffix == ".yaml":
        jconfig.save_config(jconfig.load_config(path), jpath)
        assert jpath.read_text() == path.read_text()


def test_config_transaction_puts_the_old_file_back(tmp_path):
    path = tconfig.save_config(tconfig.DGDMConfig(), tmp_path / "c.yaml")
    before = path.read_bytes()
    with pytest.raises(RuntimeError):
        with tconfig.config_transaction(path):
            path.write_text("broken: [")
            raise RuntimeError("boom")
    assert path.read_bytes() == before
    merged = tconfig.merge_configs({"a": {"b": 1, "c": [1]}}, {"a": {"c": [2]}, "d": 3})
    assert merged == jconfig.merge_configs({"a": {"b": 1, "c": [1]}}, {"a": {"c": [2]}, "d": 3})


ARGVS = {
    "preset": ["train", "--preset", "dgdm-base", "--num-classes", "2", "--seed", "3"],
    "flags": ["train", "--config", str(CONFIGS[0]), "--hidden-dims", "64,32",
              "--attention-heads", "4", "--max-epochs", "3", "--pretrain-epochs", "1",
              "--learning-rate", "2e-3", "--batch-size", "2", "--scheduler", "onecycle",
              "--save-top-k", "1", "--dataset-type", "graph", "--precision", "32"],
    "survival": ["resume", "--preset", "dgdm-small", "--survival-mode", "discrete",
                 "--survival-intervals", "6", "--checkpoint-dir", "x", "--dropout", "0.2",
                 "--pooling", "mean", "--regression-targets", "1"],
    "mesh": ["train", "--mesh-shape", "2,4", "--devices", "8"],
}


@pytest.mark.parametrize("name", sorted(ARGVS))
def test_merge_cli_config_matches_jax(name):
    argv = ARGVS[name]
    ours = tcli.merge_cli_config(tcli.build_parser().parse_args(argv + ["--device", "cpu"]))
    theirs = jcli.merge_cli_config(jcli.build_parser().parse_args(argv))
    assert tconfig.config_to_dict(ours) == jconfig.config_to_dict(theirs)


def test_unknown_preset_exits_as_in_jax():
    with pytest.raises(SystemExit, match="unknown preset"):
        tcli.merge_cli_config(tcli.build_parser().parse_args(["--preset", "dgdm-huge"]))


def test_trainer_config_from_config_matches_jax():
    cfg = tconfig.load_config(CONFIGS[0], overrides={"advanced": {"gradient_clip_val": 0.5},
                                                     "training": {"warmup_steps": 7}})
    ours = dataclasses.asdict(TrainerConfig.from_config(cfg))
    theirs = dataclasses.asdict(jtr.TrainerConfig.from_config(
        jconfig.load_config(CONFIGS[0], overrides={"advanced": {"gradient_clip_val": 0.5},
                                                   "training": {"warmup_steps": 7}})))
    assert ours == theirs


def test_trainer_from_config_builds_the_configured_model_from_its_seed():
    over = {"model": {"node_features": 16, "hidden_dims": [32, 16], "attention_heads": 4,
                      "graph_layers": 1, "num_diffusion_steps": 3},
            "classification": {"enabled": True, "num_classes": 3},
            "regression": {"enabled": True, "num_targets": 2}}
    cfg = tconfig.load_config(overrides=over)
    a, b = (DGDMTrainer.from_config(cfg, device="cpu") for _ in range(2))
    other = DGDMTrainer.from_config(
        tconfig.load_config(overrides={**over, "experiment": {"seed": 1}}), device="cpu")
    assert a.model.num_classes == 3 and a.model.regression_targets == 2
    assert a.task == "classification" and a.model.graph_layers == 1
    assert a.config.warmup_steps == cfg.training.warmup_steps
    sa, sb, so = (t.model.state_dict() for t in (a, b, other))
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not all(torch.equal(sa[k], so[k]) for k in sa)


@pytest.mark.parametrize("over,item", [
    ({"hardware": {"mesh_shape": [2, 4], "mesh_axes": ["data", "model"]}}, 12),
    ({"model": {"moe_experts": 4}}, None),
    ({"model": {"param_dtype": "bfloat16"}}, 8),
    ({"advanced": {"accumulate_grad_batches": 2}}, None),
    ({"hardware": {"mesh_shape": [1, 2], "mesh_axes": ["data", "model"]}}, 12),
    ({"hardware": {"mesh_shape": [1, 4], "mesh_axes": ["data", "expert"]}}, 12),
])
def test_unported_config_options_raise_naming_their_item(over, item):
    """A mesh with an axis other than ``data`` above 1 and bfloat16
    parameters raise naming their item; ``moe_experts`` and
    ``accumulate_grad_batches`` build and take a step."""
    cfg = tconfig.load_config(overrides=over)
    if item is not None:
        with pytest.raises(NotImplementedError, match=f"ROADMAP queue 1, item {item}"):
            DGDMTrainer.from_config(cfg, device="cpu").init_state(0)
        return
    from test_torch_training import make_batch, to_torch_graph
    small = {"node_features": 16, "hidden_dims": [32, 16], "attention_heads": 4,
             "graph_layers": 1, "num_diffusion_steps": 3, "compute_dtype": "float32",
             "edge_features": 3}
    cfg = tconfig.load_config(overrides={**over, "model": {**small, **over.get("model", {})}})
    trainer = DGDMTrainer.from_config(cfg, device="cpu")
    trainer.init_state(0)
    metrics = trainer.training_step(to_torch_graph(make_batch()), 0)
    assert trainer.model.moe_experts == cfg.model.moe_experts
    assert trainer.config.accumulate_grad_batches == cfg.advanced.accumulate_grad_batches
    assert ("moe_aux_loss" in metrics) == bool(cfg.model.moe_experts)


@pytest.mark.parametrize("call", [
    ("validate_integer", (3.5, "n")), ("validate_integer", (7, "n", 0, 5)),
    ("validate_numeric", (float("nan"), "x")), ("validate_probability", (1.5, "p")),
    ("validate_enum", ("c", "e", ["a", "b"])), ("validate_boolean", ("maybe", "b")),
    ("validate_string", ("a b", "s", 4096, None, True)),
    ("validate_path", ("../x", "p")), ("validate_path", ("/nonexistent/x", "p", True)),
])
def test_input_validator_errors_match_jax(call):
    name, args = call
    with pytest.raises(Exception) as theirs:
        getattr(jvalid.InputValidator, name)(*args)
    with pytest.raises(ValidationError) as ours:
        getattr(tvalid.InputValidator, name)(*args)
    assert str(ours.value) == str(theirs.value)


def test_input_validator_accepts_what_jax_accepts(tmp_path):
    V, J = tvalid.InputValidator, jvalid.InputValidator
    assert V.validate_path(tmp_path, "d", must_exist=True) == J.validate_path(tmp_path, "d", True)
    assert V.validate_boolean("yes", "b") is True and V.validate_integer(4, "n", 0, 5) == 4
    arr = torch.zeros(2, 3)
    assert V.validate_array_shape(arr, "a", shape=(2, None)) is arr
    with pytest.raises(ValidationError, match="dim 1 mismatch"):
        V.validate_array_shape(arr, "a", shape=(2, 4))
    (tmp_path / "g.npz").write_bytes(b"x")
    assert tvalid.FileValidator.validate_graph_file(tmp_path / "g.npz").name == "g.npz"


def test_logging_redacts_secrets_as_jax_does(tmp_path):
    setup_logging("DEBUG", log_file=tmp_path / "log.jsonl")
    get_logger("test").info("password=hunter2 user 123-45-6789")
    record = logging.LogRecord("x", logging.INFO, "", 0, "token: abc and 123-45-6789", (), None)
    jrec = logging.LogRecord("x", logging.INFO, "", 0, "token: abc and 123-45-6789", (), None)
    SecurityAuditFilter().filter(record)
    JaxFilter().filter(jrec)
    assert record.getMessage() == jrec.getMessage() == "[REDACTED] and [REDACTED]"
    line = json.loads((tmp_path / "log.jsonl").read_text().splitlines()[-1])
    assert line["message"] == "[REDACTED] user [REDACTED]"
    assert line["logger"] == "dgdm_histopath_torch.test"
    setup_logging("WARNING")
