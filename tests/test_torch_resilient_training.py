"""``ResilientTrainer`` on the port against the JAX package's, on the CPU.

The JAX package's own cases (``tests/test_distributed_processing.py``,
``TestResilientTrainer``) run on both packages over the same flaky trainer
and must leave the same results and statistics. Then the port's real
``DGDMTrainer`` at a tiny width (f32, dropout 0.1 so that the draws
matter): a failure raised in the forward before the update is retried and
the run replays the uninterrupted one bit for bit, metrics and parameters;
checkpoints every 2 steps and ``recover_from_checkpoint`` continue the run
bit for bit. A failure inside the optimizer's update is not replayed: the
parameters it already wrote stay (the JAX step is functional), which the
last test records.
"""

import numpy as np
import pytest
import torch

from dgdm_histopath_torch.models.dgdm import DGDMModel
from dgdm_histopath_torch.nn.layers import init_parameters
from dgdm_histopath_torch.testing.quality_gates import _tiny_graph
from dgdm_histopath_torch.training import CheckpointManager, DGDMTrainer, TrainerConfig
from dgdm_histopath_torch.utils.resilient_training import ResilientTrainer
from dgdm_histopath_tpu.utils.resilient_training import ResilientTrainer as JaxResilientTrainer


class _FlakyTrainer:
    def __init__(self, fail_times: int):
        self.state = object()
        self.fail_times = fail_times
        self.calls = 0

    def training_step(self, batch, epoch=None):
        self.calls += 1
        if self.calls <= self.fail_times:
            raise RuntimeError("transient device error")
        return {"loss": 1.0 / self.calls}


def _recovers(cls):
    rt = cls(_FlakyTrainer(fail_times=1), max_batch_retries=2)
    return rt.training_step(batch=None), rt.stats


def _skips(cls):
    rt = cls(_FlakyTrainer(fail_times=100), max_batch_retries=1, skip_failed_batches=True)
    return rt.training_step(batch=None), rt.stats


def _raises(cls):
    rt = cls(_FlakyTrainer(fail_times=100), max_batch_retries=0, skip_failed_batches=False)
    with pytest.raises(RuntimeError):
        rt.training_step(batch=None)
    return rt.stats


def _epoch(cls):
    rt = cls(_FlakyTrainer(fail_times=0))
    report = rt.train_epoch([None, None, None], epoch=0)
    report.pop("duration_s")
    assert report["batches"] == 3 and np.isfinite(report["mean_loss"])
    return report, rt.best_step, rt.best_loss


@pytest.mark.parametrize("case", [_recovers, _skips, _raises, _epoch],
                         ids=["recovers", "skips", "raises", "epoch"])
def test_jax_resilient_trainer_cases_give_the_same_results(case):
    assert case(ResilientTrainer) == case(JaxResilientTrainer)


def _trainer():
    model = DGDMModel(node_features=16, hidden_dims=(32, 16), attention_heads=4,
                      graph_layers=2, num_diffusion_steps=3, num_classes=2,
                      compute_dtype="float32", dropout=0.1)
    init_parameters(model, torch.Generator().manual_seed(0))
    trainer = DGDMTrainer(model, TrainerConfig(warmup_steps=1, pretrain_epochs=1),
                          device="cpu")
    trainer.init_state(seed=3)
    return trainer


@pytest.fixture(scope="module")
def uninterrupted():
    """The metrics of 5 steps (pretrain, then finetune from step 3) and the
    parameters after them, with no failure."""
    trainer, batch = _trainer(), _tiny_graph(num_classes=2)
    metrics = [trainer.training_step(batch, epoch=int(i >= 3)) for i in range(5)]
    return batch, metrics, {k: v.clone() for k, v in trainer.model.state_dict().items()}


def _same_state(model, ref) -> bool:
    return all(torch.equal(v, ref[k]) for k, v in model.state_dict().items())


def test_a_failure_before_the_update_replays_bit_for_bit(uninterrupted, monkeypatch):
    batch, ref_metrics, ref_state = uninterrupted
    trainer = _trainer()
    rt = ResilientTrainer(trainer, max_batch_retries=1)
    monkeypatch.setattr(rt.retry, "base_delay", 0.0)
    failures = {"left": 1}

    def fail_once(module, args, out):
        if trainer.step == 2 and failures["left"]:
            failures["left"] -= 1
            raise torch.cuda.OutOfMemoryError("injected")
    trainer.model.feature_encoder.register_forward_hook(fail_once)
    metrics = [rt.training_step(batch, epoch=int(i >= 3)) for i in range(5)]
    assert failures["left"] == 0
    assert rt.stats == {"steps": 5, "errors_recovered": 1, "batches_skipped": 0,
                        "checkpoints_saved": 0}
    assert metrics == ref_metrics
    assert _same_state(trainer.model, ref_state)


def test_checkpoints_and_recovery_continue_the_run_bit_for_bit(uninterrupted, tmp_path):
    batch, ref_metrics, ref_state = uninterrupted
    trainer = _trainer()
    rt = ResilientTrainer(trainer, CheckpointManager(tmp_path), checkpoint_every_steps=2,
                          cleanup_every_steps=3)
    metrics = [rt.training_step(batch, epoch=int(i >= 3)) for i in range(4)]
    assert metrics == ref_metrics[:4]
    assert rt.stats["checkpoints_saved"] == 2 and rt.checkpoint_manager.all_steps() == [2, 4]
    trainer.training_step(batch, epoch=1)            # a step the checkpoint does not hold
    assert rt.recover_from_checkpoint() and trainer.step == 4
    assert rt.training_step(batch, epoch=1) == ref_metrics[4]
    assert _same_state(trainer.model, ref_state)
    assert not ResilientTrainer(trainer).recover_from_checkpoint()


def test_a_failure_inside_the_update_is_not_replayed(uninterrupted, monkeypatch):
    """The port's step writes the parameters in place: a failure after the
    optimizer's first writes leaves them, and the retried step starts from
    them (ROADMAP queue 3). The JAX step returns a new state and keeps the
    old one on a failure."""
    batch, ref_metrics, _ = uninterrupted
    trainer = _trainer()
    rt = ResilientTrainer(trainer, max_batch_retries=1)
    monkeypatch.setattr(rt.retry, "base_delay", 0.0)
    step = trainer.optimizer.step
    failures = {"left": 1}

    def half_step(*a, **kw):
        out = step(*a, **kw)
        if trainer.step == 1 and failures["left"]:
            failures["left"] -= 1
            raise RuntimeError("injected after the update")
        return out
    monkeypatch.setattr(trainer.optimizer, "step", half_step)
    metrics = [rt.training_step(batch, epoch=0) for _ in range(3)]
    assert rt.stats["errors_recovered"] == 1 and trainer.step == 3
    assert metrics[0] == ref_metrics[0]
    assert metrics[1] != ref_metrics[1]              # it started from the written update
