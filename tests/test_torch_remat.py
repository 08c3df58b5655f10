"""``use_remat`` in the port: each GraphEncoder layer under
``torch.utils.checkpoint`` with its dropout draws replayed in the recompute.

The small model: node_features 16, hidden (32, 16), 4 heads, 2 graph layers,
hierarchical on (5 more layers, not checkpointed, as in the reference),
N = 128 with 100 real nodes and K = 5, f32 on the CPU.

Tolerances: against the JAX ``DGDMModel(use_remat=True)`` on the same
parameters, inference logits 1e-5 and the gradients of a sum-of-squares loss
1e-4 of each tensor's largest entry (f32 sums in another order; the key
biases, whose true gradient is zero, against a thousandth of the tree's
largest entry, as in tests/test_torch_training.py). Within the port, remat on
against off: equal to the bit (``torch.equal``), since the recompute runs
the same CPU operations on the same inputs and draws the same masks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils.checkpoint

from conftest import make_synthetic_graph
from dgdm_histopath_tpu.models import DGDMModel as JaxDGDM
from dgdm_histopath_tpu.ops.graph import batch_graphs as j_batch
from dgdm_histopath_torch.convert import load_state, params_from_flax
from dgdm_histopath_torch.models.dgdm import DGDMModel
from dgdm_histopath_torch.nn.layers import init_parameters
from dgdm_histopath_torch.ops.kernels import gather_agg, neighbor_transpose
from dgdm_histopath_torch.training import DGDMTrainer, TrainerConfig
from test_torch_model import _flat, to_torch_graph
from test_torch_training import assert_tree_close

KW = dict(node_features=16, hidden_dims=(32, 16), num_diffusion_steps=3,
          attention_heads=4, graph_layers=2, num_classes=2, compute_dtype="float32")
RNGS = {"params": jax.random.PRNGKey(0), "diffusion": jax.random.PRNGKey(1),
        "masking": jax.random.PRNGKey(2)}


def _jax_batch():
    return j_batch([make_synthetic_graph(seed=i, n_nodes=128, n_real=100, feat_dim=16, k=5)
                    for i in range(2)])


def _pair(dropout=0.1, seed=0):
    """The same seeded parameters in a model with remat and one without."""
    on = init_parameters(DGDMModel(**KW, dropout=dropout, use_remat=True),
                         torch.Generator().manual_seed(seed))
    off = DGDMModel(**KW, dropout=dropout)
    off.load_state_dict(on.state_dict())
    return on, off


def _assert_same_grads(model_a, model_b):
    """Every gradient equal to the bit, None (a head the step does not
    reach) on both sides alike."""
    grads_b = dict(model_b.named_parameters())
    for key, p in model_a.named_parameters():
        q = grads_b[key]
        assert (p.grad is None) == (q.grad is None), key
        assert p.grad is None or torch.equal(p.grad, q.grad), key


@pytest.fixture
def checkpoints(monkeypatch):
    """Counts the calls of ``torch.utils.checkpoint.checkpoint``."""
    calls = []
    real = torch.utils.checkpoint.checkpoint

    def counting(*args, **kwargs):
        calls.append(kwargs)
        return real(*args, **kwargs)

    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", counting)
    return calls


def test_remat_matches_the_jax_remat_model(checkpoints):
    """Mirrors tests/test_model.py::TestRemat: inference logits, then the
    gradients of sum(logits ** 2) through the checkpointed layers."""
    batch = _jax_batch()
    jm = JaxDGDM(**KW, dropout=0.0, use_remat=True, gather_impl="xla")
    with jax.default_matmul_precision("float32"):
        params = jax.jit(lambda g: jm.init(RNGS, g, mode="pretrain", deterministic=True))(batch)

        def loss(p):
            return jnp.sum(jm.apply(p, batch, mode="inference")["classification_logits"] ** 2)

        ref_logits = jax.jit(lambda p: jm.apply(p, batch, mode="inference"))(
            params)["classification_logits"]
        ref_grads = jax.jit(jax.grad(loss))(params)
    tm = DGDMModel(**KW, dropout=0.0, use_remat=True)
    load_state(tm, params_from_flax(_flat(params)))
    logits = tm(to_torch_graph(batch), mode="inference")["classification_logits"]
    assert len(checkpoints) == KW["graph_layers"]            # one per GraphEncoder layer
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(ref_logits), atol=1e-5,
                               rtol=0)
    (logits ** 2).sum().backward()
    # the parameters the inference forward does not reach have no gradient
    # here and a zero one in JAX
    got = {k: torch.zeros_like(p) if p.grad is None else p.grad
           for k, p in tm.named_parameters()}
    want = {k: torch.from_numpy(np.array(v))
            for k, v in params_from_flax(_flat(ref_grads)).items()}
    assert all(torch.isfinite(g).all() for g in got.values())
    assert_tree_close(got, want, 1e-4, "remat gradient")


@pytest.mark.parametrize("source", ["generator", "global"])
def test_remat_step_is_bit_equal_to_the_plain_step(checkpoints, source):
    """A pretrain step at dropout 0.1: the losses, every gradient and the
    generator's state after the backward are equal to the bit. ``global``
    draws the masks from the global generator (``generator=None``), which
    ``checkpoint`` replays itself."""
    batch = to_torch_graph(_jax_batch())
    models, results = _pair(), []
    for model in models:
        if source == "generator":
            gen = torch.Generator().manual_seed(7)
        else:
            torch.manual_seed(7)
            gen = None
        out = model.pretrain_step(batch, generator=gen)
        loss = out["diffusion_loss"] + out["reconstruction_loss"]
        loss.backward()
        state = gen.get_state() if gen is not None else torch.get_rng_state()
        results.append((loss.detach(), state))
    (loss_on, state_on), (loss_off, state_off) = results
    assert len(checkpoints) == KW["graph_layers"]
    assert torch.equal(loss_on, loss_off)
    _assert_same_grads(*models)
    assert torch.equal(state_on, state_off)
    assert float(models[0].graph_encoder.layer0.q_proj.weight.grad.abs().max()) > 0


def test_remat_trainer_steps_match_plain_steps_and_leave_the_generator_alike(checkpoints):
    """Two DGDMTrainer steps each way: equal losses at both steps and the
    same generator state after each, so the replay leaves the generator
    where a plain step leaves it."""
    batch = to_torch_graph(_jax_batch())
    cfg = TrainerConfig(warmup_steps=0, learning_rate=1e-3, steps_per_epoch=2,
                        pretrain_epochs=1)
    runs = []
    for model in _pair():
        trainer = DGDMTrainer(model, cfg, device="cpu")
        trainer.init_state(0)
        steps = []
        for _ in range(2):
            metrics = trainer.training_step(batch, 0)
            steps.append((metrics, trainer.generator.get_state()))
        runs.append((steps, {k: p.detach().clone() for k, p in model.named_parameters()}))
    (steps_on, params_on), (steps_off, params_off) = runs
    assert len(checkpoints) == 2 * KW["graph_layers"]
    for (m_on, s_on), (m_off, s_off) in zip(steps_on, steps_off):
        assert m_on == m_off
        assert torch.equal(s_on, s_off)
    assert steps_on[0][0] != steps_on[1][0]
    assert all(torch.equal(params_on[k], params_off[k]) for k in params_off)


def test_remat_recompute_replays_the_layers_and_builds_no_list(checkpoints, monkeypatch):
    """With the lists built on the CPU too: a remat step builds the 3 lists
    of a plain step (one per U-Net level), the recompute takes them as
    inputs, and only the GraphEncoder layers run twice: the message sums
    (two per layer) are 14 in a plain step of the 7 layers, 14 + 4 with
    remat, as a Base step on the card launches 18 and 18 + 8."""
    monkeypatch.setattr(neighbor_transpose, "BUILD_DEVICES", ("cuda", "cpu"))
    counts = {"lists": 0, "sums": 0}
    build, plain_sum = neighbor_transpose.neighbor_transpose, gather_agg.weighted_gather_sum_plain

    def counted_build(idx, m=None):
        counts["lists"] += 1
        return build(idx, m)

    def counted_sum(*args):
        counts["sums"] += 1
        return plain_sum(*args)

    monkeypatch.setattr(neighbor_transpose, "neighbor_transpose", counted_build)
    monkeypatch.setattr(gather_agg, "weighted_gather_sum_plain", counted_sum)
    batch = to_torch_graph(_jax_batch())
    models, seen = _pair(), []
    for model in models:
        counts.update(lists=0, sums=0)
        out = model.pretrain_step(batch, generator=torch.Generator().manual_seed(7))
        (out["diffusion_loss"] + out["reconstruction_loss"]).backward()
        seen.append(dict(counts))
    _assert_same_grads(*models)
    assert seen == [{"lists": 3, "sums": 18}, {"lists": 3, "sums": 14}]


def test_no_checkpoint_without_a_gradient_or_with_attention(checkpoints):
    """The reference wraps the layers only when no attention is returned;
    the port also takes no checkpoint where no gradient is recorded."""
    batch = to_torch_graph(_jax_batch())
    on, off = _pair(dropout=0.0)
    with torch.no_grad():
        on(batch)
    with torch.inference_mode():
        on(batch)
    out = on(batch, return_attention=True)
    assert out["classification_logits"].requires_grad and len(out["edge_attentions"]) == 2
    off(batch)
    for p in on.parameters():
        p.requires_grad_(False)
    on(batch)
    assert checkpoints == []
    for p in on.parameters():
        p.requires_grad_(True)
    on(batch)
    assert len(checkpoints) == KW["graph_layers"]
    assert all(c["use_reentrant"] is False for c in checkpoints)
