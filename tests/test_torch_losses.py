"""The port's training losses and head losses against the JAX package's, f32
on the CPU, same numpy inputs on both sides, 1e-5 (f32 reductions in
another order). Random subsamples are injected: the contrastive scores and
the negative edge endpoints are drawn once with JAX and handed to the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgdm_histopath_tpu.models import decoders as jdec
from dgdm_histopath_tpu.training import losses as jl
from dgdm_histopath_torch.models import decoders as tdec
from dgdm_histopath_torch.training import losses as tl

TOL = dict(atol=1e-5, rtol=1e-5)


def t_(a):
    return torch.from_numpy(np.asarray(a))


def close(out, ref):
    np.testing.assert_allclose(float(out), float(ref), **TOL)


@pytest.fixture(scope="module")
def emb():
    rs = np.random.RandomState(0)
    e = rs.randn(3, 96, 16).astype(np.float32)
    mask = np.zeros((3, 96), bool)
    mask[0, :80], mask[1, :70] = True, True       # graph 2 is a filler graph
    return e, mask


@pytest.mark.parametrize("loss_type", ["mse", "mae", "huber"])
@pytest.mark.parametrize("masked", [False, True])
def test_diffusion_loss(emb, loss_type, masked):
    e, mask = emb
    other = np.random.RandomState(1).randn(*e.shape).astype(np.float32) * 2
    m = mask if masked else None
    ref = jl.diffusion_loss(jnp.asarray(e), jnp.asarray(other),
                            None if m is None else jnp.asarray(m), loss_type, 0.7)
    out = tl.diffusion_loss(t_(e), t_(other), None if m is None else t_(m), loss_type, 0.7)
    close(out, ref)


def test_diffusion_loss_rejects_unknown_type(emb):
    with pytest.raises(ValueError, match="unknown diffusion loss"):
        tl.diffusion_loss(t_(emb[0]), t_(emb[0]), loss_type="l3")


def test_contrastive_loss_without_rng_keeps_the_lower_index_on_ties(emb):
    """With no draw every real node scores 2.0; ``lax.top_k`` keeps the lower
    index among equals, and so must the port's stable sort."""
    e, mask = emb
    scattered = mask.copy()
    scattered[0, :] = False
    scattered[0, ::2] = True                       # real nodes interleaved with padding
    with jax.default_matmul_precision("float32"):
        ref = jl.contrastive_loss(jnp.asarray(e), jnp.asarray(scattered), 0.1, 32, rng=None)
    close(tl.contrastive_loss(t_(e), t_(scattered), 0.1, 32), ref)


def test_contrastive_loss_with_injected_scores(emb):
    e, mask = emb
    rng = jax.random.PRNGKey(3)
    u = np.array(jax.random.uniform(rng, mask.shape))
    with jax.default_matmul_precision("float32"):
        ref = jl.contrastive_loss(jnp.asarray(e), jnp.asarray(mask), 0.2, 24, rng=rng)
    close(tl.contrastive_loss(t_(e), t_(mask), 0.2, 24, uniform=t_(u)), ref)
    other = tl.contrastive_loss(t_(e), t_(mask), 0.2, 24,
                                generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(other) and abs(float(other) - float(ref)) > 0


def test_contrastive_loss_without_subsampling(emb):
    e, mask = emb
    with jax.default_matmul_precision("float32"):
        ref = jl.contrastive_loss(jnp.asarray(e), jnp.asarray(mask), 0.1, 128)
    close(tl.contrastive_loss(t_(e), t_(mask), 0.1, 128), ref)


def test_contrastive_loss_pairs(emb):
    a, p = emb[0][0, :12], emb[0][1, :12]
    with jax.default_matmul_precision("float32"):
        ref = jl.contrastive_loss_pairs(jnp.asarray(a), jnp.asarray(p), 0.3)
    close(tl.contrastive_loss_pairs(t_(a), t_(p), 0.3), ref)


def test_masked_lm_loss():
    rs = np.random.RandomState(2)
    logits = rs.randn(2, 10, 7).astype(np.float32)
    targets = rs.randint(0, 7, (2, 10))
    masked = rs.rand(2, 10) < 0.4
    ref = jl.masked_lm_loss(jnp.asarray(logits), jnp.asarray(targets), jnp.asarray(masked))
    close(tl.masked_lm_loss(t_(logits), t_(targets), t_(masked)), ref)
    none = np.zeros_like(masked)
    assert float(tl.masked_lm_loss(t_(logits), t_(targets), t_(none))) == 0.0


@pytest.mark.parametrize("focal_gamma,num_negatives", [(0.0, 1), (2.0, 2)])
def test_graph_reconstruction_loss_with_injected_negatives(emb, focal_gamma, num_negatives):
    e, mask = emb
    rs = np.random.RandomState(4)
    b, n, k = 3, 96, 4
    nbr_idx = rs.randint(0, n, (b, n, k)).astype(np.int32)
    nbr_mask = rs.rand(b, n, k) < 0.8
    rng = jax.random.PRNGKey(9)
    neg = np.array(jax.random.randint(rng, (b, n, k * num_negatives), 0, n), np.int32)
    h = e * 0.3
    with jax.default_matmul_precision("float32"):
        ref = jl.graph_reconstruction_loss(
            jnp.asarray(h), jnp.asarray(nbr_idx), jnp.asarray(nbr_mask), jnp.asarray(mask),
            rng, num_negatives, focal_gamma)
    out = tl.graph_reconstruction_loss(t_(h), t_(nbr_idx), t_(nbr_mask), t_(mask),
                                       neg_idx=t_(neg), num_negatives=num_negatives,
                                       focal_gamma=focal_gamma)
    close(out, ref)
    drawn = tl.graph_reconstruction_loss(t_(h), t_(nbr_idx), t_(nbr_mask), t_(mask),
                                         generator=torch.Generator().manual_seed(0),
                                         num_negatives=num_negatives)
    assert torch.isfinite(drawn)


def test_multi_task_loss():
    losses = np.array([0.5, 2.0, 1.25], np.float32)
    log_vars = np.array([0.1, -0.3, 0.0], np.float32)
    ref = jl.multi_task_loss(jnp.asarray(losses), jnp.asarray(log_vars))
    close(tl.multi_task_loss(t_(losses), t_(log_vars)), ref)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("weighted", [False, True])
def test_cross_entropy_loss(smoothing, weighted):
    rs = np.random.RandomState(5)
    logits = rs.randn(6, 4).astype(np.float32) * 3
    labels = rs.randint(0, 4, 6)
    cw = np.array([1.0, 2.0, 0.5, 1.5], np.float32) if weighted else None
    ref = jdec.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels),
                                  None if cw is None else jnp.asarray(cw), smoothing)
    out = tdec.cross_entropy_loss(t_(logits), t_(labels), None if cw is None else t_(cw),
                                  smoothing)
    close(out, ref)


@pytest.mark.parametrize("with_valid", [False, True])
def test_cox_partial_likelihood(with_valid):
    rs = np.random.RandomState(6)
    risk = rs.randn(8).astype(np.float32)
    time = rs.rand(8).astype(np.float32) * 10
    time[3] = time[5]                              # a tie in the risk sets
    event = (rs.rand(8) < 0.6).astype(np.float32)
    valid = np.array([1, 1, 1, 0, 1, 1, 0, 1], np.float32) if with_valid else None
    ref = jdec.cox_partial_likelihood(jnp.asarray(risk), jnp.asarray(time), jnp.asarray(event),
                                      None if valid is None else jnp.asarray(valid))
    out = tdec.cox_partial_likelihood(t_(risk), t_(time), t_(event),
                                      None if valid is None else t_(valid))
    close(out, ref)


@pytest.mark.parametrize("with_valid", [False, True])
def test_discrete_survival_loss(with_valid):
    rs = np.random.RandomState(7)
    hazards = rs.randn(8, 5).astype(np.float32)
    interval = rs.randint(-1, 7, 8)                # clipped into [0, T)
    event = (rs.rand(8) < 0.5).astype(np.float32)
    valid = np.array([1, 0, 1, 1, 1, 0, 1, 1], np.float32) if with_valid else None
    ref = jdec.discrete_survival_loss(jnp.asarray(hazards), jnp.asarray(interval),
                                      jnp.asarray(event),
                                      None if valid is None else jnp.asarray(valid))
    out = tdec.discrete_survival_loss(t_(hazards), t_(interval), t_(event),
                                      None if valid is None else t_(valid))
    close(out, ref)
