"""The port's diffusion schedule, noising, sampling step and DiffusionLayer
against the JAX package's, f32 on the CPU.

The schedules are computed in float64 on the host on both sides and cast
once, so they agree to 1e-7. The two frameworks cannot share random
numbers, so the JAX layer's own draws (noise, t) are read back and handed
to the port; with them the denoiser's prediction agrees to 1e-5 (f32
matmuls in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgdm_histopath_tpu.nn.diffusion import DiffusionLayer as JaxDiffusionLayer
from dgdm_histopath_tpu.ops import diffusion as jd
from dgdm_histopath_torch.convert import load_state, params_from_flax
from dgdm_histopath_torch.models.dgdm import DGDMModel
from dgdm_histopath_torch.nn import diffusion as nn_diffusion
from dgdm_histopath_torch.nn.diffusion import DiffusionLayer
from dgdm_histopath_torch.ops import diffusion as td
from test_torch_model import KW, _flat


@pytest.mark.parametrize("num_steps", [3, 10, 100])
@pytest.mark.parametrize("schedule", ["linear", "cosine", "sigmoid"])
def test_make_schedule_matches_jax(schedule, num_steps):
    ref, out = jd.make_schedule(num_steps, schedule), td.make_schedule(num_steps, schedule)
    assert out.num_steps == num_steps
    for name in ref._fields:
        got = getattr(out, name)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(ref, name)),
                                   atol=1e-7, rtol=0, err_msg=name)


def test_unknown_schedule_raises():
    with pytest.raises(ValueError, match="unknown diffusion schedule"):
        td.make_schedule(10, "quadratic")


@pytest.mark.parametrize("per_node", [False, True])
def test_add_noise_with_the_jax_noise(per_node):
    rs = np.random.RandomState(0)
    x0 = rs.randn(3, 7, 5).astype(np.float32)
    t = rs.randint(0, 10, size=(3, 7) if per_node else (3,))
    ref_xt, ref_noise = jd.add_noise(jd.make_schedule(10), jnp.asarray(x0), jnp.asarray(t),
                                     jax.random.PRNGKey(4))
    x_t, noise = td.add_noise(td.make_schedule(10), torch.from_numpy(x0),
                              torch.from_numpy(t), noise=torch.from_numpy(np.array(ref_noise)))
    np.testing.assert_array_equal(noise.numpy(), np.asarray(ref_noise))
    np.testing.assert_allclose(x_t.numpy(), np.asarray(ref_xt), atol=1e-6, rtol=1e-6)


def test_add_noise_draws_from_the_generator_only():
    sched, x0 = td.make_schedule(10), torch.zeros(2, 50, 8)
    t = torch.tensor([9, 9])
    a, na = td.add_noise(sched, x0, t, generator=torch.Generator().manual_seed(3))
    torch.manual_seed(123)                        # the global generator is not read
    b, nb = td.add_noise(sched, x0, t, generator=torch.Generator().manual_seed(3))
    c, _ = td.add_noise(sched, x0, t, generator=torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and torch.equal(na, nb) and not torch.equal(a, c)
    assert abs(float(na.std()) - 1.0) < 0.1


@pytest.mark.parametrize("t", [0, 1, 9])
def test_ddpm_sample_step_with_injected_noise(t):
    rs = np.random.RandomState(1)
    x_t, eps, z = (rs.randn(2, 6, 4).astype(np.float32) for _ in range(3))
    # read the JAX step's own noise back: it is normal(rng, x_t.shape)
    rng = jax.random.PRNGKey(7)
    z = np.array(jax.random.normal(rng, x_t.shape, jnp.float32))
    ref = jd.ddpm_sample_step(jd.make_schedule(10), jnp.asarray(x_t), jnp.asarray(eps),
                              jnp.asarray(t), rng)
    out = td.ddpm_sample_step(td.make_schedule(10), torch.from_numpy(x_t),
                              torch.from_numpy(eps), torch.tensor(t), noise=torch.from_numpy(z))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    if t == 0:                                    # no noise is added at the last step
        other = td.ddpm_sample_step(td.make_schedule(10), torch.from_numpy(x_t),
                                    torch.from_numpy(eps), torch.tensor(t),
                                    noise=torch.from_numpy(2 * z))
        assert torch.equal(out, other)


def test_time_embedding_moved_and_still_exported_from_nn():
    assert nn_diffusion.sinusoidal_time_embedding is td.sinusoidal_time_embedding
    t = np.array([0, 3, 9])
    for dim in (128, 7):
        np.testing.assert_allclose(
            td.sinusoidal_time_embedding(torch.from_numpy(t), dim).numpy(),
            np.asarray(jd.sinusoidal_time_embedding(jnp.asarray(t), dim)), atol=1e-6)


@pytest.fixture(scope="module")
def layer_pair():
    jl = JaxDiffusionLayer(features=16, num_steps=5, schedule="cosine", dtype=jnp.float32)
    x0 = np.random.RandomState(2).randn(3, 20, 16).astype(np.float32)
    with jax.default_matmul_precision("float32"):
        params = jl.init(jax.random.PRNGKey(0), jnp.asarray(x0), jax.random.PRNGKey(1))
        ref = jl.apply(params, jnp.asarray(x0), jax.random.PRNGKey(5))
    tl = DiffusionLayer(16, num_steps=5, schedule="cosine")
    load_state(tl, params_from_flax(_flat(params)))
    return ref, tl, torch.from_numpy(x0)


def test_diffusion_layer_with_the_jax_draws(layer_pair):
    (ref_pred, ref_noise, ref_t), tl, x0 = layer_pair
    assert ref_t.shape == (3,)                    # one timestep per graph
    pred, noise, t = tl(x0, t=torch.from_numpy(np.array(ref_t)),
                        noise=torch.from_numpy(np.array(ref_noise)))
    np.testing.assert_array_equal(t.numpy(), np.asarray(ref_t))
    np.testing.assert_allclose(pred.detach().numpy(), np.asarray(ref_pred),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        tl.predict_noise(x0, t).detach().numpy(),
        np.asarray(tl.denoiser(x0, t).detach()), atol=0)


def test_diffusion_layer_draws_one_timestep_per_graph_from_its_generator(layer_pair):
    _, tl, x0 = layer_pair
    a = tl(x0, generator=torch.Generator().manual_seed(0))
    b = tl(x0, generator=torch.Generator().manual_seed(0))
    assert a[2].shape == (3,) and a[2].min() >= 0 and a[2].max() < 5
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    sample = tl.sample((2, 6, 16), generator=torch.Generator().manual_seed(0))
    assert sample.shape == (2, 6, 16) and sample.dtype == torch.float32
    assert torch.isfinite(sample).all()
    assert torch.equal(sample, tl.sample((2, 6, 16),
                                         generator=torch.Generator().manual_seed(0)))


def test_ddpm_sample_runs_the_reverse_chain():
    sched = td.make_schedule(4, "linear")
    calls = []

    def denoise(x, t, cond):
        calls.append(int(t))
        return torch.zeros_like(x)

    out = td.ddpm_sample(sched, denoise, (2, 3), generator=torch.Generator().manual_seed(0))
    assert calls == [3, 2, 1, 0] and out.shape == (2, 3) and torch.isfinite(out).all()


def test_schedule_buffers_stay_out_of_the_state_dict():
    """A checkpoint holds parameters only, so the strict bundle load of
    ``convert.load_state`` keeps passing with the schedule on the layer."""
    model = DGDMModel(**KW)
    keys = set(model.state_dict())
    assert not any(k.startswith("diffusion.") and "denoiser" not in k for k in keys)
    assert model.diffusion.betas.shape == (KW["num_diffusion_steps"],)
    load_state(model, {k: v.clone() for k, v in model.state_dict().items()})
    moved = model.to(torch.float32)
    assert moved.diffusion.constants.num_steps == KW["num_diffusion_steps"]
