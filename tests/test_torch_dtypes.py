"""Half precision in the port against the JAX package, on the CPU: the
kernels' plain versions in f16, the Set2Set pool, the model in the
(compute, param) pairs (f16, f32), (bf16, bf16) and (f16, f16), optimizer
steps with parameters below f32, and bundles with bf16 and f16 leaves.

Tolerances, and why:

* ``gather_rows`` forward: bit-equal (a copy; the Pallas kernel's one-hot
  product with an f32 accumulator is exact).
* ``gather_rows`` backward, ``weighted_gather_sum``'s dh: one f16 ulp of
  each element (the plain versions sum in f64 and round through f32, the
  Pallas kernel and XLA sum in f32 and round once); a sum past 65504 is inf
  on both sides.
* ``weighted_gather_sum`` forward and dw: 1e-5 of max(1, |x|) (f32 sums of K
  and F terms in another order).
* flash packed and head-major: 1e-4 plus one f16 ulp of each element (both
  compute in f32 from the same f16 inputs and round once).
* Set2Set: f32 1e-5; bf16 compute 4 bf16 ulps of the output's largest
  entry (the last ``q_star`` and ``out_proj`` round in bf16 in another
  order).
* the model: f32 logits and graph embeddings of each pair within ``tol``
  (atol = rtol), against the port's distance read on this suite's CPU: the
  least ``tol`` that passes was 4.2e-4 for (f16, f32) and (f16, f16), and
  8.0e-3 and 5.5e-3 with the port computing those two in bf16 instead; 3.1e-3
  for (bf16, bf16); 1.8e-7 for ``set2set`` in f32. The limits: 1.5e-3 for the
  f16 pairs (a bf16 computation fails), 1e-2 for (bf16, bf16), 1e-5 for
  ``set2set``. XLA on the CPU keeps f32 between fused half-precision
  operations where PyTorch rounds each one, and the differences add up over
  ~20 layers.
* the update rule: ``make_optimizer``, ``optax_global_norm`` and
  ``clip_and_step`` over bf16 or f16 parameters against the JAX trainer's
  optax chain run op by op (``jax.disable_jit``): the norm, the parameters
  and both moments bit-equal after each of five updates (NaN where optax's
  is NaN). Under ``jax.jit`` XLA keeps f32 between fused half-precision
  operations (the f16 update's, and the norm's sums in bf16 too), so jitted
  optax differs in the last bit in places; the port rounds every
  operation, as optax's code reads. Mutations read (each fails): the final ``apply_updates`` left
  out, parameters differ from the second update on in bf16 and from the
  first in f16 (where optax's turn NaN); ``torch.optim.AdamW`` in place of
  ``OptaxAdamW``, the first update's ``mu`` differs in 889 (bf16) and 671
  (f16) of the first leaf's 2048 entries.
* training, 3 steps against the jitted JAX trainer (bf16: 2 pretrain, 1
  finetune, f16: 3 pretrain; peak rate 1e-2, so the summed rates S are
  1.1e-2, ~20 bf16 ulps at 0.1): losses within 5% (bf16 compute); the
  non-finite leaves the same after every step; in bf16, leaf by leaf apart
  from the ``k_proj`` biases (their exact gradient is 0: softmax ignores a
  shift of the keys, so both sides step on rounding noise), the update
  ``p3 - p0`` within 0.6 of the JAX update's norm (worst reading 0.43), the
  moments within 0.75 of theirs (worst 0.34 for ``mu``, 0.53 for ``nu``:
  the gradients differ by bf16 rounding), and of the elements that the JAX
  update moved by at least S/2, at least 99% moved within S/4 of it
  (reading: 27610 of 27696). The update left out fails here too (the
  finetune step's grad_norm 0.645 against 1.148; in f16 no leaf NaN after
  the first update); ``torch.optim.AdamW``'s order passes here (its decay
  of 1e-5 is below bf16's rounding), which the update rule test catches.
  With f16 parameters optax's eps (1e-8) is 0 in f16: after the first
  update 173 of 174 leaves hold NaN, in both packages, and every leaf after
  the second.

The JAX side runs under ``jax.default_matmul_precision("float32")`` and its
Pallas kernels in interpret mode.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch

from conftest import make_synthetic_graph
from dgdm_histopath_tpu.models import DGDMModel as JaxDGDM
from dgdm_histopath_tpu.models.pooling import GlobalSet2SetPool as JaxSet2Set
from dgdm_histopath_tpu.ops.graph import batch_graphs as j_batch
from dgdm_histopath_tpu.ops.graph import masked_softmax as j_masked_softmax
from dgdm_histopath_tpu.ops.pallas.flash_spatial import flash_spatial_attention as j_flash
from dgdm_histopath_tpu.ops.pallas.gather_agg import weighted_gather_sum as j_wgs
from dgdm_histopath_tpu.ops.pallas.gather_rows import gather_rows as j_gather_rows
from dgdm_histopath_tpu.training import checkpoint as jckpt
from dgdm_histopath_tpu.training import trainer as jtr
from dgdm_histopath_torch.convert import load_state, params_from_flax, params_to_flax
from dgdm_histopath_torch.models.dgdm import DGDMModel
from dgdm_histopath_torch.models.pooling import GlobalSet2SetPool
from dgdm_histopath_torch.ops.graph import masked_softmax
from dgdm_histopath_torch.ops.kernels import flash_spatial as fs
from dgdm_histopath_torch.ops.kernels.gather_agg import weighted_gather_sum
from dgdm_histopath_torch.ops.kernels.gather_rows import gather_rows
from dgdm_histopath_torch.training import DGDMTrainer, TrainerConfig
from dgdm_histopath_torch.training.trainer import (clip_and_step, make_lr_schedule,
                                                   make_optimizer, optax_global_norm)
from dgdm_histopath_torch.training import checkpoint as tckpt
from dgdm_histopath_tpu.nn.diffusion import DiffusionLayer as JaxDiffusionLayer
from test_torch_model import KW, RNGS, _flat, to_torch_graph


def _torch(a) -> torch.Tensor:
    """A JAX array of any float dtype as a tensor of the same dtype."""
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def jax_draws(jm, mask_ratio=0.15):
    """``(params, batch, rngs) -> draws`` of one JAX ``pretrain_step`` (as
    tests/test_torch_training.py reads them, jitted once), the noise in its
    own dtype: JAX draws it in x0's dtype, so a bf16 or f16 model's noise is
    a draw in that dtype, not an f32 draw rounded."""
    def draws(params, batch, rngs):
        out, state = jm.apply(
            params, batch, mask_ratio=mask_ratio, deterministic=False,
            method=JaxDGDM.pretrain_step, rngs=rngs, mutable=["intermediates"],
            capture_intermediates=lambda m, name: (isinstance(m, JaxDiffusionLayer)
                                                   and name == "__call__"))
        _, noise, t = state["intermediates"]["diffusion"]["__call__"][0]
        uniform = jax.random.uniform(jax.random.fold_in(rngs["masking"], 17),
                                     batch.node_mask.shape)
        return out["masked_nodes"], noise, t, uniform

    fn = jax.jit(draws)

    def call(params, batch, rngs):
        masked, noise, t, uniform = fn(params, batch, rngs)
        return {"masked": _torch(masked), "noise": _torch(noise), "t": _torch(t).long(),
                "uniform": _torch(uniform)}
    return call


def _ulp(ref: np.ndarray, bits: int) -> np.ndarray:
    """One ulp of each element of ``ref`` at ``bits`` significant bits (f16
    11, bf16 8); the smallest f16 subnormal below its normal range."""
    ulp = np.ldexp(np.ones_like(ref, np.float64), np.frexp(ref)[1] - bits)
    return np.maximum(ulp, 2.0 ** -24)


def _f16(rs, *shape, scale=1.0):
    a = (rs.randn(*shape) * scale).astype(np.float16)
    return torch.from_numpy(a), jnp.asarray(a)


# ---------------------------------------------------------------------------
# the kernels' plain versions in f16 against the Pallas kernels
# ---------------------------------------------------------------------------

def test_gather_rows_f16_forward_bit_equal_and_backward_within_an_ulp():
    """Backward: dsrc in f16 from f16 cotangents; the hub row's sum passes
    65504 and is inf on both sides."""
    rs = np.random.RandomState(0)
    src, jsrc = _f16(rs, 2, 128, 64)
    idx = rs.randint(0, 128, size=(2, 128, 8)).astype(np.int32)
    idx[0, :, 0] = 5                                   # node 5: a hub of 128 slots
    out = gather_rows(src.requires_grad_(), torch.from_numpy(idx))
    ref, vjp = jax.vjp(lambda s: j_gather_rows(s, jnp.asarray(idx), True), jsrc)
    assert out.dtype == torch.float16
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(ref))
    g = rs.randn(2, 128, 8, 64).astype(np.float16)
    g[0, :, 0, :3] = 30000.0                           # 128 x 30000 overflows f16
    (dref,) = vjp(jnp.asarray(g))
    out.backward(torch.from_numpy(g))
    got, want = src.grad.float().numpy(), np.asarray(dref, np.float32)
    assert src.grad.dtype == torch.float16
    assert np.isinf(want[0, 5, :3]).all() and np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    assert (np.abs(got[fin] - want[fin]) <= _ulp(want[fin], 11)).all()


def test_weighted_gather_sum_f16_forward_and_backward():
    rs = np.random.RandomState(1)
    h, jh = _f16(rs, 2, 128, 64)
    idx = rs.randint(0, 128, size=(2, 128, 8)).astype(np.int32)
    w = rs.rand(2, 128, 8).astype(np.float32)
    tw = torch.from_numpy(w).requires_grad_()
    out = weighted_gather_sum(h.requires_grad_(), torch.from_numpy(idx), tw)
    ref, vjp = jax.vjp(lambda a, b: j_wgs(a, jnp.asarray(idx), b, True), jh, jnp.asarray(w))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    g = rs.randn(2, 128, 64).astype(np.float32)
    dh_ref, dw_ref = vjp(jnp.asarray(g))
    out.backward(torch.from_numpy(g))
    assert h.grad.dtype == torch.float16 and tw.grad.dtype == torch.float32
    want = np.asarray(dh_ref, np.float32)
    assert (np.abs(h.grad.float().numpy() - want) <= _ulp(want, 11)).all()
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(dw_ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("heads", [(8, 16), (4, 64)], ids=["packed", "headmajor"])
def test_flash_plain_versions_f16_match_the_pallas_kernels(heads):
    h, d = heads
    rs = np.random.RandomState(2)
    (q, jq), (k, jk), (v, jv) = (_f16(rs, 2, 256, h, d) for _ in range(3))
    pos = rs.rand(2, 256, 2).astype(np.float32)
    mask = np.ones((2, 256), bool)
    mask[:, 230:] = False
    assert fs.flash_route(256, h, d) == ("packed" if h * d == 128 else "headmajor")
    out = fs.flash_spatial_attention(q, k, v, torch.from_numpy(pos), torch.from_numpy(mask))
    with jax.default_matmul_precision("float32"):
        ref = np.asarray(j_flash(jq, jk, jv, jnp.asarray(pos), jnp.asarray(mask), tau=0.1,
                                 force_pallas=True), np.float32)
    assert out.dtype == torch.float16
    err = np.abs(out.float().numpy() - ref) * mask[:, :, None, None]
    assert (err <= 1e-4 + _ulp(ref, 11)).all(), err.max()


def test_masked_softmax_floor_is_zero_in_f16_as_in_the_reference():
    """``1e-20`` in the logits' dtype is 0 in f16: a fully-masked f16 row is
    0 / 0 = NaN in both packages (no caller in the model passes f16)."""
    logits = np.random.RandomState(3).randn(2, 6).astype(np.float16)
    mask = np.array([[True] * 6, [False] * 6])
    ref = np.asarray(j_masked_softmax(jnp.asarray(logits), jnp.asarray(mask)), np.float32)
    out = masked_softmax(torch.from_numpy(logits), torch.from_numpy(mask)).float().numpy()
    assert np.isnan(ref[1]).all() and np.isnan(out[1]).all()
    np.testing.assert_allclose(out[0], ref[0], atol=1e-3)


# ---------------------------------------------------------------------------
# Set2Set and the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_set2set_pool_matches_jax(dtype):
    """bf16 compute over f32 parameters: the JAX pool cannot draw bf16 or f16
    parameters on the CPU (flax's orthogonal initializer takes a QR, which
    LAPACK has no half type for); the port draws them in f32 and rounds."""
    rs = np.random.RandomState(4)
    x = rs.randn(3, 40, 16).astype(np.float32)
    mask = np.ones((3, 40), bool)
    mask[1, 25:] = False
    jdt = jnp.dtype(dtype)
    jm = JaxSet2Set(16, dtype=jdt, param_dtype=jnp.float32)
    jx = jnp.asarray(x, jdt)
    with jax.default_matmul_precision("float32"):
        params = jm.init(jax.random.PRNGKey(0), jx, jnp.asarray(mask))
        ref = np.asarray(jm.apply(params, jx, jnp.asarray(mask)), np.float32)
    tdt = getattr(torch, dtype)
    tm = GlobalSet2SetPool(16, dtype=tdt)
    load_state(tm, params_from_flax(_flat(params)))
    assert sorted(dict(tm.named_parameters())) == sorted(params_from_flax(_flat(params)))
    out = tm(torch.from_numpy(x).to(tdt), torch.from_numpy(mask)).float().detach().numpy()
    tol = 1e-5 if dtype == "float32" else 4 * 2.0 ** -8 * np.abs(ref).max()
    np.testing.assert_allclose(out, ref, atol=tol, rtol=0)


def _batch(n_graphs=2):
    return j_batch([make_synthetic_graph(seed=i, n_nodes=128, n_real=100, feat_dim=16)
                    for i in range(n_graphs)])


@pytest.fixture(scope="module")
def f32_params():
    """``pooling -> (f32 parameters, batch)`` of the small model, drawn once;
    a case in another ``param_dtype`` takes them rounded to it (what JAX's
    init draws in f32 and casts, but for flax's own rounding order)."""
    batch, out = _batch(), {}
    for pooling in ("attention", "set2set"):
        jm = JaxDGDM(**{**KW, "pooling": pooling}, gather_impl="xla")
        out[pooling] = jax.jit(lambda g: jm.init(RNGS, g, mode="pretrain",
                                                 deterministic=True))(batch)
    return out, batch


def _cast(params, dtype):
    return jax.tree_util.tree_map(lambda a: a.astype(dtype), params)


MODEL_CASES = {   # id -> (compute, param, pooling, logit tolerance)
    "f16-f32": ("float16", "float32", "attention", 1.5e-3),
    "bf16-bf16": ("bfloat16", "bfloat16", "attention", 1e-2),
    "f16-f16": ("float16", "float16", "attention", 1.5e-3),
    "set2set": ("float32", "float32", "set2set", 1e-5),
}


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_model_forward_in_each_dtype_pair_matches_jax(case, f32_params):
    compute, param, pooling, tol = MODEL_CASES[case]
    kw = {**KW, "compute_dtype": compute, "param_dtype": param, "pooling": pooling}
    params, batch = _cast(f32_params[0][pooling], param), f32_params[1]
    jm = JaxDGDM(**kw, gather_impl="xla")
    with jax.default_matmul_precision("float32"):
        ref = jax.jit(lambda p, g: jm.apply(p, g, mode="inference"))(params, batch)
    tm = DGDMModel(**kw)
    state = params_from_flax(_flat(params))
    assert {v.dtype for k, v in state.items() if "router" not in k} == {getattr(torch, param)}
    load_state(tm, state)
    with torch.inference_mode():
        out = tm(to_torch_graph(batch), mode="inference")
    assert out["node_embeddings"].dtype == getattr(torch, compute)
    for key in ("classification_logits", "graph_embedding"):
        got, want = out[key].float().numpy(), np.asarray(ref[key], np.float32)
        assert np.isfinite(got).all() and np.isfinite(want).all()
        np.testing.assert_allclose(got, want, atol=tol, rtol=tol, err_msg=key)


# ---------------------------------------------------------------------------
# optimizer steps with parameters below f32
# ---------------------------------------------------------------------------

def _np(a) -> np.ndarray:
    return (a.detach().float().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(a, np.float32))


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_update_rule_equals_optax_op_by_op(dtype):
    """Five updates of four leaves, the clip active in four (norms 138, 47,
    14 and 92) and not in one (0.45), one gradient element in ten 0 (in f16
    a 0/0), weight decay 1e-2, the rate 0 in the first update."""
    cfg = dict(learning_rate=1e-2, weight_decay=1e-2, warmup_steps=1, steps_per_epoch=2,
               pretrain_epochs=1, max_epochs=3)
    rs = np.random.RandomState(5)
    shapes = {"w0": (64, 32), "w1": (32,), "w2": (16, 8), "w3": (200,)}   # flax's order
    jp = {k: jnp.asarray(rs.randn(*s) * 0.1, dtype) for k, s in shapes.items()}
    params = [torch.nn.Parameter(_torch(jp[k])) for k in shapes]
    opt = make_optimizer(TrainerConfig(**cfg), params)
    schedule = make_lr_schedule(TrainerConfig(**cfg))
    jtx = jtr.make_optimizer(jtr.TrainerConfig(**cfg))
    with jax.disable_jit():
        jstate = jtx.init(jp)
        for step, scale in enumerate([3.0, 0.01, 1.0, 0.3, 2.0]):
            jg = {k: jnp.asarray(rs.randn(*s) * scale * (rs.rand(*s) > 0.1), dtype)
                  for k, s in shapes.items()}
            updates, jstate = jtx.update(jg, jstate, jp)
            jp, jnorm = optax.apply_updates(jp, updates), optax.global_norm(jg)
            for p, k in zip(params, shapes):
                p.grad = _torch(jg[k])
            norm = clip_and_step(params, opt, schedule(step), 1.0,
                                 optax_global_norm([p.grad for p in params]))
            assert float(norm) == float(jnorm), step
            adam = jstate[1][0]
            for p, k in zip(params, shapes):
                st = opt.state[p]
                for got, want in ((p, jp[k]), (st["exp_avg"], adam.mu[k]),
                                  (st["exp_avg_sq"], adam.nu[k])):
                    assert np.array_equal(_np(got), _np(want), equal_nan=True), (step, k)
    assert np.isnan(_np(params[0])).any() == (dtype == "float16")


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_three_steps_with_low_precision_parameters_match_the_jax_trainer(dtype, f32_params):
    kw = {**KW, "compute_dtype": dtype, "param_dtype": dtype}
    cfg = dict(learning_rate=1e-2, warmup_steps=1, steps_per_epoch=2, pretrain_epochs=1,
               max_epochs=2)
    batch = f32_params[1].replace(y=jnp.asarray(np.array([1, 0], np.int32)))
    jm = JaxDGDM(**kw, gather_impl="xla")
    jt = jtr.DGDMTrainer(jm, jtr.TrainerConfig(**cfg), use_mesh=False)
    epochs = [0, 0, 1] if dtype == "bfloat16" else [0, 0, 0]
    with jax.default_matmul_precision("float32"):
        # the trainer's state as init_state makes it, from the shared draw
        params0 = _cast(f32_params[0]["attention"], dtype)
        start = params_from_flax(_flat(params0))
        jt.state = jt.place_state(jtr.TrainState.create(params0, jt.tx,
                                                        jax.random.PRNGKey(11)))
        state_rng = jnp.asarray(np.array(jt.state.rng))
        tm = DGDMModel(**kw)
        load_state(tm, {k: v.clone() for k, v in start.items()})
        tt = DGDMTrainer(tm, TrainerConfig(**cfg), device="cpu")
        tt.init_state(0)
        tbatch = to_torch_graph(batch)
        tbatch = tbatch.replace(y=torch.from_numpy(np.array(batch.y)))
        draw = jax_draws(jm)
        # f16: every leaf is NaN after the second update, so the finetune
        # phase (another JAX compile) would show nothing more
        for step, epoch in enumerate(epochs):
            rng = jax.random.fold_in(state_rng, step)
            rngs = {"diffusion": jax.random.fold_in(rng, 0),
                    "masking": jax.random.fold_in(rng, 1), "dropout": jax.random.fold_in(rng, 2)}
            draws = draw(params0, batch, rngs) if epoch == 0 else None
            ref = jt.training_step(batch, epoch)
            got = tt.training_step(tbatch, epoch, draws=draws)
            assert set(got) == set(ref)
            for key in ref:
                a, b = float(got[key]), float(ref[key])
                assert np.isfinite(a) == np.isfinite(b), (step, key, a, b)
                if np.isfinite(b):
                    assert abs(a - b) <= 5e-2 * max(1.0, abs(b)), (step, key, a, b)
            ref_params = params_from_flax(_flat(jax.device_get(jt.state.params)))
            got_params = dict(tm.named_parameters())
            nonfinite = {k for k, v in ref_params.items() if not torch.isfinite(v).all()}
            assert {k for k, v in got_params.items() if not torch.isfinite(v).all()} == \
                nonfinite, step
            if dtype == "float16":                 # optax's eps is 0 in f16
                assert len(nonfinite) >= len(ref_params) - 1 if step == 0 else \
                    nonfinite == set(ref_params), (step, len(nonfinite))
    if dtype == "float16":
        return
    assert not nonfinite
    adam = jax.device_get(jt.state.opt_state)[1][0]
    moments = {"exp_avg": params_from_flax(_flat(adam.mu)),
               "exp_avg_sq": params_from_flax(_flat(adam.nu))}
    s = sum(tt.lr_schedule(i) for i in range(len(epochs)))
    moved = close = 0
    for key, ref in ref_params.items():
        got = got_params[key].detach()
        assert got.dtype == ref.dtype == torch.bfloat16, key
        if key.endswith("k_proj.bias"):                  # exact gradient 0
            continue
        d_ref, d_got = ref.float() - start[key].float(), got.float() - start[key].float()
        err = float((d_got - d_ref).norm() / d_ref.norm().clamp_min(1e-30))
        assert err <= 0.6, (key, err)
        for name, want in moments.items():
            have = tt.optimizer.state[got_params[key]][name].float()
            err = float((have - want[key].float()).norm()
                        / want[key].float().norm().clamp_min(1e-30))
            assert err <= 0.75, (key, name, err)
        big = d_ref.abs() >= s / 2
        moved += int(big.sum())
        close += int(((d_got - d_ref).abs() <= s / 4)[big].sum())
    assert moved > 20000 and close >= 0.99 * moved, (moved, close)


# ---------------------------------------------------------------------------
# bundles with bf16 and f16 leaves, both directions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_bundles_with_half_precision_leaves_in_both_directions(dtype, tmp_path, f32_params):
    """JAX -> port: the port reads the JAX bundle's leaves bit for bit
    (bf16 arrives as ``np.load``'s raw 2-byte ``|V2``). Port -> JAX: the
    port writes the same leaf bytes and dtypes as JAX's own bundle; JAX's
    ``load_model_bundle`` returns them as they are. A JAX bundle with bf16
    leaves does not apply in JAX itself (``|V2`` has no cast); f16 does."""
    kw = {**KW, "compute_dtype": dtype, "param_dtype": dtype}
    params, batch = _cast(f32_params[0]["attention"], dtype), f32_params[1]
    jm = JaxDGDM(**kw, gather_impl="xla")
    jpath = jckpt.save_model_bundle(tmp_path / "jax.npz", params, kw)
    tm = DGDMModel(**kw)
    tckpt.load_model_bundle(jpath, tm)
    want = params_from_flax(_flat(params))
    for k, v in tm.state_dict().items():
        assert v.dtype == getattr(torch, dtype) and torch.equal(v, want[k]), k
    tpath = tckpt.save_model_bundle(tmp_path / "port.npz", tm, kw)
    with np.load(jpath) as a, np.load(tpath) as b:
        assert sorted(a.files) == sorted(b.files)
        for name in a.files:
            if name.startswith("p:"):
                assert a[name].dtype.itemsize == b[name].dtype.itemsize == 2, name
                assert a[name].dtype.kind == b[name].dtype.kind, name
                assert a[name].tobytes() == b[name].tobytes(), name
    back = jckpt.load_model_bundle(tpath, params)
    leaf = jax.tree_util.tree_leaves(back)[0]
    if dtype == "bfloat16":
        assert leaf.dtype.kind == "V"                      # JAX's own bundle: the same
        as_bf16 = jax.tree_util.tree_map(lambda a: a.view(ml_dtypes.bfloat16), back)
        assert all(np.array_equal(np.asarray(x).view(np.uint16), np.asarray(y).view(np.uint16))
                   for x, y in zip(jax.tree_util.tree_leaves(as_bf16),
                                   jax.tree_util.tree_leaves(params)))
    else:
        assert leaf.dtype == np.float16
        apply = jax.jit(lambda p: jm.apply(p, batch, mode="inference")["classification_logits"])
        with jax.default_matmul_precision("float32"):
            a, b = apply(back), apply(params)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    flat = params_to_flax(tm.state_dict(), tm)
    assert {a.dtype.itemsize for a in flat.values()} == {2}
