"""w8a8 int8 inference on the port (``ops/quant.py``, ``models/quantized.py``,
``models/vit_int8.py``, the int8 featurizer and ``DGDMPredictor(quant=
"int8")``) against the JAX package's, on the CPU.

The JAX side runs under ``jax.jit``, as every JAX product does (the
predictor, the featurizer and the edge engine): XLA compiles ``absmax / 127``
as a product with the f32 reciprocal, and so does the port.

Tolerances: the int8 values of weights and activations equal the JAX
package's, zero rows and columns and halfway ties included; the int32
products are exact; ``int8_dense`` within 1e-6 of its output scale. The DGDM
model (JAX ``tests/test_quant.py``'s: hidden (128, 64), 4 heads, 2 layers,
f32) reroutes exactly the modules JAX reroutes, and its logits agree within
1e-4; its U-Net's f32 sums run in another order than XLA's, so a few of its
int8 activations land one step apart (held to 0.1% of them, one step each).
The small ViT (LayerScale gammas ~1, so that the blocks count) quantizes
every activation as JAX does and its features agree within 1e-5; each stage
on the same input within 1e-5. The featurizer's resize differs from
``jax.image.resize`` by up to 6e-5 on the 0-255 scale, which moves a few
activations a step (see its test).
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

import dgdm_histopath_tpu.ops.quant as jquant
import dgdm_histopath_torch.ops.quant as tquant
from conftest import make_synthetic_graph
from dgdm_histopath_tpu.models import DGDMModel as JaxDGDM
from dgdm_histopath_tpu.models import quantized as jq
from dgdm_histopath_tpu.models import vit as jvit
from dgdm_histopath_tpu.models import vit_int8 as jv8
from dgdm_histopath_tpu.ops.graph import batch_graphs as j_batch
from dgdm_histopath_tpu.preprocessing.synthetic import generate_tissue_image
from dgdm_histopath_torch.convert import encoder_params_from_flax, load_state, params_from_flax
from dgdm_histopath_torch.evaluation.predictor import DGDMPredictor
from dgdm_histopath_torch.models import quantized as tq
from dgdm_histopath_torch.models import vit
from dgdm_histopath_torch.models import vit_int8 as tv8
from dgdm_histopath_torch.models.dgdm import DGDMModel
from dgdm_histopath_torch.nn.layers import Dense, DenseGeneral
from dgdm_histopath_torch.ops.graph import PaddedGraph
from dgdm_histopath_torch.utils.exceptions import InferenceError

KW = dict(node_features=128, hidden_dims=(128, 64), num_diffusion_steps=4,
          attention_heads=4, graph_layers=2, num_classes=3, compute_dtype="float32")
RNGS = {"params": jax.random.PRNGKey(0), "diffusion": jax.random.PRNGKey(1),
        "masking": jax.random.PRNGKey(2), "dropout": jax.random.PRNGKey(3)}
FIELDS = ("x", "pos", "nbr_idx", "nbr_mask", "edge_attr", "node_mask")
INFER = dict(mode="inference", deterministic=True, return_attention=True)


def _flat(variables):
    leaves = jax.tree_util.tree_flatten_with_path(variables)[0]
    return {"/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(v) for kp, v in leaves}


def _graph(g) -> PaddedGraph:
    return PaddedGraph(**{f: torch.from_numpy(np.array(getattr(g, f))) for f in FIELDS})


def _recording(inner):
    """A JAX interceptor around ``inner`` that records the path of every
    module it reroutes (its float ``next_fun`` not called)."""
    paths = set()

    def interceptor(next_fun, args, kwargs, context):
        called = []

        def float_call(*a, **k):
            called.append(True)
            return next_fun(*a, **k)
        out = inner(float_call, args, kwargs, context)
        if not called:
            paths.add("/".join(context.module.path))
        return out
    return interceptor, paths


def _record_activations(monkeypatch, module):
    """Record each int8 activation tensor ``module.quantize_activations`` makes."""
    seen = []
    original = module.quantize_activations

    def recording(x):
        q, s = original(x)
        seen.append(q)
        return q, s
    monkeypatch.setattr(module, "quantize_activations", recording)
    return seen


def _jit_recording(fn, seen):
    """``fn`` under ``jax.jit``, also returning the activations it quantized."""
    def run(*args):
        seen.clear()
        return fn(*args), list(seen)
    return jax.jit(run)


@pytest.fixture(scope="module")
def dgdm():
    """The JAX model's int8 outputs (and the paths it reroutes) and the
    port's model with the same parameters, on the same 2 graphs."""
    g = j_batch([make_synthetic_graph(seed=i, n_nodes=64, n_real=56, feat_dim=128,
                                      num_classes=3) for i in range(2)])
    jm = JaxDGDM(**KW)
    interceptor, paths = _recording(jq.make_int8_interceptor())

    def int8_forward(p, gg):
        with nn.intercept_methods(interceptor):
            return jm.apply(p, gg, **INFER)
    with jax.default_matmul_precision("float32"), pytest.MonkeyPatch.context() as mp:
        params = jax.jit(lambda gg: jm.init(RNGS, gg, mode="pretrain"))(g)
        acts = _record_activations(mp, jquant)
        ref8, acts = _jit_recording(int8_forward, acts)(params, g)
    tm = DGDMModel(**KW)
    load_state(tm, params_from_flax(_flat(params)))
    return dict(ref8=ref8, acts=acts, paths=paths, tm=tm.eval(), tg=_graph(g))


# ---------------------------------------------------------------------------
# the primitives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["random", "zero_column", "ties"])
def test_quantize_weight_matches_jax(case):
    rs = np.random.RandomState(1)
    w = rs.randn(96, 40).astype(np.float32)          # JAX kernel [K, N]
    if case == "zero_column":
        w[:, 3] = 0.0
    if case == "ties":                                # column 0: scale 1, x.5 values
        w[:, 0] = 0.0
        w[:6, 0] = [127.0, 0.5, 1.5, 2.5, -0.5, -3.5]
    jw, js = jax.jit(jquant.quantize_weight)(jnp.asarray(w))
    tw, ts = tquant.quantize_weight(torch.from_numpy(w.T.copy()), axis=0)   # Dense.weight [N, K]
    assert tw.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tw.numpy().T, np.asarray(jw))
    np.testing.assert_array_equal(ts.numpy().reshape(-1), np.asarray(js).reshape(-1))
    kw, ks = tquant.quantize_weight(torch.from_numpy(w))                   # the JAX layout
    np.testing.assert_array_equal(kw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(ks.numpy(), np.asarray(js))


def test_quantize_activations_match_jax():
    """Per row: an outlier row, a zero row and halfway ties (scale 1)."""
    x = np.random.RandomState(2).randn(5, 64).astype(np.float32)
    x[0] *= 1000.0
    x[1] = 0.0
    x[2, :6] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5]
    x[2, 6:] = 0.0
    jx, js = jax.jit(jquant.quantize_activations)(jnp.asarray(x))
    tx, ts = tquant.quantize_activations(torch.from_numpy(x))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tx[2, :6].tolist() == [127, 0, 2, 2, 0, -2]


@pytest.mark.parametrize("m,k,n", [(16, 64, 32), (1, 20, 13), (40, 128, 64)])
def test_int8_matmul_is_exact(m, k, n):
    rs = np.random.RandomState(m)
    x = rs.randint(-127, 128, (m, k)).astype(np.int8)
    w = rs.randint(-127, 128, (k, n)).astype(np.int8)
    want = x.astype(np.int64) @ w.astype(np.int64)
    out = tquant.int8_matmul(torch.from_numpy(x), torch.from_numpy(w.T.copy()))
    plain = tquant.int8_matmul_plain(torch.from_numpy(x), torch.from_numpy(w.T.copy()))
    assert out.dtype == plain.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), want)
    np.testing.assert_array_equal(plain.numpy(), want)
    np.testing.assert_array_equal(
        np.asarray(jax.jit(jquant.int8_matmul)(jnp.asarray(x), jnp.asarray(w))), want)


@pytest.mark.parametrize("bias", [True, False])
def test_int8_dense_matches_jax(bias):
    rs = np.random.RandomState(3)
    x = rs.randn(2, 16, 128).astype(np.float32)
    w = (rs.randn(128, 64) * 0.05).astype(np.float32)
    b = (rs.randn(64) * 0.1).astype(np.float32) if bias else None
    jw, js = jax.jit(jquant.quantize_weight)(jnp.asarray(w))
    ref = np.asarray(jax.jit(jquant.int8_dense)(jnp.asarray(x), jw, js,
                                                None if b is None else jnp.asarray(b)))
    tw, ts = tquant.quantize_weight(torch.from_numpy(w.T.copy()), axis=0)
    tb = None if b is None else torch.from_numpy(b)
    out = tquant.int8_dense(torch.from_numpy(x), tw, ts, tb)
    plain = tquant.int8_dense(torch.from_numpy(x), tw, ts, tb, matmul=tquant.int8_matmul_plain)
    assert out.shape == (2, 16, 64) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6 * np.abs(ref).max(), rtol=0)
    assert torch.equal(out, plain)


# ---------------------------------------------------------------------------
# the graph model
# ---------------------------------------------------------------------------

def test_rerouted_modules_are_jaxs(dgdm):
    """The port reroutes exactly the modules the JAX interceptor reroutes;
    every DenseGeneral (a flax DenseGeneral in JAX) stays float."""
    tm = dgdm["tm"]
    names = {id(m): n for n, m in tm.named_modules()}
    hit = set()
    inner = tq.make_int8_interceptor()

    def recording(mod, x):
        out = inner(mod, x)
        if out is not None:
            hit.add(names[id(mod)].replace(".", "/"))
        return out
    with torch.inference_mode(), tq.intercept_dense(recording):
        tm(dgdm["tg"], **INFER)
    assert hit == dgdm["paths"] and len(hit) == 22
    general = {n.replace(".", "/") for n, m in tm.named_modules() if isinstance(m, DenseGeneral)}
    assert general and not general & hit
    assert all(type(m) is Dense for n, m in tm.named_modules() if n.replace(".", "/") in hit)


def test_int8_apply_logits_match_jax(dgdm, monkeypatch):
    acts = _record_activations(monkeypatch, tquant)
    with torch.inference_mode():
        out = tq.int8_apply(dgdm["tm"], dgdm["tg"], **INFER)
    monkeypatch.undo()
    with torch.inference_mode():
        flt = dgdm["tm"](dgdm["tg"], **INFER)
    assert len(acts) == len(dgdm["acts"]) == 22
    steps = np.concatenate([np.abs(np.asarray(a, np.int32).reshape(b.shape)
                                   - b.numpy().astype(np.int32)).ravel()
                            for a, b in zip(dgdm["acts"], acts)])
    assert steps.max() <= 1 and np.count_nonzero(steps) <= 1e-3 * steps.size
    for key, atol in (("classification_logits", 1e-4), ("graph_embedding", 1e-4),
                      ("attention_weights", 1e-6)):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(dgdm["ref8"][key]),
                                   atol=atol, rtol=0, err_msg=key)
    # the int8 forward is not the float forward
    gap = (out["classification_logits"] - flt["classification_logits"]).abs().max()
    assert float(gap) > 1e-3


def test_min_features_gate_equals_the_float_forward(dgdm):
    with torch.inference_mode():
        out = tq.int8_apply(dgdm["tm"], dgdm["tg"], min_features=10 ** 5, **INFER)
        flt = dgdm["tm"](dgdm["tg"], **INFER)
    assert torch.equal(out["classification_logits"], flt["classification_logits"])
    fn = tq.int8_apply_fn(dgdm["tm"], min_features=10 ** 5)
    with torch.inference_mode():
        assert torch.equal(fn(dgdm["tg"], **INFER)["classification_logits"],
                           flt["classification_logits"])


def test_padding_does_not_move_int8_outputs(dgdm):
    """Padded nodes' features changed: real outputs within 1e-5 (per-row
    activation scales keep padding out of the quantizer)."""
    tg = dgdm["tg"]
    x = tg.x.clone()
    x[~tg.node_mask] = 9.9
    with torch.inference_mode():
        a = tq.int8_apply(dgdm["tm"], tg, mode="inference")["classification_logits"]
        b = tq.int8_apply(dgdm["tm"], tg.replace(x=x), mode="inference")["classification_logits"]
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=0)


def test_int8_is_per_call_across_threads_and_follows_weight_updates(dgdm):
    """Float and int8 callers on threads get their own answers; the cached
    int8 weight is recomputed after the weight changes in place."""
    tm, tg = dgdm["tm"], dgdm["tg"]
    with torch.inference_mode():
        want8 = tq.int8_apply(tm, tg, mode="inference")["classification_logits"]
        want = tm(tg, mode="inference")["classification_logits"]
    got = {}

    def run(name, fn):
        with torch.inference_mode():
            got[name] = [fn()["classification_logits"] for _ in range(3)]
    threads = [threading.Thread(target=run, args=("int8", lambda: tq.int8_apply(
        tm, tg, mode="inference"))), threading.Thread(target=run, args=(
            "float", lambda: tm(tg, mode="inference")))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert all(torch.equal(t, want8) for t in got["int8"])
    assert all(torch.equal(t, want) for t in got["float"])
    lin = tm.feature_encoder.dense0
    saved = lin.weight.detach().clone()
    try:
        with torch.no_grad():
            lin.weight.mul_(0.5)
        with torch.inference_mode():
            moved = tq.int8_apply(tm, tg, mode="inference")["classification_logits"]
        assert not torch.equal(moved, want8)
    finally:
        with torch.no_grad():
            lin.weight.copy_(saved)
    with torch.inference_mode():
        assert torch.equal(tq.int8_apply(tm, tg, mode="inference")["classification_logits"],
                           want8)


def test_predictor_int8_predicts_through_int8_apply(dgdm):
    tm, tg = dgdm["tm"], dgdm["tg"]
    pred = DGDMPredictor(model=tm, device="cpu", feature_extractor="none", quant="int8")
    single = pred.predict_graph(PaddedGraph(**{f: getattr(tg, f)[0] for f in FIELDS}))
    with torch.inference_mode():
        want = tq.int8_apply(tm, tg, **INFER)
    np.testing.assert_allclose(single["logits"], want["classification_logits"][0].numpy(),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(single["logits"],
                               np.asarray(dgdm["ref8"]["classification_logits"])[0],
                               atol=1e-4, rtol=0)
    assert single["biomarkers"] and np.isfinite(single["probabilities"]).all()
    both = pred.predict_batch([PaddedGraph(**{f: getattr(tg, f)[i] for f in FIELDS})
                               for i in range(2)])
    probs = torch.softmax(want["classification_logits"], -1).numpy()
    np.testing.assert_allclose(np.stack([r["probabilities"] for r in both]), probs,
                               atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# the ViT featurizer
# ---------------------------------------------------------------------------

TINY = dict(embed_dim=64, depth=2, num_heads=4, patch_size=8)


@pytest.fixture(scope="module")
def small_vit():
    """A 2-block ViT at image 32 with LayerScale gammas ~1 (DINOv2's 1e-5
    would make the blocks vanish), the same parameters on both sides."""
    jm = jvit.VisionTransformer(**TINY, layer_scale=True, dtype=jnp.float32)
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0),
                                                        jnp.zeros((1, 32, 32, 3))))
    rs = np.random.RandomState(1)
    for blk in ("block0", "block1"):
        for name in ("ls1_gamma", "ls2_gamma"):
            params["params"][blk][name] = rs.uniform(0.5, 1.5, 64).astype(np.float32)
    tm = vit.VisionTransformer(**TINY, layer_scale=True, image_size=32, dtype=torch.float32)
    load_state(tm, encoder_params_from_flax(params))
    return jm, params, tm.eval()


def test_quantized_vit_tree_matches_jax(small_vit):
    _, params, tm = small_vit
    jp = jax.jit(jv8.quantize_vit_params)(params)["params"]
    tp = tv8.quantize_vit_params(tm)
    hd = 64
    for i in range(2):
        jb, tb = jp[f"block{i}"], tp["blocks"][i]
        for j, proj in enumerate(("query", "key", "value")):     # [D, H·Dh] in JAX
            np.testing.assert_array_equal(tb["qkv"]["q"][j * hd:(j + 1) * hd].numpy().T,
                                          np.asarray(jb["attn"][proj]["q"]))
            np.testing.assert_array_equal(tb["qkv"]["s"][j * hd:(j + 1) * hd].numpy(),
                                          np.asarray(jb["attn"][proj]["s"]).reshape(-1))
        for tname, jsub in (("out", jb["attn"]["out"]), ("mlp1", jb["mlp1"]),
                            ("mlp2", jb["mlp2"])):
            assert tb[tname]["q"].dtype == torch.int8
            np.testing.assert_array_equal(tb[tname]["q"].numpy().T, np.asarray(jsub["q"]))
            np.testing.assert_array_equal(tb[tname]["s"].numpy(), np.asarray(jsub["s"]).reshape(-1))
        assert tb["out"]["q"].shape == (64, hd)           # [D, H·Dh]
        np.testing.assert_array_equal(tb["ls1_gamma"].numpy(), jb["ls1_gamma"])
    assert tp["patch_embed"][0].dtype == torch.float32


def _activation_steps(jax_acts, port_acts) -> np.ndarray:
    """JAX quantizes q, k and v apart (from the same input), the port once:
    pair each port product's int8 activations with JAX's and return the
    step differences, all products together."""
    per_block = [a for i, a in enumerate(jax_acts) if i % 6 not in (1, 2)]
    assert len(per_block) == len(port_acts)
    return np.concatenate([
        np.abs(np.asarray(a, np.int32).reshape(b.shape) - b.numpy().astype(np.int32)).ravel()
        for a, b in zip(per_block, port_acts)])


def test_vit_int8_forward_matches_jax(small_vit, monkeypatch):
    """Every int8 activation equal to JAX's; features within 1e-5."""
    jm, params, tm = small_vit
    x = np.random.RandomState(0).randn(4, 32, 32, 3).astype(np.float32)
    jacts = _record_activations(monkeypatch, jquant)
    tacts = _record_activations(monkeypatch, tquant)
    with jax.default_matmul_precision("float32"):
        ref, jacts = _jit_recording(jv8.vit_int8_forward, jacts)(
            jax.jit(jv8.quantize_vit_params)(params), jnp.asarray(x))
        ref = np.asarray(ref)
        flt = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x)))
    with torch.inference_mode():
        out = tv8.vit_int8_forward(tv8.quantize_vit_params(tm), torch.from_numpy(x)).numpy()
    assert out.shape == (4, 64) and out.dtype == np.float32
    assert not _activation_steps(jacts, tacts).any()
    np.testing.assert_allclose(out, ref, atol=1e-5 * np.abs(ref).max(), rtol=0)
    assert np.abs(ref - flt).max() > 5e-3 * np.abs(ref).max()      # int8 is not float


def test_vit_int8_stages_match_jax_on_the_same_input(small_vit):
    """One block's attention and MLP on JAX's input: within 1e-5."""
    _, params, tm = small_vit
    jp = jax.jit(jv8.quantize_vit_params)(params)["params"]
    tp = tv8.quantize_vit_params(tm)
    h = np.random.RandomState(4).randn(3, 17, 64).astype(np.float32)
    m1 = jp["block1"]["mlp1"]
    with jax.default_matmul_precision("float32"):
        ref_attn = np.asarray(jax.jit(jv8._attn_int8)(jnp.asarray(h), jp["block1"]["attn"]))
        ref_mlp = np.asarray(jax.jit(lambda a: jax.nn.gelu(jquant.int8_dense(
            a, m1["q"], m1["s"], m1["bias"]), approximate=False))(jnp.asarray(h)))
        ref_ln = np.asarray(jax.jit(jv8._layer_norm)(jnp.asarray(h), jp["block1"]["norm1"]))
    t = torch.from_numpy(h)
    tb = tp["blocks"][1]
    for out, ref in ((tv8._attn_int8(t, tb), ref_attn),
                     (torch.nn.functional.gelu(tv8._dense(t, tb["mlp1"])), ref_mlp),
                     (tv8._layer_norm(t, tb["norm1"]), ref_ln)):
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-5 * np.abs(ref).max(), rtol=0)


@pytest.mark.parametrize("size", [32, 64])
def test_int8_extractor_matches_jax(small_vit, monkeypatch, size):
    """The fused featurizer (no stain step) with the small ViT in both
    extractors, int8. At 32 px: every activation equal, features within
    1e-5. At 64 px the resize to 32 runs first and differs from
    ``jax.image.resize`` by up to 6e-5 on the 0-255 scale (its sums in
    another order, ``tests/test_torch_vit.py``), so activations behind it
    land one or two steps apart: held to 2% of them, two steps, and features
    within 1% of the largest."""
    jm, params, tm = small_vit
    jext = jvit.PatchFeatureExtractor(arch="stats", image_size=32)
    text = vit.PatchFeatureExtractor(arch="stats", image_size=32, device="cpu")
    jext.module, jext.params, jext.quant = jm, params, "int8"
    text.module, text.quant = tm, "int8"
    jext._refresh_quant_params()
    text._refresh_quant_params()
    img, _ = generate_tissue_image(256, 256, seed=3)
    p = np.stack([img[(i // 3) * 64:(i // 3) * 64 + size, (i % 3) * 64:(i % 3) * 64 + size]
                  for i in range(6)])
    jacts = _record_activations(monkeypatch, jquant)
    tacts = _record_activations(monkeypatch, tquant)
    with jax.default_matmul_precision("float32"):
        ref, jacts = _jit_recording(jext._fused_forward, jacts)(jext._qparams, jnp.asarray(p))
        ref = np.asarray(ref)
    with torch.inference_mode():
        out = text.fused_forward(torch.from_numpy(p)).numpy()
    steps = _activation_steps(jacts, tacts)
    if size == 32:
        assert not steps.any()
        np.testing.assert_allclose(out, ref, atol=1e-5 * np.abs(ref).max(), rtol=0)
    else:
        assert steps.max() <= 2 and np.count_nonzero(steps) <= 0.02 * steps.size
        np.testing.assert_allclose(out, ref, atol=1e-2 * np.abs(ref).max(), rtol=0)


@pytest.mark.parametrize("arch,quant", [("stats", "int8"), ("simple_cnn", "int8"),
                                        ("simple_cnn+stats", "int8"), ("vit_small", "int4")])
def test_quant_options_the_jax_extractor_refuses(arch, quant):
    with pytest.raises(ValueError):
        jvit.PatchFeatureExtractor(arch=arch, quant=quant)
    with pytest.raises(ValueError):
        vit.PatchFeatureExtractor(arch=arch, quant=quant, device="cpu")


def test_predictor_refuses_an_unknown_quant_mode(dgdm):
    with pytest.raises(InferenceError, match="unsupported quant mode"):
        DGDMPredictor(model=dgdm["tm"], device="cpu", feature_extractor="none", quant="int4")
    with pytest.raises(ValueError, match="requires a ViT arch"):
        DGDMPredictor(model=dgdm["tm"], device="cpu", feature_extractor="stats", quant="int8")
