"""Whole-model parity of the port's DGDMModel with the JAX package's, plus
the port's configuration surface, weight carry-over and isolation rules.

The small model (node_features 16, hidden (32, 16), 4 heads, 2 graph
layers, hierarchical on, N = 128 with 100 real nodes, 2 graphs) runs in f32;
logits and attention must agree within 1e-3 with JAX ``gather_impl="xla"``
(tests/test_pallas.py holds xla equal to the pallas formulation).
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from conftest import make_synthetic_graph
from dgdm_histopath_tpu.models import DGDMModel as JaxDGDM
from dgdm_histopath_tpu.models.presets import default_window_policy as j_policy
from dgdm_histopath_tpu.ops.graph import batch_graphs as j_batch
from dgdm_histopath_torch.convert import load_state, params_from_flax
from dgdm_histopath_torch.evaluation.predictor import DGDMPredictor
from dgdm_histopath_torch.models.dgdm import DGDMModel
from dgdm_histopath_torch.models.presets import create_model, default_window_policy
from dgdm_histopath_torch.ops.graph import PaddedGraph
from dgdm_histopath_torch.utils.exceptions import CheckpointError, ConfigurationError

REPO = Path(__file__).resolve().parents[1]
KW = dict(node_features=16, hidden_dims=(32, 16), num_diffusion_steps=3,
          attention_heads=4, graph_layers=2, num_classes=2, regression_targets=1,
          survival_mode="discrete", survival_intervals=4, compute_dtype="float32",
          dropout=0.0)
RNGS = {"params": jax.random.PRNGKey(0), "diffusion": jax.random.PRNGKey(1),
        "masking": jax.random.PRNGKey(2)}


def _flat(variables):
    leaves = jax.tree_util.tree_flatten_with_path(variables)[0]
    return {"/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(v)
            for kp, v in leaves}


def to_torch_graph(g) -> PaddedGraph:
    return PaddedGraph(**{f: torch.from_numpy(np.array(getattr(g, f))) for f in
                          ("x", "pos", "nbr_idx", "nbr_mask", "edge_attr", "node_mask")})


@pytest.fixture(scope="module")
def small_pair():
    """(JAX outputs, port model, port batch) for the small model."""
    batch = j_batch([make_synthetic_graph(seed=i, n_nodes=128, n_real=100, feat_dim=16)
                     for i in range(2)])
    jm = JaxDGDM(**KW, gather_impl="xla")
    with jax.default_matmul_precision("float32"):
        params = jax.jit(lambda g: jm.init(RNGS, g, mode="pretrain", deterministic=True))(batch)
        ref = jax.jit(lambda p, g: jm.apply(p, g, mode="inference", deterministic=True,
                                            return_attention=True))(params, batch)
    tm = DGDMModel(**KW)
    load_state(tm, params_from_flax(_flat(params)))
    return ref, tm.eval(), to_torch_graph(batch)


def test_small_model_inference_matches_jax(small_pair):
    ref, tm, batch = small_pair
    with torch.inference_mode():
        out = tm(batch, mode="inference", return_attention=True)

    def close(a, b):
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32),
                                   atol=1e-3, rtol=1e-3)

    close(out["classification_logits"], ref["classification_logits"])
    close(out["attention_weights"], ref["attention_weights"])
    close(out["graph_embedding"], ref["graph_embedding"])
    close(out["spatial_attention"], ref["spatial_attention"])
    close(out["regression"]["mean"], ref["regression"]["mean"])
    close(out["survival"]["survival"], ref["survival"]["survival"])
    for a, b in zip(out["edge_attentions"], ref["edge_attentions"]):
        close(a, b)


def test_finetune_mode_is_the_deterministic_inference_forward(small_pair):
    _, tm, batch = small_pair
    with torch.inference_mode():
        a = tm(batch, mode="inference")["classification_logits"]
        b = tm(batch, mode="finetune")["classification_logits"]
    assert torch.equal(a, b)


def test_base_state_dict_matches_the_jax_parameter_tree():
    """Every key of a DGDM-Base bundle maps onto the port, shapes included."""
    g = j_batch([make_synthetic_graph(n_nodes=16, n_real=12, feat_dim=768, seed=0)])
    jm = JaxDGDM(num_classes=2)
    shapes = jax.eval_shape(lambda: jm.init(RNGS, g, mode="pretrain", deterministic=True))
    flat = {k: np.zeros(v.shape, np.float32) for k, v in _flat(
        jax.tree_util.tree_map(lambda s: np.empty(s.shape, np.float32), shapes)).items()}
    model = create_model("dgdm-base", num_classes=2, device="cpu")
    load_state(model, params_from_flax(flat))      # strict: raises on any mismatch
    assert sum(v.size for v in flat.values()) == sum(p.numel() for p in model.parameters())


@pytest.mark.parametrize("change,error", [
    ({"missing": "pool.global_query"}, "paths mismatch"),
    ({"extra": "pool.surplus"}, "paths mismatch"),
    ({"reshape": "graph_encoder.edge_proj.weight"}, "shape mismatch"),
])
def test_weight_load_is_strict(change, error):
    model = DGDMModel(**KW)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    state.pop(change.get("missing", "__none__"), None)
    if "extra" in change:
        state[change["extra"]] = torch.zeros(1)
    if "reshape" in change:
        state[change["reshape"]] = state[change["reshape"]].t()
    with pytest.raises(CheckpointError, match=error):
        load_state(model, state)


def test_flax_layout_rules():
    rs = np.random.RandomState(0)
    dense, dg, out_proj = rs.randn(3, 5), rs.randn(6, 2, 4), rs.randn(2, 4, 6)
    st = params_from_flax({
        "params/a/kernel": dense, "params/q_proj/kernel": dg,
        "params/q_proj/bias": rs.randn(2, 4), "params/out_proj/kernel": out_proj,
        "params/norm/scale": np.ones(3), "params/pool/global_query": rs.randn(2, 4),
        "params/mask_token": rs.randn(5)})
    np.testing.assert_array_equal(st["a.weight"].numpy(), dense.T.astype(np.float32))
    np.testing.assert_array_equal(st["q_proj.weight"].numpy(),
                                  dg.reshape(6, 8).T.astype(np.float32))
    assert st["q_proj.bias"].shape == (8,)
    np.testing.assert_array_equal(st["out_proj.weight"].numpy(),
                                  out_proj.reshape(8, 6).T.astype(np.float32))
    assert st["norm.weight"].shape == (3,) and st["pool.global_query"].shape == (2, 4)
    assert st["mask_token"].shape == (5,)


@pytest.mark.parametrize("override", [
    {"spatial_window": 64}, {"graph_window": 64}, {"moe_experts": 4},
    {"pooling": "set2set"}, {"attention_traffic_dtype": "bfloat16"},
    {"param_dtype": "bfloat16"}, {"compute_dtype": "float16"},
])
def test_unported_options_raise_naming_the_roadmap(override):
    """Every option builds and reaches its modules (item 8's three since its
    slice: Set2Set pooling, parameters stored in ``param_dtype``, layers
    computing in ``compute_dtype``); a value outside each option's range
    raises. No option raises ``NotImplementedError`` any more."""
    ported = {"spatial_window": lambda m: m.spatial_attention.window_size,
              "pooling": lambda m: (type(m.pool).__name__, m.pool.lstm.features),
              "param_dtype": lambda m: ({p.dtype for p in m.parameters()},
                                        m.graph_encoder.layer0.conv1.bias.dtype),
              "compute_dtype": lambda m: (m.dtype, m.graph_unet.down0.q_proj.compute_dtype,
                                          m.pool.out_proj.compute_dtype),
              "moe_experts": lambda m: (m.moe_ffn.num_experts, m.moe_ffn.top_k,
                                        m.moe_ffn.hidden_dim, m.moe_norm.normalized_shape),
              "graph_window": lambda m: (m.graph_encoder.layer0.band_window,
                                         m.graph_encoder.layer1.band_window,
                                         m.graph_unet.down0.band_window,
                                         m.graph_unet.down1.band_window),
              "attention_traffic_dtype": lambda m: m.spatial_attention.traffic_dtype}
    (name, value), = override.items()
    want = {"spatial_window": 64, "graph_window": (64, 64, 64, None),
            "attention_traffic_dtype": torch.bfloat16,
            "moe_experts": (4, 1, 2 * KW["hidden_dims"][-1], (KW["hidden_dims"][-1],)),
            "pooling": ("GlobalSet2SetPool", KW["hidden_dims"][-1]),
            "param_dtype": ({torch.bfloat16}, torch.bfloat16),
            "compute_dtype": (torch.float16,) * 3,
            }[name]
    assert ported[name](DGDMModel(**{**KW, **override})) == want
    # make_pool raises ValueError for an unknown pooling, as the reference's does
    with pytest.raises(ValueError if name == "pooling" else ConfigurationError):
        DGDMModel(**{**KW, name: -1 if name in ("spatial_window", "graph_window",
                                                "moe_experts") else "int8"})


def test_pretrain_and_dropout_forward_raise(small_pair):
    """These two forwards raised until the training slice; now the pretrain
    forward gives its outputs, a dropout forward differs from the
    deterministic one, and only an unknown mode raises."""
    _, tm, batch = small_pair
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        out = tm(batch, mode="pretrain", generator=gen)
    assert out["diffusion_loss"].shape == () and torch.isfinite(out["diffusion_loss"])
    assert out["diffusion_t"].shape == (2,) and out["reconstruction"].shape == (2, 128, 16)
    assert "classification_logits" in out
    dropout_model = DGDMModel(**{**KW, "dropout": 0.1})
    dropout_model.load_state_dict(tm.state_dict())
    with torch.no_grad():
        noisy = dropout_model(batch, deterministic=False, generator=gen)
        assert torch.equal(dropout_model(batch)["classification_logits"],
                           tm(batch)["classification_logits"])
    assert not torch.equal(noisy["classification_logits"], tm(batch)["classification_logits"])
    with pytest.raises(ValueError, match="unknown mode"):
        tm(batch, mode="train")


@pytest.mark.parametrize("impl", ["auto", "onehot", "xla", "pallas"])
def test_every_gather_impl_is_the_gather_formulation(impl, small_pair):
    _, tm, batch = small_pair
    other = DGDMModel(**{**KW, "gather_impl": impl})
    other.load_state_dict(tm.state_dict())
    with torch.inference_mode():
        assert torch.equal(other.eval()(batch)["classification_logits"],
                           tm(batch)["classification_logits"])


def test_invalid_config_raises():
    with pytest.raises(ConfigurationError):
        DGDMModel(**{**KW, "gather_impl": "bogus"})
    with pytest.raises(ConfigurationError):
        DGDMModel(**{**KW, "attention_heads": 5})


@pytest.mark.parametrize("n", [128, 1024, 2048, 4096])
def test_default_window_policy_matches(n):
    assert default_window_policy(n) == j_policy(n)


def test_entry_points_refuse_to_run_on_the_cpu_silently(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_model("dgdm-small", num_classes=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DGDMPredictor(model=DGDMModel(**KW))
    assert DGDMPredictor(model=DGDMModel(**KW), device="cpu").device.type == "cpu"


def test_port_runs_with_jax_blocked():
    """Imports the port with jax/flax unimportable and runs a tiny CPU forward."""
    code = (
        "import sys\n"
        "for m in ('jax', 'flax', 'dgdm_histopath_tpu'): sys.modules[m] = None\n"
        "import numpy as np, torch\n"
        "from dgdm_histopath_torch import DGDMPredictor, create_model, build_padded_graph\n"
        "import dgdm_histopath_torch.deployment.serving\n"
        "import dgdm_histopath_torch.ops.kernels.flash_spatial\n"
        "from dgdm_histopath_torch.nn.attention import SpatialAttention\n"
        "a = SpatialAttention(128, 8, use_flash=True)\n"
        "o = a(torch.randn(1, 128, 128), torch.rand(1, 128, 2),"
        " torch.ones(1, 128, dtype=torch.bool))\n"
        "assert o.shape == (1, 128, 128) and a.route(128) == 'flash'\n"
        "m = create_model('dgdm-small', num_classes=2, device='cpu', node_features=8,"
        " hidden_dims=(16, 8), compute_dtype='float32')\n"
        "rs = np.random.RandomState(0)\n"
        "g = build_padded_graph(rs.randn(10, 8), rs.rand(10, 2), rs.randint(0, 10, (10, 3)),"
        " rs.rand(10, 3, 3), np.ones((10, 3), bool), bucket=16)\n"
        "r = DGDMPredictor(model=m, device='cpu').predict_graph(g)\n"
        "assert abs(r['probabilities'].sum() - 1) < 1e-5\n"
        "print('ok')\n")
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().endswith("ok")


FORBIDDEN = ("jax", "flax", "dgdm_histopath_tpu")


def test_no_port_file_imports_jax_flax_or_the_jax_package():
    files = sorted((REPO / "dgdm_histopath_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            bad += [f"{path.name}: {n}" for n in names if n.split(".")[0] in FORBIDDEN]
    assert not bad, bad
    assert len(files) > 15
