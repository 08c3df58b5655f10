"""The port's edge deployment tier (``deployment/edge.py``) against the JAX
package's, on the CPU.

The bundle is the JAX package's ``edge_npz_v2``: for the same parameters both
packages write the same arrays under the same names with the same per-leaf
metadata, for every quantization. A bundle written by either loads in the
other, and the engines predict within 1e-4 of each other in f32 (the int8
engine computes through each package's ``int8_apply``). The model is wide
enough (64) for int8 to reroute its Dense layers.
"""

import json

import jax
import numpy as np
import pytest
import torch

from conftest import make_synthetic_graph
from dgdm_histopath_tpu import deployment as jdep
from dgdm_histopath_tpu.models import DGDMModel as JaxDGDM
from dgdm_histopath_tpu.ops.graph import batch_graphs as j_batch
from dgdm_histopath_torch import deployment as tdep
from dgdm_histopath_torch.convert import load_state, params_from_flax
from dgdm_histopath_torch.models.dgdm import DGDMModel
from dgdm_histopath_torch.models.quantized import int8_apply
from dgdm_histopath_torch.ops.graph import PaddedGraph

CFG = dict(node_features=64, hidden_dims=(64, 64), num_diffusion_steps=2, attention_heads=4,
           graph_layers=1, num_classes=2, use_hierarchical=False, use_spatial_attention=False,
           compute_dtype="float32")
MOE_CFG = dict(CFG, node_features=8, hidden_dims=(16, 8), moe_experts=2)
RNGS = {"params": jax.random.PRNGKey(0), "diffusion": jax.random.PRNGKey(1),
        "masking": jax.random.PRNGKey(2)}
FIELDS = ("x", "pos", "nbr_idx", "nbr_mask", "edge_attr", "node_mask")


def _flat(variables):
    leaves = jax.tree_util.tree_flatten_with_path(variables)[0]
    return {"/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(v, np.float32)
            for kp, v in leaves}


def _setup(cfg):
    g = j_batch([make_synthetic_graph(seed=i, n_nodes=16, n_real=12, feat_dim=cfg["node_features"])
                 for i in range(2)])
    jm = JaxDGDM(**cfg)
    params = jax.jit(lambda gg: jm.init(RNGS, gg, mode="pretrain", deterministic=True))(g)
    tm = DGDMModel(**cfg)
    load_state(tm, params_from_flax(_flat(params)))
    tg = PaddedGraph(**{f: torch.from_numpy(np.array(getattr(g, f))) for f in FIELDS})
    return dict(jm=jm, params=params, g=g, tm=tm.eval(), tg=tg)


@pytest.fixture(scope="module")
def pair():
    return _setup(CFG)


def _bundle(path):
    with np.load(path, allow_pickle=False) as data:
        return json.loads(str(data["__meta__"])), {k: data[k] for k in data.files
                                                   if k != "__meta__"}


@pytest.mark.parametrize("quant", ["int8", "bf16", "bfloat16", "none"])
def test_bundle_is_the_jax_bundle_and_round_trips(pair, tmp_path, quant):
    """Same arrays, names, per-leaf kinds and scales and stats as the JAX
    package's bundle of the same parameters; loaded back, the engine predicts
    what the model does with the stored parameters. ``"bfloat16"`` stores raw
    leaves, as in the reference."""
    cfg = tdep.EdgeConfig(quantization=quant)
    path = tdep.EdgeDeploymentManager(tmp_path / "port").package(pair["tm"], None, CFG, cfg)
    jpath = jdep.EdgeDeploymentManager(tmp_path / "jax").package(
        pair["jm"], pair["params"], CFG, jdep.EdgeConfig(quantization=quant))
    (meta, arrays), (jmeta, jarrays) = _bundle(path), _bundle(jpath)
    assert meta["format"] == jmeta["format"] == "edge_npz_v2"
    assert meta["leaves"] == jmeta["leaves"] and meta["stats"] == jmeta["stats"]
    assert sorted(arrays) == sorted(jarrays)
    for k, a in arrays.items():
        assert a.dtype == jarrays[k].dtype and np.array_equal(a, jarrays[k]), k
    assert {v["kind"] for v in meta["leaves"].values()} == {
        "int8": {"int8", "raw"}, "bf16": {"bf16"}, "bfloat16": {"raw"}, "none": {"raw"}}[quant]
    assert (tmp_path / "port" / "manifest.json").exists()
    assert meta["edge_config"] == cfg.__dict__

    engine = tdep.EdgeDeploymentManager.load(path, device="cpu")
    res = engine.predict(pair["tg"])
    assert res["probabilities"].shape == (2, 2) and engine.mean_latency_s > 0
    stored = engine.model
    if quant == "bf16":      # the model holds the bf16-rounded parameters
        for k, v in pair["tm"].state_dict().items():
            assert torch.equal(stored.state_dict()[k], v.to(torch.bfloat16).float()), k
    with torch.inference_mode():
        run = int8_apply if quant == "int8" else (lambda m, *a, **k: m(*a, **k))
        want = run(stored, pair["tg"], mode="inference")["classification_logits"]
    np.testing.assert_allclose(res["probabilities"], torch.softmax(want, -1).numpy(),
                               atol=1e-6, rtol=0)
    if quant in ("bfloat16", "none"):
        for k, v in pair["tm"].state_dict().items():
            assert torch.equal(stored.state_dict()[k], v), k


def test_jax_int8_bundle_predicts_in_the_port_as_in_jax(pair, tmp_path):
    path = jdep.EdgeDeploymentManager(tmp_path).package(
        pair["jm"], pair["params"], CFG, jdep.EdgeConfig(quantization="int8"))
    with jax.default_matmul_precision("float32"):
        ref = jdep.EdgeDeploymentManager.load(path).predict(pair["g"])
    res = tdep.EdgeDeploymentManager.load(path, device="cpu").predict(pair["tg"])
    for key in ("probabilities", "graph_embedding"):
        np.testing.assert_allclose(res[key], ref[key], atol=1e-4, rtol=0, err_msg=key)
    assert np.array_equal(res["predicted_class"], ref["predicted_class"])


def test_port_int8_bundle_loads_in_jax(pair, tmp_path):
    path = tdep.EdgeDeploymentManager(tmp_path).package(
        pair["tm"], pair["tm"].state_dict(), CFG, tdep.EdgeConfig(quantization="int8"))
    engine = jdep.EdgeDeploymentManager.load(path)
    assert engine.config.quantization == "int8"
    with jax.default_matmul_precision("float32"):
        ref = engine.predict(pair["g"])
    res = tdep.EdgeDeploymentManager.load(path, device="cpu").predict(pair["tg"])
    np.testing.assert_allclose(res["probabilities"], ref["probabilities"], atol=1e-4, rtol=0)


def test_moe_bundle_round_trips_and_predicts_as_in_jax(tmp_path):
    """The reference's MoE case (2 experts, ``"bfloat16"``: raw leaves)."""
    moe = _setup(MOE_CFG)
    path = tdep.EdgeDeploymentManager(tmp_path).package(
        moe["tm"], None, MOE_CFG, tdep.EdgeConfig(quantization="bfloat16"))
    res = tdep.EdgeDeploymentManager.load(path, device="cpu").predict(moe["tg"])
    with jax.default_matmul_precision("float32"):
        ref = jdep.EdgeDeploymentManager.load(path).predict(moe["g"])
    assert res["probabilities"].shape == (2, 2) and np.isfinite(res["probabilities"]).all()
    np.testing.assert_allclose(res["probabilities"], ref["probabilities"], atol=1e-4, rtol=0)


@pytest.mark.parametrize("quant", ["int8", "bf16", "none"])
def test_optimizer_compresses_as_the_jax_optimizer(pair, quant):
    packed = tdep.EdgeModelOptimizer(tdep.EdgeConfig(quantization=quant)).optimize(
        pair["tm"].state_dict())
    jpacked = jdep.EdgeModelOptimizer(jdep.EdgeConfig(quantization=quant)).optimize(
        pair["params"])
    assert packed["format"] == jpacked["format"] == quant
    assert packed["stats"] == jpacked["stats"]
    restored = tdep.EdgeModelOptimizer.restore(packed)
    want = params_from_flax(_flat(jdep.EdgeModelOptimizer.restore(jpacked)))
    for k, v in want.items():
        assert torch.equal(restored[k].float(), v), k
    if quant == "int8":
        assert sorted(packed["data"]["scales"]) == sorted(jpacked["data"]["scales"])


@pytest.mark.parametrize("quant", ["int8", "bf16"])
def test_bf16_parameter_bundle_quantizes_its_leaves(pair, tmp_path, quant):
    """A ``param_dtype: bfloat16`` model's bundle stores what the bundle of
    an f32 model holding the same values stores: int8 leaves with the same
    scales (compression 2.0 against the bf16 bytes) or the same bf16 bits.
    The JAX package stores such leaves raw (their numpy kind is not "f").
    Its engine's probabilities against the bf16 model's own: int8 within
    1e-2 (reading 2.5e-3, the int8 rounding), bf16 within 1e-6 (6e-8)."""
    cfg16 = {**CFG, "param_dtype": "bfloat16"}
    state = {k: v.to(torch.bfloat16) for k, v in pair["tm"].state_dict().items()}
    tm16, twin = DGDMModel(**cfg16).eval(), DGDMModel(**CFG).eval()
    tm16.load_state_dict(state)
    twin.load_state_dict({k: v.float() for k, v in state.items()})
    config = tdep.EdgeConfig(quantization=quant)
    path = tdep.EdgeDeploymentManager(tmp_path / "bf16").package(tm16, None, cfg16, config)
    twin_path = tdep.EdgeDeploymentManager(tmp_path / "f32").package(twin, None, CFG, config)
    (meta, arrays), (twin_meta, twin_arrays) = _bundle(path), _bundle(twin_path)
    assert meta["leaves"] == twin_meta["leaves"]
    kinds = {info["kind"] for info in meta["leaves"].values()}
    assert kinds == ({"int8", "raw"} if quant == "int8" else {"bf16"})
    for name, info in meta["leaves"].items():
        if info["kind"] != "raw":
            key = "p:" + name
            assert np.array_equal(arrays[key], twin_arrays[key]), name
    assert meta["stats"]["compression"] > (1.99 if quant == "int8" else 0.99)
    res = tdep.EdgeDeploymentManager.load(path, device="cpu").predict(pair["tg"])
    with torch.no_grad():
        own = torch.softmax(tm16(pair["tg"], mode="inference")["classification_logits"].float(),
                            -1).numpy()
    np.testing.assert_allclose(res["probabilities"], own, rtol=0,
                               atol=1e-2 if quant == "int8" else 1e-6)


def test_pickle_bundles_are_refused(tmp_path):
    for load in (tdep.EdgeDeploymentManager.load, jdep.EdgeDeploymentManager.load):
        with pytest.raises(ValueError, match="pickle"):
            load(tmp_path / "edge_model.pkl")


def test_stablehlo_export_raises_naming_its_item(tmp_path):
    """Once a raise check (the export had no PyTorch form); now the export
    works: a narrow DGDM of 2 graph layers, exported on the CPU, saved,
    loaded and run, gives the eager forward's outputs to the bit, and its
    graph holds one ``dgdm.gather_rows`` and two ``dgdm.weighted_gather_sum``
    a graph layer. (The U-Net's 5 layers take the export past 10 s here;
    ``chip_smoke.py`` phase 21 exports DGDM-Base with them.) The flag is
    stored, not read, as in the JAX package."""
    from collections import Counter

    from dgdm_histopath_torch.nn.layers import init_parameters
    from dgdm_histopath_torch.ops import kernels

    assert tdep.EdgeConfig(export_stablehlo=True).export_stablehlo is True
    model = init_parameters(DGDMModel(node_features=16, hidden_dims=(16, 16), graph_layers=2,
                                      attention_heads=4, num_classes=2, use_hierarchical=False,
                                      compute_dtype="float32"),
                            torch.Generator().manual_seed(0)).eval()
    g = j_batch([make_synthetic_graph(seed=i, n_nodes=32, n_real=25, feat_dim=16)
                 for i in range(2)])
    graph = PaddedGraph(**{f: torch.from_numpy(np.array(getattr(g, f))) for f in FIELDS})
    path = tdep.EdgeModelOptimizer.export_stablehlo(model, (graph,), tmp_path / "dgdm.pt2")
    assert path == tmp_path / "dgdm.pt2"
    program = torch.export.load(path)
    ops = Counter(str(n.target) for n in program.graph.nodes if n.op == "call_function")
    assert ops["dgdm.gather_rows.default"] == 2 and ops["dgdm.weighted_gather_sum.default"] == 4
    kernels.reset_launch_counts()
    with torch.no_grad():
        got, want = program.module()(graph), model(graph)
    assert kernels.launch_counts()["gather_rows"] == 0          # the CPU runs the plain versions
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_resource_monitor_reports_as_the_jax_monitor():
    ours, theirs = tdep.EdgeResourceMonitor(), jdep.EdgeResourceMonitor()
    assert ours.report() == theirs.report() == {}
    s, t = ours.sample(), theirs.sample()
    assert set(s) == set(t) and 0.0 <= s["host_mem_used_frac"] <= 1.0
    assert set(ours.report()) == set(theirs.report()) and ours.report()["samples"] == 1
