"""The port's CUDA kernels and its card path, on a CUDA device.

Every test here is marked ``cuda`` and skips without a card. The file
imports neither JAX nor the JAX package, so it also runs on a machine that
has only PyTorch:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerances: gather_rows is a copy (bit-equal); gather_agg sums K f32 terms
in another order than the plain version (1e-5); the two backward kernels sum
with f32 atomic adds in no fixed order (1e-5 in f32; in bf16 one ulp of the
plain result, which rounds the same f32 sums once); the f32 model on the
card against the same model on the CPU differs by f32 rounding (1e-4), and
its training step's gradients by 1e-3 of each tensor's largest entry.
"""

import copy

import numpy as np
import pytest
import torch

from dgdm_histopath_torch.models.presets import create_model
from dgdm_histopath_torch.ops import kernels
from dgdm_histopath_torch.ops.graph import batch_graphs, build_padded_graph
from dgdm_histopath_torch.ops.kernels.gather_agg import (
    weighted_gather_sum,
    weighted_gather_sum_bwd,
    weighted_gather_sum_bwd_plain,
    weighted_gather_sum_plain,
)
from dgdm_histopath_torch.ops.kernels.gather_rows import (
    gather_rows,
    gather_rows_bwd,
    gather_rows_plain,
    scatter_add_rows,
)
from dgdm_histopath_torch.training import DGDMTrainer, TrainerConfig

SHAPES = [(32, 1024, 8, 128), (3, 100, 5, 24), (2, 37, 40, 5)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _data(device, b, n, k, f, dtype, seed=0):
    """idx spans [-2, n+2): out-of-range indices must give zero rows."""
    g = torch.Generator(device=device).manual_seed(seed)
    src = torch.randn(b, n, f, device=device, generator=g).to(dtype)
    idx = torch.randint(-2, n + 2, (b, n, k), device=device, generator=g, dtype=torch.int32)
    w = torch.rand(b, n, k, device=device, generator=g)
    return src, idx, w


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_gather_rows_kernel_bit_equal_on_card(cuda_device, dtype, shape):
    src, idx, _ = _data(cuda_device, *shape, dtype)
    count = kernels.GATHER_ROWS.launches
    out = gather_rows(src, idx)
    torch.cuda.synchronize()
    assert kernels.GATHER_ROWS.launches == count + 1
    assert torch.equal(out, gather_rows_plain(src, idx))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_gather_agg_kernel_matches_plain_on_card(cuda_device, dtype, shape):
    src, idx, w = _data(cuda_device, *shape, dtype)
    count = kernels.GATHER_AGG.launches
    out = weighted_gather_sum(src, idx, w)
    torch.cuda.synchronize()
    assert kernels.GATHER_AGG.launches == count + 1
    torch.testing.assert_close(out, weighted_gather_sum_plain(src, idx, w),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
def test_kernels_refuse_non_contiguous_input_on_card(cuda_device):
    src, idx, w = _data(cuda_device, 2, 16, 4, 8, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        gather_rows(src.transpose(1, 2).contiguous().transpose(1, 2), idx)
    with pytest.raises(ValueError, match="contiguous"):
        weighted_gather_sum(src, idx, w.transpose(1, 2).contiguous().transpose(1, 2))


def _assert_scatter_close(out, ref32):
    """f32: 1e-5. bf16: one bf16 ulp of the rounded plain sums (+1e-5 near 0)."""
    if out.dtype == torch.float32:
        torch.testing.assert_close(out, ref32, atol=1e-5, rtol=1e-5)
        return
    ref = ref32.to(out.dtype).float()
    ulp = torch.ldexp(torch.ones_like(ref), torch.frexp(ref).exponent - 8)
    assert ((out.float() - ref).abs() <= ulp + 1e-5).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_gather_rows_bwd_kernel_matches_plain_on_card(cuda_device, dtype, shape):
    _, idx, _ = _data(cuda_device, *shape, dtype)
    b, n, k, f = shape
    g = torch.randn(b, n, k, f, device=cuda_device).to(dtype)
    count = kernels.GATHER_ROWS_BWD.launches
    out = gather_rows_bwd(idx, g)
    torch.cuda.synchronize()
    assert kernels.GATHER_ROWS_BWD.launches == count + 1
    assert out.dtype == dtype and out.shape == (b, n, f)
    _assert_scatter_close(out, scatter_add_rows(idx, g, n))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_gather_agg_bwd_kernel_matches_plain_on_card(cuda_device, dtype, shape):
    h, idx, w = _data(cuda_device, *shape, dtype)
    g = torch.randn(h.shape, device=cuda_device)
    count = kernels.GATHER_AGG_BWD.launches
    dh, dw = weighted_gather_sum_bwd(g, h, idx, w)
    torch.cuda.synchronize()
    assert kernels.GATHER_AGG_BWD.launches == count + 1
    assert dh.dtype == dtype and dw.dtype == torch.float32
    _assert_scatter_close(dh, scatter_add_rows(idx, w[..., None] * g[:, :, None, :],
                                               h.shape[1]))
    torch.testing.assert_close(dw, weighted_gather_sum_bwd_plain(g, h, idx, w)[1],
                               atol=1e-5, rtol=1e-5)
    only_dh, no_dw = weighted_gather_sum_bwd(g, h, idx, w, need_dw=False)
    no_dh, only_dw = weighted_gather_sum_bwd(g, h, idx, w, need_dh=False)
    assert no_dw is None and no_dh is None and torch.equal(only_dw, dw)
    _assert_scatter_close(only_dh, scatter_add_rows(
        idx, w[..., None] * g[:, :, None, :], h.shape[1]))


@pytest.mark.cuda
def test_autograd_through_the_wrappers_runs_the_backward_kernels_on_card(cuda_device):
    """f32, against autograd through the plain forwards; the cotangent of
    gather_rows is handed over strided and expanded."""
    src, idx, w = _data(cuda_device, 3, 100, 5, 24, torch.float32)
    src.requires_grad_()
    w.requires_grad_()
    g4 = torch.randn(3, 100, 1, 24, device=cuda_device).expand(3, 100, 5, 24)
    g3 = torch.randn(3, 100, 24, device=cuda_device)
    kernels.reset_launch_counts()
    (d_rows,) = torch.autograd.grad(gather_rows(src, idx), src, g4)
    d_h, d_w = torch.autograd.grad(weighted_gather_sum(src, idx, w), (src, w), g3)
    (only_w,) = torch.autograd.grad(weighted_gather_sum(src.detach(), idx, w), w, g3)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {"gather_rows": 1, "gather_agg": 2,
                                       "gather_rows_bwd": 1, "gather_agg_bwd": 2}
    (p_rows,) = torch.autograd.grad(gather_rows_plain(src, idx), src, g4)
    p_h, p_w = torch.autograd.grad(weighted_gather_sum_plain(src, idx, w), (src, w), g3)
    for got, want in ((d_rows, p_rows), (d_h, p_h), (d_w, p_w), (only_w, p_w)):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def _small_pair(device, **overrides):
    """A small f32 model on the CPU, its copy on the card, and 2 graphs."""
    rs = np.random.RandomState(0)
    graphs = []
    for _ in range(2):
        n, k = 90, 6
        pos = rs.rand(n, 2).astype(np.float32)
        d2 = ((pos[:, None] - pos[None]) ** 2).sum(-1)
        np.fill_diagonal(d2, np.inf)
        idx = np.argsort(d2, axis=1, kind="stable")[:, :k]
        dist = np.sqrt(np.take_along_axis(d2, idx, 1))
        attr = np.stack([dist, np.exp(-10 * dist), 0 * dist], -1)
        graphs.append(build_padded_graph(rs.randn(n, 32).astype(np.float32), pos, idx,
                                         attr, np.ones((n, k), bool), bucket=128))
    cpu = create_model("dgdm-base", num_classes=3, device="cpu", node_features=32,
                       hidden_dims=(64, 32), graph_layers=2, compute_dtype="float32",
                       **overrides)
    return cpu, copy.deepcopy(cpu).to(device), batch_graphs(graphs)


def _card_vs_cpu(card, cpu, batch, device):
    with torch.inference_mode():
        on_card = card(batch.to(device), return_attention=True)
        torch.cuda.synchronize()
        on_cpu = cpu(batch, return_attention=True)
    for key in ("classification_logits", "attention_weights", "graph_embedding"):
        torch.testing.assert_close(on_card[key].cpu(), on_cpu[key], atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_small_model_on_card_matches_cpu_and_launches_the_kernels(cuda_device):
    cpu, card, batch = _small_pair(cuda_device)
    kernels.reset_launch_counts()
    _card_vs_cpu(card, cpu, batch, cuda_device)
    assert kernels.launch_counts() == {"gather_rows": 7, "gather_agg": 14,   # 2 + 5 layers
                                       "gather_rows_bwd": 0, "gather_agg_bwd": 0}


@pytest.mark.cuda
def test_out_of_range_neighbor_indices_on_card_match_cpu(cuda_device):
    """Out-of-range nbr_idx reaches every gather of the forward (kernels,
    symmetric norm, pooling). No device-side assert: the card answers what
    the CPU answers, and the CUDA context stays usable."""
    cpu, card, batch = _small_pair(cuda_device)
    idx = batch.nbr_idx.clone()
    idx[0, 0, 0], idx[0, 5, 2], idx[1, 9, 1] = -3, batch.num_nodes, 10 ** 6
    _card_vs_cpu(card, cpu, batch.replace(nbr_idx=idx), cuda_device)
    assert torch.ones(4, device=cuda_device).sum().item() == 4.0


@pytest.mark.cuda
def test_training_step_on_card_matches_cpu_and_launches_all_four_kernels(cuda_device):
    """One f32 pretrain step (dropout 0) with the same injected draws."""
    cpu, card, batch = _small_pair(cuda_device, dropout=0.0)
    gen = torch.Generator().manual_seed(0)
    b, n = batch.node_mask.shape
    draws = {"masked": (torch.rand(b, n, generator=gen) < 0.15) & batch.node_mask,
             "t": torch.randint(0, 10, (b,), generator=gen),
             "noise": torch.randn(b, n, 32, generator=gen),
             "uniform": torch.rand(b, n, generator=gen)}
    out = {}
    for device, model in (("cpu", cpu), (cuda_device, card)):
        trainer = DGDMTrainer(model, TrainerConfig(warmup_steps=0, learning_rate=1e-3),
                              device=device)
        trainer.init_state(0)
        kernels.reset_launch_counts()
        metrics = trainer.training_step(batch, 0, draws={k: v.to(device)
                                                         for k, v in draws.items()})
        out[str(device)] = (metrics, kernels.launch_counts(),
                            {k: p.grad.cpu() for k, p in model.named_parameters()},
                            {k: p.detach().cpu() for k, p in model.named_parameters()})
    (m_cpu, c_cpu, g_cpu, p_cpu), (m_card, c_card, g_card, p_card) = out["cpu"], out["cuda"]
    assert c_cpu == dict.fromkeys(c_cpu, 0)
    assert c_card == {"gather_rows": 7, "gather_agg": 14,
                      "gather_rows_bwd": 7, "gather_agg_bwd": 14}
    assert abs(m_cpu["loss"] - m_card["loss"]) <= 1e-4
    floor = 1e-3 * max(float(g.abs().max()) for g in g_cpu.values())
    for key, ref in g_cpu.items():
        scale = max(float(ref.abs().max()), floor)
        assert float((g_card[key] - ref).abs().max()) <= 1e-3 * scale, key
