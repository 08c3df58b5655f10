"""The port's CUDA kernels and its card path, on a CUDA device.

Every test here is marked ``cuda`` and skips without a card. The file
imports neither JAX nor the JAX package, so it also runs on a machine that
has only PyTorch:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerances: gather_rows is a copy (bit-equal); gather_agg sums K f32 terms
in another order than the plain version (1e-5); the f32 model on the card
against the same model on the CPU differs by f32 rounding (1e-4).
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
    weighted_gather_sum_plain,
)
from dgdm_histopath_torch.ops.kernels.gather_rows import gather_rows, gather_rows_plain

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


def _small_pair(device):
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
                       hidden_dims=(64, 32), graph_layers=2, compute_dtype="float32")
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
    assert kernels.launch_counts() == {"gather_rows": 7, "gather_agg": 14}  # 2 + 5 layers


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
