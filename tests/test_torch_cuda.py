"""The port's CUDA kernels and its card path, on a CUDA device.

Every test here is marked ``cuda`` and skips without a card. The file
imports neither JAX nor the JAX package, so it also runs on a machine that
has only PyTorch:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerances: gather_rows is a copy (bit-equal); gather_agg sums K f32 terms
in another order than the plain version (1e-5), also over a table of
another row count than its indices (the halo tier); a training step with
``use_remat`` recomputes the same kernels on the same inputs (1e-6 of each
gradient tensor's largest entry against the plain step); the transposed neighbor
list is fixed by idx (bit-equal); the two backward kernels sum each row in
f32 in a fixed order of their own, other than the plain version's (1e-5 in
f32; in bf16 and f16 one ulp of the plain result, which rounds the same f32
sums once), and give bit-identical results from call to call; every kernel
test runs in f32, bf16 and f16 (the flash kernels' f16 split of p is
within one f16 ulp of each element beside the 1e-4 limit); the f32 model on the
card against the same model on the CPU differs by f32 rounding (1e-4), and
its training step's gradients by 1e-3 of each tensor's largest entry. The
slide path on the card against the CPU: kNN neighbour lists equal slot for
slot (edge features 1e-5), Macenko stain matrices 1e-4 and pixels 5e-3 on
the 0-255 scale, the tissue mask within 0.05% of its pixels, the f32 ViT-B
featurizer within 1e-3 of its largest feature, predict_slide's probabilities
within 1e-4. The MoE model on the card against the CPU: logits 1e-4, the
aux loss 1e-5, expert assignments equal. A /predict answered through the dynamic batcher on the card
equals ``predict_batch`` of the padded batch it rode in to the bit. int8:
``torch._int_mm`` on the card (its operands padded to >16 rows and K, N
multiples of 8) equals the exact f64 sums, and so does ``int8_dense``'s
int32 product; its int8 activations and weights equal the CPU's; the int8
model launches the float model's kernels, its logits within 1e-3 of the CPU's
int8 logits (an activation an ulp apart can quantize a step apart).
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
    gather_rows_bwd_plain,
    gather_rows_plain,
)
from dgdm_histopath_torch.ops.kernels.neighbor_transpose import (
    neighbor_transpose,
    neighbor_transpose_plain,
)
from dgdm_histopath_torch.training import DGDMTrainer, TrainerConfig

SHAPES = [(32, 1024, 8, 128), (3, 100, 5, 24), (2, 37, 40, 5)]
# the backward kernels at the DGDM-Base levels, the DGDM-Large levels and
# the ragged shapes; "hub" sends half the slots to node 0, as pooling does
BWD_SHAPES = [(32, 1024, 8, 128), (32, 512, 8, 128), (32, 256, 8, 128),
              (4, 2048, 8, 128), (4, 1024, 8, 128), (4, 512, 8, 128),
              (3, 100, 5, 24), (2, 37, 40, 5)]
NO_FLASH = {"flash_spatial_packed": 0, "flash_spatial": 0}   # no model path launches them
# gather_agg: K = 8 compiled apart for 16-byte lanes, any other K (and every K
# on one-element lanes, F = 5 here) in chunks of 8 (33 crosses four chunks);
# F 24 takes a group of 4 lanes, 128 and 256 one of 16 or 32 (bf16)
AGG_SHAPES = SHAPES + [(3, 200, k, f) for k in (5, 8, 16, 33) for f in (24, 128, 256)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _data(device, b, n, k, f, dtype, seed=0, hub=False):
    """idx spans [-2, n+2): out-of-range indices must give zero rows. With
    ``hub`` half the slots point at node 0."""
    g = torch.Generator(device=device).manual_seed(seed)
    src = torch.randn(b, n, f, device=device, generator=g).to(dtype)
    idx = torch.randint(-2, n + 2, (b, n, k), device=device, generator=g, dtype=torch.int32)
    if hub:
        idx[torch.rand(b, n, k, device=device, generator=g) < 0.5] = 0
    w = torch.rand(b, n, k, device=device, generator=g)
    return src, idx, w


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape", SHAPES)
def test_gather_rows_kernel_bit_equal_on_card(cuda_device, dtype, shape):
    src, idx, _ = _data(cuda_device, *shape, dtype)
    count = kernels.GATHER_ROWS.launches
    out = gather_rows(src, idx)
    torch.cuda.synchronize()
    assert kernels.GATHER_ROWS.launches == count + 1
    assert torch.equal(out, gather_rows_plain(src, idx))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape", AGG_SHAPES)
def test_gather_agg_kernel_matches_plain_on_card(cuda_device, dtype, shape):
    """Indices -2 .. N+1 and N + 3 at some slots: out of range adds nothing."""
    src, idx, w = _data(cuda_device, *shape, dtype)
    idx[:, ::7, 0] = shape[1] + 3
    idx[:, 1::7, -1] = -1
    count = kernels.GATHER_AGG.launches
    out = weighted_gather_sum(src, idx, w)
    torch.cuda.synchronize()
    assert kernels.GATHER_AGG.launches == count + 1
    torch.testing.assert_close(out, weighted_gather_sum_plain(src, idx, w),
                               atol=1e-5, rtol=1e-5)
    ok = (idx >= 0) & (idx < shape[1])
    torch.testing.assert_close(out, weighted_gather_sum_plain(src, idx.clamp(0, shape[1] - 1),
                                                              w * ok), atol=1e-5, rtol=1e-5)


# rectangular tables (the halo tier): (B, N query rows, K, F, N_src table rows)
RECT_SHAPES = [(32, 512, 8, 128, 620), (32, 2, 57, 128, 512), (3, 100, 5, 24, 37),
               (2, 37, 40, 1, 300)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape", RECT_SHAPES)
def test_rectangular_gathers_match_plain_on_card(cuda_device, dtype, shape):
    """A table of N_src rows read by N rows of K slots (indices -2 ..
    N_src + 1): gather_rows bit-equal to its plain version, gather_agg
    within 1e-5, one launch each; the backward of either raises (the halo
    tier is forward only)."""
    b, n, k, f, n_src = shape
    g = torch.Generator(device=cuda_device).manual_seed(3)
    src = torch.randn(b, n_src, f, device=cuda_device, generator=g).to(dtype)
    idx = torch.randint(-2, n_src + 2, (b, n, k), device=cuda_device, generator=g,
                        dtype=torch.int32)
    w = torch.rand(b, n, k, device=cuda_device, generator=g)
    rows, agg = kernels.GATHER_ROWS.launches, kernels.GATHER_AGG.launches
    out = gather_rows(src, idx)
    summed = weighted_gather_sum(src, idx, w)
    torch.cuda.synchronize()
    assert (kernels.GATHER_ROWS.launches, kernels.GATHER_AGG.launches) == (rows + 1, agg + 1)
    assert out.shape == (b, n, k, f) and torch.equal(out, gather_rows_plain(src, idx))
    torch.testing.assert_close(summed, weighted_gather_sum_plain(src, idx, w),
                               atol=1e-5, rtol=1e-5)
    leaf = src.float().requires_grad_()
    with pytest.raises(RuntimeError, match="forward only"):
        gather_rows(leaf.to(dtype), idx).sum().backward()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("k", [5, 8])
def test_gather_agg_kernel_takes_inputs_that_are_not_16_byte_aligned_on_card(cuda_device,
                                                                            dtype, k):
    """h, idx and w that start one element into their storage take the
    one-element path and the any-K path; the sums are those of the aligned
    call and of the plain version."""
    b, n, f = 3, 200, 128
    src, idx, w = _data(cuda_device, b, n, k, f, dtype)

    def shifted(t):
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda_device)
        flat[1:] = t.reshape(-1)
        return flat[1:].view(t.shape)

    s2, i2, w2 = shifted(src), shifted(idx), shifted(w)
    assert s2.data_ptr() % 16 and i2.data_ptr() % 16 and w2.data_ptr() % 16
    out = weighted_gather_sum(s2, i2, w2)
    torch.testing.assert_close(out, weighted_gather_sum(src, idx, w), atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(out, weighted_gather_sum_plain(src, idx, w), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.cuda
def test_kernels_refuse_non_contiguous_input_on_card(cuda_device):
    src, idx, w = _data(cuda_device, 2, 16, 4, 8, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        gather_rows(src.transpose(1, 2).contiguous().transpose(1, 2), idx)
    with pytest.raises(ValueError, match="contiguous"):
        weighted_gather_sum(src, idx, w.transpose(1, 2).contiguous().transpose(1, 2))


# significant bits of each half type: its ulp of x is 2^(exponent(x) - bits)
HALF_BITS = {torch.bfloat16: 8, torch.float16: 11}


def _ulp(x, dtype):
    return torch.ldexp(torch.ones_like(x), torch.frexp(x).exponent - HALF_BITS[dtype])


def _assert_scatter_close(out, ref32):
    """f32: 1e-5. bf16 / f16: one ulp of the rounded plain sums (+1e-5 near 0)."""
    if out.dtype == torch.float32:
        torch.testing.assert_close(out, ref32, atol=1e-5, rtol=1e-5)
        return
    ref = ref32.to(out.dtype).float()
    assert ((out.float() - ref).abs() <= _ulp(ref, out.dtype) + 1e-5).all()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(32, 1024, 8), (4, 2048, 8), (3, 100, 5), (2, 37, 40),
                                   (2, 3000, 8), (2, 5, 0)])
@pytest.mark.parametrize("hub", [False, True])
def test_neighbor_transpose_kernel_bit_equal_on_card(cuda_device, shape, hub):
    """N = 3000 keeps its counters in global scratch, the rest in shared memory."""
    _, idx, _ = _data(cuda_device, *shape, 4, torch.float32, hub=hub)
    count = kernels.NEIGHBOR_TRANSPOSE.launches
    out = neighbor_transpose(idx)
    torch.cuda.synchronize()
    assert kernels.NEIGHBOR_TRANSPOSE.launches == count + 1
    ref = neighbor_transpose_plain(idx)
    assert torch.equal(out.offsets, ref.offsets) and torch.equal(out.slots, ref.slots)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape", BWD_SHAPES)
@pytest.mark.parametrize("hub", [False, True])
def test_gather_rows_bwd_kernel_matches_plain_on_card(cuda_device, dtype, shape, hub):
    _, idx, _ = _data(cuda_device, *shape, dtype, hub=hub)
    b, n, k, f = shape
    g = torch.randn(b, n, k, f, device=cuda_device).to(dtype)
    nbr_t = neighbor_transpose(idx)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    out = gather_rows_bwd(idx, g, nbr_t)
    again = gather_rows_bwd(idx, g, nbr_t)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {**dict.fromkeys(kernels.KERNELS, 0),
                                       "gather_rows_bwd": 2}     # one launch a call
    assert out.dtype == dtype and out.shape == (b, n, f)
    assert torch.equal(out, again)
    _assert_scatter_close(out, gather_rows_bwd_plain(idx, g.float()))
    assert torch.equal(gather_rows_bwd(idx, g), out)              # the list built inside


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape", BWD_SHAPES)
@pytest.mark.parametrize("hub", [False, True])
def test_gather_agg_bwd_kernel_matches_plain_on_card(cuda_device, dtype, shape, hub):
    h, idx, w = _data(cuda_device, *shape, dtype, hub=hub)
    g = torch.randn(h.shape, device=cuda_device)
    nbr_t = neighbor_transpose(idx)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    dh, dw = weighted_gather_sum_bwd(g, h, idx, w, nbr_t=nbr_t)
    dh2, dw2 = weighted_gather_sum_bwd(g, h, idx, w, nbr_t=nbr_t)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {**dict.fromkeys(kernels.KERNELS, 0),
                                       "gather_agg_bwd": 2}      # one launch a call
    assert dh.dtype == dtype and dw.dtype == torch.float32
    assert torch.equal(dh, dh2) and torch.equal(dw, dw2)
    ref_dh, ref_dw = weighted_gather_sum_bwd_plain(g, h.float(), idx, w, nbr_t)
    _assert_scatter_close(dh, ref_dh)
    torch.testing.assert_close(dw, ref_dw, atol=1e-5, rtol=1e-5)
    only_dh, no_dw = weighted_gather_sum_bwd(g, h, idx, w, need_dw=False)
    no_dh, only_dw = weighted_gather_sum_bwd(g, h, idx, w, need_dh=False)
    assert no_dw is None and no_dh is None
    assert torch.equal(only_dw, dw) and torch.equal(only_dh, dh)


@pytest.mark.cuda
def test_backward_kernels_take_rows_that_are_not_16_byte_aligned_on_card(cuda_device):
    """A cotangent that starts 4 bytes into its storage takes the one-feature
    path; the sums are those of the aligned call."""
    _, idx, w = _data(cuda_device, 2, 64, 8, 128, torch.float32)
    h = torch.randn(2, 64, 128, device=cuda_device)
    g4 = torch.randn(2 * 64 * 8 * 128 + 1, device=cuda_device)[1:].view(2, 64, 8, 128)
    g3 = torch.randn(2 * 64 * 128 + 1, device=cuda_device)[1:].view(2, 64, 128)
    assert g4.data_ptr() % 16 and g3.data_ptr() % 16 and g4.is_contiguous()
    _assert_scatter_close(gather_rows_bwd(idx, g4), gather_rows_bwd(idx, g4.clone()))
    dh, dw = weighted_gather_sum_bwd(g3, h, idx, w)
    ref_dh, ref_dw = weighted_gather_sum_bwd(g3.clone(), h, idx, w)
    _assert_scatter_close(dh, ref_dh)
    torch.testing.assert_close(dw, ref_dw, atol=1e-5, rtol=1e-5)


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
    # the gathers called alone build their transposed lists in their
    # backwards: one for gather_rows, one for the dh half of gather_agg (the
    # dw-only backward needs none)
    assert kernels.launch_counts() == {"gather_rows": 1, "gather_agg": 2,
                                       "gather_rows_bwd": 1, "gather_agg_bwd": 2,
                                       "neighbor_transpose": 2, **NO_FLASH}
    (p_rows,) = torch.autograd.grad(gather_rows_plain(src, idx), src, g4)
    p_h, p_w = torch.autograd.grad(weighted_gather_sum_plain(src, idx, w), (src, w), g3)
    for got, want in ((d_rows, p_rows), (d_h, p_h), (d_w, p_w), (only_w, p_w)):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def _small_pair(device, features=32, **overrides):
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
        graphs.append(build_padded_graph(rs.randn(n, features).astype(np.float32), pos, idx,
                                         attr, np.ones((n, k), bool), bucket=128))
    kw = dict(node_features=features, hidden_dims=(64, 32), graph_layers=2,
              compute_dtype="float32")
    cpu = create_model("dgdm-base", num_classes=3, device="cpu", **{**kw, **overrides})
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
                                       "gather_rows_bwd": 0, "gather_agg_bwd": 0,
                                       "neighbor_transpose": 0, **NO_FLASH}


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
    assert c_card == {"gather_rows": 7, "gather_agg": 14,      # one list per U-Net level
                      "gather_rows_bwd": 7, "gather_agg_bwd": 14, "neighbor_transpose": 3,
                      **NO_FLASH}
    assert abs(m_cpu["loss"] - m_card["loss"]) <= 1e-4
    floor = 1e-3 * max(float(g.abs().max()) for g in g_cpu.values())
    for key, ref in g_cpu.items():
        scale = max(float(ref.abs().max()), floor)
        assert float((g_card[key] - ref).abs().max()) <= 1e-3 * scale, key


@pytest.mark.cuda
def test_remat_training_step_on_card_matches_the_plain_step(cuda_device):
    """A small DGDM-Base (4 graph-encoder layers + 5 U-Net layers, dropout
    0.1) trained one step with and without ``use_remat`` from one seed: equal
    losses, gradients within 1e-6 of each tensor's largest entry, the same
    generator state after the step; the recompute runs the 4 checkpointed
    layers' gathers again (13 / 26 against 9 / 18) and builds no list."""
    _, _, batch = _small_pair(cuda_device)
    batch = batch.to(cuda_device)
    out = {}
    for remat in (False, True):
        model = create_model("dgdm-base", num_classes=3, device=cuda_device,
                             node_features=32, hidden_dims=(64, 32), graph_layers=4,
                             compute_dtype="float32", dropout=0.1, use_remat=remat)
        trainer = DGDMTrainer(model, TrainerConfig(warmup_steps=0, learning_rate=1e-3),
                              device=cuda_device)
        trainer.init_state(0)
        kernels.reset_launch_counts()
        metrics = trainer.training_step(batch, 0)
        torch.cuda.synchronize()
        out[remat] = (metrics, kernels.launch_counts(), trainer.generator.get_state(),
                      {k: p.grad.clone() for k, p in model.named_parameters()
                       if p.grad is not None})
    (m_off, c_off, s_off, g_off), (m_on, c_on, s_on, g_on) = out[False], out[True]
    assert c_off == {"gather_rows": 9, "gather_agg": 18, "gather_rows_bwd": 9,
                     "gather_agg_bwd": 18, "neighbor_transpose": 3, **NO_FLASH}
    assert c_on == {**c_off, "gather_rows": 13, "gather_agg": 26}
    assert m_on["loss"] == pytest.approx(m_off["loss"], rel=0, abs=1e-6 * abs(m_off["loss"]))
    assert torch.equal(s_on, s_off)
    assert g_on.keys() == g_off.keys()
    for key, ref in g_off.items():
        assert float((g_on[key] - ref).abs().max()) <= 1e-6 * float(ref.abs().max()), key


# ---------------------------------------------------------------------------
# flash spatial attention: f32 results hold to 1e-4 on valid rows (the kernel
# sums in another order and takes exp through the fast intrinsic); bf16
# results to that plus one bf16 ulp of each element (kernel and plain version
# each round their f32 result once, so they part only where the two f32
# values straddle a rounding boundary)
# ---------------------------------------------------------------------------

FLASH_SHAPES = [   # (B, N, H, D), route
    ((2, 256, 8, 16), "packed"), ((2, 256, 16, 8), "packed"), ((1, 128, 2, 64), "packed"),
    ((1, 128, 1, 128), "packed"), ((1, 128, 32, 4), "packed"),
    ((2, 256, 4, 16), "headmajor"), ((1, 128, 2, 128), "headmajor"),
    ((2, 128, 4, 64), "headmajor"), ((1, 128, 3, 24), "headmajor"),
    ((1, 128, 2, 5), "headmajor"), ((1, 128, 1, 200), "headmajor"),
    ((2, 128, 8, 8), "headmajor"), ((2, 128, 16, 8), "packed"), ((2, 128, 8, 16), "packed"),
]


def _flash_inputs(device, shape, dtype, masked_from, seed=0):
    from dgdm_histopath_torch.ops.kernels import flash_spatial as fs
    b, n, h, d = shape
    g = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (torch.randn(b, n, h, d, device=device, generator=g).to(dtype)
               for _ in range(3))
    pos = torch.rand(b, n, 2, device=device, generator=g)
    mask = torch.ones(b, n, dtype=torch.bool, device=device)
    mask[:, masked_from:] = False
    return fs, q, k, v, pos, mask


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape,route", FLASH_SHAPES)
def test_flash_kernels_match_their_plain_versions_on_card(cuda_device, shape, route, dtype):
    fs, q, k, v, pos, mask = _flash_inputs(cuda_device, shape, dtype, shape[1] - 28)
    assert fs.flash_route(*shape[1:]) == route
    kernel = fs.KERNEL_PACKED if route == "packed" else fs.KERNEL_HEADMAJOR
    plain = fs.flash_spatial_packed_plain if route == "packed" else fs.flash_spatial_plain
    count = kernel.launches
    out = fs.flash_spatial_attention(q, k, v, pos, mask, tau=0.1)
    torch.cuda.synchronize()
    assert kernel.launches == count + 1
    ref = plain(q, k, v, pos, mask, 0.1)
    dense = fs.dense_reference(q, k, v, pos, mask, 0.1)
    valid = mask[:, :, None, None]
    assert out.dtype == dtype and out.shape == q.shape
    for want in (ref.float(), dense.float()):
        tol = torch.full_like(want, 1e-4)
        if dtype != torch.float32:
            tol = tol + _ulp(want, dtype)
        assert ((out.float() - want).abs() * valid <= tol).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape,route", [((2, 256, 8, 16), "packed"), ((2, 256, 16, 8), "packed"),
                                         ((2, 256, 4, 64), "headmajor")])
def test_flash_bf16_kernels_at_a_sharp_tau_on_card(cuda_device, shape, route, dtype):
    """tau = 1e-3: the tensor-core kernels (bf16 and f16) start the q.k
    accumulator from the bias in units of the unscaled product, largest at a
    small tau. Held to the reference's limit at this tau (5e-3) plus one ulp
    of each element in the dtype."""
    fs, q, k, v, pos, mask = _flash_inputs(cuda_device, shape, dtype, shape[1] - 28)
    assert fs.flash_route(*shape[1:]) == route
    kernel = fs.KERNEL_PACKED if route == "packed" else fs.KERNEL_HEADMAJOR
    plain = fs.flash_spatial_packed_plain if route == "packed" else fs.flash_spatial_plain
    count = kernel.launches
    out = fs.flash_spatial_attention(q, k, v, pos, mask, tau=1e-3)
    torch.cuda.synchronize()
    assert kernel.launches == count + 1
    want = plain(q, k, v, pos, mask, 1e-3).float()
    tol = 5e-3 + _ulp(want, dtype)
    assert ((out.float() - want).abs() * mask[:, :, None, None] <= tol).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape", [(2, 128, 8, 16), (2, 128, 16, 8), (2, 128, 4, 16),
                                   (2, 256, 4, 64)])
def test_flash_all_masked_graph_gives_zeros_on_card(cuda_device, shape, dtype):
    fs, q, k, v, pos, mask = _flash_inputs(cuda_device, shape, dtype, shape[1])
    mask[1] = False
    out = fs.flash_spatial_attention(q, k, v, pos, mask)
    torch.cuda.synchronize()
    assert (out[1] == 0).all() and torch.isfinite(out).all() and (out[0] != 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape", [(2, 256, 16, 8), (2, 256, 4, 16), (2, 256, 1, 200)])
def test_flash_masked_value_rows_change_no_valid_row_on_card(cuda_device, shape, dtype):
    """Key tiles past the last valid node are skipped whole; a masked key in
    a tile that has valid ones contributes exactly nothing."""
    fs, q, k, v, pos, mask = _flash_inputs(cuda_device, shape, dtype, 200)
    out = fs.flash_spatial_attention(q, k, v, pos, mask)
    v2 = v.clone()
    v2[:, 200:] = 99.0
    assert torch.equal(fs.flash_spatial_attention(q, k, v2, pos, mask)[:, :200], out[:, :200])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 128, 8, 16), (2, 128, 16, 8), (2, 128, 4, 16)])
def test_flash_gradients_are_the_dense_recompute_on_card(cuda_device, shape):
    fs, q, k, v, pos, mask = _flash_inputs(cuda_device, shape, torch.float32, 100)
    g = torch.randn(shape, device=cuda_device) * mask[:, :, None, None]
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(fs.flash_spatial_attention(*leaves, pos, mask), leaves, g)
    want = torch.autograd.grad(fs.dense_reference(*leaves, pos, mask, 0.1), leaves, g)
    for a, b in zip(got, want):
        assert torch.allclose(a, b, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("embed,heads,name", [(128, 8, "flash_spatial_packed"),
                                              (128, 16, "flash_spatial_packed"),
                                              (64, 4, "flash_spatial")])
def test_spatial_attention_use_flash_is_one_launch_and_the_dense_module_on_card(
        cuda_device, embed, heads, name):
    from dgdm_histopath_torch.nn.attention import SpatialAttention
    from dgdm_histopath_torch.nn.layers import init_parameters
    flash = init_parameters(SpatialAttention(embed, heads, use_flash=True),
                            torch.Generator().manual_seed(0)).to(cuda_device)
    dense = SpatialAttention(embed, heads).to(cuda_device)
    dense.load_state_dict(flash.state_dict())
    g = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn(2, 256, embed, device=cuda_device, generator=g)
    pos = torch.rand(2, 256, 2, device=cuda_device, generator=g)
    mask = torch.arange(256, device=cuda_device).expand(2, 256) < 200
    kernels.reset_launch_counts()
    out = flash(x, pos, mask)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {k: int(k == name) for k in kernels.KERNELS}
    assert torch.allclose(out, dense(x, pos, mask), atol=2e-4, rtol=2e-4)


@pytest.mark.cuda
def test_windowed_banded_model_on_card_matches_cpu(cuda_device):
    """A small dgdm-large (16 heads x 8, W = 128, N = 384) in f32: the card
    (kernels) against the CPU (plain versions), logits within 1e-4."""
    cpu_model = create_model("dgdm-large", num_classes=2, device="cpu", node_features=24,
                             hidden_dims=(48, 128), graph_layers=2, compute_dtype="float32")
    rs = np.random.RandomState(0)
    n_real, n, k = 350, 384, 6
    pos = np.sort(rs.rand(n_real, 2).astype(np.float32), axis=0)
    idx = np.clip(np.arange(n_real)[:, None] + rs.randint(-40, 40, (n_real, k)), 0, n_real - 1)
    g = build_padded_graph(rs.randn(n_real, 24), pos, idx, rs.rand(n_real, k, 3),
                           np.ones((n_real, k), bool), bucket=n)
    batch = batch_graphs([g, g])
    card_model = copy.deepcopy(cpu_model).to(cuda_device)
    with torch.inference_mode():
        ref = cpu_model(batch)["classification_logits"]
        out = card_model(batch.to(cuda_device))["classification_logits"].cpu()
    assert card_model.spatial_attention.route(n) == "window"
    assert torch.allclose(out, ref, atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# the slide path: gathers at K = 24, Macenko, kNN, the tissue mask, the
# featurizer and predict_slide, each on the card against the CPU
# ---------------------------------------------------------------------------

def _tissue_patches(n, size=256, seed=3):
    from dgdm_histopath_torch.preprocessing.synthetic import generate_tissue_image
    img, _ = generate_tissue_image(1024, 1024, seed=seed)
    return np.stack([img[(i // 4) * 256:(i // 4) * 256 + size, (i % 4) * 256:(i % 4) * 256 + size]
                     for i in range(n)])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_gather_kernels_at_the_slide_shape_on_card(cuda_device, dtype):
    """One slide's graph: B 1, N 1024, K 24 (8 spatial + 16 morphological
    neighbours), F 128: gather_agg takes its any-K path."""
    src, idx, w = _data(cuda_device, 1, 1024, 24, 128, dtype)
    assert torch.equal(gather_rows(src, idx), gather_rows_plain(src, idx))
    assert torch.allclose(weighted_gather_sum(src, idx, w),
                          weighted_gather_sum_plain(src, idx, w), atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
def test_macenko_on_card_matches_cpu(cuda_device):
    """Stain matrices within 1e-4 (cuSOLVER's eigenvector signs against
    LAPACK's), normalized pixels within 5e-3 on the 0-255 scale."""
    from dgdm_histopath_torch.preprocessing import stain_normalization as st
    p = torch.from_numpy(_tissue_patches(16))
    flat = p.reshape(16, -1, 3)[:, ::16]
    on_card = st.estimate_stain_matrix(flat.to(cuda_device)).cpu()
    assert torch.allclose(on_card, st.estimate_stain_matrix(flat), atol=1e-4, rtol=0)
    ref_s = torch.from_numpy(st.DEFAULT_STAIN_MATRIX)
    ref_c = torch.from_numpy(st.DEFAULT_MAX_CONCENTRATIONS)
    out = st.macenko_normalize_batch(p.to(cuda_device), ref_s.to(cuda_device),
                                     ref_c.to(cuda_device)).cpu()
    assert torch.allclose(out, st.macenko_normalize_batch(p, ref_s, ref_c), atol=5e-3, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("tf32", [False, True])
def test_knn_on_card_matches_cpu_slot_for_slot(cuda_device, tf32):
    """Lattice positions (exact ties) with the imageless features, and random
    768-d features: the same neighbour lists on both devices, whatever the
    global TF32 flag says."""
    from dgdm_histopath_torch.ops.knn import build_dual_knn
    gx, gy = np.meshgrid(np.arange(32), np.arange(32), indexing="ij")
    pos = ((np.stack([gx, gy], -1).reshape(-1, 2) * 256 + 128) / np.float32(8192)).astype(np.float32)
    mask = np.arange(1024) < 1000
    place = np.concatenate([pos, np.ones((1024, 1)), np.full((1024, 1), 0.5),
                            np.zeros((1024, 1))], 1).astype(np.float32)
    rand = np.random.RandomState(0).randn(1024, 768).astype(np.float32)
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        for feats in (place, rand):
            args = [torch.from_numpy(a) for a in (pos, feats, mask)]
            ref = build_dual_knn(*args)
            out = build_dual_knn(*[a.to(cuda_device) for a in args])
            for key in ("nbr_idx", "nbr_mask"):
                assert torch.equal(out[key].cpu(), ref[key]), key
            assert torch.allclose(out["edge_attr"].cpu(), ref["edge_attr"], atol=1e-5, rtol=0)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


@pytest.mark.cuda
def test_tissue_mask_on_card_matches_cpu(cuda_device):
    from dgdm_histopath_torch.preprocessing.synthetic import synthetic_slide
    from dgdm_histopath_torch.preprocessing.tissue_detection import compute_tissue_mask
    for seed in range(3):
        thumb = torch.from_numpy(synthetic_slide(2048, 2048, num_levels=3, seed=seed)[0]
                                 .get_thumbnail(512))
        out = compute_tissue_mask(thumb.to(cuda_device)).cpu()
        assert (out != compute_tissue_mask(thumb)).float().mean() <= 5e-4


@pytest.mark.cuda
def test_f32_featurizer_on_card_matches_cpu(cuda_device):
    """ViT-B/16 (the "dinov2" featurizer) in f32 with Macenko on the device,
    4 patches of 256 px: the card within 1e-3 of the largest feature."""
    from dgdm_histopath_torch.models.vit import PatchFeatureExtractor
    p = _tissue_patches(4)
    kw = dict(arch="dinov2", stain_normalize_on_device=True, dtype="float32", seed=0)
    out = PatchFeatureExtractor(device=cuda_device, **kw).extract(p)
    ref = PatchFeatureExtractor(device="cpu", **kw).extract(p)
    assert out.shape == (4, 768) and np.isfinite(out).all()
    assert np.abs(out - ref).max() <= 1e-3 * np.abs(ref).max()


@pytest.mark.cuda
def test_predict_slide_runs_on_the_card_by_default(cuda_device):
    from dgdm_histopath_torch.evaluation.predictor import DGDMPredictor
    from dgdm_histopath_torch.preprocessing.synthetic import synthetic_slide
    model = create_model("dgdm-small", num_classes=2, device="cpu", node_features=14,
                         hidden_dims=(32, 16), compute_dtype="float32")
    kw = dict(feature_extractor="stats", patch_size=32, max_patches=60, tissue_threshold=0.3,
              node_buckets=[64])
    card = DGDMPredictor(model=copy.deepcopy(model), **kw)
    assert card.device.type == "cuda" and card.graph_builder.device.type == "cuda"
    backend = synthetic_slide(512, 512, num_levels=3, seed=5)[0]
    kernels.reset_launch_counts()
    out = card.predict_slide(backend)
    counts = kernels.launch_counts()
    assert counts["gather_rows"] == 2 and counts["gather_agg"] == 4
    ref = DGDMPredictor(model=model, device="cpu", **kw).predict_slide(backend)
    assert out["num_patches"] == ref["num_patches"] == 60
    np.testing.assert_allclose(out["probabilities"], ref["probabilities"], atol=1e-4)


# ---------------------------------------------------------------------------
# training through fit and the CLI: checkpoints, preemption and resume, and
# bundles, on the card
# ---------------------------------------------------------------------------

SMALL_BASE = dict(node_features=24, hidden_dims=(48, 32), attention_heads=4, graph_layers=2,
                  num_diffusion_steps=3)


def _small_graphs(count, n_real=90, n=128, k=6, f=24, seed=0):
    rs = np.random.RandomState(seed)
    graphs = []
    for i in range(count):
        idx = rs.randint(0, n_real, (n_real, k))
        g = build_padded_graph(rs.randn(n_real, f), rs.rand(n_real, 2), idx,
                               rs.rand(n_real, k, 3), np.ones((n_real, k), bool), bucket=n)
        graphs.append(g.replace(y=torch.tensor(i % 2, dtype=torch.int32)))
    return graphs


def _card_trainer(device):
    model = create_model("dgdm-base", num_classes=2, device=device, seed=0, **SMALL_BASE)
    trainer = DGDMTrainer(model, TrainerConfig(learning_rate=1e-3, warmup_steps=1,
                                               pretrain_epochs=1, max_epochs=2), device=device)
    trainer.init_state(0)
    return trainer


@pytest.mark.cuda
def test_fit_preempted_and_resumed_is_bit_equal_on_card(cuda_device, tmp_path):
    """Two epochs of host batches through fit (pinned uploads on the side
    stream), against the same run stopped after its first step with an
    emergency checkpoint and resumed from it: parameters, AdamW state and
    step equal to the bit."""
    from dgdm_histopath_torch.training import CheckpointManager, PreemptionGuard

    batches = [batch_graphs(_small_graphs(4, seed=s)) for s in range(3)]
    ref = _card_trainer(cuda_device)
    ref.fit(batches, val_loader=batches[:1])

    stopped = _card_trainer(cuda_device)
    mgr = CheckpointManager(tmp_path / "ckpt")
    guard = PreemptionGuard(install=False)
    guard.trigger()
    result = stopped.fit(batches, val_loader=batches[:1], checkpoint_manager=mgr,
                         preemption_guard=guard)
    assert result["interrupted"] and result["resume"]["step_in_epoch"] == 1
    assert mgr.record_extra()["resume"] == result["resume"]

    resumed = _card_trainer(cuda_device)
    resumed.load_state_dict(mgr.restore())
    resumed.current_epoch = result["resume"]["epoch"]
    out = resumed.fit(batches, val_loader=batches[:1], checkpoint_manager=mgr,
                      start_step_in_epoch=result["resume"]["step_in_epoch"])
    assert out["interrupted"] is False and resumed.step == ref.step == 6
    for (name, a), b in zip(ref.model.state_dict().items(), resumed.model.state_dict().values()):
        assert torch.equal(a, b), name
    sa, sb = ref.optimizer.state_dict()["state"], resumed.optimizer.state_dict()["state"]
    for i in sa:
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa[i][key], sb[i][key]), (i, key)
    assert {k: v for k, v in out["history"][-1].items() if k != "epoch_time_s"} == {
        k: v for k, v in ref.history[-1].items() if k != "epoch_time_s"}
    assert mgr.all_steps() == [0, 1] and mgr.best_step in (0, 1)


@pytest.mark.cuda
def test_bundle_written_on_card_loads_on_the_cpu(cuda_device, tmp_path):
    """An f32 model trained a step on the card, saved as a bundle, loaded on
    the CPU: logits within 1e-3 of the card's."""
    from dgdm_histopath_torch.evaluation.predictor import load_model_checkpoint
    from dgdm_histopath_torch.training import save_model_bundle

    model = create_model("dgdm-base", num_classes=2, device=cuda_device, seed=1,
                         compute_dtype="float32", **SMALL_BASE)
    trainer = DGDMTrainer(model, TrainerConfig(warmup_steps=0, pretrain_epochs=1),
                          device=cuda_device)
    trainer.init_state(0)
    batch = batch_graphs(_small_graphs(3))
    trainer.training_step(batch, 0)
    config = {**SMALL_BASE, "hidden_dims": list(SMALL_BASE["hidden_dims"]), "dropout": 0.1,
              "num_classes": 2, "compute_dtype": "float32"}
    save_model_bundle(tmp_path / "model.npz", model, config)
    cpu_model, meta = load_model_checkpoint(tmp_path / "model.npz", device="cpu")
    assert meta["format"] == "named_paths_v2"
    with torch.inference_mode():
        on_card = model.eval()(batch.to(cuda_device))["classification_logits"].cpu()
        on_cpu = cpu_model(batch)["classification_logits"]
    torch.testing.assert_close(on_cpu, on_card, atol=1e-3, rtol=1e-3)


@pytest.mark.cuda
def test_train_cli_runs_on_the_card_by_default(cuda_device, tmp_path):
    """``cli.train.main`` without ``--device``: the steps launch the card's
    kernels, and the run writes its outputs. The package logger that
    ``setup_logging`` reconfigures is put back afterwards."""
    import json
    import logging

    from dgdm_histopath_torch.cli import train as train_cli
    from dgdm_histopath_torch.data.graph_io import save_graph

    for i, g in enumerate(_small_graphs(8)):
        save_graph(g, tmp_path / "data" / f"s{i}_graph.npz")
    (tmp_path / "cfg.json").write_text(json.dumps({
        "model": {**SMALL_BASE, "hidden_dims": list(SMALL_BASE["hidden_dims"])},
        "data": {"batch_size": 4, "train_split": 0.5, "val_split": 0.25, "test_split": 0.25},
        "training": {"max_epochs": 2, "pretrain_epochs": 1, "warmup_steps": 1},
        "logging": {"logger_type": "csv"}}))
    kernels.reset_launch_counts()
    pkg = logging.getLogger("dgdm_histopath_torch")
    saved = (pkg.level, pkg.propagate, list(pkg.handlers))
    try:
        rc = train_cli.main(["train", "--config", str(tmp_path / "cfg.json"), "--data-dir",
                             str(tmp_path / "data"), "--num-classes", "2", "--dataset-type",
                             "graph", "--output-dir", str(tmp_path / "out")])
    finally:
        pkg.setLevel(saved[0])
        pkg.propagate = saved[1]
        pkg.handlers[:] = saved[2]
    assert rc == 0 and (tmp_path / "out" / "final_model.npz").exists()
    assert kernels.GATHER_AGG_BWD.launches > 0


# ---------------------------------------------------------------------------
# serving on the card: dynamic batching and the health report
# ---------------------------------------------------------------------------

def _http(port, method, path, body=None):
    import http.client
    import json

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request(method, path, body=None if body is None else json.dumps(body))
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


@pytest.mark.cuda
def test_batched_predicts_on_card_equal_their_padded_batch(cuda_device):
    """Concurrent /predict through the dynamic batcher on the card: each
    answer equals, to the bit, ``predict_batch`` of the padded batch it rode
    in (a spy records the batches), and the batches are powers of two."""
    import threading

    from dgdm_histopath_torch.deployment import InferenceServer
    from dgdm_histopath_torch.deployment.serving import graph_to_json
    from dgdm_histopath_torch.evaluation.predictor import DGDMPredictor

    model = create_model("dgdm-base", num_classes=2, device="cuda", seed=0, **SMALL_BASE)
    predictor = DGDMPredictor(model=model)
    assert predictor.device.type == "cuda"
    graphs = _small_graphs(5)
    seen = []
    real = predictor.predict_batch

    def spy(batch):
        results = real(batch)
        seen.append((batch, results))
        return results

    predictor.predict_batch = spy
    server = InferenceServer(predictor, port=0, host="127.0.0.1", dynamic_batch=4,
                             batch_wait_ms=20, rate_limit_per_s=1e4)
    server.start(background=True)
    answers = [None] * 10
    try:
        def call(i):
            answers[i] = _http(server.port, "POST", "/predict",
                               {"graph": graph_to_json(graphs[i % 5])})

        threads = [threading.Thread(target=call, args=(i,)) for i in range(10)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        server.stop()
    assert all(len(b) in (1, 2, 4) for b, _ in seen)
    for i, (status, res) in enumerate(answers):
        assert status == 200
        x = graphs[i % 5].x
        rows = [r for b, rs in seen for g, r in zip(b, rs) if torch.equal(g.x, x)]
        assert any(np.array_equal(np.asarray(res["probabilities"], np.float32),
                                  r["probabilities"]) for r in rows)


@pytest.mark.cuda
def test_healthz_on_card_answers_200(cuda_device):
    from dgdm_histopath_torch.deployment import InferenceServer
    from dgdm_histopath_torch.evaluation.predictor import DGDMPredictor

    model = create_model("dgdm-base", num_classes=2, device="cuda", seed=0, **SMALL_BASE)
    server = InferenceServer(DGDMPredictor(model=model), port=0, host="127.0.0.1")
    server.start(background=True)
    try:
        status, report = _http(server.port, "GET", "/healthz")
    finally:
        server.stop()
    assert status == 200 and report["healthy"]
    assert report["checks"] == {"host_memory": True, "devices": True, "model_loaded": True,
                                "dependencies": True}


def _moe_inputs(model, batch):
    """The MoE block's input (its norm's output) and token mask of a forward."""
    seen = []
    hook = model.moe_ffn.register_forward_hook(lambda m, args, out: seen.append(args[:2]))
    try:
        with torch.inference_mode():
            out = model(batch)
    finally:
        hook.remove()
    return out, seen[0]


@pytest.mark.cuda
def test_moe_forward_on_card_matches_cpu(cuda_device):
    """DGDM-Base's layout with 4 experts, f32: logits within 1e-4, the aux
    loss within 1e-5, each token's expert and the kept tokens equal; the
    MoE adds no kernel launch."""
    cpu, card, batch = _small_pair(cuda_device, moe_experts=4)
    kernels.reset_launch_counts()
    _card_vs_cpu(card, cpu, batch, cuda_device)
    assert kernels.launch_counts()["gather_rows"] == 7
    (on_cpu, (x_cpu, m_cpu)), (on_card, (x_card, m_card)) = (
        _moe_inputs(cpu, batch), _moe_inputs(card, batch.to(cuda_device)))
    assert abs(float(on_cpu["moe_aux_loss"]) - float(on_card["moe_aux_loss"])) <= 1e-5
    with torch.inference_mode():
        r_cpu, r_card = cpu.moe_ffn.route(x_cpu, m_cpu), card.moe_ffn.route(x_card, m_card)
    for key in ("first_choice", "kept", "dispatch"):
        assert torch.equal(r_card[key].cpu(), r_cpu[key]), key


@pytest.mark.cuda
def test_moe_training_step_on_card_matches_cpu(cuda_device):
    """One f32 pretrain step of the MoE model (dropout 0, injected draws):
    loss within 1e-4, gradients within 1e-3 of each tensor's largest entry,
    the launches of the model without the MoE."""
    cpu, card, batch = _small_pair(cuda_device, dropout=0.0, moe_experts=4)
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
                            {k: p.grad.cpu() for k, p in model.named_parameters()})
    (m_cpu, _, g_cpu), (m_card, c_card, g_card) = out["cpu"], out["cuda"]
    assert c_card == {"gather_rows": 7, "gather_agg": 14, "gather_rows_bwd": 7,
                      "gather_agg_bwd": 14, "neighbor_transpose": 3, **NO_FLASH}
    assert abs(m_cpu["loss"] - m_card["loss"]) <= 1e-4
    assert abs(m_cpu["moe_aux_loss"] - m_card["moe_aux_loss"]) <= 1e-5
    floor = 1e-3 * max(float(g.abs().max()) for g in g_cpu.values())
    for key, ref in g_cpu.items():
        scale = max(float(ref.abs().max()), floor)
        assert float((g_card[key] - ref).abs().max()) <= 1e-3 * scale, key


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(1, 128, 128), (16, 64, 32), (17, 20, 13), (40, 768, 512),
                                   (3, 3072, 768)])
def test_int8_matmul_pads_what_cublaslt_refuses(cuda_device, m, k, n):
    """Rows <= 16 and K, N not multiples of 8 are zero-padded: the int32
    result equals the exact sums, as on the CPU."""
    from dgdm_histopath_torch.ops.quant import int8_matmul, int8_matmul_plain

    g = torch.Generator(device=cuda_device).manual_seed(m + k + n)
    x = torch.randint(-127, 128, (m, k), generator=g, device=cuda_device, dtype=torch.int8)
    w = torch.randint(-127, 128, (n, k), generator=g, device=cuda_device, dtype=torch.int8)
    out = int8_matmul(x, w)
    assert out.shape == (m, n) and out.dtype == torch.int32
    assert torch.equal(out, int8_matmul_plain(x, w))
    assert torch.equal(out.cpu(), int8_matmul(x.cpu(), w.cpu()))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 512, 768, 512), (1, 1, 128, 128), (4, 197, 768, 3072)])
def test_int8_dense_on_card_matches_its_plain_version_and_the_cpu(cuda_device, shape):
    from dgdm_histopath_torch.ops.quant import (
        int8_dense, int8_matmul_plain, quantize_activations, quantize_weight)

    b, m, k, n = shape
    g = torch.Generator().manual_seed(k)
    x, w = torch.randn(b, m, k, generator=g), torch.randn(n, k, generator=g) * 0.05
    bias = torch.randn(n, generator=g)
    w_q, s = quantize_weight(w.to(cuda_device), axis=0)
    want_q, want_s = quantize_weight(w, axis=0)
    assert torch.equal(w_q.cpu(), want_q) and torch.equal(s.cpu(), want_s)
    xq = quantize_activations(x.to(cuda_device))[0]
    assert torch.equal(xq.cpu(), quantize_activations(x)[0])
    out = int8_dense(x.to(cuda_device), w_q, s.reshape(-1), bias.to(cuda_device))
    plain = int8_dense(x.to(cuda_device), w_q, s.reshape(-1), bias.to(cuda_device),
                       matmul=int8_matmul_plain)
    assert torch.equal(out, plain)
    cpu = int8_dense(x, w_q.cpu(), s.reshape(-1).cpu(), bias)
    torch.testing.assert_close(out.cpu(), cpu, rtol=0, atol=1e-6 * float(cpu.abs().max()))


@pytest.mark.cuda
def test_int8_model_on_card_launches_the_kernels_and_matches_cpu(cuda_device):
    from dgdm_histopath_torch.evaluation.predictor import DGDMPredictor
    from dgdm_histopath_torch.models.quantized import int8_apply

    cpu, card, batch = _small_pair(cuda_device, features=128, hidden_dims=(128, 64))
    pred = DGDMPredictor(model=card, device=cuda_device, feature_extractor="none",
                         quant="int8")
    kernels.reset_launch_counts()
    out = pred.forward(batch)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {"gather_rows": 7, "gather_agg": 14, "gather_rows_bwd": 0,
                                       "gather_agg_bwd": 0, "neighbor_transpose": 0, **NO_FLASH}
    with torch.inference_mode():
        ref = int8_apply(cpu, batch, mode="inference", deterministic=True,
                         return_attention=True)
        flt = card(batch.to(cuda_device))
    logits = out["classification_logits"].cpu()
    assert torch.isfinite(logits).all()
    torch.testing.assert_close(logits, ref["classification_logits"], rtol=0, atol=1e-3)
    assert float((logits - flt["classification_logits"].cpu()).abs().max()) > 1e-4
