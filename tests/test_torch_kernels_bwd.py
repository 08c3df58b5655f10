"""The plain versions of the port's backward gather kernels against the JAX
package: the Pallas ``gather_rows`` backward in interpret mode, ``jax.grad``
through the Pallas forwards, and the XLA vjp of ``weighted_gather_sum``.
The plain versions have the kernels' gather form: each destination row sums
its slots of the transposed neighbor list (``neighbor_transpose.py``).

Everything is f32 on the CPU unless a test says bf16. The scatter sums run
in another order than JAX's: up to K·(collisions) f32 terms per row, so the
``gather_rows`` backward is held to 1e-6 and the ``weighted_gather_sum``
backward (products of O(1) values, F-term dots) to 1e-5. In bf16 both sides
accumulate in f32 and round once, so they may differ by one bf16 ulp where
the f32 sums straddle a rounding boundary. The CUDA kernels are held to
these plain versions on the card in tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgdm_histopath_tpu.ops.pallas.gather_agg import _vjp_bwd as j_wgs_vjp_bwd
from dgdm_histopath_tpu.ops.pallas.gather_agg import weighted_gather_sum as j_wgs
from dgdm_histopath_tpu.ops.pallas.gather_rows import _bwd_pallas
from dgdm_histopath_tpu.ops.pallas.gather_rows import gather_rows as j_gather_rows
from dgdm_histopath_torch.nn.layers import init_parameters
from dgdm_histopath_torch.models.dgdm import DGDMModel
from dgdm_histopath_torch.ops import kernels
from dgdm_histopath_torch.ops.kernels import neighbor_transpose as nt
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

DT = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _data(b=2, n=128, k=5, f=128, dtype="float32", seed=0, lo=0, hi=None):
    """g, h with values representable in ``dtype``; idx in [lo, hi)."""
    rs = np.random.RandomState(seed)
    tdt = DT[dtype][0]
    g = torch.from_numpy(rs.randn(b, n, k, f).astype(np.float32)).to(tdt)
    h = torch.from_numpy(rs.randn(b, n, f).astype(np.float32)).to(tdt)
    idx = rs.randint(lo, n if hi is None else hi, size=(b, n, k)).astype(np.int32)
    w = rs.rand(b, n, k).astype(np.float32)
    g3 = rs.randn(b, n, f).astype(np.float32)
    return g, h, idx, w, g3


def _jax(t, dtype):
    return jnp.asarray(t.float().numpy(), DT[dtype][1])


def _assert_within_one_bf16_ulp(out, ref):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    ulp = np.maximum(np.abs(ref), 2.0 ** -126) * 2.0 ** -7
    assert (np.abs(out - ref) <= ulp).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_rows_bwd_plain_matches_pallas_backward(dtype):
    g, _, idx, _, _ = _data(dtype=dtype)
    ref = _bwd_pallas(jnp.asarray(idx), _jax(g, dtype), 128, DT[dtype][1], interpret=True)
    out = gather_rows_bwd_plain(torch.from_numpy(idx), g)
    assert out.dtype == g.dtype and out.shape == (2, 128, 128)
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-6)
    else:
        # the Pallas block accumulates tile by tile in f32 and the vjp casts once
        _assert_within_one_bf16_ulp(out.float().numpy(), ref.astype(jnp.bfloat16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_rows_bwd_plain_matches_jax_grad_through_the_pallas_gather(dtype):
    g, h, idx, _, _ = _data(dtype=dtype)
    jg = _jax(g, dtype)
    ref = jax.grad(lambda s: jnp.sum((j_gather_rows(s, jnp.asarray(idx), True)
                                      * jg).astype(jnp.float32)))(_jax(h, dtype))
    out = gather_rows_bwd_plain(torch.from_numpy(idx), g)
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-6)
    else:
        _assert_within_one_bf16_ulp(out.float().numpy(), ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weighted_gather_sum_bwd_plain_matches_jax_vjp(dtype):
    _, h, idx, w, g3 = _data(dtype=dtype)
    _, vjp = jax.vjp(lambda h_, w_: j_wgs(h_, jnp.asarray(idx), w_, True),
                     _jax(h, dtype), jnp.asarray(w))
    ref_dh, ref_dw = vjp(jnp.asarray(g3))
    dh, dw = weighted_gather_sum_bwd_plain(torch.from_numpy(g3), h, torch.from_numpy(idx),
                                           torch.from_numpy(w))
    assert dh.dtype == h.dtype and dw.dtype == torch.float32
    np.testing.assert_allclose(dw.numpy(), np.asarray(ref_dw), atol=1e-5, rtol=1e-5)
    if dtype == "float32":
        np.testing.assert_allclose(dh.numpy(), np.asarray(ref_dh), atol=1e-5, rtol=1e-5)
    else:
        _assert_within_one_bf16_ulp(dh.float().numpy(), ref_dh)


def test_out_of_range_indices_add_nothing_like_the_pallas_backward():
    g, h, idx, w, g3 = _data(lo=-3, hi=131, seed=5)
    bad = (idx < 0) | (idx >= 128)
    assert bad.any()
    ti = torch.from_numpy(idx)
    ref = _bwd_pallas(jnp.asarray(idx), _jax(g, "float32"), 128, jnp.float32, interpret=True)
    np.testing.assert_allclose(gather_rows_bwd_plain(ti, g).numpy(), np.asarray(ref),
                               atol=1e-6, rtol=1e-6)
    dh, dw = weighted_gather_sum_bwd_plain(torch.from_numpy(g3), h, ti, torch.from_numpy(w))
    np.testing.assert_array_equal(dw.numpy()[bad], 0.0)
    # dh equals the sum over the in-range slots only
    clean = torch.from_numpy(np.where(bad, 0, idx).astype(np.int32))
    w_clean = torch.from_numpy(np.where(bad, 0.0, w).astype(np.float32))
    dh_ref, _ = weighted_gather_sum_bwd_plain(torch.from_numpy(g3), h, clean, w_clean)
    np.testing.assert_allclose(dh.numpy(), dh_ref.numpy(), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("lo,hi", [(0, None), (-2, 18)])
def test_plain_backwards_are_the_autograd_of_the_plain_forwards(lo, hi):
    """The f32 scatter sums against autograd through the plain forwards
    (1e-5: both are f32 sums of at most N·K terms in different orders)."""
    g, h, idx, w, g3 = _data(b=2, n=16, k=4, f=8, lo=lo, hi=hi, seed=3)
    ti, tw = torch.from_numpy(idx), torch.from_numpy(w).requires_grad_()
    src = h.clone().requires_grad_()
    (dsrc,) = torch.autograd.grad(gather_rows_plain(src, ti), src, g)
    torch.testing.assert_close(gather_rows_bwd_plain(ti, g), dsrc, atol=1e-5, rtol=1e-5)
    dh, dw = torch.autograd.grad(weighted_gather_sum_plain(src, ti, tw), (src, tw),
                                 torch.from_numpy(g3))
    out_dh, out_dw = weighted_gather_sum_bwd_plain(torch.from_numpy(g3), h, ti, tw.detach())
    torch.testing.assert_close(out_dh, dh, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(out_dw, dw, atol=1e-5, rtol=1e-5)


def test_wrappers_pass_gradcheck_on_the_cpu():
    """The CPU path is the autograd Function over the plain forward and the
    plain gather-form backward; the wrappers take f32 and bf16 only, so
    gradcheck runs in f32 with loose steps."""
    _, h, idx, w, _ = _data(b=1, n=6, k=3, f=4, seed=2)
    ti = torch.from_numpy(idx)
    src = h.clone().requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    kw = dict(eps=1e-2, atol=1e-2, rtol=1e-2)
    assert torch.autograd.gradcheck(lambda s: gather_rows(s, ti), (src,), **kw)
    assert torch.autograd.gradcheck(lambda s, w_: weighted_gather_sum(s, ti, w_),
                                    (src, tw), **kw)


def test_plain_forwards_pass_gradcheck_in_f64():
    _, h, idx, w, _ = _data(b=1, n=6, k=3, f=4, seed=2, lo=-1, hi=7)
    ti = torch.from_numpy(idx)
    src = h.double().requires_grad_()
    tw = torch.from_numpy(w).double().requires_grad_()
    assert torch.autograd.gradcheck(lambda s: gather_rows_plain(s, ti), (src,))
    assert torch.autograd.gradcheck(
        lambda s, w_: (gather_rows_plain(s, ti) * w_[..., None]).sum(-2), (src, tw))


def test_non_contiguous_cotangent_gives_the_same_sums():
    g, _, idx, _, _ = _data(b=2, n=16, k=4, f=8)
    ti = torch.from_numpy(idx)
    strided = g.permute(0, 1, 3, 2).contiguous().permute(0, 1, 3, 2)
    assert not strided.is_contiguous()
    assert torch.equal(gather_rows_bwd_plain(ti, strided), gather_rows_bwd_plain(ti, g))
    expanded = g[:, :, :1, :].expand(2, 16, 4, 8)
    assert torch.equal(gather_rows_bwd_plain(ti, expanded),
                       gather_rows_bwd_plain(ti, expanded.contiguous()))


def test_backward_kernel_wrappers_refuse_cpu_tensors_and_launch_nothing():
    """The backward wrappers are the kernels' own entry points: no plain
    version stands behind them, so a CPU tensor raises."""
    g, h, idx, w, g3 = _data(b=1, n=8, k=2, f=4)
    before = kernels.launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        gather_rows_bwd(torch.from_numpy(idx), g)
    with pytest.raises(ValueError, match="CUDA"):
        weighted_gather_sum_bwd(torch.from_numpy(g3), h, torch.from_numpy(idx),
                                torch.from_numpy(w))
    assert kernels.launch_counts() == before
    assert set(before) == {"gather_rows", "gather_agg", "gather_rows_bwd", "gather_agg_bwd",
                           "neighbor_transpose", "flash_spatial_packed", "flash_spatial"}


def _case(case, dtype, seed=7):
    """(g4, h, idx, w, g3) of a named case: ``ragged`` (N 100, K 5, F 24),
    ``out_of_range`` (indices in [-3, N+3)) and ``hub`` (half the slots at
    node 0, as pooling leaves them), all at B 2."""
    b, n, k, f = (2, 100, 5, 24) if case == "ragged" else (2, 128, 8, 32)
    rs = np.random.RandomState(seed)
    tdt = DT[dtype][0]
    g4 = torch.from_numpy(rs.randn(b, n, k, f).astype(np.float32)).to(tdt)
    h = torch.from_numpy(rs.randn(b, n, f).astype(np.float32)).to(tdt)
    lo, hi = (-3, n + 3) if case == "out_of_range" else (0, n)
    idx = rs.randint(lo, hi, size=(b, n, k)).astype(np.int32)
    if case == "hub":
        idx[rs.rand(b, n, k) < 0.5] = 0
    w = rs.rand(b, n, k).astype(np.float32)
    g3 = rs.randn(b, n, f).astype(np.float32)
    return g4, h, idx, w, g3


def _pallas_bwd_padded(idx, g4, dtype):
    """The Pallas backward in interpret mode; N padded to its 128-row tile
    with rows that index nothing and carry zero cotangents."""
    b, n, k, f = g4.shape
    pad = -n % 128
    idx_p = np.pad(idx, ((0, 0), (0, pad), (0, 0)), constant_values=-1)
    g_p = np.pad(g4.float().numpy(), ((0, 0), (0, pad), (0, 0), (0, 0)))
    ref = _bwd_pallas(jnp.asarray(idx_p), jnp.asarray(g_p, DT[dtype][1]), n + pad,
                      DT[dtype][1], interpret=True)
    return np.asarray(ref.astype(DT[dtype][1]), np.float32)[:, :n]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["ragged", "out_of_range", "hub"])
def test_gather_form_plain_backwards_match_the_jax_backwards(case, dtype):
    """The gather-form plain versions (what the kernels are held to on the
    card) against the Pallas gather_rows backward and the XLA vjp of
    weighted_gather_sum, on the same numpy inputs: 1e-5 in f32, one bf16
    ulp in bf16 (both sides sum in f32 and round once)."""
    g4, h, idx, w, g3 = _case(case, dtype)
    ti = torch.from_numpy(idx)
    dsrc = gather_rows_bwd_plain(ti, g4)
    ref = _pallas_bwd_padded(idx, g4, dtype)
    # the XLA vjp has no out-of-range rule (its take fills NaN): it gets the
    # in-range slots only, which is what "adds nothing" means
    bad = (idx < 0) | (idx >= idx.shape[1])
    (ref_dh, _, ref_dw) = j_wgs_vjp_bwd(
        None, (_jax(h, dtype), jnp.asarray(np.where(bad, 0, idx)),
               jnp.asarray(np.where(bad, 0.0, w).astype(np.float32))), jnp.asarray(g3))
    ref_dw = np.where(bad, 0.0, np.asarray(ref_dw))
    dh, dw = weighted_gather_sum_bwd_plain(torch.from_numpy(g3), h, ti, torch.from_numpy(w))
    assert dsrc.dtype == g4.dtype and dh.dtype == h.dtype and dw.dtype == torch.float32
    np.testing.assert_allclose(dw.numpy(), np.asarray(ref_dw), atol=1e-5, rtol=1e-5)
    if dtype == "float32":
        np.testing.assert_allclose(dsrc.numpy(), ref, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(dh.numpy(), np.asarray(ref_dh), atol=1e-5, rtol=1e-5)
    else:
        _assert_within_one_bf16_ulp(dsrc.float().numpy(), ref)
        _assert_within_one_bf16_ulp(dh.float().numpy(), np.asarray(ref_dh, np.float32))
    assert bad.any() == (case == "out_of_range") and (dw.numpy()[bad] == 0).all()


@pytest.mark.parametrize("case", ["ragged", "out_of_range", "hub"])
def test_a_given_transposed_list_gives_the_same_sums_as_one_built_inside(case):
    g4, h, idx, w, g3 = _case(case, "float32")
    ti, tw, tg3 = torch.from_numpy(idx), torch.from_numpy(w), torch.from_numpy(g3)
    t = nt.neighbor_transpose(ti)
    assert torch.equal(gather_rows_bwd_plain(ti, g4, t), gather_rows_bwd_plain(ti, g4))
    for a, b in zip(weighted_gather_sum_bwd_plain(tg3, h, ti, tw, t),
                    weighted_gather_sum_bwd_plain(tg3, h, ti, tw)):
        assert torch.equal(a, b)
    # and through the wrappers' autograd on the CPU
    src, w1 = h.clone().requires_grad_(), tw.clone().requires_grad_()
    with_t = torch.autograd.grad(weighted_gather_sum(src, ti, w1, t), (src, w1), tg3)
    without = torch.autograd.grad(weighted_gather_sum(src, ti, w1), (src, w1), tg3)
    assert all(torch.equal(a, b) for a, b in zip(with_t, without))
    (r_with,) = torch.autograd.grad(gather_rows(src, ti, t), src, g4)
    (r_without,) = torch.autograd.grad(gather_rows(src, ti), src, g4)
    assert torch.equal(r_with, r_without)
    with pytest.raises(ValueError, match="does not fit"):
        gather_rows(src, ti, nt.neighbor_transpose(ti[:, :-1]))


def test_a_small_base_step_gives_the_same_gradients_with_and_without_the_list(monkeypatch):
    """A small DGDM-Base pretrain step (f32, the U-Net's three levels) on the
    CPU: with the transposed lists built once per level in the forward and
    handed to every layer, and without (each gather builds its own in its
    backward). Same lists, same sums: the gradients are equal."""
    from test_torch_training import KW, make_batch, to_torch_graph
    from dgdm_histopath_torch.training import DGDMTrainer, TrainerConfig

    tbatch = to_torch_graph(make_batch())
    b, n = tbatch.node_mask.shape
    gen = torch.Generator().manual_seed(0)
    draws = {"masked": (torch.rand(b, n, generator=gen) < 0.15) & tbatch.node_mask,
             "t": torch.randint(0, 3, (b,), generator=gen),
             "noise": torch.randn(b, n, KW["hidden_dims"][-1], generator=gen),
             "uniform": torch.rand(b, n, generator=gen)}
    built = []
    real_build = nt.neighbor_transpose

    def counted_build(idx, m=None):
        built.append(tuple(idx.shape))
        return real_build(idx, m)

    monkeypatch.setattr(nt, "neighbor_transpose", counted_build)

    def grads():
        tm = init_parameters(DGDMModel(**KW), torch.Generator().manual_seed(0))
        loss, _ = DGDMTrainer(tm, TrainerConfig(), device="cpu")._pretrain_losses(tbatch, draws)
        loss.backward()
        return {k: p.grad.clone() for k, p in tm.named_parameters() if p.grad is not None}

    without = grads()
    assert built == []                          # nothing built in a CPU forward by default
    monkeypatch.setattr(nt, "BUILD_DEVICES", ("cuda", "cpu"))
    with_lists = grads()
    assert built == [(b, n, 8), (b, n // 2, 8), (b, n // 4, 8)]   # once per level
    assert with_lists.keys() == without.keys() and len(without) > 10
    for key, g in without.items():
        assert torch.equal(with_lists[key], g), key
