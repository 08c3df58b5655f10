"""The plain versions of the port's backward gather kernels against the JAX
package: the Pallas ``gather_rows`` backward in interpret mode, ``jax.grad``
through the Pallas forwards, and the XLA vjp of ``weighted_gather_sum``.

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

from dgdm_histopath_tpu.ops.pallas.gather_agg import weighted_gather_sum as j_wgs
from dgdm_histopath_tpu.ops.pallas.gather_rows import _bwd_pallas
from dgdm_histopath_tpu.ops.pallas.gather_rows import gather_rows as j_gather_rows
from dgdm_histopath_torch.ops import kernels
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
    """The CPU path is the plain forward under plain autograd; the wrappers
    take f32 and bf16 only, so gradcheck runs in f32 with loose steps."""
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
    assert set(before) == {"gather_rows", "gather_agg", "gather_rows_bwd", "gather_agg_bwd"}
