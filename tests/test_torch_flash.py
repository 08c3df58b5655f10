"""Flash spatial attention of the port against the JAX package on the CPU: f32,
and bf16 inputs at the widths the card kernels treat apart.

The JAX side runs its Pallas kernels in interpret mode (``force_pallas=True``,
as tests/test_pallas.py does) under ``default_matmul_precision("float32")``.
On the CPU the port's wrapper runs the plain PyTorch versions of its two CUDA
kernels (a blockwise online softmax with the kernels' constants) and the
dense-recompute backward.

Tolerances are the reference's own (tests/test_pallas.py): 1e-4 on valid rows
at tau = 0.1 (bf16 outputs: plus one bf16 ulp of each element, since both
sides round their f32 result once); 5e-3 at tau = 1e-3, where the sharp
softmax amplifies rounding differences in the distance; gradients rtol = atol
= 2e-3 (the backward is a dense recompute on both sides, the forward values it
starts from differ by the 1e-4 above); modules 2e-4.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgdm_histopath_tpu.nn import attention as jatt
from dgdm_histopath_tpu.ops.pallas.flash_spatial import flash_spatial_attention as j_flash
from dgdm_histopath_torch.nn import attention as tatt
from dgdm_histopath_torch.ops import kernels
from dgdm_histopath_torch.ops.kernels import flash_spatial as fs
from test_torch_layers import _carry, _close, _init_apply, _t

SHAPES = {"8x16": (8, 16), "16x8": (16, 8), "4x16": (4, 16), "2x128": (2, 128)}
# widths the card kernels treat apart (D padded to 8 or to 16s in shared
# memory, D = 8 off the packed route, D > 128, many heads of width 4) and the
# two packed model widths at DGDM-Large's bucket
WIDTHS = {"4x64": (4, 64), "8x8": (8, 8), "3x24": (3, 24), "2x5": (2, 5), "1x200": (1, 200),
          "32x4": (32, 4)}
ALL_WIDTHS = {**SHAPES, **WIDTHS}
PARITY_CASES = (   # (heads, N, tau, dtype)
    [(h, n, tau, "f32") for h in sorted(SHAPES) for n in (128, 256) for tau in (0.1, 1e-3)]
    + [(h, 128, tau, "f32") for h in WIDTHS for tau in (0.1, 1e-3)]
    + [(h, 2048, tau, "f32") for h in ("8x16", "16x8") for tau in (0.1, 1e-3)]
    + [(h, 256, 0.1, "bf16") for h in sorted(SHAPES)]
    + [(h, 128, 0.1, "bf16") for h in WIDTHS]
    + [(h, 2048, 0.1, "bf16") for h in ("8x16", "16x8")])


def _inputs(n, h, d, masked_from, b=2, seed=0):
    rs = np.random.RandomState(seed)
    q, k, v = (rs.randn(b, n, h, d).astype(np.float32) for _ in range(3))
    pos = rs.rand(b, n, 2).astype(np.float32)
    mask = np.ones((b, n), bool)
    mask[:, masked_from:] = False
    return q, k, v, pos, mask


def _jax_flash(q, k, v, pos, mask, tau):
    with jax.default_matmul_precision("float32"):
        return np.asarray(j_flash(*(jnp.asarray(a) for a in (q, k, v, pos, mask)), tau=tau,
                                  force_pallas=True))


@pytest.mark.parametrize(
    "heads,n,tau,dtype",
    [pytest.param(*c, id="-".join(map(str, c[:3])) + ("-bf16" if c[3] == "bf16" else ""))
     for c in PARITY_CASES])
def test_plain_versions_match_the_jax_kernels(heads, n, tau, dtype):
    """bf16: both sides take the same bf16 inputs, compute in f32 and round
    once, so each element is held to its own bf16 ulp on top of the f32
    limit (the two f32 values may straddle a rounding boundary)."""
    h, d = ALL_WIDTHS[heads]
    q, k, v, pos, mask = _inputs(n, h, d, masked_from=n - 28)
    route = fs.flash_route(n, h, d)
    assert route == ("packed" if h * d == 128 else "headmajor")
    qkv = _t(q, k, v)
    if dtype == "bf16":
        qkv = [t.to(torch.bfloat16) for t in qkv]
        q, k, v = (t.float().numpy() for t in qkv)      # exact: bf16 values in f32
    out = fs.flash_spatial_attention(*qkv, *_t(pos, mask), tau=tau)
    plain = fs.flash_spatial_packed_plain if route == "packed" else fs.flash_spatial_plain
    assert torch.equal(out, plain(*qkv, *_t(pos, mask), tau))
    if dtype == "bf16":
        assert out.dtype == torch.bfloat16
        with jax.default_matmul_precision("float32"):
            ref = np.asarray(j_flash(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                                     jnp.asarray(pos), jnp.asarray(mask), tau=tau,
                                     force_pallas=True).astype(jnp.float32))
        ulp = np.ldexp(np.ones_like(ref), np.frexp(ref)[1] - 8)
    else:
        ref = _jax_flash(q, k, v, pos, mask, tau)
        ulp = 0.0
    out = out.float().numpy()
    valid = mask[:, :, None, None]
    assert out.shape == ref.shape
    err = np.abs((out - ref) * valid)
    assert (err < (1e-4 if tau == 0.1 else 5e-3) + ulp).all(), err.max()


@pytest.mark.parametrize("heads", ["8x16", "4x16"])
def test_plain_versions_agree_with_each_other_and_with_dense(heads):
    """Both plain versions compute one function, whatever the route."""
    h, d = SHAPES[heads]
    args = _t(*_inputs(256, h, d, masked_from=200, seed=1))
    a = fs.flash_spatial_packed_plain(*args, 0.1)
    b = fs.flash_spatial_plain(*args, 0.1)
    dense = fs.dense_reference(*args, 0.1)
    valid = args[4][:, :, None, None]
    assert ((a - b).abs() * valid).max() < 1e-5
    assert ((a - dense).abs() * valid).max() < 1e-5


@pytest.mark.parametrize("heads", ["8x16", "4x16"])
def test_graph_without_a_valid_node_gives_zeros(heads):
    h, d = SHAPES[heads]
    q, k, v, pos, mask = _inputs(128, h, d, masked_from=100, seed=2)
    mask[1] = False
    out = fs.flash_spatial_attention(*_t(q, k, v, pos, mask))
    assert (out[1] == 0).all() and torch.isfinite(out).all() and (out[0] != 0).any()
    ref = _jax_flash(q, k, v, pos, mask, 0.1)
    np.testing.assert_array_equal(ref[1], 0.0)
    assert np.abs((out.numpy() - ref) * mask[:, :, None, None]).max() < 1e-4


@pytest.mark.parametrize("heads", ["16x8", "4x16"])
def test_masked_value_rows_change_no_valid_row(heads):
    h, d = SHAPES[heads]
    q, k, v, pos, mask = _inputs(256, h, d, masked_from=128, seed=3)
    out1 = fs.flash_spatial_attention(*_t(q, k, v, pos, mask))
    v2 = v.copy()
    v2[:, 128:] = 99.0
    out2 = fs.flash_spatial_attention(*_t(q, k, v2, pos, mask))
    assert torch.equal(out1[:, :128], out2[:, :128])


def test_nontiling_node_count_takes_the_dense_route():
    q, k, v, pos, mask = _inputs(100, 8, 16, masked_from=90, seed=4)
    assert fs.flash_route(100, 8, 16) == "dense" and fs.flash_route(64, 8, 16) == "dense"
    before, dense_before = kernels.launch_counts(), fs.dense_route_calls()
    out = fs.flash_spatial_attention(*_t(q, k, v, pos, mask))
    assert kernels.launch_counts() == before
    assert fs.dense_route_calls() == dense_before + 1
    assert torch.equal(out, fs.dense_reference(*_t(q, k, v, pos, mask), 0.1))
    with jax.default_matmul_precision("float32"):
        ref = np.asarray(j_flash(*(jnp.asarray(a) for a in (q, k, v, pos, mask))))
    assert np.abs((out.numpy() - ref) * mask[:, :, None, None]).max() < 1e-4


@pytest.mark.parametrize("heads", ["8x16", "16x8", "4x16"])
def test_gradients_match_jax_grad_through_the_jax_wrapper(heads):
    h, d = SHAPES[heads]
    q, k, v, pos, mask = _inputs(128, h, d, masked_from=120, seed=5)
    mj = jnp.asarray(mask)

    def loss(q_, k_, v_):
        o = j_flash(q_, k_, v_, jnp.asarray(pos), mj, tau=0.1, force_pallas=True)
        return jnp.sum((o * mj[..., None, None]) ** 2)

    with jax.default_matmul_precision("float32"):
        ref = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    leaves = [t.requires_grad_() for t in _t(q, k, v)]
    tpos, tmask = _t(pos, mask)
    tpos.requires_grad_()
    out = fs.flash_spatial_attention(*leaves, tpos, tmask)
    assert out.grad_fn is not None and "FlashSpatial" in type(out.grad_fn).__name__
    ((out * tmask[..., None, None]) ** 2).sum().backward()
    for got, want in zip(leaves, ref):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want), atol=2e-3, rtol=2e-3)
    assert (tpos.grad == 0).all()          # pos gets a zero gradient, as in the reference


def test_wrapper_rejects_what_the_kernels_do_not_take():
    q, k, v, pos, mask = _t(*_inputs(128, 8, 16, masked_from=128))
    with pytest.raises(TypeError, match="bf16, f16 or f32"):
        fs.flash_spatial_attention(q.double(), k.double(), v.double(), pos, mask)
    with pytest.raises(TypeError, match="bool"):
        fs.flash_spatial_attention(q, k, v, pos, mask.float())
    with pytest.raises(ValueError, match="one shape"):
        fs.flash_spatial_attention(q, k[:, :64], v, pos, mask)
    with pytest.raises(ValueError, match="pos"):
        fs.flash_spatial_attention(q, k, v, pos[:, :64], mask)
    assert {"flash_spatial_packed", "flash_spatial"} <= set(kernels.KERNELS)


# ---------------------------------------------------------------------------
# SpatialAttention: the flash, windowed, traffic-dtype and dense routes
# ---------------------------------------------------------------------------

def _module_inputs(n, f, n_real, seed=0, b=2):
    rs = np.random.RandomState(seed)
    x = rs.randn(b, n, f).astype(np.float32)
    pos = rs.rand(b, n, 2).astype(np.float32)
    mask = np.zeros((b, n), bool)
    mask[:, :n_real] = True
    return x, pos, mask


@pytest.mark.parametrize("width", ["128/8", "128/16", "64/4"])
def test_spatial_attention_flash_matches_jax_flash_and_the_dense_module(width):
    f, h = (int(s) for s in width.split("/"))
    x, pos, mask = _module_inputs(256, f, 200, seed=1)
    jm = jatt.SpatialAttention(f, h, use_flash=True, dtype=jnp.float32)
    with jax.default_matmul_precision("float32"):
        variables = jm.init(jax.random.PRNGKey(0), x, pos, mask)
        # the JAX module gives the Pallas kernel only on a TPU backend; its
        # wrapper picks interpret mode by itself off one
        ref = jm.apply(variables, x, pos, mask)
    flash = _carry(tatt.SpatialAttention(f, h, use_flash=True), variables)
    dense = _carry(tatt.SpatialAttention(f, h), variables)
    assert flash.route(256) == "flash" and dense.route(256) == "dense"
    before = kernels.launch_counts()
    out = flash(*_t(x, pos, mask))
    assert kernels.launch_counts() == before       # CPU tensors: no kernel launch
    _close(out, ref, 2e-4)
    _close(out, dense(*_t(x, pos, mask)).detach().numpy(), 2e-4)
    # asking for the weights forces the dense route, as in the reference
    out_w, w = flash(*_t(x, pos, mask), return_weights=True)
    assert w.shape == (2, h, 256, 256)
    _close(out_w, out.detach().numpy(), 2e-4)


def test_spatial_attention_window_matches_jax_and_wraps_around():
    """N = 512 in 4 blocks of 128. The nodes of block 0 and of the last block
    are put close together, far from the rest, so block 0's attention goes
    to its wrapped previous block: without the roll-around the outputs of
    block 0 differ, which the last assertion shows."""
    n, w, f, h = 512, 128, 32, 4
    x, pos, mask = _module_inputs(n, f, n, seed=2)
    pos[:, :w] = pos[:, :w] * 0.05
    pos[:, -w:] = pos[:, -w:] * 0.05
    pos[:, w:-w] = 0.5 + pos[:, w:-w] * 0.5
    mask[1, 500:] = False
    jm = jatt.SpatialAttention(f, h, window_size=w, dtype=jnp.float32)
    variables, ref = _init_apply(jm, x, pos, mask)
    tm = _carry(tatt.SpatialAttention(f, h, window_size=w), variables)
    assert tm.route(n) == "window"
    out = tm(*_t(x, pos, mask))
    _close(out, ref)
    dense = _carry(tatt.SpatialAttention(f, h), variables)(*_t(x, pos, mask))
    assert (out - dense).abs().max() > 1e-3            # the window is an approximation
    # keys of the wrapped block matter: scramble the last block's features
    x2 = x.copy()
    x2[:, -w:] = np.random.RandomState(9).randn(2, w, f)
    moved = (tm(*_t(x2, pos, mask)) - out).abs()[:, :w].max()
    assert moved > 1e-3
    middle = (tm(*_t(x2, pos, mask)) - out).abs()[:, w:2 * w].max()
    assert middle == 0.0                               # block 1 never sees the last block


def test_spatial_attention_window_dropout_draws_from_the_generator():
    x, pos, mask = _module_inputs(384, 32, 300, seed=3)
    tm = tatt.SpatialAttention(32, 4, dropout=0.5, window_size=128)
    from dgdm_histopath_torch.nn.layers import init_parameters
    init_parameters(tm, torch.Generator().manual_seed(0))
    args = _t(x, pos, mask)
    a = tm(*args, deterministic=False, generator=torch.Generator().manual_seed(1))
    b = tm(*args, deterministic=False, generator=torch.Generator().manual_seed(1))
    c = tm(*args, deterministic=False, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a, tm(*args))


@pytest.mark.parametrize("route", ["dense", "window"])
def test_spatial_attention_traffic_dtype_bf16_matches_jax(route):
    """Logits and weights take one bf16 rounding each (2^-9 relative); through
    the softmax and the LayerNorm the outputs of the two packages, which round
    the same f32 values, differ where a value sits on a rounding boundary:
    held to 2e-2 on O(1) outputs, and to the f32 module within 5e-2."""
    n, w = 384, (128 if route == "window" else None)
    x, pos, mask = _module_inputs(n, 32, 300, seed=4)
    jm = jatt.SpatialAttention(32, 4, window_size=w, traffic_dtype=jnp.bfloat16,
                               dtype=jnp.float32)
    variables, ref = _init_apply(jm, x, pos, mask)
    tm = _carry(tatt.SpatialAttention(32, 4, window_size=w, traffic_dtype=torch.bfloat16),
                variables)
    assert tm.route(n) == route
    out = tm(*_t(x, pos, mask))
    _close(out, ref, 2e-2)
    exact = _carry(tatt.SpatialAttention(32, 4, window_size=w), variables)(*_t(x, pos, mask))
    assert 0 < (out - exact).abs().max() < 5e-2
    if route == "dense":
        _, weights = tm(*_t(x, pos, mask), return_weights=True)
        assert weights.dtype == torch.bfloat16


ROUTE_CASES = [   # (module flags, N, deterministic, return_weights)
    (dict(use_flash=True), 256, True, False),
    (dict(use_flash=True), 256, True, True),
    (dict(use_flash=True), 200, True, False),
    (dict(use_flash=True, dropout=0.1), 256, False, False),
    (dict(use_flash=True, dropout=0.1), 256, True, False),
    (dict(use_flash=True, dropout=0.0), 256, False, False),
    (dict(use_flash=True, window_size=128), 384, True, False),
    (dict(use_flash=True, window_size=64, dropout=0.1), 256, False, False),
    (dict(window_size=128), 384, True, False),
    (dict(window_size=128), 256, True, False),
    (dict(window_size=100), 384, True, False),
    (dict(window_size=128), 384, True, True),
    (dict(flash_auto_min_nodes=256), 256, True, False),
    (dict(flash_auto_min_nodes=256, dropout=0.0), 256, False, False),
    (dict(flash_auto_min_nodes=512), 256, True, False),
    (dict(), 256, True, False),
]


def _reference_route(flags, n, deterministic, return_weights) -> str:
    """The route the JAX module takes, read off its traced program: a
    ``pallas_call`` is flash, an [N, N] array is dense, else windowed."""
    jm = jatt.SpatialAttention(32, 4, dtype=jnp.float32, **flags)
    x, pos, mask = _module_inputs(n, 32, n, b=1)
    rngs = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}
    kw = dict(deterministic=deterministic, return_weights=return_weights)
    variables = jax.eval_shape(lambda: jm.init(rngs, x, pos, mask))
    variables = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), variables)
    text = str(jax.make_jaxpr(lambda v: jm.apply(v, x, pos, mask, rngs=rngs, **kw))(variables))
    if "pallas_call" in text:
        return "flash"
    return "dense" if re.search(rf"\[[\d,]*{n},{n}\]", text) else "window"


@pytest.mark.parametrize("case", range(len(ROUTE_CASES)))
def test_route_table_equals_the_reference(case):
    flags, n, deterministic, return_weights = ROUTE_CASES[case]
    tm = tatt.SpatialAttention(32, 4, **flags)
    assert tm.route(n, deterministic, return_weights) == _reference_route(
        flags, n, deterministic, return_weights)


def test_route_table_covers_every_route():
    got = {tatt.SpatialAttention(32, 4, **f).route(n, d, r) for f, n, d, r in ROUTE_CASES}
    assert got == {"flash", "window", "dense"}
