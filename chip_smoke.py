#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``dgdm_histopath_torch``) on one GPU and check it.

Run from the repository root with no arguments:  python3 chip_smoke.py

Phases, each of which raises on a failed check:
  1. environment: torch/CUDA versions and the card's name and power limit;
  2. build: nvcc builds every kernel under dgdm_histopath_torch/csrc/, and
     the registers, spills and static shared memory ptxas reported for each
     flash kernel instantiation;
  3. kernels: each of the four gather kernels (the two gathers and their
     backwards) and the transposed neighbor list the backwards read, against
     its plain PyTorch version on the card at the shapes both model paths
     give it (DGDM-Base: B=32, N in {1024, 512, 256}; DGDM-Large: B=4, N in
     {2048, 1024, 512}; K=8, F=128, bf16 and f32), at hub shapes (half the
     slots at node 0, as pooling leaves them) and one ragged shape, with
     device times (CUDA-graph replays timed by CUDA events), the plain
     version's and the library call's (``index_add_``, ``torch.gather``,
     ``torch.sparse.mm`` over a CSR adjacency); the backwards bit-identical
     from call to call; autograd through each wrapper against the plain
     backward functions. Then
     the two flash spatial-attention kernels against their plain versions,
     bf16 and f32, at the DGDM-Base shape (B=32, N=1024, 8 heads x 16), the
     DGDM-Large shape (B=4, N=2048, 16 x 8) and a head-major shape (B=8,
     N=1024, 4 x 64), each with a masked tail, and ten other widths at
     N=128 (bf16 runs on the tensor cores, f32 on FMAs), an all-masked graph,
     a shape that takes the dense route (counted, no launch), their gradients
     against plain autograd, the exp floor next to the tensor-core bound, and
     ``scaled_dot_product_attention`` with an additive mask as the library
     yardstick;
  4. model: DGDM-Base (seeded weights, bf16) on 32 graphs of bucket 1024
     with 1000 real nodes through DGDMPredictor.predict_batch; the kernel
     launch counts of that run, output checks, forward time, and the card
     against the CPU in f32 on 2 graphs;
  5. server: InferenceServer answers 1 /predict whose nbr_idx leaves
     [0, N), 3 /predict and 1 /predict_batch requests with full-width
     graphs, each checked against the predictor and each counted: one
     forward's kernel launches per request;
  6. training: DGDMTrainer on DGDM-Base (bf16 compute, f32 parameters,
     dropout 0.1) with the same 32 graphs: 8 pretrain steps (launch counts of
     one step, finite metrics, learning rate 0 at the first update, the same
     seed giving the same first loss), 2 finetune steps with labels, one
     validation step, one f32 step on the card against the CPU on 2 graphs
     with injected draws, step time, peak memory and a profiled step; the
     backward kernels and the list build timed on the three neighbor-index
     tensors of one real pretrain step;
  7. flash module: ``SpatialAttention(128, 8, use_flash=True)`` on B=32,
     N=1024 in bf16 against the same module with ``use_flash=False`` (one
     packed launch, outputs within tolerance, peak memory of both), in f32 at
     B=4 within 2e-4, and the same at a head-major width (256, 4 heads);
  8. DGDM-Large at full width (1024-d features, hidden (768, 512, 256, 128),
     16 heads x 8, 6 graph layers + the depth-2 U-Net, windowed attention and
     banded message passing with W=128) on 4 band-exact graphs of bucket 2048
     with 2000 real nodes: predict_batch, one /predict request, pretrain and
     finetune training steps and a validation step, each with its kernel
     launch counts, step time, peak memory, a profile, and f32 card-vs-CPU
     checks on 2 graphs.

It prints a ``{"kernels": [...]}`` JSON line, then the card's name and power
limit, and as its last line ``{"ok": true, "device": {...}}``. It exits
non-zero without a CUDA device or without the port beside it.
"""

from __future__ import annotations

import copy
import json
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
F32_FLOPS_PER_S = 67e12            # H100 SXM f32, outside the tensor cores
BF16_FLOPS_PER_S = 989e12          # H100 SXM bf16 tensor cores, dense
EXP_PER_S = 132 * 16 * 1.98e9      # H100 SXM special-function units (exp), 16/clk/SM at 1.98 GHz
# (B, N, K, F) of the gathers at the U-Net levels of DGDM-Base and DGDM-Large
MAIN_SHAPES = [(32, 1024, 8, 128), (32, 512, 8, 128), (32, 256, 8, 128)]
LARGE_SHAPES = [(4, 2048, 8, 128), (4, 1024, 8, 128), (4, 512, 8, 128)]
RAGGED_SHAPE = (32, 100, 5, 24)
# the pooled Base levels and a Large level with half the slots at node 0
HUB_SHAPES = [(32, 512, 8, 128), (32, 256, 8, 128), (4, 1024, 8, 128)]
K = 8
# The two model cells. ``layers`` counts the DynamicGraphLayers (Base: 4
# encoder + 5 U-Net, Large: 6 + 5); each launches one key gather and two conv
# aggregations per forward, and a training step adds one backward launch for
# each. Large is windowed + banded (W = 128) and its graphs are band-exact.
BASE = dict(preset="dgdm-base", label="DGDM-Base", batch=32, bucket=1024, n_real=1000,
            features=768, layers=9, window=None, dropout=0.1, pretrain_steps=8)
LARGE = dict(preset="dgdm-large", label="DGDM-Large", batch=4, bucket=2048, n_real=2000,
             features=1024, layers=11, window=128, dropout=0.15, pretrain_steps=8)
WARMUP_STEPS = 2


def expected_launches(cell: dict, training: bool) -> dict:
    """Launches of one forward (or one training step) of a model cell. A
    training step builds one transposed neighbor list per U-Net level (3 in
    both cells), a forward without a gradient none. No DGDMModel path reaches
    the flash kernels, as in the JAX package."""
    layers = cell["layers"]
    bwd = layers if training else 0
    return {"gather_rows": layers, "gather_agg": 2 * layers, "gather_rows_bwd": bwd,
            "gather_agg_bwd": 2 * bwd, "neighbor_transpose": 3 if training else 0,
            "flash_spatial_packed": 0, "flash_spatial": 0}


PORT_KERNEL_NAMES = ("gather_rows_kernel", "gather_agg_kernel", "gather_rows_bwd_kernel",
                     "gather_agg_bwd_kernel", "neighbor_transpose_kernel", "flash_spatial")
# sources whose ptxas report (registers, spills per kernel) the build phase prints
PTXAS_SOURCES = ("gather_rows_bwd", "gather_agg_bwd", "neighbor_transpose", "flash_spatial")
# (B, N, real nodes, H, D): DGDM-Base, DGDM-Large, a head-major width
FLASH_SHAPES = [(32, 1024, 1000, 8, 16), (4, 2048, 2000, 16, 8), (8, 1024, 1000, 4, 64)]


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def device_ms(torch, fn, reps: int = 20, trials: int = 21) -> float:
    """Device time of one call: a CUDA graph of ``reps`` calls replayed
    ``trials`` times between CUDA events; median of the per-call means."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    torch.cuda.empty_cache()
    return statistics.median(times)


def scatter_error(torch, out, ref32) -> dict:
    """A backward gather-sum kernel's result against the plain f32 sums
    ``ref32``. f32: atol = rtol = 1e-5 (the two sum in other orders). bf16:
    the kernel rounds its f32 sums once, so it is held to one bf16 ulp of the
    plain rounded result, plus the 1e-5 of the f32 sums near zero."""
    if out.dtype == torch.float32:
        err = (out - ref32).abs()
        ok = bool((err <= 1e-5 + 1e-5 * ref32.abs()).all())
        return {"ok": ok, "max_abs_err": err.max().item(), "max_ulp_err": None}
    ref = ref32.to(out.dtype).float()
    ulp = torch.ldexp(torch.ones_like(ref), torch.frexp(ref).exponent - 8)
    err = (out.float() - ref).abs()
    return {"ok": bool((err <= ulp + 1e-5).all()), "max_abs_err": err.max().item(),
            "max_ulp_err": (err / ulp.clamp_min(1e-5)).max().item()}


def csr_adjacency(torch, idx, w, dtype, transpose: bool = False):
    """The [B·N, B·N] CSR matrix A with A[b·N + n, b·N + idx[b, n, k]] summing
    w[b, n, k] over the in-range slots (A^T with ``transpose``): then
    ``A @ h`` is gather_agg and ``A^T @ g`` the dh half of its backward. The
    operand of the library yardstick, built outside its timing."""
    b, n, k = idx.shape
    valid = (idx >= 0) & (idx < n)
    base = n * torch.arange(b, device=idx.device).view(b, 1, 1)
    rows = (torch.arange(n, device=idx.device).view(1, n, 1) + base).expand(b, n, k)[valid]
    cols = (idx.long() + base)[valid]
    if transpose:
        rows, cols = cols, rows
    coo = torch.sparse_coo_tensor(torch.stack([rows, cols]), w[valid].to(dtype), (b * n, b * n))
    return coo.coalesce().to_sparse_csr()


def sparse_mm_ms(torch, idx, w, dense, transpose: bool = False) -> tuple:
    """(device ms, dtype) of ``torch.sparse.mm`` of the CSR adjacency with
    ``dense`` [B, N, F]: in dense's dtype where cuSPARSE takes it, else in
    f32 (the dtype is recorded beside the time)."""
    b, n, f = dense.shape
    for dtype in dict.fromkeys((dense.dtype, torch.float32)):
        x = dense.reshape(b * n, f).to(dtype)
        a = csr_adjacency(torch, idx, w, dtype, transpose)
        try:
            torch.sparse.mm(a, x)
            torch.cuda.synchronize()
        except RuntimeError as exc:          # this dtype is not taken: the next one
            log(f"library: torch.sparse.mm refuses {dtype}: {str(exc).splitlines()[0]}")
            continue
        return device_ms(torch, lambda: torch.sparse.mm(a, x)), str(dtype).replace("torch.", "")
    raise AssertionError("torch.sparse.mm took neither dtype")


def backward_checks(torch, gen, src, idx, w, tag, out: dict, timed: bool) -> None:
    """The transposed-list kernel and both backward kernels at one shape:
    the list bit-equal to its plain version, the backwards bit-identical from
    call to call and held to their plain f32 sums, through autograd, and
    (``timed``) their device times, bounds and library times appended to
    ``out["neighbor_transpose" | "gather_rows_bwd" | "gather_agg_bwd"]``."""
    from dgdm_histopath_torch.ops.kernels.gather_agg import (
        weighted_gather_sum, weighted_gather_sum_bwd, weighted_gather_sum_bwd_plain)
    from dgdm_histopath_torch.ops.kernels.gather_rows import (
        gather_rows, gather_rows_bwd, gather_rows_bwd_plain)
    from dgdm_histopath_torch.ops.kernels.neighbor_transpose import (
        neighbor_transpose, neighbor_transpose_plain)

    b, n, f = src.shape
    k = idx.shape[-1]
    e = src.element_size()
    g4 = torch.randn(b, n, k, f, device="cuda", generator=gen).to(src.dtype)
    g3 = torch.randn(b, n, f, device="cuda", generator=gen)
    nbr_t, plain_t = neighbor_transpose(idx), neighbor_transpose_plain(idx)
    torch.cuda.synchronize()
    if not (torch.equal(nbr_t.offsets, plain_t.offsets)
            and torch.equal(nbr_t.slots, plain_t.slots)):
        raise AssertionError(f"neighbor_transpose differs from its plain version at {tag}")
    dsrc = gather_rows_bwd(idx, g4, nbr_t)
    dh, dw = weighted_gather_sum_bwd(g3, src, idx, w, nbr_t=nbr_t)
    again = (gather_rows_bwd(idx, g4, nbr_t), *weighted_gather_sum_bwd(g3, src, idx, w,
                                                                       nbr_t=nbr_t))
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip((dsrc, dh, dw), again)):
        raise AssertionError(f"the backward kernels differ from call to call at {tag}")
    r = scatter_error(torch, dsrc, gather_rows_bwd_plain(idx, g4.float(), plain_t))
    ref_dh, dw_ref = weighted_gather_sum_bwd_plain(g3, src.float(), idx, w, plain_t)
    a = scatter_error(torch, dh, ref_dh)
    dw_err = (dw - dw_ref).abs().max().item()
    if not r["ok"]:
        raise AssertionError(f"gather_rows_bwd off its plain version: {r} at {tag}")
    if not (a["ok"] and torch.allclose(dw, dw_ref, atol=1e-5, rtol=1e-5)):
        raise AssertionError(f"gather_agg_bwd off its plain version: {a}, dw {dw_err} at {tag}")
    # each half alone, as needs_input_grad asks for it; the list built inside
    only_dh, none_dw = weighted_gather_sum_bwd(g3, src, idx, w, True, False)
    none_dh, only_dw = weighted_gather_sum_bwd(g3, src, idx, w, False, True)
    if not (none_dw is None and none_dh is None and torch.equal(only_dw, dw)
            and torch.equal(only_dh, dh) and torch.equal(gather_rows_bwd(idx, g4), dsrc)):
        raise AssertionError(f"gather_agg_bwd halves disagree with the whole at {tag}")
    a["max_abs_err"] = max(a["max_abs_err"], dw_err)

    # autograd through the wrappers (forward and backward kernels, the list
    # built inside), on a strided cotangent, against the plain backward
    # functions: plain autograd's scatter sums in g's dtype in no fixed
    # order, ~1e-4 off the exact sum of a hub row's ~2000 f32 terms
    s1, w1 = src.clone().requires_grad_(), w.clone().requires_grad_()
    (d_rows,) = torch.autograd.grad(gather_rows(s1, idx), s1, g4.permute(0, 1, 3, 2)
                                    .contiguous().permute(0, 1, 3, 2))   # strided g
    d_h, d_w = torch.autograd.grad(weighted_gather_sum(s1, idx, w1), (s1, w1), g3)
    p_rows = gather_rows_bwd_plain(idx, g4, plain_t)
    p_h, p_w = weighted_gather_sum_bwd_plain(g3, src, idx, w, plain_t)
    for name, got, want in (("gather_rows", d_rows, p_rows), ("gather_agg dh", d_h, p_h),
                            ("gather_agg dw", d_w, p_w)):
        chk = scatter_error(torch, got, want.float())
        if not (chk["ok"] and got.dtype == want.dtype):
            raise AssertionError(f"autograd through {name}: {chk} at {tag}")
    if not timed:
        return
    counts = (nbr_t.offsets[:, 1:] - nbr_t.offsets[:, :-1])
    tag = dict(tag, max_in_degree=int(counts.max()))
    flat_idx = (idx.long() + n * torch.arange(b, device="cuda").view(b, 1, 1)).reshape(-1)
    g_flat = g4.reshape(-1, f)
    valid_idx = torch.where((flat_idx >= 0) & (flat_idx < b * n), flat_idx, 0)
    rbytes = b * n * k * f * e + b * n * k * 4 + b * n * f * e
    t_bytes, t_ops = rbytes / HBM_BYTES_PER_S * 1e3, b * n * k * f / F32_FLOPS_PER_S * 1e3
    out["gather_rows_bwd"].append(dict(
        tag, max_abs_err=r["max_abs_err"], max_ulp_err=r["max_ulp_err"],
        ms=device_ms(torch, lambda: gather_rows_bwd(idx, g4, nbr_t)),
        plain_ms=device_ms(torch, lambda: gather_rows_bwd_plain(idx, g4, plain_t)),
        library_ms=device_ms(torch, lambda: torch.zeros(
            b * n, f, dtype=g4.dtype, device="cuda").index_add_(0, valid_idx, g_flat)),
        library="index_add_", bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations", bytes=rbytes))
    abytes = b * n * f * 4 + 2 * b * n * f * e + 3 * b * n * k * 4
    flops = 4 * b * n * k * f
    t_bytes, t_ops = abytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
    lib_ms, lib_dtype = sparse_mm_ms(torch, idx, w, g3, transpose=True)
    out["gather_agg_bwd"].append(dict(
        tag, max_abs_err=a["max_abs_err"], max_ulp_err=a["max_ulp_err"],
        ms=device_ms(torch, lambda: weighted_gather_sum_bwd(g3, src, idx, w, nbr_t=nbr_t)),
        plain_ms=device_ms(torch, lambda: weighted_gather_sum_bwd_plain(g3, src, idx, w,
                                                                        plain_t)),
        library_ms=lib_ms, library=f"torch.sparse.mm(A^T CSR, g) {lib_dtype}, dh half only",
        bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
        bytes=abytes, flops=flops))
    if src.dtype == torch.bfloat16:     # the list does not depend on the dtype
        tbytes = 2 * b * n * k * 4 + b * (n + 1) * 4
        out["neighbor_transpose"].append(dict(
            tag, max_abs_err=0.0, ms=device_ms(torch, lambda: neighbor_transpose(idx)),
            plain_ms=device_ms(torch, lambda: neighbor_transpose_plain(idx)),
            library_ms=None, bound_ms=tbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
            bytes=tbytes))


def log_kernel_rows(out: dict, names) -> None:
    for name in names:
        r = out[name][-1]
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        extra = f"  in-degree<={r['max_in_degree']}" if "max_in_degree" in r else ""
        log(f"kernel {name:18s} {str(r['shape']):20s} {r['dtype']:8s} "
            f"err {r['max_abs_err']:.2e}  ms {r['ms']:.4f}  plain {r['plain_ms']:.4f}"
            f"  library {lib}  bound {r['bound_ms']:.4f} ({r['bound_by']}){extra}"
            f"{'  ' + r['case'] if 'case' in r else ''}")


def kernel_phase(torch) -> dict:
    from dgdm_histopath_torch.ops.kernels.gather_agg import (
        weighted_gather_sum, weighted_gather_sum_plain)
    from dgdm_histopath_torch.ops.kernels.gather_rows import gather_rows, gather_rows_plain

    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {name: [] for name in ("gather_rows", "gather_agg", "gather_rows_bwd",
                                 "gather_agg_bwd", "neighbor_transpose")}
    for (b, n, k, f) in MAIN_SHAPES + LARGE_SHAPES + [RAGGED_SHAPE]:
        for dtype in (torch.bfloat16, torch.float32):
            e = torch.finfo(dtype).bits // 8
            src = torch.randn(b, n, f, device="cuda", generator=gen).to(dtype)
            idx = torch.randint(0, n, (b, n, k), device="cuda", generator=gen,
                                dtype=torch.int32)
            w = torch.rand(b, n, k, device="cuda", generator=gen)
            tag = dict(shape=[b, n, k, f], dtype=str(dtype).replace("torch.", ""))

            res = gather_rows(src, idx)
            torch.cuda.synchronize()
            if not torch.equal(res, gather_rows_plain(src, idx)):
                raise AssertionError(f"gather_rows differs from its plain version at {tag}")
            lib_idx = idx.long().reshape(b, n * k, 1).expand(b, n * k, f)
            rbytes = b * n * k * f * e + b * n * f * e + b * n * k * 4
            out["gather_rows"].append(dict(
                tag, max_abs_err=0.0,
                ms=device_ms(torch, lambda: gather_rows(src, idx)),
                plain_ms=device_ms(torch, lambda: gather_rows_plain(src, idx)),
                library_ms=device_ms(torch, lambda: torch.gather(src, 1, lib_idx)),
                library="torch.gather", bound_ms=rbytes / HBM_BYTES_PER_S * 1e3,
                bound_by="bytes", bytes=rbytes))

            agg = weighted_gather_sum(src, idx, w)
            ref = weighted_gather_sum_plain(src, idx, w)
            torch.cuda.synchronize()
            err = (agg - ref).abs().max().item()
            if not torch.allclose(agg, ref, atol=1e-5, rtol=1e-5):
                raise AssertionError(f"gather_agg off its plain version by {err} at {tag}")
            abytes = b * n * f * e + 2 * b * n * k * 4 + b * n * f * 4
            flops = 2 * b * n * k * f
            t_bytes = abytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / F32_FLOPS_PER_S * 1e3
            lib_ms, lib_dtype = sparse_mm_ms(torch, idx, w, src)
            out["gather_agg"].append(dict(
                tag, max_abs_err=err,
                ms=device_ms(torch, lambda: weighted_gather_sum(src, idx, w)),
                plain_ms=device_ms(torch, lambda: weighted_gather_sum_plain(src, idx, w)),
                library_ms=lib_ms, library=f"torch.sparse.mm(A CSR, h) {lib_dtype}",
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations", bytes=abytes,
                flops=flops))
            backward_checks(torch, gen, src, idx, w, tag, out, timed=True)
            log_kernel_rows(out, ("gather_rows", "gather_agg", "gather_rows_bwd",
                                  "gather_agg_bwd")
                            + (("neighbor_transpose",) if dtype == torch.bfloat16 else ()))

    # hub shapes: half the slots at node 0, as compact pooling leaves them
    for (b, n, k, f) in HUB_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            src = torch.randn(b, n, f, device="cuda", generator=gen).to(dtype)
            idx = torch.randint(0, n, (b, n, k), device="cuda", generator=gen,
                                dtype=torch.int32)
            idx[torch.rand(b, n, k, device="cuda", generator=gen) < 0.5] = 0
            w = torch.rand(b, n, k, device="cuda", generator=gen)
            tag = dict(shape=[b, n, k, f], dtype=str(dtype).replace("torch.", ""), case="hub")
            backward_checks(torch, gen, src, idx, w, tag, out, timed=True)
            log_kernel_rows(out, ("gather_rows_bwd", "gather_agg_bwd")
                            + (("neighbor_transpose",) if dtype == torch.bfloat16 else ()))

    # indices outside [0, N) give zero rows in both versions
    b, n, k, f = RAGGED_SHAPE
    src = torch.randn(b, n, f, device="cuda", generator=gen).to(torch.bfloat16)
    idx = torch.randint(-3, n + 3, (b, n, k), device="cuda", generator=gen,
                        dtype=torch.int32)
    w = torch.rand(b, n, k, device="cuda", generator=gen)
    res = gather_rows(src, idx)
    bad = (idx < 0) | (idx >= n)
    if not (torch.equal(res, gather_rows_plain(src, idx)) and bad.any()
            and (res[bad] == 0).all()):
        raise AssertionError("gather_rows: out-of-range indices must give zero rows")
    if not torch.allclose(weighted_gather_sum(src, idx, w),
                          weighted_gather_sum_plain(src, idx, w), atol=1e-5, rtol=1e-5):
        raise AssertionError("gather_agg: out-of-range indices must contribute nothing")
    for dtype in (torch.bfloat16, torch.float32):
        backward_checks(torch, gen, src.to(dtype), idx, w,
                        dict(shape=list(RAGGED_SHAPE), dtype=str(dtype), out_of_range=True),
                        out, timed=False)
    log("kernel checks: out-of-range indices give zero rows in the forward kernels, are "
        "dropped from the transposed list and add nothing in the backward kernels, as in "
        "the plain versions; the backward kernels are bit-identical from call to call")
    return out


def real_step_phase(torch, captured) -> dict:
    """The list kernel and both backward kernels (bf16, F 128) on the
    neighbor-index tensors of one real DGDM-Base pretrain step, one per U-Net
    level, with the hub rows that compact pooling leaves at node 0."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    out = {name: [] for name in ("gather_rows_bwd", "gather_agg_bwd", "neighbor_transpose")}
    for idx in captured:
        b, n, k = idx.shape
        src = torch.randn(b, n, 128, device="cuda", generator=gen).to(torch.bfloat16)
        w = torch.rand(b, n, k, device="cuda", generator=gen)
        tag = dict(shape=[b, n, k, 128], dtype="bfloat16", case="real Base step")
        backward_checks(torch, gen, src, idx, w, tag, out, timed=True)
        log_kernel_rows(out, ("neighbor_transpose", "gather_rows_bwd", "gather_agg_bwd"))
    return out


def morton_order(pos):
    """Order of the nodes along the Morton (Z-order) curve of their 16-bit
    quantised coordinates."""
    import numpy as np
    q = np.minimum((pos * 65536).astype(np.uint64), 65535)
    code = np.zeros(len(pos), np.uint64)
    for bit in range(16):
        code |= ((q[:, 0] >> np.uint64(bit)) & np.uint64(1)) << np.uint64(2 * bit)
        code |= ((q[:, 1] >> np.uint64(bit)) & np.uint64(1)) << np.uint64(2 * bit + 1)
    return np.argsort(code, kind="stable")


def flash_kernel_phase(torch) -> dict:
    """The two flash spatial-attention kernels on the card against their plain
    versions. f32 results are held to 1e-4 on valid rows (the kernel sums in
    another order and takes exp through the fast intrinsic). bf16: kernel and
    plain version each round their f32 result once, so where the two f32
    values (1e-4 apart at most) straddle a rounding boundary they differ by
    one bf16 ulp of that element (2^-9 for a value in [0.5, 1)); every
    element is held to its own ulp plus the 1e-4."""
    import torch.nn.functional as F
    from dgdm_histopath_torch.ops import kernels
    from dgdm_histopath_torch.ops.kernels import flash_spatial as fs

    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = {"flash_spatial_packed": [], "flash_spatial": []}

    def inputs(b, n, n_real, h, d, dtype):
        q, k, v = (torch.randn(b, n, h, d, device="cuda", generator=gen).to(dtype)
                   for _ in range(3))
        pos = torch.rand(b, n, 2, device="cuda", generator=gen)
        mask = torch.arange(n, device="cuda").expand(b, n) < n_real
        return q, k, v, pos, mask

    def versions(h, d, n):
        route = fs.flash_route(n, h, d)
        name = {"packed": "flash_spatial_packed", "headmajor": "flash_spatial"}[route]
        plain = fs.flash_spatial_packed_plain if route == "packed" else fs.flash_spatial_plain
        return name, plain

    def error(out, ref, mask, tag, atol=1e-4) -> float:
        ref32 = ref.float()
        tol = torch.full_like(ref32, atol)
        if out.dtype == torch.bfloat16:
            tol = tol + torch.ldexp(torch.ones_like(ref32), torch.frexp(ref32).exponent - 8)
        err = (out.float() - ref32).abs() * mask[:, :, None, None]
        if not ((err <= tol).all() and torch.isfinite(out).all() and out.dtype == ref.dtype):
            raise AssertionError(f"flash kernel off its plain version by {err.max().item()}, "
                                 f"{(err / tol).max().item():.2f} of the limit, at {tag}")
        return err.max().item()

    for (b, n, n_real, h, d) in FLASH_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            name, plain = versions(h, d, n)
            q, k, v, pos, mask = inputs(b, n, n_real, h, d, dtype)
            tag = dict(shape=[b, n, h, d], real_nodes=n_real,
                       dtype=str(dtype).replace("torch.", ""))
            before = kernels.KERNELS[name].launches
            out = fs.flash_spatial_attention(q, k, v, pos, mask, tau=0.1)
            torch.cuda.synchronize()
            if kernels.KERNELS[name].launches != before + 1:
                raise AssertionError(f"{name} was not launched at {tag}")
            err = error(out, plain(q, k, v, pos, mask, 0.1), mask, tag)
            error(out, fs.dense_reference(q, k, v, pos, mask, 0.1), mask, tag)

            # the library yardstick: SDPA with bias and mask as one additive
            # [B, 1, N, N] attn_mask (its construction timed apart)
            def make_attn_mask():
                bias = fs.distance_bias(pos, pos, 0.1)[:, None]
                return bias.masked_fill(~mask[:, None, None, :], float("-inf")).to(dtype)

            attn_mask = make_attn_mask()
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            lib = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=attn_mask).transpose(1, 2)
            lib_err = ((lib.float() - out.float()).abs() * mask[:, :, None, None]).max().item()
            e = q.element_size()
            nbytes = 4 * b * n * h * d * e + pos.numel() * 4 + mask.numel()
            flops = 4 * h * d * n * int(mask.sum().item())      # valid keys only
            peak = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else F32_FLOPS_PER_S
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
            rows[name].append(dict(
                tag, max_abs_err=err, library_abs_diff=lib_err,
                ms=device_ms(torch, lambda: fs.flash_spatial_attention(q, k, v, pos, mask)),
                plain_ms=device_ms(torch, lambda: plain(q, k, v, pos, mask, 0.1), 4, 7),
                library_ms=device_ms(torch, lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=attn_mask), 10, 11),
                library_mask_ms=device_ms(torch, make_attn_mask, 4, 7),
                dense_ms=device_ms(torch, lambda: fs.dense_reference(q, k, v, pos, mask, 0.1),
                                   4, 7),
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                f32_fma_ms=flops / F32_FLOPS_PER_S * 1e3, bytes=nbytes, flops=flops))
            r = rows[name][-1]
            # a reckoning for the log, not a measurement: one exp per (query,
            # head, key), every query row, the key tiles that hold a valid key
            # (64 keys a tile), at the data sheet's exp rate
            exp_floor_ms = b * n * h * min(n, -(-n_real // 64) * 64) / EXP_PER_S * 1e3
            log(f"kernel {name:20s} {str(tag['shape']):20s} {tag['dtype']:8s} err "
                f"{r['max_abs_err']:.2e}  ms {r['ms']:.4f}  plain {r['plain_ms']:.4f}  dense "
                f"{r['dense_ms']:.4f}  library {r['library_ms']:.4f} (+ mask "
                f"{r['library_mask_ms']:.4f}, differs {lib_err:.1e})  bound {r['bound_ms']:.4f} "
                f"({r['bound_by']}; as f32 FMAs {r['f32_fma_ms']:.4f}; exp floor "
                f"{exp_floor_ms:.4f})")
            del attn_mask, lib

    # a sharp bias, tau = 1e-3, bf16: the tensor-core kernels start q.k's
    # accumulator from the bias in units of the unscaled product (up to
    # 1.4 / (tau * scale) here), so they are held where it is largest, to the
    # reference's limit at this tau (5e-3) plus one bf16 ulp of each element
    sharp = {}
    for (b, n, n_real, h, d) in FLASH_SHAPES:
        name, plain = versions(h, d, n)
        q, k, v, pos, mask = inputs(b, n, n_real, h, d, torch.bfloat16)
        tag = f"{name} {[b, n, h, d]} bfloat16 tau 1e-3"
        before = kernels.KERNELS[name].launches
        out = fs.flash_spatial_attention(q, k, v, pos, mask, tau=1e-3)
        torch.cuda.synchronize()
        if kernels.KERNELS[name].launches != before + 1:
            raise AssertionError(f"{name} was not launched at {tag}")
        sharp[tag] = error(out, plain(q, k, v, pos, mask, 1e-3), mask, tag, atol=5e-3)
    log(f"kernel checks: flash bf16 at tau = 1e-3 within 5e-3 + 1 ulp of the plain versions, "
        f"largest errors {sharp}")

    # a graph without a valid node gives zeros; its neighbor in the batch is untouched
    for (h, d) in ((8, 16), (16, 8), (4, 64)):
        for dtype in (torch.bfloat16, torch.float32):
            name, plain = versions(h, d, 256)
            q, k, v, pos, mask = inputs(3, 256, 200, h, d, dtype)
            mask[1] = False
            out = fs.flash_spatial_attention(q, k, v, pos, mask)
            torch.cuda.synchronize()
            error(out, plain(q, k, v, pos, mask, 0.1), mask, f"{name} all-masked {dtype}")
            if not ((out[1] == 0).all() and (out[0] != 0).any() and (out[2] != 0).any()):
                raise AssertionError(f"{name}: an all-masked graph must give zeros")
            v2 = v.clone()
            v2[:, 200:] = 99.0                                  # masked value rows
            if not torch.equal(fs.flash_spatial_attention(q, k, v2, pos, mask)[:, :200],
                               out[:, :200]):
                raise AssertionError(f"{name}: masked value rows changed valid rows")
    # other widths of both kernels, both dtypes: true D, no padding in device
    # memory (the bf16 kernels pad D to 8 or to 16s in shared memory only);
    # N = 128 is the smallest N the route takes
    for (h, d) in ((1, 128), (2, 64), (32, 4), (3, 24), (2, 5), (1, 200), (2, 128), (8, 8),
                   (8, 16), (16, 8)):
        for dtype in (torch.bfloat16, torch.float32):
            name, plain = versions(h, d, 128)
            q, k, v, pos, mask = inputs(2, 128, 100, h, d, dtype)
            before = kernels.KERNELS[name].launches
            out = fs.flash_spatial_attention(q, k, v, pos, mask)
            torch.cuda.synchronize()
            if kernels.KERNELS[name].launches != before + 1:
                raise AssertionError(f"{name} was not launched at {h}x{d} {dtype}")
            error(out, plain(q, k, v, pos, mask, 0.1), mask, f"{name} {h}x{d} {dtype}")
    # N that does not tile takes the dense route: no launch, and it is counted
    q, k, v, pos, mask = inputs(2, 100, 90, 8, 16, torch.float32)
    before, dense_before = kernels.launch_counts(), fs.dense_route_calls()
    if not (torch.equal(fs.flash_spatial_attention(q, k, v, pos, mask),
                        fs.dense_reference(q, k, v, pos, mask, 0.1))
            and kernels.launch_counts() == before
            and fs.dense_route_calls() == dense_before + 1):
        raise AssertionError("N = 100 must take the dense route and be counted there")

    # gradients: the autograd.Function (kernel forward, dense-recompute
    # backward) against plain autograd through the plain version, f32
    grads = {}
    for (b, n, n_real, h, d) in ((4, 1024, 1000, 8, 16), (2, 2048, 2000, 16, 8),
                                 (2, 1024, 1000, 4, 64)):
        name, plain = versions(h, d, n)
        q, k, v, pos, mask = inputs(b, n, n_real, h, d, torch.float32)
        g = torch.randn(b, n, h, d, device="cuda", generator=gen) * mask[:, :, None, None]
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        got = torch.autograd.grad(fs.flash_spatial_attention(*leaves, pos, mask), leaves, g)
        want = torch.autograd.grad(plain(*leaves, pos, mask, 0.1), leaves, g)
        worst = max((a - w).abs().max().item() for a, w in zip(got, want))
        if not all(torch.allclose(a, w, atol=1e-4, rtol=1e-3) for a, w in zip(got, want)):
            raise AssertionError(f"{name}: gradients off plain autograd by {worst}")
        grads[name] = max(grads.get(name, 0.0), worst)
    log(f"kernel checks: flash kernels give zeros for an all-masked graph, ignore masked "
        f"value rows, take the true head width (1x128 ... 2x5, 8x8, bf16 and f32), leave N = "
        f"100 to the dense "
        f"route (counted, no launch); gradients within {grads} of plain autograd (atol 1e-4, "
        f"rtol 1e-3)")
    for name in rows:
        for r in rows[name]:
            r["grad_max_abs_err"] = grads[name]
    return rows


def flash_module_phase(torch, card: str) -> dict:
    """The flash path as a user reaches it: ``SpatialAttention(use_flash=True)``
    against the same module with ``use_flash=False``. The launch counters are
    set to 0 just before the counted forward and read just after it.

    Tolerances. f32: 2e-4 (the reference's own limit for this pair). bf16:
    the dense route stores its q·k products in bf16 before the softmax while
    the flash kernels keep them in f32, so weights differ by up to 2^-8
    relative per logit unit; on LayerNorm outputs of size O(1) the two are
    held to 0.1 at the worst element and 1e-2 on average."""
    from dgdm_histopath_torch.nn.attention import SpatialAttention
    from dgdm_histopath_torch.nn.layers import init_parameters
    from dgdm_histopath_torch.ops import kernels

    out = {}
    for name, embed, heads, b, n, n_real in (
            ("flash_spatial_packed", 128, 8, 32, 1024, 1000),
            ("flash_spatial", 256, 4, 8, 1024, 1000)):
        gen = torch.Generator(device="cuda").manual_seed(2)
        x32 = torch.randn(b, n, embed, device="cuda", generator=gen)
        pos = torch.rand(b, n, 2, device="cuda", generator=gen)
        mask = torch.arange(n, device="cuda").expand(b, n) < n_real
        res = {}
        for dtype, rows, worst_tol, mean_tol in ((torch.bfloat16, b, 0.1, 1e-2),
                                                 (torch.float32, 4, 2e-4, 2e-4)):
            flash = SpatialAttention(embed, heads, use_flash=True, dtype=dtype)
            init_parameters(flash, torch.Generator().manual_seed(3))
            dense = SpatialAttention(embed, heads, use_flash=False, dtype=dtype)
            dense.load_state_dict(flash.state_dict())
            flash, dense = flash.to("cuda").eval(), dense.to("cuda").eval()
            x = x32[:rows].to(dtype)
            args = (x, pos[:rows], mask[:rows])
            with torch.inference_mode():
                flash(*args), dense(*args)                       # warm up
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                kernels.reset_launch_counts()
                y_flash = flash(*args)
                torch.cuda.synchronize()
                counts = kernels.launch_counts()
                peak_flash = torch.cuda.max_memory_allocated() - base
                torch.cuda.reset_peak_memory_stats()
                y_dense = dense(*args)
                torch.cuda.synchronize()
                peak_dense = torch.cuda.max_memory_allocated() - base
                ms_flash = device_ms(torch, lambda: flash(*args), 5, 7)
                ms_dense = device_ms(torch, lambda: dense(*args), 5, 7)
            want = {k: int(k == name) for k in counts}
            if counts != want:
                raise AssertionError(f"SpatialAttention(use_flash=True) launches {counts}, "
                                     f"expected {want}")
            diff = (y_flash.float() - y_dense.float()).abs()
            worst, mean = diff.max().item(), diff.mean().item()
            if not (worst <= worst_tol and mean <= mean_tol and torch.isfinite(y_flash).all()):
                raise AssertionError(f"flash and dense modules differ by {worst} (mean {mean})")
            key = str(dtype).replace("torch.", "")
            res[key] = {"launches": counts, "max_abs_diff": worst, "mean_abs_diff": mean,
                        "flash_ms": ms_flash, "dense_ms": ms_dense,
                        "flash_peak_mib": peak_flash / 2 ** 20,
                        "dense_peak_mib": peak_dense / 2 ** 20, "batch": rows}
            log(f"flash module: SpatialAttention({embed}, {heads}) {key} B={rows} N={n}: "
                f"use_flash=True launches {name} x{counts[name]}, differs from the dense "
                f"module by {worst:.2e} (mean {mean:.2e}; limits {worst_tol}, {mean_tol}); "
                f"module forward {ms_flash:.3f} ms vs dense {ms_dense:.3f} ms, peak above "
                f"the inputs {peak_flash / 2 ** 20:.1f} vs {peak_dense / 2 ** 20:.1f} MiB "
                f"[{card}]")
        out[name] = res
    return out


def make_graphs(cell: dict, seed: int = 0):
    """The cell's graphs: ``n_real`` real nodes in its bucket, kNN (K=8) over
    random positions, edge_attr [d, exp(-10 d), 0] (the benchmark geometry).
    A windowed cell gets band-exact graphs: nodes in Morton order and the
    neighbors taken inside the ±1-block band of each node."""
    import numpy as np
    from dgdm_histopath_torch.ops.graph import build_padded_graph

    n_real, window = cell["n_real"], cell["window"]
    graphs = []
    for i in range(cell["batch"]):
        rs = np.random.RandomState(seed + i)
        x = rs.randn(n_real, cell["features"]).astype(np.float32)
        pos = rs.rand(n_real, 2).astype(np.float32)
        if window:
            pos = pos[morton_order(pos)]
        d2 = ((pos[:, None, :] - pos[None, :, :]) ** 2).sum(-1)
        np.fill_diagonal(d2, np.inf)
        if window:
            block = np.arange(n_real) // window
            d2[np.abs(block[:, None] - block[None, :]) > 1] = np.inf
        near = np.argpartition(d2, K, axis=1)[:, :K]
        near_d2 = np.take_along_axis(d2, near, axis=1)
        order = np.lexsort((near, near_d2), axis=-1)       # by distance, then index
        idx = np.take_along_axis(near, order, axis=1)
        dist = np.sqrt(np.take_along_axis(near_d2, order, axis=1))
        attr = np.stack([dist, np.exp(-10.0 * dist), np.zeros_like(dist)], -1)
        graphs.append(build_padded_graph(x, pos, idx, attr, np.ones((n_real, K), bool),
                                         bucket=cell["bucket"]))
    return graphs


def model_phase(torch, graphs, card: str, cell: dict) -> tuple:
    import numpy as np
    from dgdm_histopath_torch import DGDMPredictor, batch_graphs, create_model
    from dgdm_histopath_torch.ops import kernels
    from dgdm_histopath_torch.ops.graph import in_band_fraction

    label, batch_size, bucket = cell["label"], cell["batch"], cell["bucket"]
    model = create_model(cell["preset"], num_classes=2, compute_dtype="bfloat16",
                         device="cuda", seed=0)
    if (model.spatial_window, model.graph_window) != (cell["window"], cell["window"]):
        raise AssertionError(f"{label}: window options are not the preset's")
    if cell["window"]:
        frac = min(in_band_fraction(g.nbr_idx, g.nbr_mask, cell["window"]) for g in graphs)
        if frac != 1.0:
            raise AssertionError(f"{label}: graphs are not band-exact ({frac})")
    predictor = DGDMPredictor(model=model, device="cuda")

    # the main path, counted: one predict_batch of the cell's graphs
    expected = expected_launches(cell, training=False)
    kernels.reset_launch_counts()
    results = predictor.predict_batch(graphs)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    log(f"model: {label} predict_batch({len(graphs)}) launches {launches}")
    if launches != expected:
        raise AssertionError(f"kernel launches {launches}, expected {expected}")
    for r in results:
        p = r["probabilities"]
        if not (np.isfinite(p).all() and abs(float(p.sum()) - 1.0) < 1e-5):
            raise AssertionError(f"bad probabilities {p}")
        if not (np.isfinite(r["graph_embedding"]).all() and r["graph_embedding"].shape == (128,)
                and np.isfinite(r["attention_weights"]).all()
                and r["attention_weights"].shape == (bucket,)):
            raise AssertionError("non-finite or misshaped outputs")
        if abs(float(r["attention_weights"].sum()) - 1.0) > 1e-2:
            raise AssertionError("pooled attention does not sum to 1")

    # forward time on device-resident inputs; predict_batch end to end
    batch = batch_graphs(graphs).to("cuda")
    fwd = []
    for i in range(13):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        predictor.forward(batch)
        torch.cuda.synchronize()
        if i >= 3:
            fwd.append((time.perf_counter() - t0) * 1e3)
    e2e = []
    for _ in range(5):
        t0 = time.perf_counter()
        predictor.predict_batch(graphs)
        e2e.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.reset_peak_memory_stats()
    predictor.forward(batch)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    fwd_ms, e2e_ms = statistics.median(fwd), statistics.median(e2e)
    timing = {"forward_ms": fwd_ms, "forward_ms_all": fwd,
              "graphs_per_s": batch_size / fwd_ms * 1e3, "predict_batch_ms": e2e_ms,
              "predict_batch_graphs_per_s": batch_size / e2e_ms * 1e3,
              "peak_gib": peak_gib, "card": card}
    log(f"model: {label} bf16 batch {batch_size} bucket {bucket}: forward {fwd_ms:.3f} ms "
        f"({timing['graphs_per_s']:.1f} graphs/s), predict_batch {e2e_ms:.3f} ms "
        f"({timing['predict_batch_graphs_per_s']:.1f} graphs/s), peak {peak_gib:.2f} GiB "
        f"[{card}]")
    timing["profile"] = profile_call(torch, lambda: predictor.forward(batch),
                                     f"{label} forward")
    parity = card_vs_cpu(torch, graphs[:2], cell)
    return predictor, launches, timing, parity


def profile_call(torch, fn, what: str) -> dict:
    """Device time by kernel over one call of ``fn`` (torch.profiler): only the
    device-side kernel events are summed, not the CPU ops that launched them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(ev.self_device_time_total / 1e3, ev.count, ev.key)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0
            and not getattr(ev, "is_user_annotation", False)]   # ranges, not kernels
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    if not rows:
        log("profile: the profiler recorded no device time (not measured)")
        return {"wall_ms": wall_ms, "device_busy_ms": None, "top": []}
    ours = sum(r[0] for r in rows if any(name in r[2] for name in PORT_KERNEL_NAMES))
    n_kernels = sum(r[1] for r in rows)
    log(f"profile: one {what} {wall_ms:.3f} ms wall (profiled), {n_kernels} kernels "
        f"{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}% busy), of which the port's "
        f"own kernels {ours:.3f} ms ({100 * ours / busy_ms:.1f}% of device time)")
    for ms, count, key in rows[:15]:
        log(f"profile:   {ms:9.3f} ms  x{count:4d}  {key[:100]}")
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms, "gather_kernels_ms": ours,
            "kernel_launches": n_kernels,
            "top": [{"ms": ms, "count": c, "name": key} for ms, c, key in rows[:40]]}


def card_vs_cpu(torch, graphs, cell: dict) -> dict:
    """The same f32 model and state on the card (kernels) and on the CPU
    (plain versions): logits within 1e-3, pooled attention within 1e-4; with
    the attention weights asked for (the predictor's forward, dense spatial
    attention) and without (the windowed route where the cell has a window)."""
    from dgdm_histopath_torch import batch_graphs, create_model

    cpu_model = create_model(cell["preset"], num_classes=2, compute_dtype="float32",
                             device="cpu", seed=1)
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    batch = batch_graphs(graphs)

    def diff(a, b, key):
        return (a[key].cpu() - b[key]).abs().max().item()

    with torch.inference_mode():
        on_card = gpu_model(batch.to("cuda"), return_attention=True)
        on_cpu = cpu_model(batch, return_attention=True)
        d_logits = max(diff(on_card, on_cpu, "classification_logits"),
                       diff(gpu_model(batch.to("cuda")), cpu_model(batch),
                            "classification_logits"))
    d_attn = diff(on_card, on_cpu, "attention_weights")
    route = gpu_model.spatial_attention.route(cell["bucket"])
    log(f"parity: {cell['label']} f32 card vs CPU on 2 graphs: logits {d_logits:.3e} "
        f"(<= 1e-3, dense and {route} spatial attention), pooled attention {d_attn:.3e} "
        f"(<= 1e-4)")
    if not (d_logits <= 1e-3 and d_attn <= 1e-4):
        raise AssertionError("card and CPU disagree beyond tolerance")
    if route != ("window" if cell["window"] else "dense"):
        raise AssertionError(f"spatial attention took the {route} route")
    return {"logits_max_abs": d_logits, "attention_max_abs": d_attn}


def http_json(port: int, method: str, path: str, body=None):
    """One request to the local server; the decoded JSON of a 200 answer."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        data = None if body is None else json.dumps(body)
        conn.request(method, path, body=data,
                     headers={"Content-Type": "application/json"} if data else {})
        resp = conn.getresponse()
        payload = json.loads(resp.read())
    finally:
        conn.close()
    if resp.status != 200:
        raise AssertionError(f"{method} {path} -> {resp.status}: {payload}")
    return payload


def counted_request(port: int, path: str, body, cell: dict) -> tuple:
    """A POST with the launch counters set to 0 just before it and read just
    after: every request is one forward of the cell's model."""
    from dgdm_histopath_torch.ops import kernels

    expected = expected_launches(cell, training=False)
    kernels.reset_launch_counts()
    res = http_json(port, "POST", path, body)
    counts = kernels.launch_counts()
    if counts != expected:
        raise AssertionError(f"{path}: kernel launches {counts}, expected {expected}")
    return res, counts


def same_answer(a, b, atol: float, what: str) -> float:
    import numpy as np

    d = float(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32)).max())
    if d > atol:
        raise AssertionError(f"{what}: server differs from the predictor by {d}")
    return d


def checked_predict(port: int, predictor, graph, cell: dict) -> tuple:
    """One counted /predict of ``graph`` held against ``predict_graph``:
    (probability diff, launches, round trip ms). The predictor call that
    checks the answer comes after the counters are read."""
    from dgdm_histopath_torch.deployment.serving import graph_to_json

    t0 = time.perf_counter()
    res, counts = counted_request(port, "/predict", {"graph": graph_to_json(graph)}, cell)
    ms = (time.perf_counter() - t0) * 1e3
    ref = predictor.predict_graph(graph)
    diff = same_answer(res["probabilities"], ref["probabilities"], 1e-6, "/predict")
    same_answer(res["attention_weights"], ref["attention_weights"], 1e-6, "/predict attention")
    if res["predicted_class"] != ref["predicted_class"]:
        raise AssertionError("/predict class differs from predict_graph")
    return diff, counts, ms


def start_server(predictor, cell: dict):
    from dgdm_histopath_torch.deployment.serving import InferenceServer

    server = InferenceServer(predictor, port=0, host="127.0.0.1")
    server.start(background=True)
    try:
        if not http_json(server.port, "GET", "/healthz")["healthy"]:
            raise AssertionError("server reports unhealthy")
        if http_json(server.port, "GET", "/info")["node_features"] != cell["features"]:
            raise AssertionError("server /info is wrong")
    except BaseException:
        server.stop()
        raise
    return server


def server_phase(predictor, graphs, cell: dict) -> dict:
    """The server path of DGDM-Base, counted request by request: one /predict
    whose nbr_idx leaves [0, N), three /predict and one /predict_batch."""
    from dgdm_histopath_torch.deployment.serving import graph_to_json

    # a graph whose nbr_idx leaves [0, N): answered (zero rows), and the
    # requests after it prove the card's CUDA context survived it
    bad_idx = graphs[-1].nbr_idx.clone()
    bad_idx[0, 0], bad_idx[1, 1], bad_idx[2, 2] = -1, cell["bucket"], 10 ** 6
    bad = graphs[-1].replace(nbr_idx=bad_idx)

    server = start_server(predictor, cell)
    latencies, diffs, launches = [], [], []
    try:
        port = server.port
        res, counts = counted_request(port, "/predict", {"graph": graph_to_json(bad)}, cell)
        launches.append(counts)
        same_answer(res["probabilities"], predictor.predict_graph(bad)["probabilities"], 1e-6,
                    "/predict with out-of-range nbr_idx")
        for g in graphs[:3]:
            diff, counts, ms = checked_predict(port, predictor, g, cell)
            diffs.append(diff), launches.append(counts), latencies.append(ms)
        pair = graphs[3:5]
        res, counts = counted_request(port, "/predict_batch",
                                      {"graphs": [graph_to_json(g) for g in pair]}, cell)
        launches.append(counts)
        if res["count"] != len(pair):
            raise AssertionError("/predict_batch count is wrong")
        for r, b, g in zip(res["results"], predictor.predict_batch(pair), pair):
            same_answer(r["probabilities"], b["probabilities"], 1e-6, "/predict_batch")
            # batch 2 against batch 1 in bf16: GEMM tilings may differ
            diffs.append(same_answer(r["probabilities"],
                                     predictor.predict_graph(g)["probabilities"], 2e-2,
                                     "/predict_batch vs predict_graph"))
        stats = dict(server.stats)
    finally:
        server.stop()
    log(f"server: {cell['label']}: 1 /predict with out-of-range nbr_idx + 3 /predict + 1 "
        f"/predict_batch answered and agree with the predictor (max prob diff "
        f"{max(diffs):.2e}); launches per request {launches}; /predict round trip ms "
        f"{[round(x, 1) for x in latencies]}")
    if stats["requests"] != 5 or stats["errors"] != 0:
        raise AssertionError(f"server stats {stats}")
    return {"predict_ms": latencies, "max_prob_diff": max(diffs), "launches": launches}


def server_one_request(predictor, graph, cell: dict) -> dict:
    """One counted /predict of a full-width graph of ``cell`` (DGDM-Large)."""
    server = start_server(predictor, cell)
    try:
        diff, counts, ms = checked_predict(server.port, predictor, graph, cell)
        stats = dict(server.stats)
    finally:
        server.stop()
    log(f"server: {cell['label']}: 1 /predict answered and agrees with the predictor (prob "
        f"diff {diff:.2e}); launches {counts}; round trip {ms:.1f} ms")
    if stats["requests"] != 1 or stats["errors"] != 0:
        raise AssertionError(f"server stats {stats}")
    return {"predict_ms": [ms], "max_prob_diff": diff, "launches": [counts]}


def training_phase(torch, graphs, card: str, cell: dict, captured=None) -> tuple:
    """The training path, counted: DGDMTrainer.training_step on the cell's
    model at full width (DGDM-Base: batch 32, bucket 1024; DGDM-Large: batch
    4, bucket 2048, windowed attention and banded message passing). The
    launch counters are set to 0 just before one step and read just after.
    ``captured``, where given, receives the neighbor-index tensor of each
    transposed list that one more pretrain step builds (one per level)."""
    import math

    from dgdm_histopath_torch import DGDMTrainer, TrainerConfig, batch_graphs, create_model
    from dgdm_histopath_torch.ops import kernels
    from dgdm_histopath_torch.ops.kernels import neighbor_transpose as nt

    label, batch_size, steps = cell["label"], cell["batch"], cell["pretrain_steps"]
    expected_train = expected_launches(cell, training=True)
    batch = batch_graphs(graphs).to("cuda")

    def new_trainer():
        model = create_model(cell["preset"], num_classes=2, compute_dtype="bfloat16",
                             device="cuda", seed=0)
        trainer = DGDMTrainer(model, TrainerConfig(
            warmup_steps=WARMUP_STEPS, steps_per_epoch=steps, pretrain_epochs=1,
            max_epochs=2), device="cuda")
        trainer.init_state(seed=0, example_batch=batch)      # the band guard passes
        return trainer

    def counted_step(trainer, batch, epoch, expected):
        kernels.reset_launch_counts()
        metrics = trainer.training_step(batch, epoch)
        counts = kernels.launch_counts()
        if counts != expected:
            raise AssertionError(f"kernel launches {counts}, expected {expected}")
        bad = {k: v for k, v in metrics.items() if not math.isfinite(v)}
        if bad or not metrics["grad_norm"] > 0:
            raise AssertionError(f"training metrics {metrics}")
        return metrics, counts

    def snapshot(trainer):
        return [p.detach().clone() for p in trainer.model.parameters()]

    def moved(trainer, before) -> float:
        return max((p.detach() - q).abs().max().item()
                   for p, q in zip(trainer.model.parameters(), before))

    trainer = new_trainer()
    if trainer.model.dropout != cell["dropout"] or any(
            p.dtype != torch.float32 for p in trainer.model.parameters()):
        raise AssertionError(f"{label} must train with dropout {cell['dropout']} and f32 "
                             "parameters")

    # (a) pretrain steps; the first is the counted run of the main path
    before = snapshot(trainer)
    first, launches = counted_step(trainer, batch, 0, expected_train)
    if moved(trainer, before) != 0.0:
        raise AssertionError("the first update has learning rate 0 and must move nothing")
    again = new_trainer().training_step(batch, 0)
    if abs(again["loss"] - first["loss"]) > 1e-6 * abs(first["loss"]):
        raise AssertionError(f"same seed, other first loss: {first['loss']} {again['loss']}")
    log(f"training: {label} pretrain step 1 launches {launches}, metrics {first}; the same "
        f"seed gives loss {again['loss']}")
    step_ms, history = [], [first]
    for i in range(1, steps):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        metrics, _ = counted_step(trainer, batch, 0, expected_train)
        torch.cuda.synchronize()
        history.append(metrics)
        if i >= 2:                                   # two warm-up steps
            step_ms.append((time.perf_counter() - t0) * 1e3)
        if i == 1 and not moved(trainer, before) > 0.0:
            raise AssertionError("the second update must move the parameters")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    ms = statistics.median(step_ms)
    log(f"training: {label} bf16 batch {batch_size} bucket {cell['bucket']} pretrain step "
        f"{ms:.3f} ms median of {len(step_ms)} ({batch_size / ms * 1e3:.1f} graphs/s), peak "
        f"{peak_gib:.2f} GiB, loss {[round(m['loss'], 4) for m in history]} [{card}]")
    profile = profile_call(torch, lambda: trainer.training_step(batch, 0),
                           f"{label} pretrain step")
    if captured is not None:
        build = nt.neighbor_transpose

        def capture(idx):
            captured.append(idx.clone())
            return build(idx)

        nt.neighbor_transpose = capture
        try:
            trainer.training_step(batch, 0)
        finally:
            nt.neighbor_transpose = build
        log(f"training: {label} one pretrain step built lists for the index tensors "
            f"{[tuple(i.shape) for i in captured]}")

    # (b) finetune steps with labels, (c) one validation step
    labeled = batch.replace(y=torch.arange(batch_size, device="cuda") % 2)
    finetune = [counted_step(trainer, labeled, 1, expected_train)[0] for _ in range(2)]
    kernels.reset_launch_counts()
    val = trainer.validation_step(labeled, 1)
    if kernels.launch_counts() != expected_launches(cell, training=False):
        raise AssertionError(f"validation launches {kernels.launch_counts()}")
    val = {k: v.item() for k, v in val.items() if v.dim() == 0}
    if not all(math.isfinite(v) for v in val.values()) or "accuracy" not in val:
        raise AssertionError(f"validation metrics {val}")
    log(f"training: {label} finetune steps {finetune}; validation {val}")

    parity = train_step_card_vs_cpu(torch, graphs[:2], cell)
    timing = {"pretrain_step_ms": ms, "pretrain_step_ms_all": step_ms,
              "graphs_per_s": batch_size / ms * 1e3, "peak_gib": peak_gib, "card": card,
              "pretrain_loss": [m["loss"] for m in history],
              "grad_norm": [m["grad_norm"] for m in history],
              "finetune": finetune, "validation": val, "profile": profile}
    return launches, timing, parity


def train_step_card_vs_cpu(torch, graphs, cell: dict) -> dict:
    """One f32 pretrain step (dropout 0) with the same injected draws on the
    card (kernels, forward and backward) and on the CPU (plain versions):
    loss within 1e-4; every parameter's gradient within 1e-3 of that
    tensor's largest entry (tensors whose true gradient is zero, the key
    biases, are held to 1e-3 of a thousandth of the largest entry overall)."""
    from dgdm_histopath_torch import DGDMTrainer, TrainerConfig, batch_graphs, create_model

    batch = batch_graphs(graphs)
    gen = torch.Generator().manual_seed(0)
    n_graphs, n = batch.node_mask.shape
    draws = {"masked": (torch.rand(n_graphs, n, generator=gen) < 0.15) & batch.node_mask,
             "t": torch.randint(0, 10, (n_graphs,), generator=gen),
             "noise": torch.randn(n_graphs, n, 128, generator=gen),
             "uniform": torch.rand(n_graphs, n, generator=gen)}
    results = {}
    for device in ("cpu", "cuda"):
        model = create_model(cell["preset"], num_classes=2, compute_dtype="float32",
                             dropout=0.0, device=device, seed=1)
        trainer = DGDMTrainer(model, TrainerConfig(warmup_steps=WARMUP_STEPS), device=device)
        trainer.init_state(seed=0)
        metrics = trainer.training_step(batch, 0, draws={k: v.to(device)
                                                         for k, v in draws.items()})
        results[device] = (metrics, {k: p.grad.detach().cpu()
                                     for k, p in model.named_parameters()})
    (m_cpu, g_cpu), (m_card, g_card) = results["cpu"], results["cuda"]
    d_loss = abs(m_cpu["loss"] - m_card["loss"])
    floor = 1e-3 * max(g.abs().max().item() for g in g_cpu.values())
    worst, worst_key = 0.0, ""
    for key, ref in g_cpu.items():
        rel = (g_card[key] - ref).abs().max().item() / max(ref.abs().max().item(), floor)
        if rel > worst:
            worst, worst_key = rel, key
    log(f"parity: {cell['label']} f32 pretrain step card vs CPU on 2 graphs: loss "
        f"{m_card['loss']:.6f} vs {m_cpu['loss']:.6f} (diff {d_loss:.3e} <= 1e-4), worst gradient {worst:.3e} of its "
        f"tensor's largest entry ({worst_key}, <= 1e-3), grad_norm {m_card['grad_norm']:.4f} "
        f"vs {m_cpu['grad_norm']:.4f}")
    if not (d_loss <= 1e-4 and worst <= 1e-3):
        raise AssertionError("card and CPU training steps disagree beyond tolerance")
    return {"loss_abs_diff": d_loss, "worst_grad_rel": worst, "worst_grad": worst_key}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        from dgdm_histopath_torch.ops.kernels import build
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable here ({exc}); "
              "run it from the repository root", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"env: python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)} [{card}]")

    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"build: {sorted(libs)} in {time.perf_counter() - t0:.1f} s (nvcc, sm_90a)")
    ptxas = {name: build.ptxas_report(name) for name in PTXAS_SOURCES}
    for r in (r for rows in ptxas.values() for r in rows):
        log(f"ptxas: {r['kernel']}: {r['registers']} registers, spill stores "
            f"{r['spill_stores']} / loads {r['spill_loads']} bytes, stack {r['stack']}, "
            f"static smem {r['static_smem']}")

    kern = kernel_phase(torch)
    kern.update(flash_kernel_phase(torch))

    # DGDM-Base: serving, then training
    graphs = make_graphs(BASE)
    predictor, launches, timing, parity = model_phase(torch, graphs, card, BASE)
    server = server_phase(predictor, graphs, BASE)
    del predictor
    torch.cuda.empty_cache()
    captured = []
    train_launches, train_timing, train_parity = training_phase(torch, graphs, card, BASE,
                                                                captured)
    del graphs
    torch.cuda.empty_cache()
    real_step = real_step_phase(torch, captured)
    del captured
    torch.cuda.empty_cache()

    # the flash path, through the module a user would call
    flash_module = flash_module_phase(torch, card)
    torch.cuda.empty_cache()

    # DGDM-Large (windowed + banded): serving, then training
    large_graphs = make_graphs(LARGE, seed=100)
    predictor, l_launches, l_timing, l_parity = model_phase(torch, large_graphs, card, LARGE)
    l_server = server_one_request(predictor, large_graphs[0], LARGE)
    del predictor
    torch.cuda.empty_cache()
    l_train_launches, l_train_timing, l_train_parity = training_phase(
        torch, large_graphs, card, LARGE)

    replaces = {   # kernel -> (its source, the TPU code it stands in for)
        "gather_rows": ("gather_rows.cu", "dgdm_histopath_tpu/ops/pallas/gather_rows.py:56"),
        "gather_agg": ("gather_agg.cu", "dgdm_histopath_tpu/ops/pallas/gather_agg.py:36"),
        "gather_rows_bwd": ("gather_rows_bwd.cu",
                            "dgdm_histopath_tpu/ops/pallas/gather_rows.py:86"),
        "gather_agg_bwd": ("gather_agg_bwd.cu",
                           "dgdm_histopath_tpu/ops/pallas/gather_agg.py:101"),
        "neighbor_transpose": ("neighbor_transpose.cu",
                               "none: new, the list the backwards of "
                               "dgdm_histopath_tpu/ops/pallas/gather_rows.py:86 and "
                               "gather_agg.py:101 read"),
        "flash_spatial_packed": ("flash_spatial.cu",
                                 "dgdm_histopath_tpu/ops/pallas/flash_spatial.py:101"),
        "flash_spatial": ("flash_spatial.cu",
                          "dgdm_histopath_tpu/ops/pallas/flash_spatial.py:47"),
    }
    line = {"kernels": []}
    for name, (source, where) in replaces.items():
        main_shape = kern[name][0]                 # the first shape timed, bf16
        by_path = {"predict_batch": launches[name], "training_step": train_launches[name],
                   "large_predict_batch": l_launches[name],
                   "large_training_step": l_train_launches[name],
                   "spatial_attention_use_flash": (
                       flash_module[name]["bfloat16"]["launches"][name]
                       if name in flash_module else 0)}
        # max_abs_err is over the f32 comparisons; the bf16 backward results
        # and the bf16 flash results are held to one bf16 ulp of each element
        f32_rows = [r for r in kern[name] if r["dtype"] == "float32"
                    or name in ("gather_rows", "gather_agg", "neighbor_transpose")]
        # each kernel's own main path: the training step for the gathers, the
        # SpatialAttention(use_flash=True) forward for the flash kernels
        main_path = ("spatial_attention_use_flash" if name in flash_module
                     else "training_step")
        entry = {"name": name, "route": "cuda",
                 "source": f"dgdm_histopath_torch/csrc/{source}", "replaces": where,
                 "launches": by_path[main_path], "launches_by_path": by_path,
                 "max_abs_err": max(r["max_abs_err"] for r in f32_rows),
                 "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
                 "bound_ms": main_shape["bound_ms"], "bound_by": main_shape["bound_by"],
                 "library_ms": main_shape["library_ms"], "library": main_shape.get("library"),
                 "shape": ("B{} N{} H{} D{} bf16".format(*main_shape["shape"])
                           if name in flash_module else "B32 N1024 K8 F128 bf16")}
        if entry["launches"] < 1:
            raise AssertionError(f"{name} was launched no time on its main path")
        if "bwd" in name:
            entry["max_ulp_err_bf16"] = max(r["max_ulp_err"] for r in kern[name]
                                            if r["max_ulp_err"] is not None)
        if name in real_step:
            entry["real_step_ms"] = {r["shape"][1]: r["ms"] for r in real_step[name]}
        if name in flash_module:
            entry["max_abs_err_bf16"] = max(r["max_abs_err"] for r in kern[name]
                                            if r["dtype"] == "bfloat16")
            entry["all_shapes"] = kern[name]
        line["kernels"].append(entry)
    for t in (timing, train_timing, l_timing, l_train_timing):
        t["profile"].pop("top")           # printed above, one line per kernel
    log("details: " + json.dumps({"ptxas": ptxas, "kernels": kern, "real_step": real_step,
                                  "model": timing, "parity": parity, "server": server,
                                  "training": train_timing,
                                  "training_parity": train_parity,
                                  "flash_module": flash_module,
                                  "large": {"model": l_timing, "parity": l_parity,
                                            "server": l_server,
                                            "training": l_train_timing,
                                            "training_parity": l_train_parity}}))
    log(f"done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
