#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``dgdm_histopath_torch``) on one GPU and check it.

Run from the repository root with no arguments:  python3 chip_smoke.py

Phases, each of which raises on a failed check:
  1. environment: torch/CUDA versions and the card's name and power limit;
  2. build: nvcc builds every kernel under dgdm_histopath_torch/csrc/, and
     the registers, spills and static shared memory ptxas reported for each
     instantiation of the forward aggregation, backward, list and flash
     kernels;
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
     forward aggregation, the backward kernels and the list build timed on
     the three neighbor-index tensors of one real pretrain step;
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
     checks on 2 graphs;
  9. remat: three DGDM-Base pretrain steps with ``use_remat=True``
     against three with ``use_remat=False`` (the GraphEncoder layers
     checkpointed): equal losses and gradient norms, launch counts (the 4
     encoder layers' gathers run again in the backward), peak memory and
     device time of both;
 10. whole slide, last: a synthetic 20x slide (a 3 x 3 mosaic of 4096²
     fields made in worker processes, >= 1000 tissue patches) through
     ``DGDMPredictor(feature_extractor="dinov2", stain_normalize=True)``
     with DGDM-Base: the featurizer's throughput over 1024 patches against
     its bound, ``predict_slide`` pipelined and serial (9 + 18 gather
     launches each, the same prediction, the stage timings, peak memory),
     the two gathers at the slide graph's shape (B 1, N 1024, K 24) against
     their plain versions, Macenko's stain matrices, the kNN graph and the
     f32 featurizer on the card against the CPU, and one /predict_slide
     request over HTTP on a deflate-tiled TIFF;
 11. the training entry point, last: ``cli.train.main`` at DGDM-Base full
     width (batch 32, bucket 1024) on 160 graph files, two epochs, counted
     (every step 9 / 18 / 9 / 18 + 3 launches, every validation and test
     forward 9 / 18) with every output file; the same run stopped by
     SIGTERM inside epoch 0 (exit 75) and resumed, its final parameters
     equal to the bit; ``cli.predict.main`` on the bundle (9 / 18 a graph,
     probabilities equal to ``DGDMPredictor``'s); the loader's rate alone,
     ``fit``'s graphs/s and idle share against the resident-batch step, the
     checkpoint's blocking and background times; ``--dataset-type slide``
     on four small deflate-tiled TIFFs with the dinov2 featurizer;
 12. the serving entry point, last: DGDM-Base behind ``InferenceServer``
     with ``dynamic_batch=16`` after ``warmup(1024)``, 16 closed-loop
     clients sending 64 ``/predict`` of graph files (launches exactly 9 / 18
     a batch, each answer equal to the bit to ``predict_batch`` of its padded
     batch, ``/metrics`` checked), the same traffic serialized, the rate
     limit (4 of 10 requests answered, 6 refused with 429), ``python -m
     dgdm_histopath_torch.cli.serve`` as a process (ready, 16 answers,
     SIGTERM -> exit 0) and ``cli.predict --save-heatmaps`` where matplotlib
     is importable.
 13. the MoE tier (run after phase 9, on its graphs): DGDM-Base with the
     model section of configs/dgdm_base_moe.yaml (4 experts, top-1,
     capacity 1.5) at full width: predict_batch and one /predict (9 / 18
     launches), 8 pretrain + 2 finetune + 1 validation step (9 / 18 / 9 /
     18 + 3), step time, peak memory and profiles against the Base numbers
     of this run, the MoE block alone with its kernels by name, routing
     statistics at bf16, the f32 model on the card against the CPU (logits
     1e-3, aux loss 1e-5, routing equal), accumulate_grad_batches=2, and
     ``python -m dgdm_histopath_torch.cli.train train --config
     configs/dgdm_base_moe.yaml --dataset-type graph --batch-size 32`` (2
     epochs of 2 steps on 64 graph files) with the predict CLI on its bundle;
 14. data parallelism: 2 spawned ranks over gloo sharing the card (16
     graphs each) and 1 rank over NCCL take 3 f32 Base steps with injected
     draws, equal to one process on the global batch of 32; each rank's
     launches 9 / 18 / 9 / 18 + 3 a step.

It prints a ``{"kernels": [...]}`` JSON line, then the card's name and power
limit, and as its last line ``{"ok": true, "device": {...}}``. It exits
non-zero without a CUDA device or without the port beside it.

``python3 chip_smoke.py --dp-only`` on a machine of several cards runs the
build and phase 14 alone, with one NCCL rank a card, and then the train CLI
with ``--mesh-shape`` of all the cards: its bundle against one process's,
and a SIGTERM to the launcher, exit 75 and ``resume``, bit-equal.
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
            features=768, layers=9, encoder_layers=4, window=None, dropout=0.1,
            pretrain_steps=8)
LARGE = dict(preset="dgdm-large", label="DGDM-Large", batch=4, bucket=2048, n_real=2000,
             features=1024, layers=11, encoder_layers=6, window=128, dropout=0.15,
             pretrain_steps=8)
WARMUP_STEPS = 2
# The whole-slide cell: DGDM-Base behind the slide pipeline with the
# reference's defaults (256-px patches at 20x, at most 1000 a slide, the
# dinov2 ViT-B/16 featurizer at 224 in batches of 256, Macenko on the card,
# the 1024 bucket, 8 + 16 = 24 neighbours). The slide: a 3 x 3 mosaic of
# 4096² synthetic fields (12288² at level 0, 4 levels), 14 tissue blobs a
# field so that it yields well over 1000 tissue patches.
SLIDE = dict(preset="dgdm-base", fields=3, field_px=4096, levels=4, num_blobs=14,
             min_patches=1000, bucket=1024, k=24, throughput_patches=1024, http_px=2048)
# The training entry point's cells: DGDM-Base through ``cli.train.main`` on
# 160 graphs of the Base cell (0.8 / 0.1 / 0.1 split: 4 training batches of
# 32 an epoch, one validation and one test batch, each filled up), two
# epochs; and ``--dataset-type slide`` on four small deflate-tiled TIFFs.
CLI = dict(graphs=160, batch=32, epochs=2, slides=4, slide_px=1024, slide_patch=128,
           slide_bucket=64)
# The serving cell: DGDM-Base behind the README's ``dgdm-serve --dynamic-batch
# 16``: 64 graph files of the Base cell (1000 real nodes in bucket 1024, K = 8)
# read by ``graph_path`` under data_root, 16 closed-loop clients, a 5 ms
# batch window; the rate limit at 2 a second (burst 4) against 10 requests at
# once; the CLI as a process with batches of 8, 16 requests; heatmaps of 2.
SERVE = dict(graphs=64, clients=16, dynamic_batch=16, wait_ms=5.0, limit_rate=2.0,
             limit_requests=10, cli_batch=8, cli_requests=16, heatmap_graphs=2)
# The MoE cell: DGDM-Base with the model section of configs/dgdm_base_moe.yaml
# (4 experts, top-1, capacity 1.5, hidden 2 x 128) on the Base cell's graphs;
# its CLI run takes 64 graph files (0.7 / 0.15 / 0.15: 2 training batches of
# 32 an epoch, one validation and one test batch).
MOE = dict(BASE, label="DGDM-Base+MoE", config="configs/dgdm_base_moe.yaml",
           model=dict(moe_experts=4, moe_top_k=1, moe_capacity=1.5), graphs=64)
# The data-parallel cell: 2 ranks over gloo sharing the card, and one rank a
# card over NCCL; with ``--dp-only`` on several cards, the train CLI too, on
# 128 graph files (0.75 / 0.125 / 0.125: 3 training batches of 32 an epoch).
DP = dict(steps=3, cli_graphs=128, cli_epochs=4)


def expected_launches(cell: dict, training: bool, remat: bool = False) -> dict:
    """Launches of one forward (or one training step) of a model cell. A
    training step builds one transposed neighbor list per U-Net level (3 in
    both cells), a forward without a gradient none. With ``use_remat`` a
    training step runs the forward of each GraphEncoder layer again in its
    backward (one key gather, two conv aggregations each) and builds no list
    there. No DGDMModel path reaches the flash kernels, as in the JAX
    package."""
    layers = cell["layers"]
    bwd = layers if training else 0
    again = cell["encoder_layers"] if training and remat else 0
    return {"gather_rows": layers + again, "gather_agg": 2 * (layers + again),
            "gather_rows_bwd": bwd, "gather_agg_bwd": 2 * bwd,
            "neighbor_transpose": 3 if training else 0,
            "flash_spatial_packed": 0, "flash_spatial": 0}


PORT_KERNEL_NAMES = ("gather_rows_kernel", "gather_agg_kernel", "gather_rows_bwd_kernel",
                     "gather_agg_bwd_kernel", "neighbor_transpose_kernel", "flash_spatial")
# sources whose ptxas report (registers, spills per kernel) the build phase prints
PTXAS_SOURCES = ("gather_agg", "gather_rows_bwd", "gather_agg_bwd", "neighbor_transpose",
                 "flash_spatial")
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


def gather_rows_row(torch, src, idx, tag: dict) -> dict:
    """The key-gather kernel at one shape: bit-equal to its plain version,
    its device time, the plain version's and ``torch.gather``'s, and its
    bound (src and idx read once, the gathered rows written once)."""
    from dgdm_histopath_torch.ops.kernels.gather_rows import gather_rows, gather_rows_plain

    b, n, f = src.shape
    k = idx.shape[-1]
    e = src.element_size()
    res = gather_rows(src, idx)
    torch.cuda.synchronize()
    if not torch.equal(res, gather_rows_plain(src, idx)):
        raise AssertionError(f"gather_rows differs from its plain version at {tag}")
    lib_idx = idx.long().clamp(0, n - 1).reshape(b, n * k, 1).expand(b, n * k, f)
    rbytes = b * n * k * f * e + b * n * f * e + b * n * k * 4
    return dict(tag, max_abs_err=0.0,
                ms=device_ms(torch, lambda: gather_rows(src, idx)),
                plain_ms=device_ms(torch, lambda: gather_rows_plain(src, idx)),
                library_ms=device_ms(torch, lambda: torch.gather(src, 1, lib_idx)),
                library="torch.gather", bound_ms=rbytes / HBM_BYTES_PER_S * 1e3,
                bound_by="bytes", bytes=rbytes)


def gather_agg_row(torch, src, idx, w, tag: dict) -> dict:
    """The forward aggregation kernel at one shape: held to its plain version
    (1e-5: both sum K f32 terms, in other orders), its device time, the plain
    version's and the library call's (``torch.sparse.mm`` of the CSR
    adjacency), and its bound (each input read once, f32 out written once)."""
    from dgdm_histopath_torch.ops.kernels.gather_agg import (
        weighted_gather_sum, weighted_gather_sum_plain)

    b, n, f = src.shape
    k = idx.shape[-1]
    agg = weighted_gather_sum(src, idx, w)
    ref = weighted_gather_sum_plain(src, idx, w)
    torch.cuda.synchronize()
    err = (agg - ref).abs().max().item()
    if not torch.allclose(agg, ref, atol=1e-5, rtol=1e-5):
        raise AssertionError(f"gather_agg off its plain version by {err} at {tag}")
    abytes = b * n * f * src.element_size() + 2 * b * n * k * 4 + b * n * f * 4
    flops = 2 * b * n * k * f
    t_bytes = abytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    lib_ms, lib_dtype = sparse_mm_ms(torch, idx, w, src)
    return dict(tag, max_abs_err=err,
                ms=device_ms(torch, lambda: weighted_gather_sum(src, idx, w)),
                plain_ms=device_ms(torch, lambda: weighted_gather_sum_plain(src, idx, w)),
                library_ms=lib_ms, library=f"torch.sparse.mm(A CSR, h) {lib_dtype}",
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations", bytes=abytes,
                flops=flops)


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
            src = torch.randn(b, n, f, device="cuda", generator=gen).to(dtype)
            idx = torch.randint(0, n, (b, n, k), device="cuda", generator=gen,
                                dtype=torch.int32)
            w = torch.rand(b, n, k, device="cuda", generator=gen)
            tag = dict(shape=[b, n, k, f], dtype=str(dtype).replace("torch.", ""))

            out["gather_rows"].append(gather_rows_row(torch, src, idx, tag))
            out["gather_agg"].append(gather_agg_row(torch, src, idx, w, tag))
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
    """The forward aggregation kernel, the list kernel and both backward
    kernels (bf16, F 128) on the neighbor-index tensors of one real DGDM-Base
    pretrain step, one per U-Net level, with the slots that padding and
    pooling mask off pointed at -1 (``real_edge_index``)."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    out = {name: [] for name in ("gather_agg", "gather_rows_bwd", "gather_agg_bwd",
                                 "neighbor_transpose")}
    for idx in captured:
        b, n, k = idx.shape
        src = torch.randn(b, n, 128, device="cuda", generator=gen).to(torch.bfloat16)
        w = torch.rand(b, n, k, device="cuda", generator=gen)
        tag = dict(shape=[b, n, k, 128], dtype="bfloat16", case="real Base step")
        out["gather_agg"].append(gather_agg_row(torch, src, idx, w, tag))
        backward_checks(torch, gen, src, idx, w, tag, out, timed=True)
        log_kernel_rows(out, ("gather_agg", "neighbor_transpose", "gather_rows_bwd",
                              "gather_agg_bwd"))
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
                         device="cuda", seed=0, **cell.get("model", {}))
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
                             device="cpu", seed=1, **cell.get("model", {}))
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


def http_status(port: int, method: str, path: str, body=None) -> tuple:
    """One request to the local server: (status, body text)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request(method, path, body=None if body is None else json.dumps(body),
                     headers={"Content-Type": "application/json"} if body is not None else {})
        resp = conn.getresponse()
        return resp.status, resp.read().decode()
    finally:
        conn.close()


def http_json(port: int, method: str, path: str, body=None):
    """One request to the local server; the decoded JSON of a 200 answer."""
    status, text = http_status(port, method, path, body)
    if status != 200:
        raise AssertionError(f"{method} {path} -> {status}: {text[:2000]}")
    return json.loads(text)


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
                             device="cuda", seed=0, **cell.get("model", {}))
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


def remat_phase(torch, graphs, card: str, cell: dict) -> dict:
    """``use_remat=True`` against ``use_remat=False`` on the cell's pretrain
    step at full width, from one seed: each way, one counted step (the
    counters set to 0 just before it and read just after), a second step
    whose peak ``max_memory_allocated`` is kept, and a profiled third. Each
    step's loss and gradient norm are held equal between the two ways within
    1e-6 of their size (the recompute runs the same kernels on the same
    inputs and replays the same dropout draws). The first update has rate 0
    (warm-up), so a wrong recompute shows in the gradient norms of every
    step and, through the second update, in the third step's loss."""
    from dgdm_histopath_torch import DGDMTrainer, TrainerConfig, batch_graphs, create_model
    from dgdm_histopath_torch.ops import kernels

    batch = batch_graphs(graphs).to("cuda")
    res = {}
    for remat in (False, True):
        model = create_model(cell["preset"], num_classes=2, compute_dtype="bfloat16",
                             device="cuda", seed=0, use_remat=remat)
        trainer = DGDMTrainer(model, TrainerConfig(
            warmup_steps=WARMUP_STEPS, steps_per_epoch=cell["pretrain_steps"],
            pretrain_epochs=1, max_epochs=2), device="cuda")
        trainer.init_state(seed=0, example_batch=batch)
        kernels.reset_launch_counts()
        steps = [trainer.training_step(batch, 0)]
        launches = kernels.launch_counts()
        expected = expected_launches(cell, training=True, remat=remat)
        if launches != expected:
            raise AssertionError(f"use_remat={remat}: kernel launches {launches}, expected "
                                 f"{expected}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        steps.append(trainer.training_step(batch, 0))
        torch.cuda.synchronize()
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        profile = profile_call(torch, lambda: steps.append(trainer.training_step(batch, 0)),
                               f"{cell['label']} pretrain step, use_remat={remat}")
        profile.pop("top")
        res[remat] = {"launches": launches, "loss": [m["loss"] for m in steps],
                      "grad_norm": [m["grad_norm"] for m in steps], "peak_gib": peak_gib,
                      "profile": profile}
        del trainer, model
        torch.cuda.empty_cache()
    off, on = res[False], res[True]
    rel = {key: max(abs(a - b) / abs(b) for a, b in zip(on[key], off[key]))
           for key in ("loss", "grad_norm")}
    log(f"remat: {cell['label']} batch {cell['batch']} pretrain steps, use_remat on / off: "
        f"launches {on['launches']} / {off['launches']}; losses {on['loss']} / "
        f"{off['loss']}; gradient norms {on['grad_norm']} / {off['grad_norm']} (largest "
        f"relative difference {rel['loss']:.3e} / {rel['grad_norm']:.3e}, <= 1e-6); peak "
        f"{on['peak_gib']:.3f} / {off['peak_gib']:.3f} GiB; device "
        f"{on['profile']['device_busy_ms']} / {off['profile']['device_busy_ms']} ms in "
        f"{on['profile'].get('kernel_launches')} / {off['profile'].get('kernel_launches')} "
        f"kernels [{card}]")
    if max(rel.values()) > 1e-6:
        raise AssertionError(f"use_remat changes the steps: relative differences {rel}")
    return {"on": on, "off": off, "max_rel_diff": rel, "card": card}


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
                             dropout=0.0, device=device, seed=1, **cell.get("model", {}))
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


def slide_fixture() -> tuple:
    """The slide of the whole-slide cell: a mosaic of ``SLIDE["fields"]``²
    synthetic H&E fields (the port's generator, one seed each, rendered in
    worker processes), its pyramid in memory, objective power 20."""
    import multiprocessing as mp
    import os
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np
    from dgdm_histopath_torch.preprocessing.slide_io import ArrayBackend
    from dgdm_histopath_torch.preprocessing.synthetic import build_pyramid, generate_tissue_image

    t0 = time.perf_counter()
    n, px = SLIDE["fields"], SLIDE["field_px"]
    with ProcessPoolExecutor(max_workers=min(n * n, os.cpu_count() or 1),
                             mp_context=mp.get_context("spawn")) as pool:
        futures = [pool.submit(generate_tissue_image, px, px, num_blobs=SLIDE["num_blobs"],
                               seed=seed) for seed in range(n * n)]
        fields = [f.result()[0] for f in futures]
    level0 = np.concatenate([np.concatenate(fields[r * n:(r + 1) * n], 1) for r in range(n)], 0)
    del fields
    backend = ArrayBackend(build_pyramid(level0, SLIDE["levels"]),
                           properties={"openslide.objective-power": "20"})
    seconds = time.perf_counter() - t0
    log(f"slide: fixture {level0.shape[1]} x {level0.shape[0]}, {SLIDE['levels']} levels, "
        f"{n * n} fields of {px}² built in {seconds:.1f} s")
    return backend, seconds


def counted(torch, fn, expected: dict, what: str):
    """``fn()`` with the launch counters set to 0 just before it and read just
    after; fails unless they read ``expected``."""
    from dgdm_histopath_torch.ops import kernels

    kernels.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    if launches != expected:
        raise AssertionError(f"{what}: kernel launches {launches}, expected {expected}")
    return out, launches


def featurizer_throughput(torch, ext, patches_u8) -> dict:
    """The fused featurizer alone (upload excluded: the patches are on the
    card) over ``len(patches_u8)`` patches in batches of ``ext.batch_size``:
    CUDA events, median of 5 after 2 warm-ups; bound: the ViT's operations
    at the bf16 tensor-core peak."""
    from dgdm_histopath_torch.models.vit import vit_flops

    bs, n = ext.batch_size, len(patches_u8)

    def run():
        with torch.inference_mode():
            for i in range(0, n, bs):
                ext.fused_forward(patches_u8[i:i + bs])
    times = []
    for i in range(7):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        if i >= 2:
            times.append(start.elapsed_time(end))
    ms = statistics.median(times)
    flops = vit_flops() * n
    bound_ms = flops / BF16_FLOPS_PER_S * 1e3
    return {"patches": n, "ms": ms, "ms_all": times, "patches_per_s": n / ms * 1e3,
            "bound_ms": bound_ms, "bound_by": "operations", "flops": flops}


def slide_phase(torch, card: str, kern: dict) -> dict:
    """The whole-slide cell: DGDM-Base (seed 0, bf16) behind
    ``DGDMPredictor(feature_extractor="dinov2", stain_normalize=True)`` on a
    synthetic 20x slide of >= 1000 tissue patches. ``predict_slide``
    pipelined and serial, each counted (one DGDM-Base forward: 9 + 18 gather
    launches); the gathers at the slide graph's shape (B 1, N 1024, K 24)
    against their plain versions; Macenko, the kNN graph and the f32
    featurizer on the card against the CPU; one ``/predict_slide`` over
    HTTP; the featurizer's throughput."""
    import tempfile

    import numpy as np
    from dgdm_histopath_torch import DGDMPredictor, create_model
    from dgdm_histopath_torch.deployment.serving import InferenceServer
    from dgdm_histopath_torch.models.vit import PatchFeatureExtractor
    from dgdm_histopath_torch.ops.graph import real_edge_index
    from dgdm_histopath_torch.ops.knn import build_dual_knn
    from dgdm_histopath_torch.preprocessing import synthetic, tiff
    from dgdm_histopath_torch.preprocessing.slide_processor import SlideData
    from dgdm_histopath_torch.preprocessing.stain_normalization import estimate_stain_matrix

    backend, fixture_s = slide_fixture()
    model = create_model(SLIDE["preset"], num_classes=2, compute_dtype="bfloat16",
                         device="cuda", seed=0)
    predictor = DGDMPredictor(model=model, feature_extractor="dinov2", stain_normalize=True)
    proc, builder = predictor.processor, predictor.graph_builder
    mask, mask_ds = proc.detect_tissue_regions(backend)
    tissue = proc.generate_patch_coordinates(backend, mask, mask_ds)
    log(f"slide: {len(tissue)} tissue patches of {proc.patch_size} px at 20x (>= "
        f"{SLIDE['min_patches']} needed; max_patches {proc.max_patches} keeps "
        f"{min(len(tissue), proc.max_patches)})")
    if len(tissue) < SLIDE["min_patches"]:
        raise AssertionError(f"the slide yields {len(tissue)} tissue patches, fewer than "
                             f"{SLIDE['min_patches']}")
    infos = tissue
    if len(tissue) > proc.max_patches:       # the predictor's uniform subsample
        infos = [tissue[i] for i in np.linspace(0, len(tissue) - 1,
                                                proc.max_patches).astype(int)]
    patches = proc.extract_patch_batch(backend, infos)              # [1000, 256, 256, 3]
    ext = builder.extractor

    # the featurizer alone first (it warms every kernel of the path)
    reps = -(-SLIDE["throughput_patches"] // len(patches))
    on_card = torch.from_numpy(np.concatenate([patches] * reps)[:SLIDE["throughput_patches"]])
    on_card = on_card.to("cuda")
    throughput = featurizer_throughput(torch, ext, on_card)
    with torch.inference_mode():
        throughput["profile"] = profile_call(
            torch, lambda: ext.fused_forward(on_card[:ext.batch_size]),
            f"featurizer batch of {ext.batch_size} patches")
    del on_card
    log(f"slide: featurizer (Macenko + resize + ViT-B/16, bf16) {throughput['patches']} "
        f"patches in {throughput['ms']:.2f} ms ({throughput['patches_per_s']:.0f} patches/s), "
        f"bound {throughput['bound_ms']:.2f} ms ({throughput['flops'] / 1e12:.1f} TFLOP at "
        f"989 TFLOP/s) [{card}]")

    # the main path, counted: predict_slide pipelined, then serial
    expected = expected_launches(BASE, training=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    piped, launches = counted(torch, lambda: predictor.predict_slide(backend, slide_id="slide"),
                              expected, "predict_slide")
    piped_s = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    t0 = time.perf_counter()
    serial, _ = counted(torch, lambda: predictor.predict_slide(backend, slide_id="slide",
                                                               pipelined=False),
                        expected, "predict_slide(pipelined=False)")
    serial_s = time.perf_counter() - t0
    timings = piped["pipeline_timings"]
    d_prob = float(np.abs(piped["probabilities"] - serial["probabilities"]).max())
    log(f"slide: predict_slide launches {launches}; pipelined {piped_s:.3f} s, serial "
        f"{serial_s:.3f} s; stages (s) " + ", ".join(f"{k} {v:.4f}" for k, v in timings.items())
        + f"; peak {peak_gib:.2f} GiB; probabilities {piped['probabilities']} (serial differs "
        f"by {d_prob:.2e}) [{card}]")
    for r in (piped, serial):
        p = r["probabilities"]
        if not (np.isfinite(p).all() and abs(float(p.sum()) - 1.0) < 1e-5
                and r["num_patches"] == len(infos)
                and r["attention_weights"].shape == (SLIDE["bucket"],)
                and np.isfinite(r["graph_embedding"]).all()):
            raise AssertionError("predict_slide: non-finite or misshaped outputs")
    if d_prob > 1e-3 or piped["predicted_class"] != serial["predicted_class"]:
        raise AssertionError(f"pipelined and serial predict_slide differ by {d_prob}")

    # the two gathers at the slide graph's shape: uniform indices, and the
    # index tensor of this slide's graph as the model passes it
    features = ext.extract(patches)
    data = SlideData("slide", "", patches[:0], infos, proc.get_metadata(backend))
    graph = builder.build_graph(data, features=features)
    forward_profile = profile_call(torch, lambda: predictor.forward(graph.unsqueeze()),
                                   "slide graph forward (DGDM-Base, B 1, N 1024, K 24)")
    b, n, k, f = 1, SLIDE["bucket"], SLIDE["k"], 128
    if tuple(graph.nbr_idx.shape) != (n, k):
        raise AssertionError(f"slide graph neighbour list {tuple(graph.nbr_idx.shape)}")
    gen = torch.Generator(device="cuda").manual_seed(2)
    slide_idx = real_edge_index(graph.nbr_idx, graph.nbr_mask)[None].int().contiguous()
    uniform_idx = torch.randint(0, n, (b, n, k), device="cuda", generator=gen, dtype=torch.int32)
    rows = {"gather_rows": [], "gather_agg": []}
    for case, idx in (("uniform", uniform_idx), ("slide graph", slide_idx)):
        for dtype in (torch.bfloat16, torch.float32):
            src = torch.randn(b, n, f, device="cuda", generator=gen).to(dtype)
            w = torch.rand(b, n, k, device="cuda", generator=gen)
            tag = dict(shape=[b, n, k, f], dtype=str(dtype).replace("torch.", ""),
                       case=f"K 24, {case}")
            rows["gather_rows"].append(gather_rows_row(torch, src, idx, tag))
            rows["gather_agg"].append(gather_agg_row(torch, src, idx, w, tag))
            log_kernel_rows(rows, ("gather_rows", "gather_agg"))
    for name, r in rows.items():
        kern[name].extend(r)

    # the card against the CPU: Macenko's stain matrices, the kNN graph, the
    # f32 featurizer
    sub = torch.from_numpy(np.ascontiguousarray(patches[:64].reshape(64, -1, 3)[:, ::16]))
    d_stain = (estimate_stain_matrix(sub.cuda()).cpu() - estimate_stain_matrix(sub)).abs().max()
    pos = builder.normalize_coordinates(infos, backend.dimensions)
    pad = n - len(infos)
    args = [torch.from_numpy(np.pad(pos, ((0, pad), (0, 0)))),
            torch.from_numpy(np.pad(features, ((0, pad), (0, 0)))),
            torch.from_numpy(np.arange(n) < len(infos))]
    knn_cpu = build_dual_knn(*args)
    knn_card = build_dual_knn(*[a.cuda() for a in args])
    same_idx = torch.equal(knn_card["nbr_idx"].cpu(), knn_cpu["nbr_idx"])
    d_attr = (knn_card["edge_attr"].cpu() - knn_cpu["edge_attr"]).abs().max().item()
    kw = dict(arch="dinov2", stain_normalize_on_device=True, dtype="float32", seed=0)
    f_card = PatchFeatureExtractor(device="cuda", **kw).extract(patches[:8])
    f_cpu = PatchFeatureExtractor(device="cpu", **kw).extract(patches[:8])
    d_feat = float(np.abs(f_card - f_cpu).max() / np.abs(f_cpu).max())
    log(f"slide: card vs CPU: Macenko stain matrices of 64 patches {d_stain:.2e} (<= 1e-4); "
        f"kNN of {len(infos)} nodes neighbour lists equal {same_idx}, edge_attr {d_attr:.2e} "
        f"(<= 1e-5); f32 featurizer on 8 patches {d_feat:.2e} of its largest feature (<= 1e-3)")
    if not (d_stain <= 1e-4 and same_idx and d_attr <= 1e-5 and d_feat <= 1e-3):
        raise AssertionError("the slide path differs between the card and the CPU")

    # one /predict_slide over HTTP on a deflate-tiled TIFF written by the port
    with tempfile.TemporaryDirectory() as root:
        img, _ = synthetic.generate_tissue_image(SLIDE["http_px"], SLIDE["http_px"], seed=100,
                                                 num_blobs=SLIDE["num_blobs"])
        path = tiff.write_tiled_tiff(f"{root}/slide.tif", synthetic.build_pyramid(img, 3),
                                     tile=256, compression="deflate", bigtiff=True,
                                     description="Aperio synthetic|AppMag = 20|MPP = 0.5")
        server = InferenceServer(predictor, port=0, host="127.0.0.1", data_root=root)
        server.start(background=True)
        try:
            t0 = time.perf_counter()
            res, http_launches = counted(torch, lambda: http_json(
                server.port, "POST", "/predict_slide", {"slide_path": "slide.tif"}),
                expected, "/predict_slide")
            http_ms = (time.perf_counter() - t0) * 1e3
            stats = dict(server.stats)
        finally:
            server.stop()
        ref = predictor.predict_slide(path)
    predictor.close()
    d_http = same_answer(res["probabilities"], ref["probabilities"], 1e-6, "/predict_slide")
    if stats["requests"] != 1 or stats["errors"] != 0 or res["num_patches"] != ref["num_patches"]:
        raise AssertionError(f"/predict_slide: server stats {stats}")
    log(f"slide: /predict_slide of a {SLIDE['http_px']}² deflate-tiled TIFF ({res['num_patches']} "
        f"patches) answered in {http_ms:.1f} ms, launches {http_launches}, agrees with "
        f"predict_slide (prob diff {d_http:.2e}) [{card}]")
    return {"fixture_s": fixture_s, "tissue_patches": len(tissue), "launches": launches,
            "pipeline_timings": timings, "pipelined_s": piped_s, "serial_s": serial_s,
            "forward_profile": forward_profile,
            "serial_prob_diff": d_prob, "peak_gib": peak_gib, "featurizer": throughput,
            "card_vs_cpu": {"stain": float(d_stain), "knn_idx_equal": same_idx,
                            "knn_edge_attr": d_attr, "featurizer_f32_rel": d_feat},
            "http": {"ms": http_ms, "launches": http_launches, "prob_diff": d_http,
                     "num_patches": res["num_patches"]},
            "kernels_k24": rows, "card": card}


def write_cli_fixture(root: str) -> dict:
    """The graph-training cell's files under ``root``: CLI["graphs"] DGDM-Base
    graphs of ``make_graphs`` (1000 real nodes in bucket 1024, 768-d, K = 8,
    3 edge features) written by the port's ``save_graph``, a seeded two-class
    ``labels.json`` and a JSON config (splits, batch, epochs, csv logging)."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from dgdm_histopath_torch.data.graph_io import save_graph

    t0 = time.perf_counter()
    graphs = make_graphs(dict(BASE, batch=CLI["graphs"]), seed=1000)
    data = f"{root}/graphs"
    rs = np.random.RandomState(0)
    labels = {f"slide{i:03d}": int(v) for i, v in enumerate(rs.randint(0, 2, len(graphs)))}
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:   # zlib frees the GIL
        list(pool.map(lambda i: save_graph(graphs[i], f"{data}/slide{i:03d}_graph.npz"),
                      range(len(graphs))))
    with open(f"{root}/labels.json", "w") as f:
        json.dump(labels, f)
    cfg = {"experiment": {"name": "chip_smoke_cli"},
           "data": {"train_split": 0.8, "val_split": 0.1, "test_split": 0.1,
                    "batch_size": CLI["batch"]},
           "training": {"max_epochs": CLI["epochs"], "pretrain_epochs": 1,
                        "warmup_steps": WARMUP_STEPS},
           "logging": {"logger_type": "csv"}}
    with open(f"{root}/config.json", "w") as f:
        json.dump(cfg, f)
    seconds = time.perf_counter() - t0
    size = sum(os.path.getsize(f"{data}/{n}") for n in os.listdir(data))
    log(f"cli: fixture {len(graphs)} graphs ({size / 2 ** 20:.1f} MiB compressed) written "
        f"in {seconds:.1f} s")
    return {"data": data, "labels": f"{root}/labels.json", "config": f"{root}/config.json",
            "fixture_s": seconds, "fixture_mib": size / 2 ** 20}


def cli_expected(steps: int, forwards: int) -> dict:
    """Launches of ``steps`` Base training steps and ``forwards`` forwards
    without a gradient."""
    step, fwd = expected_launches(BASE, training=True), expected_launches(BASE, training=False)
    return {k: steps * step[k] + forwards * fwd[k] for k in step}


def bundle_params(path: str) -> dict:
    import numpy as np

    with np.load(path) as data:
        return {k: data[k] for k in data.files if k != "__meta__"}


def cli_phase(torch, card: str) -> dict:
    """The training entry point, ``dgdm_histopath_torch.cli.train.main``, at
    DGDM-Base full width (batch 32, bucket 1024), last:
    A) ``train`` on 160 graphs, two epochs (pretrain, finetune), counted:
       every training step 9 / 18 / 9 / 18 + 3 launches, every validation
       and test forward 9 / 18; every output file written;
    B) the same command stopped by SIGTERM in epoch 0 (exit 75, emergency
       checkpoint with its position), then ``resume``: the final parameters
       and the finetune epoch's summary equal to A's;
    the predict CLI on A's bundle over the test graphs (9 / 18 launches a
    graph, probabilities equal to ``DGDMPredictor.predict_graph``); the
    loader's rate alone, ``fit``'s graphs/s and the device's idle share over
    a profiled epoch against the resident-batch step; last, ``--dataset-type
    slide`` on four deflate-tiled TIFFs (the dinov2 featurizer on the card)."""
    import math
    import os
    import signal
    import tempfile
    import threading

    import numpy as np
    from dgdm_histopath_torch.cli import predict as predict_cli
    from dgdm_histopath_torch.cli import train as train_cli
    from dgdm_histopath_torch.data import HistopathDataModule, HistopathDataset, load_graph
    from dgdm_histopath_torch.evaluation.predictor import DGDMPredictor
    from dgdm_histopath_torch.ops import kernels
    from dgdm_histopath_torch.training import CheckpointManager, DGDMTrainer
    from dgdm_histopath_torch.utils.config import load_config

    managers = []                         # every CheckpointManager the runs make
    init = CheckpointManager.__init__

    def recording_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        managers.append(self)

    CheckpointManager.__init__ = recording_init
    out: dict = {"card": card}
    try:
        with tempfile.TemporaryDirectory() as root:
            fx = write_cli_fixture(root)
            out.update(fixture_s=fx["fixture_s"], fixture_mib=fx["fixture_mib"])
            argv = ["--preset", "dgdm-base", "--config", fx["config"], "--data-dir", fx["data"],
                    "--dataset-type", "graph", "--metadata", fx["labels"], "--num-classes", "2",
                    "--seed", "0", "--log-level", "WARNING"]
            cfg = load_config(fx["config"])
            dm = HistopathDataModule(HistopathDataset(fx["data"], metadata_path=fx["labels"]),
                                     batch_size=CLI["batch"], train_split=0.8, val_split=0.1,
                                     test_split=0.1, seed=0)
            n_train = len(dm.train_dataloader())
            steps = CLI["epochs"] * n_train
            forwards = CLI["epochs"] * len(dm.val_dataloader()) + len(dm.test_dataloader())
            if n_train != 4:
                raise AssertionError(f"{n_train} training batches an epoch, expected 4")

            # A: train, counted
            torch.cuda.reset_peak_memory_stats()
            a_dir = f"{root}/A"
            t0 = time.perf_counter()
            rc, launches = counted(torch, lambda: train_cli.main(
                ["train", *argv, "--output-dir", a_dir]), cli_expected(steps, forwards),
                "dgdm-train (run A)")
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            if rc != 0:
                raise AssertionError(f"run A exit code {rc}")
            for name in ("config_snapshot.yaml", "checkpoints/index.json", "logs/metrics.csv",
                         "logs/metrics.jsonl", "final_model.npz", "history.json"):
                if not os.path.exists(f"{a_dir}/{name}"):
                    raise AssertionError(f"run A wrote no {name}")
            with open(f"{a_dir}/history.json") as f:
                hist_a = json.load(f)
            if [h["phase"] for h in hist_a] != ["pretrain", "finetune"] or not all(
                    math.isfinite(v) for h in hist_a for v in h.values()
                    if isinstance(v, float)):
                raise AssertionError(f"run A history {hist_a}")
            saves = [t for m in managers for t in m.save_timings]
            out["A"] = {"rc": rc, "launches": launches, "steps": steps, "forwards": forwards,
                        "wall_s": wall, "epoch_s": [h["epoch_time_s"] for h in hist_a],
                        "fit_graphs_per_s": [h["steps"] * CLI["batch"] / h["epoch_time_s"]
                                             for h in hist_a],
                        "peak_gib": peak, "history": hist_a, "checkpoint_saves": saves}
            log(f"cli: A train rc {rc} in {wall:.1f} s ({steps} steps, {forwards} forwards), "
                f"launches {launches} as computed; epochs "
                f"{[round(h['epoch_time_s'], 3) for h in hist_a]} s, fit "
                f"{[round(g, 1) for g in out['A']['fit_graphs_per_s']]} graphs/s, peak "
                f"{peak:.2f} GiB; checkpoint saves (ms blocking / background, MiB) "
                f"{[(round(t['blocking_ms'], 1), round(t['background_ms'], 1), round(t['bytes'] / 2 ** 20, 1)) for t in saves]} [{card}]")

            # B: preempted by SIGTERM once the first backward ran, then resumed
            b_dir = f"{root}/B"
            kernels.reset_launch_counts()
            done = threading.Event()

            def watch():
                while not done.is_set():
                    if kernels.KERNELS["gather_agg_bwd"].launches > 0:
                        os.kill(os.getpid(), signal.SIGTERM)
                        return
                    time.sleep(0.0005)

            watcher = threading.Thread(target=watch, daemon=True)
            watcher.start()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            try:
                rc_b = train_cli.main(["train", *argv, "--output-dir", b_dir])
            finally:
                done.set()
                watcher.join(timeout=10)
            stopped_s = time.perf_counter() - t0
            position = CheckpointManager(f"{b_dir}/checkpoints").record_extra().get("resume", {})
            if rc_b != 75 or not position.get("mid_epoch") or not (
                    0 < position.get("step_in_epoch", 0) < n_train):
                raise AssertionError(f"run B exit code {rc_b}, resume record {position}")
            t0 = time.perf_counter()
            rc_r = train_cli.main(["resume", *argv, "--output-dir", b_dir, "--checkpoint-dir",
                                   f"{b_dir}/checkpoints"])
            resume_s = time.perf_counter() - t0
            peak_b = torch.cuda.max_memory_allocated() / 2 ** 30
            if rc_r != 0:
                raise AssertionError(f"resume exit code {rc_r}")
            pa, pb = bundle_params(f"{a_dir}/final_model.npz"), bundle_params(
                f"{b_dir}/final_model.npz")
            differ = [k for k in pa if not np.array_equal(pa[k], pb[k])]
            with open(f"{b_dir}/history.json") as f:
                hist_b = json.load(f)

            def summary(h):
                return {k: v for k, v in h.items() if k != "epoch_time_s"}

            if set(pa) != set(pb) or differ or summary(hist_b[-1]) != summary(hist_a[-1]):
                raise AssertionError(f"resumed run differs from run A: parameters {differ[:8]}, "
                                     f"finetune {hist_b[-1]} against {hist_a[-1]}")
            out["B"] = {"rc": rc_b, "resume": position, "stopped_wall_s": stopped_s,
                        "resume_rc": rc_r, "resume_wall_s": resume_s,
                        "epoch_s": [h["epoch_time_s"] for h in hist_b],
                        "fit_graphs_per_s": [(h["steps"] - (position["step_in_epoch"] if i == 0
                                                            else 0)) * CLI["batch"]
                                             / h["epoch_time_s"] for i, h in enumerate(hist_b)],
                        "peak_gib": peak_b, "parameters_equal": len(pa)}
            log(f"cli: B rc {rc_b} at {position} after {stopped_s:.1f} s, resume rc {rc_r} in "
                f"{resume_s:.1f} s (epochs {[round(h['epoch_time_s'], 3) for h in hist_b]} s, "
                f"fit {[round(g, 1) for g in out['B']['fit_graphs_per_s']]} graphs/s), peak "
                f"{peak_b:.2f} GiB; {len(pa)} parameters bit-equal to A, finetune summary equal")

            # predict on A's bundle over the test graphs
            test_files = [dm.dataset.files[i] for i in dm.test_dataloader().dataset.indices]
            test_dir = f"{root}/test"
            os.makedirs(test_dir)
            for p in test_files:
                os.symlink(p, f"{test_dir}/{p.name}")
            fwd = expected_launches(BASE, training=False)
            t0 = time.perf_counter()
            rc_p, p_launches = counted(torch, lambda: predict_cli.main(
                ["--model", f"{a_dir}/final_model.npz", "--input", test_dir, "--output-dir",
                 f"{root}/preds", "--format", "both", "--log-level", "WARNING"]),
                {k: len(test_files) * v for k, v in fwd.items()}, "dgdm-predict")
            predict_s = time.perf_counter() - t0
            predictor = DGDMPredictor(model_path=f"{a_dir}/final_model.npz")
            worst = 0.0
            for p in test_files:
                with open(f"{root}/preds/{p.stem}.json") as f:
                    got = np.asarray(json.load(f)["probabilities"])
                ref = predictor.predict_graph(load_graph(p))["probabilities"]
                worst = max(worst, float(np.abs(got - ref).max()))
            if rc_p != 0 or worst != 0.0 or not os.path.exists(f"{root}/preds/predictions.csv"):
                raise AssertionError(f"dgdm-predict rc {rc_p}, probabilities off by {worst}")
            out["predict"] = {"rc": rc_p, "graphs": len(test_files), "launches": p_launches,
                              "wall_s": predict_s, "max_abs_err": worst}
            log(f"cli: predict rc {rc_p} on {len(test_files)} graphs in {predict_s:.1f} s, "
                f"launches {p_launches}, probabilities equal to DGDMPredictor.predict_graph")
            del predictor

            out["rates"] = fit_rates(torch, cfg, fx)
            torch.cuda.empty_cache()
            out["slide"] = slide_training(torch, root)
    finally:
        CheckpointManager.__init__ = init
    return out


def fit_rates(torch, cfg, fx) -> dict:
    """The loader alone (cold: a new dataset inflates every file; warm: from
    its cache); ``fit``'s graphs/s over warm pretrain epochs of the loader,
    of the same batches stacked beforehand on the host and on the card, and
    a profiled epoch; the resident-batch pretrain step on the same trainer
    (median of 5 after 2) and its profile. ``cfg``: the run's config."""
    from dgdm_histopath_torch.data import HistopathDataModule, HistopathDataset
    from dgdm_histopath_torch.models.presets import PRESETS
    from dgdm_histopath_torch.training import DGDMTrainer

    def loader_rate(dm):
        t0 = time.perf_counter()
        n = sum(1 for _ in dm.train_dataloader())
        return n / (time.perf_counter() - t0)

    dm = HistopathDataModule(HistopathDataset(fx["data"], metadata_path=fx["labels"]),
                             batch_size=CLI["batch"], train_split=0.8, val_split=0.1,
                             test_split=0.1, seed=0)
    cold, warm = loader_rate(dm), loader_rate(dm)
    batch = next(iter(dm.train_dataloader()))
    for key, value in PRESETS["dgdm-base"].items():       # the run's model: the preset,
        setattr(cfg.model, key, list(value) if isinstance(value, tuple) else value)
    cfg.model.num_classes, cfg.model.edge_features = 2, batch.edge_attr.shape[-1]
    trainer = DGDMTrainer.from_config(cfg, device="cuda")
    trainer.init_state(0, batch)
    def fit_epochs(loader_fn, epochs: int) -> list:
        rates = []
        for _ in range(epochs):
            trainer.current_epoch = 0
            trainer.fit(loader_fn(), max_epochs=1)
            epoch = trainer.history[-1]
            rates.append(epoch["steps"] * CLI["batch"] / epoch["epoch_time_s"])
        return rates

    fit_gps = fit_epochs(dm.train_dataloader, 3)[1:]      # a warm-up epoch, then two timed
    # the feed taken apart: the same four batches stacked beforehand, on the
    # host (fit pins and uploads them) and on the card (fit's loop alone)
    host_batches = list(dm.train_dataloader())
    card_batches = [b.to(trainer.device) for b in host_batches]
    host_gps = fit_epochs(lambda: host_batches, 2)
    card_gps = fit_epochs(lambda: card_batches, 2)
    del host_batches, card_batches
    trainer.current_epoch = 0
    loader = dm.train_dataloader()
    fit_profile = profile_call(torch, lambda: trainer.fit(loader, max_epochs=1),
                               "fit epoch (4 pretrain steps of batch 32)")
    resident = batch.to(trainer.device)
    step_ms = []
    for i in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.training_step(resident, 0)
        torch.cuda.synchronize()
        if i >= 2:
            step_ms.append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(step_ms)
    step_profile = profile_call(torch, lambda: trainer.training_step(resident, 0),
                                "resident-batch pretrain step")

    def idle(profile):
        busy = profile["device_busy_ms"]
        return None if busy is None else 1.0 - busy / profile["wall_ms"]

    rates = {"loader_batches_per_s_cold": cold, "loader_batches_per_s_warm": warm,
             "fit_graphs_per_s_warm": fit_gps, "fit_graphs_per_s_host_batches": host_gps,
             "fit_graphs_per_s_card_batches": card_gps, "resident_step_ms": ms,
             "resident_step_ms_all": step_ms, "resident_graphs_per_s": CLI["batch"] / ms * 1e3,
             "idle_share_fit_epoch_profiled": idle(fit_profile),
             "idle_share_resident_step_profiled": idle(step_profile),
             "profile_fit_epoch": {k: v for k, v in fit_profile.items() if k != "top"},
             "profile_resident_step": {k: v for k, v in step_profile.items() if k != "top"}}

    def share(x):
        return "not measured" if x is None else f"{100 * x:.1f}%"

    log(f"cli: loader alone {cold:.2f} batches/s cold, {warm:.2f} warm; fit "
        f"{[round(g, 1) for g in fit_gps]} graphs/s over two warm epochs (stacked host batches "
        f"{[round(g, 1) for g in host_gps]}, batches on the card "
        f"{[round(g, 1) for g in card_gps]}) against {rates['resident_graphs_per_s']:.1f} for "
        f"the resident-batch step ({ms:.3f} ms median of 5); device idle {share(idle(fit_profile))} of a profiled fit epoch, "
        f"{share(idle(step_profile))} of a profiled resident step")
    return rates


def slide_training(torch, root: str) -> dict:
    """``--dataset-type slide`` on CLI["slides"] deflate-tiled TIFFs written by
    the port: the dinov2 featurizer on the card (768-d nodes, K = 24), batch
    2, one pretrain and one finetune epoch, counted."""
    import os

    import numpy as np
    from dgdm_histopath_torch.cli import train as train_cli
    from dgdm_histopath_torch.preprocessing import synthetic, tiff

    slides = f"{root}/slides"
    os.makedirs(slides)
    labels = {}
    for i in range(CLI["slides"]):
        img, _ = synthetic.generate_tissue_image(CLI["slide_px"], CLI["slide_px"], seed=200 + i,
                                                 num_blobs=SLIDE["num_blobs"])
        tiff.write_tiled_tiff(f"{slides}/case{i}.tif", synthetic.build_pyramid(img, 3),
                              tile=256, compression="deflate", bigtiff=True,
                              description="Aperio synthetic|AppMag = 20|MPP = 0.5")
        labels[f"case{i}"] = i % 2
    with open(f"{root}/slide_labels.json", "w") as f:
        json.dump(labels, f)
    cfg = {"data": {"train_split": 0.5, "val_split": 0.25, "test_split": 0.25, "batch_size": 2,
                    "patch_size": CLI["slide_patch"], "tissue_threshold": 0.5,
                    "node_buckets": [CLI["slide_bucket"]], "feature_extractor": "dinov2"},
           "training": {"max_epochs": 2, "pretrain_epochs": 1, "warmup_steps": WARMUP_STEPS},
           "logging": {"logger_type": "csv"}}
    with open(f"{root}/slide_config.json", "w") as f:
        json.dump(cfg, f)
    # 2 training slides (1 step an epoch), 1 validation and 1 test slide
    steps, forwards = 2, 2 + 1
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rc, launches = counted(torch, lambda: train_cli.main(
        ["train", "--preset", "dgdm-base", "--config", f"{root}/slide_config.json",
         "--data-dir", slides, "--dataset-type", "slide", "--metadata",
         f"{root}/slide_labels.json", "--num-classes", "2", "--seed", "0", "--output-dir",
         f"{root}/S", "--log-level", "WARNING"]), cli_expected(steps, forwards),
        "dgdm-train --dataset-type slide")
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    with open(f"{root}/S/history.json") as f:
        hist = json.load(f)
    if rc != 0 or [h["phase"] for h in hist] != ["pretrain", "finetune"]:
        raise AssertionError(f"slide run rc {rc}, history {hist}")
    with np.load(f"{root}/S/final_model.npz") as data:
        meta = json.loads(str(data["__meta__"]))
    log(f"cli: slide training rc {rc} in {wall:.1f} s on {CLI['slides']} {CLI['slide_px']}² "
        f"TIFFs (dinov2, node_features {meta['model_config']['node_features']}), launches "
        f"{launches} as computed; epochs {[round(h['epoch_time_s'], 3) for h in hist]} s, peak "
        f"{peak:.2f} GiB")
    return {"rc": rc, "launches": launches, "wall_s": wall, "peak_gib": peak,
            "epoch_s": [h["epoch_time_s"] for h in hist]}


def prometheus(port: int) -> dict:
    """``GET /metrics`` as {metric name: value}."""
    status, text = http_status(port, "GET", "/metrics")
    if status != 200:
        raise AssertionError(f"/metrics -> {status}")
    return {name: float(value) for name, value in
            (line.split() for line in text.splitlines() if line and not line.startswith("#"))}


def in_threads(fn, count: int, timeout: float = 600.0) -> float:
    """``fn(i)`` for i < count, each in its own thread, all started
    together; the first exception of any thread is raised here. Returns the
    wall seconds from the first start to the last join."""
    import threading

    errors = []

    def run(i):
        try:
            fn(i)
        except BaseException as exc:  # noqa: BLE001 - raised below, in the caller
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(count)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        raise AssertionError(f"{sum(t.is_alive() for t in threads)} client threads hang")
    if errors:
        raise errors[0]
    return wall


def closed_loop(port: int, names, clients: int) -> dict:
    """``clients`` closed-loop clients: client c sends /predict for
    ``names[c::clients]`` one after another. Every answer, its round trip,
    requests/s over the run, p50 and p99."""
    import numpy as np

    answers, lat = [None] * len(names), [0.0] * len(names)

    def client(c):
        for i in range(c, len(names), clients):
            t0 = time.perf_counter()
            answers[i] = http_json(port, "POST", "/predict", {"graph_path": names[i]})
            lat[i] = (time.perf_counter() - t0) * 1e3

    wall = in_threads(client, clients)
    return {"answers": answers, "latency_ms": lat, "wall_s": wall,
            "requests_per_s": len(names) / wall,
            "p50_ms": float(np.percentile(lat, 50)), "p99_ms": float(np.percentile(lat, 99))}


def serve_phase(torch, card: str) -> dict:
    """The serving entry point at DGDM-Base full width (seed 0, bf16), last:
    a bundle written by ``save_model_bundle`` and SERVE["graphs"] graph files
    of the Base cell's geometry under a temporary data_root, then
    1) ``InferenceServer(dynamic_batch=16, batch_wait_ms=5)`` after
       ``warmup(1024)``: 16 closed-loop clients send 64 ``/predict
       {"graph_path"}``; launches exactly 9 / 18 x the batches run; every
       answer equal to the bit to ``predict_batch`` of the padded batch it
       rode in (a spy records the batches, which run again afterwards);
       ``/metrics`` agrees with the batcher;
    2) the same traffic serialized (``dynamic_batch=0``): 9 / 18 a request,
       answers within 2e-2 of the batched ones (bf16, other batch sizes);
    3) ``rate_limit_per_s=2`` (burst 4): 10 requests at once, 4 answered 200
       and 6 answered 429, ``/metrics`` counting 4 requests and 0 errors;
    4) ``python -m dgdm_histopath_torch.cli.serve --dynamic-batch 8
       --warmup-nodes 1024`` as a process on a free port (``serve_cli``);
    5) ``cli.predict --save-heatmaps`` over 2 graphs, where matplotlib is
       importable: both files per graph."""
    import importlib.util
    import os
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from dgdm_histopath_torch import create_model
    from dgdm_histopath_torch.cli import predict as predict_cli
    from dgdm_histopath_torch.data.graph_io import save_graph
    from dgdm_histopath_torch.deployment import InferenceServer
    from dgdm_histopath_torch.evaluation.predictor import DGDMPredictor
    from dgdm_histopath_torch.models.presets import PRESETS
    from dgdm_histopath_torch.ops import kernels
    from dgdm_histopath_torch.training.checkpoint import save_model_bundle

    per_forward = expected_launches(BASE, training=False)
    out = {"card": card}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        model = create_model("dgdm-base", num_classes=2, compute_dtype="bfloat16",
                             device="cuda", seed=0)
        bundle = str(save_model_bundle(f"{root}/final_model.npz", model,
                                       dict(PRESETS["dgdm-base"], num_classes=2,
                                            compute_dtype="bfloat16")))
        del model
        graphs = make_graphs(dict(BASE, batch=SERVE["graphs"]), seed=3000)
        names = [f"graphs/s{i:03d}_graph.npz" for i in range(len(graphs))]
        with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:   # zlib frees the GIL
            list(pool.map(lambda i: save_graph(graphs[i], f"{root}/{names[i]}"),
                          range(len(graphs))))
        out["fixture_s"] = time.perf_counter() - t0
        predictor = DGDMPredictor(model_path=bundle)
        if predictor.device.type != "cuda":
            raise AssertionError(f"the predictor is on {predictor.device}")
        try:
            # 1) dynamic batching, counted, each answer held to its padded batch
            server = InferenceServer(predictor, port=0, host="127.0.0.1", data_root=root,
                                     dynamic_batch=SERVE["dynamic_batch"],
                                     batch_wait_ms=SERVE["wait_ms"], rate_limit_per_s=1e4)
            t0 = time.perf_counter()
            warmed = server.warmup(num_nodes=BASE["bucket"])
            torch.cuda.synchronize()
            out["warmup_s"] = time.perf_counter() - t0
            if warmed != 5:
                raise AssertionError(f"warmup ran {warmed} batch sizes, expected 5")
            recorded, busy = [], []
            real = predictor.predict_batch

            def spy(batch):
                t_call = time.perf_counter()
                results = real(batch)
                busy.append(time.perf_counter() - t_call)
                recorded.append((batch, results))
                return results

            predictor.predict_batch = spy
            server.start(background=True)
            try:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                kernels.reset_launch_counts()
                batched = closed_loop(server.port, names, SERVE["clients"])
                torch.cuda.synchronize()
                launches = kernels.launch_counts()
                peak = torch.cuda.max_memory_allocated() / 2 ** 30
                metrics = prometheus(server.port)
                stats = dict(server.batcher.stats)
            finally:
                server.stop()
                del predictor.predict_batch
            batches = int(stats["batches"])
            expected = {k: batches * v for k, v in per_forward.items()}
            if launches != expected or len(recorded) != batches:
                raise AssertionError(f"batched serving: launches {launches} over {batches} "
                                     f"batches ({len(recorded)} recorded), expected {expected}")
            want = {"dgdm_requests_total": len(names), "dgdm_errors_total": 0,
                    "dgdm_batches_total": batches,
                    "dgdm_batch_size_mean": round(len(names) / batches, 3),
                    "dgdm_batch_size_max": stats["max_batch_seen"]}
            if any(metrics[k] != v for k, v in want.items()) or stats["items"] != len(names):
                raise AssertionError(f"/metrics {metrics} against {want}, batcher {stats}")
            slot_of = {}
            for b, (batch, _) in enumerate(recorded):
                if len(batch) & (len(batch) - 1):
                    raise AssertionError(f"a batch of {len(batch)} is no power of two")
                for s, g in enumerate(batch):
                    slot_of.setdefault(g.x[0, :16].numpy().tobytes(), (b, s))
            fresh = [real(batch) for batch, _ in recorded]       # uncounted: the check
            for i, res in enumerate(batched["answers"]):
                b, s = slot_of[graphs[i].x[0, :16].numpy().tobytes()]
                for key in ("probabilities", "attention_weights", "graph_embedding"):
                    got = np.asarray(res[key], np.float32)
                    if not (np.array_equal(got, fresh[b][s][key])
                            and np.array_equal(got, recorded[b][1][s][key])):
                        raise AssertionError(f"answer {i} ({key}) differs from predict_batch "
                                             f"of its padded batch {b} slot {s}")
            out["batched"] = {k: v for k, v in batched.items() if k != "answers"}
            # the batcher thread's share of the run inside predict_batch (the
            # rest: waiting for the IO threads to read files and write answers)
            out["batched"].update({"batches": batches, "mean_batch": len(names) / batches,
                                   "max_batch": int(stats["max_batch_seen"]),
                                   "padded_sizes": [len(batch) for batch, _ in recorded],
                                   "predict_batch_ms": [1e3 * t for t in busy],
                                   "batcher_busy_share": sum(busy) / batched["wall_s"],
                                   "server_latency_ms": [1e3 * a["latency_s"]
                                                         for a in batched["answers"]],
                                   "launches": launches, "peak_gib": peak,
                                   "metrics": metrics})
            out["launches"] = launches

            # 2) the same traffic, serialized
            server = InferenceServer(predictor, port=0, host="127.0.0.1", data_root=root,
                                     rate_limit_per_s=1e4)
            server.start(background=True)
            try:
                kernels.reset_launch_counts()
                serial = closed_loop(server.port, names, SERVE["clients"])
                torch.cuda.synchronize()
                s_launches = kernels.launch_counts()
            finally:
                server.stop()
            expected = {k: len(names) * v for k, v in per_forward.items()}
            if s_launches != expected:
                raise AssertionError(f"serialized: launches {s_launches}, expected {expected}")
            d_serial = max(same_answer(a["probabilities"], b["probabilities"], 2e-2,
                                       "serialized vs batched /predict")
                           for a, b in zip(serial["answers"], batched["answers"]))
            out["serialized"] = {k: v for k, v in serial.items() if k != "answers"}
            out["serialized"]["server_latency_ms"] = [1e3 * a["latency_s"]
                                                      for a in serial["answers"]]
            out["serialized"].update({"launches": s_launches, "prob_diff_vs_batched": d_serial})
            out["batched_over_serialized"] = (batched["requests_per_s"]
                                              / serial["requests_per_s"])

            # 3) the rate limit: 2 a second, burst 4, 10 requests at once
            server = InferenceServer(predictor, port=0, host="127.0.0.1", data_root=root,
                                     dynamic_batch=SERVE["dynamic_batch"],
                                     batch_wait_ms=SERVE["wait_ms"],
                                     rate_limit_per_s=SERVE["limit_rate"])
            server.start(background=True)
            statuses = [None] * SERVE["limit_requests"]
            try:
                def limited(i):
                    statuses[i] = http_status(server.port, "POST", "/predict",
                                              {"graph_path": names[i]})[0]

                in_threads(limited, len(statuses))
                limit_metrics = prometheus(server.port)
            finally:
                server.stop()
            if sorted(statuses) != [200] * 4 + [429] * 6 or \
                    limit_metrics["dgdm_requests_total"] != 4 or \
                    limit_metrics["dgdm_errors_total"] != 0:
                raise AssertionError(f"rate limit: statuses {statuses}, /metrics {limit_metrics}")
            out["rate_limit"] = {"statuses": statuses, "metrics": limit_metrics}

            # 4) dgdm-serve as a process on a free port, stopped by SIGTERM
            out["cli"] = serve_cli(bundle, root, names, graphs, predictor)

            # 5) dgdm-predict --save-heatmaps over 2 graphs
            has_mpl = importlib.util.find_spec("matplotlib") is not None
            has_plotly = importlib.util.find_spec("plotly") is not None
            log(f"serve: probe: matplotlib {'importable' if has_mpl else 'absent'}, plotly "
                f"{'importable' if has_plotly else 'absent'}")
            out["probe"] = {"matplotlib": has_mpl, "plotly": has_plotly}
            if has_mpl:
                heat_in = f"{root}/heat_in"
                os.makedirs(heat_in)
                picked = names[:SERVE["heatmap_graphs"]]
                for n in picked:
                    shutil.copy(f"{root}/{n}", heat_in)
                t0 = time.perf_counter()
                rc = predict_cli.main(["--model", bundle, "--input", heat_in, "--output-dir",
                                       f"{root}/heat_out", "--save-heatmaps", "--class-names",
                                       "benign,tumour", "--log-level", "WARNING"])
                heat_s = time.perf_counter() - t0
                files = sorted(os.listdir(f"{root}/heat_out"))
                want = sorted(f"{os.path.basename(n)[:-4]}{ext}" for n in picked
                              for ext in (".json", "_summary.png", "_summary.html"))
                if rc != 0 or files != want:
                    raise AssertionError(f"--save-heatmaps: rc {rc}, files {files}")
                out["heatmaps"] = {"rc": rc, "files": files, "s": heat_s}
        finally:
            predictor.close()
    b, s = out["batched"], out["serialized"]
    log(f"serve: DGDM-Base dgdm-serve --dynamic-batch {SERVE['dynamic_batch']}, "
        f"{SERVE['clients']} clients, {len(names)} graph_path requests: batched "
        f"{b['requests_per_s']:.1f} requests/s, p50 {b['p50_ms']:.1f} ms, p99 "
        f"{b['p99_ms']:.1f} ms, {b['batches']} batches (mean {b['mean_batch']:.2f}, max "
        f"{b['max_batch']}, padded {b['padded_sizes']}), predict_batch ms "
        f"{[round(t, 1) for t in b['predict_batch_ms']]} (the batcher busy "
        f"{100 * b['batcher_busy_share']:.0f}% of the run), launches {b['launches']}, peak "
        f"{b['peak_gib']:.2f} GiB; serialized {s['requests_per_s']:.1f} requests/s, p50 "
        f"{s['p50_ms']:.1f} ms, p99 {s['p99_ms']:.1f} ms, in the server "
        f"{statistics.median(s['server_latency_ms']):.1f} ms median; batched / serialized "
        f"{out['batched_over_serialized']:.2f}x; rate limit "
        f"{sorted(out['rate_limit']['statuses'])}; CLI ready {out['cli']['ready_s']:.1f} s, "
        f"stop {out['cli']['stop_s']:.2f} s (exit 0); heatmaps "
        f"{'written' if 'heatmaps' in out else 'not run: no matplotlib'}; fixture "
        f"{out['fixture_s']:.1f} s, warmup {out['warmup_s']:.2f} s [{card}]")
    return out


def serve_cli(bundle: str, root: str, names, graphs, predictor) -> dict:
    """``python -m dgdm_histopath_torch.cli.serve`` on a free port: wait for
    ``/readyz``, 16 concurrent ``/predict`` within 2e-2 of ``predict_graph``,
    ``/metrics`` and ``/info``, then SIGTERM: exit 0 within 30 s. The
    server's log is printed when a step fails."""
    import os
    import signal
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    cmd = [sys.executable, "-m", "dgdm_histopath_torch.cli.serve", "--model", bundle,
           "--port", str(port), "--data-root", root, "--dynamic-batch", str(SERVE["cli_batch"]),
           "--warmup-nodes", str(BASE["bucket"]), "--rate-limit", "1000"]
    log_path = f"{root}/serve_cli.log"
    t0 = time.perf_counter()
    with open(log_path, "w") as log_file:
        proc = subprocess.Popen(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                                stdout=log_file, stderr=subprocess.STDOUT)
    try:
        while True:
            if proc.poll() is not None:
                raise AssertionError(f"dgdm-serve exited {proc.returncode} before it was ready")
            try:
                if http_status(port, "GET", "/readyz")[0] == 200:
                    break
            except OSError:
                pass
            if time.perf_counter() - t0 > 300:
                raise AssertionError("dgdm-serve was not ready within 300 s")
            time.sleep(0.25)
        ready_s = time.perf_counter() - t0
        count = SERVE["cli_requests"]
        answers = [None] * count

        def call(i):
            answers[i] = http_json(port, "POST", "/predict", {"graph_path": names[i]})

        wall = in_threads(call, count)
        diff = max(same_answer(a["probabilities"], predictor.predict_graph(g)["probabilities"],
                               2e-2, "dgdm-serve /predict vs predict_graph")
                   for a, g in zip(answers, graphs))
        status, text = http_status(port, "GET", "/metrics")
        info = http_json(port, "GET", "/info")
        if status != 200 or f"dgdm_requests_total {count}\n" not in text or \
                info["serving_stats"]["requests"] != count or info["device"] != "cuda":
            raise AssertionError(f"dgdm-serve /metrics or /info: {text!r} {info}")
        t1 = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=30)
        stop_s = time.perf_counter() - t1
        with open(log_path) as f:
            server_log = f.read()
        if rc != 0 or f"inference server on :{port}" not in server_log or \
                "server stopped" not in server_log:
            raise AssertionError(f"dgdm-serve exit {rc}")
    except BaseException:
        with open(log_path) as f:
            log("serve: dgdm-serve log:\n" + f.read()[-4000:])
        raise
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    log(f"serve: dgdm-serve (port {port}) ready in {ready_s:.1f} s, {count} concurrent /predict "
        f"in {wall:.2f} s (max prob diff vs predict_graph {diff:.2e}), SIGTERM -> exit {rc} "
        f"in {stop_s:.2f} s")
    return {"ready_s": ready_s, "requests": count, "wall_s": wall, "prob_diff": diff,
            "rc": rc, "stop_s": stop_s}


def yaml_model_matches(model, cfg) -> None:
    """The model has every DGDMModel option of the config's model section."""
    import dataclasses

    wanted = {f.name: getattr(cfg.model, f.name) for f in dataclasses.fields(cfg.model)
              if hasattr(model, f.name) and f.name not in ("num_classes", "edge_features")}
    got = {k: getattr(model, k) for k in wanted}
    wanted["hidden_dims"] = list(wanted["hidden_dims"])
    got["hidden_dims"] = list(got["hidden_dims"])
    if got != wanted:
        raise AssertionError(f"model options {got} are not the config's {wanted}")


def moe_inputs(model, batch) -> tuple:
    """(outputs, the MoE block's input, its token mask) of a forward."""
    seen = []
    hook = model.moe_ffn.register_forward_hook(lambda m, args, out: seen.append(args[:2]))
    try:
        out = model(batch)
    finally:
        hook.remove()
    return out, seen[0][0], seen[0][1]


def routing_stats(torch, model, batch) -> dict:
    """Tokens each expert takes, dropped real tokens and the aux loss of one
    forward of ``batch``."""
    with torch.inference_mode():
        out, x, mask = moe_inputs(model, batch)
        r = model.moe_ffn.route(x, mask)
    kept = r["kept"].sum((0, 1))
    real = float(r["mask"].sum())
    dropped = float(((r["kept"].sum(-1) == 0).float() * r["mask"]).sum())
    return {"tokens_per_expert": kept.tolist(),
            "first_choice_per_expert": r["first_choice"].sum((0, 1)).tolist(),
            "real_tokens": real, "dropped_tokens": dropped,
            "dropped_share": dropped / max(real, 1.0),
            "capacity_per_group": int(r["dispatch"].shape[-1]),
            "groups": int(r["dispatch"].shape[0]), "aux_loss": float(out["moe_aux_loss"])}


def moe_card_vs_cpu(torch, graphs) -> dict:
    """The f32 MoE model on the card against the CPU on 2 graphs: logits
    within 1e-3, the aux loss within 1e-5, each token's expert and the
    kept tokens equal."""
    from dgdm_histopath_torch import batch_graphs, create_model

    cpu = create_model("dgdm-base", num_classes=2, compute_dtype="float32", device="cpu",
                       seed=1, **MOE["model"])
    card = copy.deepcopy(cpu).to("cuda")
    batch = batch_graphs(graphs)
    with torch.inference_mode():
        o_cpu, x_cpu, m_cpu = moe_inputs(cpu, batch)
        o_card, x_card, m_card = moe_inputs(card, batch.to("cuda"))
        r_cpu, r_card = cpu.moe_ffn.route(x_cpu, m_cpu), card.moe_ffn.route(x_card, m_card)
    d_logits = (o_card["classification_logits"].cpu() - o_cpu["classification_logits"]
                ).abs().max().item()
    d_aux = abs(float(o_card["moe_aux_loss"]) - float(o_cpu["moe_aux_loss"]))
    same = {k: bool(torch.equal(r_card[k].cpu(), r_cpu[k])) for k in ("first_choice", "kept")}
    log(f"moe: f32 card vs CPU on 2 graphs: logits {d_logits:.3e} (<= 1e-3), aux loss "
        f"{d_aux:.3e} (<= 1e-5), expert choices equal {same['first_choice']}, kept tokens "
        f"equal {same['kept']}")
    if not (d_logits <= 1e-3 and d_aux <= 1e-5 and all(same.values())):
        raise AssertionError("the MoE model on the card and on the CPU disagree")
    return {"logits_max_abs": d_logits, "aux_abs": d_aux, **same}


def moe_block_timing(torch, model, batch, card: str) -> dict:
    """The MoE block alone (norm + routed FFN) at the step's input: forward
    and forward + backward device times, and its kernels by name."""
    with torch.no_grad():
        _, x, mask = moe_inputs(model, batch)
    x = x.detach().clone().requires_grad_(True)

    def fwd():
        return model.moe_ffn(x, mask)

    def fwd_bwd():
        out, aux = model.moe_ffn(x, mask)
        (out.float().sum() + aux).backward()

    res = {}
    for name, fn in (("forward", fwd), ("forward_backward", fwd_bwd)):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            fn()
        end.record()
        torch.cuda.synchronize()
        res[f"{name}_ms"] = start.elapsed_time(end) / 10
    prof = profile_call(torch, fwd_bwd, "MoE block forward + backward")
    res["profile"] = prof
    log(f"moe: block (router, dispatch/combine over [32, 1024, 4, 384], experts) forward "
        f"{res['forward_ms']:.3f} ms, forward + backward {res['forward_backward_ms']:.3f} ms "
        f"[{card}]")
    return res


def moe_phase(torch, graphs, card: str, base_train: dict, base_model: dict) -> dict:
    """The MoE tier: DGDM-Base with the model section of
    configs/dgdm_base_moe.yaml (4 experts, top-1, capacity 1.5, moe_hidden
    256, bf16 compute, f32 parameters) on the Base cell's graphs (batch 32,
    1000 real nodes in bucket 1024, K 8), full width: predict_batch and one
    /predict (9 / 18 launches), 8 pretrain + 2 finetune + 1 validation step
    (9 / 18 / 9 / 18 + 3 a step), the profiled step and forward and the peak
    memory against the plain Base step of this run, routing statistics at
    bf16, the f32 model on the card against the CPU, one step with
    ``accumulate_grad_batches=2``, and the train CLI on the config followed
    by the predict CLI on its bundle."""
    from dgdm_histopath_torch import DGDMTrainer, TrainerConfig, batch_graphs, create_model
    from dgdm_histopath_torch.utils.config import load_config

    cfg = load_config(MOE["config"])
    probe = create_model("dgdm-base", num_classes=2, device="cpu", seed=0, **MOE["model"])
    yaml_model_matches(probe, cfg)
    if probe.moe_ffn.hidden_dim != 256:
        raise AssertionError(f"moe_hidden {probe.moe_ffn.hidden_dim}, expected 256")
    del probe

    predictor, launches, timing, parity = model_phase(torch, graphs, card, MOE)
    server = server_one_request(predictor, graphs[0], MOE)
    batch = batch_graphs(graphs).to("cuda")
    stats = routing_stats(torch, predictor.model, batch)
    log(f"moe: routing at bf16 over {stats['groups']} groups of 1024 (capacity "
        f"{stats['capacity_per_group']}): tokens per expert {stats['tokens_per_expert']}, "
        f"first choices {stats['first_choice_per_expert']}, dropped "
        f"{stats['dropped_tokens']:.0f} of {stats['real_tokens']:.0f} real tokens, aux loss "
        f"{stats['aux_loss']:.4f}")
    del predictor
    torch.cuda.empty_cache()
    train_launches, train_timing, train_parity = training_phase(torch, graphs, card, MOE)
    torch.cuda.empty_cache()
    f32 = moe_card_vs_cpu(torch, graphs[:2])

    # gradient accumulation: the first mini-step moves nothing, the second does
    model = create_model("dgdm-base", num_classes=2, compute_dtype="bfloat16", device="cuda",
                         seed=0, **MOE["model"])
    trainer = DGDMTrainer(model, TrainerConfig(warmup_steps=0, accumulate_grad_batches=2,
                                               pretrain_epochs=1), device="cuda")
    trainer.init_state(seed=0)
    before = [p.detach().clone() for p in trainer.params]
    first = counted(torch, lambda: trainer.training_step(batch, 0),
                    expected_launches(BASE, training=True), "accumulation mini-step 1")[0]
    still = max((p.detach() - q).abs().max().item() for p, q in zip(trainer.params, before))
    second = trainer.training_step(batch, 0)
    moved = max((p.detach() - q).abs().max().item() for p, q in zip(trainer.params, before))
    log(f"moe: accumulate_grad_batches=2: after mini-step 1 the parameters moved {still}, "
        f"after mini-step 2 {moved:.3e}; losses {first['loss']:.4f} {second['loss']:.4f}")
    if still != 0.0 or not moved > 0.0 or trainer.mini_step != 0:
        raise AssertionError("accumulation must hold the parameters for one mini-step and "
                             "move them on the second")
    block = moe_block_timing(torch, model, batch, card)
    del trainer, model
    torch.cuda.empty_cache()

    base_step = base_train["pretrain_step_ms"]
    log(f"moe: pretrain step {train_timing['pretrain_step_ms']:.3f} ms against the Base step "
        f"{base_step:.3f} ms ({train_timing['pretrain_step_ms'] / base_step:.3f}x), peak "
        f"{train_timing['peak_gib']:.2f} / {base_train['peak_gib']:.2f} GiB; forward "
        f"{timing['forward_ms']:.3f} / {base_model['forward_ms']:.3f} ms; device "
        f"{train_timing['profile']['device_busy_ms']} / "
        f"{base_train['profile']['device_busy_ms']} ms a step [{card}]")
    cli = moe_cli(torch, card)
    return {"launches": launches, "timing": timing, "parity": parity, "server": server,
            "routing_bf16": stats, "train_launches": train_launches,
            "training": train_timing, "training_parity": train_parity, "f32": f32,
            "accumulate": {"moved_after_1": still, "moved_after_2": moved,
                           "loss": [first["loss"], second["loss"]]},
            "block": block, "cli": cli, "card": card}


def moe_cli(torch, card: str) -> dict:
    """``python -m dgdm_histopath_torch.cli.train train --config
    configs/dgdm_base_moe.yaml --dataset-type graph --batch-size 32`` over
    MOE["graphs"] graph files of the Base geometry, cut to 2 epochs (one
    pretrain, one finetune) of 2 steps, then the predict CLI on its bundle
    (9 / 18 launches a graph)."""
    import os
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from dgdm_histopath_torch.cli import predict as predict_cli
    from dgdm_histopath_torch.data.graph_io import save_graph

    with tempfile.TemporaryDirectory() as root:
        graphs = make_graphs(dict(BASE, batch=MOE["graphs"]), seed=3000)
        with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
            list(pool.map(lambda i: save_graph(graphs[i], f"{root}/g/s{i:03d}_graph.npz"),
                          range(len(graphs))))
        rs = np.random.RandomState(1)
        with open(f"{root}/labels.json", "w") as f:
            json.dump({f"s{i:03d}": int(v) for i, v in enumerate(rs.randint(0, 2, len(graphs)))},
                      f)
        argv = [sys.executable, "-m", "dgdm_histopath_torch.cli.train", "train", "--config",
                MOE["config"], "--dataset-type", "graph", "--batch-size", "32", "--data-dir",
                f"{root}/g", "--metadata", f"{root}/labels.json", "--num-classes", "2",
                "--max-epochs", "2", "--pretrain-epochs", "1", "--output-dir", f"{root}/out",
                "--log-level", "WARNING"]
        # the config logs to TensorBoard; csv keeps the run to the checkout's own files
        env = {**os.environ, "DGDM_LOGGING__LOGGER_TYPE": "csv"}
        t0 = time.perf_counter()
        res = subprocess.run(argv, capture_output=True, text=True, timeout=600, env=env)
        wall = time.perf_counter() - t0
        if res.returncode != 0:
            raise AssertionError(f"dgdm-train on {MOE['config']} exited {res.returncode}: "
                                 f"{res.stderr[-3000:]}")
        with open(f"{root}/out/history.json") as f:
            hist = json.load(f)
        with np.load(f"{root}/out/final_model.npz") as data:
            meta = json.loads(str(data["__meta__"]))
        if meta["model_config"].get("moe_experts") != 4 or [h["phase"] for h in hist] != [
                "pretrain", "finetune"] or "train_moe_aux_loss" not in hist[0]:
            raise AssertionError(f"MoE CLI run: meta {meta['model_config']}, history {hist}")
        files = sorted(os.listdir(f"{root}/g"))[:8]
        os.makedirs(f"{root}/p")
        for name in files:
            os.symlink(f"{root}/g/{name}", f"{root}/p/{name}")
        fwd = expected_launches(BASE, training=False)
        rc, launches = counted(torch, lambda: predict_cli.main(
            ["--model", f"{root}/out/final_model.npz", "--input", f"{root}/p", "--output-dir",
             f"{root}/preds", "--format", "json", "--log-level", "WARNING"]),
            {k: len(files) * v for k, v in fwd.items()}, "dgdm-predict of the MoE bundle")
        probs = [json.load(open(f"{root}/preds/{n[:-4]}.json"))["probabilities"] for n in files]
        if rc != 0 or not all(np.isfinite(p).all() and abs(sum(p) - 1) < 1e-5 for p in probs):
            raise AssertionError(f"dgdm-predict on the MoE bundle: rc {rc}")
    log(f"moe: dgdm-train --config {MOE['config']} --dataset-type graph --batch-size 32 on "
        f"{MOE['graphs']} graphs, 2 epochs: rc 0 in {wall:.1f} s (a process of its own), "
        f"train_moe_aux_loss {[round(h['train_moe_aux_loss'], 4) for h in hist]}; dgdm-predict "
        f"on its bundle: {len(files)} graphs, launches {launches} [{card}]")
    return {"wall_s": wall, "history": hist, "predict_launches": launches,
            "predict_graphs": len(files)}


def dp_rank(rank: int, world: int, backend: str, rendezvous: str, spec_path: str,
            out_path: str, card_index: int) -> None:
    """One rank of the data-parallel phase: its process group on
    ``cuda:card_index``, the f32 Base trainer on the global batch (its
    rows), the steps with the given draws; writes its metrics, launch
    counts, step times and parameters."""
    import os
    import traceback

    import torch
    import torch.distributed as dist

    try:
        from dgdm_histopath_torch import DGDMTrainer, TrainerConfig, create_model
        from dgdm_histopath_torch.ops import kernels
        from dgdm_histopath_torch.parallel import make_mesh

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.set_device(card_index)
        spec = torch.load(spec_path, weights_only=False)
        dist.init_process_group(backend, init_method=f"file://{rendezvous}",
                                world_size=world, rank=rank)
        model = create_model("dgdm-base", num_classes=2, compute_dtype="float32", dropout=0.0,
                             device=f"cuda:{card_index}", seed=1)
        trainer = DGDMTrainer(model, TrainerConfig(**spec["config"]), device=f"cuda:{card_index}",
                              mesh=make_mesh())
        trainer.init_state(seed=0)
        batch = spec["batch"]
        metrics, launches, ms = [], [], []
        for draws in spec["draws"]:
            kernels.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics.append(trainer.training_step(batch, 0, draws=draws))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            launches.append(kernels.launch_counts())
        torch.save({"metrics": metrics, "launches": launches, "step_ms": ms,
                    "params": {k: v.detach().cpu() for k, v in model.named_parameters()}},
                   out_path)
        dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 - reported to the parent by the exit code
        traceback.print_exc()
        os._exit(1)


def dp_phase(torch, graphs, card: str, cards: int) -> dict:
    """The data-parallel path with its kernels: two ranks share cuda:0 over
    a gloo group (NCCL takes one card a rank), each with 16 of the Base
    cell's 32 graphs at f32, dropout 0, then ``cards`` ranks over NCCL, one
    a card (1 on a one-card machine). Three steps equal a single process on
    the global batch with the same injected draws (each loss within 1e-5 of
    max(1, |loss|), parameters within 1e-5 of max(1, the tensor's largest
    entry), as the CPU tests hold them; the key biases, whose true gradient
    is zero, to the steps' summed learning rate), each rank launching 9 /
    18 / 9 / 18 + 3 a step. The gloo wall times are those of host-staged
    collectives on one card, not a data-parallel speed; over NCCL on several
    cards they are one, at f32, against the one-process step on one card."""
    import multiprocessing
    import os
    import tempfile

    from dgdm_histopath_torch import DGDMTrainer, TrainerConfig, batch_graphs, create_model

    batch = batch_graphs(graphs)
    gen = torch.Generator().manual_seed(7)
    b, n = batch.node_mask.shape
    draws = [{"masked": (torch.rand(b, n, generator=gen) < 0.15) & batch.node_mask,
              "t": torch.randint(0, 10, (b,), generator=gen),
              "noise": torch.randn(b, n, 128, generator=gen),
              "uniform": torch.rand(b, n, generator=gen)} for _ in range(DP["steps"])]
    config = dict(learning_rate=1e-4, warmup_steps=0, pretrain_epochs=1)
    expected = expected_launches(BASE, training=True)
    out = {"card": card}
    with tempfile.TemporaryDirectory() as root:
        torch.save({"batch": batch, "draws": draws, "config": config}, f"{root}/spec.pt")
        ctx = multiprocessing.get_context("spawn")
        for name, backend, world in (("gloo", "gloo", 2), ("nccl", "nccl", cards)):
            t0 = time.perf_counter()
            procs = [ctx.Process(target=dp_rank, args=(
                r, world, backend, f"{root}/{name}.rdv", f"{root}/spec.pt",
                f"{root}/{name}{r}.pt", 0 if backend == "gloo" else r)) for r in range(world)]
            for p in procs:
                p.start()
            for p in procs:
                p.join(600)
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
            wall = time.perf_counter() - t0
            if any(p.exitcode != 0 for p in procs):
                raise AssertionError(f"{name} ranks exited {[p.exitcode for p in procs]}")
            out[name] = [torch.load(f"{root}/{name}{r}.pt", weights_only=False)
                         for r in range(world)]
            out[f"{name}_wall_s"] = wall
            for r, res in enumerate(out[name]):
                if any(c != expected for c in res["launches"]):
                    raise AssertionError(f"{name} rank {r} launches {res['launches']}")

    model = create_model("dgdm-base", num_classes=2, compute_dtype="float32", dropout=0.0,
                         device="cuda", seed=1)
    trainer = DGDMTrainer(model, TrainerConfig(**config), device="cuda")
    trainer.init_state(seed=0)
    single, single_ms = [], []
    for d in draws:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        single.append(trainer.training_step(batch, 0, draws={k: v.to("cuda")
                                                             for k, v in d.items()}))
        torch.cuda.synchronize()
        single_ms.append((time.perf_counter() - t0) * 1e3)
    params = {k: v.detach().cpu() for k, v in model.named_parameters()}
    del trainer, model
    torch.cuda.empty_cache()
    lr_sum = config["learning_rate"] * DP["steps"]
    model0 = create_model("dgdm-base", num_classes=2, compute_dtype="float32", dropout=0.0,
                          device="cpu", seed=1)
    moved = max((params[k] - p.detach()).abs().max().item()
                for k, p in model0.named_parameters())
    report = {"single_moved": moved, "single_step_ms": single_ms}
    for name in ("gloo", "nccl"):
        ranks = out[name]
        if any(r["metrics"] != ranks[0]["metrics"] for r in ranks):
            raise AssertionError(f"{name}: the ranks report different metrics")
        loss = max(abs(a[k] - s[k]) / max(1.0, abs(s[k]))
                   for a, s in zip(ranks[0]["metrics"], single) for k in s)
        worst, worst_key = 0.0, ""
        for key, ref in params.items():
            err = (ranks[0]["params"][key] - ref).abs().max().item()
            bound = lr_sum if key.endswith(("k_proj.bias", "risk.bias")) else \
                1e-5 * max(ref.abs().max().item(), 1.0)
            if err / bound > worst:
                worst, worst_key = err / bound, key
        report[name] = {"max_metric_rel": loss, "worst_param_over_bound": worst,
                        "worst_param": worst_key, "wall_s": out[f"{name}_wall_s"],
                        "step_ms": [r["step_ms"] for r in ranks],
                        "launches": ranks[0]["launches"][0]}
        where = ("on one card, host-staged collectives: not a data-parallel speed"
                 if name == "gloo" or len(ranks) == 1 else f"one card a rank, against "
                 f"{[round(x, 1) for x in single_ms]} ms for one process on one card")
        log(f"dp: {name} world {len(ranks)}, 3 f32 Base steps ({32 // len(ranks)} "
            f"graphs a rank): metrics within {loss:.3e} of max(1, |x|) of one process on the "
            f"global batch (<= 1e-5), parameters at {worst:.3f} of their bound ({worst_key}; "
            f"the steps moved them up to {moved:.2e}); "
            f"launches a step {ranks[0]['launches'][0]}; step wall "
            f"{[[round(x, 1) for x in r['step_ms']] for r in ranks]} ms ({where}); "
            f"processes {out[f'{name}_wall_s']:.1f} s [{card}]")
        if loss > 1e-5 or worst > 1.0:
            raise AssertionError(f"{name} data-parallel steps differ from one process")
    report["single_loss"] = [m["loss"] for m in single]
    return report


def dp_cli(torch, card: str, cards: int) -> dict:
    """``python -m dgdm_histopath_torch.cli.train train --mesh-shape W``
    (one rank a card over NCCL) with DGDM-Base's model in the config, on
    DP["cli_graphs"] graph files of the Base geometry at f32 with dropout 0,
    so that W ranks and
    one process take the same draws: run A over W ranks against run S over
    one process (bundles within 1e-5 of max(1, the tensor's largest entry),
    the key biases to the steps' summed learning rate); run B stopped by a
    SIGTERM to the launcher once epoch 0's checkpoint is written (exit 75,
    a mid-epoch position), then ``resume`` with the same argv: its bundle
    equal to A's to the bit."""
    import os
    import signal
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from dgdm_histopath_torch.data.graph_io import save_graph
    from dgdm_histopath_torch.models.presets import PRESETS

    # the preset's model in the config (a --preset flag would override the
    # config's dtype and dropout), at f32 and dropout 0
    model = {k: list(v) if isinstance(v, tuple) else v
             for k, v in PRESETS["dgdm-base"].items() if k != "label_note"}
    model.update(compute_dtype="float32", dropout=0.0)
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        graphs = make_graphs(dict(BASE, batch=DP["cli_graphs"]), seed=4000)
        with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
            list(pool.map(lambda i: save_graph(graphs[i], f"{root}/g/s{i:03d}_graph.npz"),
                          range(len(graphs))))
        del graphs
        rs = np.random.RandomState(2)
        with open(f"{root}/labels.json", "w") as f:
            json.dump({f"s{i:03d}": int(v) for i, v in
                       enumerate(rs.randint(0, 2, DP["cli_graphs"]))}, f)
        with open(f"{root}/config.json", "w") as f:
            json.dump({"data": {"train_split": 0.75, "val_split": 0.125, "test_split": 0.125,
                                "batch_size": 32},
                       "training": {"max_epochs": DP["cli_epochs"], "pretrain_epochs": 2,
                                    "warmup_steps": WARMUP_STEPS},
                       "model": model,
                       "logging": {"logger_type": "csv"}}, f)
        fixture_s = time.perf_counter() - t0

        def argv(out, world):
            return [sys.executable, "-m", "dgdm_histopath_torch.cli.train", "train",
                    "--config", f"{root}/config.json", "--data-dir", f"{root}/g",
                    "--dataset-type", "graph", "--metadata", f"{root}/labels.json",
                    "--num-classes", "2", "--seed", "0", "--log-level", "WARNING",
                    "--mesh-shape", str(world), "--output-dir", f"{root}/{out}"]

        def run(args, what):
            t0 = time.perf_counter()
            res = subprocess.run(args, capture_output=True, text=True, timeout=900)
            if res.returncode != 0:
                raise AssertionError(f"{what} exited {res.returncode}: {res.stderr[-3000:]}")
            return time.perf_counter() - t0

        wall = {"A": run(argv("A", cards), f"dgdm-train --mesh-shape {cards}"),
                "S": run(argv("S", 1), "dgdm-train --mesh-shape 1")}
        pa, ps = bundle_params(f"{root}/A/final_model.npz"), bundle_params(
            f"{root}/S/final_model.npz")
        with open(f"{root}/A/history.json") as f:
            hist = json.load(f)
        steps = sum(h["steps"] for h in hist)
        lr_sum = 1e-4 * steps
        worst, worst_key = 0.0, ""
        for key, ref in ps.items():
            bound = lr_sum if key.endswith(("k_proj/bias", "risk/bias")) else \
                1e-5 * max(float(np.abs(ref).max()), 1.0)
            err = float(np.abs(pa[key] - ref).max())
            if err / bound > worst:
                worst, worst_key = err / bound, key
        if set(pa) != set(ps) or worst > 1.0:
            raise AssertionError(f"{cards} ranks' bundle differs from one process's: {worst_key} "
                                 f"at {worst:.3f} of its bound")
        only_rank0 = sorted(os.listdir(f"{root}/A"))

        proc = subprocess.Popen(argv("B", cards), stdout=subprocess.DEVNULL,
                                stderr=subprocess.PIPE, text=True)
        t0 = time.perf_counter()
        index = f"{root}/B/checkpoints/index.json"
        while not os.path.exists(index) and proc.poll() is None:
            time.sleep(0.01)
        proc.send_signal(signal.SIGTERM)
        err = proc.communicate(timeout=900)[1]
        wall["B"] = time.perf_counter() - t0
        with open(index) as f:
            position = json.load(f)["records"][-1].get("extra", {}).get("resume", {})
        if proc.returncode != 75 or not position.get("mid_epoch"):
            raise AssertionError(f"run B exit code {proc.returncode}, resume record {position}: "
                                 f"{err[-2000:]}")
        resume = argv("B", cards)
        resume[3] = "resume"
        wall["resume"] = run(resume + ["--checkpoint-dir", f"{root}/B/checkpoints"],
                             "dgdm-train resume")
        pb = bundle_params(f"{root}/B/final_model.npz")
        differ = [k for k in pa if not np.array_equal(pa[k], pb[k])]
        if differ:
            raise AssertionError(f"the resumed run differs from run A: {differ[:8]}")
    log(f"dp: dgdm-train --mesh-shape {cards} (DGDM-Base, NCCL, one card a rank, f32, "
        f"dropout 0) on {DP['cli_graphs']} graph files, {steps} steps of 32: rc 0 in "
        f"{wall['A']:.1f} s, one process {wall['S']:.1f} s; bundles within {worst:.3f} of their "
        f"bound ({worst_key}); rank 0 alone wrote {only_rank0}; SIGTERM to the launcher -> "
        f"75 at {position} after {wall['B']:.1f} s, resume {wall['resume']:.1f} s, its bundle "
        f"equal to run A's to the bit ({len(pa)} arrays) [{card}]")
    return {"wall_s": wall, "steps": steps, "worst_param_over_bound": worst,
            "worst_param": worst_key, "resume": position, "fixture_s": fixture_s,
            "outputs": only_rank0, "history": hist}


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

    if sys.argv[1:] == ["--dp-only"]:
        # data parallelism alone, for a machine of several cards
        cards = torch.cuda.device_count()
        dp = dp_phase(torch, make_graphs(BASE), card, cards)
        dp["cli"] = dp_cli(torch, card, cards) if cards > 1 else None
        log("details: " + json.dumps({"dp": dp}))
        log(f"done in {time.perf_counter() - t_start:.1f} s")
        print(card)
        print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                                 "kind": torch.cuda.get_device_name(0),
                                                 "count": cards}}))
        return 0

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
    del large_graphs
    torch.cuda.empty_cache()

    # so that every phase above runs as it did before this phase existed
    remat = remat_phase(torch, graphs, card, BASE)
    torch.cuda.empty_cache()

    # the MoE tier (configs/dgdm_base_moe.yaml) against the Base numbers above
    moe = moe_phase(torch, graphs, card, train_timing, timing)
    torch.cuda.empty_cache()

    # data parallelism: two gloo ranks sharing the card, one NCCL rank
    dp = dp_phase(torch, graphs, card, torch.cuda.device_count())
    del graphs
    torch.cuda.empty_cache()

    # last: the whole-slide path
    slide = slide_phase(torch, card, kern)
    torch.cuda.empty_cache()

    # last: training through the CLI, resumed after a SIGTERM, and dgdm-predict
    cli = cli_phase(torch, card)
    torch.cuda.empty_cache()

    # last: the serving tier, dynamic batching, the rate limit and dgdm-serve
    serve = serve_phase(torch, card)
    torch.cuda.empty_cache()

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
                   "training_step_use_remat": remat["on"]["launches"][name],
                   "large_predict_batch": l_launches[name],
                   "large_training_step": l_train_launches[name],
                   "predict_slide": slide["launches"][name],
                   "dgdm_train": cli["A"]["launches"][name],
                   "dgdm_train_slide": cli["slide"]["launches"][name],
                   "dgdm_predict": cli["predict"]["launches"][name],
                   "dgdm_serve": serve["launches"][name],
                   "moe_predict_batch": moe["launches"][name],
                   "moe_training_step": moe["train_launches"][name],
                   "dp_training_step_gloo_rank": dp["gloo"]["launches"][name],
                   "dp_training_step_nccl_rank": dp["nccl"]["launches"][name],
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
        if name in slide["kernels_k24"]:
            entry["slide_k24_ms"] = {f"{r['case']} {r['dtype']}": r["ms"]
                                     for r in slide["kernels_k24"][name]}
        if name in flash_module:
            entry["max_abs_err_bf16"] = max(r["max_abs_err"] for r in kern[name]
                                            if r["dtype"] == "bfloat16")
            entry["all_shapes"] = kern[name]
        line["kernels"].append(entry)
    for t in (timing, train_timing, l_timing, l_train_timing, moe["timing"], moe["training"],
              moe["block"]):
        t["profile"].pop("top")           # printed above, one line per kernel
    log("details: " + json.dumps({"ptxas": ptxas, "kernels": kern, "real_step": real_step,
                                  "model": timing, "parity": parity, "server": server,
                                  "training": train_timing,
                                  "training_parity": train_parity, "remat": remat,
                                  "flash_module": flash_module, "cli": cli,
                                  "serve": serve, "moe": moe, "dp": dp, "slide": {
                                      k: v for k, v in slide.items() if k != "kernels_k24"},
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
