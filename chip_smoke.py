#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``dgdm_histopath_torch``) on one GPU and check it.

Run from the repository root with no arguments:  python3 chip_smoke.py

Phases, each of which raises on a failed check:
  1. environment: torch/CUDA versions and the card's name and power limit;
  2. build: nvcc builds every kernel under dgdm_histopath_torch/csrc/;
  3. kernels: each of the four kernels (the two gathers and their backwards)
     against its plain PyTorch version on the card at the main-path shapes
     (B=32, N in {1024, 512, 256}, K=8, F=128, bf16 and f32) and one ragged
     shape, with device times (CUDA-graph replays timed by CUDA events), the
     plain version's and the library call's; autograd through each wrapper
     against autograd through its plain forward;
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
     with injected draws, step time, peak memory and a profiled step.

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
MAIN_SHAPES = [(32, 1024, 8, 128), (32, 512, 8, 128), (32, 256, 8, 128)]
RAGGED_SHAPE = (32, 100, 5, 24)
BATCH, BUCKET, N_REAL, FEATURES, K = 32, 1024, 1000, 768, 8
# launches per DGDM-Base forward: 9 DynamicGraphLayers (4 encoder + 5 U-Net),
# one key gather and two conv aggregations each; a training step adds one
# backward launch for each
EXPECTED_LAUNCHES = {"gather_rows": 9, "gather_agg": 18,
                     "gather_rows_bwd": 0, "gather_agg_bwd": 0}
EXPECTED_TRAIN_LAUNCHES = {"gather_rows": 9, "gather_agg": 18,
                           "gather_rows_bwd": 9, "gather_agg_bwd": 18}
PORT_KERNEL_NAMES = ("gather_rows_kernel", "gather_agg_kernel", "scatter_rows_kernel",
                     "gather_agg_bwd_kernel", "round_to_bf16_kernel")
PRETRAIN_STEPS, WARMUP_STEPS = 8, 2


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
    """A scatter-sum kernel's result against the plain f32 sums ``ref32``.
    f32: atol = rtol = 1e-5 (atomic adds in no fixed order). bf16: the
    kernel rounds its f32 sums once, so it is held to one bf16 ulp of the
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


def kernel_phase(torch) -> dict:
    from dgdm_histopath_torch.ops.kernels.gather_agg import (
        weighted_gather_sum, weighted_gather_sum_bwd, weighted_gather_sum_bwd_plain,
        weighted_gather_sum_plain)
    from dgdm_histopath_torch.ops.kernels.gather_rows import (
        gather_rows, gather_rows_bwd, gather_rows_bwd_plain, gather_rows_plain,
        scatter_add_rows)

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows_out, agg_out, rows_bwd_out, agg_bwd_out = [], [], [], []

    def backward_checks(src, idx, w, tag, timed: bool):
        """Both backward kernels at one shape: against the plain f32 sums,
        through autograd, and (``timed``) their device times and bounds."""
        b, n, f = src.shape
        k = idx.shape[-1]
        e = src.element_size()
        g4 = torch.randn(b, n, k, f, device="cuda", generator=gen).to(src.dtype)
        g3 = torch.randn(b, n, f, device="cuda", generator=gen)
        dsrc = gather_rows_bwd(idx, g4)
        dh, dw = weighted_gather_sum_bwd(g3, src, idx, w)
        torch.cuda.synchronize()
        r = scatter_error(torch, dsrc, scatter_add_rows(idx, g4, n))
        a = scatter_error(torch, dh, scatter_add_rows(idx, w[..., None] * g3[:, :, None, :], n))
        _, dw_ref = weighted_gather_sum_bwd_plain(g3, src, idx, w)
        dw_err = (dw - dw_ref).abs().max().item()
        if not r["ok"]:
            raise AssertionError(f"gather_rows_bwd off its plain version: {r} at {tag}")
        if not (a["ok"] and torch.allclose(dw, dw_ref, atol=1e-5, rtol=1e-5)):
            raise AssertionError(f"gather_agg_bwd off its plain version: {a}, dw {dw_err} "
                                 f"at {tag}")
        # each half alone, as needs_input_grad asks for it
        only_dh, none_dw = weighted_gather_sum_bwd(g3, src, idx, w, True, False)
        none_dh, only_dw = weighted_gather_sum_bwd(g3, src, idx, w, False, True)
        if not (none_dw is None and none_dh is None and torch.equal(only_dw, dw)
                and torch.allclose(only_dh.float(), dh.float(), atol=1e-5,
                                   rtol=2.0 ** -7)):
            raise AssertionError(f"gather_agg_bwd halves disagree with the whole at {tag}")
        a["max_abs_err"] = max(a["max_abs_err"], dw_err)

        # autograd through the wrappers (forward and backward kernels). f32:
        # against autograd through the plain forwards. bf16: plain autograd
        # sums the scatter in bf16, so the plain backward functions (f32 sums,
        # one rounding) are the reference there.
        s1, w1 = src.clone().requires_grad_(), w.clone().requires_grad_()
        (d_rows,) = torch.autograd.grad(gather_rows(s1, idx), s1, g4.permute(0, 1, 3, 2)
                                        .contiguous().permute(0, 1, 3, 2))   # strided g
        d_h, d_w = torch.autograd.grad(weighted_gather_sum(s1, idx, w1), (s1, w1), g3)
        if src.dtype == torch.float32:
            (p_rows,) = torch.autograd.grad(gather_rows_plain(s1, idx), s1, g4)
            p_h, p_w = torch.autograd.grad(weighted_gather_sum_plain(s1, idx, w1), (s1, w1), g3)
        else:
            p_rows = gather_rows_bwd_plain(idx, g4)
            p_h, p_w = weighted_gather_sum_bwd_plain(g3, src, idx, w)
        for name, got, want in (("gather_rows", d_rows, p_rows), ("gather_agg dh", d_h, p_h),
                                ("gather_agg dw", d_w, p_w)):
            chk = scatter_error(torch, got, want.float())
            if not (chk["ok"] and got.dtype == want.dtype):
                raise AssertionError(f"autograd through {name}: {chk} at {tag}")
        if not timed:
            return
        flat_idx = (idx.long() + n * torch.arange(b, device="cuda").view(b, 1, 1)).reshape(-1)
        g_flat = g4.reshape(-1, f)
        rbytes = b * n * k * f * e + b * n * k * 4 + b * n * f * e
        t_bytes, t_ops = rbytes / HBM_BYTES_PER_S * 1e3, b * n * k * f / F32_FLOPS_PER_S * 1e3
        rows_bwd_out.append(dict(
            tag, max_abs_err=r["max_abs_err"], max_ulp_err=r["max_ulp_err"],
            ms=device_ms(torch, lambda: gather_rows_bwd(idx, g4)),
            plain_ms=device_ms(torch, lambda: gather_rows_bwd_plain(idx, g4)),
            library_ms=device_ms(torch, lambda: torch.zeros(
                b * n, f, dtype=g4.dtype, device="cuda").index_add_(0, flat_idx, g_flat)),
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations", bytes=rbytes))
        abytes = b * n * f * 4 + 2 * b * n * f * e + 3 * b * n * k * 4
        flops = 4 * b * n * k * f
        t_bytes, t_ops = abytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
        agg_bwd_out.append(dict(
            tag, max_abs_err=a["max_abs_err"], max_ulp_err=a["max_ulp_err"],
            ms=device_ms(torch, lambda: weighted_gather_sum_bwd(g3, src, idx, w)),
            plain_ms=device_ms(torch, lambda: weighted_gather_sum_bwd_plain(g3, src, idx, w)),
            library_ms=None, bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations", bytes=abytes,
            flops=flops))
    for (b, n, k, f) in MAIN_SHAPES + [RAGGED_SHAPE]:
        for dtype in (torch.bfloat16, torch.float32):
            e = torch.finfo(dtype).bits // 8
            src = torch.randn(b, n, f, device="cuda", generator=gen).to(dtype)
            idx = torch.randint(0, n, (b, n, k), device="cuda", generator=gen,
                                dtype=torch.int32)
            w = torch.rand(b, n, k, device="cuda", generator=gen)
            tag = dict(shape=[b, n, k, f], dtype=str(dtype).replace("torch.", ""))

            out = gather_rows(src, idx)
            torch.cuda.synchronize()
            if not torch.equal(out, gather_rows_plain(src, idx)):
                raise AssertionError(f"gather_rows differs from its plain version at {tag}")
            lib_idx = idx.long().reshape(b, n * k, 1).expand(b, n * k, f)
            rbytes = b * n * k * f * e + b * n * f * e + b * n * k * 4
            rows_out.append(dict(
                tag, max_abs_err=0.0,
                ms=device_ms(torch, lambda: gather_rows(src, idx)),
                plain_ms=device_ms(torch, lambda: gather_rows_plain(src, idx)),
                library_ms=device_ms(torch, lambda: torch.gather(src, 1, lib_idx)),
                bound_ms=rbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes", bytes=rbytes))

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
            agg_out.append(dict(
                tag, max_abs_err=err,
                ms=device_ms(torch, lambda: weighted_gather_sum(src, idx, w)),
                plain_ms=device_ms(torch, lambda: weighted_gather_sum_plain(src, idx, w)),
                library_ms=None, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations", bytes=abytes,
                flops=flops))
            backward_checks(src, idx, w, tag, timed=True)
            for name, r in (("gather_rows", rows_out[-1]), ("gather_agg", agg_out[-1]),
                            ("gather_rows_bwd", rows_bwd_out[-1]),
                            ("gather_agg_bwd", agg_bwd_out[-1])):
                lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
                log(f"kernel {name:15s} {str(tag['shape']):20s} {tag['dtype']:8s} "
                    f"err {r['max_abs_err']:.2e}  ms {r['ms']:.4f}  plain {r['plain_ms']:.4f}"
                    f"  library {lib}  bound {r['bound_ms']:.4f} ({r['bound_by']})")

    # indices outside [0, N) give zero rows in both versions
    b, n, k, f = RAGGED_SHAPE
    src = torch.randn(b, n, f, device="cuda", generator=gen).to(torch.bfloat16)
    idx = torch.randint(-3, n + 3, (b, n, k), device="cuda", generator=gen,
                        dtype=torch.int32)
    w = torch.rand(b, n, k, device="cuda", generator=gen)
    out = gather_rows(src, idx)
    bad = (idx < 0) | (idx >= n)
    if not (torch.equal(out, gather_rows_plain(src, idx)) and bad.any()
            and (out[bad] == 0).all()):
        raise AssertionError("gather_rows: out-of-range indices must give zero rows")
    if not torch.allclose(weighted_gather_sum(src, idx, w),
                          weighted_gather_sum_plain(src, idx, w), atol=1e-5, rtol=1e-5):
        raise AssertionError("gather_agg: out-of-range indices must contribute nothing")
    for dtype in (torch.bfloat16, torch.float32):
        backward_checks(src.to(dtype), idx, w, dict(shape=list(RAGGED_SHAPE), dtype=str(dtype),
                                                    out_of_range=True), timed=False)
    log("kernel checks: out-of-range indices give zero rows in the forward kernels and add "
        "nothing in the backward kernels, as in the plain versions")
    return {"gather_rows": rows_out, "gather_agg": agg_out,
            "gather_rows_bwd": rows_bwd_out, "gather_agg_bwd": agg_bwd_out}


def make_graphs(count: int, seed: int = 0):
    """Graphs of bucket 1024 with 1000 real nodes, kNN (K=8) over random
    positions, edge_attr [d, exp(-10 d), 0] (the benchmark geometry)."""
    import numpy as np
    from dgdm_histopath_torch.ops.graph import build_padded_graph

    graphs = []
    for i in range(count):
        rs = np.random.RandomState(seed + i)
        x = rs.randn(N_REAL, FEATURES).astype(np.float32)
        pos = rs.rand(N_REAL, 2).astype(np.float32)
        d2 = ((pos[:, None, :] - pos[None, :, :]) ** 2).sum(-1)
        np.fill_diagonal(d2, np.inf)
        near = np.argpartition(d2, K, axis=1)[:, :K]
        near_d2 = np.take_along_axis(d2, near, axis=1)
        order = np.lexsort((near, near_d2), axis=-1)       # by distance, then index
        idx = np.take_along_axis(near, order, axis=1)
        dist = np.sqrt(np.take_along_axis(near_d2, order, axis=1))
        attr = np.stack([dist, np.exp(-10.0 * dist), np.zeros_like(dist)], -1)
        graphs.append(build_padded_graph(x, pos, idx, attr, np.ones((N_REAL, K), bool),
                                         bucket=BUCKET))
    return graphs


def model_phase(torch, graphs, card: str) -> tuple:
    import numpy as np
    from dgdm_histopath_torch import DGDMPredictor, batch_graphs, create_model
    from dgdm_histopath_torch.ops import kernels

    model = create_model("dgdm-base", num_classes=2, compute_dtype="bfloat16",
                         device="cuda", seed=0)
    predictor = DGDMPredictor(model=model, device="cuda")

    # the main path, counted: one predict_batch of 32 graphs
    kernels.reset_launch_counts()
    results = predictor.predict_batch(graphs)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    log(f"model: predict_batch({len(graphs)}) launches {launches}")
    if launches != EXPECTED_LAUNCHES:
        raise AssertionError(f"kernel launches {launches}, expected {EXPECTED_LAUNCHES}")
    for r in results:
        p = r["probabilities"]
        if not (np.isfinite(p).all() and abs(float(p.sum()) - 1.0) < 1e-5):
            raise AssertionError(f"bad probabilities {p}")
        if not (np.isfinite(r["graph_embedding"]).all() and r["graph_embedding"].shape == (128,)
                and np.isfinite(r["attention_weights"]).all()
                and r["attention_weights"].shape == (BUCKET,)):
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
              "graphs_per_s": BATCH / fwd_ms * 1e3, "predict_batch_ms": e2e_ms,
              "predict_batch_graphs_per_s": BATCH / e2e_ms * 1e3,
              "peak_gib": peak_gib, "card": card}
    log(f"model: DGDM-Base bf16 batch {BATCH} bucket {BUCKET}: forward {fwd_ms:.3f} ms "
        f"({timing['graphs_per_s']:.1f} graphs/s), predict_batch {e2e_ms:.3f} ms "
        f"({timing['predict_batch_graphs_per_s']:.1f} graphs/s), peak {peak_gib:.2f} GiB "
        f"[{card}]")
    timing["profile"] = profile_call(torch, lambda: predictor.forward(batch), "forward")
    parity = card_vs_cpu(torch, graphs[:2])
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
        f"gather kernels {ours:.3f} ms ({100 * ours / busy_ms:.1f}% of device time)")
    for ms, count, key in rows[:15]:
        log(f"profile:   {ms:9.3f} ms  x{count:4d}  {key[:100]}")
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms, "gather_kernels_ms": ours,
            "kernel_launches": n_kernels,
            "top": [{"ms": ms, "count": c, "name": key} for ms, c, key in rows[:40]]}


def card_vs_cpu(torch, graphs) -> dict:
    """The same f32 model and state on the card (kernels) and on the CPU
    (plain versions): logits within 1e-3, pooled attention within 1e-4."""
    from dgdm_histopath_torch import batch_graphs, create_model

    cpu_model = create_model("dgdm-base", num_classes=2, compute_dtype="float32",
                             device="cpu", seed=1)
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    batch = batch_graphs(graphs)
    with torch.inference_mode():
        on_card = gpu_model(batch.to("cuda"), return_attention=True)
        on_cpu = cpu_model(batch, return_attention=True)
    d_logits = (on_card["classification_logits"].cpu() - on_cpu["classification_logits"]).abs().max().item()
    d_attn = (on_card["attention_weights"].cpu() - on_cpu["attention_weights"]).abs().max().item()
    log(f"parity: f32 card vs CPU on 2 graphs: logits {d_logits:.3e} (<= 1e-3), "
        f"pooled attention {d_attn:.3e} (<= 1e-4)")
    if not (d_logits <= 1e-3 and d_attn <= 1e-4):
        raise AssertionError("card and CPU disagree beyond tolerance")
    return {"logits_max_abs": d_logits, "attention_max_abs": d_attn}


def server_phase(predictor, graphs) -> dict:
    """The server path, counted: the launch counters are set to 0 just
    before each request and read just after it, so the predictor calls that
    check the answers are not counted. Every request is one forward."""
    import http.client

    import numpy as np
    from dgdm_histopath_torch.deployment.serving import InferenceServer, graph_to_json
    from dgdm_histopath_torch.ops import kernels

    def request(port, method, path, body=None):
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

    def counted(port, path, body):
        kernels.reset_launch_counts()
        res = request(port, "POST", path, body)
        counts = kernels.launch_counts()
        if counts != EXPECTED_LAUNCHES:
            raise AssertionError(f"{path}: kernel launches {counts}, expected "
                                 f"{EXPECTED_LAUNCHES}")
        launches.append(counts)
        return res

    def same(a, b, atol, what):
        d = float(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32)).max())
        if d > atol:
            raise AssertionError(f"{what}: server differs from the predictor by {d}")
        return d

    # a graph whose nbr_idx leaves [0, N): answered (zero rows), and the
    # requests after it prove the card's CUDA context survived it
    bad_idx = graphs[5].nbr_idx.clone()
    bad_idx[0, 0], bad_idx[1, 1], bad_idx[2, 2] = -1, BUCKET, 10 ** 6
    bad = graphs[5].replace(nbr_idx=bad_idx)

    server = InferenceServer(predictor, port=0, host="127.0.0.1")
    server.start(background=True)
    latencies, diffs, launches = [], [], []
    try:
        port = server.port
        if not request(port, "GET", "/healthz")["healthy"]:
            raise AssertionError("server reports unhealthy")
        if request(port, "GET", "/info")["node_features"] != FEATURES:
            raise AssertionError("server /info is wrong")
        res = counted(port, "/predict", {"graph": graph_to_json(bad)})
        same(res["probabilities"], predictor.predict_graph(bad)["probabilities"], 1e-6,
             "/predict with out-of-range nbr_idx")
        for g in graphs[:3]:
            t0 = time.perf_counter()
            res = counted(port, "/predict", {"graph": graph_to_json(g)})
            latencies.append((time.perf_counter() - t0) * 1e3)
            ref = predictor.predict_graph(g)
            diffs.append(same(res["probabilities"], ref["probabilities"], 1e-6, "/predict"))
            same(res["attention_weights"], ref["attention_weights"], 1e-6, "/predict attention")
            if res["predicted_class"] != ref["predicted_class"]:
                raise AssertionError("/predict class differs from predict_graph")
        pair = graphs[3:5]
        res = counted(port, "/predict_batch", {"graphs": [graph_to_json(g) for g in pair]})
        if res["count"] != 2:
            raise AssertionError("/predict_batch count is wrong")
        for r, b, g in zip(res["results"], predictor.predict_batch(pair), pair):
            same(r["probabilities"], b["probabilities"], 1e-6, "/predict_batch")
            # batch 2 against batch 1 in bf16: GEMM tilings may differ
            diffs.append(same(r["probabilities"], predictor.predict_graph(g)["probabilities"],
                              2e-2, "/predict_batch vs predict_graph"))
        stats = dict(server.stats)
    finally:
        server.stop()
    log(f"server: 1 /predict with out-of-range nbr_idx + 3 /predict + 1 /predict_batch "
        f"answered and agree with the predictor (max prob diff {max(diffs):.2e}); "
        f"launches per request {launches}; /predict round trip ms "
        f"{[round(x, 1) for x in latencies]}")
    if stats["requests"] != 5 or stats["errors"] != 0:
        raise AssertionError(f"server stats {stats}")
    return {"predict_ms": latencies, "max_prob_diff": max(diffs), "launches": launches}


def training_phase(torch, graphs, card: str) -> tuple:
    """The training path, counted: DGDMTrainer.training_step on DGDM-Base at
    full width, batch 32, bucket 1024. The launch counters are set to 0 just
    before one step and read just after it."""
    import math

    from dgdm_histopath_torch import DGDMTrainer, TrainerConfig, batch_graphs, create_model
    from dgdm_histopath_torch.ops import kernels

    def new_trainer():
        model = create_model("dgdm-base", num_classes=2, compute_dtype="bfloat16",
                             device="cuda", seed=0)
        trainer = DGDMTrainer(model, TrainerConfig(
            warmup_steps=WARMUP_STEPS, steps_per_epoch=PRETRAIN_STEPS, pretrain_epochs=1,
            max_epochs=2), device="cuda")
        trainer.init_state(seed=0)
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

    batch = batch_graphs(graphs).to("cuda")
    trainer = new_trainer()
    if trainer.model.dropout != 0.1 or any(p.dtype != torch.float32
                                           for p in trainer.model.parameters()):
        raise AssertionError("DGDM-Base must train with dropout 0.1 and f32 parameters")

    # (a) pretrain steps; the first is the counted run of the main path
    before = snapshot(trainer)
    first, launches = counted_step(trainer, batch, 0, EXPECTED_TRAIN_LAUNCHES)
    if moved(trainer, before) != 0.0:
        raise AssertionError("the first update has learning rate 0 and must move nothing")
    again = new_trainer().training_step(batch, 0)
    if abs(again["loss"] - first["loss"]) > 1e-6 * abs(first["loss"]):
        raise AssertionError(f"same seed, other first loss: {first['loss']} {again['loss']}")
    log(f"training: pretrain step 1 launches {launches}, metrics {first}; the same seed "
        f"gives loss {again['loss']}")
    step_ms, history = [], [first]
    for i in range(1, PRETRAIN_STEPS):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        metrics, _ = counted_step(trainer, batch, 0, EXPECTED_TRAIN_LAUNCHES)
        torch.cuda.synchronize()
        history.append(metrics)
        if i >= 2:                                   # two warm-up steps
            step_ms.append((time.perf_counter() - t0) * 1e3)
        if i == 1 and not moved(trainer, before) > 0.0:
            raise AssertionError("the second update must move the parameters")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    ms = statistics.median(step_ms)
    log(f"training: DGDM-Base bf16 batch {BATCH} bucket {BUCKET} pretrain step "
        f"{ms:.3f} ms median of {len(step_ms)} ({BATCH / ms * 1e3:.1f} graphs/s), peak "
        f"{peak_gib:.2f} GiB, loss {[round(m['loss'], 4) for m in history]} [{card}]")
    profile = profile_call(torch, lambda: trainer.training_step(batch, 0), "pretrain step")

    # (b) finetune steps with labels, (c) one validation step
    labeled = batch.replace(y=torch.arange(BATCH, device="cuda") % 2)
    finetune = [counted_step(trainer, labeled, 1, EXPECTED_TRAIN_LAUNCHES)[0]
                for _ in range(2)]
    kernels.reset_launch_counts()
    val = trainer.validation_step(labeled, 1)
    if kernels.launch_counts() != EXPECTED_LAUNCHES:
        raise AssertionError(f"validation launches {kernels.launch_counts()}")
    val = {k: v.item() for k, v in val.items() if v.dim() == 0}
    if not all(math.isfinite(v) for v in val.values()) or "accuracy" not in val:
        raise AssertionError(f"validation metrics {val}")
    log(f"training: finetune steps {finetune}; validation {val}")

    parity = train_step_card_vs_cpu(torch, graphs[:2])
    timing = {"pretrain_step_ms": ms, "pretrain_step_ms_all": step_ms,
              "graphs_per_s": BATCH / ms * 1e3, "peak_gib": peak_gib, "card": card,
              "pretrain_loss": [m["loss"] for m in history],
              "grad_norm": [m["grad_norm"] for m in history],
              "finetune": finetune, "validation": val, "profile": profile}
    return launches, timing, parity


def train_step_card_vs_cpu(torch, graphs) -> dict:
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
        model = create_model("dgdm-base", num_classes=2, compute_dtype="float32",
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
    log(f"parity: f32 pretrain step card vs CPU on 2 graphs: loss {m_card['loss']:.6f} vs "
        f"{m_cpu['loss']:.6f} (diff {d_loss:.3e} <= 1e-4), worst gradient {worst:.3e} of its "
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

    kern = kernel_phase(torch)
    graphs = make_graphs(BATCH)
    predictor, launches, timing, parity = model_phase(torch, graphs, card)
    server = server_phase(predictor, graphs)
    del predictor
    torch.cuda.empty_cache()
    train_launches, train_timing, train_parity = training_phase(torch, graphs, card)

    replaces = {   # kernel -> the TPU code it stands in for
        "gather_rows": "dgdm_histopath_tpu/ops/pallas/gather_rows.py:56",
        "gather_agg": "dgdm_histopath_tpu/ops/pallas/gather_agg.py:36",
        "gather_rows_bwd": "dgdm_histopath_tpu/ops/pallas/gather_rows.py:86",
        "gather_agg_bwd": "dgdm_histopath_tpu/ops/pallas/gather_agg.py:101",
    }
    line = {"kernels": []}
    for name, where in replaces.items():
        main_shape = kern[name][0]                 # B32 N1024 K8 F128 bf16
        # max_abs_err is over the f32 comparisons; the bf16 backward results
        # are held to one bf16 ulp (max_ulp_err)
        f32_rows = [r for r in kern[name] if r["dtype"] == "float32" or "bwd" not in name]
        entry = {"name": name, "route": "cuda",
                 "source": f"dgdm_histopath_torch/csrc/{name}.cu", "replaces": where,
                 "launches": train_launches[name],
                 "launches_by_path": {"predict_batch": launches[name],
                                      "training_step": train_launches[name]},
                 "max_abs_err": max(r["max_abs_err"] for r in f32_rows),
                 "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
                 "bound_ms": main_shape["bound_ms"], "bound_by": main_shape["bound_by"],
                 "library_ms": main_shape["library_ms"], "shape": "B32 N1024 K8 F128 bf16"}
        if "bwd" in name:
            entry["max_ulp_err_bf16"] = max(r["max_ulp_err"] for r in kern[name]
                                            if r["max_ulp_err"] is not None)
        line["kernels"].append(entry)
    for t in (timing, train_timing):
        t["profile"].pop("top")           # printed above, one line per kernel
    log("details: " + json.dumps({"model": timing, "parity": parity, "server": server,
                                  "training": train_timing,
                                  "training_parity": train_parity}))
    log(f"done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
