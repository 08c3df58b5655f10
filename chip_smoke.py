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
     backwards) and the transposed neighbor list the backwards read (bit-equal
     and the same over 10 calls at every shape), against
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
     graphs each) and 1 rank over NCCL take 2 f32 Base steps with injected
     draws, equal to one process on the global batch of 32; each rank's
     launches 9 / 18 / 9 / 18 + 3 a step.
 15. int8 (w8a8) inference, after the slide phase and on its patches: the
     int8 Dense (``torch._int_mm``, padded where cuBLASLt needs it) at every
     shape the DGDM-Base forward reroutes, the ViT-B/16 shapes at the
     featurizer's batch of 256 and a batch-1 head, its int32 products equal
     to the bit to exact f64 sums, with the times of the product, bf16
     ``F.linear``, the whole int8 Dense and the bf16 Dense against the int8
     bound; DGDM-Base through ``DGDMPredictor(quant="int8")`` (9 / 18
     launches, logit cosine > 0.98 against bf16, device time, kernels and
     peak memory against bf16, the f32 int8 forward on the card against the
     CPU within 1e-4); the int8 dinov2 featurizer (feature cosine > 0.999
     against bf16, 1024-patch throughput against bf16) and
     ``predict_slide`` with ``quant="int8"`` (9 / 18); ``python -m
     dgdm_histopath_torch.cli.serve --quant int8`` (one /predict, one
     /predict_batch, SIGTERM -> 0); an int8 edge bundle packaged from the
     model on the card, loaded and predicting (9 / 18).

 16. the parallel tiers, after phase 14 on its graphs: 8 spawned gloo ranks
     share the card. Two run tensor parallelism over (data 1, model 2) on
     DGDM-Base at full width (f32, a pretrain step with injected draws and
     a finetune step: metrics within 1e-5 of max(1, |x|) of one process,
     parameters within 1e-5 of max(1, each tensor's largest entry), launches
     9 / 18 / 9 / 18 + 3 a step, each rank's parameter + AdamW bytes), the
     GPipe encoder over (1, 2) pipe stages (Base's GraphEncoder, 4
     microbatches: output and gradients within 1e-4), the MoE block of
     configs/dgdm_base_moe.yaml with its experts over (1, 2) (2e-5, routing
     equal) and the halo tier over a model axis of 2 on the Morton-sorted
     Base graphs (halo_gather equal to the dense gather on every real slot,
     sp_graph_conv within 1e-5 of GraphConvolution, H and the halo
     fraction) and DGDM-Base at full width over node-sharded inputs
     (``sp_forward`` over (1, 2) on 8 Morton-sorted Base graphs: f32 logits
     within 1e-4 of one process, bf16 logits against one process and f32,
     the pooled selections slot for slot, each rank's launches against its
     prediction, peak memory a rank against one process, and the same on
     one graph of 8000 nodes in the 8192 bucket) and DGDM-Base trained over
     node-sharded inputs (``training_step(block, epoch, prepared=True,
     plan=plan)`` over (1, 2), dropout 0.1: 3 pretrain + 1 finetune steps
     on the 8 sorted graphs in f32 against one process on the card, metrics
     1e-5 of max(1, |x|) and parameters 1e-5 of max(1, |p|), a bf16 pretrain
     step, one bf16 pretrain step on the 8192-node graph; each step's
     launches a rank against its prediction, 27 / 18 / 27 / 18 + 4, step
     times and a rank's peak memory against one process's); then all 4 of
     8 run ``dryrun_multichip(8)`` (every check of 4 ranks, and the (2, 2,
     2) data x pipe x expert mesh). The ``sp_large`` job runs DGDM-Large
     over node-sharded inputs, (1, 2), with both windows of 128 (banded
     layers over the halo tables, windowed attention through the ring
     shift): on the Large cell's 4 band-exact graphs (bucket 2048) an f32
     forward (logits 1e-5; the pooled nodes' sets equal at each level and
     their scores within 3e-5 slot for slot: near-tied nodes may swap
     slots; two score faults planted in one process's forward must fail
     that check) and an f32 ``return_attention`` forward (the edge, spatial and readout attention,
     the ranks' rows concatenated, 1e-5 of one process's), 3 pretrain + 1
     finetune f32 steps at dropout 0 and at 0.15 (metrics 1e-5 of max(1,
     |x|), first-step gradients 1e-5 of each tensor's largest entry,
     parameters as above) and a bf16 step; on configs/dgdm_xl_windowed.yaml's
     8000-node graph (bucket 8192) a bf16 pretrain step and a bf16
     ``return_attention`` forward (its [1, 16, 4096, 8192] weights a rank),
     each rank's peak above resident against one process's; every forward's
     and step's launches a rank against its prediction (35 / 22 a forward,
     35 / 22 / 35 / 22 + 4 a step). Last, the kernels with a rectangular
     table at the halo shapes against their plain versions: both forwards
     (bit-equal, 1e-5), and the widened ones, the lists over M rows (bit-
     equal) and both backwards (1e-5 in f32, one ulp in bf16 and f16,
     bit-identical from call to call) at the [32, 622, 128] table over
     [32, 512, 8] slots and the outgoing rows' [32, 512, 128] over [32, 2,
     H] slots, and at the Large graphs' [4, 1024 + 2H, 128] table and
     outgoing rows (bf16, f32), timed.

 17. half precision (ROADMAP item 8), after phase 15 on its graphs: the four
     gather kernels in f16 at the Base shapes (B=32, N in {1024, 512, 256},
     K=8, F=128) and both flash kernels in f16 at the three flash shapes,
     against their plain versions (gather_rows bit-equal, gather_agg and dw
     1e-5, the backward sums one f16 ulp, flash 1e-4 plus one f16 ulp; at
     tau = 1e-3 5e-3 plus one ulp; an all-masked graph gives zeros), timed
     beside the bf16 rows; ``SpatialAttention(use_flash=True)`` in f16,
     counted (one launch of each flash kernel); DGDM-Base at full width
     through ``DGDMTrainer``: 2 bf16 steps (f32 parameters), then 8 pretrain + 2
     finetune steps with ``compute_dtype: float16`` (each 9 / 18 / 9 / 18 +
     3 launches, losses finite), 4 steps with ``param_dtype: bfloat16``
     (parameter + AdamW bytes and peak memory against f32 parameters), a
     profiled step of each; one set of f32 parameters computing in f32, bf16
     and f16 (each half type's logits against f32's); ``pooling: set2set``:
     a counted finetune step and an f32 bundle through
     ``DGDMPredictor.predict_batch`` on the card against the CPU (1e-3 on
     log-probabilities); ``dgdm-train --pooling set2set`` with
     ``model.compute_dtype: float16`` in a written config for one epoch on 40
     graph files, and its bundle answering one /predict through
     ``dgdm-serve``.

 18. offline preprocessing (ROADMAP item 10), last: two synthetic 20x slides
     of 16384² (5 levels) rendered on the card band by band
     (``write_synthetic_slide_tiff(device="cuda")``, deflate tiles encoded in
     threads), each >= 1000 tissue patches of 256 px at threshold 0.8; one
     band's card ms against the host numpy path's on its first 2048-px tile
     (the host renders tile by tile; compared per pixel), and the card's band
     against the renderer's core on the CPU fed the card's draws (one uint8
     step, tissue field 1e-5); ``SlideDataset.preprocess_all`` with the
     dinov2 featurizer, one worker then two (equal graphs), each graph's
     structure against ``DGDMPredictor.predict_slide``'s (9 / 18 launches),
     and ``dgdm-predict`` on the written graphs (9 / 18 a graph); where h5py
     imports, ``dgdm-preprocess`` end to end and an ``.h5`` slide through the
     native reader, else one line saying so.

 19. the research path (item 14a), after phase 17 on the Base cell's
     graphs: DGDM-Base (bf16) ``ClinicalSaliencyAnalyzer.node_saliency``,
     ``integrated_gradients`` (16 steps), ``MedicalAdversarialAttack.fgsm``
     and ``pgd`` (10 steps, random start) and ``RobustnessAnalyzer.analyze``
     with a defense, each counted (one gradient with respect to the node
     features launches 9 / 18 / 9 / 18 + 3, as one training step); the
     perturbations within eps on real nodes and zero on padding; the f32
     gradient on the card against the CPU on 2 graphs (1e-3 of its largest
     entry); ms per saliency, IG and PGD call (CUDA events, median of 3
     after a warm-up), the device-busy share of a profiled IG call and its
     peak memory; ``HierarchicalEncoder`` (768 -> 512, 8 heads, 2 levels),
     ``PhaseModulatedGraphDiffusion`` (768) and ``AdaptiveGraphTopology``
     in f32, counted, against the CPU on 2 graphs (1e-4).

 20. item 14's kernel paths, after phase 19 on the Base cell's graphs:
     ``python -m dgdm_histopath_torch.cli.quality_gates --level production``
     as a process (13 gates passed), twice with ``--parallel 4 --cache-dir``
     (the second run serves all 13 from the cache), the seven model gates
     through ``ScalableQualityGateRunner(mode="process", max_workers=2)``,
     and each model gate in this process, counted (the ``training_step``
     gate launches all four gather kernels and the list build), each gate's
     wall s; ``ResilientTrainer`` over DGDM-Base (bf16, batch 32): 6 steps,
     a checkpoint every 2, a cleanup every 3, a CUDA out-of-memory error
     injected into step 3's forward once (1 recovered, 0 skipped, 3
     checkpoints, each step 9 / 18 / 9 / 18 + 3, metrics equal to the bit to
     an uninterrupted run), then a lost step, ``recover_from_checkpoint`` and
     step 7 equal to the bit; ``FederatedDGDMManager`` over two DGDM-Base
     clients of 16 graphs (2 local steps): 2 FedAvg rounds, one each of
     FedProx, SCAFFOLD, the sqrt weighting and FedAvg with DP (clip 1.0,
     noise 0.01), each round 2 x 2 x (9 / 18 / 9 / 18 + 3) launches and its
     new global parameters within one f32 ulp of the f64 weighted mean of
     the updates; the clipped norm and the noise's sigma (2%); a round's
     CUDA-event ms against two Base steps, peak memory; one f32 FedAvg round
     (2 clients x 1 step on 2 graphs) on the card against the CPU (losses
     1e-4, parameters 2 lr + 1e-5 max(1, |p|)).

 21. the last of item 14, after phase 20 on the Base cell's graphs and the
     slide of phase 10, DGDM-Base (bf16): ``PACSEHRIntegrationManager(
     DGDMPredictor(dinov2, stain_normalize=True)).process_study`` with PHI in
     the DICOM attributes, twice, counted (9 / 18 each), its class and
     confidence equal to the bit to a direct ``predict_slide``, the
     observations posted to a local HTTP endpoint with no PHI; a cohort of
     ``predict_batch`` over the 32 graphs through
     ``ClinicalPerformanceAnalyzer`` and a ``FDASubmissionManager`` dossier
     free of PHI; ``EdgeModelOptimizer.export_stablehlo`` of the Base
     inference forward (batch 32, bucket 1024): 9 ``dgdm.gather_rows`` and 18
     ``dgdm.weighted_gather_sum`` nodes, the loaded program counted (9 / 18),
     its outputs against the eager forward's, export s, file MB, both
     forwards' CUDA-event ms; ``ProductionOrchestrator`` (load a bundle,
     health, a ``predict_batch`` equal to the forward, a failing stage; the
     rollbacks in reverse) and the manifests' ``nvidia.com/gpu``; the planner
     over 6 dependent tasks of Base work (counted), ``read_resources``
     against the allocator, the resource gate, ``SafeScheduler``, placement
     by the ``"cuda"`` capability, ``QuantumOptimizer`` over
     ``dgdm_search_space`` (3 trials of 2 counted training steps of a 768-d
     DGDM built from each configuration), the 12-qubit statevector on the
     card against the CPU, ``HybridQuantumClassicalLayer(768, 128, 2)``
     card against CPU with ms; two tenants' jobs (counted) and the quota
     refusals.
 22. the staged accuracy gates (``dgdm_histopath_torch/scripts/``), last:
     (a) ``eval_camelyon16 --synthetic --hard`` with the calibrated recipe's
     training flags (GATE_C16_RECIPE) cut to GATE_PHASE_EPOCHS of pretraining
     and finetuning, the dense arm at train seed 0 and the
     int8 rider, on a copy of ``docs/results/c16_hard``'s manifest and graph
     cache with the features that cache holds (``simple_cnn+stats``): no
     cache miss, the reports and arm file in the JAX package's keys, a finite
     AUC and int8 delta, and gather_agg, gather_rows, their backwards and
     neighbor_transpose launched (the counts over the arm-seed); (b) the tiny
     ``eval_tcga --synthetic --hard`` loop of ``tests/test_gate_harness.py``
     (two train seeds, int8 rider; slides rendered for it) with a
     ``macro_ovr`` pooled report; (c) ``convert_timm_vit`` on a random
     timm-layout state dict at the dinov2_b14 geometry (a 37 x 37 grid
     resized to 16 x 16), the bundle in an f32 ``PatchFeatureExtractor`` and
     32 patches' features against the timm forward of the state dict.

Each phase logs its wall seconds as it ends, and all of them on one
``phase_seconds:`` line at the end. It prints a ``{"kernels": [...]}`` JSON
line (the f16 instantiations as ``<name>_f16`` entries), then the card's
name and power limit, and as its last line ``{"ok": true, "device":
{...}}``. It exits
non-zero without a CUDA device or without the port beside it.

``python3 chip_smoke.py --gates-only [--train-seeds 5,6,7,8,9]`` runs the
build and the whole c16 hard gate: the calibrated recipe exactly
(``--extractor stats --per-slide-norm``, its graphs built from slides
rendered from the committed manifest's seed, timed in this process, in one
spawned worker and through ``render_slides``'s rule), the dense and scratch
arms over GATE_SEEDS train seeds (or the ones given), and the pooled report
beside the JAX package's ``docs/results/c16_hard/report_pooled.json`` over
the same seeds.

``python3 chip_smoke.py --parallel-only`` runs the build and phase 16 alone;
on a machine of four cards its tiers run over NCCL, one rank a card (TP
(2, 2), PP over 4 stages, EP (2, 2), the halo, ``sp_forward``, its
training and the ``sp_large`` job over a model axis of 4,
``dryrun_multichip(4)``),
followed by ``dgdm-train --mesh-shape 2,2`` against one process and a
SIGTERM, exit 75 and ``resume``, bit-equal.

``python3 chip_smoke.py --preprocess-only`` runs the build and phase 18 alone.

``python3 chip_smoke.py --transpose-only [--old-transpose PATH]`` runs the
build and the transposed-list phase alone (``transpose_phase``, which the
whole script runs after the kernel phase: the cluster kernel at
TRANSPOSE_CASES, bit-equal and the same over 10 calls, timed beside the
bytes bound and an empty launch of the plan's grid and cluster); with a
``neighbor_transpose.cu`` of the single-CTA design (``git show
<commit>:dgdm_histopath_torch/csrc/neighbor_transpose.cu``), both kernels
timed in turns at TRANSPOSE_AB_SHAPES.

``python3 chip_smoke.py --orchestration-only`` runs the build and phase 21
alone (on a slide of its own).

``python3 chip_smoke.py --quality-only`` runs the build and phase 20 alone.

``python3 chip_smoke.py --research-only`` runs the build and phase 19 alone.

``python3 chip_smoke.py --dtype-only`` runs the build and phase 17 alone
(its bf16 kernel rows timed there too), and prints the f16 entries of the
kernel line.

``python3 chip_smoke.py --dp-only`` on a machine of several cards runs the
build and phase 14 alone, with one NCCL rank a card, and then the train CLI
with ``--mesh-shape`` of all the cards: its bundle against one process's,
and a SIGTERM to the launcher, exit 75 and ``resume``, bit-equal.
"""

from __future__ import annotations

import copy
import functools
import json
import math
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
F32_FLOPS_PER_S = 67e12            # H100 SXM f32, outside the tensor cores
BF16_FLOPS_PER_S = 989e12          # H100 SXM bf16 tensor cores, dense
INT8_OPS_PER_S = 1979e12           # H100 SXM int8 tensor cores, dense
EXP_PER_S = 132 * 16 * 1.98e9      # H100 SXM special-function units (exp), 16/clk/SM at 1.98 GHz
# (B, N, K, F) of the gathers at the U-Net levels of DGDM-Base and DGDM-Large
MAIN_SHAPES = [(32, 1024, 8, 128), (32, 512, 8, 128), (32, 256, 8, 128)]
LARGE_SHAPES = [(4, 2048, 8, 128), (4, 1024, 8, 128), (4, 512, 8, 128)]
RAGGED_SHAPE = (32, 100, 5, 24)
# the pooled Base levels and a Large level with half the slots at node 0
HUB_SHAPES = [(32, 512, 8, 128), (32, 256, 8, 128), (4, 1024, 8, 128)]
K = 8
# The transposed list's own cases (transpose_phase): (label, B, N, K, M or
# None for N, index kind, timed). The timed ones include the model's shapes,
# the node-sharded tier's bucket 8192 graph and batch 1; the rest are edges
# of the cluster plan. Each is held bit-equal to the plain version and
# bit-identical over TRANSPOSE_CALLS calls.
TRANSPOSE_CASES = [
    ("Base level 0", 32, 1024, 8, None, "random", True),
    ("Large level 0", 4, 2048, 8, None, "random", True),
    ("Base level 2", 32, 256, 8, None, "random", True),
    ("hub: half the slots at row 0", 32, 512, 8, None, "hub", True),
    ("bucket 8192", 1, 8192, 8, None, "random", True),
    ("batch 1", 1, 1024, 8, None, "random", True),
    ("one row takes every slot", 1, 1024, 8, None, "one row", True),
    ("every index out of range", 4, 512, 8, None, "out of range", False),
    ("M = 1", 8, 256, 8, 1, "ragged", False),
    ("M > N", 4, 1024, 8, 3000, "random", False),
    ("N*K not a multiple of C*32", 4, 1000, 7, None, "ragged", False),
    ("M = 16384: counters in global scratch", 1, 2048, 8, 16384, "ragged", False),
]
TRANSPOSE_CALLS = 10
# ``--transpose-only --old-transpose PATH``: the shapes of the A/B against a
# neighbor_transpose.cu of the single-CTA design
TRANSPOSE_AB_SHAPES = [(32, 1024, 8), (4, 2048, 8), (32, 256, 8), (1, 8192, 8), (1, 1024, 8)]
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
DP = dict(steps=2, cli_graphs=128, cli_epochs=4)
# The int8 cell (ROADMAP item 13): DGDM-Base through DGDMPredictor(quant="int8")
# on the Base cell's graphs, the dinov2 featurizer at its batch of 256 on the
# slide cell's patches, dgdm-serve --quant int8 and an int8 edge bundle; the
# cosine bounds are the JAX package's tests' (tests/test_quant.py:95,182).
INT8 = dict(vit_batch=256, cosine_model=0.98, cosine_featurizer=0.999, cpu_atol=1e-4)


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


def device_ms(torch, fn, reps: int = 20, trials: int = 11) -> float:
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


EMPTY_KERNEL = r"""
__global__ void empty_kernel() {}
// grid x block threads in clusters of `cluster` CTAs with `smem` bytes of
// dynamic shared memory each: the shape of a kernel's launch, without its work
extern "C" int empty_launch(long long grid, long long block, long long cluster,
                            long long smem, void* stream) {
  cudaFuncSetAttribute(empty_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 224 * 1024);
  cudaFuncSetAttribute(empty_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(grid));
  cfg.blockDim = dim3(static_cast<unsigned>(block));
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, empty_kernel);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
"""


@functools.lru_cache(maxsize=None)
def empty_kernel():
    """A launcher of an empty kernel, built with the kernels' nvcc flags into
    the package's build directory (once a process): the launch floor that
    the smallest kernels' times stand beside. ``launch(stream, grid=1,
    block=32, cluster=1, smem=0)`` launches it at a kernel's shape (clusters
    of ``cluster`` CTAs, ``smem`` bytes of dynamic shared memory each).
    Raises if it does not build or launch."""
    import ctypes

    from dgdm_histopath_torch.ops.kernels.build import BUILD_DIR, NVCC_FLAGS, nvcc_path

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src, lib = (BUILD_DIR / f"launch_floor-{os.getpid()}{ext}" for ext in (".cu", ".so"))
    src.write_text(EMPTY_KERNEL)
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"the empty kernel did not build: {proc.stderr[-2000:]}")
    fn = ctypes.CDLL(str(lib)).empty_launch
    fn.argtypes = [ctypes.c_longlong] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def launch(stream, grid=1, block=32, cluster=1, smem=0):
        err = fn(grid, block, cluster, smem, stream)
        if err:
            raise RuntimeError(f"the empty kernel did not launch: CUDA error {err}")
    return launch


def half_ulp(torch, x, dtype):
    """One ulp of each element of the f32 tensor ``x`` in the half type
    ``dtype`` (bf16: 8 significant bits, f16: 11)."""
    bits = 8 if dtype == torch.bfloat16 else 11
    return torch.ldexp(torch.ones_like(x), torch.frexp(x).exponent - bits)


def scatter_error(torch, out, ref32) -> dict:
    """A backward gather-sum kernel's result against the plain f32 sums
    ``ref32``. f32: atol = rtol = 1e-5 (the two sum in other orders). bf16
    and f16: the kernel rounds its f32 sums once, so it is held to one ulp of
    the plain rounded result, plus the 1e-5 of the f32 sums near zero."""
    if out.dtype == torch.float32:
        err = (out - ref32).abs()
        ok = bool((err <= 1e-5 + 1e-5 * ref32.abs()).all())
        return {"ok": ok, "max_abs_err": err.max().item(), "max_ulp_err": None}
    ref = ref32.to(out.dtype).float()
    ulp = half_ulp(torch, ref, out.dtype)
    err = (out.float() - ref).abs()
    return {"ok": bool((err <= ulp + 1e-5).all()), "max_abs_err": err.max().item(),
            "max_ulp_err": (err / ulp.clamp_min(1e-5)).max().item()}


def csr_adjacency(torch, idx, w, dtype, transpose: bool = False, n_src=None):
    """The [B·N, B·N_src] CSR matrix A with A[b·N + n, b·N_src + idx[b, n, k]]
    summing w[b, n, k] over the in-range slots (A^T with ``transpose``): then
    ``A @ h`` is gather_agg and ``A^T @ g`` the dh half of its backward. The
    operand of the library yardstick, built outside its timing."""
    b, n, k = idx.shape
    n_src = n if n_src is None else n_src
    valid = (idx >= 0) & (idx < n_src)
    arange = torch.arange(b, device=idx.device).view(b, 1, 1)
    rows = (torch.arange(n, device=idx.device).view(1, n, 1) + n * arange).expand(b, n, k)[valid]
    cols = (idx.long() + n_src * arange)[valid]
    shape = (b * n, b * n_src)
    if transpose:
        rows, cols, shape = cols, rows, shape[::-1]
    coo = torch.sparse_coo_tensor(torch.stack([rows, cols]), w[valid].to(dtype), shape)
    return coo.coalesce().to_sparse_csr()


def sparse_mm_ms(torch, idx, w, dense, transpose: bool = False, n_src=None) -> tuple:
    """(device ms, dtype) of ``torch.sparse.mm`` of the CSR adjacency with
    ``dense`` [B, N, F]: in dense's dtype where cuSPARSE takes it, else in
    f32 (the dtype is recorded beside the time). With ``transpose`` dense is
    the cotangent [B, N, F] and ``n_src`` the table's rows (default N)."""
    b, rows, f = dense.shape
    for dtype in dict.fromkeys((dense.dtype, torch.float32)):
        x = dense.reshape(b * rows, f).to(dtype)
        a = csr_adjacency(torch, idx, w, dtype, transpose, n_src if transpose else rows)
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
    transpose_repeats(torch, idx, None, nbr_t, tag)
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


def transpose_repeats(torch, idx, m, first, tag, calls: int = TRANSPOSE_CALLS) -> None:
    """Raise unless ``calls`` builds of idx's list over ``m`` rows (``first``
    one of them) are bit-identical."""
    from dgdm_histopath_torch.ops.kernels.neighbor_transpose import neighbor_transpose

    for _ in range(calls - 1):
        again = neighbor_transpose(idx, m)
        if not (torch.equal(again.offsets, first.offsets)
                and torch.equal(again.slots, first.slots)):
            raise AssertionError(f"neighbor_transpose differs from call to call at {tag}")


def transpose_indices(torch, gen, b, n, k, m, kind):
    """idx [b, n, k] of a named kind over a table of m rows: ``random`` in
    [0, m), ``hub`` with half of them at row 0, ``ragged`` in [-1, m + 1),
    ``one row`` every slot at one row, ``out of range`` none in [0, m)."""
    if kind == "one row":
        return torch.full((b, n, k), min(7, m - 1), dtype=torch.int32, device="cuda")
    lo, hi = {"random": (0, m), "hub": (0, m), "ragged": (-1, m + 1),
              "out of range": (m, m + 8)}[kind]
    idx = torch.randint(lo, hi, (b, n, k), device="cuda", generator=gen, dtype=torch.int32)
    half = torch.rand(b, n, k, device="cuda", generator=gen) < 0.5
    if kind == "hub":
        idx[half] = 0
    elif kind == "out of range":
        idx[half] -= m + 8                                 # [-8, 0)
    return idx


def transpose_phase(torch) -> dict:
    """The transposed-list kernel at TRANSPOSE_CASES: each case bit-equal to
    the plain version and bit-identical over TRANSPOSE_CALLS calls, with its
    launch plan (cluster, grid, shared memory, the clusters of that shape the
    card holds at once); the timed cases with their device ms, the plain
    version's, the bytes bound and the launch floor (an empty kernel at the
    plan's grid, cluster and shared memory, timed as the kernel is)."""
    import ctypes

    from dgdm_histopath_torch.ops.kernels import build
    from dgdm_histopath_torch.ops.kernels.neighbor_transpose import (
        launch_plan, neighbor_transpose, neighbor_transpose_plain)

    lib = ctypes.CDLL(str(build.build_all(["neighbor_transpose"])["neighbor_transpose"]))
    max_clusters = lib.neighbor_transpose_max_clusters
    max_clusters.argtypes, max_clusters.restype = [ctypes.c_int64] * 3, ctypes.c_int
    for r in build.ptxas_report("neighbor_transpose"):
        log(f"transpose: ptxas {r['kernel']}: {r['registers']} registers, spill stores "
            f"{r['spill_stores']} / loads {r['spill_loads']} bytes, static smem "
            f"{r['static_smem']} (+ the plan's dynamic smem below)")
    t_phase = time.perf_counter()
    empty = empty_kernel()
    gen = torch.Generator(device="cuda").manual_seed(20)
    rows = []
    for label, b, n, k, m, kind, timed in TRANSPOSE_CASES:
        m = n if m is None else m
        idx = transpose_indices(torch, gen, b, n, k, m, kind)
        plan = launch_plan(b, n, k, m)
        out, ref = neighbor_transpose(idx, m), neighbor_transpose_plain(idx, m)
        torch.cuda.synchronize()
        if not (torch.equal(out.offsets, ref.offsets) and torch.equal(out.slots, ref.slots)):
            raise AssertionError(f"neighbor_transpose differs from its plain version: {label}")
        transpose_repeats(torch, idx, m, out, label)
        counts = out.offsets[:, 1:] - out.offsets[:, :-1]
        row = dict(case=label, shape=[b, n, k], rows=m, cluster=plan.cluster, grid=plan.grid,
                   warps=plan.warps, smem=plan.smem, scratch=plan.scratch > 0,
                   max_clusters=max_clusters(plan.warps, plan.cluster, plan.smem),
                   kept=int(out.offsets[:, -1].sum()),
                   max_in_degree=int(counts.max()) if counts.numel() else 0)
        if timed:
            tbytes = 2 * b * n * k * 4 + b * (m + 1) * 4
            row.update(
                ms=device_ms(torch, lambda: neighbor_transpose(idx, m)),
                plain_ms=device_ms(torch, lambda: neighbor_transpose_plain(idx, m)),
                floor_ms=device_ms(torch, lambda: empty(
                    torch.cuda.current_stream().cuda_stream, plan.grid, plan.threads,
                    plan.cluster, plan.smem)),
                bound_ms=tbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes", bytes=tbytes,
                library_ms=None)
        rows.append(row)
        times = (f"  ms {row['ms']:.4f}  plain {row['plain_ms']:.4f}  bound {row['bound_ms']:.4f}"
                 f" (bytes)  launch floor {row['floor_ms']:.4f}  share of bound "
                 f"{row['bound_ms'] / row['ms']:.3f}, of bound + floor "
                 f"{(row['bound_ms'] + row['floor_ms']) / row['ms']:.3f}" if timed else "")
        log(f"transpose: {label:40s} B{b} N{n} K{k} M{m}: cluster {plan.cluster} x "
            f"{plan.grid // plan.cluster}, {plan.warps} warps, smem {plan.smem}"
            f"{' (scratch)' if plan.scratch else ''}, "
            f"{row['max_clusters']} clusters at once, kept {row['kept']}, in-degree <= "
            f"{row['max_in_degree']}; bit-equal, {TRANSPOSE_CALLS} calls identical{times}")
    phase_s = time.perf_counter() - t_phase
    log(f"transpose: phase took {phase_s:.1f} s")
    return {"cases": rows, "phase_s": phase_s}


def old_transpose(torch, source: str):
    """A launcher ``fn(idx, m) -> (offsets, slots)`` of a neighbor_transpose.cu
    of the single-CTA design (one block of 16 warps a graph; its C entry
    point ``neighbor_transpose_launch(idx, offsets, slots, scratch, B, N, K,
    M, stream)``, its counters in a global scratch buffer above 160 KiB),
    built with the kernels' nvcc flags: the yardstick of transpose_ab."""
    import ctypes

    from dgdm_histopath_torch.ops.kernels.build import BUILD_DIR, NVCC_FLAGS, nvcc_path

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = BUILD_DIR / f"neighbor_transpose_single_cta-{os.getpid()}.so"
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(lib), source],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{source} did not build: {proc.stderr[-2000:]}")
    fn = ctypes.CDLL(str(lib)).neighbor_transpose_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def launch(idx, m):
        b, n, k = idx.shape
        offsets = torch.empty((b, m + 1), dtype=torch.int32, device=idx.device)
        slots = torch.empty((b, n * k), dtype=torch.int32, device=idx.device)
        words = m * 16 + (m * 16 >> 5) + 1
        scratch = (torch.empty(b * words, dtype=torch.int32, device=idx.device)
                   if words * 4 > 160 * 1024 else None)
        err = fn(idx.data_ptr(), offsets.data_ptr(), slots.data_ptr(),
                 None if scratch is None else scratch.data_ptr(), b, n, k, m,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"the single-CTA neighbor_transpose failed: CUDA error {err}")
        return offsets, slots
    return launch


def transpose_ab(torch, source: str, card: str) -> dict:
    """The cluster kernel against the single-CTA one built from ``source``,
    at TRANSPOSE_AB_SHAPES in one call and in turns (single-CTA, cluster,
    cluster, single-CTA): both bit-equal to the plain version, the device ms
    of each turn, the bytes bound and the cluster plan's launch floor."""
    from dgdm_histopath_torch.ops.kernels.neighbor_transpose import (
        launch_plan, neighbor_transpose, neighbor_transpose_plain)

    old = old_transpose(torch, source)
    empty = empty_kernel()
    gen = torch.Generator(device="cuda").manual_seed(21)
    rows = []
    for b, n, k in TRANSPOSE_AB_SHAPES:
        idx = transpose_indices(torch, gen, b, n, k, n, "random")
        ref = neighbor_transpose_plain(idx)
        got = old(idx, n)
        torch.cuda.synchronize()
        if not (torch.equal(got[0], ref.offsets) and torch.equal(got[1], ref.slots)):
            raise AssertionError(f"the single-CTA kernel differs from the plain version at "
                                 f"B{b} N{n} K{k}")
        plan = launch_plan(b, n, k, n)
        turns = [device_ms(torch, fn) for fn in (
            lambda: old(idx, n), lambda: neighbor_transpose(idx),
            lambda: neighbor_transpose(idx), lambda: old(idx, n))]
        floor = device_ms(torch, lambda: empty(torch.cuda.current_stream().cuda_stream,
                                               plan.grid, plan.threads, plan.cluster,
                                               plan.smem))
        tbytes = 2 * b * n * k * 4 + b * (n + 1) * 4
        row = dict(shape=[b, n, k], single_cta_ms=[turns[0], turns[3]],
                   cluster_ms=[turns[1], turns[2]], cluster=plan.cluster, floor_ms=floor,
                   bound_ms=tbytes / HBM_BYTES_PER_S * 1e3,
                   speedup=(turns[0] + turns[3]) / (turns[1] + turns[2]))
        rows.append(row)
        log(f"transpose A/B B{b} N{n} K{k}: single CTA {turns[0]:.4f} / {turns[3]:.4f} ms, "
            f"cluster of {plan.cluster} {turns[1]:.4f} / {turns[2]:.4f} ms ({row['speedup']:.2f}x)"
            f", bound {row['bound_ms']:.4f} (bytes), launch floor {floor:.4f} [{card}]")
    return {"rows": rows}


def rows_read(torch, idx, n_src: int) -> int:
    """The table rows a gather must read at least: the distinct in-range
    indices of each graph of ``idx`` [B, N, K] over a table of ``n_src``
    rows (fewer than ``B * n_src`` where the queries touch part of the
    table, as the halo's outgoing-rows gather does)."""
    flat = idx.long().reshape(idx.shape[0], -1)
    ok = (flat >= 0) & (flat < n_src)
    keys = flat + n_src * torch.arange(idx.shape[0], device=idx.device).view(-1, 1)
    return int(torch.unique(keys[ok]).numel())


def gather_rows_row(torch, src, idx, tag: dict) -> dict:
    """The key-gather kernel at one shape (src [B, N_src, F], idx [B, N, K]):
    bit-equal to its plain version, its device time, the plain version's and
    ``torch.gather``'s, and its bound (each table row that an in-range index
    names and idx read once, the gathered rows written once)."""
    from dgdm_histopath_torch.ops.kernels.gather_rows import gather_rows, gather_rows_plain

    b, n_src, f = src.shape
    n, k = idx.shape[1:]
    e = src.element_size()
    res = gather_rows(src, idx)
    torch.cuda.synchronize()
    if not torch.equal(res, gather_rows_plain(src, idx)):
        raise AssertionError(f"gather_rows differs from its plain version at {tag}")
    lib_idx = idx.long().clamp(0, n_src - 1).reshape(b, n * k, 1).expand(b, n * k, f)
    rbytes = b * n * k * f * e + rows_read(torch, idx, n_src) * f * e + b * n * k * 4
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
    adjacency), and its bound (idx, w and each table row that an in-range
    index names read once, f32 out written once). src may hold another row
    count than idx ([B, N_src, F] and [B, N, K])."""
    from dgdm_histopath_torch.ops.kernels.gather_agg import (
        weighted_gather_sum, weighted_gather_sum_plain)

    b, n_src, f = src.shape
    n, k = idx.shape[1:]
    agg = weighted_gather_sum(src, idx, w)
    ref = weighted_gather_sum_plain(src, idx, w)
    torch.cuda.synchronize()
    err = (agg - ref).abs().max().item()
    if not torch.allclose(agg, ref, atol=1e-5, rtol=1e-5):
        raise AssertionError(f"gather_agg off its plain version by {err} at {tag}")
    abytes = (rows_read(torch, idx, n_src) * f * src.element_size() + 2 * b * n * k * 4
              + b * n * f * 4)
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


def flash_inputs(torch, gen, b, n, n_real, h, d, dtype):
    q, k, v = (torch.randn(b, n, h, d, device="cuda", generator=gen).to(dtype)
               for _ in range(3))
    pos = torch.rand(b, n, 2, device="cuda", generator=gen)
    mask = torch.arange(n, device="cuda").expand(b, n) < n_real
    return q, k, v, pos, mask


def flash_versions(h, d, n):
    """(kernel name, plain version) of the route of a [*, n, h, d] input."""
    from dgdm_histopath_torch.ops.kernels import flash_spatial as fs

    route = fs.flash_route(n, h, d)
    name = {"packed": "flash_spatial_packed", "headmajor": "flash_spatial"}[route]
    plain = fs.flash_spatial_packed_plain if route == "packed" else fs.flash_spatial_plain
    return name, plain


def flash_error(torch, out, ref, mask, tag, atol=1e-4) -> float:
    """A flash kernel's result against a reference on the valid rows: atol,
    and for bf16 and f16 one ulp of each element in that type more."""
    ref32 = ref.float()
    tol = torch.full_like(ref32, atol)
    if out.dtype != torch.float32:
        tol = tol + half_ulp(torch, ref32, out.dtype)
    err = (out.float() - ref32).abs() * mask[:, :, None, None]
    if not ((err <= tol).all() and torch.isfinite(out).all() and out.dtype == ref.dtype):
        raise AssertionError(f"flash kernel off its plain version by {err.max().item()}, "
                             f"{(err / tol).max().item():.2f} of the limit, at {tag}")
    return err.max().item()


def flash_row(torch, gen, b, n, n_real, h, d, dtype) -> tuple:
    """(kernel name, row): one flash kernel at one shape against its plain
    version and the dense reference, one launch counted, with its device
    time, the plain version's, the dense formulation's and
    ``scaled_dot_product_attention``'s (its additive mask built apart), and
    its bound (the two products' operations on valid keys at the tensor-core
    rate for bf16 / f16, at the f32 rate for f32; or the bytes)."""
    import torch.nn.functional as F
    from dgdm_histopath_torch.ops import kernels
    from dgdm_histopath_torch.ops.kernels import flash_spatial as fs

    name, plain = flash_versions(h, d, n)
    q, k, v, pos, mask = flash_inputs(torch, gen, b, n, n_real, h, d, dtype)
    tag = dict(shape=[b, n, h, d], real_nodes=n_real, dtype=str(dtype).replace("torch.", ""))
    before = kernels.KERNELS[name].launches
    out = fs.flash_spatial_attention(q, k, v, pos, mask, tau=0.1)
    torch.cuda.synchronize()
    if kernels.KERNELS[name].launches != before + 1:
        raise AssertionError(f"{name} was not launched at {tag}")
    err = flash_error(torch, out, plain(q, k, v, pos, mask, 0.1), mask, tag)
    flash_error(torch, out, fs.dense_reference(q, k, v, pos, mask, 0.1), mask, tag)

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
    peak = F32_FLOPS_PER_S if dtype == torch.float32 else BF16_FLOPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    r = dict(
        tag, max_abs_err=err, library_abs_diff=lib_err,
        ms=device_ms(torch, lambda: fs.flash_spatial_attention(q, k, v, pos, mask)),
        plain_ms=device_ms(torch, lambda: plain(q, k, v, pos, mask, 0.1), 4, 7),
        library_ms=device_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=attn_mask), 10, 11),
        library_mask_ms=device_ms(torch, make_attn_mask, 4, 7),
        dense_ms=device_ms(torch, lambda: fs.dense_reference(q, k, v, pos, mask, 0.1), 4, 7),
        bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
        f32_fma_ms=flops / F32_FLOPS_PER_S * 1e3, bytes=nbytes, flops=flops)
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
    return name, r


def flash_kernel_phase(torch) -> dict:
    """The two flash spatial-attention kernels on the card against their plain
    versions. f32 results are held to 1e-4 on valid rows (the kernel sums in
    another order and takes exp through the fast intrinsic). bf16: kernel and
    plain version each round their f32 result once, so where the two f32
    values (1e-4 apart at most) straddle a rounding boundary they differ by
    one bf16 ulp of that element (2^-9 for a value in [0.5, 1)); every
    element is held to its own ulp plus the 1e-4."""
    from dgdm_histopath_torch.ops import kernels
    from dgdm_histopath_torch.ops.kernels import flash_spatial as fs

    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = {"flash_spatial_packed": [], "flash_spatial": []}

    for (b, n, n_real, h, d) in FLASH_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            name, row = flash_row(torch, gen, b, n, n_real, h, d, dtype)
            rows[name].append(row)

    # a sharp bias, tau = 1e-3, bf16: the tensor-core kernels start q.k's
    # accumulator from the bias in units of the unscaled product (up to
    # 1.4 / (tau * scale) here), so they are held where it is largest, to the
    # reference's limit at this tau (5e-3) plus one bf16 ulp of each element
    sharp = {}
    for (b, n, n_real, h, d) in FLASH_SHAPES:
        name, plain = flash_versions(h, d, n)
        q, k, v, pos, mask = flash_inputs(torch, gen, b, n, n_real, h, d, torch.bfloat16)
        tag = f"{name} {[b, n, h, d]} bfloat16 tau 1e-3"
        before = kernels.KERNELS[name].launches
        out = fs.flash_spatial_attention(q, k, v, pos, mask, tau=1e-3)
        torch.cuda.synchronize()
        if kernels.KERNELS[name].launches != before + 1:
            raise AssertionError(f"{name} was not launched at {tag}")
        sharp[tag] = flash_error(torch, out, plain(q, k, v, pos, mask, 1e-3), mask, tag, atol=5e-3)
    log(f"kernel checks: flash bf16 at tau = 1e-3 within 5e-3 + 1 ulp of the plain versions, "
        f"largest errors {sharp}")

    # a graph without a valid node gives zeros; its neighbor in the batch is untouched
    for (h, d) in ((8, 16), (16, 8), (4, 64)):
        for dtype in (torch.bfloat16, torch.float32):
            name, plain = flash_versions(h, d, 256)
            q, k, v, pos, mask = flash_inputs(torch, gen, 3, 256, 200, h, d, dtype)
            mask[1] = False
            out = fs.flash_spatial_attention(q, k, v, pos, mask)
            torch.cuda.synchronize()
            flash_error(torch, out, plain(q, k, v, pos, mask, 0.1), mask,
                        f"{name} all-masked {dtype}")
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
            name, plain = flash_versions(h, d, 128)
            q, k, v, pos, mask = flash_inputs(torch, gen, 2, 128, 100, h, d, dtype)
            before = kernels.KERNELS[name].launches
            out = fs.flash_spatial_attention(q, k, v, pos, mask)
            torch.cuda.synchronize()
            if kernels.KERNELS[name].launches != before + 1:
                raise AssertionError(f"{name} was not launched at {h}x{d} {dtype}")
            flash_error(torch, out, plain(q, k, v, pos, mask, 0.1), mask, f"{name} {h}x{d} {dtype}")
    # N that does not tile takes the dense route: no launch, and it is counted
    q, k, v, pos, mask = flash_inputs(torch, gen, 2, 100, 90, 8, 16, torch.float32)
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
        name, plain = flash_versions(h, d, n)
        q, k, v, pos, mask = flash_inputs(torch, gen, b, n, n_real, h, d, torch.float32)
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


def profile_call(torch, fn, what: str, host: bool = True) -> dict:
    """Device time by kernel over one call of ``fn`` (torch.profiler): only the
    device-side kernel events are summed, not the CPU ops that launched them.
    ``host=False`` records the device activity alone, which keeps a call of
    tens of thousands of kernels cheap to trace and read."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU] if host else []
    with profile(activities=activities + [ProfilerActivity.CUDA]) as prof:
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

        def capture(idx, m=None):
            captured.append(idx.clone())
            return build(idx, m)

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
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np
    from dgdm_histopath_torch.preprocessing.slide_io import ArrayBackend
    from dgdm_histopath_torch.preprocessing.synthetic import build_pyramid, generate_tissue_image

    t0 = time.perf_counter()
    n, px = SLIDE["fields"], SLIDE["field_px"]
    # every field at once: a pool of fewer workers than fields takes a second
    # round as long as the first
    with ProcessPoolExecutor(max_workers=n * n, mp_context=mp.get_context("spawn")) as pool:
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


def slide_phase(torch, card: str, kern: dict, keep: dict) -> dict:
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
    keep.update(backend=backend, patches=patches)                   # for the int8 phase
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


def write_cli_fixture(root: str, count: int = CLI["graphs"]) -> dict:
    """The graph-training cell's files under ``root``: ``count`` DGDM-Base
    graphs of ``make_graphs`` (1000 real nodes in bucket 1024, 768-d, K = 8,
    3 edge features) written by the port's ``save_graph``, a seeded two-class
    ``labels.json`` and a JSON config (splits, batch, epochs, csv logging)."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from dgdm_histopath_torch.data.graph_io import save_graph

    t0 = time.perf_counter()
    graphs = make_graphs(dict(BASE, batch=count), seed=1000)
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


def serve_cli(bundle: str, root: str, names, graphs, predictor,
              count: int = SERVE["cli_requests"]) -> dict:
    """``python -m dgdm_histopath_torch.cli.serve`` on a free port: wait for
    ``/readyz``, ``count`` concurrent ``/predict`` within 2e-2 of ``predict_graph``,
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
        log(f"dp: {name} world {len(ranks)}, {DP['steps']} f32 Base steps ({32 // len(ranks)} "
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


def dp_cli(torch, card: str, cards: int, mesh: str = None) -> dict:
    """``python -m dgdm_histopath_torch.cli.train train --mesh-shape W``
    (one rank a card over NCCL) with DGDM-Base's model in the config, on
    DP["cli_graphs"] graph files of the Base geometry at f32 with dropout 0,
    so that W ranks and
    one process take the same draws: run A over W ranks against run S over
    one process (bundles within 1e-5 of max(1, the tensor's largest entry),
    the key biases to the steps' summed learning rate); run B stopped by a
    SIGTERM to the launcher once epoch 0's checkpoint is written (exit 75,
    a mid-epoch position), then ``resume`` with the same argv: its bundle
    equal to A's to the bit. ``mesh``: the ``--mesh-shape`` of runs A and B
    (default: ``cards``, data parallel; "2,2": data x model)."""
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

        mesh = mesh or str(cards)

        def argv(out, shape):
            return [sys.executable, "-m", "dgdm_histopath_torch.cli.train", "train",
                    "--config", f"{root}/config.json", "--data-dir", f"{root}/g",
                    "--dataset-type", "graph", "--metadata", f"{root}/labels.json",
                    "--num-classes", "2", "--seed", "0", "--log-level", "WARNING",
                    "--mesh-shape", str(shape), "--output-dir", f"{root}/{out}"]

        def run(args, what):
            t0 = time.perf_counter()
            res = subprocess.run(args, capture_output=True, text=True, timeout=900)
            if res.returncode != 0:
                raise AssertionError(f"{what} exited {res.returncode}: {res.stderr[-3000:]}")
            return time.perf_counter() - t0

        wall = {"A": run(argv("A", mesh), f"dgdm-train --mesh-shape {mesh}"),
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
            raise AssertionError(f"--mesh-shape {mesh}'s bundle differs from one process's: {worst_key} "
                                 f"at {worst:.3f} of its bound")
        only_rank0 = sorted(os.listdir(f"{root}/A"))

        proc = subprocess.Popen(argv("B", mesh), stdout=subprocess.DEVNULL,
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
        resume = argv("B", mesh)
        resume[3] = "resume"
        wall["resume"] = run(resume + ["--checkpoint-dir", f"{root}/B/checkpoints"],
                             "dgdm-train resume")
        pb = bundle_params(f"{root}/B/final_model.npz")
        differ = [k for k in pa if not np.array_equal(pa[k], pb[k])]
        if differ:
            raise AssertionError(f"the resumed run differs from run A: {differ[:8]}")
    log(f"dp: dgdm-train --mesh-shape {mesh} (DGDM-Base, NCCL, one card a rank, f32, "
        f"dropout 0) on {DP['cli_graphs']} graph files, {steps} steps of 32: rc 0 in "
        f"{wall['A']:.1f} s, one process {wall['S']:.1f} s; bundles within {worst:.3f} of their "
        f"bound ({worst_key}); rank 0 alone wrote {only_rank0}; SIGTERM to the launcher -> "
        f"75 at {position} after {wall['B']:.1f} s, resume {wall['resume']:.1f} s, its bundle "
        f"equal to run A's to the bit ({len(pa)} arrays) [{card}]")
    return {"wall_s": wall, "steps": steps, "worst_param_over_bound": worst,
            "worst_param": worst_key, "resume": position, "fixture_s": fixture_s,
            "outputs": only_rank0, "history": hist, "mesh": mesh}


# ---------------------------------------------------------------------------
# 16. the parallel tiers: TP, PP, EP, node sharding with the halo exchange and
#     the model over node-sharded inputs
# ---------------------------------------------------------------------------

# Every tier on one card runs as gloo ranks sharing it, held against one
# process in the same call (host-staged collectives: correctness, not speed);
# with --parallel-only on four cards over NCCL, one rank a card.
# dryrun_multichip over 8 gloo ranks runs every check of 4 and the pipe x
# expert mesh; four cards run it over their 4 NCCL ranks
PAR = dict(tp_epochs=(0, 1), pp_micro=4, dryruns={"gloo": (8,), "nccl": (4,)})
# biases whose true gradient is 0 (a shift that the softmax over the slots
# cancels): AdamW turns their rounding noise into lr-sized steps
SHIFT_INVARIANT = ("k_proj.bias", "risk.bias")
# The model over node-sharded inputs: DGDM-Base at full width on the first 8
# of the Base cell's graphs, Morton-sorted (f32 and bf16), and one graph of
# 8000 real nodes in the 8192 bucket, the JAX tier's own case (bf16).
SP = dict(batch=8, f32_atol=1e-4)
SP_BIG = dict(BASE, batch=1, bucket=8192, n_real=8000, seed=300)
# Training over node-sharded inputs (DGDMTrainer.training_step(block, epoch,
# prepared=True, plan=plan)): DGDM-Base on the 8 sorted graphs with labels, 3
# pretrain and 1 finetune steps in f32 without dropout and at the preset's
# dropout 0.1, both held to one process with the DP phase's bounds (metrics
# 1e-5 of max(1, |x|), parameters 1e-5 of max(1, the tensor's largest entry),
# the key biases to the summed learning rate), the first step's gradients to
# 1e-4 of each tensor's largest entry, and each parameter entry's bound plus
# what AdamW's first update makes of the two runs' first-step gradients there
# (``sp_f32_check``); the dropout masks follow the nodes, so two pooled nodes
# whose scores tie to rounding may swap slots and keep their masks. Then bf16
# at dropout 0.1 (launches, step times), and one bf16 pretrain step on the
# 8192-node graph (a rank's peak against one process's).
SP_TRAIN = dict(epochs=(0, 0, 0, 1), config=dict(learning_rate=1e-4, warmup_steps=0,
                                                 pretrain_epochs=1))
# DGDM-Large over node-sharded inputs (the sp_large job): the preset at full
# width (1024-d, hidden (768, 512, 256, 128), 16 heads x 8, 6 layers + the
# U-Net, both windows of 128) on the Large cell's 4 band-exact graphs (bucket
# 2048, 2000 real nodes), and configs/dgdm_xl_windowed.yaml's case: one
# band-exact graph of 8000 real nodes in the 8192 bucket, batch 1. Large: an
# inference forward and a return_attention one (the dense route, the bands
# kept) against one process, 3 pretrain + 1 finetune steps in f32 at dropout
# 0 and at the preset's 0.15 against one process (metrics 1e-5 of max(1,
# |x|), first-step gradients 1e-5 of each tensor's largest entry, parameters
# as the sp_train job's, logits and returned attention 1e-5, the pooled
# nodes' sets equal at each level and their scores within 3e-5 slot for
# slot: a score carries the rounding of the node embeddings, two nodes
# whose scores lie within it may swap slots, and sorting moves no value by
# more than the largest change of a score), a bf16 step. The score bound
# sits above the sound runs' largest reading (1.23e-5) and below what each
# of SCORE_FAULTS, planted in one process's forward, makes of the scores;
# the run fails if the check passes a planted fault. XL (bf16): a pretrain step and a
# return_attention forward ([1, 16, 4096, 8192] weights a rank at tp 2),
# each rank's peak above resident against one process's. Cut from a run's
# thousands of steps to these.
SP_LARGE = dict(seed=100, f32_atol=1e-5, grad_rel=1e-5, score_atol=3e-5)
# the pooling scores of one block (each level's second half of rows, the
# last rank's at tp 2) through bf16, or off by 5e-5 (a fault the earlier
# bound of 1e-4 let through)
SCORE_FAULTS = {"block_bf16": lambda t: t.bfloat16().float(), "block_plus_5e-5": lambda t: t + 5e-5}
SP_XL = dict(LARGE, batch=1, bucket=8192, n_real=8000, seed=400,
             config="configs/dgdm_xl_windowed.yaml")
# (name, compute dtype, dropout, batch, epochs)
SP_LARGE_RUNS = (
    ("float32", "float32", 0.0, "large_batch", SP_TRAIN["epochs"]),
    ("float32_dropout", "float32", LARGE["dropout"], "large_batch", SP_TRAIN["epochs"]),
    ("bfloat16", "bfloat16", LARGE["dropout"], "large_batch", (0,)),
    ("xl", "bfloat16", LARGE["dropout"], "xl_batch", (0,)))
# The MoE and remat over node-sharded inputs (the sp_moe and sp_remat jobs).
# sp_moe: configs/dgdm_base_moe.yaml's model (MOE["model"]: 4 experts, top-1,
# capacity 1.5, groups of 1024 tokens, moe_hidden 256) at full width on the 8
# sorted Base graphs (bucket 1024: a group is one graph, over both ranks'
# blocks): an f32 inference forward against one process (logits 1e-5, the
# aux loss 1e-6, each expert's kept and dropped tokens equal), the runs of
# SP_TRAIN at dropout 0 and 0.1 with SP_TRAIN's bounds, and one bf16 step on
# the 8192-node graph (groups inside a block; a rank's peak above resident
# against one process's). A token's first choice may flip where its two
# largest router probabilities lie within ``tie`` of each other (the f32
# rounding of its block's router input, ~2e-6 on the card); the check allows
# no other flip and counts these: in the forward each expert's counts then
# within the flips and the logits compared on the graphs without one; in a
# training run the steps before the first flip held to the bounds (the flip
# moves a token to another expert, so the runs train different functions
# from there; the flip's step and later ones are reported). The run fails
# if the check lets the planted fault through: one process's probabilities
# with ``fault`` added to expert 0 on the last rank's rows of every graph.
SP_MOE = dict(tie=1e-5, fault=1e-2, f32_atol=1e-5, aux_atol=1e-6)
# sp_remat: DGDM-Base with use_remat, the f32 run of SP_TRAIN at dropout 0.1
# against one process with remat, and one bf16 step on the 8192-node graph:
# a rank's peak above resident with remat, beside the sp_train job's without
# it and one process's with it. The recompute runs each encoder layer's key
# gather, its three outgoing-row gathers and its two aggregations again.
# (name, compute dtype, dropout, batch, plans, epochs)
SP_MOE_RUNS = (
    ("float32", "float32", 0.0, "sp_train_batch", "sp_plans", SP_TRAIN["epochs"]),
    ("float32_dropout", "float32", 0.1, "sp_train_batch", "sp_plans", SP_TRAIN["epochs"]),
    ("big", "bfloat16", 0.1, "sp_big", "sp_big_plans", (0,)))
SP_REMAT_RUNS = (
    ("float32_dropout", "float32", 0.1, "sp_train_batch", "sp_plans", SP_TRAIN["epochs"]),
    ("big", "bfloat16", 0.1, "sp_big", "sp_big_plans", (0,)))


def par_meshes(world: int) -> dict:
    """The mesh shapes of each tier for a world of 2 (one card) or 4."""
    if world == 2:
        return {"tp": (1, 2), "pp": (1, 2), "ep": (1, 2), "halo": (1, 2), "sp": (1, 2)}
    return {"tp": (2, 2), "pp": (1, 4), "ep": (2, 2), "halo": (1, 4), "sp": (1, 4)}


def sp_train_expected_launches(cell: dict, remat: bool = False) -> dict:
    """A rank's launches in one training step over node-sharded inputs: the
    forward's of ``sp_forward`` (the outgoing-rows gathers included), one
    backward launch for each of its gathers and aggregations, and four
    transposed lists: the [local || halo] table's and the outgoing rows' at
    the full-N levels, one for each pooled level. With ``remat`` the
    backward runs each encoder layer's forward again: its key gather, the
    three outgoing-row gathers of its halo tables and its two aggregations
    (no list: the recompute reads the level's)."""
    fwd = sp_expected_launches(cell)
    again = cell["encoder_layers"] if remat else 0
    return {**fwd, "gather_rows": fwd["gather_rows"] + 4 * again,
            "gather_agg": fwd["gather_agg"] + 2 * again,
            "gather_rows_bwd": fwd["gather_rows"], "gather_agg_bwd": fwd["gather_agg"],
            "neighbor_transpose": 4}


def sp_expected_launches(cell: dict) -> dict:
    """A rank's launches in one ``sp_forward``: a forward's (each
    DynamicGraphLayer one key gather and two aggregations) and, at each of the
    full-N layers (the encoder's and the U-Net's down0 and up0), one
    gather_rows more for each of the three halo tables it reads (the key
    table and both convolutions' features). The pooled levels read
    all-gathered tables and launch as one process does."""
    full = cell["encoder_layers"] + 2
    return {**expected_launches(cell, training=False),
            "gather_rows": cell["layers"] + 3 * full}


def par_rank(rank: int, size: int, backend: str, root: str, jobs: list) -> None:
    """One rank of the parallel phase: for each (job, world) in ``jobs`` the
    process group of that world (made anew where the size changes; ranks
    beyond it sit the job out), the job, its result and wall seconds in
    ``root``."""
    import os
    import traceback

    import torch
    import torch.distributed as dist

    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        card = rank if backend == "nccl" else 0
        torch.cuda.set_device(card)
        spec = torch.load(f"{root}/spec.pt", weights_only=False)
        current, results = None, {}
        for i, (job, world) in enumerate(jobs):
            if world != current:
                current = world
                if dist.is_initialized():
                    dist.destroy_process_group()
                if rank < world:
                    dist.init_process_group(backend, init_method=f"file://{root}/rdv{i}",
                                            world_size=world, rank=rank)
            if rank < world:
                t0 = time.perf_counter()
                results[job] = PAR_JOBS[job](torch, spec, f"cuda:{card}")
                results.setdefault("seconds", {})[job] = time.perf_counter() - t0
        if dist.is_initialized():
            dist.destroy_process_group()
        torch.save(results, f"{root}/result{rank}.pt")
    except BaseException:  # noqa: BLE001 - reported to the parent by the exit code
        traceback.print_exc()
        os._exit(1)


def counted_call(torch, fn):
    """(fn(), this call's kernel launches): the counts set to 0 just before."""
    from dgdm_histopath_torch.ops import kernels

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, kernels.launch_counts()


def par_tp(torch, spec, device) -> dict:
    """DGDM-Base (f32, dropout 0) tensor-parallel over (data, model): two
    pretrain steps with the given draws and a finetune step; each step's
    metrics, launches and wall time, the whole parameters, this rank's
    parameter and AdamW bytes."""
    import torch.distributed as dist

    from dgdm_histopath_torch import DGDMTrainer, TrainerConfig, create_model
    from dgdm_histopath_torch.parallel import make_mesh
    from dgdm_histopath_torch.parallel.tp import optimizer_bytes, param_bytes

    shape = par_meshes(dist.get_world_size())["tp"]
    model = create_model("dgdm-base", num_classes=2, compute_dtype="float32", dropout=0.0,
                         device=device, seed=1)
    trainer = DGDMTrainer(model, TrainerConfig(**spec["config"]), device=device,
                          mesh=make_mesh(axes=("data", "model"), shape=shape))
    trainer.init_state(seed=0)
    metrics, launches, ms = [], [], []
    for epoch, draws in zip(PAR["tp_epochs"], spec["draws"]):
        draws = None if draws is None else {k: v.to(device) for k, v in draws.items()}
        t0 = time.perf_counter()
        m, counts = counted_call(torch, lambda: trainer.training_step(
            spec["batch"], epoch, draws=draws))
        ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append(m)
        launches.append(counts)
    return {"metrics": metrics, "launches": launches, "step_ms": ms, "shape": shape,
            "sharded": len(model.tp_layout),
            "params": {k: v.cpu() for k, v in trainer.model_state_dict().items()},
            "bytes": (param_bytes(trainer.params), optimizer_bytes(trainer.optimizer))}


def par_pp(torch, spec, device) -> dict:
    """Base's GraphEncoder pipelined over (1, S) (data, pipe), ``num_micro``
    4: output, gradients of sum(out²) (this stage's layers and the
    projections), the launches of forward + backward."""
    import torch.distributed as dist

    from dgdm_histopath_torch import create_model
    from dgdm_histopath_torch.parallel import make_mesh, pp_graph_encoder_apply

    shape = par_meshes(dist.get_world_size())["pp"]
    mesh = make_mesh(axes=("data", "pipe"), shape=shape)
    enc = create_model("dgdm-base", num_classes=2, compute_dtype="float32", dropout=0.0,
                       device=device, seed=1).graph_encoder
    g = spec["pp"]

    def run():
        y = pp_graph_encoder_apply(enc, mesh, *(t.to(device) for t in g),
                                   num_micro=PAR["pp_micro"])
        (y ** 2).sum().backward()
        return y.detach()

    y, launches = counted_call(torch, run)
    t0 = time.perf_counter()
    enc.zero_grad()
    run()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    return {"out": y.cpu(), "launches": launches, "wall_ms": wall, "shape": shape,
            "stage": mesh.axis("pipe").index,
            "grads": {k: p.grad.cpu() for k, p in enc.named_parameters() if p.grad is not None}}


def par_ep(torch, spec, device) -> dict:
    """The MoE block of configs/dgdm_base_moe.yaml with its experts over (data,
    expert): output, aux loss, routing and the gradients of sum(out²) + aux."""
    import torch.distributed as dist

    from dgdm_histopath_torch.nn.moe import MoEFFN
    from dgdm_histopath_torch.parallel import make_mesh, place_experts

    shape = par_meshes(dist.get_world_size())["ep"]
    mesh = make_mesh(axes=("data", "expert"), shape=shape)
    moe = MoEFFN(**spec["moe_kw"]).to(device)
    moe.load_state_dict(spec["moe_state"])
    placed = place_experts(moe, mesh)
    x = spec["moe_x"].to(device).requires_grad_()
    mask = spec["mask"].to(device)
    out, aux = moe(x, mask)
    ((out ** 2).sum() + aux).backward()
    kept = moe.route(x.detach(), mask)["kept"]
    return {"placed": placed, "out": out.detach().cpu(), "aux": float(aux.detach()), "dx": x.grad.cpu(),
            "kept": kept.cpu(), "index": mesh.axis("expert").index, "shape": shape,
            "grads": {k: p.grad.cpu() for k, p in moe.named_parameters()}}


def par_halo(torch, spec, device) -> dict:
    """This rank's node block of the Morton-sorted Base graphs: halo_gather
    and sp_graph_conv over the model axis, each with its launches."""
    import torch.distributed as dist

    from dgdm_histopath_torch.nn.graph_layers import GraphConvolution
    from dgdm_histopath_torch.parallel import (halo_gather, make_mesh, shard_graph_nodes,
                                               sp_graph_conv)

    shape = par_meshes(dist.get_world_size())["halo"]
    mesh = make_mesh(axes=("data", "model"), shape=shape)
    plan = spec["plans"][shape[1]]
    block = shard_graph_nodes(spec["sorted"], mesh).to(device)
    conv = GraphConvolution(*spec["conv"]).to(device)
    conv.load_state_dict(spec["conv_state"])
    gathered, g_launch = counted_call(torch, lambda: halo_gather(block.x, plan, mesh))
    with torch.no_grad():
        sp, s_launch = counted_call(torch, lambda: sp_graph_conv(
            conv, block.x, block.nbr_idx, block.nbr_mask, plan, mesh,
            edge_attr=block.edge_attr))
    return {"gather": gathered.cpu(), "sp": sp.cpu(), "launches": g_launch,
            "sp_launches": s_launch, "index": mesh.axis("model").index, "tp": shape[1]}


def sp_measure(torch, fn) -> dict:
    """One forward ``fn()`` without a gradient: its output, its launches
    (counted alone), its peak memory (of the process, and above what was
    allocated before it) and the wall time of a second call."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    with torch.no_grad():
        out, launches = counted_call(torch, fn)
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    with torch.no_grad():
        fn()
    torch.cuda.synchronize()
    return {"out": out, "launches": launches, "peak_gib": peak / 2 ** 30,
            "above_gib": (peak - before) / 2 ** 30, "wall_ms": (time.perf_counter() - t0) * 1e3}


def sp_model(torch, dtype: str, device, preset: str = "dgdm-base", **model_kw):
    from dgdm_histopath_torch import create_model

    return create_model(preset, num_classes=2, compute_dtype=dtype, dropout=0.0,
                        device=device, seed=1, **model_kw)


def sp_result(r: dict, sel, emb: bool) -> dict:
    """The host copy of a measured forward: logits, selections, numbers."""
    out = r.pop("out")
    r.update(logits=out["classification_logits"].float().cpu(), sel=[t.cpu() for t in sel])
    if emb:
        r["emb"] = out["node_embeddings"].float().cpu()
    return r


def par_sp(torch, spec, device) -> dict:
    """DGDM-Base over node-sharded inputs (``sp_forward``) on this rank's block,
    f32 and bf16 on the 8 sorted Base graphs and bf16 on the 8192-node graph:
    logits, selections, launches, peak memory and wall time of each."""
    import torch.distributed as dist

    from dgdm_histopath_torch.parallel import make_mesh, shard_graph_nodes, sp_forward

    shape = par_meshes(dist.get_world_size())["sp"]
    mesh = make_mesh(axes=("data", "model"), shape=shape)
    out = {"tp": shape[1], "index": mesh.axis("model").index}
    for name, dtype, batch, plans in (("float32", "float32", "sp_batch", "sp_plans"),
                                      ("bfloat16", "bfloat16", "sp_batch", "sp_plans"),
                                      ("big", "bfloat16", "sp_big", "sp_big_plans")):
        model = sp_model(torch, dtype, device)
        block = shard_graph_nodes(spec[batch], mesh).to(device)
        plan = spec[plans][shape[1]]
        r = sp_measure(torch, lambda: sp_forward(model, block, plan, mesh))
        out[name] = sp_result(r, r["out"]["pool_sel_idx"], emb=name == "float32")
        del model, block
        torch.cuda.empty_cache()
    return out


def sp_trainer(torch, dtype: str, dropout: float, device, mesh=None,
               preset: str = "dgdm-base", **model_kw):
    from dgdm_histopath_torch import DGDMTrainer, TrainerConfig, create_model

    model = create_model(preset, num_classes=2, compute_dtype=dtype, dropout=dropout,
                         device=device, seed=1, **model_kw)
    trainer = DGDMTrainer(model, TrainerConfig(**SP_TRAIN["config"]), device=device,
                          mesh=mesh)
    trainer.init_state(seed=0)
    return trainer


def whole_grads(torch, trainer) -> dict:
    """The parameters' gradients as whole tensors on the host (gathered over
    the model line where the trainer keeps tensor-parallel shards)."""
    from dgdm_histopath_torch.parallel.tp import gather_state

    grads = {k: p.grad.detach() for k, p in trainer.model.named_parameters()}
    if trainer._tp is not None:
        grads = gather_state(grads, trainer.model.tp_layout, trainer._tp)
    return {k: v.cpu() for k, v in grads.items()}


def with_selections(fn, scores: list = None):
    """(fn(), each pooled level's selection [b, keep] that the U-Net's
    compaction made in it, whole-level node ids, on the host): the one
    process's ``AdaptiveGraphPooling`` and ``sp_forward``'s compaction both
    call ``compact_top_k_nodes``. ``scores``, where given, receives the
    selected nodes' scores in slot order (f32, on the host)."""
    from dgdm_histopath_torch.nn import graph_layers
    from dgdm_histopath_torch.parallel import sp

    real, seen = graph_layers.compact_top_k_nodes, []

    def record(*args, **kwargs):
        c = real(*args, **kwargs)
        seen.append(c["sel_idx"].cpu())
        if scores is not None:
            score = args[4] if len(args) > 4 else kwargs["score"]
            scores.append(score.float().gather(-1, c["sel_idx"]).cpu())
        return c

    graph_layers.compact_top_k_nodes = sp.compact_top_k_nodes = record
    try:
        return fn(), seen
    finally:
        graph_layers.compact_top_k_nodes = sp.compact_top_k_nodes = real


def score_fault_selections(torch, model, on, fault) -> tuple:
    """One process's forward of ``model`` on ``on`` with ``fault`` applied
    to the pooling scores of each level's second half of rows (a block's
    score path gone wrong): (its selections, their scores), as
    ``with_selections`` records them."""
    from dgdm_histopath_torch.nn.graph_layers import AdaptiveGraphPooling

    real = AdaptiveGraphPooling.gate

    def gate(self, x):
        score, _ = real(self, x)
        half = score.shape[-1] // 2
        score = torch.cat([score[..., :half], fault(score[..., half:])], -1)
        return score, x * torch.sigmoid(score).to(x.dtype)[..., None]

    AdaptiveGraphPooling.gate = gate
    scores = []
    try:
        with torch.no_grad():
            _, sel = with_selections(lambda: model(on), scores)
    finally:
        AdaptiveGraphPooling.gate = real
    return sel, scores


def sp_train_run(torch, trainer, epochs, step, grads: bool = False) -> dict:
    """``step(epoch)`` for each epoch: metrics, launches and wall ms of each
    step, and the peak memory of the run (of the process, and above what was
    allocated before it); with ``grads`` the first step's (clipped)
    gradients and pooled selections."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    metrics, launches, ms, out = [], [], [], {"sel0_scores": []}
    for epoch in epochs:
        first = grads and not metrics
        t0 = time.perf_counter()
        m, counts = counted_call(torch, (lambda: with_selections(
            lambda: step(epoch), out["sel0_scores"])) if first else (lambda: step(epoch)))
        ms.append((time.perf_counter() - t0) * 1e3)
        if first:
            m, out["sel0"] = m
            out["grads0"] = whole_grads(torch, trainer)
        metrics.append(m)
        launches.append(counts)
    peak = torch.cuda.max_memory_allocated()
    return {**out, "metrics": metrics, "launches": launches, "step_ms": ms,
            "peak_gib": peak / 2 ** 30, "above_gib": (peak - before) / 2 ** 30}


# (name, compute dtype, dropout, batch, plans, epochs)
SP_TRAIN_RUNS = (
    ("float32", "float32", 0.0, "sp_train_batch", "sp_plans", SP_TRAIN["epochs"]),
    ("float32_dropout", "float32", 0.1, "sp_train_batch", "sp_plans", SP_TRAIN["epochs"]),
    ("bfloat16", "bfloat16", 0.1, "sp_train_batch", "sp_plans", (0,)),
    ("big", "bfloat16", 0.1, "sp_big", "sp_big_plans", (0,)))
F32_RUNS = ("float32", "float32_dropout")
SP_TRAIN_NAMES = tuple(r[0] for r in SP_TRAIN_RUNS)


def par_sp_train(torch, spec, device, runs=SP_TRAIN_RUNS, out=None, **model_kw) -> dict:
    """DGDM-Base training over node-sharded inputs through ``training_step(
    block, epoch, prepared=True, plan=plan)`` on this rank's block (the
    ``sp`` mesh): each run of ``runs`` with its metrics, launches, step wall
    times and peak memory, and the whole parameters after the f32 runs;
    ``model_kw`` the model's options (the MoE's, ``use_remat``)."""
    import torch.distributed as dist

    from dgdm_histopath_torch.parallel import make_mesh, shard_graph_nodes

    shape = par_meshes(dist.get_world_size())["sp"]
    mesh = make_mesh(axes=("data", "model"), shape=shape)
    out = {**(out or {}), "tp": shape[1], "index": mesh.axis("model").index}
    for name, dtype, dropout, batch, plans, epochs in runs:
        trainer = sp_trainer(torch, dtype, dropout, device, mesh, **model_kw)
        block = shard_graph_nodes(spec[batch], mesh).to(device)
        plan = spec[plans][shape[1]]
        routing = []
        if trainer.model.moe_experts:
            moe_routing(torch, trainer.model, routing)
        out[name] = sp_train_run(torch, trainer, epochs, lambda e: trainer.training_step(
            block, e, prepared=True, plan=plan), grads=name in F32_RUNS)
        out[name]["routing"] = routing
        if name in F32_RUNS:
            out[name]["params"] = {k: v.cpu() for k, v in trainer.model_state_dict().items()}
        del trainer, block
        torch.cuda.empty_cache()
    return out


def moe_routing(torch, model, record: list) -> None:
    """Hook ``model``'s MoE block: each call appends its routing (the
    block's line of groups over node blocks) to ``record``: the router's
    probabilities, first choices (one-hot, dropped tokens included) and kept
    tokens [g, G, E] and the token mask [g, G], on the host."""
    def hook(m, args, kwargs, out):
        with torch.no_grad():
            r = m.route(args[0], args[1], kwargs.get("group_size"), kwargs.get("block"))
        record.append({k: r[k].float().cpu() for k in ("probs", "first_choice", "kept", "mask")})

    model.moe_ffn.register_forward_hook(hook, with_kwargs=True)


def par_sp_moe(torch, spec, device) -> dict:
    """configs/dgdm_base_moe.yaml's DGDM-Base over node-sharded inputs on this
    rank's block (the ``sp`` mesh): the f32 inference forward (logits, aux
    loss, the routing of its line's groups, launches, peak memory), then the
    runs of SP_MOE_RUNS through ``training_step(block, epoch, prepared=True,
    plan=plan)``."""
    import torch.distributed as dist

    from dgdm_histopath_torch.parallel import make_mesh, shard_graph_nodes, sp_forward

    shape = par_meshes(dist.get_world_size())["sp"]
    mesh = make_mesh(axes=("data", "model"), shape=shape)
    model = sp_model(torch, "float32", device, **MOE["model"])
    routing = []
    moe_routing(torch, model, routing)
    block = shard_graph_nodes(spec["sp_batch"], mesh).to(device)
    r = sp_measure(torch, lambda: sp_forward(model, block, spec["sp_plans"][shape[1]], mesh))
    aux = float(r["out"]["moe_aux_loss"])
    forward = dict(sp_result(r, [], emb=False), aux=aux, routing=routing[0])
    del model, block, r
    torch.cuda.empty_cache()
    return par_sp_train(torch, spec, device, SP_MOE_RUNS, {"forward": forward}, **MOE["model"])


def par_sp_remat(torch, spec, device) -> dict:
    """DGDM-Base with ``use_remat`` over node-sharded inputs: the runs of
    SP_REMAT_RUNS on this rank's block."""
    return par_sp_train(torch, spec, device, SP_REMAT_RUNS, use_remat=True)


def sp_attention_rows(out: dict) -> dict:
    """The returned attention of a forward on the host: the edge attentions
    of each encoder layer, the spatial attention's weights, the readout's."""
    return {**{f"edge_attentions {i}": a.cpu() for i, a in enumerate(out["edge_attentions"])},
            "spatial_attention": out["spatial_attention"].cpu(),
            "attention_weights": out["attention_weights"].cpu()}


def par_sp_large(torch, spec, device) -> dict:
    """DGDM-Large over node-sharded inputs on this rank's block (the ``sp``
    mesh): the f32 forward (logits, selections, node embeddings) and the
    f32 ``return_attention`` forward (its rows of the returned attention) on
    the Large graphs, each run of ``SP_LARGE_RUNS`` through
    ``training_step(block, epoch, prepared=True, plan=plan)``, the bf16
    ``return_attention`` forward on the 8192-node graph; launches, peak
    memory and wall times of each."""
    import torch.distributed as dist

    from dgdm_histopath_torch.parallel import make_mesh, shard_graph_nodes, sp_forward

    shape = par_meshes(dist.get_world_size())["sp"]
    mesh = make_mesh(axes=("data", "model"), shape=shape)
    tp = shape[1]
    out = {"tp": tp, "index": mesh.axis("model").index}
    model = sp_model(torch, "float32", device, "dgdm-large")
    block = shard_graph_nodes(spec["large_batch"], mesh).to(device)
    plan = spec["large_plans"][tp]
    scores = []
    r, sel = with_selections(lambda: sp_measure(torch, lambda: sp_forward(
        model, block, plan, mesh)), scores)
    out["forward"] = dict(sp_result(r, sel, emb=True), scores=scores)
    r = sp_measure(torch, lambda: sp_forward(model, block, plan, mesh, return_attention=True))
    attention = sp_attention_rows(r["out"])
    out["attention"] = dict(sp_result(r, [], emb=False), rows=attention)
    del model, block, r
    torch.cuda.empty_cache()
    for name, dtype, dropout, batch, epochs in SP_LARGE_RUNS:
        trainer = sp_trainer(torch, dtype, dropout, device, mesh, "dgdm-large")
        block = shard_graph_nodes(spec[batch], mesh).to(device)
        plan = spec[batch.replace("batch", "plans")][tp]
        out[name] = sp_train_run(torch, trainer, epochs, lambda e: trainer.training_step(
            block, e, prepared=True, plan=plan), grads=name in F32_RUNS)
        if name in F32_RUNS:
            out[name]["params"] = {k: v.cpu() for k, v in trainer.model_state_dict().items()}
        del trainer, block
        torch.cuda.empty_cache()
    model = sp_model(torch, "bfloat16", device, "dgdm-large")
    block = shard_graph_nodes(spec["xl_batch"], mesh).to(device)
    r = sp_measure(torch, lambda: sp_forward(model, block, spec["xl_plans"][tp], mesh,
                                             return_attention=True))
    weights = r["out"]["spatial_attention"]
    r["weights_shape"] = tuple(weights.shape)
    r["finite"] = all(bool(torch.isfinite(t).all()) for t in (
        weights, r["out"]["classification_logits"], *r["out"]["edge_attentions"]))
    out["xl_attention"] = sp_result(r, [], emb=False)
    del model, block, r, weights
    torch.cuda.empty_cache()
    return out


def sp_train_spec(torch, spec: dict, ref: dict, device="cuda") -> None:
    """The labelled batch of the node-sharded steps into ``spec``, and one
    process's runs on the whole batches: of ``SP_TRAIN_RUNS`` into
    ``ref["sp_train"]``, of the MoE model's forward (its routing hooked) and
    ``SP_MOE_RUNS`` into ``ref["sp_moe"]``, of ``SP_REMAT_RUNS`` with remat
    into ``ref["sp_remat"]``."""
    gen = torch.Generator().manual_seed(15)
    b = spec["sp_batch"].x.shape[0]
    spec["sp_train_batch"] = spec["sp_batch"].replace(y=torch.randint(0, 2, (b,),
                                                                      generator=gen))
    model = sp_model(torch, "float32", device, **MOE["model"])
    routing = []
    moe_routing(torch, model, routing)
    on = spec["sp_batch"].to(device)
    r = sp_measure(torch, lambda: model(on))
    aux = float(r["out"]["moe_aux_loss"])
    forward = dict(sp_result(r, [], emb=False), aux=aux, routing=routing[0])
    del model, on, r
    torch.cuda.empty_cache()
    for key, runs, model_kw in (("sp_train", SP_TRAIN_RUNS, {}),
                                ("sp_moe", SP_MOE_RUNS, MOE["model"]),
                                ("sp_remat", SP_REMAT_RUNS, {"use_remat": True})):
        ref[key] = {"forward": forward} if key == "sp_moe" else {}
        for name, dtype, dropout, batch, _, epochs in runs:
            trainer = sp_trainer(torch, dtype, dropout, device, **model_kw)
            on = spec[batch].to(device)
            routing = []
            if trainer.model.moe_experts:
                moe_routing(torch, trainer.model, routing)
            r = sp_train_run(torch, trainer, epochs, lambda e: trainer.training_step(on, e),
                             grads=name in F32_RUNS)
            r["routing"] = routing
            if name in F32_RUNS:
                r["params"] = {k: v.detach().cpu() for k, v in trainer.model.named_parameters()}
            ref[key][name] = r
            del trainer, on
            torch.cuda.empty_cache()


def par_dryrun(n: int):
    def job(torch, spec, device) -> dict:
        from dgdm_histopath_torch.parallel import dryrun_multichip

        t0 = time.perf_counter()
        out = dryrun_multichip(n, device)
        out["wall_s"] = time.perf_counter() - t0
        return out
    return job


PAR_JOBS = {"tp": par_tp, "pp": par_pp, "ep": par_ep, "halo": par_halo, "sp": par_sp,
            "sp_train": par_sp_train, "sp_moe": par_sp_moe, "sp_remat": par_sp_remat,
            "sp_large": par_sp_large,
            **{f"dryrun{n}": par_dryrun(n) for ns in PAR["dryruns"].values() for n in ns}}


def par_spec(torch, graphs) -> tuple:
    """The inputs of every job (on the host) and the one-process references
    on the card: the Base batch with labels and three steps' draws, the
    encoder input of the Base graphs, the MoE block and its input, the
    Morton-sorted graphs and their plans."""
    from dgdm_histopath_torch import DGDMTrainer, TrainerConfig, batch_graphs, create_model
    from dgdm_histopath_torch.nn.graph_layers import GraphConvolution
    from dgdm_histopath_torch.nn.layers import init_parameters
    from dgdm_histopath_torch.nn.moe import MoEFFN
    from dgdm_histopath_torch.parallel import halo

    gen = torch.Generator().manual_seed(11)
    batch = batch_graphs(graphs)
    b, n = batch.node_mask.shape
    batch = batch.replace(y=torch.randint(0, 2, (b,), generator=gen))
    draws = [{"masked": (torch.rand(b, n, generator=gen) < 0.15) & batch.node_mask,
              "t": torch.randint(0, 10, (b,), generator=gen),
              "noise": torch.randn(b, n, 128, generator=gen),
              "uniform": torch.rand(b, n, generator=gen)} if e == 0 else None
             for e in PAR["tp_epochs"]]
    config = dict(learning_rate=1e-4, warmup_steps=0, pretrain_epochs=1)
    ref: dict = {}

    # TP: one process, the same steps
    model = create_model("dgdm-base", num_classes=2, compute_dtype="float32", dropout=0.0,
                         device="cuda", seed=1)
    trainer = DGDMTrainer(model, TrainerConfig(**config), device="cuda")
    trainer.init_state(seed=0)
    ref["tp"] = [trainer.training_step(batch, e, draws=None if d is None else {
        k: v.to("cuda") for k, v in d.items()}) for e, d in zip(PAR["tp_epochs"], draws)]
    ref["tp_params"] = {k: v.detach().cpu() for k, v in model.named_parameters()}
    ref["tp_bytes"] = (sum(p.numel() * 4 for p in trainer.params),
                       sum(t.numel() * t.element_size() for s in trainer.optimizer.state.values()
                           for t in s.values() if torch.is_tensor(t) and t.dim() > 0))
    del trainer

    # the encoder's input: the feature encoder's output of the Base graphs
    fresh = create_model("dgdm-base", num_classes=2, compute_dtype="float32", dropout=0.0,
                         device="cuda", seed=1)
    on = batch.to("cuda")
    with torch.no_grad():
        h0 = fresh.feature_encoder(on.x)
    pp_in = (h0.cpu(), batch.nbr_idx, batch.nbr_mask, batch.node_mask, batch.edge_attr)
    enc = fresh.graph_encoder
    y = enc(h0, on.nbr_idx, on.nbr_mask, on.node_mask, edge_attr=on.edge_attr)["embeddings"]
    (y ** 2).sum().backward()
    ref["pp"] = y.detach().cpu()
    ref["pp_grads"] = {k: p.grad.cpu() for k, p in enc.named_parameters() if p.grad is not None}

    # EP: the MoE block of configs/dgdm_base_moe.yaml, replicated
    moe_kw = dict(features=128, hidden_dim=256, num_experts=4, top_k=1, capacity_factor=1.5,
                  dtype=torch.float32)
    moe = init_parameters(MoEFFN(**moe_kw), torch.Generator().manual_seed(12)).to("cuda")
    x = h0.detach().clone().requires_grad_()
    out, aux = moe(x, on.node_mask)
    ((out ** 2).sum() + aux).backward()
    ref["ep"] = {"out": out.detach().cpu(), "aux": float(aux.detach()), "dx": x.grad.cpu(),
                 "kept": moe.route(h0, on.node_mask)["kept"].cpu(),
                 "grads": {k: p.grad.cpu() for k, p in moe.named_parameters()}}

    # the halo tier: Morton-sorted Base graphs, their features as the encoder sees them
    t0 = time.perf_counter()
    sorted_graphs = [halo.spatial_sort(g) for g in graphs]
    srt = batch_graphs(sorted_graphs)
    with torch.no_grad():
        srt = srt.replace(x=fresh.feature_encoder(srt.x.to("cuda")).cpu())
    plans = {tp: halo.build_halo_plan(srt.nbr_idx, srt.nbr_mask, tp) for tp in (2, 4)}
    plan_s = time.perf_counter() - t0
    conv = init_parameters(GraphConvolution(128, 128, 3), torch.Generator().manual_seed(13))
    conv = conv.to("cuda")
    s_on = srt.to("cuda")
    with torch.no_grad():
        ref["conv"] = conv(s_on.x, s_on.nbr_idx, s_on.nbr_mask, s_on.edge_attr).cpu()
        from dgdm_histopath_torch.ops.kernels.gather_rows import gather_rows
        ref["dense_gather"] = gather_rows(s_on.x, s_on.nbr_idx).cpu()
    ref["halo"] = {tp: {"H": p.halo_size, "fraction": halo.halo_fraction(
        srt.nbr_idx, srt.nbr_mask, tp)} for tp, p in plans.items()}
    ref["plan_s"] = plan_s
    spec = {"batch": batch, "draws": draws, "config": config, "pp": pp_in,
            "moe_kw": moe_kw, "moe_state": {k: v.cpu() for k, v in moe.state_dict().items()},
            "moe_x": h0.cpu(), "mask": batch.node_mask, "sorted": srt, "plans": plans,
            "conv": (128, 128, 3), "conv_state": {k: v.cpu() for k, v in conv.state_dict().items()}}
    del fresh, moe, conv, model
    torch.cuda.empty_cache()
    sp_spec(torch, graphs, spec, ref)
    sp_train_spec(torch, spec, ref)
    sp_large_spec(torch, spec, ref)
    return spec, ref


def sp_large_spec(torch, spec: dict, ref: dict, device="cuda") -> None:
    """The sp_large job's inputs into ``spec``: the Large cell's band-exact
    graphs with labels and the XL config's 8192-node graph (already in
    Morton order: a re-sort could move an edge out of its band), their plans
    for a model axis of 2 and 4; and one process's runs on the whole
    batches into ``ref["sp_large"]``: the f32 forward, each run of
    ``SP_LARGE_RUNS``, the XL bf16 ``return_attention`` forward (its returned
    attention is compared after the ranks, ``sp_large_attention``)."""
    from dgdm_histopath_torch import batch_graphs, create_model
    from dgdm_histopath_torch.ops.graph import in_band_fraction
    from dgdm_histopath_torch.parallel import halo
    from dgdm_histopath_torch.utils.config import load_config

    probe = create_model("dgdm-large", device="cpu", seed=0)
    yaml_model_matches(probe, load_config(SP_XL["config"]))
    del probe
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(17)
    for key, cell in (("large", LARGE), ("xl", SP_XL)):
        graphs = make_graphs(cell, seed=SP_LARGE["seed"] if key == "large" else cell["seed"])
        frac = min(in_band_fraction(g.nbr_idx, g.nbr_mask, cell["window"]) for g in graphs)
        if frac != 1.0:
            raise AssertionError(f"sp_large: the {key} graphs are not band-exact ({frac})")
        batch = batch_graphs(graphs)
        spec[f"{key}_batch"] = batch.replace(y=torch.randint(0, 2, (len(graphs),),
                                                             generator=gen))
        spec[f"{key}_plans"] = {tp: halo.build_halo_plan(batch.nbr_idx, batch.nbr_mask, tp)
                                for tp in (2, 4)}
    one = ref["sp_large"] = {"inputs_s": time.perf_counter() - t0}
    model = sp_model(torch, "float32", device, "dgdm-large")
    on = spec["large_batch"].to(device)
    scores = []
    r, sel = with_selections(lambda: sp_measure(torch, lambda: model(on)), scores)
    one["forward"] = dict(sp_result(r, sel, emb=True), scores=scores)
    one["faults"] = {}
    for name, fault in SCORE_FAULTS.items():
        got, got_scores = score_fault_selections(torch, model, on, fault)
        one["faults"][name] = selection_check(got, sel[:len(got)], got_scores,
                                              scores[:len(got)])
    del model, on, r
    torch.cuda.empty_cache()
    for name, dtype, dropout, batch, epochs in SP_LARGE_RUNS:
        trainer = sp_trainer(torch, dtype, dropout, device, preset="dgdm-large")
        on = spec[batch].to(device)
        r = sp_train_run(torch, trainer, epochs, lambda e: trainer.training_step(on, e),
                         grads=name in F32_RUNS)
        if name in F32_RUNS:
            r["params"] = {k: v.detach().cpu() for k, v in trainer.model.named_parameters()}
        one[name] = r
        del trainer, on
        torch.cuda.empty_cache()
    model = sp_model(torch, "bfloat16", device, "dgdm-large")
    on = spec["xl_batch"].to(device)
    r = sp_measure(torch, lambda: model(on, return_attention=True))
    one["xl_attention"] = sp_result(r, [], emb=False)
    del model, on, r
    torch.cuda.empty_cache()


def sp_spec(torch, graphs, spec: dict, ref: dict, device="cuda") -> None:
    """The inputs of the ``sp_forward`` job (the sorted graphs and their
    plans for a model axis of 2 and 4) into ``spec``, and one process's
    forward of the same model on each into ``ref["sp"]``."""
    from dgdm_histopath_torch import batch_graphs
    from dgdm_histopath_torch.parallel import halo

    t0 = time.perf_counter()
    spec["sp_batch"] = batch_graphs([halo.spatial_sort(g) for g in graphs[:SP["batch"]]])
    spec["sp_big"] = batch_graphs([halo.spatial_sort(g)
                                   for g in make_graphs(SP_BIG, seed=SP_BIG["seed"])])
    for key, plans in (("sp_batch", "sp_plans"), ("sp_big", "sp_big_plans")):
        spec[plans] = {tp: halo.build_halo_plan(spec[key].nbr_idx, spec[key].nbr_mask, tp)
                       for tp in (2, 4)}
    ref["sp_inputs_s"] = time.perf_counter() - t0
    ref["sp"] = {"halo_size": {tp: p.halo_size for tp, p in spec["sp_plans"].items()}}
    for name, dtype, key in (("float32", "float32", "sp_batch"),
                             ("bfloat16", "bfloat16", "sp_batch"), ("big", "bfloat16", "sp_big")):
        model = sp_model(torch, dtype, device)
        sel = {}
        for d in range(2):
            getattr(model.graph_unet, f"pool{d}").register_forward_hook(
                lambda m, i, o, d=d: sel.__setitem__(d, o["sel_idx"]))
        on = spec[key].to(device)
        r = sp_measure(torch, lambda: model(on))
        ref["sp"][name] = sp_result(r, [sel[0], sel[1]], emb=name == "float32")
        del model, on
        torch.cuda.empty_cache()


def rect_backward_rows(torch, gen, table, idx, w, tag: dict, out: dict,
                       agg: bool = True) -> None:
    """The widened kernels at one rectangular shape (a table [B, M, F] read
    by idx [B, N, K]): the list over M rows bit-equal to its plain version
    (timed once a shape, in bf16), gather_rows_bwd (dsrc [B, M, F]) and,
    with ``agg``, gather_agg_bwd (dh [B, M, F], dw [B, N, K]) bit-identical
    from call to call and held to their plain f32 sums (1e-5 in f32, one
    ulp in bf16 and f16), each timed with its plain version, its library
    call and its bound; rows appended to ``out``."""
    from dgdm_histopath_torch.ops.kernels.gather_agg import (
        weighted_gather_sum_bwd, weighted_gather_sum_bwd_plain)
    from dgdm_histopath_torch.ops.kernels.gather_rows import (
        gather_rows_bwd, gather_rows_bwd_plain)
    from dgdm_histopath_torch.ops.kernels.neighbor_transpose import (
        neighbor_transpose, neighbor_transpose_plain)

    b, m, f = table.shape
    n, k = idx.shape[1:]
    e = table.element_size()
    nbr_t, plain_t = neighbor_transpose(idx, m), neighbor_transpose_plain(idx, m)
    torch.cuda.synchronize()
    if not (torch.equal(nbr_t.offsets, plain_t.offsets)
            and torch.equal(nbr_t.slots, plain_t.slots)):
        raise AssertionError(f"neighbor_transpose over {m} rows differs from its plain "
                             f"version at {tag}")
    transpose_repeats(torch, idx, m, nbr_t, tag)
    if table.dtype == torch.bfloat16:
        tbytes = 2 * b * n * k * 4 + b * (m + 1) * 4
        out["neighbor_transpose"].append(dict(
            tag, max_abs_err=0.0, ms=device_ms(torch, lambda: neighbor_transpose(idx, m)),
            plain_ms=device_ms(torch, lambda: neighbor_transpose_plain(idx, m)),
            library_ms=None, bound_ms=tbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
            bytes=tbytes))
    g4 = torch.randn(b, n, k, f, device="cuda", generator=gen).to(table.dtype)
    dsrc = gather_rows_bwd(idx, g4, nbr_t, m)
    again = gather_rows_bwd(idx, g4, nbr_t, m)
    torch.cuda.synchronize()
    r = scatter_error(torch, dsrc, gather_rows_bwd_plain(idx, g4.float(), plain_t, m))
    if dsrc.shape != (b, m, f) or not torch.equal(dsrc, again) or not r["ok"]:
        raise AssertionError(f"gather_rows_bwd over {m} rows: {r} at {tag}")
    flat_idx = (idx.long() + m * torch.arange(b, device="cuda").view(b, 1, 1)).reshape(-1)
    valid_idx = torch.where((idx >= 0).reshape(-1) & (idx < m).reshape(-1), flat_idx, 0)
    g_flat = g4.reshape(-1, f)
    rbytes = b * n * k * f * e + b * n * k * 4 + b * m * f * e
    t_bytes, t_ops = rbytes / HBM_BYTES_PER_S * 1e3, b * n * k * f / F32_FLOPS_PER_S * 1e3
    out["gather_rows_bwd"].append(dict(
        tag, max_abs_err=r["max_abs_err"], max_ulp_err=r["max_ulp_err"],
        ms=device_ms(torch, lambda: gather_rows_bwd(idx, g4, nbr_t, m)),
        plain_ms=device_ms(torch, lambda: gather_rows_bwd_plain(idx, g4, plain_t, m)),
        library_ms=device_ms(torch, lambda: torch.zeros(
            b * m, f, dtype=g4.dtype, device="cuda").index_add_(0, valid_idx, g_flat)),
        library="index_add_", bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations", bytes=rbytes))
    if not agg:
        return
    g3 = torch.randn(b, n, f, device="cuda", generator=gen)
    dh, dw = weighted_gather_sum_bwd(g3, table, idx, w, nbr_t=nbr_t)
    dh2, dw2 = weighted_gather_sum_bwd(g3, table, idx, w, nbr_t=nbr_t)
    torch.cuda.synchronize()
    ref_dh, dw_ref = weighted_gather_sum_bwd_plain(g3, table.float(), idx, w, plain_t)
    a = scatter_error(torch, dh, ref_dh)
    dw_err = (dw - dw_ref).abs().max().item()
    if (dh.shape != (b, m, f) or not (torch.equal(dh, dh2) and torch.equal(dw, dw2))
            or not a["ok"] or not torch.allclose(dw, dw_ref, atol=1e-5, rtol=1e-5)):
        raise AssertionError(f"gather_agg_bwd over {m} rows: {a}, dw {dw_err} at {tag}")
    abytes = b * n * f * 4 + 2 * b * m * f * e + 3 * b * n * k * 4
    flops = 4 * b * n * k * f
    t_bytes, t_ops = abytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
    lib_ms, lib_dtype = sparse_mm_ms(torch, idx, w, g3, transpose=True, n_src=m)
    out["gather_agg_bwd"].append(dict(
        tag, max_abs_err=max(a["max_abs_err"], dw_err), max_ulp_err=a["max_ulp_err"],
        ms=device_ms(torch, lambda: weighted_gather_sum_bwd(g3, table, idx, w, nbr_t=nbr_t)),
        plain_ms=device_ms(torch, lambda: weighted_gather_sum_bwd_plain(g3, table, idx, w,
                                                                        plain_t)),
        library_ms=lib_ms, library=f"torch.sparse.mm(A^T CSR, g) {lib_dtype}, dh half only",
        bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
        bytes=abytes, flops=flops))


def par_rect_kernels(torch, spec) -> dict:
    """The kernels with a rectangular table at the halo tier's shapes (model
    axis 2, rank 0), of the Base graphs and (the sp_large job's) the Large
    graphs: the outgoing rows (gather_rows from the [B, n_loc, 128] block,
    [B, 2, H] slots), the local step (gather_rows and gather_agg over the
    [B, n_loc + 2H, 128] table, [B, n_loc, 8] slots, masked slots -1 as the
    model points them), the forwards in bf16 and f32 held to their plain
    versions and timed; then the backwards at both shapes and the
    transposed lists over their M rows in f32, bf16 and f16 (Large: bf16
    and f32) (``rect_backward_rows``)."""
    from dgdm_histopath_torch.ops.graph import real_edge_index
    from dgdm_histopath_torch.parallel.halo import local_plan
    from dgdm_histopath_torch.parallel.mesh import Axis, Mesh

    mesh = Mesh(("data", "model"), (1, 2), lines={"model": Axis("model", 2, 0)})
    gen = torch.Generator(device="cuda").manual_seed(14)
    rows = {name: [] for name in ("gather_rows", "gather_agg", "gather_rows_bwd",
                                  "gather_agg_bwd", "neighbor_transpose")}
    # (label, plan, graphs, dtypes); the block's rows: the Base graphs'
    # features as the encoder sees them, random ones of the Large width
    cases = (("", spec["plans"][2], spec["sorted"],
              (torch.bfloat16, torch.float32, torch.float16)),
             ("Large ", spec["large_plans"][2], spec["large_batch"],
              (torch.bfloat16, torch.float32)))
    for label, plan, srt, dtypes in cases:
        send, idx = (t.cuda() for t in local_plan(plan, mesh, device="cpu"))
        n_loc = plan.n_local
        masked = (srt.nbr_mask & srt.node_mask[..., None])[:, :n_loc].cuda()
        idx = real_edge_index(idx, masked).contiguous()
        block = (srt.x[:, :n_loc].cuda() if not label else
                 torch.randn(srt.x.shape[0], n_loc, 128, generator=gen, device="cuda"))
        m = n_loc + 2 * plan.halo_size
        w = torch.rand(idx.shape, generator=gen, device="cuda")
        for dtype in dtypes:
            x = block.to(dtype).contiguous()
            table = torch.randn(x.shape[0], m, x.shape[-1], generator=gen,
                                device="cuda").to(dtype)
            dt = str(dtype).replace("torch.", "")
            out_tag = dict(case=f"{label}outgoing rows", shape=tuple(send.shape),
                           src=tuple(x.shape), dtype=dt)
            step_tag = dict(case=f"{label}local step", shape=tuple(idx.shape),
                            src=tuple(table.shape), dtype=dt)
            if dtype != torch.float16:
                rows["gather_rows"].append(gather_rows_row(torch, x, send, out_tag))
                rows["gather_rows"].append(gather_rows_row(torch, table, idx, step_tag))
                rows["gather_agg"].append(gather_agg_row(torch, table, idx, w, step_tag))
            rect_backward_rows(torch, gen, table, idx, w, step_tag, rows)
            rect_backward_rows(torch, gen, x, send, None, out_tag, rows, agg=False)
    # the launch floor: an empty kernel of one warp, timed as the kernels are
    empty = empty_kernel()
    rows["empty_kernel_ms"] = device_ms(torch, lambda: empty(
        torch.cuda.current_stream().cuda_stream))
    log(f"kernel empty launch (1 block of 32 threads) ms {rows['empty_kernel_ms']:.4f}, "
        f"the floor under neighbor_transpose's bound")
    for name, rs in rows.items():
        if name == "empty_kernel_ms":
            continue
        for r in rs:
            lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
            ulp = (f" ulp {r['max_ulp_err']:.2f}" if r.get("max_ulp_err") is not None else "")
            log(f"kernel {name:18s} rectangular {r['case']:19s} src {r['src']} idx "
                f"{r['shape']} {r['dtype']:8s} err {r['max_abs_err']:.2e}{ulp}  ms "
                f"{r['ms']:.4f}  plain {r['plain_ms']:.4f}  library {lib}  bound "
                f"{r['bound_ms']:.4f} ({r['bound_by']})")
    log("kernel checks: the lists over M != N rows equal their plain versions to the bit; "
        "the rectangular backwards are bit-identical from call to call and within 1e-5 "
        "(f32) / one ulp (bf16, f16) of their plain sums")
    return rows


def par_compare(torch, got: dict, ref: dict, spec: dict, world: int, card: str) -> dict:
    """Every rank's results against the one-process references; raises on a
    failed bound."""
    out = {}
    # TP
    ranks = [r["tp"] for r in got]
    if any(r["metrics"] != ranks[0]["metrics"] for r in ranks):
        raise AssertionError("tp: the ranks report different metrics")
    loss = max(abs(a[k] - s[k]) / max(1.0, abs(s[k]))
               for a, s in zip(ranks[0]["metrics"], ref["tp"]) for k in s)
    lr_sum = 1e-4 * len(PAR["tp_epochs"])
    worst, worst_key = 0.0, ""
    for key, r in ref["tp_params"].items():
        err = (ranks[0]["params"][key] - r).abs().max().item()
        bound = lr_sum if key.endswith(SHIFT_INVARIANT) else \
            1e-5 * max(r.abs().max().item(), 1.0)
        if err / bound > worst:
            worst, worst_key = err / bound, key
    expected = expected_launches(BASE, training=True)
    bad = [c for r in ranks for c in r["launches"] if c != expected]
    out["tp"] = {"shape": ranks[0]["shape"], "max_metric_rel": loss,
                 "worst_param_over_bound": worst, "worst_param": worst_key,
                 "launches": ranks[0]["launches"][0], "step_ms": [r["step_ms"] for r in ranks],
                 "sharded": ranks[0]["sharded"], "rank_bytes": [r["bytes"] for r in ranks],
                 "one_process_bytes": ref["tp_bytes"]}
    log(f"parallel: TP {ranks[0]['shape']} (data, model), DGDM-Base f32 batch 32 bucket 1024, "
        f"1 pretrain + 1 finetune step: metrics within {loss:.3e} of max(1, |x|) of one "
        f"process (<= 1e-5), parameters at {worst:.3f} of their bound ({worst_key}); "
        f"{ranks[0]['sharded']} parameters sharded; launches a step {ranks[0]['launches']} "
        f"(one process: {expected}); rank param + AdamW bytes "
        f"{[sum(r['bytes']) for r in ranks]} against {sum(ref['tp_bytes'])} for one process; "
        f"step wall {[[round(x, 1) for x in r['step_ms']] for r in ranks]} ms [{card}]")
    if loss > 1e-5 or worst > 1.0 or bad:
        raise AssertionError(f"tensor-parallel steps differ from one process (launches {bad})")

    # PP
    ranks = [r["pp"] for r in got]
    stages = ranks[0]["shape"][1]
    fwd = max((r["out"] - ref["pp"]).abs().max().item() for r in ranks)
    scale = max(ref["pp"].abs().max().item(), 1.0)
    grads = {}
    for r in ranks:
        per = 4 // stages
        mine = tuple(f"layer{r['stage'] * per + i}." for i in range(per))
        for k, v in r["grads"].items():
            if not k.startswith("layer") or k.startswith(mine):
                grads.setdefault(k, v)
    gerr = max((grads[k] - v).abs().max().item() / max(v.abs().max().item(), 1.0)
               for k, v in ref["pp_grads"].items())
    out["pp"] = {"shape": ranks[0]["shape"], "max_out_err": fwd, "max_grad_rel": gerr,
                 "launches": ranks[0]["launches"], "wall_ms": [r["wall_ms"] for r in ranks],
                 "bubble": (stages - 1) / (PAR["pp_micro"] + stages - 1)}
    log(f"parallel: PP {ranks[0]['shape']} (data, pipe), Base GraphEncoder (4 layers of 128, 8 "
        f"heads) B 32 N 1024, {PAR['pp_micro']} microbatches: output within {fwd:.2e} "
        f"(bound 1e-4 x {scale:.1f}), gradients within {gerr:.2e} of max(1, |g|) (<= 1e-4); a "
        f"stage's launches, forward + backward {ranks[0]['launches']}; wall "
        f"{[round(r['wall_ms'], 1) for r in ranks]} ms; bubble {out['pp']['bubble']:.3f} "
        f"[{card}]")
    if fwd > 1e-4 * scale or gerr > 1e-4 or set(grads) != set(ref["pp_grads"]):
        raise AssertionError("the pipelined encoder differs from the sequential one")

    # EP
    ranks = [r["ep"] for r in got]
    e = ref["ep"]
    errs = {"out": max((r["out"] - e["out"]).abs().max().item() for r in ranks),
            "aux": max(abs(r["aux"] - e["aux"]) for r in ranks),
            "dx": max((r["dx"] - e["dx"]).abs().max().item() for r in ranks)}
    n_loc = 4 // ranks[0]["shape"][1]
    for r in ranks:
        for k, g in e["grads"].items():
            mine = g[r["index"] * n_loc:(r["index"] + 1) * n_loc] if k in (
                "w_in", "b_in", "w_out", "b_out") else g
            errs[k] = max(errs.get(k, 0.0), (r["grads"][k] - mine).abs().max().item())
    routing = all(torch.equal(r["kept"], e["kept"]) for r in ranks)
    out["ep"] = {"shape": ranks[0]["shape"], "errors": errs, "routing_equal": routing}
    log(f"parallel: EP {ranks[0]['shape']} (data, expert), the MoE block of "
        f"configs/dgdm_base_moe.yaml on [32, 1024, 128]: max errors {errs} (<= 2e-5), "
        f"routing equal {routing} [{card}]")
    if max(errs.values()) > 2e-5 or not routing:
        raise AssertionError("the expert-parallel block differs from the replicated one")

    # the halo tier
    ranks = [r["halo"] for r in got]
    tp = ranks[0]["tp"]
    n_loc = ref["conv"].shape[1] // tp
    equal, sp_err = True, 0.0
    for r in ranks:
        blk = slice(r["index"] * n_loc, (r["index"] + 1) * n_loc)
        m = ref["sorted_mask"][:, blk][..., None]
        equal &= torch.equal(r["gather"] * m, ref["dense_gather"][:, blk] * m)
        node = ref["sorted_node"][:, blk][..., None]
        sp_err = max(sp_err, ((r["sp"] - ref["conv"][:, blk]) * node).abs().max().item())
    hh = ref["halo"][tp]
    out["halo"] = {"tp": tp, "bit_equal": equal, "sp_graph_conv_err": sp_err, "H": hh["H"],
                   "halo_fraction": hh["fraction"], "launches": ranks[0]["launches"],
                   "sp_launches": ranks[0]["sp_launches"], "plan_s": ref["plan_s"],
                   "all": ref["halo"]}
    log(f"parallel: halo, model axis {tp}, the Base cell's graphs Morton-sorted: halo_gather "
        f"equal to the dense gather on every real slot {equal}; sp_graph_conv within "
        f"{sp_err:.2e} of GraphConvolution (<= 1e-5); H {hh['H']}, halo_fraction "
        f"{hh['fraction']:.4f} ({ref['halo']}); launches halo_gather {ranks[0]['launches']}, "
        f"sp_graph_conv {ranks[0]['sp_launches']}; plans built in {ref['plan_s']:.2f} s [{card}]")
    if not equal or sp_err > 1e-5:
        raise AssertionError("the halo tier differs from the dense path")

    out["sp"] = sp_compare(torch, [r["sp"] for r in got], ref["sp"], card)
    out["sp_train"] = sp_train_compare(torch, [r["sp_train"] for r in got], ref["sp_train"],
                                       card)
    out["sp_moe"] = sp_moe_compare(torch, [r["sp_moe"] for r in got], ref["sp_moe"], card)
    out["sp_remat"] = remat = sp_train_compare(torch, [r["sp_remat"] for r in got],
                                               ref["sp_remat"], card, SP_REMAT_RUNS,
                                               "sp_remat training", remat=True)
    plain = out["sp_train"]["big"]
    remat["big_without_remat_above_gib"] = plain["above_gib"]
    log(f"parallel: sp_remat, one bf16 pretrain step on the 8192-node graph: a rank's peak "
        f"above resident {[round(x, 3) for x in remat['big']['above_gib']]} GiB with remat, "
        f"{[round(x, 3) for x in plain['above_gib']]} without (the sp_train job); one "
        f"process {remat['big']['one_above_gib']:.3f} with remat, {plain['one_above_gib']:.3f} "
        f"without [{card}]")
    out["sp_large"] = sp_large_compare(torch, [r["sp_large"] for r in got], ref["sp_large"],
                                       spec, card)

    for n in sorted({n for ns in PAR["dryruns"].values() for n in ns}):
        if f"dryrun{n}" in got[0]:
            r = got[0][f"dryrun{n}"]
            out[f"dryrun{n}"] = {"line": r["line"], "wall_s": r["wall_s"]}
            log(f"parallel: {r['line']} ({r['wall_s']:.1f} s on rank 0) [{card}]")
    return out


def sel_agreement(got, want) -> tuple:
    """(the share of pooled slots holding the same node, the share of (graph,
    level) pairs whose selected node sets are equal)."""
    slots = sum((a == b).sum().item() for a, b in zip(got, want)) / sum(b.numel() for b in want)
    sets = [bool((a.sort().values == b.sort().values).all())
            for x, y in zip(got, want) for a, b in zip(x, y)]
    return slots, sum(sets) / len(sets)


def selection_check(got: list, want: list, got_scores: list, want_scores: list) -> dict:
    """The pooled selections of two runs of the same forwards (each
    forward's [level 1, level 2] selections in call order, and their
    scores in slot order): the share of slots holding the same node and of
    (graph, level) pairs selecting the same nodes, both in node ids of the
    whole graph (a level-2 slot's level-1 slot composed), and the largest
    difference of the selected scores slot for slot. Two nodes whose scores
    lie within rounding of each other may take each other's slots in the
    two runs (a near tie); their scores still agree slot by slot."""
    import torch

    def node_ids(sel):
        ids = []
        for s0, s1 in zip(sel[0::2], sel[1::2]):
            ids += [s0, torch.gather(s0, -1, s1)]
        return ids

    slots, sets = sel_agreement(node_ids(got), node_ids(want))
    gap = max((a - b).abs().max().item() for a, b in zip(got_scores, want_scores))
    return {"slots_equal": slots, "sets_equal": sets, "score_gap": gap}


def sp_compare(torch, ranks: list, ref: dict, card: str) -> dict:
    """Each rank's ``sp_forward`` against one process on the same inputs:
    f32 logits within SP["f32_atol"] and node embeddings reported; bf16
    logits no further from the f32 one-process logits than 3x one process's
    bf16 plus 1e-3; selections compared slot for slot; every rank's launches
    as predicted; on the 8192-node graph each rank's peak above its resident
    memory below one process's. Raises on a failed bound."""
    tp = ranks[0]["tp"]
    expected = sp_expected_launches(BASE)
    f32 = ref["float32"]
    n_loc = f32["emb"].shape[1] // tp
    out = {"tp": tp, "expected_launches": expected}
    for name in ("float32", "bfloat16", "big"):
        one = ref[name]
        agree = [sel_agreement(r[name]["sel"], one["sel"]) for r in ranks]
        out[name] = {
            "logits_err": max((r[name]["logits"] - one["logits"]).abs().max().item()
                              for r in ranks),
            "finite": all(bool(torch.isfinite(r[name]["logits"]).all()) for r in ranks),
            "sel_slots_equal": min(a[0] for a in agree),
            "sel_sets_equal": min(a[1] for a in agree),
            "launches": [r[name]["launches"] for r in ranks], "one_launches": one["launches"],
            "peak_gib": [r[name]["peak_gib"] for r in ranks], "one_peak_gib": one["peak_gib"],
            "above_gib": [r[name]["above_gib"] for r in ranks],
            "one_above_gib": one["above_gib"],
            "wall_ms": [r[name]["wall_ms"] for r in ranks], "one_wall_ms": one["wall_ms"]}
    out["emb_err"] = max((r["float32"]["emb"] - f32["emb"][:, r["index"] * n_loc:
                                                         (r["index"] + 1) * n_loc])
                         .abs().max().item() for r in ranks)
    # the rows a rank receives for one f32 table of 128 features: a halo
    # table at the full-N levels, an all-gathered one at the pooled levels
    h, b, n = ref["halo_size"][tp], SP["batch"], f32["emb"].shape[1]
    out["table_bytes"] = {"halo, N": b * (tp - 1) * h * 128 * 4,
                          **{f"all-gather, N/{2 ** d}": b * (tp - 1) * (n >> d) // tp * 128 * 4
                             for d in (1, 2)}}
    log(f"parallel: sp_forward bytes a rank receives a table (f32, F 128, batch {b}): "
        f"{out['table_bytes']} (H {h}) [{card}]")
    bf = out["bfloat16"]
    bf["one_vs_f32"] = (ref["bfloat16"]["logits"] - f32["logits"]).abs().max().item()
    bf["sp_vs_f32"] = max((r["bfloat16"]["logits"] - f32["logits"]).abs().max().item()
                          for r in ranks)
    bf["bound"] = 3 * bf["one_vs_f32"] + 1e-3
    def gathers(c):
        return {k: c[k] for k in ("gather_rows", "gather_agg")}

    for name, what in (("float32", f"Base f32 batch {SP['batch']} bucket 1024"),
                       ("bfloat16", f"Base bf16 batch {SP['batch']} bucket 1024"),
                       ("big", "Base bf16 one graph of 8000 nodes, bucket 8192")):
        r = out[name]
        log(f"parallel: sp_forward (1, {tp}) (data, model), {what}: logits within "
            f"{r['logits_err']:.2e} of one process, finite {r['finite']}; pooled slots equal "
            f"{r['sel_slots_equal']:.4f}, selected sets equal {r['sel_sets_equal']:.3f}; a "
            f"rank's launches {gathers(r['launches'][0])} (predicted {gathers(expected)}; one "
            f"process {gathers(r['one_launches'])}); peak GiB a rank "
            f"{[round(x, 3) for x in r['peak_gib']]} "
            f"({[round(x, 3) for x in r['above_gib']]} above resident) against "
            f"{r['one_peak_gib']:.3f} ({r['one_above_gib']:.3f}) for one process; wall "
            f"{[round(x, 1) for x in r['wall_ms']]} ms against {r['one_wall_ms']:.1f} [{card}]")
    log(f"parallel: sp_forward f32 node embeddings within {out['emb_err']:.2e} of one "
        f"process's block; bf16 logits {bf['sp_vs_f32']:.3e} from the f32 one-process logits "
        f"(one process's bf16 {bf['one_vs_f32']:.3e}, bound {bf['bound']:.3e}) [{card}]")
    failed = {"f32 logits": out["float32"]["logits_err"] > SP["f32_atol"],
              "launches": any(c != expected for n in ("float32", "bfloat16", "big")
                              for c in out[n]["launches"]),
              "finite": not all(out[n]["finite"] for n in ("float32", "bfloat16", "big")),
              "bf16 logits": bf["sp_vs_f32"] > bf["bound"],
              "8192-node peak": max(out["big"]["above_gib"]) >= out["big"]["one_above_gib"]}
    if any(failed.values()):
        raise AssertionError(f"sp_forward: {[k for k, v in failed.items() if v]} failed")
    return out


def adamw_first_update(g):
    """AdamW's first bias-corrected step direction for gradient g (the
    trainer's eps 1e-8): g / (|g| + eps), lr-sized wherever |g| >> eps."""
    return g / (g.abs() + 1e-8)


def sp_f32_check(ranks: list, one: dict, name: str, steps: int = None) -> dict:
    """A rank's f32 run against one process's: each step's metrics over
    max(1, |x|), the first step's gradients over each tensor's largest entry
    (floored at 1e-3 of the largest entry of all, for the tensors whose true
    gradient is 0), the parameters after the run over their bound, worst
    entries first. The strict bound is 1e-5 of max(1, the tensor's largest
    entry) (the shift-invariant biases: the summed learning rate); each
    entry's bound adds what AdamW's first update makes of the two runs'
    first-step gradients there, lr x |u(g_rank) - u(g_one)| with u(g) = g /
    (|g| + eps): below eps (1e-8) the update is lr x g / eps, so a rounding
    difference of a gradient at 1e-7 of its tensor's largest entry (held by
    the gradient bound) moves the entry by a tenth of lr, the strict bound.
    Where |g| >> eps that term is ~0. Both ratios are returned. ``steps``:
    hold only the metrics of the first ``steps`` steps (a routing flip's
    step and those after it train another function), and the parameters
    only where that is every step."""
    got = ranks[0][name]
    steps = len(one["metrics"]) if steps is None else steps
    lr_sum = SP_TRAIN["config"]["learning_rate"] * len(SP_TRAIN["epochs"])
    lr0 = SP_TRAIN["config"]["learning_rate"]       # the first step's (no warmup)
    metric = {f"{i} {k}": abs(a[k] - s[k]) / max(1.0, abs(s[k]))
              for i, (a, s) in enumerate(zip(got["metrics"][:steps], one["metrics"][:steps]))
              for k in s}
    floor = 1e-3 * max(g.abs().max().item() for g in one["grads0"].values())
    grad = {k: (got["grads0"][k] - g).abs().max().item() / max(g.abs().max().item(), floor)
            for k, g in one["grads0"].items()}
    param, strict = {}, {}
    for key, want in (one["params"] if steps == len(one["metrics"]) else {}).items():
        bound = lr_sum if key.endswith(SHIFT_INVARIANT) else \
            1e-5 * max(want.abs().max().item(), 1.0)
        diff = (got["params"][key] - want).abs().double()
        first = lr0 * (adamw_first_update(got["grads0"][key].double())
                       - adamw_first_update(one["grads0"][key].double())).abs()
        param[key] = (diff / (bound + first)).max().item()
        strict[key] = diff.max().item() / bound

    def worst(d):
        return sorted(d.items(), key=lambda kv: -kv[1])[:6]

    slots, sets = sel_agreement(got["sel0"], one["sel0"])
    return {"same_on_every_rank": all(r[name]["metrics"] == got["metrics"] for r in ranks),
            "sel0_slots_equal": slots, "sel0_sets_equal": sets,
            "sel0_ids": selection_check(got["sel0"], one["sel0"], got["sel0_scores"],
                                        one["sel0_scores"]),
            "max_metric_rel": max(metric.values(), default=0.0),
            "max_first_step_metric_rel": max((v for k, v in metric.items()
                                              if k.startswith("0 ")), default=0.0),
            "max_grad0_rel": max(grad.values()) if steps else 0.0,
            "max_param_over_bound": max(param.values(), default=0.0),
            "max_param_over_strict_bound": max(strict.values(), default=0.0),
            "steps_held": steps,
            "worst_metrics": worst(metric), "worst_grads0": worst(grad),
            "worst_params": worst(param), "worst_params_strict": worst(strict)}


RUN_TEXT = {"float32": "f32, dropout 0", "float32_dropout": "f32, dropout 0.1",
            "bfloat16": "bf16, dropout 0.1",
            "big": "bf16, one graph of 8000 nodes in bucket 8192, 1 pretrain step"}


def sp_train_compare(torch, ranks: list, ref: dict, card: str, runs=SP_TRAIN_RUNS,
                     what: str = "sp training", remat: bool = False) -> dict:
    """Each rank's node-sharded training runs (``runs``) against one
    process's on the card. f32 without dropout and at dropout 0.1 alike, as
    the DP phase: metrics equal on every rank and within 1e-5 of max(1, |x|)
    of one process's at every step, the first step's gradients within 1e-4
    of each tensor's largest entry, the parameters within 1e-5 of max(1,
    each tensor's largest entry) (the shift-invariant key biases to the
    summed learning rate) plus what AdamW's first update makes of the two
    runs' first-step gradients (``sp_f32_check``), the first step's pooled
    node sets equal (their slots are reported: a swap of two tied nodes
    keeps their dropout masks). Every step's launches as predicted on every
    rank (``sp_train_expected_launches``; one process: 9 / 18 / 9 / 18 + 3,
    with ``remat`` 13 / 26 / 9 / 18 + 3); on the 8192-node graph each rank's
    peak above its resident memory below one process's. An MoE run's routing
    is held each step (``moe_run_flips``): a first choice may flip only at a
    near tie, and the steps before the first flip are held to the bounds.
    Raises on a failed bound."""
    tp = ranks[0]["tp"]
    names = tuple(r[0] for r in runs)
    f32 = [n for n in names if n in F32_RUNS]
    expected = sp_train_expected_launches(BASE, remat)
    one_expected = expected_launches(BASE, training=True, remat=remat)
    out = {"tp": tp, "expected_launches": expected}
    for name in f32:
        flips = moe_run_flips(ranks, ref[name], name) if ref[name].get("routing") else []
        held = next((i for i, f in enumerate(flips) if f["flipped"]), None)
        out[f"{name}_check"] = c = sp_f32_check(ranks, ref[name], name, held)
        c["flips"] = flips
        if flips:
            log(f"parallel: {what} {name}: the routing a step, flipped first choices "
                f"{[f['flipped'] for f in flips]} (largest gap "
                f"{max(f['max_gap'] for f in flips):.2e}, allowed <= {SP_MOE['tie']}; "
                f"router probabilities within "
                f"{['%.1e' % f['max_prob_diff'] for f in flips]} "
                f"of one process's); steps held to the bounds: {c['steps_held']} of "
                f"{len(ref[name]['metrics'])} [{card}]")
        log(f"parallel: {what} {name} (1, {tp}), DGDM-Base batch {SP['batch']} bucket "
            f"1024, 3 pretrain + 1 finetune steps: metrics within {c['max_metric_rel']:.3e} of "
            f"max(1, |x|) of one process (first step {c['max_first_step_metric_rel']:.3e}), "
            f"first-step gradients within {c['max_grad0_rel']:.3e} of each tensor's largest "
            f"entry, its pooled selections: slots equal {c['sel0_slots_equal']:.4f}, sets "
            f"equal {c['sel0_sets_equal']:.3f}; parameters at "
            f"{c['max_param_over_bound']:.3f} of their bound "
            f"({c['max_param_over_strict_bound']:.3f} of the strict bound, "
            f"{[(k, round(v, 3)) for k, v in c['worst_params_strict'][:3]]}); worst "
            f"metrics {[(k, f'{v:.2e}') for k, v in c['worst_metrics']]}, gradients "
            f"{[(k, f'{v:.2e}') for k, v in c['worst_grads0']]}, parameters "
            f"{[(k, round(v, 3)) for k, v in c['worst_params']]} [{card}]")
    for name in names:
        one = ref[name]
        out[name] = {
            "launches": [r[name]["launches"] for r in ranks], "one_launches": one["launches"],
            "step_ms": [r[name]["step_ms"] for r in ranks], "one_step_ms": one["step_ms"],
            "peak_gib": [r[name]["peak_gib"] for r in ranks], "one_peak_gib": one["peak_gib"],
            "above_gib": [r[name]["above_gib"] for r in ranks],
            "one_above_gib": one["above_gib"],
            "loss": [m["loss"] for m in ranks[0][name]["metrics"]],
            "one_loss": [m["loss"] for m in one["metrics"]],
            "finite": all(math.isfinite(v) for r in ranks for m in r[name]["metrics"]
                          for v in m.values())}

    def gathers(c):
        return {k: c[k] for k in ("gather_rows", "gather_agg", "gather_rows_bwd",
                                  "gather_agg_bwd", "neighbor_transpose")}

    for name in names:
        r = out[name]
        log(f"parallel: {what} {RUN_TEXT[name]}: a rank's launches a step "
            f"{gathers(r['launches'][0][0])} (predicted {gathers(expected)}; one process "
            f"{gathers(r['one_launches'][0])}); step wall ms a rank "
            f"{[[round(x, 1) for x in ms] for ms in r['step_ms']]} against "
            f"{[round(x, 1) for x in r['one_step_ms']]}; peak GiB a rank "
            f"{[round(x, 3) for x in r['peak_gib']]} ({[round(x, 3) for x in r['above_gib']]} "
            f"above resident) against {r['one_peak_gib']:.3f} ({r['one_above_gib']:.3f}) for "
            f"one process; loss {[round(x, 5) for x in r['loss']]} against "
            f"{[round(x, 5) for x in r['one_loss']]} [{card}]")
    failed = {}
    for name in f32:
        c = out[f"{name}_check"]
        failed[f"{name} routing flips"] = not all(f["ok"] for f in c["flips"])
        failed.update({f"{name} ranks": not c["same_on_every_rank"],
                       f"{name} metrics": c["max_metric_rel"] > 1e-5,
                       f"{name} first-step gradients": c["max_grad0_rel"] > 1e-4,
                       f"{name} parameters": c["max_param_over_bound"] > 1.0,
                       f"{name} selections": (c["steps_held"] > 0
                                              and c["sel0_sets_equal"] < 1.0)})
    failed.update({
        "launches": any(c != expected for n in names for r in out[n]["launches"] for c in r),
        "one-process launches": any(c != one_expected for n in names
                                    for c in out[n]["one_launches"]),
        "finite": not all(out[n]["finite"] for n in names),
        "8192-node peak": max(out["big"]["above_gib"]) >= out["big"]["one_above_gib"]})
    if any(failed.values()):
        raise AssertionError(f"{what}: {[k for k, v in failed.items() if v]} failed")
    return out


def moe_run_flips(ranks: list, one: dict, name: str) -> list:
    """Each step's routing of a MoE run on the ranks against one process's,
    up to the first step in which a first choice flips (the two runs train
    different functions from there): its flipped tokens and their largest
    gap (``moe_flip_check``, ``SP_MOE["tie"]``) and the largest difference of
    a router probability."""
    steps = []
    for s, want in enumerate(one["routing"]):
        checks = [moe_flip_check(want, r[name]["routing"][s]["first_choice"], SP_MOE["tie"])
                  for r in ranks]
        steps.append({"flipped": max(c["flipped"] for c in checks),
                      "max_gap": max(c["max_gap"] for c in checks),
                      "ok": all(c["ok"] for c in checks),
                      "max_prob_diff": max((r[name]["routing"][s]["probs"] - want["probs"])
                                           .abs().max().item() for r in ranks)})
        if steps[-1]["flipped"]:
            break
    return steps


def moe_flip_check(one: dict, got_first, tie: float) -> dict:
    """The tokens whose first choice differs between one process's routing
    ``one`` and ``got_first`` [g, G, E] (one-hot), among the real ones: their
    count and the largest gap between their two largest router
    probabilities in ``one``; ``ok`` when no such gap exceeds ``tie``."""
    real = one["mask"] > 0
    flipped = (one["first_choice"].argmax(-1) != got_first.argmax(-1)) & real
    top = one["probs"].topk(2, -1).values
    gaps = (top[..., 0] - top[..., 1])[flipped]
    worst = float(gaps.max()) if gaps.numel() else 0.0
    return {"flipped": int(flipped.sum()), "max_gap": worst, "ok": worst <= tie,
            "graphs": flipped.any(-1)}


def sp_moe_compare(torch, ranks: list, ref: dict, card: str) -> dict:
    """The sp_moe job: the f32 forward of each rank against one process's
    (every group one graph: the logits of the graphs without a flipped
    token within 1e-5, equal on both ranks; the aux loss 1e-6; each
    expert's kept and dropped tokens equal, or within the flips; flips only
    within ``SP_MOE["tie"]``, and MOE_FAULT caught), then its training runs
    (``sp_train_compare``). Raises on a failed bound."""
    one = ref["forward"]
    forward = [r["forward"] for r in ranks]
    flips = [moe_flip_check(one["routing"], r["routing"]["first_choice"], SP_MOE["tie"])
             for r in forward]
    # the planted fault: expert 0 raised on the last rank's rows of every graph
    faulted = one["routing"]["probs"].clone()
    half = faulted.shape[1] - faulted.shape[1] // ranks[0]["tp"]
    faulted[:, half:, 0] += SP_MOE["fault"]
    first = torch.nn.functional.one_hot(faulted.argmax(-1), faulted.shape[-1]).float()
    fault = moe_flip_check(one["routing"], first, SP_MOE["tie"])
    clean = ~torch.stack([f["graphs"] for f in flips]).any(0)
    logits = max(((r["logits"] - one["logits"])[clean].abs().max().item() if clean.any()
                  else 0.0) for r in forward)
    aux = max(abs(r["aux"] - one["aux"]) for r in forward)
    n_flips = max(f["flipped"] for f in flips)

    def counts(rt):
        kept = rt["kept"].sum((0, 1))
        return kept, rt["first_choice"].sum((0, 1)) - kept

    kept1, dropped1 = counts(one["routing"])
    count_err = max(max((a - b).abs().max().item() for a, b in zip(counts(r["routing"]),
                                                                    (kept1, dropped1)))
                    for r in forward)
    out = {"flipped_tokens": n_flips, "flip_max_gap": max(f["max_gap"] for f in flips),
           "max_prob_diff": max((r["routing"]["probs"] - one["routing"]["probs"]).abs().max()
                                .item() for r in forward),
           "fault_flipped": fault["flipped"], "fault_max_gap": fault["max_gap"],
           "logits_err": logits, "aux_err": aux, "count_err": count_err,
           "kept": kept1.tolist(), "dropped": dropped1.tolist(),
           "launches": [r["launches"] for r in forward], "one_launches": one["launches"],
           "graphs_compared": int(clean.sum())}
    expected = sp_expected_launches(BASE)
    log(f"parallel: sp_moe forward (1, {ranks[0]['tp']}), {MOE['config']} at full width, "
        f"f32, the 8 sorted Base graphs (groups of 1024: each a graph over both blocks): "
        f"logits of {out['graphs_compared']} graphs within {logits:.2e} of one process "
        f"(<= {SP_MOE['f32_atol']}), aux loss within {aux:.2e} (<= {SP_MOE['aux_atol']}), "
        f"kept {out['kept']} / dropped {out['dropped']} an expert, counts off by {count_err:.0f}; "
        f"{n_flips} flipped first choices (largest gap {out['flip_max_gap']:.2e}, allowed "
        f"<= {SP_MOE['tie']}; router probabilities within {out['max_prob_diff']:.2e} of one "
        f"process's); the planted fault (+{SP_MOE['fault']} on expert 0, last "
        f"rank's rows) flips {fault['flipped']} tokens, largest gap {fault['max_gap']:.2e}; "
        f"launches a rank {forward[0]['launches']} (predicted {expected}) [{card}]")
    failed = {"flips": not all(f["ok"] for f in flips),
              "fault passed": fault["ok"],
              "logits": logits > SP_MOE["f32_atol"] or not all(
                  torch.equal(r["logits"], forward[0]["logits"]) for r in forward),
              "aux": n_flips == 0 and aux > SP_MOE["aux_atol"],
              "counts": count_err > n_flips,
              "launches": any(r["launches"] != expected for r in forward)}
    if any(failed.values()):
        raise AssertionError(f"sp_moe forward: {[k for k, v in failed.items() if v]} failed")
    return {"forward": out, **sp_train_compare(torch, ranks, ref, card, SP_MOE_RUNS,
                                               "sp_moe training")}


def sp_large_attention(torch, spec: dict, ranks: list) -> dict:
    """One process's f32 ``return_attention`` forward of DGDM-Large on the
    whole Large batch, on the card, against the ranks' rows of each returned
    attention concatenated in rank order along its node axis (the query axis
    of the spatial weights): the largest difference of each, and of the
    logits."""
    model = sp_model(torch, "float32", "cuda", "dgdm-large")
    with torch.no_grad():
        out = model(spec["large_batch"].to("cuda"), return_attention=True)
    want = {**{f"edge_attentions {i}": a for i, a in enumerate(out["edge_attentions"])},
            "spatial_attention": out["spatial_attention"],
            "attention_weights": out["attention_weights"]}
    errors = {}
    for key, w in want.items():
        got = torch.cat([r["attention"]["rows"][key] for r in ranks],
                        2 if key == "spatial_attention" else 1).cuda()
        if got.shape != w.shape:
            raise AssertionError(f"sp_large: {key} rows {tuple(got.shape)} concatenated, one "
                                 f"process {tuple(w.shape)}")
        errors[key] = (got - w).abs().max().item()
    logits = out["classification_logits"].cpu()
    del model, out, want
    torch.cuda.empty_cache()
    return {"errors": errors, "shape": tuple(ranks[0]["attention"]["rows"][
        "spatial_attention"].shape), "logits_err": max(
        (r["attention"]["logits"] - logits).abs().max().item() for r in ranks)}


def sp_large_compare(torch, ranks: list, ref: dict, spec: dict, card: str) -> dict:
    """Each rank's sp_large results against one process's on the card: the
    f32 forward's logits (1e-5) and pooled selections (``selection_check``:
    the same nodes at each level, their scores within 3e-5 slot for slot;
    the same check on one process's forward with each of SCORE_FAULTS
    planted must fail), the returned attention concatenated over the ranks (1e-5), the f32 runs
    as the sp_train job holds them (``sp_f32_check``; first-step gradients
    1e-5 of each tensor's largest entry, the first step's selections as the
    forward's), every
    forward's and step's launches as predicted on every rank, the bf16 and
    XL results finite, and at bucket 8192 each rank's peak above its
    resident memory below one process's (the step and the
    ``return_attention`` forward). Raises on a failed bound."""
    tp = ranks[0]["tp"]
    fwd_expected, step_expected = sp_expected_launches(LARGE), sp_train_expected_launches(LARGE)
    out = {"tp": tp, "expected_launches": {"forward": fwd_expected, "step": step_expected},
           "inputs_s": ref["inputs_s"]}
    f = ref["forward"]
    n_loc = f["emb"].shape[1] // tp
    sel = [selection_check(r["forward"]["sel"], f["sel"], r["forward"]["scores"], f["scores"])
           for r in ranks]
    out["forward"] = {
        "logits_err": max((r["forward"]["logits"] - f["logits"]).abs().max().item()
                          for r in ranks),
        "emb_err": max((r["forward"]["emb"] - f["emb"][:, r["index"] * n_loc:
                                                        (r["index"] + 1) * n_loc])
                       .abs().max().item() for r in ranks),
        "sel_slots_equal": min(c["slots_equal"] for c in sel),
        "sel_sets_equal": min(c["sets_equal"] for c in sel),
        "sel_score_gap": max(c["score_gap"] for c in sel),
        "faults": ref["faults"],
        "launches": [r["forward"]["launches"] for r in ranks], "one_launches": f["launches"],
        "wall_ms": [r["forward"]["wall_ms"] for r in ranks], "one_wall_ms": f["wall_ms"],
        "above_gib": [r["forward"]["above_gib"] for r in ranks],
        "one_above_gib": f["above_gib"]}
    out["attention"] = dict(sp_large_attention(torch, spec, ranks),
                            launches=[r["attention"]["launches"] for r in ranks],
                            wall_ms=[r["attention"]["wall_ms"] for r in ranks],
                            above_gib=[r["attention"]["above_gib"] for r in ranks])
    for name in F32_RUNS:
        out[f"{name}_check"] = sp_f32_check(ranks, ref[name], name)
    for name in (r[0] for r in SP_LARGE_RUNS):
        one = ref[name]
        out[name] = {
            "launches": [r[name]["launches"] for r in ranks], "one_launches": one["launches"],
            "step_ms": [r[name]["step_ms"] for r in ranks], "one_step_ms": one["step_ms"],
            "peak_gib": [r[name]["peak_gib"] for r in ranks], "one_peak_gib": one["peak_gib"],
            "above_gib": [r[name]["above_gib"] for r in ranks],
            "one_above_gib": one["above_gib"],
            "loss": [m["loss"] for m in ranks[0][name]["metrics"]],
            "one_loss": [m["loss"] for m in one["metrics"]],
            "finite": all(math.isfinite(v) for r in ranks for m in r[name]["metrics"]
                          for v in m.values())}
    xa, one_xa = [r["xl_attention"] for r in ranks], ref["xl_attention"]
    out["xl_attention"] = {
        "weights_shape": xa[0]["weights_shape"], "finite": all(r["finite"] for r in xa),
        "launches": [r["launches"] for r in xa], "one_launches": one_xa["launches"],
        "peak_gib": [r["peak_gib"] for r in xa], "one_peak_gib": one_xa["peak_gib"],
        "above_gib": [r["above_gib"] for r in xa], "one_above_gib": one_xa["above_gib"],
        "wall_ms": [r["wall_ms"] for r in xa], "one_wall_ms": one_xa["wall_ms"]}
    # the rows a rank receives for one f32 table of 128 features: a halo
    # table at the full-N levels, an all-gathered one at the pooled levels,
    # the window route's two windows of W rows
    w = LARGE["window"]
    out["halo"] = {}
    for key in ("large", "xl"):
        plan, b = spec[f"{key}_plans"][tp], spec[f"{key}_batch"].x.shape[0]
        n = spec[f"{key}_batch"].x.shape[1]
        out["halo"][key] = {"H": {t: p.halo_size for t, p in spec[f"{key}_plans"].items()},
                            "table_bytes": {
                                "halo, N": b * (tp - 1) * plan.halo_size * 128 * 4,
                                **{f"all-gather, N/{2 ** d}": b * (tp - 1) * (n >> d) // tp
                                   * 128 * 4 for d in (1, 2)},
                                "window ring, N": b * 2 * w * 128 * 4}}

    def gathers(c):
        return {k: c[k] for k in ("gather_rows", "gather_agg", "gather_rows_bwd",
                                  "gather_agg_bwd", "neighbor_transpose")}

    fw, at = out["forward"], out["attention"]
    log(f"parallel: sp_large (1, {tp}) (data, model), DGDM-Large f32 batch 4 bucket 2048 "
        f"(windows of {w}): logits within {fw['logits_err']:.2e} of one process (<= "
        f"{SP_LARGE['f32_atol']}), node embeddings {fw['emb_err']:.2e}; pooled nodes (ids of "
        f"the graph): slots equal {fw['sel_slots_equal']:.4f}, sets {fw['sel_sets_equal']:.3f}, "
        f"selected scores slot for slot within {fw['sel_score_gap']:.2e}; a rank's launches "
        f"{gathers(fw['launches'][0])} (predicted {gathers(fwd_expected)}; one process "
        f"{gathers(fw['one_launches'])}); wall {[round(x, 1) for x in fw['wall_ms']]} ms "
        f"against {fw['one_wall_ms']:.1f}; peak GiB above resident "
        f"{[round(x, 3) for x in fw['above_gib']]} against {fw['one_above_gib']:.3f} [{card}]")
    faults = {k: f"slots {c['slots_equal']:.4f}, sets {c['sets_equal']:.3f}, scores within "
                 f"{c['score_gap']:.2e}" for k, c in fw["faults"].items()}
    log(f"parallel: sp_large planted score faults (a block's pooling scores in one process's "
        f"f32 forward) against the sound forward: {faults} (each must fail: sets equal and "
        f"scores within {SP_LARGE['score_atol']}) [{card}]")
    log(f"parallel: sp_large return_attention f32: rows concatenated over the ranks, "
        f"largest differences {({k: f'{v:.2e}' for k, v in at['errors'].items()})} (<= "
        f"{SP_LARGE['f32_atol']}), spatial weights {at['shape']} a rank, logits "
        f"{at['logits_err']:.2e}; launches {gathers(at['launches'][0])}; wall "
        f"{[round(x, 1) for x in at['wall_ms']]} ms; peak GiB above resident "
        f"{[round(x, 3) for x in at['above_gib']]} [{card}]")
    for name in F32_RUNS:
        c = out[f"{name}_check"]
        log(f"parallel: sp_large training {name} (1, {tp}), 3 pretrain + 1 finetune steps: "
            f"metrics within {c['max_metric_rel']:.3e} of max(1, |x|) of one process, "
            f"first-step gradients within {c['max_grad0_rel']:.3e} of each tensor's largest "
            f"entry (<= {SP_LARGE['grad_rel']}), first-step pooled nodes: slots equal "
            f"{c['sel0_ids']['slots_equal']:.4f}, sets {c['sel0_ids']['sets_equal']:.3f}, "
            f"scores slot for slot within {c['sel0_ids']['score_gap']:.2e}; parameters at "
            f"{c['max_param_over_bound']:.3f} of "
            f"their bound ({c['max_param_over_strict_bound']:.3f} of the strict bound); worst "
            f"gradients {[(k, f'{v:.2e}') for k, v in c['worst_grads0'][:3]]}, parameters "
            f"{[(k, round(v, 3)) for k, v in c['worst_params'][:3]]} [{card}]")
    for name, what in (("float32", "f32, dropout 0"),
                       ("float32_dropout", f"f32, dropout {LARGE['dropout']}"),
                       ("bfloat16", f"bf16, dropout {LARGE['dropout']}, 1 pretrain step"),
                       ("xl", "bf16, configs/dgdm_xl_windowed.yaml, one graph of 8000 nodes "
                              "in bucket 8192, 1 pretrain step")):
        r = out[name]
        log(f"parallel: sp_large training {what}: a rank's launches a step "
            f"{gathers(r['launches'][0][0])} (predicted {gathers(step_expected)}; one process "
            f"{gathers(r['one_launches'][0])}); step wall ms a rank "
            f"{[[round(x, 1) for x in ms] for ms in r['step_ms']]} against "
            f"{[round(x, 1) for x in r['one_step_ms']]}; peak GiB a rank "
            f"{[round(x, 3) for x in r['peak_gib']]} ({[round(x, 3) for x in r['above_gib']]} "
            f"above resident) against {r['one_peak_gib']:.3f} ({r['one_above_gib']:.3f}) for "
            f"one process; loss {[round(x, 5) for x in r['loss']]} against "
            f"{[round(x, 5) for x in r['one_loss']]} [{card}]")
    x = out["xl_attention"]
    log(f"parallel: sp_large XL return_attention bf16, bucket 8192: spatial weights "
        f"{x['weights_shape']} a rank, finite {x['finite']}; launches "
        f"{gathers(x['launches'][0])}; peak GiB a rank {[round(v, 3) for v in x['peak_gib']]} "
        f"({[round(v, 3) for v in x['above_gib']]} above resident) against "
        f"{x['one_peak_gib']:.3f} ({x['one_above_gib']:.3f}) for one process; wall "
        f"{[round(v, 1) for v in x['wall_ms']]} ms against {x['one_wall_ms']:.1f} [{card}]")
    log(f"parallel: sp_large H and bytes a rank receives a table (f32, F 128): "
        f"{out['halo']} [{card}]")
    failed = {"forward logits": fw["logits_err"] > SP_LARGE["f32_atol"],
              "forward selections": fw["sel_sets_equal"] < 1.0
              or fw["sel_score_gap"] > SP_LARGE["score_atol"],
              "selection check blind to a planted score fault": any(
                  c["sets_equal"] == 1.0 and c["score_gap"] <= SP_LARGE["score_atol"]
                  for c in fw["faults"].values()),
              "attention": max(at["errors"].values()) > SP_LARGE["f32_atol"]
              or at["logits_err"] > SP_LARGE["f32_atol"],
              "forward launches": any(c != fwd_expected for c in fw["launches"]
                                      + at["launches"] + x["launches"]),
              "one-process forward launches": any(
                  c != expected_launches(LARGE, training=False)
                  for c in (fw["one_launches"], x["one_launches"])),
              "step launches": any(c != step_expected for n, *_ in SP_LARGE_RUNS
                                   for r in out[n]["launches"] for c in r),
              "one-process step launches": any(
                  c != expected_launches(LARGE, training=True)
                  for n, *_ in SP_LARGE_RUNS for c in out[n]["one_launches"]),
              "finite": not (all(out[n]["finite"] for n, *_ in SP_LARGE_RUNS)
                             and x["finite"]),
              "8192-node step peak": max(out["xl"]["above_gib"]) >= out["xl"]["one_above_gib"],
              "8192-node attention peak": max(x["above_gib"]) >= x["one_above_gib"]}
    for name in F32_RUNS:
        c = out[f"{name}_check"]
        failed.update({f"{name} ranks": not c["same_on_every_rank"],
                       f"{name} metrics": c["max_metric_rel"] > 1e-5,
                       f"{name} first-step gradients": c["max_grad0_rel"] > SP_LARGE["grad_rel"],
                       f"{name} parameters": c["max_param_over_bound"] > 1.0,
                       f"{name} selections": c["sel0_ids"]["sets_equal"] < 1.0
                       or c["sel0_ids"]["score_gap"] > SP_LARGE["score_atol"]})
    if any(failed.values()):
        raise AssertionError(f"sp_large: {[k for k, v in failed.items() if v]} failed")
    return out


def parallel_phase(torch, graphs, card: str, cards: int) -> dict:
    """The tiers through their entry points. One card: 8 gloo ranks share it;
    2 of them run TP (1, 2) on DGDM-Base at full width, PP, EP, the halo
    tier, ``sp_forward`` and training over node-sharded inputs, then
    DGDM-Large and the XL config's 8192-node graph over node-sharded inputs
    (the ``sp_large`` job: windows, returned attention), then all 8 run
    ``dryrun_multichip(8)``. Four cards (``cards >= 4``): 4 NCCL ranks, one a
    card, run TP (2, 2), PP (1, 4), EP (2, 2), the halo, ``sp_forward``,
    its training and ``sp_large`` over 4 and ``dryrun_multichip(4)``. Each
    tier against one process of this call; then the kernels with a
    rectangular table at the halo shapes of the Base and the Large graphs."""
    import multiprocessing
    import tempfile

    backend, world = ("nccl", 4) if cards >= 4 else ("gloo", 2)
    jobs = ([(j, world) for j in ("tp", "pp", "ep", "halo", "sp", "sp_train", "sp_moe",
                                  "sp_remat", "sp_large")]
            + [(f"dryrun{n}", n) for n in PAR["dryruns"][backend]])
    size = max(w for _, w in jobs)
    t0 = time.perf_counter()
    spec, ref = par_spec(torch, graphs)
    ref["sorted_mask"] = spec["sorted"].nbr_mask
    ref["sorted_node"] = spec["sorted"].node_mask
    ref_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as root:
        torch.save(spec, f"{root}/spec.pt")
        ctx = multiprocessing.get_context("spawn")
        t0 = time.perf_counter()
        procs = [ctx.Process(target=par_rank, args=(r, size, backend, root, jobs))
                 for r in range(size)]
        for p in procs:
            p.start()
        # a rank that fails leaves the others waiting in a collective: stop all
        deadline = time.monotonic() + 900
        while (any(p.is_alive() for p in procs) and time.monotonic() < deadline
               and not any(p.exitcode not in (None, 0) for p in procs)):
            time.sleep(0.5)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        wall = time.perf_counter() - t0
        if any(p.exitcode != 0 for p in procs):
            raise AssertionError(f"parallel ranks exited {[p.exitcode for p in procs]}")
        got = [torch.load(f"{root}/result{r}.pt", weights_only=False) for r in range(world)]
    # the kernels alone first: a wrong kernel shows there before the steps
    rect = par_rect_kernels(torch, spec) if backend == "gloo" else None
    out = par_compare(torch, got, ref, spec, world, card)
    job_s = {job: round(got[0]["seconds"][job], 1) for job, _ in jobs}
    out.update(backend=backend, world=world, ranks_wall_s=wall, reference_s=ref_s,
               job_seconds=job_s)
    how = ("one a card" if backend == "nccl" else
           "sharing the card, host-staged collectives: not a parallel speed")
    log(f"parallel: {size} {backend} ranks ({how}) in {wall:.1f} s (rank 0's jobs: {job_s} "
        f"s), the one-process references {ref_s:.1f} s [{card}]")
    if rect is not None:
        out["rect"] = rect
        out["dropout_draw"] = dropout_draw_memory(torch, card)
    return out


def dropout_draw_memory(torch, card: str) -> dict:
    """A node block's largest dropout draw at the 8192-node bucket, the
    spatial attention weights [1, 8 heads, N/tp, N] f32 of DGDM-Base: the
    peak above resident memory (the output included) of the port's draw at
    the whole graph's shape keeping the block (``NodeRows``), against a draw
    at the block's own shape, for tp = 1, 2, 4 and 8 on one card."""
    from dgdm_histopath_torch.nn.layers import NodeRows, dropout

    n = SP_BIG["bucket"]
    gen = torch.Generator(device="cuda").manual_seed(16)
    out = {}
    for tp in (1, 2, 4, 8):
        x = torch.ones(1, 8, n // tp, n, device="cuda")
        res = {}
        for how, rows in (("whole", NodeRows(n, lo=(tp - 1) * (n // tp))), ("block", None)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            y = dropout(x, BASE["dropout"], gen, rows)
            torch.cuda.synchronize()
            res[how] = (torch.cuda.max_memory_allocated() - before) / 2 ** 30
            del y
        out[tp] = res
        del x
    torch.cuda.empty_cache()
    log(f"parallel: a block's spatial-attention dropout at bucket {n}, peak GiB above "
        f"resident, whole-graph draw kept to the block against a block-shape draw: "
        f"{ {tp: (round(r['whole'], 3), round(r['block'], 3)) for tp, r in out.items()} } "
        f"[{card}]")
    return out


# ---------------------------------------------------------------------------
# 15. int8 (w8a8) inference
# ---------------------------------------------------------------------------

def int8_dense_row(torch, m: int, k: int, n: int, what: str) -> dict:
    """One int8 Dense shape ``[m, k] x [k, n]`` on the card: the int32 product
    (``torch._int_mm``, padded where cuBLASLt needs it) equal to the bit to
    its plain version (exact f64 sums), ``int8_dense`` within 1e-6 of its
    plain version's output; device times (CUDA-graph replays) of the int8
    product, the plain version and bf16 ``F.linear`` on the same shape, and of
    the whole int8 ``Dense`` (quantize, product, dequantize, bias, cast)
    against the bf16 ``Dense`` (which casts its f32 weight each call); bound:
    the product's operations at the dense int8 rate or its bytes at the
    memory rate, the larger."""
    import torch.nn.functional as F
    from dgdm_histopath_torch.models.quantized import _int8_dense_call
    from dgdm_histopath_torch.nn.layers import Dense
    from dgdm_histopath_torch.ops.quant import (
        int8_dense, int8_matmul, int8_matmul_plain, quantize_activations, quantize_weight)

    gen = torch.Generator(device="cuda").manual_seed(m + 7 * k + 13 * n)
    dense = Dense(k, n, dtype=torch.bfloat16).cuda()
    with torch.no_grad():
        dense.weight.normal_(0.0, k ** -0.5, generator=gen)
        dense.bias.normal_(0.0, 0.1, generator=gen)
    x = torch.randn(m, k, device="cuda", generator=gen).to(torch.bfloat16)
    x_q, _ = quantize_activations(x)
    w_q, w_s = quantize_weight(dense.weight, axis=0)
    acc = int8_matmul(x_q, w_q)
    acc_equal = torch.equal(acc, int8_matmul_plain(x_q, w_q))
    out = int8_dense(x, w_q, w_s, dense.bias)
    ref = int8_dense(x, w_q, w_s, dense.bias, matmul=int8_matmul_plain)
    rel = ((out - ref).abs().max() / ref.abs().max()).item()
    if not acc_equal or rel > 1e-6:
        raise AssertionError(f"int8 {what} [{m}, {k}] x [{k}, {n}]: accumulators equal "
                             f"{acc_equal}, output {rel:.2e} of its scale from the plain version")
    xb, wb = x, dense.weight.detach().to(torch.bfloat16)
    with torch.inference_mode():
        row = {"shape": [m, k, n], "what": what, "padded": m <= 16 or k % 8 > 0 or n % 8 > 0,
               "acc_equal": acc_equal, "max_rel_err": rel,
               "int_mm_ms": device_ms(torch, lambda: int8_matmul(x_q, w_q)),
               "bf16_linear_ms": device_ms(torch, lambda: F.linear(xb, wb)),
               "plain_ms": device_ms(torch, lambda: int8_matmul_plain(x_q, w_q), reps=3,
                                     trials=5),
               "dense_int8_ms": device_ms(torch, lambda: _int8_dense_call(dense, x)),
               "dense_bf16_ms": device_ms(torch, lambda: dense(x))}
    by_ops = 2.0 * m * k * n / INT8_OPS_PER_S * 1e3
    by_bytes = (m * k + n * k + 4 * m * n) / HBM_BYTES_PER_S * 1e3
    row.update(bound_ms=max(by_ops, by_bytes),
               bound_by="operations" if by_ops >= by_bytes else "bytes")
    return row


def int8_layouts(torch, card: str) -> dict:
    """``torch._int_mm``'s second operand at the ViT-B/16 mlp1 shape: the
    transpose of a contiguous ``[N, K]`` int8 weight (the port's layout) and a
    contiguous ``[K, N]`` matrix; both equal to the exact sums, device times."""
    from dgdm_histopath_torch.ops.quant import int8_matmul_plain

    gen = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randint(-127, 128, (INT8["vit_batch"] * 197, 768), device="cuda",
                      dtype=torch.int8, generator=gen)
    w = torch.randint(-127, 128, (3072, 768), device="cuda", dtype=torch.int8, generator=gen)
    want, out = int8_matmul_plain(x, w), {}
    for name, mat2 in (("weight_nk_transposed", w.t()), ("contiguous_kn", w.t().contiguous())):
        if not torch.equal(torch._int_mm(x, mat2), want):
            raise AssertionError(f"_int_mm with mat2 {name} differs from the exact sums")
        out[name] = device_ms(torch, lambda mat2=mat2: torch._int_mm(x, mat2))
    log(f"int8: _int_mm [{x.shape[0]}, 768] x [768, 3072]: mat2 the transpose of a contiguous "
        f"[N, K] weight {out['weight_nk_transposed']:.4f} ms, a contiguous [K, N] matrix "
        f"{out['contiguous_kn']:.4f} ms [{card}]")
    return out


def int8_model(torch, graphs, card: str) -> dict:
    """DGDM-Base (seed 0, bf16) on the Base cell's graphs through
    ``DGDMPredictor(quant="int8")``: predict_batch counted (9 / 18), the
    shapes of the Dense calls it reroutes, logit cosine against the bf16
    forward of the same model, forward wall / device time / kernels / peak
    memory against bf16; the f32 model's int8 forward on the card against the
    CPU on 2 graphs (logits within 1e-4; the int8 activations that land a
    step apart counted)."""
    import numpy as np
    from dgdm_histopath_torch import DGDMPredictor, batch_graphs, create_model
    from dgdm_histopath_torch.models import quantized
    from dgdm_histopath_torch.ops.quant import quantize_activations

    model = create_model("dgdm-base", num_classes=2, compute_dtype="bfloat16", device="cuda",
                         seed=0)
    flt, pred = DGDMPredictor(model=model), DGDMPredictor(model=model, quant="int8")
    results, launches = counted(torch, lambda: pred.predict_batch(graphs),
                                expected_launches(BASE, training=False), "int8 predict_batch")
    for r in results:
        if not (np.isfinite(r["probabilities"]).all()
                and abs(float(r["probabilities"].sum()) - 1.0) < 1e-5
                and np.isfinite(r["graph_embedding"]).all()):
            raise AssertionError("int8 predict_batch: non-finite outputs")
    batch = batch_graphs(graphs).to("cuda")
    inner, shapes = quantized.make_int8_interceptor(), {}

    def recording(mod, x):
        out = inner(mod, x)
        if out is not None:
            key = (x.numel() // x.shape[-1], x.shape[-1], mod.out_features)
            shapes[key] = shapes.get(key, 0) + 1
        return out
    with torch.inference_mode(), quantized.intercept_dense(recording):
        out8 = model(batch, mode="inference", deterministic=True, return_attention=True)
    outf = flt.forward(batch)

    def cosine(a, b):
        a, b = a.float(), b.float()
        return (a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1))
    cos_logits = cosine(out8["classification_logits"], outf["classification_logits"])
    cos_emb = cosine(out8["graph_embedding"], outf["graph_embedding"])
    timing = {}
    for name, p in (("int8", pred), ("bf16", flt)):
        walls = []
        for i in range(13):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p.forward(batch)
            torch.cuda.synchronize()
            if i >= 3:
                walls.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.reset_peak_memory_stats()
        p.forward(batch)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        prof = profile_call(torch, lambda p=p: p.forward(batch), f"DGDM-Base {name} forward")
        prof.pop("top")
        timing[name] = {"forward_ms": statistics.median(walls), "forward_ms_all": walls,
                        "peak_gib": peak, "profile": prof}
    log(f"int8: DGDM-Base batch {BASE['batch']} bucket {BASE['bucket']}: predict_batch "
        f"launches {launches}; {sum(shapes.values())} Dense calls rerouted over {len(shapes)} "
        f"shapes; logit cosine vs bf16 min {cos_logits.min().item():.5f} (> "
        f"{INT8['cosine_model']}), embedding cosine min {cos_emb.min().item():.5f}; forward "
        f"int8 {timing['int8']['forward_ms']:.2f} ms / device "
        f"{timing['int8']['profile']['device_busy_ms']} ms in "
        f"{timing['int8']['profile'].get('kernel_launches')} kernels / peak "
        f"{timing['int8']['peak_gib']:.2f} GiB against bf16 {timing['bf16']['forward_ms']:.2f} "
        f"/ {timing['bf16']['profile']['device_busy_ms']} / "
        f"{timing['bf16']['profile'].get('kernel_launches')} / "
        f"{timing['bf16']['peak_gib']:.2f} [{card}]")
    if cos_logits.min().item() <= INT8["cosine_model"]:
        raise AssertionError(f"int8 logits' cosine against bf16 {cos_logits.tolist()}")

    # the f32 model's int8 forward, card against CPU, on 2 graphs
    cpu_model = create_model("dgdm-base", num_classes=2, compute_dtype="float32", device="cpu",
                             seed=1)
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    small = batch_graphs(graphs[:2])
    acts = {"cpu": [], "cuda": []}

    def activations(where):
        def interceptor(mod, x):
            out = inner(mod, x)
            if out is not None:
                acts[where].append([t.cpu() for t in quantize_activations(x)])
            return out
        return interceptor
    with torch.inference_mode():
        with quantized.intercept_dense(activations("cuda")):
            on_card = gpu_model(small.to("cuda"), mode="inference", return_attention=True)
        with quantized.intercept_dense(activations("cpu")):
            on_cpu = cpu_model(small, mode="inference", return_attention=True)
    d_logits = (on_card["classification_logits"].cpu()
                - on_cpu["classification_logits"]).abs().max().item()
    # rows whose scale is below 1e-3 of the call's largest (padding and
    # pooled-away nodes, near zero) count apart: an ulp there is many steps.
    # A row more than a step apart is matched again against every CPU row of
    # the call: two near-equal pooling scores that round the other way on the
    # card put the same nodes in another order
    steps, faint, moved = [], [], []
    for (q_card, s_card), (q_cpu, s_cpu) in zip(acts["cuda"], acts["cpu"]):
        live = (s_cpu >= 1e-3 * s_cpu.max()).reshape(-1).numpy()
        a, b = (q.reshape(live.size, -1).numpy().astype(np.int32) for q in (q_card, q_cpu))
        d = np.abs(a - b)
        steps.append(d[live])
        faint.append(d[~live])
        far = np.flatnonzero(live & (d.max(axis=1) > 1))
        if far.size:
            nearest = np.concatenate([np.abs(a[far[i:i + 8], None] - b[None]).max(-1).min(-1)
                                      for i in range(0, far.size, 8)])
            moved.append({"shape": list(a.shape), "rows_beyond_a_step": int(far.size),
                          "beyond_a_step_of_every_cpu_row": int((nearest > 1).sum()),
                          "nearest_cpu_row_steps_max": int(nearest.max())})
    flips = sum(int((d > 0).sum()) for d in steps)
    total = sum(d.size for d in steps)
    faint_flips = sum(int((d > 0).sum()) for d in faint)
    faint_total = sum(d.size for d in faint)
    most = max(int(d.max()) for d in steps if d.size)
    log(f"int8: f32 DGDM-Base int8 forward card vs CPU on 2 graphs: logits {d_logits:.3e} "
        f"(<= {INT8['cpu_atol']}); {flips} of {total} int8 activations of live rows a step "
        f"apart (at most {most}), {faint_flips} of {faint_total} in rows below 1e-3 of the "
        f"largest scale; calls with rows more than a step apart: {moved}")
    if d_logits > INT8["cpu_atol"]:
        raise AssertionError("the int8 forward differs between the card and the CPU")
    return {"model": model, "launches": launches, "timing": timing,
            "shapes": [{"m": m, "k": k, "n": n, "calls": c}
                       for (m, k, n), c in sorted(shapes.items())],
            "cosine_logits_min": cos_logits.min().item(),
            "cosine_embedding_min": cos_emb.min().item(),
            "card_vs_cpu": {"logits_max_abs": d_logits, "activation_flips": flips,
                            "activations": total, "activation_steps_max": most,
                            "faint_row_flips": faint_flips, "faint_row_activations": faint_total,
                            "rows_more_than_a_step_apart": moved}}


def int8_featurizer(torch, card: str, model, slide: dict) -> dict:
    """The dinov2 featurizer (ViT-B/16, Macenko on the card, seed 0) with
    ``quant="int8"`` against bf16 on the slide cell's patches: feature cosine
    on 256 patches (> 0.999), throughput over 1024 patches each (CUDA events),
    a profiled int8 batch; then ``predict_slide`` with ``quant="int8"``
    (counted, 9 / 18) against the bf16 ``predict_slide``."""
    import numpy as np
    from dgdm_histopath_torch import DGDMPredictor
    from dgdm_histopath_torch.models.vit import PatchFeatureExtractor, vit_flops

    patches = slide["patches"]
    kw = dict(arch="dinov2", stain_normalize_on_device=True, seed=0, device="cuda")
    ext16, ext8 = PatchFeatureExtractor(**kw), PatchFeatureExtractor(quant="int8", **kw)
    f16, f8 = ext16.extract(patches[:256]), ext8.extract(patches[:256])
    cos = (f16 * f8).sum(-1) / (np.linalg.norm(f16, axis=-1) * np.linalg.norm(f8, axis=-1))
    reps = -(-SLIDE["throughput_patches"] // len(patches))
    on_card = torch.from_numpy(
        np.concatenate([patches] * reps)[:SLIDE["throughput_patches"]]).to("cuda")
    t8, t16 = featurizer_throughput(torch, ext8, on_card), featurizer_throughput(torch, ext16,
                                                                                 on_card)
    # int8's bound: the block products at the int8 rate, the patch embedding
    # and the attention products (bf16 operands) at the bf16 rate
    t, d, depth = 197, 768, 12
    int8_ops = depth * 2 * t * d * d * 12 * len(on_card)
    t8["bound_ms"] = (int8_ops / INT8_OPS_PER_S
                      + (vit_flops() * len(on_card) - int8_ops) / BF16_FLOPS_PER_S) * 1e3
    with torch.inference_mode():
        t8["profile"] = profile_call(torch, lambda: ext8.fused_forward(on_card[:ext8.batch_size]),
                                     f"int8 featurizer batch of {ext8.batch_size} patches")
    del on_card
    log(f"int8: featurizer feature cosine vs bf16 on 256 patches min {cos.min():.6f} (> "
        f"{INT8['cosine_featurizer']}); {t8['patches']} patches int8 {t8['ms']:.2f} ms (bound "
        f"{t8['bound_ms']:.2f}) against bf16 {t16['ms']:.2f} ms (bound {t16['bound_ms']:.2f}) "
        f"[{card}]")
    if cos.min() <= INT8["cosine_featurizer"]:
        raise AssertionError(f"int8 features' cosine against bf16 {cos.min()}")

    pred8 = DGDMPredictor(model=model, feature_extractor="dinov2", stain_normalize=True,
                          quant="int8")
    pred16 = DGDMPredictor(model=model, feature_extractor="dinov2", stain_normalize=True)
    t0 = time.perf_counter()
    r8, launches = counted(torch, lambda: pred8.predict_slide(slide["backend"], slide_id="s"),
                           expected_launches(BASE, training=False), "int8 predict_slide")
    wall8 = time.perf_counter() - t0
    r16 = pred16.predict_slide(slide["backend"], slide_id="s")
    for p in (pred8, pred16):
        p.close()
    d_prob = float(np.abs(r8["probabilities"] - r16["probabilities"]).max())
    if not (np.isfinite(r8["probabilities"]).all() and r8["num_patches"] == r16["num_patches"]
            and r8["attention_weights"].shape == (SLIDE["bucket"],)):
        raise AssertionError("int8 predict_slide: non-finite or misshaped outputs")
    log(f"int8: predict_slide launches {launches}, {wall8:.3f} s, probabilities "
        f"{r8['probabilities']} against bf16 {r16['probabilities']} (diff {d_prob:.2e}), "
        f"featurize {r8['pipeline_timings']['featurize_s']:.3f} s against "
        f"{r16['pipeline_timings']['featurize_s']:.3f} s [{card}]")
    t8["profile"].pop("top")
    return {"cosine_min": float(cos.min()), "int8": t8, "bf16": t16,
            "predict_slide": {"launches": launches, "wall_s": wall8, "prob_diff_vs_bf16": d_prob,
                              "timings": r8["pipeline_timings"],
                              "bf16_timings": r16["pipeline_timings"]}}


def int8_serve_and_edge(torch, card: str, graphs) -> dict:
    """``python -m dgdm_histopath_torch.cli.serve --quant int8`` on a DGDM-Base
    bundle: one ``/predict`` (through the dynamic batcher) and one
    ``/predict_batch`` of 3 graphs, each within 1e-5 of the in-process
    ``DGDMPredictor(quant="int8")``, SIGTERM -> 0; then an int8 edge bundle
    packaged from the model on the card, loaded and predicting on 4 graphs
    (counted, 9 / 18), equal to ``int8_apply`` of the loaded model."""
    import os
    import signal
    import socket
    import tempfile

    import numpy as np
    from dgdm_histopath_torch import DGDMPredictor, batch_graphs, create_model
    from dgdm_histopath_torch.data.graph_io import save_graph
    from dgdm_histopath_torch.deployment import EdgeConfig, EdgeDeploymentManager
    from dgdm_histopath_torch.models.presets import PRESETS
    from dgdm_histopath_torch.models.quantized import int8_apply
    from dgdm_histopath_torch.training.checkpoint import save_model_bundle

    out = {}
    config = dict(PRESETS["dgdm-base"], num_classes=2, compute_dtype="bfloat16")
    model = create_model("dgdm-base", num_classes=2, compute_dtype="bfloat16", device="cuda",
                         seed=0)
    with tempfile.TemporaryDirectory() as root:
        bundle = str(save_model_bundle(f"{root}/final_model.npz", model, config))
        names = [f"graphs/s{i}_graph.npz" for i in range(4)]
        for name, g in zip(names, graphs):
            save_graph(g, f"{root}/{name}")
        local = DGDMPredictor(model_path=bundle, quant="int8")
        want = local.predict_batch(graphs[:1]) + local.predict_batch(graphs[1:4])
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        cmd = [sys.executable, "-m", "dgdm_histopath_torch.cli.serve", "--model", bundle,
               "--port", str(port), "--data-root", root, "--dynamic-batch", "4",
               "--rate-limit", "1000", "--quant", "int8"]
        log_path = f"{root}/serve.log"
        t0 = time.perf_counter()
        with open(log_path, "w") as log_file:
            proc = subprocess.Popen(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                                    stdout=log_file, stderr=subprocess.STDOUT)
        try:
            while True:
                if proc.poll() is not None:
                    raise AssertionError(f"dgdm-serve --quant int8 exited {proc.returncode}")
                try:
                    if http_status(port, "GET", "/readyz")[0] == 200:
                        break
                except OSError:
                    pass
                if time.perf_counter() - t0 > 300:
                    raise AssertionError("dgdm-serve --quant int8 not ready within 300 s")
                time.sleep(0.25)
            ready_s = time.perf_counter() - t0
            one = http_json(port, "POST", "/predict", {"graph_path": names[0]})
            many = http_json(port, "POST", "/predict_batch", {"graph_paths": names[1:4]})
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=30)
            if rc != 0:
                raise AssertionError(f"dgdm-serve --quant int8 exit {rc}")
        except BaseException:
            with open(log_path) as f:
                log("int8: dgdm-serve log:\n" + f.read()[-4000:])
            raise
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        answers = [one] + many["results"]
        d_serve = max(same_answer(a["probabilities"], w["probabilities"], 1e-5,
                                  "dgdm-serve --quant int8 vs DGDMPredictor(quant='int8')")
                      for a, w in zip(answers, want))
        out["serve"] = {"ready_s": ready_s, "rc": rc, "prob_diff": d_serve}
        log(f"int8: dgdm-serve --quant int8 ready in {ready_s:.1f} s; /predict and "
            f"/predict_batch of 3 within {d_serve:.2e} of DGDMPredictor(quant='int8'); "
            f"SIGTERM -> {rc}")

        # the edge bundle, packaged from the model on the card
        t0 = time.perf_counter()
        path = EdgeDeploymentManager(f"{root}/edge").package(
            model, None, config, EdgeConfig(quantization="int8"))
        package_s = time.perf_counter() - t0
        with np.load(path, allow_pickle=False) as data:
            stats = json.loads(str(data["__meta__"]))["stats"]
        engine = EdgeDeploymentManager.load(path)
        batch = batch_graphs(graphs[:4])
        res, launches = counted(torch, lambda: engine.predict(batch),
                                expected_launches(BASE, training=False), "edge predict")
        with torch.inference_mode():
            ref = int8_apply(engine.model, batch.to("cuda"), mode="inference")
        probs = torch.softmax(ref["classification_logits"].float(), -1).cpu().numpy()
        d_edge = same_answer(res["probabilities"], probs, 1e-6, "edge engine vs int8_apply")
        if engine.device.type != "cuda" or res["probabilities"].shape != (4, 2):
            raise AssertionError("edge engine: not on the card or misshaped")
        out["edge"] = {"stats": stats, "package_s": package_s, "launches": launches,
                       "latency_s": res["latency_s"], "prob_diff": d_edge,
                       "bundle_bytes": os.path.getsize(path)}
        log(f"int8: edge bundle {stats['bytes_before'] / 2 ** 20:.1f} MiB -> "
            f"{stats['bytes_after'] / 2 ** 20:.1f} MiB ({stats['compression']:.3f}x), npz "
            f"{os.path.getsize(path) / 2 ** 20:.1f} MiB, packaged in {package_s:.2f} s; load + "
            f"predict on 4 graphs: launches {launches}, {res['latency_s'] * 1e3:.1f} ms, equal "
            f"to int8_apply within {d_edge:.2e} [{card}]")
    return out


def int8_phase(torch, graphs, card: str, slide: dict) -> dict:
    """int8 (ROADMAP item 13): the int8 Dense at every shape the Base forward
    gives it, the ViT-B/16 shapes at the featurizer's batch and a batch-1
    head; the Base forward, the featurizer and predict_slide, dgdm-serve and
    the edge bundle."""
    model_out = int8_model(torch, graphs, card)
    rows = [int8_dense_row(torch, s["m"], s["k"], s["n"], "DGDM-Base")
            for s in model_out["shapes"]]
    m = INT8["vit_batch"] * 197
    rows += [int8_dense_row(torch, m, k, n, f"ViT-B/16 {what}")
             for what, k, n in (("qkv", 768, 2304), ("out", 768, 768), ("mlp1", 768, 3072),
                                ("mlp2", 3072, 768), ("q, k or v alone", 768, 768))]
    rows.append(int8_dense_row(torch, 1, 128, 128, "batch-1 head"))
    layouts = int8_layouts(torch, card)
    for r in rows:
        log(f"int8: {r['what']} [{r['shape'][0]}, {r['shape'][1]}] x [{r['shape'][1]}, "
            f"{r['shape'][2]}]{' padded' if r['padded'] else ''}: _int_mm {r['int_mm_ms']:.4f} "
            f"ms, bf16 linear {r['bf16_linear_ms']:.4f}, bound {r['bound_ms']:.4f} "
            f"({r['bound_by']}), plain {r['plain_ms']:.4f}; int8 Dense {r['dense_int8_ms']:.4f} "
            f"against bf16 Dense {r['dense_bf16_ms']:.4f}; accumulators equal, output "
            f"{r['max_rel_err']:.1e} [{card}]")
    feat = int8_featurizer(torch, card, model_out.pop("model"), slide)
    torch.cuda.empty_cache()
    serve = int8_serve_and_edge(torch, card, graphs[:4])
    return {**model_out, "dense": rows, "mat2_layouts_ms": layouts, "featurizer": feat, **serve,
            "card": card}


# The half-precision cell (ROADMAP item 8): the kernels in f16 at the Base
# gather shapes and the flash shapes; DGDM-Base at full width with
# ``compute_dtype: float16`` over f32 parameters (8 pretrain + 2 finetune
# steps), with ``param_dtype: bfloat16`` (4 steps), and with ``pooling:
# set2set`` (a finetune step, a bundle served by ``DGDMPredictor``); and
# ``dgdm-train --pooling set2set`` with ``model.compute_dtype: float16`` for
# one epoch on DTYPE["cli_graphs"] graph files of the Base geometry, its
# bundle answering a /predict through ``dgdm-serve``.
DTYPE = dict(pretrain_steps=8, finetune_steps=2, bf16_param_steps=4, cli_graphs=40,
             set2set_atol=1e-3)


def dtype_kernels(torch, bf16_rows) -> dict:
    """The four gather kernels and both flash kernels in f16 against their
    plain versions on the card, timed like the bf16 rows: gather_rows
    bit-equal, gather_agg and dw within 1e-5, the backward sums within one
    f16 ulp of the plain rounded sums, flash within 1e-4 plus one f16 ulp of
    each element (its f16 split of p). ``bf16_rows``: the bf16 rows of the
    kernel phase at the same shapes, or None (then timed here)."""
    gen = torch.Generator(device="cuda").manual_seed(14)
    out = {name: [] for name in ("gather_rows", "gather_agg", "gather_rows_bwd",
                                 "gather_agg_bwd", "neighbor_transpose")}
    bf16 = {name: [] for name in out} if bf16_rows is None else None
    for (b, n, k, f) in MAIN_SHAPES:
        for dtype in ((torch.bfloat16, torch.float16) if bf16 is not None
                      else (torch.float16,)):
            src = torch.randn(b, n, f, device="cuda", generator=gen).to(dtype)
            idx = torch.randint(0, n, (b, n, k), device="cuda", generator=gen,
                                dtype=torch.int32)
            w = torch.rand(b, n, k, device="cuda", generator=gen)
            tag = dict(shape=[b, n, k, f], dtype=str(dtype).replace("torch.", ""))
            dst = out if dtype == torch.float16 else bf16
            dst["gather_rows"].append(gather_rows_row(torch, src, idx, tag))
            dst["gather_agg"].append(gather_agg_row(torch, src, idx, w, tag))
            backward_checks(torch, gen, src, idx, w, tag, dst, timed=True)
            log_kernel_rows(dst, ("gather_rows", "gather_agg", "gather_rows_bwd",
                                  "gather_agg_bwd"))
    flash = {"flash_spatial_packed": [], "flash_spatial": []}
    for (b, n, n_real, h, d) in FLASH_SHAPES:
        for dtype in ((torch.bfloat16, torch.float16) if bf16 is not None
                      else (torch.float16,)):
            name, row = flash_row(torch, gen, b, n, n_real, h, d, dtype)
            if dtype == torch.float16:
                flash[name].append(row)
            else:
                bf16.setdefault(name, []).append(row)
    # tau = 1e-3 (the bias largest in the accumulator) and an all-masked graph
    from dgdm_histopath_torch.ops.kernels import flash_spatial as fs
    for (b, n, n_real, h, d) in FLASH_SHAPES:
        name, plain = flash_versions(h, d, n)
        q, k, v, pos, mask = flash_inputs(torch, gen, min(b, 4), n, n_real, h, d,
                                          torch.float16)
        got = fs.flash_spatial_attention(q, k, v, pos, mask, tau=1e-3)
        flash_error(torch, got, plain(q, k, v, pos, mask, 1e-3), mask,
                    f"{name} f16 tau 1e-3", atol=5e-3)
        mask[0] = False
        got = fs.flash_spatial_attention(q, k, v, pos, mask)
        if not ((got[0] == 0).all() and torch.isfinite(got).all()):
            raise AssertionError(f"{name} f16: an all-masked graph must give zeros")
    out.update(flash)
    ref = bf16_rows if bf16 is None else bf16
    ratio = {}
    for name, rows in out.items():
        for r in rows:
            twin = [x for x in ref.get(name, []) if x["shape"] == r["shape"]
                    and x["dtype"] == "bfloat16" and "case" not in x]
            if twin:
                r["bf16_ms"] = twin[0]["ms"]
                ratio.setdefault(name, []).append(r["ms"] / twin[0]["ms"])
    log(f"dtype: f16 kernel time / bf16 at the same shapes {ratio}; flash f16 within 5e-3 + "
        f"1 ulp at tau 1e-3, zeros for an all-masked graph")
    return out


def dtype_flash_module(torch) -> dict:
    """``SpatialAttention(use_flash=True)`` in f16 (packed at 128 x 8 heads,
    B 32; head-major at 256 x 4, B 8), counted: the counters set to 0 just
    before the forward and read just after; against ``use_flash=False``
    within the bf16 pair's bounds (0.1 worst, 1e-2 mean)."""
    from dgdm_histopath_torch.nn.attention import SpatialAttention
    from dgdm_histopath_torch.nn.layers import init_parameters
    from dgdm_histopath_torch.ops import kernels

    res = {}
    for name, embed, heads, b in (("flash_spatial_packed", 128, 8, 32),
                                  ("flash_spatial", 256, 4, 8)):
        gen = torch.Generator(device="cuda").manual_seed(2)
        x = torch.randn(b, 1024, embed, device="cuda", generator=gen).half()
        pos = torch.rand(b, 1024, 2, device="cuda", generator=gen)
        mask = torch.arange(1024, device="cuda").expand(b, 1024) < 1000
        flash = SpatialAttention(embed, heads, use_flash=True, dtype=torch.float16)
        init_parameters(flash, torch.Generator().manual_seed(3))
        dense = SpatialAttention(embed, heads, use_flash=False, dtype=torch.float16)
        dense.load_state_dict(flash.state_dict())
        flash, dense = flash.to("cuda").eval(), dense.to("cuda").eval()
        with torch.inference_mode():
            kernels.reset_launch_counts()
            y = flash(x, pos, mask)
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
            diff = (y.float() - dense(x, pos, mask).float()).abs()
        if counts != {k: int(k == name) for k in counts}:
            raise AssertionError(f"f16 SpatialAttention(use_flash=True) launches {counts}")
        if not (diff.max().item() <= 0.1 and diff.mean().item() <= 1e-2
                and torch.isfinite(y).all()):
            raise AssertionError(f"f16 flash and dense modules differ by {diff.max().item()}")
        res[name] = {"launches": counts, "max_abs_diff": diff.max().item(),
                     "mean_abs_diff": diff.mean().item(), "batch": b}
    return res


def param_bytes(trainer) -> int:
    """Parameter + optimizer-state bytes a trainer holds."""
    total = sum(p.numel() * p.element_size() for p in trainer.model.parameters())
    for st in trainer.optimizer.state.values():
        total += sum(t.numel() * t.element_size() for t in st.values() if hasattr(t, "numel"))
    return total


def dtype_training(torch, graphs, card: str) -> dict:
    """DGDM-Base at full width through ``DGDMTrainer``: bf16 compute over f32
    parameters (3 steps, the third profiled), ``compute_dtype: float16`` over
    f32 parameters (8 pretrain + 2 finetune steps, each counted against the
    Base cell's launches, losses finite; a profiled step), and
    ``param_dtype: bfloat16`` with bf16 compute (4 steps): its parameter +
    optimizer bytes and peak memory against the f32 parameters'."""
    import math

    from dgdm_histopath_torch import DGDMTrainer, TrainerConfig, batch_graphs, create_model

    batch = batch_graphs(graphs).to("cuda")
    labeled = batch.replace(y=torch.arange(BASE["batch"], device="cuda") % 2)
    expected = expected_launches(BASE, training=True)

    def trainer_for(compute, param):
        model = create_model(BASE["preset"], num_classes=2, compute_dtype=compute,
                             param_dtype=param, device="cuda", seed=0)
        tr = DGDMTrainer(model, TrainerConfig(
            warmup_steps=WARMUP_STEPS, steps_per_epoch=DTYPE["pretrain_steps"],
            pretrain_epochs=1, max_epochs=2), device="cuda")
        tr.init_state(seed=0, example_batch=batch)
        return tr

    def run(tr, epochs, what):
        steps, wall, peaks, first = [], [], [], None
        for epoch in epochs:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            metrics, launches = counted(torch, lambda: tr.training_step(
                labeled if epoch else batch, epoch), expected, f"{what} step {len(steps)}")
            first = first or launches
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
            peaks.append(torch.cuda.max_memory_allocated() / 2 ** 30)
            bad = {k: v for k, v in metrics.items() if not math.isfinite(v)}
            if bad:
                raise AssertionError(f"{what} step {len(steps)}: non-finite {bad}")
            steps.append(metrics)
        return steps, wall, peaks, first

    res = {}
    for key, compute, param, epochs in (
            ("bf16", "bfloat16", "float32", [0, 0]),
            ("f16", "float16", "float32",
             [0] * DTYPE["pretrain_steps"] + [1] * DTYPE["finetune_steps"]),
            ("bf16_params", "bfloat16", "bfloat16", [0] * DTYPE["bf16_param_steps"])):
        tr = trainer_for(compute, param)
        if {p.dtype for n, p in tr.model.named_parameters()} != {getattr(torch, param)}:
            raise AssertionError(f"{key}: parameters not in {param}")
        steps, wall, peaks, launches = run(tr, epochs, f"DGDM-Base {compute}/{param}")
        profile = profile_call(torch, lambda: tr.training_step(batch, 0),
                               f"DGDM-Base pretrain step {compute} compute, {param} parameters")
        profile.pop("top")
        res[key] = {"compute_dtype": compute, "param_dtype": param, "launches": launches,
                    "loss": [m["loss"] for m in steps],
                    "grad_norm": [m["grad_norm"] for m in steps],
                    "step_wall_ms": wall, "peak_gib": max(peaks[1:] or peaks),
                    "param_optimizer_bytes": param_bytes(tr), "profile": profile}
        if key == "f16":
            res[key]["finetune"] = steps[DTYPE["pretrain_steps"]:]
        del tr
        torch.cuda.empty_cache()
    ratio = {"device_ms_f16_over_bf16": res["f16"]["profile"]["device_busy_ms"]
             / res["bf16"]["profile"]["device_busy_ms"],
             "bytes_bf16_params_over_f32": res["bf16_params"]["param_optimizer_bytes"]
             / res["bf16"]["param_optimizer_bytes"],
             "peak_bf16_params_over_f32": res["bf16_params"]["peak_gib"]
             / res["bf16"]["peak_gib"]}
    res["ratio"] = ratio
    log(f"dtype: DGDM-Base steps, device ms bf16 {res['bf16']['profile']['device_busy_ms']} / "
        f"f16 {res['f16']['profile']['device_busy_ms']} / bf16 parameters "
        f"{res['bf16_params']['profile']['device_busy_ms']}; f16 losses "
        f"{[round(x, 4) for x in res['f16']['loss']]}; parameter + optimizer bytes "
        f"{res['bf16']['param_optimizer_bytes']} (f32) / "
        f"{res['bf16_params']['param_optimizer_bytes']} (bf16), peak "
        f"{res['bf16']['peak_gib']:.3f} / {res['bf16_params']['peak_gib']:.3f} GiB; {ratio} "
        f"[{card}]")
    return res


def dtype_logits(torch, graphs, card: str) -> dict:
    """One set of f32 parameters computing in f32, bf16 and f16 on the card
    (batch 32, bucket 1024, inference): each half type's logits against the
    f32 logits; each forward counted (9 / 18)."""
    from dgdm_histopath_torch import batch_graphs, create_model

    batch = batch_graphs(graphs).to("cuda")
    ref_model = create_model(BASE["preset"], num_classes=2, compute_dtype="float32",
                             device="cuda", seed=0)
    state = ref_model.state_dict()
    logits = {}
    for compute in ("float32", "bfloat16", "float16"):
        model = create_model(BASE["preset"], num_classes=2, compute_dtype=compute,
                             device="cuda", seed=0)
        model.load_state_dict(state)
        with torch.inference_mode():
            out, _ = counted(torch, lambda: model(batch), expected_launches(BASE, False),
                             f"DGDM-Base {compute} forward")
        logits[compute] = out["classification_logits"].float()
        if not torch.isfinite(logits[compute]).all():
            raise AssertionError(f"{compute} logits are not finite")
    dist = {k: (logits[k] - logits["float32"]).abs().max().item()
            for k in ("bfloat16", "float16")}
    log(f"dtype: DGDM-Base logits against f32 on the card, max abs: bf16 {dist['bfloat16']:.3e}, "
        f"f16 {dist['float16']:.3e} ({dist['float16'] / dist['bfloat16']:.3f} of bf16's) "
        f"[{card}]")
    return {"max_abs_vs_f32": dist, "logit_scale": logits["float32"].abs().max().item()}


def dtype_set2set(torch, graphs, card: str, root: str) -> dict:
    """DGDM-Base with ``pooling: set2set``: one counted finetune step on the
    card (bf16 compute), then an f32 model's bundle through
    ``DGDMPredictor.predict_batch`` on the card (9 / 18 launches) against
    the same bundle's predictor on the CPU: logits within
    DTYPE["set2set_atol"] (f32 sums in other orders through the LSTM's three
    rounds), probabilities finite and summing to 1."""
    import numpy as np
    from dgdm_histopath_torch import DGDMPredictor, DGDMTrainer, TrainerConfig, batch_graphs
    from dgdm_histopath_torch import create_model
    from dgdm_histopath_torch.models.presets import PRESETS
    from dgdm_histopath_torch.training.checkpoint import save_model_bundle

    batch = batch_graphs(graphs).to("cuda")
    labeled = batch.replace(y=torch.arange(BASE["batch"], device="cuda") % 2)
    model = create_model(BASE["preset"], num_classes=2, pooling="set2set", device="cuda",
                         seed=0)
    tr = DGDMTrainer(model, TrainerConfig(warmup_steps=0, pretrain_epochs=0), device="cuda")
    tr.init_state(seed=0, example_batch=batch)
    metrics, _ = counted(torch, lambda: tr.training_step(labeled, 1),
                         expected_launches(BASE, True), "set2set finetune step")
    del tr, model
    cfg = dict(pooling="set2set", compute_dtype="float32")
    cpu_model = create_model(BASE["preset"], num_classes=2, device="cpu", seed=5, **cfg)
    preset = {k: v for k, v in PRESETS[BASE["preset"]].items() if k != "label_note"}
    path = save_model_bundle(f"{root}/set2set.npz", cpu_model,
                             {**preset, **cfg, "num_classes": 2})
    on_card = DGDMPredictor(model_path=path, device="cuda")
    on_cpu = DGDMPredictor(model_path=path, device="cpu")
    res, launches = counted(torch, lambda: on_card.predict_batch(graphs[:4]),
                            expected_launches(BASE, False), "set2set predict_batch")
    ref = on_cpu.predict_batch(graphs[:4])
    # log-probabilities: the logits less their log-sum-exp (predict_batch
    # returns no logits); they agree where the logits do
    diff = max(float(np.abs(np.log(a["probabilities"]) - np.log(b["probabilities"])).max())
               for a, b in zip(res, ref))
    if not (diff <= DTYPE["set2set_atol"] and all(
            abs(float(r["probabilities"].sum()) - 1.0) < 1e-5 for r in res)):
        raise AssertionError(f"set2set card vs CPU: log-probabilities differ by {diff}")
    log(f"dtype: set2set finetune step {metrics}; predict_batch of its f32 bundle on the card "
        f"against the CPU: log-probabilities within {diff:.2e} (<= {DTYPE['set2set_atol']}), "
        f"launches {launches} [{card}]")
    return {"finetune": metrics, "card_vs_cpu_logprob": diff, "launches": launches}


def dtype_cli(torch, card: str, root: str) -> dict:
    """``dgdm-train train --pooling set2set`` with ``model.compute_dtype:
    float16`` in a JSON config (the config's other model defaults are
    DGDM-Base's), one epoch on
    DTYPE["cli_graphs"] graph files (a process of its own), then its bundle
    (set2set, f16 in its model_config) through ``dgdm-serve``: one /predict
    within 2e-2 of ``predict_graph``, SIGTERM -> exit 0."""
    import os

    import numpy as np
    from dgdm_histopath_torch import DGDMPredictor
    from dgdm_histopath_torch.data.graph_io import load_graph

    fx = write_cli_fixture(root, DTYPE["cli_graphs"])
    with open(fx["config"]) as f:
        cfg = json.load(f)
    cfg["model"] = {"compute_dtype": "float16"}
    cfg["training"].update(max_epochs=1, pretrain_epochs=1)
    with open(f"{root}/f16.json", "w") as f:
        json.dump(cfg, f)
    argv = [sys.executable, "-m", "dgdm_histopath_torch.cli.train", "train", "--config",
            f"{root}/f16.json", "--pooling", "set2set",
            "--dataset-type", "graph", "--data-dir", fx["data"], "--metadata", fx["labels"],
            "--num-classes", "2", "--output-dir", f"{root}/out", "--log-level", "WARNING"]
    t0 = time.perf_counter()
    res = subprocess.run(argv, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"dgdm-train --pooling set2set (f16) exited {res.returncode}: "
                             f"{res.stderr[-3000:]}")
    bundle = f"{root}/out/final_model.npz"
    with np.load(bundle) as data:
        meta = json.loads(str(data["__meta__"]))
    mc = meta["model_config"]
    if (mc.get("pooling"), mc.get("compute_dtype")) != ("set2set", "float16"):
        raise AssertionError(f"the f16 set2set bundle says {mc}")
    with open(f"{root}/out/history.json") as f:
        hist = json.load(f)
    if len(hist) != 1 or not all(np.isfinite(v) for v in hist[0].values()
                                 if isinstance(v, float)):
        raise AssertionError(f"dgdm-train f16 history {hist}")
    predictor = DGDMPredictor(model_path=bundle, device="cuda")
    if predictor.model.dtype != torch.float16 or predictor.model.pooling != "set2set":
        raise AssertionError("the served bundle is not an f16 set2set model")
    names = sorted(os.listdir(fx["data"]))[:1]
    graphs = [load_graph(f"{fx['data']}/{n}") for n in names]
    served = serve_cli(bundle, fx["data"], names, graphs, predictor, count=1)
    log(f"dtype: dgdm-train --pooling set2set, model.compute_dtype float16, 1 epoch on "
        f"{DTYPE['cli_graphs']} graphs: rc 0 in {wall:.1f} s, history {hist}; dgdm-serve "
        f"answered /predict from its bundle [{card}]")
    return {"wall_s": wall, "history": hist, "serve": served, "model_config": mc}


KERNEL_SOURCES = {   # kernel -> (its source, the TPU code it stands in for)
    "gather_rows": ("gather_rows.cu", "dgdm_histopath_tpu/ops/pallas/gather_rows.py:56"),
    "gather_agg": ("gather_agg.cu", "dgdm_histopath_tpu/ops/pallas/gather_agg.py:36"),
    "gather_rows_bwd": ("gather_rows_bwd.cu", "dgdm_histopath_tpu/ops/pallas/gather_rows.py:86"),
    "gather_agg_bwd": ("gather_agg_bwd.cu", "dgdm_histopath_tpu/ops/pallas/gather_agg.py:101"),
    "neighbor_transpose": ("neighbor_transpose.cu",
                           "none: new, the list the backwards of "
                           "dgdm_histopath_tpu/ops/pallas/gather_rows.py:86 and "
                           "gather_agg.py:101 read"),
    "flash_spatial_packed": ("flash_spatial.cu",
                             "dgdm_histopath_tpu/ops/pallas/flash_spatial.py:101"),
    "flash_spatial": ("flash_spatial.cu", "dgdm_histopath_tpu/ops/pallas/flash_spatial.py:47"),
}


def f16_kernel_entries(dtype: dict) -> list:
    """The kernel line's f16 entries: each kernel's f16 instantiation at the
    first shape timed (Base B32 N1024 K8 F128; the flash shapes of run R),
    its launches on its f16 main path (the f16 Base training step for the
    gathers, the f16 ``SpatialAttention(use_flash=True)`` forward for the
    flash kernels), counted there. The list kernel is index-only: no f16."""
    entries = []
    for name, rows in dtype["kernels"].items():
        if not rows:
            continue
        source, where = KERNEL_SOURCES[name]
        r = rows[0]
        flash = name.startswith("flash")
        launches = (dtype["flash_module"][name]["launches"][name] if flash
                    else dtype["training"]["f16"]["launches"][name])
        if launches < 1:
            raise AssertionError(f"{name} f16 was launched no time on its main path")
        entries.append({
            "name": f"{name}_f16", "route": "cuda",
            "source": f"dgdm_histopath_torch/csrc/{source}", "replaces": where,
            "launches": launches, "max_abs_err": max(x["max_abs_err"] for x in rows),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "library": r.get("library", "scaled_dot_product_attention" if flash else None),
            "bf16_ms": r.get("bf16_ms"),
            "shape": ("B{} N{} H{} D{} f16".format(*r["shape"]) if flash
                      else "B{} N{} K{} F{} f16".format(*r["shape"]))})
    return entries


def dtype_phase(torch, graphs, card: str, bf16_rows=None) -> dict:
    """Phase 17: half precision (ROADMAP item 8). ``bf16_rows``: the kernel
    phase's rows to set the f16 times beside (timed here when None)."""
    import tempfile

    t0 = time.perf_counter()
    out = {"kernels": dtype_kernels(torch, bf16_rows)}
    torch.cuda.empty_cache()
    out["flash_module"] = dtype_flash_module(torch)
    out["training"] = dtype_training(torch, graphs, card)
    out["logits"] = dtype_logits(torch, graphs, card)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as root:
        out["set2set"] = dtype_set2set(torch, graphs, card, root)
        torch.cuda.empty_cache()
        out["cli"] = dtype_cli(torch, card, root)
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    log(f"dtype: phase 17 in {out['seconds']:.1f} s")
    return out


# The offline-preprocessing cell (ROADMAP item 10, the README's first two
# commands): two synthetic 20x slides of 16384² (5 levels), rendered on the
# card in bands of 2048 rows and written as deflate-tiled BigTIFFs (lossless:
# the pixels read back are the ones rendered), each >= 1000 tissue patches
# of 256 px at the CLI's tissue threshold 0.8; SlideDataset.preprocess_all
# with the dinov2 featurizer and 8 + 16 neighbours, one worker then two; the
# structure of each graph against DGDMPredictor.predict_slide's; dgdm-predict
# on the written graphs with a seeded DGDM-Base bundle; the HDF5 paths where
# h5py imports.
PREPROCESS = dict(px=16384, levels=5, band=2048, seeds=(0, 1), num_blobs=24,
                  nuclei_density=5e-4, min_patches=1000, patch=256, max_patches=1000,
                  k_spatial=8, k_morph=16, reps=5, h5_px=8192, feature_rel=1e-3)


def preprocess_band(torch, card: str) -> dict:
    """One band (seed 0, band 0, 2048 x 16384) of the band renderer on the
    card: ms by CUDA events (median of ``reps`` after a warm-up; the draws
    included) against the host ``"numpy"`` path's ms for the band's first
    2048-px tile (it renders a band tile by tile, each tile on its own
    draws; the ratio is per pixel); the
    card's band against the renderer's core on the CPU fed the card's own
    draws (one uint8 step at most, the tissue field within 1e-5)."""
    import numpy as np
    from dgdm_histopath_torch.preprocessing import synthetic as syn

    px, band, levels = PREPROCESS["px"], PREPROCESS["band"], PREPROCESS["levels"]
    dens, seed = PREPROCESS["nuclei_density"], 0
    rs = np.random.RandomState(seed)
    blobs = syn._make_blobs(rs, px, px, PREPROCESS["num_blobs"])
    coarse = rs.rand(px // 32 + 2, px // 32 + 2).astype(np.float32)
    b_card = torch.tensor(np.asarray(blobs, np.float32), device="cuda")
    c_card = torch.from_numpy(coarse).cuda()
    render = syn._device_band_renderer(px, band, levels, dens, torch.device("cuda"), seed)
    render(b_card, c_card, 0, 0)
    torch.cuda.synchronize()
    times = []
    for _ in range(PREPROCESS["reps"]):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        render(b_card, c_card, 0, 0)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    tile = 2048
    t0 = time.perf_counter()
    syn._render_band_numpy(0, band, tile, levels, blobs, coarse, dens, seed)
    numpy_ms = (time.perf_counter() - t0) * 1e3

    uniform, normal = syn.draw_band_fields(band, px, seed, 0, "cuda")
    card_outs = [o.cpu() for o in syn.render_band(b_card, c_card, 0, uniform, normal, dens,
                                                  levels)]
    t0 = time.perf_counter()
    cpu_outs = syn.render_band(b_card.cpu(), c_card.cpu(), 0, uniform.cpu(), normal.cpu(), dens,
                               levels)
    cpu_s = time.perf_counter() - t0
    d_tissue = float((syn.band_tissue(b_card, 0, band, px).cpu()
                      - syn.band_tissue(b_card.cpu(), 0, band, px)).abs().max())
    per_level = []
    for a, b in zip(card_outs, cpu_outs):
        diff = (a.int() - b.int()).abs()
        per_level.append({"max": int(diff.max()), "share": float((diff > 0).float().mean())})
    out = {"ms": statistics.median(times), "ms_all": times, "numpy_tile_ms": numpy_ms,
           "numpy_tile": [band, tile],
           "cpu_core_s": cpu_s, "levels": per_level, "tissue_max_abs": d_tissue,
           "band": [band, px]}
    log(f"preprocess: band renderer, one band of {band} x {px} and its {levels} levels: card "
        f"{out['ms']:.2f} ms (CUDA events, median of {len(times)}, draws included), host "
        f"numpy path {numpy_ms:.0f} ms on its first {band} x {tile} tile "
        f"({numpy_ms * px / tile / out['ms']:.0f}x per pixel); card vs the core on the "
        f"CPU fed the card's draws: per level max step / share of bytes that differ "
        + ", ".join(f"{r['max']} / {r['share']:.2e}" for r in per_level)
        + f" (<= 1 step), tissue field {d_tissue:.2e} (<= 1e-5); the CPU core took "
        f"{cpu_s:.1f} s [{card}]")
    if any(r["max"] > 1 for r in per_level) or d_tissue > 1e-5:
        raise AssertionError("the band renderer on the card differs from its core on the CPU")
    return out


def preprocess_render(torch, root: str, card: str) -> dict:
    """The two slides, written on the card, and their tissue patches."""
    import os

    from dgdm_histopath_torch.preprocessing import synthetic as syn
    from dgdm_histopath_torch.preprocessing.slide_io import open_slide
    from dgdm_histopath_torch.preprocessing.slide_processor import SlideProcessor

    px = PREPROCESS["px"]
    proc = SlideProcessor(patch_size=PREPROCESS["patch"], magnifications=[20.0],
                          max_patches=PREPROCESS["max_patches"])
    out = {"px": px, "levels": PREPROCESS["levels"], "band": PREPROCESS["band"],
           "cut": None, "slides": []}
    for seed in PREPROCESS["seeds"]:
        clock = {}
        t0 = time.perf_counter()
        path = syn.write_synthetic_slide_tiff(
            f"{root}/slides/slide{seed}.tif", width=px, height=px,
            num_levels=PREPROCESS["levels"], band=PREPROCESS["band"], seed=seed,
            compression="deflate", num_blobs=PREPROCESS["num_blobs"],
            nuclei_density=PREPROCESS["nuclei_density"], device="cuda", timings=clock)
        wall = time.perf_counter() - t0
        slide = open_slide(path)
        mask, mask_ds = proc.detect_tissue_regions(slide)
        tissue = len(proc.generate_patch_coordinates(slide, mask, mask_ds))
        slide.close()
        rec = {"path": str(path), "seed": seed, "wall_s": wall, "render_s": clock["render_s"],
               "encode_s": clock["encode_s"], "bands": clock["bands"],
               "mib": os.path.getsize(path) / 2 ** 20, "tissue_patches": tissue}
        out["slides"].append(rec)
        log(f"preprocess: slide{seed}.tif {px}² (not cut) at 20x, {PREPROCESS['levels']} "
            f"levels, deflate 256-px tiles, {rec['mib']:.0f} MiB: written in {wall:.1f} s "
            f"(render on the card, dispatch + fetch, {rec['render_s']:.1f} s; encode + write "
            f"in threads "
            f"{rec['encode_s']:.1f} s; {rec['bands']} bands); {tissue} tissue patches of "
            f"{PREPROCESS['patch']} px at threshold 0.8 (>= {PREPROCESS['min_patches']}) [{card}]")
        if tissue < PREPROCESS["min_patches"]:
            raise AssertionError(f"slide{seed}: {tissue} tissue patches, fewer than "
                                 f"{PREPROCESS['min_patches']}")
    return out


def graph_arrays(g) -> dict:
    return {k: getattr(g, k).cpu().numpy()
            for k in ("x", "pos", "nbr_idx", "nbr_mask", "edge_attr", "node_mask")}


def same_structure(a: dict, b: dict, what: str, feature_tol=None) -> dict:
    """Indices and masks of two graphs bit for bit (and positions); with
    ``feature_tol`` the features within it of the largest |feature|."""
    for k in ("pos", "nbr_idx", "nbr_mask", "node_mask"):
        if a[k].shape != b[k].shape or not (a[k] == b[k]).all():
            raise AssertionError(f"{what}: {k} differs")
    import numpy as np
    d_x = float(np.abs(a["x"] - b["x"]).max())
    d_attr = float(np.abs(a["edge_attr"] - b["edge_attr"]).max())
    scale = float(np.abs(b["x"]).max())
    if feature_tol is not None and d_x > feature_tol * scale:
        raise AssertionError(f"{what}: features differ by {d_x} (bound {feature_tol} x {scale})")
    return {"x_max_abs": d_x, "x_scale": scale, "edge_attr_max_abs": d_attr}


def preprocess_graphs(torch, root: str, paths: list, card: str) -> dict:
    """``SlideDataset.preprocess_all`` with one worker, then two: wall s per
    slide and per pass; the two passes' graphs equal (indices and masks bit
    for bit, features within ``feature_rel`` of the largest |feature|, with
    the featurizer's own spread on the card: the same 256 patches twice)."""
    import numpy as np
    from dgdm_histopath_torch.data import SlideDataset, load_graph
    from dgdm_histopath_torch.preprocessing.slide_processor import SlideProcessor
    from dgdm_histopath_torch.preprocessing.tissue_graph_builder import TissueGraphBuilder

    proc = SlideProcessor(patch_size=PREPROCESS["patch"], magnifications=[20.0],
                          max_patches=PREPROCESS["max_patches"])
    builder = TissueGraphBuilder(feature_extractor="dinov2", k_spatial=PREPROCESS["k_spatial"],
                                 k_morphological=PREPROCESS["k_morph"])
    rng = np.random.RandomState(0)
    probe = rng.randint(0, 255, (256, 256, 256, 3)).astype(np.uint8)
    first = builder.extractor.extract(probe)          # weights drawn, kernels warmed
    spread = float(np.abs(builder.extractor.extract(probe) - first).max())
    out = {"feature_spread": spread}
    for workers, sub in ((1, "one"), (2, "two")):
        ds = SlideDataset(paths, proc, builder)
        per_slide = {}
        build = ds._build

        def timed(path, build=build, per_slide=per_slide):
            t = time.perf_counter()
            g = build(path)
            torch.cuda.synchronize()
            per_slide[path.stem] = time.perf_counter() - t
            return g
        ds._build = timed
        t0 = time.perf_counter()
        written = ds.preprocess_all(f"{root}/{sub}", num_workers=workers)
        wall = time.perf_counter() - t0
        if [p.name for p in written] != [f"{p.stem}_graph.npz" for p in paths]:
            raise AssertionError(f"preprocess_all({workers}) wrote {written}")
        out[sub] = {"workers": workers, "wall_s": wall, "per_slide_s": per_slide,
                    "files": [str(p) for p in written]}
        log(f"preprocess: SlideDataset.preprocess_all(num_workers={workers}) on "
            f"{len(paths)} slides in {wall:.2f} s; per slide (its own build, save excluded) "
            + ", ".join(f"{k} {v:.2f} s" for k, v in per_slide.items()) + f" [{card}]")
    diffs = []
    graphs = []
    for a, b in zip(out["one"]["files"], out["two"]["files"]):
        ga, gb = graph_arrays(load_graph(a)), graph_arrays(load_graph(b))
        diffs.append(same_structure(ga, gb, "preprocess_all 1 vs 2 workers",
                                    PREPROCESS["feature_rel"]))
        graphs.append(ga)
        if int(ga["node_mask"].sum()) != PREPROCESS["max_patches"]:
            raise AssertionError(f"{a}: {int(ga['node_mask'].sum())} real nodes")
    out["one_vs_two"] = diffs
    log("preprocess: one worker vs two: neighbour lists, masks and positions equal; features "
        + ", ".join(f"{d['x_max_abs']:.2e}" for d in diffs)
        + f" (<= {PREPROCESS['feature_rel']} x the largest |feature|; the featurizer's spread "
        f"on the card over the same 256 patches twice {spread:.2e}); graphs of "
        f"{graphs[0]['x'].shape[0]} nodes, {graphs[0]['x'].shape[1]}-d, "
        f"{graphs[0]['nbr_idx'].shape[1]} neighbours [{card}]")
    return out, graphs


def preprocess_predict(torch, root: str, paths: list, graphs: list, card: str) -> dict:
    """``DGDMPredictor.predict_slide`` on each slide (counted: 9 + 18) and
    its graph's structure against ``preprocess_all``'s; then ``dgdm-predict``
    on the written graphs with a seeded DGDM-Base bundle (counted)."""
    import numpy as np
    from dgdm_histopath_torch import DGDMPredictor, create_model
    from dgdm_histopath_torch.cli import predict as predict_cli
    from dgdm_histopath_torch.data import load_graph
    from dgdm_histopath_torch.models.presets import PRESETS
    from dgdm_histopath_torch.training.checkpoint import save_model_bundle

    model = create_model("dgdm-base", num_classes=2, compute_dtype="bfloat16", device="cuda",
                         seed=0)
    bundle = str(save_model_bundle(f"{root}/base.npz", model, dict(
        PRESETS["dgdm-base"], num_classes=2, compute_dtype="bfloat16")))
    predictor = DGDMPredictor(model=model, feature_extractor="dinov2")
    captured = []
    build = predictor.graph_builder.build_graph

    def capture(*a, **k):
        captured.append(build(*a, **k))
        return captured[-1]
    predictor.graph_builder.build_graph = capture
    fwd = expected_launches(BASE, training=False)
    out = {"predict_slide": {"s": [], "morph_slots_equal": []}}
    try:
        for path, ours in zip(paths, graphs):
            t0 = time.perf_counter()
            res, launches = counted(torch, lambda: predictor.predict_slide(path), fwd,
                                    "predict_slide")
            out["predict_slide"]["s"].append(time.perf_counter() - t0)
            out["predict_slide"]["launches"] = launches
            theirs = graph_arrays(captured[-1])
            k = PREPROCESS["k_spatial"]
            for key in ("pos", "node_mask"):
                if not (theirs[key] == ours[key]).all():
                    raise AssertionError(f"{path}: predict_slide's graph differs in {key}")
            if not ((theirs["nbr_idx"][:, :k] == ours["nbr_idx"][:, :k]).all()
                    and (theirs["nbr_mask"][:, :k] == ours["nbr_mask"][:, :k]).all()):
                raise AssertionError(f"{path}: predict_slide's spatial neighbours differ")
            out["predict_slide"]["morph_slots_equal"].append(
                float((theirs["nbr_idx"][:, k:] == ours["nbr_idx"][:, k:]).mean()))
            if not np.isfinite(res["probabilities"]).all():
                raise AssertionError("predict_slide: non-finite probabilities")
    finally:
        predictor.close()
    log(f"preprocess: predict_slide on each slide in "
        + ", ".join(f"{s:.2f}" for s in out["predict_slide"]["s"])
        + f" s, launches {out['predict_slide']['launches']}; its graphs' positions, node masks and "
        f"8 spatial neighbour slots equal preprocess_all's; morphological slots equal "
        + ", ".join(f"{100 * s:.1f}%" for s in out["predict_slide"]["morph_slots_equal"])
        + " (the predictor normalizes stains inside the featurizer, preprocess_all in the "
        f"processor) [{card}]")
    del predictor, model
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    rc, launches = counted(torch, lambda: predict_cli.main(
        ["--model", bundle, "--input", f"{root}/one", "--output-dir", f"{root}/preds",
         "--format", "both", "--log-level", "WARNING"]),
        {k: len(paths) * v for k, v in fwd.items()}, "dgdm-predict")
    wall = time.perf_counter() - t0
    ref = DGDMPredictor(model_path=bundle)
    worst = 0.0
    for path in paths:
        with open(f"{root}/preds/{path.stem}_graph.json") as f:
            got = np.asarray(json.load(f)["probabilities"])
        want = ref.predict_graph(load_graph(f"{root}/one/{path.stem}_graph.npz"))["probabilities"]
        worst = max(worst, float(np.abs(got - want).max()))
    if rc != 0 or worst != 0.0:
        raise AssertionError(f"dgdm-predict rc {rc}, probabilities off by {worst}")
    out["predict"] = {"rc": rc, "graphs": len(paths), "launches": launches, "wall_s": wall}
    log(f"preprocess: dgdm-predict rc {rc} on the {len(paths)} written graphs in {wall:.1f} s, "
        f"launches {launches} ({len(paths)} x 9 + 18), probabilities equal to "
        f"DGDMPredictor.predict_graph of the bundle [{card}]")
    out["bundle"] = bundle
    return out


def preprocess_hdf5(torch, root: str, paths: list, graphs: list, bundle: str,
                    card: str) -> dict:
    """Where h5py imports: ``dgdm-preprocess`` process-slides ->
    build-graphs -> validate-preprocessing on the same slides (graphs equal
    to ``preprocess_all``'s), and a ``write_synthetic_slide_hdf5`` slide on
    the card through ``predict_slide`` and the native reader."""
    try:
        import h5py  # noqa: F401
    except ImportError:
        log("preprocess: h5py is not importable on this machine: dgdm-preprocess "
            "(process-slides, build-graphs, validate-preprocessing), write_synthetic_slide_hdf5 "
            "and predict_slide of an .h5 slide through the native reader did not run here; "
            "tests/test_torch_{hdf5,synthetic,preprocess_cli}.py hold them against the JAX "
            "package on the CPU")
        return {"h5py": False}
    import contextlib
    import io

    from dgdm_histopath_torch import DGDMPredictor, native
    from dgdm_histopath_torch.cli import preprocess as pre_cli
    from dgdm_histopath_torch.data import load_graph
    from dgdm_histopath_torch.preprocessing import synthetic as syn

    out = {"h5py": True}
    slides = str(paths[0].parent)
    t0 = time.perf_counter()
    rc1 = pre_cli.main(["process-slides", "--input-dir", slides, "--output-dir", f"{root}/h5",
                        "--stain-normalize", "--log-level", "WARNING"])
    rc2 = pre_cli.main(["build-graphs", "--input-dir", f"{root}/h5", "--output-dir",
                        f"{root}/cli_graphs", "--log-level", "WARNING"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc3 = pre_cli.main(["validate-preprocessing", "--dir", f"{root}/cli_graphs"])
    report = json.loads(buf.getvalue().strip().splitlines()[-1])
    out["cli"] = {"rcs": [rc1, rc2, rc3], "validate": report, "s": time.perf_counter() - t0}
    if [rc1, rc2, rc3] != [0, 0, 0] or report["graphs"] != len(paths):
        raise AssertionError(f"dgdm-preprocess: {out['cli']}")
    out["cli"]["vs_preprocess_all"] = [
        same_structure(graph_arrays(load_graph(f"{root}/cli_graphs/{p.stem}_graph.npz")), g,
                       "dgdm-preprocess vs preprocess_all", PREPROCESS["feature_rel"])
        for p, g in zip(paths, graphs)]
    px = PREPROCESS["h5_px"]
    t0 = time.perf_counter()
    h5 = syn.write_synthetic_slide_hdf5(f"{root}/slide.h5", width=px, height=px, num_levels=4,
                                        tile=PREPROCESS["band"], seed=7, device="cuda")
    out["h5_write_s"] = time.perf_counter() - t0
    predictor = DGDMPredictor(model_path=bundle)
    native.reset_reader_counts()
    try:
        res, launches = counted(torch, lambda: predictor.predict_slide(h5),
                                expected_launches(BASE, training=False), "predict_slide .h5")
    finally:
        predictor.close()
    out["h5_predict"] = {"launches": launches, "readers": native.reader_counts(),
                         "num_patches": res["num_patches"]}
    if out["h5_predict"]["readers"]["native"] < 1:
        raise AssertionError(f"the .h5 slide was not read natively: {out['h5_predict']}")
    log(f"preprocess: h5py found: dgdm-preprocess rcs {out['cli']['rcs']}, validate {report}, "
        f"graphs equal to preprocess_all's; a {px}² .h5 slide written on the card in "
        f"{out['h5_write_s']:.1f} s, predict_slide {out['h5_predict']} [{card}]")
    return out


def preprocess_phase(torch, card: str) -> dict:
    """Phase 18: the offline-preprocessing cell."""
    import tempfile
    from pathlib import Path

    t_phase = time.perf_counter()
    out = {"card": card, "band": preprocess_band(torch, card)}
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as root:
        out["render"] = preprocess_render(torch, root, card)
        paths = [Path(s["path"]) for s in out["render"]["slides"]]
        torch.cuda.empty_cache()
        out["graphs"], graphs = preprocess_graphs(torch, root, paths, card)
        torch.cuda.empty_cache()
        pred = preprocess_predict(torch, root, paths, graphs, card)
        out["predict_slide"], out["predict"] = pred["predict_slide"], pred["predict"]
        torch.cuda.empty_cache()
        out["hdf5"] = preprocess_hdf5(torch, root, paths, graphs, pred["bundle"], card)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"preprocess: phase 18 took {out['phase_s']:.1f} s [{card}]")
    return out


# Phase 19, the research path: gradients of the DGDM-Base inference forward
# with respect to the node features (saliency, integrated gradients with 16
# steps, FGSM, PGD with 10 steps) on the Base cell's 32 graphs, and the
# research graph modules at Base widths. One gradient call launches what one
# Base training step launches: 9 / 18 / 9 / 18 + 3.
RESEARCH = dict(ig_steps=16, pgd_steps=10, epsilon=0.05, hier_hidden=512, hier_heads=8,
                hier_levels=2, grad_rtol=1e-3, module_rtol=1e-4, reps=3)


def research_expected(grads: int, forwards: int = 0, gathers: int = 0) -> dict:
    """Launches of ``grads`` feature-gradient calls and ``forwards``
    gradient-free forwards of DGDM-Base, plus ``gathers`` lone row gathers."""
    per_step = expected_launches(BASE, training=True)
    per_fwd = expected_launches(BASE, training=False)
    return {k: grads * per_step[k] + forwards * per_fwd[k] + (gathers if k == "gather_rows"
                                                              else 0)
            for k in per_step}


def event_ms(torch, fn, reps: int) -> tuple:
    """(median ms, all ms) of ``reps`` calls of ``fn`` between CUDA events,
    after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), times


def research_grad_card_vs_cpu(torch, graphs) -> dict:
    """The f32 ∂class-score/∂x of one DGDM-Base parameter set on the card
    (the gather kernels and their backwards) and on the CPU (the plain
    versions), 2 graphs: within 1e-3 of the CPU tensor's largest entry."""
    from dgdm_histopath_torch import batch_graphs, create_model
    from dgdm_histopath_torch.research import ClinicalSaliencyAnalyzer

    cpu_model = create_model("dgdm-base", num_classes=2, compute_dtype="float32",
                             device="cpu", seed=1)
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    batch = batch_graphs(graphs[:2])
    g_cpu = ClinicalSaliencyAnalyzer(cpu_model).class_score_grad(batch.x, batch, 1)
    g_card = ClinicalSaliencyAnalyzer(gpu_model).class_score_grad(
        batch.x.to("cuda"), batch.to("cuda"), 1).cpu()
    scale = g_cpu.abs().max().item()
    err = (g_card - g_cpu).abs().max().item()
    log(f"research: f32 d class-score / dx card vs CPU on 2 graphs: max abs {err:.3e} of "
        f"largest {scale:.3e} ({err / scale:.3e} <= {RESEARCH['grad_rtol']:g})")
    if not (scale > 0 and err <= RESEARCH["grad_rtol"] * scale
            and bool(torch.isfinite(g_card).all())):
        raise AssertionError("the card's feature gradient disagrees with the CPU's")
    return {"max_abs": err, "largest": scale, "rel": err / scale}


def research_attack_checks(torch, adv, batch, eps: float, what: str) -> float:
    """The perturbation of an attack: within eps on real nodes (and moved;
    plus the rounding of x + eps in f32, 2 ulps of the largest |x|), zero on
    padding; returns its largest entry."""
    delta = (adv.x - batch.x).abs()
    bound = eps + 2.0 ** -22 * batch.x.abs().max().item()
    real = batch.node_mask[..., None].expand_as(delta)
    big = delta[real].max().item()
    pad = delta[~real].max().item() if bool((~real).any()) else 0.0
    log(f"research: {what}: |x_adv - x| <= {big:.6f} on real nodes (eps {eps}), "
        f"{pad} on padding")
    if not (0 < big <= bound and pad == 0.0):
        raise AssertionError(f"{what}: perturbation {big} / padding {pad} outside the ball")
    return big


def research_modules(torch, graphs, card: str) -> dict:
    """HierarchicalEncoder (768 -> 512, 8 heads, 2 levels of 2 layers),
    PhaseModulatedGraphDiffusion (768, 3 rounds) and AdaptiveGraphTopology
    (768 -> 512) at f32 on the 32 Base graphs, counted, and on 2 graphs
    against the CPU within 1e-4 of each output's largest entry."""
    from dgdm_histopath_torch import batch_graphs
    from dgdm_histopath_torch.models import HierarchicalEncoder
    from dgdm_histopath_torch.nn.layers import init_parameters
    from dgdm_histopath_torch.research import (
        AdaptiveGraphTopology,
        PhaseModulatedGraphDiffusion,
    )

    hidden, heads, levels = (RESEARCH["hier_hidden"], RESEARCH["hier_heads"],
                             RESEARCH["hier_levels"])
    mods = {
        "hierarchical_encoder": (HierarchicalEncoder(768, hidden, num_levels=levels,
                                                     num_heads=heads), 2 * levels, 4 * levels),
        "phase_diffusion": (PhaseModulatedGraphDiffusion(768, num_rounds=3), 3, 0),
        "adaptive_topology": (AdaptiveGraphTopology(768, hidden), 1, 0),
    }
    batch = batch_graphs(graphs)
    card_batch = batch.to("cuda")
    small = batch_graphs(graphs[:2])
    out = {}
    for name, (mod, rows, aggs) in mods.items():
        init_parameters(mod, torch.Generator().manual_seed(3)).eval()
        on_card = copy.deepcopy(mod).to("cuda")

        def call(m, g):
            if name == "adaptive_topology":
                return m(g.x, g.nbr_idx, g.nbr_mask)["edge_weights"]
            return m(g.x, g.nbr_idx, g.nbr_mask, g.node_mask)

        expected = {k: 0 for k in expected_launches(BASE, training=False)}
        expected.update(gather_rows=rows, gather_agg=aggs)
        with torch.no_grad():
            res, launches = counted(torch, lambda: call(on_card, card_batch), expected,
                                    f"research {name}")
            ms, _ = event_ms(torch, lambda: call(on_card, card_batch), RESEARCH["reps"])
            ref = call(mod, small)
            got = call(on_card, small.to("cuda")).cpu()
        scale = max(ref.abs().max().item(), 1e-30)
        err = (got - ref).abs().max().item()
        log(f"research: {name} f32 batch 32: {ms:.3f} ms, launches {launches}; card vs CPU "
            f"on 2 graphs {err:.3e} of largest {scale:.3e} [{card}]")
        if not (bool(torch.isfinite(res).all()) and err <= RESEARCH["module_rtol"] * scale):
            raise AssertionError(f"research {name}: the card disagrees with the CPU")
        out[name] = {"ms": ms, "launches": launches, "max_abs": err, "largest": scale,
                     "shape": list(res.shape)}
    return out


def research_phase(torch, graphs, card: str) -> dict:
    """Phase 19: saliency, integrated gradients, FGSM, PGD and the robustness
    report on DGDM-Base (bf16, seeded) over the Base cell's 32 graphs, each
    counted; the f32 gradient card vs CPU; times; the research modules."""
    from dgdm_histopath_torch import batch_graphs, create_model
    from dgdm_histopath_torch.research import (
        ClinicalAdversarialDefense,
        ClinicalSaliencyAnalyzer,
        MedicalAdversarialAttack,
        RobustnessAnalyzer,
    )

    import numpy as np

    t_phase = time.perf_counter()
    segments = {}

    def lap(name):
        segments[name] = time.perf_counter() - t_phase - sum(segments.values())

    model = create_model("dgdm-base", num_classes=2, device="cuda", seed=0)
    batch = batch_graphs(graphs).to("cuda")
    labels = torch.tensor([i % 2 for i in range(len(graphs))], device="cuda")
    sal = ClinicalSaliencyAnalyzer(model)
    eps, steps = RESEARCH["epsilon"], RESEARCH["pgd_steps"]
    attack = MedicalAdversarialAttack(model, epsilon=eps, pgd_steps=steps)
    out = {"card": card}

    # the main path of this phase, counted: one gradient call each
    saliency, out["launches"] = counted(torch, lambda: sal.node_saliency(batch, class_idx=1),
                                        research_expected(1), "research node_saliency")
    log(f"research: node_saliency launches {out['launches']} (one training step's)")
    if not (np.isfinite(saliency).all() and saliency.shape == tuple(batch.node_mask.shape)
            and saliency[~batch.node_mask.cpu().numpy()].max() == 0.0
            and saliency.max() > 0):
        raise AssertionError("research: bad saliency map")
    ig, out["ig_launches"] = counted(
        torch, lambda: sal.integrated_gradients(batch, 1, steps=RESEARCH["ig_steps"]),
        research_expected(RESEARCH["ig_steps"]), "research integrated_gradients")
    if not (np.isfinite(ig).all() and ig[~batch.node_mask.cpu().numpy()].max() == 0.0):
        raise AssertionError("research: bad integrated gradients")
    adv, out["fgsm_launches"] = counted(torch, lambda: attack.fgsm(batch, labels),
                                        research_expected(1), "research fgsm")
    out["fgsm_max_delta"] = research_attack_checks(torch, adv, batch, eps, "fgsm")
    gen = torch.Generator("cuda").manual_seed(0)
    adv, out["pgd_launches"] = counted(torch, lambda: attack.pgd(batch, labels, gen),
                                       research_expected(steps), "research pgd")
    out["pgd_max_delta"] = research_attack_checks(torch, adv, batch, eps, "pgd (random start)")
    # clean, attacked and defended forwards; the defense's smoothing gathers once a method
    report, out["analyze_launches"] = counted(
        torch, lambda: RobustnessAnalyzer(model).analyze(
            batch, labels.cpu().numpy(), attack, ClinicalAdversarialDefense(noise_sigma=0.01),
            generator=torch.Generator("cuda").manual_seed(1)),
        research_expected(1 + steps, forwards=5, gathers=2), "research analyze")
    log(f"research: RobustnessAnalyzer.analyze (fgsm, pgd, defended): {json.dumps(report)}")
    out["report"] = report
    lap("counted calls")

    # times: CUDA events around whole calls (the host waits inside each)
    timing = {}
    timing["saliency_ms"], timing["saliency_ms_all"] = event_ms(
        torch, lambda: sal.node_saliency(batch, class_idx=1), RESEARCH["reps"])
    timing["ig_ms"], timing["ig_ms_all"] = event_ms(
        torch, lambda: sal.integrated_gradients(batch, 1, steps=RESEARCH["ig_steps"]),
        RESEARCH["reps"])
    timing["pgd_ms"], timing["pgd_ms_all"] = event_ms(
        torch, lambda: attack.pgd(batch, labels), RESEARCH["reps"])
    torch.cuda.reset_peak_memory_stats()
    prof = profile_call(torch, lambda: sal.integrated_gradients(
        batch, 1, steps=RESEARCH["ig_steps"]), "DGDM-Base integrated_gradients (16 steps)",
        host=False)
    prof.pop("top")
    timing["ig_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    timing["ig_profile"] = prof
    timing["ig_busy_share"] = (None if prof["device_busy_ms"] is None
                               else prof["device_busy_ms"] / prof["wall_ms"])
    lap("timing")
    log(f"research: DGDM-Base bf16 batch 32: node_saliency {timing['saliency_ms']:.3f} ms, "
        f"integrated_gradients ({RESEARCH['ig_steps']} steps) {timing['ig_ms']:.3f} ms, "
        f"pgd ({steps} steps) {timing['pgd_ms']:.3f} ms (CUDA events, median of "
        f"{RESEARCH['reps']}); one IG call's device busy share {timing['ig_busy_share']}, "
        f"peak {timing['ig_peak_gib']:.2f} GiB [{card}]")
    out["timing"] = timing
    del model, sal, attack, batch
    torch.cuda.empty_cache()

    out["grad_parity"] = research_grad_card_vs_cpu(torch, graphs)
    lap("gradient card vs CPU")
    torch.cuda.empty_cache()
    out["modules"] = research_modules(torch, graphs, card)
    lap("modules")
    out["phase_s"], out["segments_s"] = time.perf_counter() - t_phase, segments
    log(f"research: phase 19 took {out['phase_s']:.1f} s ({segments}) [{card}]")
    return out


# Phase 20 (item 14's kernel paths): dgdm-quality and its gates on the card,
# ResilientTrainer and federated DGDM-Base training. The gates run their JAX
# sizes (16-d features, 32 nodes, 2 graphs); the trainers DGDM-Base at full
# width on the Base cell's 32 graphs, bf16 compute, f32 parameters.
QUALITY = dict(parallel=4, process_workers=2, resilient_steps=6, checkpoint_every=2,
               cleanup_every=3, fail_step=3, fed_local_steps=2, fed_rounds=2,
               dp_clip=1.0, dp_noise=0.01, cpu_graphs=2, loss_atol=1e-4, cli_timeout=900)


def quality_cli(args: list, what: str) -> tuple:
    """``python -m dgdm_histopath_torch.cli.quality_gates --level production
    <args>`` as a process on the card: (its JSON summary, wall s). Fails
    unless it exits 0 with every gate passed."""
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "dgdm_histopath_torch.cli.quality_gates",
                          "--level", "production", "--log-level", "WARNING", *args],
                         capture_output=True, text=True, timeout=QUALITY["cli_timeout"])
    secs = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"quality: {what} exited {res.returncode}:\n{res.stdout[-3000:]}"
                             f"\n{res.stderr[-3000:]}")
    summary = json.loads(res.stdout)
    bad = {k: v for k, v in summary["gates"].items() if v != "passed"}
    if bad or len(summary["gates"]) != 13 or not summary["passed"]:
        raise AssertionError(f"quality: {what}: {summary}")
    log(f"quality: {what}: 13 gates passed in {secs:.1f} s "
        f"(cache hits {summary.get('cache_hits')}, speedup {summary.get('parallel_speedup')})")
    return summary, secs


def quality_gates_phase(torch, card: str) -> dict:
    """dgdm-quality --level production as a process (serial; then --parallel
    4 with a cache, twice: the second run serves all 13 from it), the seven
    model gates in two worker processes, and each model gate in this
    process, counted."""
    import tempfile

    from dgdm_histopath_torch.ops import kernels
    from dgdm_histopath_torch.testing import quality_gates as qg
    from dgdm_histopath_torch.testing.scalable_gates import ScalableQualityGateRunner

    out = {}
    with tempfile.TemporaryDirectory() as root:
        report_path = f"{root}/report.json"
        out["cli"], out["cli_s"] = quality_cli(["--output", report_path], "dgdm-quality")
        with open(report_path) as f:
            out["cli_gate_s"] = {g["name"]: g["duration_s"] for g in json.load(f)["gates"]}
        cache = ["--parallel", str(QUALITY["parallel"]), "--cache-dir", f"{root}/cache"]
        # the first use of each kernel library from 4 threads at once, in a fresh process
        out["threads"], out["threads_s"] = quality_cli(cache, "dgdm-quality --parallel 4")
        out["cached"], out["cached_s"] = quality_cli(cache, "dgdm-quality --parallel 4 again")
        if out["cached"]["cache_hits"] != 13:
            raise AssertionError(f"quality: the cached run served {out['cached']['cache_hits']}")

    t0 = time.perf_counter()
    report = ScalableQualityGateRunner("production", max_workers=QUALITY["process_workers"],
                                       mode="process", device="cuda").run(list(qg.MODEL_GATES))
    out["process_s"] = time.perf_counter() - t0
    out["process_gate_s"] = {g["name"]: g["duration_s"] for g in report["gates"]}
    bad = {g["name"]: g["error"] for g in report["gates"] if g["status"] != "passed"}
    if bad or not report["passed"]:
        raise AssertionError(f"quality: process mode: {bad}")
    log(f"quality: the 7 model gates in {QUALITY['process_workers']} processes: passed in "
        f"{out['process_s']:.1f} s")

    out["launches"], out["gate_s"] = {}, {}
    for name in qg.MODEL_GATES:
        kernels.reset_launch_counts()
        res = qg.run_gate(name, torch.device("cuda"))
        torch.cuda.synchronize()
        out["launches"][name] = kernels.launch_counts()
        out["gate_s"][name] = res["duration_s"]
        if res["status"] != "passed":
            raise AssertionError(f"quality: gate {name} on the card: {res['error']}")
        log(f"quality: gate {name} passed in {res['duration_s']:.3f} s, launches "
            f"{out['launches'][name]} [{card}]")
    step = out["launches"]["training_step"]
    missing = [k for k in ("gather_rows", "gather_agg", "gather_rows_bwd", "gather_agg_bwd",
                           "neighbor_transpose") if step[k] < 1]
    if missing:
        raise AssertionError(f"quality: the training_step gate launched no {missing}")
    return out


def base_trainer(torch, batch, seed: int = 0, **model):
    """DGDM-Base as the training cell trains it, initialized."""
    from dgdm_histopath_torch import DGDMTrainer, TrainerConfig, create_model

    cfg = model.pop("config", dict(warmup_steps=WARMUP_STEPS, steps_per_epoch=8,
                                   pretrain_epochs=1, max_epochs=2))
    m = create_model("dgdm-base", num_classes=2, device=model.pop("device", "cuda"),
                     seed=seed, **{"compute_dtype": "bfloat16", **model})
    trainer = DGDMTrainer(m, TrainerConfig(**cfg), device=m.mask_token.device)
    trainer.init_state(seed=0, example_batch=batch)
    return trainer


def resilient_phase(torch, graphs, card: str) -> dict:
    """ResilientTrainer over DGDM-Base, batch 32: 6 steps, a checkpoint every 2
    and an allocator cleanup every 3; a CUDA out-of-memory error raised from
    a forward hook in step 3, the first time only. Its metrics against an
    uninterrupted run of the same seed, bit for bit; then one step lost,
    recover_from_checkpoint() and the step again, against step 7."""
    import tempfile

    from dgdm_histopath_torch import batch_graphs
    from dgdm_histopath_torch.training import CheckpointManager
    from dgdm_histopath_torch.utils.resilient_training import ResilientTrainer

    steps = QUALITY["resilient_steps"]
    batch = batch_graphs(graphs).to("cuda")
    ref_trainer = base_trainer(torch, batch)
    ref = [ref_trainer.training_step(batch, 0) for _ in range(steps + 1)]
    del ref_trainer
    torch.cuda.empty_cache()

    trainer = base_trainer(torch, batch)
    out = {"card": card}
    with tempfile.TemporaryDirectory() as root:
        rt = ResilientTrainer(trainer, CheckpointManager(root),
                              checkpoint_every_steps=QUALITY["checkpoint_every"],
                              cleanup_every_steps=QUALITY["cleanup_every"])
        injected = {"left": 1}

        def oom(module, args, output):
            if trainer.step == QUALITY["fail_step"] - 1 and injected["left"]:
                injected["left"] -= 1
                raise torch.cuda.OutOfMemoryError("injected into step 3's forward")
        hook = trainer.model.feature_encoder.register_forward_hook(oom)
        expected = expected_launches(BASE, training=True)
        metrics, out["step_s"] = [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            m, launches = counted(torch, lambda: rt.training_step(batch, epoch=0), expected,
                                  "ResilientTrainer step")
            out["step_s"].append(time.perf_counter() - t0)
            metrics.append(m)
        hook.remove()
        out["launches"], out["stats"] = launches, dict(rt.stats)
        if injected["left"] or rt.stats != {"steps": steps, "errors_recovered": 1,
                                            "batches_skipped": 0, "checkpoints_saved": 3}:
            raise AssertionError(f"ResilientTrainer stats {rt.stats}")
        if metrics != ref[:steps]:
            raise AssertionError(f"ResilientTrainer metrics {metrics} against {ref[:steps]}")
        trainer.training_step(batch, 0)                     # a step the checkpoint lacks
        t0 = time.perf_counter()
        if not rt.recover_from_checkpoint():
            raise AssertionError("ResilientTrainer: no checkpoint to recover")
        out["recover_s"] = time.perf_counter() - t0
        again = rt.training_step(batch, epoch=0)
        if again != ref[steps] or trainer.step != steps + 1:
            raise AssertionError(f"step after recovery {again} against {ref[steps]}")
        out["checkpoints"] = rt.checkpoint_manager.all_steps()
    log(f"quality: ResilientTrainer DGDM-Base batch 32: {steps} steps with one injected "
        f"OutOfMemoryError: {out['stats']}, metrics equal to the uninterrupted run to the bit, "
        f"launches a step {out['launches']}; step s {[round(s, 3) for s in out['step_s']]} "
        f"(step 3 holds the 0.5 s backoff), recovery {out['recover_s']:.2f} s, then step 7 "
        f"equal [{card}]")
    del trainer, rt
    torch.cuda.empty_cache()
    return out


def max_ulps(torch, got, want) -> float:
    """The largest |got - want| over the f32 spacing at |want|."""
    spacing = torch.nextafter(want.abs(), torch.full_like(want, float("inf"))) - want.abs()
    return float(((got - want).abs() / spacing).max())


def federated_round_check(torch, man, round_idx: int, factor: float = 1.0) -> dict:
    """One round of ``man``, its updates captured: the new global parameters
    against the f64 weighted mean of the updates applied to the old ones
    (in f32 ulps), and the update's global norm."""
    from dgdm_histopath_torch.quantum.federated_learning import FederatedStrategy

    server = man.server
    captured = {}
    for client in server.clients:
        def capture(g, r, gen, client=client, fn=type(client).compute_update):
            captured[client.client_id] = fn(client, g, r, gen)
            return captured[client.client_id]
        client.compute_update = capture
    old = {k: v.clone() for k, v in server.global_params.items()}
    weights = [float(c.num_samples) for c in server.clients]
    if server.strategy == FederatedStrategy.QUANTUM_FED:
        weights = [w ** 0.5 for w in weights]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    stats = server.run_round(round_idx)
    end.record()
    end.synchronize()
    total = sum(weights)
    ulps = 0.0
    for k, p in old.items():
        agg = sum((w / total) * captured[c.client_id][k].double()
                  for c, w in zip(server.clients, weights))
        want = (p.double() + server.server_lr * factor * agg).float()
        ulps = max(ulps, max_ulps(torch, server.global_params[k], want))
    for client in server.clients:
        del client.compute_update
    return {"stats": stats, "max_ulps": ulps, "updates": captured, "old": old,
            "event_ms": start.elapsed_time(end)}


def federated_card_vs_cpu(torch, graphs) -> dict:
    """One FedAvg round, 2 clients x 1 local step on 2 graphs each, f32,
    finetune phase, dropout 0, on the card and on the CPU: each client's
    loss within 1e-4, the global parameters within 2 lr + 1e-5 max(1, |p|max)."""
    from dgdm_histopath_torch import batch_graphs
    from dgdm_histopath_torch.quantum import FederatedDGDMManager

    n = QUALITY["cpu_graphs"]
    labelled = [g.replace(y=torch.tensor(i % 2)) for i, g in enumerate(graphs[:2 * n])]
    cfg = dict(warmup_steps=0, pretrain_epochs=0, max_epochs=2, steps_per_epoch=8)
    res = {}
    for dev in ("cuda", "cpu"):
        loaders = {f"site{i}": [batch_graphs(labelled[i * n:(i + 1) * n]).to(dev)]
                   for i in range(2)}
        losses = {}

        def factory(dev=dev, loaders=loaders):
            t = base_trainer(torch, next(iter(loaders.values()))[0], seed=1, device=dev,
                             compute_dtype="float32", dropout=0.0, config=cfg)
            step = t.training_step

            def recorded(batch, epoch=None, t=t, step=step):
                m = step(batch, epoch)
                losses.setdefault(id(t), []).append(m["loss"])
                return m
            t.training_step = recorded
            return t
        man = FederatedDGDMManager(factory, loaders, local_steps=1)
        man.run(1)
        res[dev] = ({k: v.detach().cpu() for k, v in man.global_params.items()},
                    [losses[id(t)][0] for t in man.trainers.values()],
                    next(iter(man.trainers.values())).lr_schedule(0))
        del man
    (g_card, l_card, lr), (g_cpu, l_cpu, _) = res["cuda"], res["cpu"]
    loss_err = max(abs(a - b) for a, b in zip(l_card, l_cpu))
    worst = 0.0
    for k, p in g_cpu.items():
        tol = 2 * lr + 1e-5 * max(1.0, float(p.abs().max()))
        err = float((g_card[k] - p).abs().max())
        worst = max(worst, err / tol)
    log(f"quality: federated FedAvg round card vs CPU (f32, 2 clients x 1 step on 2 graphs): "
        f"losses {l_card} vs {l_cpu} (max diff {loss_err:.3e} <= {QUALITY['loss_atol']}); "
        f"global parameters at {worst:.3f} of the 2 lr + 1e-5 max(1, |p|) bound (lr {lr:g})")
    if loss_err > QUALITY["loss_atol"] or worst > 1.0:
        raise AssertionError("federated: the card's round disagrees with the CPU's")
    return {"loss_card": l_card, "loss_cpu": l_cpu, "loss_max_diff": loss_err,
            "param_bound_share": worst, "lr": lr}


def federated_phase(torch, graphs, card: str) -> dict:
    """FederatedDGDMManager over two DGDM-Base clients of 16 graphs each
    (one batch a client, 2 local steps): 2 FedAvg rounds, then one round of
    FedProx, SCAFFOLD, the sqrt weighting and FedAvg with DP (clip 1.0,
    noise 0.01), each counted and each aggregate checked in f32 ulps; the
    clip and the noise's sigma; CUDA-event ms of a round against two Base
    steps; peak memory; the card against the CPU."""
    from dgdm_histopath_torch import batch_graphs
    from dgdm_histopath_torch.quantum import DPConfig, FederatedDGDMManager

    half = len(graphs) // 2
    loaders = {"site0": [batch_graphs(graphs[:half]).to("cuda")],
               "site1": [batch_graphs(graphs[half:]).to("cuda")]}
    trainers = [base_trainer(torch, loaders["site0"][0]) for _ in loaders]
    per_step = expected_launches(BASE, training=True)
    per_round = {k: 2 * QUALITY["fed_local_steps"] * v for k, v in per_step.items()}
    dp = DPConfig(QUALITY["dp_clip"], QUALITY["dp_noise"])
    plan = [("fedavg", None), ("fedavg", None), ("fedprox", None), ("scaffold", None),
            ("quantum_fed", None), ("fedavg", dp)]
    out = {"card": card, "rounds": []}
    man = None
    for i, (strategy, privacy) in enumerate(plan):
        if i != 1:                          # the second FedAvg round goes on with the first's
            if man is not None:             # a new server starts from the last global model
                with torch.no_grad():
                    for k, p in trainers[0].model.named_parameters():
                        p.copy_(man.global_params[k])
            pool = iter(trainers)
            man = FederatedDGDMManager(lambda: next(pool), loaders,
                                       local_steps=QUALITY["fed_local_steps"],
                                       strategy=strategy, dp=privacy, seed=0)
        factor = 1.0 / (1.0 + man.server.fedprox_mu) if strategy == "fedprox" else 1.0
        if i == 0:
            torch.cuda.reset_peak_memory_stats()
        res, launches = counted(torch, lambda: federated_round_check(torch, man, i, factor),
                                per_round, f"federated {strategy} round")
        row = {"strategy": strategy + ("+dp" if privacy else ""), "launches": launches,
               "event_ms": res["event_ms"], "max_ulps": res["max_ulps"],
               "update_norm": res["stats"]["update_norm"]}
        if i == 0:
            out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        if res["max_ulps"] > 1.0 or not res["stats"]["update_norm"] > 0:
            raise AssertionError(f"federated {row}")
        if privacy:
            row.update(federated_dp_check(torch, man, res))
        out["rounds"].append(row)
        log(f"quality: federated {row['strategy']} round: launches {launches}, "
            f"{row['event_ms']:.1f} ms (CUDA events), aggregate within {row['max_ulps']} f32 "
            f"ulps of the f64 mean, update norm {row['update_norm']:.4e} [{card}]")
    out["launches"] = out["rounds"][0]["launches"]

    # two Base steps at batch 32, on the same card, against a round
    batch = batch_graphs(graphs).to("cuda")
    trainer = trainers[0]
    trainer.training_step(batch, 0)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(2):
        trainer.training_step(batch, 0)
    end.record()
    end.synchronize()
    out["two_base_steps_ms"] = start.elapsed_time(end)
    log(f"quality: a FedAvg round {out['rounds'][1]['event_ms']:.1f} ms against two Base "
        f"steps at batch 32 {out['two_base_steps_ms']:.1f} ms (CUDA events); peak with two "
        f"Base trainers resident {out['peak_gib']:.2f} GiB [{card}]")
    del trainers, trainer, man, batch, loaders
    torch.cuda.empty_cache()
    out["card_vs_cpu"] = federated_card_vs_cpu(torch, graphs)
    return out


def federated_dp_check(torch, man, res) -> dict:
    """The DP round: each client's raw update (its live parameters minus the
    old global) clipped with noise 0 has a global norm within clip (1 +
    1e-6), and so has it under a clip of a quarter of its norm (one that
    binds: there it reaches the clip within 1e-5); the noise the round added
    has a standard deviation within 2% of sigma over every entry."""
    from dgdm_histopath_torch.quantum import DPConfig
    from dgdm_histopath_torch.quantum.federated_learning import tree_global_norm

    sigma = QUALITY["dp_noise"] * QUALITY["dp_clip"]
    norms, bound_share, stds = [], [], []
    for cid, trainer in man.trainers.items():
        raw = {k: p.detach() - res["old"][k] for k, p in trainer.model.named_parameters()}
        clipped = DPConfig(QUALITY["dp_clip"], 0.0).privatize(raw, None)
        norms.append((float(tree_global_norm(raw)), float(tree_global_norm(clipped))))
        tight = norms[-1][0] / 4
        bound_share.append(float(tree_global_norm(DPConfig(tight, 0.0).privatize(raw, None)))
                           / tight)
        resid = torch.cat([(res["updates"][cid][k] - clipped[k]).flatten() for k in clipped])
        stds.append(float(resid.double().std()))
    entries = sum(p.numel() for p in res["old"].values())
    log(f"quality: DP: (raw, clipped) norms {norms} (clip {QUALITY['dp_clip']}), under a "
        f"quarter-norm clip {bound_share} of it; noise std {stds} over {entries} entries a "
        f"client (sigma {sigma})")
    if (max(c for _, c in norms) > QUALITY["dp_clip"] * (1 + 1e-6)
            or not all(1 - 1e-5 <= b <= 1 + 1e-6 for b in bound_share)
            or max(abs(s / sigma - 1) for s in stds) > 0.02):
        raise AssertionError("federated DP: the clip or the noise is off")
    return {"norms_raw_clipped": norms, "tight_clip_share": bound_share, "noise_std": stds,
            "entries": entries}


def quality_phase(torch, graphs, card: str) -> dict:
    """Phase 20: the quality gates, ResilientTrainer and federated training."""
    t_phase = time.perf_counter()
    out = {"gates": quality_gates_phase(torch, card)}
    out["gates_s"] = time.perf_counter() - t_phase
    torch.cuda.empty_cache()
    out["resilient"] = resilient_phase(torch, graphs, card)
    out["resilient_s"] = time.perf_counter() - t_phase - out["gates_s"]
    out["federated"] = federated_phase(torch, graphs, card)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"quality: phase 20 took {out['phase_s']:.1f} s (gates {out['gates_s']:.1f}, "
        f"resilient {out['resilient_s']:.1f}) [{card}]")
    return out


# Phase 21: the last of item 14 (clinical/, the exported program, production,
# quantum/, enterprise/) on the Base cell's graphs and the slide cell's slide.
# The DICOM attributes carry PHI (a name, an MRN, a phone number, an e-mail
# address); the orchestration tasks and tenant jobs run batches of 8 graphs.
ORCH = dict(study_attrs={"SOPInstanceUID": "1.2.826.0.1.3680043.10.1", "Modality": "SM",
                         "StudyInstanceUID": "1.2.826.0.1.3680043.10.2",
                         "SeriesInstanceUID": "1.2.826.0.1.3680043.10.3",
                         "PatientName": "DOE^JANE", "PatientID": "MRN 1234567",
                         "PatientBirthDate": "19700101", "InstitutionName": "General Hospital",
                         "StudyDescription": "call 555-123-4567 or jane@example.com"},
            task_graphs=8, planner_tasks=6, trials=3, trial_steps=2, qubits=12,
            qubit_layers=2, hybrid=(768, 128, 2), hybrid_batch=32, export_reps=20,
            tenant_slides=12)


def orch_expected(forwards: int = 0, steps: int = 0) -> dict:
    """Launches of ``forwards`` DGDM-Base forwards and ``steps`` training steps."""
    fwd, step = expected_launches(BASE, training=False), expected_launches(BASE, training=True)
    return {k: forwards * fwd[k] + steps * step[k] for k in fwd}


def ehr_endpoint():
    """A local FHIR endpoint: an HTTP server on 127.0.0.1 that keeps each
    posted resource; returns (server, received list, transport callable)."""
    import http.server
    import threading

    received = []

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_POST(self):
            resource = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
            received.append(resource)
            body = json.dumps({"status": "created", "id": resource["id"]}).encode()
            self.send_response(201)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()

    def transport(resource):
        status, text = http_status(server.server_address[1], "POST", "/Observation", resource)
        if status != 201:
            raise AssertionError(f"the EHR endpoint answered {status}: {text[:500]}")
        return json.loads(text)
    return server, received, transport


def orch_clinical(torch, graphs, backend, predictor, card: str) -> dict:
    """``PACSEHRIntegrationManager.process_study`` on the slide, counted (one
    Base forward), its record equal to the bit to a direct ``predict_slide``;
    then a cohort of ``predict_batch`` over the 32 graphs with seeded labels
    through the analyzer and a dossier that must hold no PHI."""
    import tempfile

    import numpy as np
    from dgdm_histopath_torch.clinical import (
        ClinicalCohort, ClinicalDataManager, ClinicalPerformanceAnalyzer, EHRConnector,
        FDASubmissionManager, PACSEHRIntegrationManager,
    )
    from dgdm_histopath_torch.utils.security import PHIDetector

    attrs = ORCH["study_attrs"]
    server, received, transport = ehr_endpoint()
    try:
        manager = PACSEHRIntegrationManager(predictor, ehr=EHRConnector(transport),
                                            class_names=["benign", "tumor"])
        t0 = time.perf_counter()
        record, launches = counted(torch, lambda: manager.process_study(backend, attrs),
                                   orch_expected(forwards=1), "process_study")
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        again, _ = counted(torch, lambda: manager.process_study(backend, attrs),
                           orch_expected(forwards=1), "process_study (again)")
        again_s = time.perf_counter() - t0
    finally:
        server.shutdown()
        server.server_close()
    direct = predictor.predict_slide(backend, slide_id=attrs["SOPInstanceUID"])
    for r in (record, again):
        if (r["prediction"], r["confidence"]) != (direct["predicted_class"],
                                                  direct["confidence"]):
            raise AssertionError(f"process_study {r} differs from predict_slide "
                                 f"({direct['predicted_class']}, {direct['confidence']})")
    if {record["ehr_status"], again["ehr_status"]} != {"created"} or len(received) != 2:
        raise AssertionError(f"the EHR endpoint received {len(received)} observations")
    sent = json.dumps(received)
    for tag in ("PatientName", "PatientID", "PatientBirthDate", "InstitutionName"):
        if attrs[tag] in sent:
            raise AssertionError(f"{tag} reached the EHR")
    if PHIDetector.contains_phi(sent) or not manager.dicom.verify_anonymized(
            manager.dicom.anonymize(manager.dicom.extract_metadata(attrs))):
        raise AssertionError("PHI survived the anonymization")
    out = {"launches": launches, "record": record, "first_s": first_s, "again_s": again_s,
           "observation": received[0]["valueCodeableConcept"]["text"]}
    log(f"orchestration: process_study launches {launches}; class {record['prediction']} "
        f"confidence {record['confidence']:.6f} (equal to predict_slide), {first_s:.2f} s "
        f"first (a new predictor's first predict_slide), {again_s:.2f} s again; 2 "
        f"observations over HTTP, no PHI [{card}]")

    # the cohort: predict_batch on the 32 graphs, labels seeded
    results = predictor.predict_batch(graphs)
    labels = np.random.RandomState(0).randint(0, 2, len(graphs))
    probs = np.stack([r["probabilities"] for r in results])
    data = ClinicalDataManager()
    data.register_cohort(ClinicalCohort("base-32", site="chip",
                                        metadata={"note": "contact 555-123-4567"}))
    data.add_results("base-32", labels, probs.argmax(1), probs)
    report = ClinicalPerformanceAnalyzer().analyze_all(data)
    with tempfile.TemporaryDirectory() as root:
        path = FDASubmissionManager().export(
            FDASubmissionManager().build_dossier(report), f"{root}/dossier.json")
        text = path.read_text()
    if PHIDetector.contains_phi(text) or "555-123-4567" in text:
        raise AssertionError("the dossier holds PHI")
    cohort = report["cohorts"]["base-32"]
    if not (0.0 <= cohort["auc"] <= 1.0 and "auc_ci" in cohort):
        raise AssertionError(f"the cohort report is malformed: {cohort}")
    out["cohort"] = {k: cohort[k] for k in ("n", "sensitivity", "specificity", "auc",
                                            "meets_criteria")}
    out["dossier_bytes"] = len(text)
    log(f"orchestration: cohort of {len(graphs)} predict_batch results: AUC "
        f"{cohort['auc']:.3f} (random weights), dossier {len(text)} bytes, no PHI")
    return out


def orch_export(torch, graphs, model, card: str) -> dict:
    """``export_stablehlo`` of the DGDM-Base inference forward at batch 32,
    bucket 1024 (bf16): the saved program's size, its gather nodes, the
    loaded program on the card counted (9 / 18), its logits against the
    eager forward's, and both forwards' CUDA-event ms."""
    import tempfile
    from collections import Counter

    from dgdm_histopath_torch import batch_graphs
    from dgdm_histopath_torch.deployment import EdgeModelOptimizer

    batch = batch_graphs(graphs).to("cuda")
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        path = EdgeModelOptimizer.export_stablehlo(model, (batch,), f"{root}/dgdm_base.pt2")
        export_s = time.perf_counter() - t0
        size_mb = path.stat().st_size / 1e6
        t0 = time.perf_counter()
        program = torch.export.load(path)
        loaded = program.module()
        load_s = time.perf_counter() - t0
    nodes = Counter(str(n.target) for n in program.graph.nodes if n.op == "call_function")
    ops = {"gather_rows": nodes["dgdm.gather_rows.default"],
           "weighted_gather_sum": nodes["dgdm.weighted_gather_sum.default"]}
    if ops != {"gather_rows": BASE["layers"], "weighted_gather_sum": 2 * BASE["layers"]}:
        raise AssertionError(f"the exported program holds {ops}")
    with torch.no_grad():
        got, launches = counted(torch, lambda: loaded(batch), orch_expected(forwards=1),
                                "the loaded program")
        want = model(batch)
        eager_ms, _ = event_ms(torch, lambda: model(batch), ORCH["export_reps"])
        loaded_ms, _ = event_ms(torch, lambda: loaded(batch), ORCH["export_reps"])
    a, b = got["classification_logits"].float(), want["classification_logits"].float()
    gap = (a - b).abs().max().item()
    equal = all(torch.equal(got[k], want[k]) for k in want)
    largest = b.abs().max().item()
    log(f"orchestration: export_stablehlo of DGDM-Base (batch 32, bucket 1024, bf16) in "
        f"{export_s:.1f} s, {size_mb:.1f} MB, loaded in {load_s:.1f} s; nodes {ops}; launches "
        f"{launches}; outputs {'equal to the bit' if equal else 'differ'} (logits gap "
        f"{gap:.3e} of largest {largest:.3e}); forward {loaded_ms:.3f} ms loaded against "
        f"{eager_ms:.3f} ms eager [{card}]")
    if not equal and gap > 1e-3 * largest:
        raise AssertionError(f"the loaded program's logits differ by {gap}")
    return {"export_s": export_s, "size_mb": size_mb, "load_s": load_s, "nodes": ops,
            "launches": launches, "bit_equal": equal, "logits_gap": gap,
            "loaded_ms": loaded_ms, "eager_ms": eager_ms, "card": card}


def orch_production(torch, graphs, card: str) -> dict:
    """``ProductionOrchestrator``: load a Base bundle, check health, a
    ``predict_batch`` equal to the model's forward, then a failing stage;
    the rollbacks run in reverse; the manifests ask for the GPU."""
    import tempfile

    import numpy as np
    import yaml
    from dgdm_histopath_torch import DGDMPredictor, batch_graphs, create_model
    from dgdm_histopath_torch.deployment import (
        KubernetesOrchestrator, ProductionHealthChecker, ProductionOrchestrator,
    )
    from dgdm_histopath_torch.evaluation.predictor import load_model_checkpoint
    from dgdm_histopath_torch.models.presets import PRESETS
    from dgdm_histopath_torch.training.checkpoint import save_model_bundle

    state, order = {}, []
    with tempfile.TemporaryDirectory() as root:
        model = create_model("dgdm-base", num_classes=2, compute_dtype="bfloat16",
                             device="cuda", seed=3)
        bundle = save_model_bundle(f"{root}/final_model.npz", model,
                                   dict(PRESETS["dgdm-base"], num_classes=2,
                                        compute_dtype="bfloat16"))
        del model

        def load():
            state["model"], _ = load_model_checkpoint(bundle, device="cuda")
            state["predictor"] = DGDMPredictor(model=state["model"], device="cuda")
            order.append("load")
            return True

        def health():
            report = ProductionHealthChecker(state["predictor"]).check()
            order.append("health")
            state["health"] = report["checks"]
            return report["healthy"]

        def predict():
            g8 = graphs[:ORCH["task_graphs"]]
            res, state["launches"] = counted(torch, lambda: state["predictor"].predict_batch(g8),
                                             orch_expected(forwards=1), "stage predict")
            with torch.no_grad():
                logits = state["model"](batch_graphs(g8).to("cuda"))["classification_logits"]
            probs = torch.softmax(logits.float(), -1).cpu().numpy()
            order.append("predict")
            return np.allclose(np.stack([r["probabilities"] for r in res]), probs, rtol=0,
                               atol=1e-6)

        def fail():
            order.append("promote")
            raise RuntimeError("the promotion is refused on purpose")

        orch = ProductionOrchestrator()
        orch.add_stage("load", load, rollback=lambda: order.append("undo load"))
        orch.add_stage("health", health, rollback=lambda: order.append("undo health"))
        orch.add_stage("predict", predict, rollback=lambda: order.append("undo predict"))
        orch.add_stage("promote", fail)
        result = orch.deploy_to_production()
        manifests = KubernetesOrchestrator().write_manifests(f"{root}/k8s")
        deployment = yaml.safe_load(manifests[0].read_text())
    want = ["load", "health", "predict", "promote", "undo predict", "undo health", "undo load"]
    if result["success"] or result["failed_stage"] != "promote" or order != want:
        raise AssertionError(f"the staged deploy ran {order}: {result}")
    if [e["ok"] for e in result["log"]] != [True, True, True, False]:
        raise AssertionError(f"a stage failed: {result['log']}")
    resources = deployment["spec"]["template"]["spec"]["containers"][0]["resources"]
    if resources["requests"].get("nvidia.com/gpu") != 1 or resources["limits"].get(
            "nvidia.com/gpu") != 1:
        raise AssertionError(f"the deployment asks for {resources}")
    log(f"orchestration: staged deploy {order}; health {state['health']}; the deployment "
        f"manifest asks for nvidia.com/gpu: 1")
    return {"order": order, "log": result["log"], "launches": state["launches"],
            "health": state["health"]}


def orch_trial_objective(torch, graphs, trial_launches: list):
    """The objective of ``QuantumOptimizer`` over ``dgdm_search_space``: a
    768-d DGDM built from the trial's configuration, trained
    ``trial_steps`` steps on 8 graphs (each step counted); its last loss."""
    from dgdm_histopath_torch import DGDMTrainer, DGDMModel, TrainerConfig, batch_graphs
    from dgdm_histopath_torch.nn.layers import init_parameters

    batch = batch_graphs(graphs[:ORCH["task_graphs"]])

    def objective(cfg):
        model = init_parameters(
            DGDMModel(node_features=BASE["features"], hidden_dims=cfg["hidden_dims"],
                      num_diffusion_steps=cfg["num_diffusion_steps"], dropout=cfg["dropout"],
                      pooling=cfg["pooling"], num_classes=2, compute_dtype="bfloat16"),
            torch.Generator().manual_seed(0)).to("cuda")
        trainer = DGDMTrainer(model, TrainerConfig(
            learning_rate=cfg["learning_rate"], weight_decay=cfg["weight_decay"],
            masking_ratio=cfg["masking_ratio"],
            contrastive_temperature=cfg["contrastive_temperature"], warmup_steps=1,
            steps_per_epoch=ORCH["trial_steps"], pretrain_epochs=1, max_epochs=1),
            device="cuda")
        trainer.init_state(seed=0, example_batch=batch)
        for _ in range(ORCH["trial_steps"]):
            metrics, launches = counted(torch, lambda: trainer.training_step(batch, epoch=0),
                                        orch_expected(steps=1), "an optimizer trial's step")
            trial_launches.append(launches)
        return float(metrics["loss"])
    return objective


def orch_quantum(torch, graphs, predictor, card: str) -> dict:
    """The planner (6 dependent tasks of DGDM-Base work, counted), the
    scheduler's device memory and gating, the guarded scheduler, task
    placement by capability, the hyperparameter search over DGDM training,
    the statevector on the card against the CPU and the hybrid layer."""
    import numpy as np
    from dgdm_histopath_torch import batch_graphs
    from dgdm_histopath_torch.nn.layers import init_parameters
    from dgdm_histopath_torch.quantum import (
        Circuit, HybridQuantumClassicalLayer, LocalStatevectorBackend, QuantumConfig,
        QuantumDistributedManager, QuantumOptimizer, QuantumSafetyManager, QuantumScheduler,
        QuantumTaskPlanner, SafeScheduler, TaskStatus, dgdm_search_space, read_resources,
    )
    from dgdm_histopath_torch.utils.exceptions import SecurityError

    out = {}
    g8 = graphs[:ORCH["task_graphs"]]
    batch8 = batch_graphs(g8).to("cuda")
    trainer = base_trainer(torch, batch8)

    # the planner: a chain of predict_batch and training-step tasks
    planner = QuantumTaskPlanner(max_workers=2, seed=0)
    prev, kinds = [], []
    for i in range(ORCH["planner_tasks"]):
        train = i % 3 == 1
        fn = ((lambda: trainer.training_step(batch8, epoch=0)) if train
              else (lambda: predictor.predict_batch(g8)))
        prev = [planner.add_task(f"task{i}", fn=fn, dependencies=prev, task_id=f"task{i}",
                                 priority="HIGH" if train else "MEDIUM")]
        kinds.append("step" if train else "predict")
    steps = kinds.count("step")
    t0 = time.perf_counter()
    tasks, launches = counted(torch, lambda: planner.execute(timeout=600),
                              orch_expected(forwards=len(kinds) - steps, steps=steps),
                              "the planner's tasks")
    if any(t.status != TaskStatus.COMPLETED for t in tasks.values()):
        raise AssertionError(f"planner tasks: {[(t.name, t.status, t.error) for t in tasks.values()]}")
    out["planner"] = {"kinds": kinds, "launches": launches, "s": time.perf_counter() - t0}
    log(f"orchestration: planner ran {kinds} in dependency order, launches {launches}, "
        f"{out['planner']['s']:.2f} s")

    # the scheduler: device memory as the allocator counts it, and the gate
    block = torch.empty(2 ** 30, dtype=torch.uint8, device="cuda")
    snap = read_resources()
    allocated = torch.cuda.memory_allocated() / 1e6
    del block
    if abs(snap.device_mem_used_mb - allocated) > 1.0 or snap.device_mem_total_mb < 1e4:
        raise AssertionError(f"read_resources reports {snap.device_mem_used_mb} MB in use, "
                             f"the allocator {allocated} MB")
    sched = QuantumScheduler(max_workers=1, strategy="resource_aware")
    ran = []
    fits = sched.submit("fits", lambda: ran.append("fits") or len(predictor.predict_batch(g8)))
    huge = sched.submit("huge", lambda: ran.append("huge"),
                        min_free_mem_mb=2 * snap.device_mem_total_mb)
    jobs = sched.run_pending()
    if jobs[huge].status != "deferred" or jobs[fits].result != len(g8) or ran != ["fits"]:
        raise AssertionError(f"scheduler: {[(j.name, j.status) for j in jobs.values()]}")
    out["scheduler"] = {"device_mem_used_mb": snap.device_mem_used_mb,
                        "allocated_mb": allocated, "device_mem_total_mb":
                            snap.device_mem_total_mb}
    log(f"orchestration: read_resources {snap.device_mem_used_mb:.1f} MB in use of "
        f"{snap.device_mem_total_mb:.0f} (allocator {allocated:.1f} MB); a job asking for "
        f"twice the card's memory deferred")

    # the guarded scheduler
    safety = QuantumSafetyManager()
    safety.register_user("pathologist", "a-long-password")
    token = safety.authenticate("pathologist", "a-long-password")
    safe = SafeScheduler(QuantumScheduler(max_workers=1), safety)
    jid = safe.submit(token, "predict", lambda: len(predictor.predict_batch(g8)))
    if safe.run_pending(token)[jid].result != len(g8):
        raise AssertionError("the authorized job did not run")
    try:
        safe.submit(token + "forged", "predict", lambda: None)
    except SecurityError:
        pass
    else:
        raise AssertionError("an unauthorized token was accepted")

    # placement by capability
    with QuantumDistributedManager(num_workers=2, heartbeat_interval_s=60) as man:
        caps = man.local_node.capabilities
        tid = man.submit_task(lambda: len(predictor.predict_batch(g8)),
                              required_capabilities=["cuda"])
        placed = man.get_result(tid, timeout=300)
        try:
            man.submit_task(lambda: None, required_capabilities=["tpu"])
        except RuntimeError:
            pass
        else:
            raise AssertionError("a tpu task was placed")
    if caps != ["cpu", "cuda"] or placed != len(g8):
        raise AssertionError(f"capabilities {caps}, placed result {placed}")
    log(f"orchestration: SafeScheduler ran the authorized job and refused a forged token; "
        f"the local node reports {caps}, placed a cuda task, refused a tpu task")

    # the hyperparameter search over DGDM training
    trial_launches = []
    t0 = time.perf_counter()
    opt = QuantumOptimizer(dgdm_search_space(), orch_trial_objective(torch, graphs,
                                                                    trial_launches),
                           population=ORCH["trials"], seed=0)
    best_cfg, best = opt.optimize(n_trials=ORCH["trials"])
    if not (np.isfinite(best) and len(trial_launches) == ORCH["trials"] * ORCH["trial_steps"]
            and all(np.isfinite(t.value) for t in opt.history)):
        raise AssertionError(f"optimizer trials: {[(t.config, t.value) for t in opt.history]}")
    out["optimizer"] = {"trials": [{"hidden_dims": t.config["hidden_dims"],
                                    "pooling": t.config["pooling"], "loss": t.value,
                                    "s": t.duration_s} for t in opt.history],
                        "step_launches": trial_launches[0], "s": time.perf_counter() - t0}
    log(f"orchestration: QuantumOptimizer {ORCH['trials']} trials of "
        f"{ORCH['trial_steps']} DGDM training steps: " + ", ".join(
            f"{t.config['hidden_dims']} {t.config['pooling']} loss {t.value:.4f} "
            f"({t.duration_s:.1f} s)" for t in opt.history)
        + f"; each step {trial_launches[0]}")

    # the statevector on the card against the CPU
    rs = np.random.RandomState(0)
    circ = Circuit(rs.uniform(0, 2 * np.pi, (ORCH["qubit_layers"], ORCH["qubits"]))
                   .astype(np.float32))
    on_card = LocalStatevectorBackend()
    on_card.initialize(QuantumConfig(seed=0))
    p_card = on_card.probabilities(circ)
    p_cpu = LocalStatevectorBackend(device="cpu").probabilities(circ)
    sv_err = float(np.abs(p_card - p_cpu).max())
    counts = on_card.execute_circuit(circ, shots=4096)["counts"]
    if sv_err > 1e-6 or sum(counts.values()) != 4096:
        raise AssertionError(f"statevector card vs CPU {sv_err}")

    # the hybrid layer, f32, card against CPU
    layer_cpu = init_parameters(HybridQuantumClassicalLayer(*ORCH["hybrid"]),
                                torch.Generator().manual_seed(0))
    layer = copy.deepcopy(layer_cpu).to("cuda")
    x_cpu = torch.from_numpy(rs.randn(ORCH["hybrid_batch"], ORCH["hybrid"][0])
                             .astype(np.float32)).requires_grad_(True)
    x = x_cpu.detach().to("cuda").requires_grad_(True)
    for m, inp in ((layer_cpu, x_cpu), (layer, x)):
        (m(inp) ** 2).sum().backward()
    y_err = (layer(x).detach().cpu() - layer_cpu(x_cpu).detach()).abs().max().item()
    g_err = (x.grad.cpu() - x_cpu.grad).abs().max().item()
    if y_err > 1e-5 or g_err > 1e-4:
        raise AssertionError(f"hybrid layer card vs CPU: out {y_err}, grad {g_err}")
    fwd_ms, _ = event_ms(torch, lambda: layer(x), 20)
    bwd_ms, _ = event_ms(torch, lambda: (layer(x) ** 2).sum().backward(), 20)
    out["quantum"] = {"statevector_err": sv_err, "hybrid_out_err": y_err,
                      "hybrid_grad_err": g_err, "hybrid_forward_ms": fwd_ms,
                      "hybrid_forward_backward_ms": bwd_ms, "card": card}
    log(f"orchestration: statevector {ORCH['qubits']} qubits x {ORCH['qubit_layers']} "
        f"layers card vs CPU {sv_err:.2e}; HybridQuantumClassicalLayer{ORCH['hybrid']} f32 "
        f"batch {ORCH['hybrid_batch']}: out {y_err:.2e}, input grad {g_err:.2e} against the "
        f"CPU, forward {fwd_ms:.3f} ms, forward + backward {bwd_ms:.3f} ms [{card}]")
    return out


def orch_enterprise(torch, graphs, predictor) -> dict:
    """Two tenants' ``run_job``s, each a ``predict_batch`` of 8 graphs
    (counted) charged to the daily slide quota; a job past the concurrent
    slot or the daily quota raises ``ResourceError``."""
    import tempfile

    from dgdm_histopath_torch.enterprise import MultiTenantManager, TenantQuota
    from dgdm_histopath_torch.utils.exceptions import ResourceError

    g8 = graphs[:ORCH["task_graphs"]]
    out = {}
    with tempfile.TemporaryDirectory() as root:
        man = MultiTenantManager(root)
        quota = TenantQuota(max_slides_per_day=ORCH["tenant_slides"], max_concurrent_jobs=1)
        tenants = [man.create_tenant(name, quota) for name in ("hospital", "lab")]
        keys = [man.auth.issue_key(t.tenant_id) for t in tenants]

        def job(tenant):
            man.resources.charge_slide(tenant, len(g8))
            return predictor.predict_batch(g8)
        for t, key in zip(tenants, keys):
            res, out[t.name] = counted(torch, lambda: man.run_job(key, job, t),
                                       orch_expected(forwards=1), f"{t.name}'s job")
            if len(res) != len(g8):
                raise AssertionError(f"{t.name}'s job answered {len(res)} graphs")
        refused = []
        for what, call in (
                ("daily quota", lambda: man.run_job(keys[0], job, tenants[0])),
                ("concurrent slot", lambda: man.run_job(
                    keys[1], lambda: man.run_job(keys[1], lambda: None)))):
            try:
                call()
            except ResourceError:
                refused.append(what)
        if refused != ["daily quota", "concurrent slot"]:
            raise AssertionError(f"quota refusals: {refused}")
    log(f"orchestration: two tenants' jobs launches {out['hospital']} / {out['lab']}; the "
        f"daily quota and the concurrent slot refused a job each")
    return {"launches": out, "refused": refused}


def orchestration_phase(torch, graphs, card: str, backend=None) -> dict:
    """Phase 21: clinical/, the exported program, production, quantum/ and
    enterprise/ on DGDM-Base (bf16) and the slide cell's slide."""
    from dgdm_histopath_torch import DGDMPredictor, create_model

    t_phase = time.perf_counter()
    if backend is None:
        backend, _ = slide_fixture()
    model = create_model("dgdm-base", num_classes=2, compute_dtype="bfloat16",
                         device="cuda", seed=0)
    predictor = DGDMPredictor(model=model, feature_extractor="dinov2", stain_normalize=True)
    try:
        out = {"clinical": orch_clinical(torch, graphs, backend, predictor, card)}
        out["export"] = orch_export(torch, graphs, model, card)
        torch.cuda.empty_cache()
        out["production"] = orch_production(torch, graphs, card)
        torch.cuda.empty_cache()
        out.update(orch_quantum(torch, graphs, predictor, card))
        torch.cuda.empty_cache()
        out["enterprise"] = orch_enterprise(torch, graphs, predictor)
    finally:
        predictor.close()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"orchestration: phase 21 took {out['phase_s']:.1f} s [{card}]")
    return out


# Phase 22, the staged accuracy gates. The calibrated c16 hard recipe's
# training flags (docs/results/c16_hard/README.md); each run adds its
# featurizer, its arms and its seeds.
GATE_C16_DIR = os.path.join("docs", "results", "c16_hard")
GATE_C16_RECIPE = ["--synthetic", "--hard", "--n-train-per-class", "48",
                   "--n-test-per-class", "64", "--selection", "final", "--hidden", "256,128,64",
                   "--dropout", "0.2", "--lr", "1e-3", "--weight-decay", "1e-3",
                   "--finetune-lr-factor", "1.0", "--batch-size", "4", "--seed", "0"]
GATE_EPOCHS = (4, 40)           # the recipe's pretrain and finetune epochs: --gates-only
# phase 22's cut (PERF.md §4): the whole run's arm-seed trains 1 + 1 epochs
# (a recipe arm-seed of 4 + 40 takes 67-84 s of fit on an H100, up to ~2x on
# a slow host), the 4-class loop renders 512 px slides (1024 in the test it
# mirrors)
GATE_PHASE_EPOCHS = (1, 1)
GATE_TCGA_SLIDE = 512
# --gates-only: the train seeds of both arms, 0-4 of the JAX package's 0-9
# (an arm-seed takes 67-84 s of fit on an H100: 20 would pass 1000 s)
GATE_SEEDS = tuple(range(5))
GATE_KERNELS = ("gather_agg", "gather_rows", "gather_rows_bwd", "gather_agg_bwd",
                "neighbor_transpose")
# the keys the JAX package's harness writes into a one-arm report with the int8 rider
GATE_REPORT_KEYS = {
    "dataset", "config", "hidden_dims", "per_slide_norm", "selection", "seed", "train_seed",
    "extractor", "vit_weights", "backbone_pretrained", "n_train", "n_test", "bucket",
    "max_patches", "auc", "f1", "auc_ci95", "accuracy", "auc_int8", "int8_auc_delta",
    "reference_target", "auc_delta_vs_reference", "parity_valid", "preprocess_s_per_slide",
    "best_val_loss", "wall_s", "device", "real_nodes", "int8_auc_delta_ci95"}


def gate_epochs(epochs) -> list:
    return ["--pretrain-epochs", str(epochs[0]), "--finetune-epochs", str(epochs[1])]


def gate_copy(root: str, cache: bool) -> str:
    """A copy of the committed c16 hard gate's manifest (and graph cache)
    under ``root``: the gate's ``--out``."""
    import shutil
    out = os.path.join(root, "c16")
    shutil.copytree(os.path.join(GATE_C16_DIR, "synthetic_data"),
                    os.path.join(out, "synthetic_data"))
    if cache:
        shutil.copytree(os.path.join(GATE_C16_DIR, "graph_cache"),
                        os.path.join(out, "graph_cache"))
    return out


class FitClock:
    """Wall seconds and steps of every ``DGDMTrainer.fit`` inside the block
    (the fit's own history counts its steps)."""

    def __init__(self, torch):
        self.torch, self.fits = torch, []

    def __enter__(self):
        from dgdm_histopath_torch.training import trainer
        self.cls, self.orig = trainer.DGDMTrainer, trainer.DGDMTrainer.fit
        clock = self

        def fit(trainer_self, *args, **kwargs):
            t0 = time.perf_counter()
            res = clock.orig(trainer_self, *args, **kwargs)
            clock.torch.cuda.synchronize()
            clock.fits.append({"s": time.perf_counter() - t0,
                               "steps": sum(h["steps"] for h in res["history"])})
            return res
        self.cls.fit = fit
        return self

    def __exit__(self, *exc):
        self.cls.fit = self.orig


def gate_arm_file(path: str) -> dict:
    import numpy as np
    with np.load(path, allow_pickle=True) as z:
        files = sorted(z.files)
        metrics = json.loads(str(z["metrics"]))
        shape = list(z["probs"].shape)
    if files != ["labels", "metrics", "probs", "probs_int8"]:
        raise AssertionError(f"{path}: arrays {files}")
    if metrics["_arm_config"].get("backend") != "torch":
        raise AssertionError(f"{path}: fingerprint {metrics['_arm_config']}")
    return {"arrays": files, "probs_shape": shape}


def gates_c16_arm(torch, root: str, card: str) -> dict:
    """(a) The c16 hard gate's dense arm, train seed 0, with the int8 rider,
    on the committed graph cache: no miss, JAX's keys, finite AUCs, the five
    kernels of training and prediction launched."""
    from dgdm_histopath_torch.ops import kernels
    from dgdm_histopath_torch.scripts import eval_camelyon16
    out = gate_copy(root, cache=True)
    cache = os.path.join(out, "graph_cache")
    before = sorted(os.listdir(cache))
    argv = [*GATE_C16_RECIPE, *gate_epochs(GATE_PHASE_EPOCHS),
            "--extractor", "simple_cnn+stats", "--ab-int8", "--train-seed", "0", "--out", out]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with FitClock(torch) as clock:
        report = eval_camelyon16.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    if report["graph_cache_misses"] != 0 or sorted(os.listdir(cache)) != before:
        raise AssertionError(f"c16 gate: {report['graph_cache_misses']} graph-cache misses")
    saved = json.loads(open(os.path.join(out, "report.json")).read())
    if not GATE_REPORT_KEYS <= set(saved):
        raise AssertionError(f"c16 gate report lacks {sorted(GATE_REPORT_KEYS - set(saved))}")
    arm = gate_arm_file(os.path.join(out, "variant_dense_s0.npz"))
    if not (math.isfinite(report["auc"]) and math.isfinite(report["int8_auc_delta"])):
        raise AssertionError(f"c16 gate: auc {report['auc']}, int8 delta "
                             f"{report['int8_auc_delta']}")
    missing = [k for k in GATE_KERNELS if launches[k] < 1]
    if missing:
        raise AssertionError(f"c16 gate: {missing} launched no time ({launches})")
    fit = clock.fits[0]
    expected = math.ceil((96 - 96 // 5) / 4) * sum(GATE_PHASE_EPOCHS)
    if fit["steps"] != expected:
        raise AssertionError(f"c16 gate: {fit['steps']} steps, expected {expected}")
    jax_auc = json.loads(open(os.path.join(GATE_C16_DIR, "report_pooled.json")).read())[
        "arms"]["dense"]["auc_by_seed"]["0"]
    res = {"card": card, "wall_s": wall, "fit_s": fit["s"], "steps": fit["steps"],
           "steps_per_s": fit["steps"] / fit["s"], "auc": report["auc"],
           "auc_ci95": report["auc_ci95"], "auc_int8": report["auc_int8"],
           "int8_auc_delta": report["int8_auc_delta"], "jax_seed0_auc": jax_auc,
           "cache_misses": report["graph_cache_misses"], "launches": launches, "arm": arm,
           "epochs": GATE_PHASE_EPOCHS, "extractor": "simple_cnn+stats"}
    log(f"gates: c16 dense arm t0 ({report['n_train']} train / {report['n_test']} test, "
        f"{GATE_PHASE_EPOCHS[0]} + {GATE_PHASE_EPOCHS[1]} epochs, simple_cnn+stats "
        f"graphs of the committed cache, 0 misses): AUC {report['auc']:.4f} "
        f"{report['auc_ci95']}, int8 delta {report['int8_auc_delta']}; JAX seed 0 "
        f"(stats + per-slide norm graphs) {jax_auc}; {fit['steps']} steps in "
        f"{fit['s']:.2f} s of fit ({res['steps_per_s']:.1f} steps/s), {wall:.2f} s of arm; "
        f"launches {launches} [{card}]")
    return res


def gates_tcga_loop(torch, root: str) -> dict:
    """(b) The tiny 4-class hard loop (two train seeds, the int8 rider)."""
    import numpy as np

    from dgdm_histopath_torch.ops import kernels
    from dgdm_histopath_torch.scripts import eval_tcga
    out = os.path.join(root, "tcga")
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    report = eval_tcga.main([
        "--synthetic", "--hard", "--out", out, "--slide-size", str(GATE_TCGA_SLIDE),
        "--n-train-per-class", "4",
        "--n-test-per-class", "3", "--patch-size", "32", "--bucket", "64", "--max-patches",
        "64", "--hidden", "32,16", "--pretrain-epochs", "1", "--finetune-epochs", "2",
        "--batch-size", "2", "--train-seed", "0,1", "--ab-int8"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    pooled = json.loads(open(os.path.join(out, "report_pooled.json")).read())
    with np.load(os.path.join(out, "variant_dense_s0.npz"), allow_pickle=True) as z:
        shape = z["probs"].shape
    if (pooled["auc_metric"] != "macro_ovr" or pooled["arms"]["dense"]["train_seeds"] != [0, 1]
            or pooled["int8_auc_delta"]["train_seeds"] != [0, 1] or shape != (12, 4)
            or report["subtypes"] != ["LumA", "LumB", "Her2", "Basal"]):
        raise AssertionError(f"tcga loop: pooled {pooled['auc_metric']}, probs {shape}")
    log(f"gates: tcga 4-class loop, 2 train seeds: macro OVR AUC by seed "
        f"{pooled['arms']['dense']['auc_by_seed']}, {wall:.1f} s, launches {launches}")
    return {"wall_s": wall, "auc_by_seed": pooled["arms"]["dense"]["auc_by_seed"],
            "auc_metric": pooled["auc_metric"], "launches": launches}


def gates_convert(torch, root: str, card: str) -> dict:
    """(c) timm DINOv2 weights (random, at the dinov2_b14 geometry: 518 px,
    a 37 x 37 grid) through the converter into an f32 extractor; 32
    patches' features against the timm forward of the state dict."""
    import numpy as np

    from dgdm_histopath_torch.models.vit import IMAGENET_MEAN, IMAGENET_STD
    from dgdm_histopath_torch.models.vit import PatchFeatureExtractor
    from dgdm_histopath_torch.scripts import convert_timm_vit as conv
    dim, depth, heads, patch, grid = 768, 12, 12, 14, 37
    g = torch.Generator().manual_seed(0)
    r = lambda *shape: torch.randn(*shape, generator=g) * 0.02  # noqa: E731
    sd = {"cls_token": r(1, 1, dim), "pos_embed": r(1, grid * grid + 1, dim),
          "patch_embed.proj.weight": r(dim, 3, patch, patch), "patch_embed.proj.bias": r(dim),
          "norm.weight": 1 + r(dim), "norm.bias": r(dim)}
    for i in range(depth):
        p = f"blocks.{i}."
        sd.update({p + "norm1.weight": 1 + r(dim), p + "norm1.bias": r(dim),
                   p + "attn.qkv.weight": r(3 * dim, dim), p + "attn.qkv.bias": r(3 * dim),
                   p + "attn.proj.weight": r(dim, dim), p + "attn.proj.bias": r(dim),
                   p + "ls1.gamma": 0.1 + r(dim).abs(), p + "norm2.weight": 1 + r(dim),
                   p + "norm2.bias": r(dim), p + "mlp.fc1.weight": r(4 * dim, dim),
                   p + "mlp.fc1.bias": r(4 * dim), p + "mlp.fc2.weight": r(dim, 4 * dim),
                   p + "mlp.fc2.bias": r(dim), p + "ls2.gamma": 0.1 + r(dim).abs()})
    src, bundle = os.path.join(root, "dinov2_b14.pth"), os.path.join(root, "dinov2_b14.npz")
    torch.save(sd, src)
    t0 = time.perf_counter()
    if conv.main([src, bundle, "--arch", "dinov2_b14", "--image-size", "224"]) != 0:
        raise AssertionError("convert_timm_vit failed")
    convert_s = time.perf_counter() - t0
    ext = PatchFeatureExtractor(arch="dinov2_b14", dtype="float32")
    ext.load_npz_weights(bundle)
    patches = np.random.RandomState(0).randint(0, 256, (32, 224, 224, 3), np.uint8)
    feats = ext.extract(patches)
    with np.load(bundle) as z:
        pos = z["p:params/pos_embed"]
    tsd = {k: v.cuda() for k, v in sd.items()}
    tsd["pos_embed"] = torch.as_tensor(pos, device="cuda")
    x = torch.as_tensor((patches / 255.0 - IMAGENET_MEAN) / IMAGENET_STD,
                        dtype=torch.float32, device="cuda")
    with torch.no_grad():
        ref = conv.timm_vit_forward(tsd, x, depth, heads, patch).cpu().numpy()
    err = float(np.abs(feats - ref).max())
    if feats.shape != (32, dim) or not err <= conv.CHECK_ATOL:
        raise AssertionError(f"converted dinov2_b14: features {feats.shape}, max |err| {err}")
    log(f"gates: convert_timm_vit dinov2_b14 (37 x 37 -> 16 x 16 grid) in {convert_s:.1f} s; "
        f"32 patches' f32 features against the timm forward: max |err| {err:.3g} "
        f"(<= {conv.CHECK_ATOL}) [{card}]")
    return {"convert_s": convert_s, "max_abs_err": err, "atol": conv.CHECK_ATOL,
            "tensors": len(sd)}


def gates_phase(torch, card: str) -> dict:
    """Phase 22: the staged accuracy gates on the card."""
    import tempfile

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        out = {"c16": gates_c16_arm(torch, root, card)}
        torch.cuda.empty_cache()
        out["tcga"] = gates_tcga_loop(torch, root)
        torch.cuda.empty_cache()
        out["convert"] = gates_convert(torch, root, card)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"gates: phase 22 took {out['phase_s']:.1f} s [{card}]")
    return out


def pooled_auc_ci(labels, probs_by_seed, n_bootstrap: int = 2000, seed: int = 0) -> list:
    """Two-level percentile-bootstrap 95% CI of the mean AUC over seeds: each
    draw resamples the seeds and, shared by them, the test slides."""
    import numpy as np

    from dgdm_histopath_torch.evaluation.metrics import _roc_auc
    rs = np.random.RandomState(seed)
    n, k = len(labels), len(probs_by_seed)
    vals = []
    for _ in range(n_bootstrap):
        seeds, idx = rs.randint(0, k, k), rs.randint(0, n, n)
        v = float(np.mean([_roc_auc(labels[idx], probs_by_seed[s][idx]) for s in seeds]))
        if math.isfinite(v):
            vals.append(v)
    return [float(x) for x in np.percentile(vals, [2.5, 97.5])]


def arm_probs(folder: str, tag: str, seeds) -> tuple:
    import numpy as np
    probs, labels = [], None
    for s in seeds:
        name = f"variant_{tag}_s0.npz" if s == 0 else f"variant_{tag}_s0t{s}.npz"
        with np.load(os.path.join(folder, name), allow_pickle=True) as z:
            probs.append(np.asarray(z["probs"], np.float64))
            labels = np.asarray(z["labels"])
    return labels, probs


def gate_graphs_vs_committed(out: str) -> dict:
    """The port's stats + per-slide-norm graphs against the committed
    ``simple_cnn+stats`` graphs of the same slides (JAX's preprocessing): the
    node masks and positions, and the stats features after the same
    per-slide norm."""
    import numpy as np
    cache, ref_cache = os.path.join(out, "graph_cache"), os.path.join(GATE_C16_DIR,
                                                                      "graph_cache")
    masks_equal, pos_err, n, diffs = 0, 0.0, 0, [np.zeros((0, 14))]
    for name in sorted(os.listdir(ref_cache)):
        if not name.endswith("_b256_simple_cnn-stats.npz"):
            continue
        stem = name[: -len("_b256_simple_cnn-stats.npz")]
        with np.load(os.path.join(ref_cache, name)) as a, \
                np.load(os.path.join(cache, f"{stem}_b256_stats_psn.npz")) as b:
            n += 1
            if not np.array_equal(a["node_mask"], b["node_mask"]):
                continue
            masks_equal += 1
            m = a["node_mask"]
            pos_err = max(pos_err, float(np.abs(a["pos"][m] - b["pos"][m]).max()))
            st = a["x"][m][:, -14:]
            st = (st - np.median(st, 0)) / (st.std(0) + 1e-6)
            diffs.append(np.abs(st - b["x"][m]))
    diffs = np.concatenate(diffs)
    return {"slides": n, "node_masks_equal": masks_equal, "pos_max_abs_err": pos_err,
            "features_max_abs_err": float(diffs.max()),
            "features_median_abs_err": float(np.median(diffs)),
            "features_within_1e-3": float((diffs <= 1e-3).mean()),
            "feature_max_abs_err_by_column": [round(float(v), 6) for v in diffs.max(0)]}


def gate_render_timing(out: str, card: str) -> dict:
    """The c16 hard set's slides (224 of 1024², the committed manifest's
    seed) rendered on the host into ``out``'s ``synthetic_data``, where the
    gate then finds them: 8 in this process (seconds a pixel), one in a
    spawned worker of its own (its start-up: that call's wall less this
    process's time for the slide's pixels), the other 215 through
    ``render_slides``'s rule. The break-even of a worker, in pixels, is its
    start-up over the seconds a pixel: ``PIXELS_PER_WORKER`` stands for it."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor
    from pathlib import Path

    from dgdm_histopath_torch.scripts import eval_camelyon16
    from dgdm_histopath_torch.scripts import gate_harness as gh
    jobs = {}
    eval_camelyon16.generate_synthetic_camelyon16_hard(
        Path(out) / "synthetic_data", n_train_per_class=48, n_test_per_class=64, seed=0,
        jobs=jobs)
    items = sorted(jobs.items(), key=lambda kv: str(kv[0]))
    pixels = lambda part: sum(kw["width"] * kw["height"] for _, kw in part)  # noqa: E731
    t0 = time.perf_counter()
    for item in items[:8]:
        gh._render_one(item)
    s_per_px = (time.perf_counter() - t0) / pixels(items[:8])
    t0 = time.perf_counter()
    with ProcessPoolExecutor(1, mp_context=mp.get_context("spawn")) as pool:
        pool.submit(gh._render_one, items[8]).result()
    startup = time.perf_counter() - t0 - pixels(items[8:9]) * s_per_px
    rest = items[9:]
    workers = min(os.cpu_count() or 1, pixels(rest) // gh.PIXELS_PER_WORKER)
    t0 = time.perf_counter()
    gh.render_slides(dict(rest))
    rule_s = time.perf_counter() - t0
    res = {"s_per_mpx": s_per_px * 1e6, "worker_startup_s": startup,
           "break_even_px": startup / s_per_px, "pixels_per_worker": gh.PIXELS_PER_WORKER,
           "rest_slides": len(rest), "rest_px": pixels(rest), "rest_workers": workers,
           "rest_s": rule_s, "rest_in_process_s": pixels(rest) * s_per_px,
           "cores": os.cpu_count()}
    log(f"gates-only: host rendering of 1024² c16 slides: {res['s_per_mpx']:.4f} s a "
        f"megapixel in this process, a spawned worker's start-up {startup:.2f} s, so a "
        f"worker breaks even at {res['break_even_px'] / 2 ** 20:.1f} Mpx (PIXELS_PER_WORKER "
        f"{gh.PIXELS_PER_WORKER / 2 ** 20:.0f} Mpx); the other {len(rest)} slides "
        f"({pixels(rest) / 2 ** 20:.0f} Mpx) in {workers} workers by the rule: {rule_s:.1f} s "
        f"against {res['rest_in_process_s']:.1f} s in this process (estimated), "
        f"{os.cpu_count()} cores [{card}]")
    return res


def gates_full(torch, card: str, seeds=GATE_SEEDS) -> dict:
    """``--gates-only``: the calibrated c16 hard recipe exactly, dense and
    scratch arms over ``seeds``, pooled, beside the JAX package's pooled
    report of the same recipe."""
    import tempfile

    import numpy as np

    from dgdm_histopath_torch.evaluation.metrics import _roc_auc, pooled_paired_bootstrap_delta
    from dgdm_histopath_torch.ops import kernels
    from dgdm_histopath_torch.scripts import eval_camelyon16
    jax_dir = GATE_C16_DIR
    jax_pooled = json.loads(open(os.path.join(jax_dir, "report_pooled.json")).read())
    with tempfile.TemporaryDirectory() as root:
        out = gate_copy(root, cache=False)
        render = gate_render_timing(out, card)
        argv = [*GATE_C16_RECIPE, *gate_epochs(GATE_EPOCHS),
                "--extractor", "stats", "--per-slide-norm", "--ab-pretrain",
                "--train-seed", ",".join(str(s) for s in seeds), "--out", out]
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with FitClock(torch) as clock:
            eval_camelyon16.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
        pooled = json.loads(open(os.path.join(out, "report_pooled.json")).read())
        # the per-seed report of the first train seed (the recipe's --seed is 0)
        first_name = "report.json" if seeds[0] == 0 else f"report_t{seeds[0]}.json"
        first = json.loads(open(os.path.join(out, first_name)).read())
        graphs = gate_graphs_vs_committed(out)
        labels, dense = arm_probs(out, "dense", seeds)
        jlabels, jdense = arm_probs(jax_dir, "dense", seeds)
        if not np.array_equal(labels, jlabels):
            raise AssertionError("the port's test labels are not the committed gate's")
        ours_ci, jax_ci = pooled_auc_ci(labels, dense), pooled_auc_ci(jlabels, jdense)
        # JAX's uplift over the same seeds, pooled as aggregate_hard_seeds pools it
        _, jscratch = arm_probs(jax_dir, "scratch", seeds)
        jax_same = pooled_paired_bootstrap_delta(_roc_auc, jlabels, jscratch, jdense,
                                                 n_bootstrap=2000, resample_seeds=True)
    ours_auc = pooled["arms"]["dense"]["auc_mean"]
    jax_auc = float(np.mean([jax_pooled["arms"]["dense"]["auc_by_seed"][str(s)]
                             for s in seeds]))
    uplift, jax_uplift = pooled["pretrain_auc_uplift"], jax_pooled["pretrain_auc_uplift"]
    jax_uplift_same = {"delta": jax_same["delta"], "ci95": [jax_same["lower"], jax_same["upper"]],
                       "per_seed": jax_same["per_seed"]}
    inside = jax_ci[0] <= ours_auc <= jax_ci[1]
    res = {"card": card, "seeds": list(seeds), "wall_s": wall, "render": render,
           "graph_cache_misses": first["graph_cache_misses"],
           "preprocess_s_per_slide": first["preprocess_s_per_slide"],
           "fits": clock.fits, "launches": launches, "graphs_vs_committed": graphs,
           "dense_auc_mean": ours_auc, "dense_auc_ci95_two_level": ours_ci,
           "dense_auc_by_seed": pooled["arms"]["dense"]["auc_by_seed"],
           "scratch_auc_mean": pooled["arms"]["scratch"]["auc_mean"],
           "pretrain_auc_uplift": uplift,
           "jax": {"dense_auc_mean": jax_auc, "dense_auc_ci95_two_level": jax_ci,
                   "full_dense_auc_mean": jax_pooled["arms"]["dense"]["auc_mean"],
                   "pretrain_auc_uplift": jax_uplift,
                   "pretrain_auc_uplift_same_seeds": jax_uplift_same},
           "dense_inside_jax_ci": inside}
    log(f"gates-only: c16 hard recipe (stats, per-slide norm), {len(seeds)} train seeds "
        f"x dense + scratch in {wall:.1f} s ({first['graph_cache_misses']} graphs built, "
        f"{first['preprocess_s_per_slide']} s a slide), launches {launches} [{card}]")
    log(f"gates-only: graphs against the committed simple_cnn+stats cache: {graphs}")
    log(f"gates-only: pooled dense AUC port {ours_auc:.4f} two-level CI {ours_ci} | JAX "
        f"{jax_auc:.4f} CI {jax_ci} (report_pooled.json auc_mean "
        f"{jax_pooled['arms']['dense']['auc_mean']}); inside JAX's CI: {inside}")
    log(f"gates-only: pretrain uplift port {uplift['delta']} CI {uplift['ci95']} per seed "
        f"{uplift['per_seed']} | JAX over the same seeds {jax_same['delta']:.4f} CI "
        f"[{jax_same['lower']:.4f}, {jax_same['upper']:.4f}] per seed {jax_same['per_seed']}, "
        f"over its 10 {jax_uplift['delta']} CI {jax_uplift['ci95']}")
    return res


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
    t_build = time.perf_counter() - t0
    log(f"build: {sorted(libs)} in {t_build:.1f} s (nvcc, sm_90a)")
    ptxas = {name: build.ptxas_report(name) for name in PTXAS_SOURCES}
    for r in (r for rows in ptxas.values() for r in rows):
        log(f"ptxas: {r['kernel']}: {r['registers']} registers, spill stores "
            f"{r['spill_stores']} / loads {r['spill_loads']} bytes, stack {r['stack']}, "
            f"static smem {r['static_smem']}")

    if sys.argv[1:] == ["--parallel-only"]:
        # the parallel tiers alone; on four cards over NCCL, with dgdm-train --mesh-shape 2,2
        cards = torch.cuda.device_count()
        par = parallel_phase(torch, make_graphs(BASE), card, cards)
        par["cli"] = dp_cli(torch, card, cards, "2,2") if cards >= 4 else None
        log("details: " + json.dumps({"parallel": par}, default=str))
        log(f"done in {time.perf_counter() - t_start:.1f} s")
        print(card)
        print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                                 "kind": torch.cuda.get_device_name(0),
                                                 "count": cards}}))
        return 0

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

    if sys.argv[1:] == ["--dtype-only"]:
        # phase 17 alone: the kernels and DGDM-Base in half precision
        dtype = dtype_phase(torch, make_graphs(BASE), card)
        log("details: " + json.dumps({"dtype": dtype}, default=str))
        log(f"done in {time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"kernels": f16_kernel_entries(dtype)}))
        print(card)
        print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                                 "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}))
        return 0

    if sys.argv[1:] == ["--research-only"]:
        # phase 19 alone: gradients with respect to the node features, the research modules
        research = research_phase(torch, make_graphs(BASE), card)
        log("details: " + json.dumps({"research": research}, default=str))
        log(f"done in {time.perf_counter() - t_start:.1f} s")
        print(card)
        print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                                 "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}))
        return 0

    if sys.argv[1:] == ["--quality-only"]:
        # phase 20 alone: dgdm-quality, ResilientTrainer and federated training
        quality = quality_phase(torch, make_graphs(BASE), card)
        log("details: " + json.dumps({"quality": quality}, default=str))
        log(f"done in {time.perf_counter() - t_start:.1f} s")
        print(card)
        print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                                 "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}))
        return 0

    if sys.argv[1:] == ["--orchestration-only"]:
        # phase 21 alone: clinical/, the exported program, production, quantum/, enterprise/
        orch = orchestration_phase(torch, make_graphs(BASE), card)
        log("details: " + json.dumps({"orchestration": orch}, default=str))
        log(f"done in {time.perf_counter() - t_start:.1f} s")
        print(card)
        print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                                 "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}))
        return 0

    if sys.argv[1:2] == ["--transpose-only"]:
        # the transposed-list kernel alone; with --old-transpose PATH, against
        # a neighbor_transpose.cu of the single-CTA design in the same call
        out = {"transpose": transpose_phase(torch)}
        if sys.argv[2:3] == ["--old-transpose"]:
            out["ab"] = transpose_ab(torch, sys.argv[3], card)
        log("details: " + json.dumps(out, default=str))
        log(f"done in {time.perf_counter() - t_start:.1f} s")
        print(card)
        print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                                 "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}))
        return 0

    if sys.argv[1:2] == ["--gates-only"]:
        # the whole calibrated c16 hard gate on the card
        args = sys.argv[2:]
        seeds = (tuple(int(s) for s in args[1].split(",") if s)
                 if len(args) == 2 and args[0] == "--train-seeds" else GATE_SEEDS)
        # the pooled report, and so the comparison, needs two train seeds or more
        if (args and (len(args) != 2 or args[0] != "--train-seeds")) or len(seeds) < 2:
            print("usage: chip_smoke.py --gates-only [--train-seeds 5,6,7,8,9]",
                  file=sys.stderr)
            return 2
        gates = gates_full(torch, card, seeds)
        log("details: " + json.dumps({"gates_full": gates}, default=str))
        log(f"done in {time.perf_counter() - t_start:.1f} s")
        print(card)
        print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                                 "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}))
        return 0

    if sys.argv[1:] == ["--preprocess-only"]:
        # phase 18 alone: the offline-preprocessing cell
        pre = preprocess_phase(torch, card)
        log("details: " + json.dumps({"preprocess": pre}, default=str))
        log(f"done in {time.perf_counter() - t_start:.1f} s")
        print(card)
        print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                                 "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}))
        return 0

    seconds = {"build": round(t_build, 1)}

    def timed(name: str, fn, *args):
        """``fn(*args)``, its wall seconds under ``name``, the cache emptied
        after it."""
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.empty_cache()
        seconds[name] = round(time.perf_counter() - t0, 1)
        log(f"phase {name}: {seconds[name]} s")
        return out

    kern = timed("kernels", kernel_phase, torch)
    kern.update(timed("flash_kernels", flash_kernel_phase, torch))
    transpose = timed("transpose", transpose_phase, torch)

    # DGDM-Base: serving, then training
    graphs = make_graphs(BASE)
    predictor, launches, timing, parity = timed("base_model", model_phase, torch, graphs,
                                                card, BASE)
    server = timed("base_server", server_phase, predictor, graphs, BASE)
    del predictor
    captured = []
    train_launches, train_timing, train_parity = timed("base_training", training_phase, torch,
                                                       graphs, card, BASE, captured)
    real_step = timed("real_step", real_step_phase, torch, captured)
    del captured

    # the flash path, through the module a user would call
    flash_module = timed("flash_module", flash_module_phase, torch, card)

    # DGDM-Large (windowed + banded): serving, then training
    large_graphs = make_graphs(LARGE, seed=100)
    predictor, l_launches, l_timing, l_parity = timed("large_model", model_phase, torch,
                                                      large_graphs, card, LARGE)
    l_server = timed("large_server", server_one_request, predictor, large_graphs[0], LARGE)
    del predictor
    l_train_launches, l_train_timing, l_train_parity = timed(
        "large_training", training_phase, torch, large_graphs, card, LARGE)
    del large_graphs

    # so that every phase above runs as it did before this phase existed
    remat = timed("remat", remat_phase, torch, graphs, card, BASE)

    # the MoE tier (configs/dgdm_base_moe.yaml) against the Base numbers above
    moe = timed("moe", moe_phase, torch, graphs, card, train_timing, timing)

    # data parallelism: two gloo ranks sharing the card, one NCCL rank
    dp = timed("dp", dp_phase, torch, graphs, card, torch.cuda.device_count())

    # the other parallel tiers (TP, PP, EP, the halo, node sharding with
    # DGDM-Large's windows) and the multichip dry runs
    par = timed("parallel", parallel_phase, torch, graphs, card, 1)

    # last: the whole-slide path
    slide_keep = {}
    slide = timed("slide", slide_phase, torch, card, kern, slide_keep)

    # last: int8 inference, on the Base cell's graphs and the slide's patches
    int8 = timed("int8", int8_phase, torch, graphs, card, slide_keep)
    slide_backend = slide_keep["backend"]           # for phase 21
    del slide_keep

    # half precision (item 8): the kernels in f16 beside the bf16 rows above,
    # DGDM-Base in f16 / with bf16 parameters / with set2set, the f16 CLI run
    dtype = timed("dtype", dtype_phase, torch, graphs, card, kern)

    # phase 19: feature gradients through the gather backward kernels, the
    # research modules
    research = timed("research", research_phase, torch, graphs, card)

    # phase 20: dgdm-quality and its gates, ResilientTrainer and federated
    # DGDM-Base training on the card
    quality = timed("quality", quality_phase, torch, graphs, card)

    # phase 21: clinical/ (DICOM -> predict_slide -> EHR), the exported
    # program, production, quantum/ and enterprise/ on the card
    orch = timed("orchestration", orchestration_phase, torch, graphs, card, slide_backend)
    del graphs, slide_backend

    # last: training through the CLI, resumed after a SIGTERM, and dgdm-predict
    cli = timed("cli", cli_phase, torch, card)

    # last: the serving tier, dynamic batching, the rate limit and dgdm-serve
    serve = timed("serve", serve_phase, torch, card)

    # last: offline preprocessing (slides rendered on the card -> graphs ->
    # dgdm-predict)
    pre = timed("preprocess", preprocess_phase, torch, card)

    # last: the staged accuracy gates (phase 22)
    gates = timed("gates", gates_phase, torch, card)

    replaces = KERNEL_SOURCES
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
                   "preprocess_predict_slide": pre["predict_slide"]["launches"][name],
                   "preprocess_dgdm_predict": pre["predict"]["launches"][name],
                   "gate_c16_arm_seed": gates["c16"]["launches"][name],
                   "gate_tcga_loop": gates["tcga"]["launches"][name],
                   "research_node_saliency": research["launches"][name],
                   "research_integrated_gradients": research["ig_launches"][name],
                   "research_pgd": research["pgd_launches"][name],
                   "quality_gate_training_step": (
                       quality["gates"]["launches"]["training_step"][name]),
                   "resilient_trainer_step": quality["resilient"]["launches"][name],
                   "federated_round": quality["federated"]["launches"][name],
                   "process_study": orch["clinical"]["launches"][name],
                   "exported_program": orch["export"]["launches"][name],
                   "planner_tasks": orch["planner"]["launches"][name],
                   "optimizer_trial_step": orch["optimizer"]["step_launches"][name],
                   "tenant_job": orch["enterprise"]["launches"]["hospital"][name],
                   "moe_predict_batch": moe["launches"][name],
                   "moe_training_step": moe["train_launches"][name],
                   "int8_predict_batch": int8["launches"][name],
                   "int8_predict_slide": int8["featurizer"]["predict_slide"]["launches"][name],
                   "edge_int8_predict": int8["edge"]["launches"][name],
                   "dp_training_step_gloo_rank": dp["gloo"]["launches"][name],
                   "dp_training_step_nccl_rank": dp["nccl"]["launches"][name],
                   "tp_training_step_rank": par["tp"]["launches"][name],
                   "pp_stage_forward_backward": par["pp"]["launches"][name],
                   "halo_gather": par["halo"]["launches"][name],
                   "sp_graph_conv": par["halo"]["sp_launches"][name],
                   "sp_forward_rank": par["sp"]["float32"]["launches"][0][name],
                   "sp_training_step_rank": par["sp_train"]["bfloat16"]["launches"][0][0][name],
                   "sp_moe_forward_rank": par["sp_moe"]["forward"]["launches"][0][name],
                   "sp_moe_training_step_rank": (
                       par["sp_moe"]["float32"]["launches"][0][0][name]),
                   "sp_remat_training_step_rank": (
                       par["sp_remat"]["float32_dropout"]["launches"][0][0][name]),
                   "sp_large_forward_rank": par["sp_large"]["forward"]["launches"][0][name],
                   "sp_large_training_step_rank": (
                       par["sp_large"]["float32"]["launches"][0][0][name]),
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
        if name == "neighbor_transpose":
            timed = [r for r in transpose["cases"] if "ms" in r]
            entry["launch_floor_ms"] = timed[0]["floor_ms"]     # at the Base shape's plan
            entry["cases_ms"] = {r["case"]: {k: r[k] for k in (
                "shape", "rows", "cluster", "ms", "floor_ms", "bound_ms", "plain_ms")}
                for r in timed}
        if name in real_step:
            entry["real_step_ms"] = {r["shape"][1]: r["ms"] for r in real_step[name]}
        if name in par["rect"]:
            entry["halo_rectangular"] = {f"{r['case']} {r['dtype']}": {
                k: r[k] for k in ("src", "shape", "ms", "plain_ms", "bound_ms", "library_ms")}
                for r in par["rect"][name]}
        if name in slide["kernels_k24"]:
            entry["slide_k24_ms"] = {f"{r['case']} {r['dtype']}": r["ms"]
                                     for r in slide["kernels_k24"][name]}
        if name in flash_module:
            entry["max_abs_err_bf16"] = max(r["max_abs_err"] for r in kern[name]
                                            if r["dtype"] == "bfloat16")
            entry["all_shapes"] = kern[name]
        line["kernels"].append(entry)
    line["kernels"] += f16_kernel_entries(dtype)
    for t in (timing, train_timing, l_timing, l_train_timing, moe["timing"], moe["training"],
              moe["block"]):
        t["profile"].pop("top")           # printed above, one line per kernel
    log("details: " + json.dumps({"ptxas": ptxas, "kernels": kern, "real_step": real_step,
                                  "transpose": transpose,
                                  "model": timing, "parity": parity, "server": server,
                                  "training": train_timing,
                                  "training_parity": train_parity, "remat": remat,
                                  "flash_module": flash_module, "cli": cli,
                                  "serve": serve, "moe": moe, "dp": dp, "int8": int8,
                                  "dtype": dtype, "preprocess": pre, "research": research,
                                  "gates": gates,
                                  "quality": quality, "orchestration": orch,
                                  "parallel": {k: v for k, v in par.items() if k != "rect"},
                                  "slide": {
                                      k: v for k, v in slide.items() if k != "kernels_k24"},
                                  "large": {"model": l_timing, "parity": l_parity,
                                            "server": l_server,
                                            "training": l_train_timing,
                                            "training_parity": l_train_parity}}))
    seconds["total"] = round(time.perf_counter() - t_start, 1)
    log("phase_seconds: " + json.dumps(seconds))
    log(f"done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
