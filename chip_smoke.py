#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repo root on a machine with a CUDA card and ``nvcc``.  It puts
``src/`` on ``sys.path`` and imports only ``torch`` and ``repro_torch``.
Phases, each fatal on failure:

  a. the card's name and power limit (``nvidia-smi``);
  b. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (timed);
  c. hold kernels K1-K3 against their plain PyTorch versions at OLMo-1B's
     linear shapes (2048x2048, 2048x8192, 8192x2048; M = 4, 16 and 128;
     plus a K % w != 0 case) and time both, the bf16 ``torch.matmul`` on the
     dequantized weight as a yardstick (all interleaved over ``ROUNDS``
     rounds: median and range, with the SM clock and power drawn over the
     same window; the kernels' and the yardstick's eager calls and the
     replays of a CUDA graph of the same calls, the device's time), and each
     one's least possible time; at M = 4 also each linear shape alone,
     kernel and yardstick graph-replayed; every 2-D
     kernel (K1-K3, and K9 / K10 on the mip2q layers) is called twice at
     every shape and the two outputs must be bit-identical (split-K adds
     the slices of a cluster in rank order);
  d. serve full-width OLMo-1B (16 layers, d 2048, vocab 50304, random
     weights from a seed) through ``repro_torch.launch.serve`` with its
     defaults (mip2q p=0.5 L=5, batch 4, prompt 32, gen 16): every plan
     entry must select ``cuda:onehot`` and the run must launch it; then
     ``SERVE_REPEATS`` more warm serves of the same prompt give the median
     and range of the prefill and decode times;
  e. two shorter runs (2 layers, full width) under ``--strum dliq --p 1.0``
     and ``--p 0``, which must select and launch ``cuda:maskfree`` and
     ``cuda:dense`` (K3 on the streamed kernel's byte path: every entry's
     payload routes there);
  f. phase d's logits at every decode position against the same port run
     through the ``torch`` family (dequantize + torch.matmul), teacher-forced;
  g. hold the packed-KV kernels K4 (mip2q p=0.5 L=7 pages), K5 (dliq p=1
     q=4) and K11 against their plain versions at OLMo-1B's attention shapes
     (16 kv heads x 128, pages of 16, 4 slots, contexts 512 and 2048, R = 1
     and 16 query rows per kv head; and pages of 128 at decode) and
     Qwen2-7B's (4 kv heads, R = 7 and
     112), with one slot empty and one with -1 tail ids: acc, m, l and
     acc / l each within KERNEL_TOL x its largest |plain| + 1e-6 over the
     rows with a live page, the other rows exactly the identity partial,
     K11 bit for bit; time kernel, plain
     version and a yardstick interleaved as in phase c (the yardstick for
     K4/K5 is ``scaled_dot_product_attention`` on the same pages dequantized
     to bf16; K11 has no one-call yardstick).  K11 is timed on the live K
     pages of the first case and on ``DECODE_CASES`` (dliq q=3, Qwen2-7B's
     F = 512, pages of 128, w = 64 and 128), beside a ``fill_`` of the same
     f32 output (the card's write rate, a reference only), each bit for bit.
     K4 and K5 are split-KV: their
     time includes the combine kernel that merges the splits.  Kernel and
     yardstick times here and in phase k are replays of a CUDA graph of one
     call (the device's time; the eager calls' time, which adds the Python
     wrapper's launch path, is printed beside it);
  h. serve full-width OLMo-1B through the paged runtime (``serve --paged
     --kv-cache mip2q --prompt-len 128 --gen 32``): it must select
     ``cache:attn_fused`` over ``cache:cuda_decode`` pools, launch K4 once
     per layer per decode tick and per prefill chunk (its combine at most as
     often, and at least once; K5 and its combine never), and hold its pages at
     x0.875 of int8; prints the drain time, ticks and decode-only tick;
  i. a 2-layer full-width scheduler with dliq p=1 q=4 pages must select and
     launch K5 (``cache:attn_fused_maskfree``) once per layer per lane run,
     its combine exactly once per call whose table splits, K4 and K4's
     combine never; then ``serve --paged --kv-cache mip2q --page-size 128``
     (2 layers, full width, prompt 256) must select K4 and launch it once
     per layer per lane run, serving every request to completion;
  j. decode every page phase h sealed through ``gather_decode_pages`` (K11)
     against the plain decode, exactly; then phase h's requests, teacher-
     forced on its tokens, through the cuda family and through the torch
     family (weights and cache), logits compared to phase f's tolerance;
  k. hold the grouped MoE kernels K6 (mip2q p=0.5 L=5), K7 (dliq p=1 q=4)
     and K8 (mip2q p=0) against their plain versions at Moonshot-16B-A3B's
     expert shapes (64 experts, wi/wg 2048 -> 1408 and wo 1408 -> 2048,
     capacity 6 at decode and 24 at prefill, bf16 x) and K6 at one
     Qwen3-MoE decode stack (128 experts, capacity 8, 4096 -> 1536), within
     KERNEL_TOL x max|plain|; time kernel, plain version and bf16
     ``torch.bmm`` on the dequantized stack interleaved as in phase c; then
     K6 at a routed Moonshot decode: the port's ``_route`` on 4 tokens at
     top-6 gives each expert's live rows (<= 24 of 64 experts live), x is
     zero past them, K6 and its plain version take them as ``rows``, rows
     past each count must be exactly 0, and the bound counts only the live
     experts' bytes (the ``torch.bmm`` yardstick stays over all 64); the
     same routed case for K7 (dliq p=1 q=4) and K8 (mip2q p=0); each routed
     time must be below its kernel's all-live capacity-6 time (a row tile
     past the count reads no weight byte);
  l. serve Moonshot-16B-A3B at full width with its depth cut to MOE_LAYERS
     of 48 layers through the paged runtime (``serve --paged --kv-cache
     mip2q --prompt-len 128 --gen 32``) and the dense-cache loop (batch 4,
     prompt 32, gen 16): every expert stack must select ``cuda:grouped``
     and every attention linear ``cuda:onehot``, K6 must launch 3 x layers
     x lane runs (with each expert's live rows) and K4 once per layer per
     lane run, weights and pages at
     x0.875 of int8; then the paged requests teacher-forced through the
     torch family, logits compared to phase f's tolerance;
  m. 2-layer full-width Moonshot under dliq p=1 and mip2q p=0 weights must
     select and launch K7 (``cuda:grouped_maskfree``) and K8
     (``cuda:grouped_dense``), every launch with each expert's live rows
     (K3 for the attention linears of the p=0 run, on the byte path);
  n. hold the draft kernels K9 (histream: mask + hi) and K10 (maskfree_p: hi
     only) against their plain versions at OLMo-1B's seven linear shapes
     (mip2q p=0.5 L=5, bf16 x, M = 4, 1 and 16) within KERNEL_TOL x max|plain|,
     launched with null pointers for the fields they do not stream; time
     kernel, plain version and bf16 ``torch.matmul`` on the draft-decoded
     weight interleaved as in phase c, eager and graph-replayed, and at M = 4
     each linear shape alone;
  o. serve full-width OLMo-1B speculatively through the paged runtime
     (``serve --paged --kv-cache mip2q --prompt-len 128 --gen 32
     --speculative 3 --draft histream|maskfree_p``): K9 (or K10) must launch
     112 times per draft step and K1 112 times per verify window and
     prefill chunk (so never in the draft lane), every drafted tensor must be
     the target plan's, the draft payload ratio exactly 10/14 (8/14), and
     the served tokens the verify lane's argmax at every committed position;
     then phase h's requests teacher-forced through the speculative lane:
     its predictions against phase h's plain lane at >= 0.9 of positions
     (each disagreement printed with the plain lane's top-2 gap) and its
     logits within phase f's tolerance of phase j's plain-lane logits;
  p. the schedule-driven path, each sub-phase fatal:
     p1. profile full-width OLMo-1B (all 16 layers, seed 0, f32) on the card
     with ``DEFAULT_GRID`` (timed; the same call again must be all cache
     hits, timed: the content hashes), search under
     ``Budget(target_ratio=0.875)`` (timed), save and load the schedule
     JSON; every assigned tensor must get its config on a ``cuda:*``
     variant (a ``torch:dequant`` entry only where no ``cuda:*`` predicate
     accepts its config, printed) or stay dense where assigned None, and
     the plan's packed bytes must equal ``tree_compression_report``'s over
     the packed tensors exactly; serve it through ``serve --paged
     --kv-cache mip2q --schedule PATH`` (batch 4, prompt 128, gen 32): one
     launch per entry per layer per lane run, K4 once per layer per lane
     run, nothing else; drain and decode-only tick beside phase h's; then
     phase d's prompt through the dense-cache loop on the same plan, cuda vs
     torch family as in phase f;
     p2. a schedule the script writes for 2-layer full-width OLMo-1B, one
     config per linear kind: K1 (mip2q p=0.5 L=5, on its byte path), K2
     (dliq p=1), K3 (mip2q p=0), K1 off its byte path (mip2q L=7), one
     linear dense; the plan must select exactly those variants and launch
     one kernel per entry per layer per step and nothing else; logits vs
     the torch family as in phase f; then the paged lane plain and
     speculative (k=3, histream) on the same schedule: the same tokens, the
     drafted and full-fidelity leaves ``build_draft_plan``'s mode map, and
     each kernel's launches (K9 for the drafted leaves in draft steps, the
     others' own kernels) exact;
     p3. Moonshot-16B-A3B at 2 of 48 layers, full width: wi, wg, wo of its
     MoE layer position on K6, K7, K8 through the paged runtime (one launch
     each per layer per lane run, every one with the experts' live rows),
     logits vs the torch family as in phase l; then wo left dense through
     the dense-cache loop (K6 and K7 only), logits vs the torch family.
     Names key whole stacked tensors (all layers of a position), as in the
     reference, so a schedule cannot give two layers of one position two
     configs: the dense ``wo`` is a second plan.

  q. the model zoo, each sub-phase fatal:
     q1. full-width Mamba-2 780M, all 48 layers (mip2q p=0.5 L=5): K1 at its
     in_proj (1536 -> 6448) and out_proj (3072 -> 1536) shapes, M = 4 and 16,
     against its plain version (one layer timed at M = 4); the dense-cache
     loop as in phase d, K1 exactly twice per layer per step and nothing
     else, logits vs the torch family as in phase f; layer 0's packed mixer
     at f32: ``ssm_prefill_chunk`` over 100 tokens in chunks of 16 equal to a
     one-shot ``ssm_apply`` (outputs, conv tail, state), and its memory peak
     at a 4 x 128 prefill below one (B, c, c, nh, hp) f32 tensor; the paged
     runtime at
     phase h's shape, K1 exactly twice per layer per lane run and K4, K5,
     K11 and the combine never, weights at x0.875 of int8, the SSM hot
     state's bytes exact; then its requests teacher-forced through the
     chunked lane (its own tokens, exactly) and the serial lane (the same
     tokens except at near ties: the gap between the two tokens' chunked
     logits within twice the lanes' max |diff| there; logits to phase f's
     tolerance), each lane's launches exact;
     q2. the Jamba hybrid at its SMOKE shape (4 layers, period 2: SSM + MLP,
     attention + MoE; the published width does not fit one card): paged with
     mip2q KV pages, K1 on every dense linear, K4 once per attention layer
     (its combine by the split rule) and K6 three times per MoE layer per
     lane run, exactly; serial vs chunked as in q1; logits vs the torch
     family as in phase l; ``speculative=3`` refused;
     q3. DeepSeek-67B, StableLM-2-12B (head dim 160), InternVL2-26B's
     InternLM2 backbone and MusicGen-medium (MHA, 24 kv heads of 64, GELU
     MLP) at full width with 2 layers: 2 requests of 64 + 9 tokens paged,
     launches exact, teacher-forced against the torch family; InternVL2 and
     MusicGen also through their stub frontend (seeded ``embeds`` into
     ``prefill`` and ``forward_train``, cuda vs torch family); K4 held to
     its plain version and timed as in phase g at head dim 160 (8 kv heads,
     R = 4) and 64 (24 kv heads, R = 1).

  r. the training path, each sub-phase fatal:
     r1. full-width OLMo-1B, all 16 layers, f32 parameters, bf16 activations,
     the config's remat, through ``launch.train``'s own code (``build``,
     ``TrainLoopRunner``, the data pipeline, AdamW as ``train.py`` sets it):
     ``TRAIN_STEPS`` steps at batch 4 x seq 2048, then ``COMPRESSED_STEPS``
     with ``--grad-compression``; ms per step (median of the steps after the
     first, and range), tokens/s, ``max_memory_allocated``, every step's loss
     and grad norm, the f32 FLOP bound of the step; every loss and grad norm
     finite, every parameter moves, every leaf of the state stays on the
     card, and no StruM kernel launches;
     r2. one ``make_train_step`` at full width, 2 layers, batch 1 x seq 256,
     f32 activations, on the card and on the CPU from the same parameters:
     loss within 1e-4 relative, each leaf's gradient within 1e-3 of its
     largest |g|, and AdamW on the CPU from the card's gradients within 1e-5
     of the card's updated parameters (each leaf's largest |p|); the two
     whole steps' parameters within what the gradient gap allows, element
     by element (AdamW's first step is lr · e / (|e| + eps), e the clipped
     gradient, whose slope eps / (|e| + eps)² is 1 / eps near e = 0: there
     the f32 gradients' absolute gap, set by the size of the sums that make
     them and not by |e|, becomes a visible step gap), and within 1e-5 of
     each leaf's largest |p| where both |e| >= 1e3 · eps;
     r3. resume on the OLMo smoke config: ``TrainLoopRunner(ckpt_every=3)``
     for 6 steps, against 3 steps, a new runner through ``resume_or_init``
     and 3 more: every parameter and optimizer leaf bit for bit (a failure
     names the leaves with the largest differences);
     r4. tests/test_system.py's flow on the card: sys_tiny trained 120 steps
     (the last 10 losses' mean 0.5 below the first 10's) and its PTQ CE
     ordering; r1's trained weights through the default plan, CE through
     ``loss_fn`` over the packed leaves (K1, exactly 7 x 16 launches, at M =
     8192) within 1e-2 of the CE through ``fake_quantize`` of the same
     config, K1 on a trained layer at M = 8192 held to its plain version and
     timed with its bound; then those packed weights served paged (2
     requests of 128 + 8 tokens, mip2q pages), K1 and K4 launches exact.

  s. distributed execution, each sub-phase fatal (the mesh path reuses the
     kernels above: K1 after the packed gather of ``sharded:gather_pallas``,
     K6 after ``sharded:grouped_gather``'s, K4 in the paged lanes):
     s1. NCCL on a world of 1, a 1x1 mesh: full-width OLMo-1B (16 layers,
     seed 0, the default plan) through ``serve --mesh 1x1``'s code, the
     dense-cache loop and ``BatchScheduler(mesh=)`` paged (mip2q pages,
     phase h's shape): every entry on ``sharded:gather_pallas``, K1 exactly
     phase d's count and 7 x 16 per lane run, K4 16 per lane run, tokens
     equal to phases d and h;
     s2. 4 gloo ranks sharing cuda:0 (gloo takes CUDA tensors in the
     card's torch build; NCCL refuses two ranks on one device) as a 2x2
     mesh: full-width OLMo-1B at S2_LAYERS (8 of 16) layers in the sharded
     serving layout (the reference's ``input_shardings``: dense and packed
     weights placed by ``shard_params``, the batch over data, the caches
     also over ``model`` by sequence), packed prefill + 8 decode steps
     through the dense-cache loop, each rank holding a quarter of every
     payload and of the caches and its share of every dense leaf (printed
     against the whole), K1 7 x layers x steps on every rank; at f32
     activations the one-device run's tokens and its logits within phase
     f's tolerance, at the config's bf16 the logits teacher-forced on the
     served tokens within phase f's tolerance, every argmax disagreement a
     near tie; one more f32 decode step under the dry-run's ``Counter``, its
     collectives and launches recorded for v3; one full-width
     Moonshot-16B-A3B MoE layer (a 4-slot decode, no drops) through the
     expert-parallel body, K6 3 times on every rank, the gathered-bytes
     counter exactly the rank's block, within phase l's tolerance of
     ``moe_apply`` on one device; the packed and dense bf16 payload bytes
     and their ratio, computed from the plan;
     s3. the ZeRO-3 train step (``steps._zero3_step``, the MoE, SSM and
     hybrid families' step on a mesh) on 2 gloo ranks (data = 2),
     full-width OLMo-1B at MESH_LAYERS layers, batch 2 x 256, f32, against
     the one-device step, within r2's bound; the dense f32 bytes it gathers;
     s4. the sharded serving layout of the MoE, SSM and hybrid families on
     4 gloo ranks as 2x2 (full-width Moonshot at MOE_LAYERS, Mamba-2 780M at
     S4_SSM_LAYERS, the Jamba smoke hybrid);
     s5. the paged layout on 4 gloo ranks as 2x2: ``BatchScheduler(mesh=)``
     over the default plan built on the mesh, 4 requests of 32 tokens,
     chunk 16, 6 new tokens, f32, mip2q pages, for full-width OLMo-1B (16
     layers), Moonshot (MOE_LAYERS), Mamba-2 780M (S4_SSM_LAYERS) and the
     Jamba smoke hybrid: teacher-forced on one device's tokens, every lane's
     logits within 1e-3 of max|logit| and every argmax disagreement a near
     tie, OLMo-1B also on raw f32 pages (no KV codec); K1 / K4 / K6
     launches on every rank exactly the plan's prediction (one a 2-D entry,
     one an expert stack, one an attention layer, a lane run); the bytes
     the decode lane all-gathers and ms a tick;
     s6. one train step of full-width OLMo-1B at S6_LAYERS layers, 4 x 256,
     f32, on 4 gloo ranks as 2x2 in the dense decoders' train layout and
     as ZeRO-3, against the one-device step within s3's limits; ms a step
     and each rank's peak memory for both;
     s7. one train step of the MoE, SSM and hybrid families in the train
     layout on 4 gloo ranks as 2x2, 4 x 256, f32 (S7_CASES): full-width
     Moonshot-16B-A3B at 1 layer (each rank its experts), full-width Mamba-2
     780M at 2 layers (each rank its SSM heads; also timed as ZeRO-3) and
     the Jamba smoke hybrid, each against the one-device step within s3's
     limits (rank 0 takes it first, and holds the gathered gradients and
     new parameters leaf by leaf); the dropped assignments of both runs, ms
     a step and each rank's peak memory over resident.

  t. static analysis (``repro_torch.analysis``), each sub-phase fatal:
     t1. the registry audit and the launch-contract lint on the card: every
     point of the reference's lint grid (and head dims 64-320, pages of
     16-128 for attention) that a ``cuda:*`` / ``cache:*`` / ``draft:*``
     predicate accepts must pass its launcher's ``launch_contract`` and is
     launched, within KERNEL_TOL x max|plain| + 1e-6 of its plain version,
     K1-K11 each launched; points the contracts refuse for a C++ check go
     straight to the C++ entry points and must come back
     cudaErrorInvalidValue; 0 error findings;
     t2. dataflow on full-width OLMo-1B (16 layers, phase d's plan): one
     dense decode step, each of the 112 linears exactly one K1 launch handed
     its leaf's mask / hi / lo / scale once, every decode site a K1 launch
     (no decoded copy, no ``torch:dequant``); one paged decode tick on phase
     h's scheduler (mip2q pages, 4 slots decoding): 16 K4 launches, the
     sealed pools read by K4 only, the pool bytes read equal to pools x 2 x
     slots x pages a slot x ``page_payload_bytes`` and to the tick's
     ``attn/fused/packed_bytes`` counter;
     t3. ``verify_draft_payload`` on phase o's speculative scheduler, each
     draft mode (the draft leaves the target's tensors, no skipped stream
     handed to any op or launch, the bytes read equal to
     ``draft_plan_bytes``), then every drafted leaf's skipped streams
     replaced by 0xFF copies: the draft step's logits bit for bit the same;
     t4. the recompile lint at full width, T_LAYERS layers, over the
     reference's mixed-length workload (chunked, serial and speculative
     schedulers): the signatures per lane, and exactly T_RETRACING flagged;
     t5. ``build_plan(..., validate=True)`` for full-width OLMo-1B and
     Moonshot-16B-A3B at MOE_LAYERS layers, and the time of
     ``validate_plan``.

  u. static numerics (``repro_torch.analysis.numerics``) on full-width
     OLMo-1B, all 16 layers, f32 activations, the default plan (K1 on its
     f32-x path), each sub-phase fatal:
     u1. ``analyze`` over ``forward_train`` at tokens U_TOKENS: each of the
     112 K1 calls interpreted through the hooks on the card, no unsupported
     op, no error finding, a finite bound and interval, and the bound at
     least the teacher-forced measured error (float vs packed forward on
     the card); the flash / rms matches printed;
     u2. ``output_error_profile`` of the 7 stacked linears, the
     ``output_error`` search at phase p1's budget beside the ``sqnr`` one
     (both tables and where they differ), that schedule's plan through the
     dense-cache loop and, from its JSON, the paged ``BatchScheduler(
     schedule=)`` (fp pages): teacher-forced on the loop's tokens, every
     paged argmax off the loop's token a near tie; K1 / K2 / K3 launches and
     the tick;
     u3. ``search_draft_schedule(plan, fn=forward)``; one request served
     speculatively with the winner (mip2q pages) gives the greedy lane's
     tokens; predicted alpha and speedup beside the measured acceptance;
     u4. ``verify_numerics(device="cuda")`` and ``python -m
     repro_torch.analysis --passes numerics --device cuda``: clean.

  v. the launch tools and examples (``repro_torch.examples``,
     ``repro_torch.launch.dryrun``), each sub-phase fatal; the dry-run sweeps
     of every arch x shape on 1x1, 16x16 and 2x16x16 start in V_WORKERS
     processes (host work on ``meta`` tensors) beside v1:
     v1. the example twins through their ``run`` at full width, seed 0:
     quickstart (its 512 x 256 matrix through K1 within KERNEL_TOL of the
     plain version, then full-width OLMo-1B packed by the default plan: 113
     K1 launches, the dense and packed MB, the next-token TV distance);
     serve_batch (OLMo-1B, 6 requests on 3 slots, mip2q weights and KV pages
     of 16, chunked prefill: every request retires with 8 tokens, pages
     x0.875 of int8 exactly, K1 and K4 launched; ticks and drain ms);
     serve_strum (OLMo-1B, the three fixed configs: each payload over the
     int8 bytes of K padded to whole blocks equal to Eq. 1 / 2 of its p and
     q, over the true int8 bytes within that padding; the schedule searched
     at 0.875 meets it; variants and token agreement); train_e2e (M100 at 8
     x 256 for V_TRAIN_STEPS steps: the mean loss of the last 10 below that
     of the first 10, every PTQ eval CE finite, ms a step);
     v2. full-width OLMo-1B on the default plan, a decode step at V_DECODE
     and a prefill at V_PREFILL: the dry-run's count on ``meta``
     (``count_step``, f32 parameters as the card holds them) beside the same
     step on the card: kernel calls equal to the launches per kernel and
     argument bytes equal to the real inputs' bytes, exactly; its temp
     bytes beside the card's peak above the allocations before the step,
     its roofline seconds beside the measured ms (reported); then the sweep's
     status counts (any FAIL is fatal) and seconds;
     v3. the dry-run of s2's OLMo decode step on the abstract 2x2 mesh
     (``AbstractMesh``: ``meta`` tensors, rank 0, the card's kernel choices)
     held to what s2's rank 0 records on cuda:0 under the same ``Counter``:
     every collective (primitive, kind, result shape and dtype, width,
     bytes, in order), the kernel calls and the K1 launches, exactly (with
     ``--only v`` that decode step runs alone on 4 gloo ranks first); then
     full-width OLMo-1B's decode_32k on mip2q weights counted on all three
     meshes and on dense weights on 16x16 (printed: per-device FLOPs,
     bytes, link bytes; rank 0's argument bytes of the dense cell, which
     the CPU tests hold to the reference's shard sizes); then the sweeps
     of every arch x shape on rank 0 of 16x16 and 2x16x16 (the
     same V_WORKERS processes), their status counts (any FAIL is fatal)
     and seconds; every sweep record is written to
     ``build/phase_v/dryrun_sweep.json``.

Before the last line it prints a JSON object with one entry per kernel; the
last is ``{"ok": true, "device": {...}}``.  Without a card, or outside the repo,
it exits non-zero before printing any result.  ``python3 chip_smoke.py --only
q`` (``--only r``, ``--only s``, ``--only t``, ``--only u``, ``--only v``)
builds the kernels and runs phase q (r, s, t, u, v) alone (no kernels or
result line).
"""
from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# The H100 SXM's published HBM rate and dense peaks by activation dtype,
# from ``repro_torch.hardware`` (bound in ``main`` once ``src/`` is on the
# path).  Decoded weights are integers of magnitude <= 128, exact in bf16, and
# the scale comes after the sum, so bf16 x meets the bf16 tensor-core rate;
# f32 x has only the CUDA cores' rate.
HBM_BYTES_PER_S: float
PEAK_FLOPS: dict
# |kernel - plain| <= KERNEL_TOL * max|plain| (+ 1e-6 for K4/K5, each
# output over its live rows): f32 sums of the same terms in another order
KERNEL_TOL = 2e-5
ROUNDS = 5                      # interleaved timing rounds per phase-c row
SERVE_REPEATS = 4               # warm serves timed after phase d's run
SOURCE = "src/repro_torch/kernels/csrc/strum_matmul.cu"
REPLACES = {"onehot": "src/repro/kernels/strum_matmul.py:173",
            "maskfree": "src/repro/kernels/strum_matmul.py:239",
            "dense": "src/repro/kernels/strum_matmul.py:283"}
KV_SOURCE = "src/repro_torch/kernels/csrc/strum_attention.cu"
# K4, K5, K11: registry variant name -> (kernel name, TPU kernel it replaces)
KV_KERNELS = {
    "cache:attn_fused": ("paged_attention", "src/repro/kernels/strum_attention.py:194"),
    "cache:attn_fused_maskfree": ("paged_attention_maskfree",
                                  "src/repro/kernels/strum_attention.py:225"),
    "cache:cuda_decode": ("page_decode", "src/repro/kernels/strum_decode.py:48")}
PAGE = 16                       # page size of the serving runs and most cases
# K6-K8 (grouped, one launch per expert stack): kernel name -> (registry
# variant, TPU kernel it replaces, plan of the phase-k cases)
# K9, K10 (the draft lane): kernel name -> (registry variant, TPU kernel)
DRAFT = {"histream": ("draft:histream", "src/repro/kernels/strum_matmul.py:348"),
         "maskfree_p": ("draft:maskfree_p", "src/repro/kernels/strum_matmul.py:404")}
SPEC_K = 3                      # phase o's speculative window
GROUPED = {"grouped_onehot": ("cuda:grouped", "src/repro/kernels/strum_matmul.py:462"),
           "grouped_maskfree": ("cuda:grouped_maskfree",
                                "src/repro/kernels/strum_matmul.py:522"),
           "grouped_dense": ("cuda:grouped_dense", "src/repro/kernels/strum_matmul.py:570")}
# (label, experts, capacity, (K, N) of each stack, kernels); one MoE layer of
# Moonshot-16B-A3B is wi, wg (2048 -> 1408) and wo (1408 -> 2048)
MOE_LAYER = [(2048, 1408), (2048, 1408), (1408, 2048)]
MOE_CASES = [("moonshot decode", 64, 6, MOE_LAYER, tuple(GROUPED)),
             ("moonshot prefill", 64, 24, MOE_LAYER, tuple(GROUPED)),
             ("qwen3-moe decode", 128, 8, [(4096, 1536)], ("grouped_onehot",))]
MOE_LAYERS = 4                  # of Moonshot's 48: the f32 init of all 48 is ~112 GB
MOE_ARCH = "moonshot_v1_16b_a3b"
# (label, kv heads, query rows per kv head, context tokens, page size);
# timed cases first
ATTN_CASES = [("olmo decode", 16, 1, 2048, PAGE), ("olmo prefill", 16, 16, 2048, PAGE),
              ("qwen decode", 4, 7, 2048, PAGE), ("olmo decode", 16, 1, 2048, 128),
              ("olmo decode", 16, 1, 512, PAGE), ("olmo prefill", 16, 16, 512, PAGE),
              ("qwen prefill", 4, 112, 512, PAGE)]
TIMED_CASES = 4
# K11's other timed cases (the first is phase g's live OLMo K pages): (label,
# StruMConfig keywords, pages, page size, F); 320 pages of 16 and 40 of 128
# are the live pages of phase g's 2048-token tables
DECODE_CASES = [
    ("olmo dliq", dict(method="dliq", p=0.25, q=3), 320, PAGE, 2048),
    ("qwen2-7b width", dict(method="mip2q", p=0.5, L=7), 320, PAGE, 512),
    ("olmo pages of 128", dict(method="mip2q", p=0.5, L=7), 40, 128, 2048),
    ("olmo w=64", dict(method="mip2q", w=64, p=0.5, L=7), 40, 128, 2048),
    ("olmo w=128", dict(method="mip2q", w=128, p=0.5, L=7), 40, 128, 2048)]
# (K, N) of one OLMo-1B layer's seven linears: wq wk wv wo, wi wg, mlp wo
LAYER_SHAPES = [(2048, 2048)] * 4 + [(2048, 8192)] * 2 + [(8192, 2048)]


#: phase letter -> seconds from the start of the script to the phase's start
PHASE_S: dict = {}
_T0 = time.perf_counter()


def _phase(name: str) -> None:
    PHASE_S[name[0]] = time.perf_counter() - _T0
    print(f"== {name} (t = {PHASE_S[name[0]]:.1f} s)", flush=True)


#: kernels of this slice whose ptxas report is printed entry by entry (the
#: streamed kernel of K1, K2, K3, K8, K9 and K10)
NEW_KERNELS = ("stream_kernel",)


def _ptxas_lines(log: str) -> list:
    """Registers and spills of every entry of the slice's new kernels (by
    mangled name), and for the other entries the most registers any uses
    and any that spill."""
    out, other_regs, entry = [], [], ""
    for line in log.splitlines():
        line = line.strip().replace("ptxas info    : ", "")
        if line.startswith("Compiling entry function"):
            entry = line.split("'")[1] if "'" in line else line
        elif "registers" in line or ("spill" in line and "0 bytes spill" not in line):
            if any(k in entry for k in NEW_KERNELS):
                out.append(f"ptxas {entry}: {line}")
            elif "registers" in line:
                other_regs.append(int(line.split("Used ")[1].split()[0]))
            else:
                out.append(f"ptxas {entry} spills: {line}")
    if other_regs:
        out.append(f"ptxas, the other {len(other_regs)} entries: at most "
                   f"{max(other_regs)} registers")
    return out


def _check(ok: bool, msg: str) -> None:
    """A failed check ends the run (an ``assert`` would vanish under -O)."""
    if not ok:
        raise RuntimeError(msg)


def _cuda_ms(fn, reps: int) -> float:
    """Mean time of ``fn`` in ms from CUDA events, after a warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _graphed(fn):
    """``fn`` (one call of a wrapper or a yardstick) captured in a CUDA graph
    after an eager warm-up; returns the replay.  Timed replays measure the
    device's work for the call, not the Python wrapper's launch path, which
    at tens of microseconds would otherwise be the time of a short kernel."""
    import torch
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    torch.cuda.synchronize()
    return graph.replay


def _spread(vals) -> dict:
    return {"median": statistics.median(vals), "min": min(vals), "max": max(vals)}


def _interleaved(clocks, fns, calls: int = 1):
    """Median and range of each ``fns[key] = (fn, reps)`` over ``ROUNDS``
    rounds taken in turns, so a clock that drifts across the run moves all
    alike; each time is per one of the ``calls`` units a call of fn does."""
    runs: dict = {key: [] for key in fns}
    t0 = time.perf_counter()
    for _ in range(ROUNDS):
        for key, (fn, reps) in fns.items():
            runs[key].append(_cuda_ms(fn, reps) / calls)
    spread = {key: _spread(v) for key, v in runs.items()}
    out = {key: s["median"] for key, s in spread.items()}
    out["range_ms"] = {key: [s["min"], s["max"]] for key, s in spread.items()}
    out["clock"] = clocks.window(t0, time.perf_counter())
    return out


def _bound(nbytes, flops, peak):
    """Least time: bytes over the HBM rate or operations over the peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops, "bytes_ms": t_bytes, "ops_ms": t_ops}


def _per_shape(clocks, what, items) -> dict:
    """Graph-replayed ms of one linear of each (K, N) shape, the kernel's
    and the yardstick's: ``items`` holds (shape, kernel call, yardstick
    call) for every timed linear; a shape's calls are replayed together
    and the time split evenly among them (median of ``ROUNDS``)."""
    out = {}
    for shape in dict.fromkeys(s for s, _, _ in items):
        kern = [k for s, k, _ in items if s == shape]
        lib = [y for s, _, y in items if s == shape]
        t = _interleaved(clocks, {
            "graph_ms": (_graphed(lambda: [f() for f in kern]), 20),
            "library_graph_ms": (_graphed(lambda: [f() for f in lib]), 20)},
            calls=len(kern))
        key = f"{shape[0]}x{shape[1]}"
        out[key] = {"graph_ms": t["graph_ms"], "library_graph_ms": t["library_graph_ms"]}
        print(f"    {what} {key}: one linear {t['graph_ms']:.4f} ms (graph replay), "
              f"torch.matmul bf16 {t['library_graph_ms']:.4f} ms (graph replay)", flush=True)
    return out


class Clocks:
    """The card's SM clock (MHz) and power draw (W), polled with
    ``nvidia-smi`` from a background thread until :meth:`close`, so a timed
    window can say what clock it ran at."""

    QUERY = ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader,nounits"]

    def __init__(self):
        self.samples: list = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._poll, daemon=True)
        self._thread.start()

    def _poll(self) -> None:
        while not self._stop.is_set():
            t0 = time.perf_counter()
            out = subprocess.run(self.QUERY, capture_output=True, text=True).stdout
            try:
                sm, watts = (float(v) for v in out.splitlines()[0].split(","))
                self.samples.append(((t0 + time.perf_counter()) / 2, sm, watts))
            except (IndexError, ValueError):
                pass
            self._stop.wait(0.02)

    def window(self, t0: float, t1: float) -> str:
        got = [(sm, w) for t, sm, w in self.samples if t0 <= t <= t1]
        if not got:
            return "clocks not sampled"
        sms, ws = [g[0] for g in got], [g[1] for g in got]
        return (f"SM {min(sms):.0f}-{max(sms):.0f} MHz, "
                f"{min(ws):.0f}-{max(ws):.0f} W ({len(got)} samples)")

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=30)


def _kernel_args(variant, packed):
    """(wrapper, plain, fields, kwargs) for a variant's kernel call."""
    from repro_torch.kernels import strum_matmul as K
    from repro_torch.kernels.ops import _min1
    if variant == "onehot":
        return (K.strum_matmul_onehot, K.strum_matmul_onehot_plain,
                (packed.mask, _min1(packed.hi, 1), _min1(packed.lo, 1), packed.scale),
                dict(w=packed.w, n_low=packed.n_low, q=packed.q, method=packed.method,
                     L=packed.L))
    if variant == "maskfree":
        return (K.strum_matmul_maskfree, K.strum_matmul_maskfree_plain,
                (packed.lo, packed.scale),
                dict(w=packed.w, q=packed.q, method=packed.method))
    return (K.strum_matmul_dense, K.strum_matmul_dense_plain,
            (packed.hi, packed.scale), dict(w=packed.w))


def _read_bytes(variant, packed, x) -> int:
    """Bytes the function must move: each field it reads once, x, f32 y."""
    fields = {"onehot": ("mask", "hi", "lo"), "maskfree": ("lo",),
              "dense": ("hi",)}[variant]
    payload = sum(getattr(packed, f).numel() for f in fields)
    m = x.shape[0]
    return (payload + 4 * packed.n_out + x.element_size() * m * packed.k_dim
            + 4 * m * packed.n_out)


def _twice_equal(what, fn, *args, **kw):
    """Two calls of a 2-D kernel's wrapper on the same inputs must give the
    same bits; returns the first."""
    import torch
    a, b = fn(*args, **kw), fn(*args, **kw)
    torch.cuda.synchronize()
    _check(torch.equal(a, b), f"{what}: two calls on the same inputs differ")
    return a


def _draft_twice_equal(what, x, packed) -> None:
    """K9 and K10 on a mip2q payload, each called twice: bit-identical."""
    from repro_torch.kernels import strum_matmul as K
    kw = dict(w=packed.w, n_low=packed.n_low)
    _twice_equal(f"histream {what}", K.strum_matmul_histream, x, packed.mask,
                 packed.hi, packed.scale, **kw)
    _twice_equal(f"maskfree_p {what}", K.strum_matmul_maskfree_p, x, packed.hi,
                 packed.scale, **kw)


def phase_c(dev, gen, clocks):
    """Kernels vs plain versions at OLMo-1B shapes; per-layer times; every
    2-D kernel bit-identical across two calls at every shape."""
    import torch
    from repro_torch.core.apply import pack_array
    from repro_torch.core.policy import StruMConfig
    configs = {"onehot": StruMConfig(method="mip2q", p=0.5, L=5),
               "maskfree": StruMConfig(method="dliq", p=1.0, q=4),
               "dense": StruMConfig(method="mip2q", p=0.0, L=5)}
    out = {}
    for variant, cfg in configs.items():
        # two layers of distinct weights: their payload exceeds the 50 MB L2,
        # so a timed pass reads it from HBM as a decode step does
        layers = []
        for k, n in LAYER_SHAPES * 2:
            w = torch.randn((k, n), generator=gen, device=dev)
            layers.append(pack_array(w, cfg))
            del w
        extra = [pack_array(torch.randn((2045, 2048), generator=gen, device=dev), cfg)]
        row = {"max_abs_err": 0.0}
        for m in (4, 16, 128):
            xs = {k: torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
                  for k in (2048, 8192, 2045)}
            calls = []
            for packed in layers + (extra if m == 4 else []):
                wrapper, plain, fields, kw = _kernel_args(variant, packed)
                x = xs[packed.k_dim]
                what = f"M={m} K={packed.k_dim} N={packed.n_out}"
                y = _twice_equal(f"{variant} {what}", wrapper, x, *fields, **kw)
                if variant == "onehot":
                    _draft_twice_equal(what, x, packed)
                y_plain = plain(x, *fields, **kw)
                torch.cuda.synchronize()
                err = (y - y_plain).abs().max().item()
                lim = KERNEL_TOL * y_plain.abs().max().item()
                _check(err <= lim, f"{variant} M={m} K={packed.k_dim} N={packed.n_out}: "
                       f"|kernel - plain| {err} > {lim}")
                row["max_abs_err"] = max(row["max_abs_err"], err)
                calls.append((wrapper, plain, x, fields, kw, packed))
            timed = calls[:2 * len(LAYER_SHAPES)]
            dense_w = [(x, packed_dequant(p)) for _, _, x, _, _, p in timed]
            def layer_calls():
                return [c[0](c[2], *c[3], **c[4]) for c in timed]
            def library_calls():
                return [torch.matmul(x, w) for x, w in dense_w]
            t = _interleaved(clocks, {     # two layers timed: times per layer
                "ms": (layer_calls, 20),
                "graph_ms": (_graphed(layer_calls), 20),
                "plain_ms": (lambda: [c[1](c[2], *c[3], **c[4]) for c in timed], 2),
                "library_ms": (library_calls, 20),
                "library_graph_ms": (_graphed(library_calls), 20)},
                calls=2)
            nbytes = sum(_read_bytes(variant, c[5], c[2]) for c in timed) / 2
            flops = sum(2 * m * k * n for k, n in LAYER_SHAPES)
            peak = PEAK_FLOPS[str(xs[2048].dtype)]
            row[m] = dict(t, **_bound(nbytes, flops, peak))
            print(f"  {variant:8s} M={m:3d} one layer (7 linears), median [min, max] "
                  f"of {ROUNDS} interleaved rounds: " + ", ".join(
                      f"{label} {t[key]:.4f} [{t['range_ms'][key][0]:.4f}, "
                      f"{t['range_ms'][key][1]:.4f}] ms" for key, label in
                      (("ms", "kernel"), ("graph_ms", "kernel (graph replay)"),
                       ("plain_ms", "plain"), ("library_ms", "torch.matmul bf16"),
                       ("library_graph_ms", "torch.matmul bf16 (graph replay)"))) +
                  f"; bound {row[m]['bound_ms']:.4f} ms ({row[m]['bound_by']}: "
                  f"{nbytes / 1e6:.2f} MB in {row[m]['bytes_ms']:.4f} ms, "
                  f"{flops / 1e9:.2f} GFLOP in {row[m]['ops_ms']:.4f} ms at "
                  f"{peak / 1e12:.0f} TFLOP/s); {t['clock']}", flush=True)
            if m == 4:
                row["per_shape"] = _per_shape(clocks, f"{variant:8s} M=  4", [
                    ((c[5].k_dim, c[5].n_out),
                     lambda c=c: c[0](c[2], *c[3], **c[4]),
                     lambda x=x, w=w: torch.matmul(x, w))
                    for c, (x, w) in zip(timed, dense_w)])
            del dense_w
        print(f"  {variant:8s} max |kernel - plain| {row['max_abs_err']:.3e} "
              f"(<= {KERNEL_TOL} x max|plain| at every shape); two calls bit-identical "
              f"at every shape" + (" (and K9, K10 on the same payloads)"
                                   if variant == "onehot" else ""), flush=True)
        out[variant] = row
        del layers, extra
        torch.cuda.empty_cache()
    return out


def packed_dequant(packed):
    """Dense bf16 weight of a payload: the yardstick's operand (not timed)."""
    import torch
    from repro_torch.core.packing import dequantize
    return dequantize(packed, torch.bfloat16)


def _serve(argv, variant, counts):
    from repro_torch.kernels import strum_matmul as K
    from repro_torch.launch import serve as S
    K.reset_launch_counts()
    res = S.run(argv)
    launched = dict(K.launch_counts)
    for line in S.report(res):
        print("  " + line, flush=True)
    plan = res["plan"]
    variants = set(plan.variants().values())
    _check(variants == {f"cuda:{variant}"}, f"plan selected {variants}")
    if variant == "dense":
        routes = _dense_routes(plan)
        _check(routes == {"bytes"}, f"K3's payloads route to {routes}, want the byte path")
    cfg = res["cfg"]
    steps = 1 + res["gen"] + 2     # + the untimed warm-up prefill and decode step
    want = 7 * cfg.n_layers * steps
    _check(launched[variant] == want and sum(launched.values()) == want,
           f"launches {launched}, want {want} of {variant} only")
    counts[variant] = launched[variant]
    print(f"  launches in this run: {launched} (7 linears x {cfg.n_layers} layers "
          f"x {steps} steps, 2 of them warm-up)", flush=True)
    return res


def _dense_routes(plan) -> set:
    """Where K3 / K8 run each n_low = 0 entry of a plan (``_dense_view``:
    the streamed kernel's byte path, its general path or the template)."""
    from repro_torch.kernels import strum_matmul as K
    return {K._dense_view(e.cfg.w, *e.leaf["hi"].shape[-3:-1])[0]
            for e in plan.entries.values() if e.cfg.n_low == 0}


def serve_times(res, clocks) -> dict:
    """Phase d's warm times and ``SERVE_REPEATS`` more warm serves of the
    same prompt: median and range of prefill ms and decode ms per token."""
    from repro_torch.launch import serve as S
    gen = res["gen"]
    pre, dec = [res["t_prefill"] * 1e3], [res["t_decode"] / gen * 1e3]
    same = []
    t0 = time.perf_counter()
    for _ in range(SERVE_REPEATS):
        toks, t_p, t_d = S.serve(res["cfg"], res["params"], res["prompt"], gen,
                                 device=res["device"], warmup=False)
        pre.append(t_p * 1e3)
        dec.append(t_d / gen * 1e3)
        same.append((toks == res["tokens"]).float().mean().item())
    out = {"prefill_ms": _spread(pre), "decode_ms_per_token": _spread(dec),
           "serves": len(pre), "clock": clocks.window(t0, time.perf_counter())}
    for key in ("prefill_ms", "decode_ms_per_token"):
        s = out[key]
        print(f"  {key} over {len(pre)} warm serves: median {s['median']:.3f}, "
              f"min {s['min']:.3f}, max {s['max']:.3f}", flush=True)
    # the kernels give the same bits on every call; the share is reported
    print(f"  share of tokens equal to phase d's, per repeat: {same}; "
          f"{out['clock']}", flush=True)
    return out


def phase_f(res, family="torch", gate=True, tol=0.05):
    """Phase d's decode logits vs the ``family`` backend (``torch``:
    dequantize to the activation dtype + torch.matmul; ``reference``: the
    kernels' plain oracle, f32 dequantize and product), teacher-forced;
    with ``gate`` held to ``tol`` x max|logit| and, at phase f's 5%, argmax
    agreement 0.9; at a tighter ``tol`` every argmax disagreement must be a
    near tie (``_near_ties``).  Without ``gate`` only printed."""
    import torch
    from repro_torch.launch import serve as S
    cfg, params, prompt, toks = res["cfg"], res["params"], res["prompt"], res["tokens"]
    gen = res["gen"]
    with torch.inference_mode():
        lg, caches = S.make_prefill_step(cfg, backend=family)(params, {"tokens": prompt})
        caches = S.pad_caches(caches, gen + 1)
        ref = [lg[:, -1]]
        step = S.make_decode_step(cfg, backend=family)
        for i in range(gen):
            lg, caches = step(params, toks[:, i:i + 1], caches, prompt.shape[1] + i)
            ref.append(lg[:, -1])
    ref = torch.stack(ref, dim=1)[..., :cfg.vocab_size].float()
    got = res["logits"][..., :cfg.vocab_size].float()
    _check(bool(torch.isfinite(got).all()) and got.shape == ref.shape,
           f"logits not finite or of shape {tuple(got.shape)}")
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
    print(f"  logits cuda vs {family} family ({cfg.dtype}) over {gen + 1} positions x "
          f"{got.shape[0]} rows: max|diff| {err:.4e} (max|logit| {scale:.4e}), "
          f"argmax agreement {agree:.3f}" + ("" if gate else " (printed, not held)"),
          flush=True)
    if gate:
        _check(err <= tol * scale, f"logits differ: {err} > {tol} x {scale}")
        if tol >= 0.05:
            _check(agree >= 0.9, f"argmax agreement {agree} < 0.9")
        else:
            _near_ties(ref, got, ref.argmax(-1), f"{family} family")
    _check(torch.equal(got.argmax(-1), toks), "served tokens are not the argmax")
    return {"max_abs_diff": err, "max_abs_logit": scale, "argmax_agreement": agree}


def _near_ties(ref, got, toks, what) -> list:
    """Every position where ``got``'s argmax is not ``toks`` (``ref``'s
    tokens) must be a near tie: the gap between the two tokens' ``ref``
    logits within twice the two logit rows' max |diff| there.  Returns
    (row, position, gap, max |diff|) of each such position."""
    import torch
    pred = got.argmax(-1)
    diff = (got - ref).abs().amax(-1)
    gaps = []
    for b, t in zip(*torch.nonzero(pred != toks, as_tuple=True)):
        gap = (ref[b, t, toks[b, t]] - ref[b, t, pred[b, t]]).item()
        gaps.append((int(b), int(t), gap, diff[b, t].item()))
        _check(gap <= 2 * diff[b, t].item(),
               f"{what} predicts {int(pred[b, t])} for {int(toks[b, t])} at row "
               f"{int(b)} position {int(t)}: gap {gap} > 2 x max|diff| "
               f"{diff[b, t].item()}")
    return gaps


# ------------------------------------------------- packed KV pages (g-j) --

def _pool(dev, gen, cfg, n_pages, f, ps):
    """A pool of ``n_pages`` random pages of ``ps`` positions encoded with
    ``cfg``, with empty fields floored at one row as the registry's
    variants do."""
    import torch
    from repro_torch.engine.cache import encode_page
    from repro_torch.kernels.ops import _min1
    enc = encode_page(torch.randn((n_pages, ps, f), generator=gen, device=dev), cfg)
    return {k: v if k == "scale" else _min1(v, 2).contiguous() for k, v in enc.items()}


def _kv_pools(dev, gen, cfg, n_pages, f, ps):
    """K and V pools (``_pool``)."""
    return [_pool(dev, gen, cfg, n_pages, f, ps) for _ in range(2)]


def _attn_table(dev, pages_per_slot):
    """Slot 0 and 3 full, slot 1 empty, slot 2 with its second half -1."""
    import torch
    p = pages_per_slot
    ids = torch.arange(4 * p, dtype=torch.int32).reshape(4, p)
    ids[1] = -1
    ids[2, p // 2:] = -1
    n_valid = torch.tensor([p, 0, p, p], dtype=torch.int32)
    return ids.to(dev), n_valid.to(dev)


def _kv_args(name, k, v):
    fields = ("lo", "scale") if name == "paged_attention_maskfree" else \
        ("mask", "hi", "lo", "scale")
    return [k[f] for f in fields] + [v[f] for f in fields]


def _page_bytes(pool, fields) -> int:
    """Packed bytes (and scale bytes) of one page of one pool."""
    return sum(pool[f][0].numel() * pool[f].element_size() for f in fields)


def _held(got, want, what) -> dict:
    """Hold a partial (acc, m, l) to its plain version.  Rows with a live
    page (plain l > 0) hold acc, m, l and the output acc / l, each to
    KERNEL_TOL x its own largest |plain| there + 1e-6; the other rows must
    be the identity partial (m = -1e30, l = 0, acc = 0) exactly.  Returns
    each one's max |kernel - plain| over the live rows."""
    import torch
    (acc, m, l), (acc_p, m_p, l_p) = got, want
    live = l_p > 0
    _check(bool(torch.equal(l > 0, live)) and bool(live.any()),
           f"{what}: kernel and plain disagree on which rows are live")
    dead = ~live
    _check(bool((m[dead] == -1e30).all()) and not bool(l[dead].any())
           and not bool(acc[dead].any()), f"{what}: a row with nothing live is not "
           "the identity partial")
    errs = {}
    for key, a, b in (("acc", acc, acc_p), ("m", m, m_p), ("l", l, l_p),
                      ("out", acc / l[..., None], acc_p / l_p[..., None])):
        a, b = a[live], b[live]
        err = (a - b).abs().max().item()
        lim = KERNEL_TOL * b.abs().max().item() + 1e-6
        _check(err <= lim, f"{what}: {key} |kernel - plain| {err} > {lim} on live rows")
        errs[key] = err
    return errs


def phase_g(dev, gen, clocks):
    """K4, K5, K11 against their plain versions; timings of the first
    ``TIMED_CASES`` cases, of K11 on the live K pages of the first and of
    K11's ``DECODE_CASES``."""
    import torch
    from repro_torch.core.policy import StruMConfig
    from repro_torch.kernels import strum_attention as A
    codecs = {"paged_attention": StruMConfig(method="mip2q", p=0.5, L=7),
              "paged_attention_maskfree": StruMConfig(method="dliq", p=1.0, q=4)}
    wrappers = {"paged_attention": (A.strum_paged_attention,
                                    A.strum_paged_attention_plain),
                "paged_attention_maskfree": (A.strum_paged_attention_maskfree,
                                             A.strum_paged_attention_maskfree_plain)}
    rows = {name: {"max_abs_err": 0.0, "cases": []} for name in
            ("paged_attention", "paged_attention_maskfree", "page_decode")}
    for i, (label, kv, r, ctx, ps) in enumerate(ATTN_CASES):
        hd, p_slot = 128, ctx // ps
        f = kv * hd
        ids, n_valid = _attn_table(dev, p_slot)
        live = int(((ids >= 0) & (torch.arange(p_slot, device=dev)[None, :]
                                  < n_valid[:, None])).sum())
        q4 = (torch.randn((4, kv, r, hd), generator=gen, device=dev) / hd ** 0.5).contiguous()
        for name, cfg in codecs.items():
            kern, plain = wrappers[name]
            kw = dict(w=cfg.w, q=cfg.q, method=cfg.method)
            if name == "paged_attention":
                kw["n_low"] = cfg.n_low
            k, v = _kv_pools(dev, gen, cfg, 4 * p_slot, f, ps)
            args = _kv_args(name, k, v)
            got = kern(q4, *args, ids, n_valid, **kw)
            want = plain(q4, *args, ids, n_valid, **kw)
            torch.cuda.synchronize()
            errs = _held(got, want, f"{name} {label} ctx {ctx}")
            err = max(errs.values())
            rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], err)
            case = {"case": f"{label}, {kv} kv heads x {hd}, R={r}, context {ctx}, "
                            f"{live} live pages of {ps}", "max_abs_err": err,
                    "errs": errs}
            tiles = -(-r // A._row_tile(r, hd))
            pps = A.split_pages(4, p_slot, kv * tiles, torch.cuda.get_device_properties(
                dev).multi_processor_count)
            case["case"] += f", {-(-p_slot // pps)} KV splits of {pps} page slots + combine"
            if i < TIMED_CASES:
                case.update(_time_attention(clocks, name, kern, plain, q4, args, ids,
                                            n_valid, kw, k, v, live, r, hd, kv, ps))
                if i == 0 and name == "paged_attention":
                    sel = ids[(ids >= 0) & (torch.arange(p_slot, device=dev)[None, :]
                                            < n_valid[:, None])].long()
                    rows["page_decode"]["cases"].append(_time_page_decode(
                        clocks, {f_: t[sel].contiguous() for f_, t in k.items()}, cfg,
                        f"{live} live K pages of OLMo decode (2048 ctx), mip2q p=0.5 L=7 "
                        f"-> ({live}, {ps}, {f}) f32"))
            rows[name]["cases"].append(case)
            print(f"  {name:24s} {case['case']}: max |kernel - plain| on live rows "
                  + ", ".join(f"{k_} {e:.3e}" for k_, e in errs.items())
                  + (f"; kernel {case['ms']:.4f} ms (graph replay; eager call "
                     f"{case['eager_ms']:.4f}), plain {case['plain_ms']:.4f}, "
                     f"sdpa bf16 {case['library_ms']:.4f}, bound {case['bound_ms']:.4f} "
                     f"({case['bound_by']}, {case['bytes'] / 1e6:.2f} MB); {case['clock']}"
                     if "ms" in case else ""), flush=True)
            del k, v, args, got, want
        torch.cuda.empty_cache()
    for label, cfg_kw, n_pages, ps, f in DECODE_CASES:
        cfg = StruMConfig(**cfg_kw)
        rows["page_decode"]["cases"].append(_time_page_decode(
            clocks, _pool(dev, gen, cfg, n_pages, f, ps), cfg,
            f"{label}: {n_pages} pages of {ps}, w={cfg.w}, {cfg.method} p={cfg.p} "
            f"q={cfg.q} -> ({n_pages}, {ps}, {f}) f32"))
        torch.cuda.empty_cache()
    for d in rows["page_decode"]["cases"]:
        print(f"  page_decode              {d['case']}: exact; kernel {d['ms']:.4f} ms "
              f"(graph replay; eager call {d['eager_ms']:.4f}), plain "
              f"{d['plain_ms']:.4f}, fill_ of the output "
              f"{d['fill_ms']:.4f} (a write-rate reference, not a yardstick), bound "
              f"{d['bound_ms']:.4f} ({d['bound_by']}, {d['bytes'] / 1e6:.2f} MB, "
              f"{d['bytes'] / d['ms'] / 1e9:.2f} TB/s); {d['clock']}", flush=True)
    return rows


def _time_attention(clocks, name, kern, plain, q4, args, ids, n_valid, kw, k, v,
                    live, r, hd, kv, ps):
    """Kernel, plain version and the SDPA yardstick in turns; the bound from
    the bytes this data needs (live pages' fields and scales, q, outputs)
    and its f32 operations (QK^T and PV over the live keys)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.strum_decode import decode_lo_pages, strum_page_decode_plain
    b, p_slot = ids.shape
    fields = ("lo",) if name == "paged_attention_maskfree" else ("mask", "hi", "lo")

    def dense(pool):        # (B, KV, S, hd) bf16 values of each slot's pages
        g = {f_: t[ids.clamp(min=0).long().reshape(-1)] for f_, t in pool.items()}
        if name == "paged_attention_maskfree":
            vals = decode_lo_pages(g["lo"], g["scale"], w=kw["w"], q=kw["q"],
                                   method=kw["method"])
        else:
            vals = strum_page_decode_plain(g["mask"], g["hi"], g["lo"], g["scale"], **kw)
        return vals.reshape(b, p_slot * ps, kv, hd).transpose(1, 2).to(
            torch.bfloat16).contiguous()
    kd, vd = dense(k), dense(v)
    pos = torch.arange(p_slot * ps, device=ids.device)
    valid = (ids[:, pos // ps] >= 0) & (pos[None, :] < (n_valid[:, None] * ps))
    mask = valid[:, None, None, :]
    qb = q4.to(torch.bfloat16)

    def call():
        return kern(q4, *args, ids, n_valid, **kw)
    times = _interleaved(clocks, {
        "ms": (_graphed(call), 20),
        "eager_ms": (call, 20),
        "plain_ms": (lambda: plain(q4, *args, ids, n_valid, **kw), 1),
        "library_ms": (_graphed(lambda: F.scaled_dot_product_attention(
            qb, kd, vd, attn_mask=mask, scale=1.0)), 20)})
    page = sum(_page_bytes(pool, fields + ("scale",)) for pool in (k, v))
    nbytes = (live * page + q4.numel() * 4 + (q4.numel() + 2 * b * kv * r) * 4
              + ids.numel() * 4 + n_valid.numel() * 4)
    flops = 4 * live * ps * kv * r * hd
    return dict(times, **_bound(nbytes, flops, PEAK_FLOPS["torch.float32"]))


def _time_page_decode(clocks, pool, cfg, label):
    """K11 on one pool's pages against its plain version, bit for bit; the
    kernel graph-replayed and eager, the plain version, and a graph-replayed
    ``fill_`` of the same f32 output as the card's write rate (a reference,
    not a one-call yardstick: no PyTorch call decodes the pages).  The bound
    counts the fields and scales read once and the f32 values written once."""
    import torch
    from repro_torch.kernels import strum_decode as D
    kw = dict(w=cfg.w, n_low=cfg.n_low, q=cfg.q, method=cfg.method)
    fields = [pool[f_] for f_ in ("mask", "hi", "lo", "scale")]
    want = D.strum_page_decode_plain(*fields, **kw)
    got = D.strum_page_decode(*fields, **kw)
    torch.cuda.synchronize()
    _check(torch.equal(got, want), f"page_decode differs from its plain version: {label}")
    out = torch.empty_like(want)
    times = _interleaved(clocks, {
        "ms": (_graphed(lambda: D.strum_page_decode(*fields, **kw)), 20),
        "eager_ms": (lambda: D.strum_page_decode(*fields, **kw), 20),
        "fill_ms": (_graphed(lambda: out.fill_(0.0)), 20),
        "plain_ms": (lambda: D.strum_page_decode_plain(*fields, **kw), 5)})
    nbytes = sum(t.numel() * t.element_size() for t in fields) + want.numel() * 4
    return dict(times, library_ms=None, max_abs_err=0.0, case=label,
                **_bound(nbytes, 0, PEAK_FLOPS["torch.float32"]))


def _reset_kv_counts():
    from repro_torch.kernels import strum_attention as A
    from repro_torch.kernels import strum_decode as D
    from repro_torch.kernels import strum_matmul as K
    for mod in (A, D, K):
        mod.reset_launch_counts()


def _kv_counts() -> dict:
    from repro_torch.kernels import strum_attention as A
    from repro_torch.kernels import strum_decode as D
    from repro_torch.kernels import strum_matmul as K
    return dict(A.launch_counts, **D.launch_counts, **K.launch_counts)


def _check_combine(launched) -> None:
    """K4's (K5's) combine runs once per K4 (K5) call whose table splits: at
    most once per launch of its kernel, and at least once on a path that
    launched it."""
    for name in ("paged_attention", "paged_attention_maskfree"):
        kern, comb = launched[name], launched[f"{name}_combine"]
        _check(comb <= kern and (kern == 0 or comb > 0),
               f"{name} combine launches {comb} against {kern} launches")


def _want_combines(sched, runs_by_slots, layers) -> int:
    """The combine launches a paged run must make, exactly: one per K4 / K5
    call whose table splits, by the wrapper's own rule (``split_pages``) on
    each call's shape.  ``runs_by_slots``: {slots: lane_runs} of the
    schedulers that ran, all of ``sched``'s page geometry; a decode tick is
    one call over every slot with ``rep`` query rows per kv head, a prefill
    chunk one call over one slot with ``chunk x rep`` rows."""
    import torch
    from repro_torch.kernels import strum_attention as A
    cfg = sched.cfg
    p, hd, kv = sched.pages_per_seq, cfg.hd, cfg.n_kv_heads
    rep = cfg.n_heads // kv
    sms = torch.cuda.get_device_properties(sched.device).multi_processor_count

    def splits(b, r):
        heads = kv * -(-r // A._row_tile(r, hd))
        return -(-p // A.split_pages(b, p, heads, sms))
    calls = 0
    for slots, runs in runs_by_slots.items():
        _check(runs.get("draft", 0) == runs.get("verify", 0) == 0,
               f"no rule here for draft / verify lanes: {runs}")
        calls += runs["decode"] * (splits(slots, rep) > 1)
        calls += runs["prefill_chunk"] * (splits(1, sched.prefill_chunk * rep) > 1)
    return layers * calls


def phase_h(counts):
    """Full-width OLMo-1B through the paged runtime with mip2q KV pages."""
    from repro_torch.launch import serve as S
    _reset_kv_counts()
    res = S.run(["--arch", "olmo_1b", "--seed", "0", "--paged", "--kv-cache", "mip2q",
                 "--prompt-len", "128", "--gen", "32"])
    launched = _kv_counts()
    for line in S.report(res):
        print("  " + line, flush=True)
    sched, cfg = res["sched"], res["cfg"]
    _check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.d_ff, cfg.vocab_size) ==
           (16, 2048, 16, 8192, 50304), f"not full-width OLMo-1B: {cfg}")
    _check((sched.spec.variant, sched.spec.attn_variant) ==
           ("cache:cuda_decode", "cache:attn_fused"),
           f"paged serve selected {sched.spec.variant}, {sched.spec.attn_variant}")
    runs = res["lane_runs"]
    lane = runs["decode"] + runs["prefill_chunk"]
    _check(launched["paged_attention"] == cfg.n_layers * lane,
           f"K4 launches {launched['paged_attention']}, want {cfg.n_layers} layers x "
           f"{lane} lane runs ({runs})")
    _check(launched["onehot"] == 7 * cfg.n_layers * lane,
           f"K1 launches {launched['onehot']}, want 7 x {cfg.n_layers} x {lane}")
    _check(launched["paged_attention_maskfree"] == launched["page_decode"] ==
           launched["paged_attention_maskfree_combine"] == 0,
           f"phase h launched K5, its combine or K11: {launched}")
    _check_combine(launched)
    counts["paged_attention_combine"] = launched["paged_attention_combine"]
    st = sched.cache_stats()
    _check(st["ratio_vs_int8"] == 0.875 and
           st["resident_page_bytes"] == st["expected_page_bytes"],
           f"packed pages x{st['ratio_vs_int8']} of int8, want x0.875 ({st})")
    outs = [r.output for r in res["requests"]]
    _check(len(outs) == 4 and all(len(o) == 33 for o in outs),
           f"requests came back with {[len(o) for o in outs]} tokens")
    counts["paged_attention"] = launched["paged_attention"]
    dec = sorted(ms for kind, ms in res["ticks"] if kind == "decode")
    print(f"  launches: {launched}; K4 = {cfg.n_layers} layers x {lane} lane runs "
          f"{runs} (one request of them the warm-up)", flush=True)
    return {"drain_ms": res["drain_s"] * 1e3, "ticks": len(res["ticks"]),
            "decode_tick_ms": _spread(dec), "decode_ticks": len(dec),
            "lane_runs": runs, "ratio_vs_int8": st["ratio_vs_int8"],
            "resident_page_bytes": st["resident_page_bytes"]}, res


def phase_i(dev, counts):
    """2 layers, full width, dliq p=1 q=4 pages: K5 and its combine, exact;
    then pages of 128 positions through the serve entry point: K4."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.core.policy import StruMConfig
    from repro_torch.launch import serve as S
    from repro_torch.launch.steps import build_serving_plan
    from repro_torch.models import model_defs
    from repro_torch.models.params import init_params
    from repro_torch.serving import BatchScheduler, Request
    cfg = dataclasses.replace(get_config("olmo_1b"), n_layers=2, strum=StruMConfig())
    params = init_params(model_defs(cfg), seed=1, device=dev, dtype_override="float32")
    plan = build_serving_plan(params, cfg=cfg.strum, device=dev)
    del params
    sched = BatchScheduler(cfg, None, n_slots=4, max_len=64 + 9 + PAGE, plan=plan,
                           kv_cache=StruMConfig(method="dliq", p=1.0, q=4), device=dev)
    _check(sched.spec.attn_variant == "cache:attn_fused_maskfree",
           f"dliq p=1 pages selected {sched.spec.attn_variant}")
    gen = torch.Generator().manual_seed(1)
    for i in range(4):
        sched.submit(Request(uid=i, prompt=torch.randint(0, cfg.vocab_size, (64,),
                                                         generator=gen),
                             max_new_tokens=9))
    _reset_kv_counts()
    done = sched.run_to_completion()
    launched = _kv_counts()
    lane = sched.lane_runs["decode"] + sched.lane_runs["prefill_chunk"]
    want_comb = _want_combines(sched, {4: sched.lane_runs}, 2)
    _check(len(done) == 4 and launched["paged_attention_maskfree"] == 2 * lane
           and launched["paged_attention_maskfree_combine"] == want_comb
           and launched["paged_attention"] == launched["paged_attention_combine"] == 0,
           f"K5 launches {launched}, want 2 layers x {lane} lane runs, {want_comb} "
           "combines, no K4")
    for key in ("paged_attention_maskfree", "paged_attention_maskfree_combine"):
        counts[key] = launched[key]
    st = sched.cache_stats()
    print(f"  {sched.spec.attn_variant}: launches {launched} (2 layers x {lane} lane "
          f"runs {sched.lane_runs}; combine {want_comb} = one per call whose table "
          f"splits); pages x{st['ratio_vs_int8']:.4f} of int8", flush=True)
    del sched, plan
    torch.cuda.empty_cache()

    # pages of 128 positions (8 blocks of 16: two 64-position pieces a page)
    _reset_kv_counts()
    res = S.run(["--arch", "olmo_1b", "--layers", "2", "--seed", "0", "--paged",
                 "--kv-cache", "mip2q", "--page-size", "128", "--prompt-len", "256",
                 "--gen", "8"])
    launched = _kv_counts()
    for line in S.report(res):
        print("  " + line, flush=True)
    sched, runs = res["sched"], res["lane_runs"]
    _check(sched.spec.page_size == 128 and sched.spec.attn_variant == "cache:attn_fused",
           f"pages of {sched.spec.page_size} selected {sched.spec.attn_variant}")
    lane = runs["decode"] + runs["prefill_chunk"]
    warm = {k: runs[k] - sched.lane_runs[k] for k in runs}
    want_comb = _want_combines(sched, {1: warm, 4: sched.lane_runs}, 2)
    _check(launched["paged_attention"] == 2 * lane and
           launched["paged_attention_combine"] == want_comb and
           launched["paged_attention_maskfree"] == 0,
           f"page-128 launches {launched}, want K4 = 2 layers x {lane} lane runs "
           f"({runs}), {want_comb} combines")
    outs = [r.output for r in res["requests"]]
    _check(len(outs) == 4 and all(len(o) == 9 for o in outs),
           f"page-128 requests came back with {[len(o) for o in outs]} tokens")
    sealed = int((sched.pools["pos0"]["k"]["scale"][0, :, 0].abs().amax(-1) > 0).sum())
    _check(sealed > 0, "page-128 run sealed no page: K4 never read one")
    counts["page_128"] = {"paged_attention": launched["paged_attention"],
                          "paged_attention_combine": launched["paged_attention_combine"],
                          "sealed_pages": sealed, "lane_runs": runs}
    print(f"  pages of 128: {sched.spec.attn_variant}, launches {launched} (2 layers x "
          f"{lane} lane runs {runs}; combine {want_comb}); {sealed} pages sealed; 4 "
          f"requests served to completion", flush=True)


def _recorded(sched, vocab):
    """Wrap the scheduler's lanes to keep each request's logits in the order
    its tokens come out (prefill's first token, chunked or serial, then
    every decode tick)."""
    rec: dict = {}
    decode, chunk, serial = sched._decode, sched._chunk_prefill, sched._prefill

    def dec(params, token, pools, hot, cache_len, table, active):
        lg, hot = decode(params, token, pools, hot, cache_len, table, active)
        for s in active.nonzero().flatten().tolist():
            rec.setdefault(sched.slots[s].req.uid, []).append(lg[s, -1, :vocab])
        return lg, hot

    def chk(params, toks, pools, hot, table, slot, start, valid):
        out = chunk(params, toks, pools, hot, table, slot, start, valid)
        sl = sched.slots[int(slot)]
        if int(start) + int(valid) >= sl.req.prompt.shape[0]:
            rec.setdefault(sl.req.uid, []).append(out[0][0, int(valid) - 1, :vocab])
        return out

    def ser(params, batch):
        lg, caches = serial(params, batch)
        [sl] = [s for s in sched.slots if s is not None and s.state == "prefill"
                and s.len == 0]
        rec.setdefault(sl.req.uid, []).append(lg[0, -1, :vocab])
        return lg, caches
    sched._decode, sched._chunk_prefill, sched._prefill = dec, chk, ser
    return rec


def phase_j(dev, res, counts):
    """K11 on every sealed page of phase h; phase h's requests teacher-forced
    through the cuda and the torch family."""
    import torch
    from repro_torch.engine.cache import decode_pages, gather_decode_pages
    sched, cfg = res["sched"], res["cfg"]
    spec = sched.spec
    pools = sched.pools["pos0"]
    sealed = (pools["k"]["scale"][0, :, 0].abs().amax(-1) > 0).nonzero().flatten()
    _reset_kv_counts()
    decoded = []
    for g in range(cfg.n_layers):
        for name in ("k", "v"):
            pool = {f: t[g] for f, t in pools[name].items()}
            decoded.append((pool, gather_decode_pages(pool, sealed, spec)))
    launched = _kv_counts()
    _check(launched["page_decode"] == 2 * cfg.n_layers,
           f"K11 launches {launched}, want {2 * cfg.n_layers}")
    counts["page_decode"] = launched["page_decode"]
    for pool, got in decoded:
        gathered = {f: t[sealed] for f, t in pool.items()}
        want = decode_pages(gathered, spec, backend="torch")
        _check(torch.equal(got, want), "K11 differs from the plain decode")
    print(f"  K11 decoded {sealed.numel()} sealed pages x {cfg.n_layers} layers x "
          f"K, V in {launched['page_decode']} launches; equal to the plain decode "
          f"bit for bit", flush=True)
    del decoded
    return _paged_vs_torch(dev, res)


def _paged_vs_torch(dev, res, schedule=None):
    """A paged serve's requests, teacher-forced on its tokens, through the
    cuda family (its own plan) and the torch family (weights and cache;
    the weights packed by ``schedule`` where given, else by ``cfg.strum``),
    logits held to phase f's tolerance."""
    import torch
    from repro_torch.launch.steps import build_serving_plan
    from repro_torch.models import model_defs
    from repro_torch.models.params import init_params
    from repro_torch.serving import BatchScheduler, Request
    sched, cfg = res["sched"], res["cfg"]
    spec = sched.spec
    params = init_params(model_defs(cfg), seed=0, device=dev, dtype_override="float32")
    torch_plan = build_serving_plan(params, schedule=schedule, cfg=cfg.strum,
                                    backend="torch", device=dev)
    del params
    logits = {}
    for family, plan, backend in (("cuda", res["plan"], None),
                                  ("torch", torch_plan, "torch")):
        s2 = BatchScheduler(cfg, None, n_slots=sched.n_slots, max_len=sched.max_len,
                            plan=plan, kv_cache=spec.cfg, page_size=spec.page_size,
                            cache_backend=backend, device=dev)
        rec = _recorded(s2, cfg.vocab_size)
        for r in res["requests"]:
            s2.submit(Request(uid=r.uid, prompt=res["prompt"][r.uid].cpu(),
                              max_new_tokens=len(r.output), force_tokens=r.output))
        with torch.inference_mode():
            s2.run_to_completion()
        logits[family] = torch.stack([torch.stack(rec[r.uid]) for r in res["requests"]])
        if family == "torch":
            _check(s2.spec.attn_variant == "cache:attn_unfused" and
                   s2.spec.variant == "cache:torch_dequant", f"torch family {s2.spec}")
    del torch_plan
    got, ref = logits["cuda"].float(), logits["torch"].float()
    toks = torch.tensor([r.output for r in res["requests"]], device=got.device)
    _check(bool(torch.isfinite(got).all()) and got.shape == ref.shape,
           f"logits not finite or of shape {tuple(got.shape)}")
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
    same = (got.argmax(-1) == toks).float().mean().item()
    print(f"  paged logits cuda vs torch family, teacher-forced on the served tokens, "
          f"{got.shape[1]} positions x {got.shape[0]} requests: max|diff| {err:.4e} "
          f"(max|logit| {scale:.4e}), argmax agreement {agree:.3f}; cuda argmax = "
          f"served tokens at {same:.3f} of positions", flush=True)
    _check(err <= 0.05 * scale, f"paged logits differ: {err} > 0.05 x {scale}")
    _check(agree >= 0.9, f"paged argmax agreement {agree} < 0.9")
    return {"max_abs_diff": err, "max_abs_logit": scale, "argmax_agreement": agree,
            "tokens_equal_share": same, "cuda_logits": got}


# ----------------------------------------------------- grouped MoE (k-m) --

def _grouped_args(name, packed, cfg):
    """(wrapper, plain, fields, kwargs) of a grouped kernel's call on a
    stacked payload (fields (G, nb, rows, N), scale (G, 1, N))."""
    from repro_torch.kernels import strum_matmul as K
    from repro_torch.kernels.ops import _min1
    if name == "grouped_onehot":
        return (K.strum_matmul_grouped_onehot, K.strum_matmul_grouped_onehot_plain,
                (packed["mask"], _min1(packed["hi"], 2), _min1(packed["lo"], 2),
                 packed["scale"]), dict(w=cfg.w, n_low=cfg.n_low, q=cfg.q,
                                        method=cfg.method))
    if name == "grouped_maskfree":
        return (K.strum_matmul_grouped_maskfree, K.strum_matmul_grouped_maskfree_plain,
                (packed["lo"], packed["scale"]), dict(w=cfg.w, q=cfg.q,
                                                      method=cfg.method))
    return (K.strum_matmul_grouped_dense, K.strum_matmul_grouped_dense_plain,
            (packed["hi"], packed["scale"]), dict(w=cfg.w))


def phase_k(dev, gen, clocks):
    """K6-K8 against their plain versions at MoE expert shapes; per-layer
    times with the bf16 ``torch.bmm`` yardstick."""
    import torch
    from repro_torch.core.policy import StruMConfig
    from repro_torch.engine.dispatch import dequant_leaf
    from repro_torch.models.quantize import _pack_leaf
    configs = {"grouped_onehot": StruMConfig(method="mip2q", p=0.5, L=5),
               "grouped_maskfree": StruMConfig(method="dliq", p=1.0, q=4),
               "grouped_dense": StruMConfig(method="mip2q", p=0.0, L=5)}
    rows = {name: {"max_abs_err": 0.0, "cases": []} for name in GROUPED}
    for label, g, c, shapes, names in MOE_CASES:
        for name in names:
            cfg = configs[name]
            calls = []
            for k, n in shapes:
                w = torch.randn((g, k, n), generator=gen, device=dev)
                packed = _pack_leaf(w, cfg)
                del w
                wrapper, plain, fields, kw = _grouped_args(name, packed, cfg)
                x = torch.randn((g, c, k), generator=gen, device=dev).to(torch.bfloat16)
                y = wrapper(x, *fields, **kw)
                y_plain = plain(x, *fields, **kw)
                torch.cuda.synchronize()
                err = (y - y_plain).abs().max().item()
                lim = KERNEL_TOL * y_plain.abs().max().item()
                _check(err <= lim, f"{name} {label} G={g} C={c} K={k} N={n}: "
                       f"|kernel - plain| {err} > {lim}")
                rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], err)
                wd = dequant_leaf(packed, torch.bfloat16, cfg=cfg, k_dim=k)
                calls.append((wrapper, plain, x, fields, kw, packed, wd, err, lim))
                del y, y_plain
            def layer():
                return [cl[0](cl[2], *cl[3], **cl[4]) for cl in calls]
            t = _interleaved(clocks, {
                "ms": (_graphed(layer), 10),
                "eager_ms": (layer, 10),
                "plain_ms": (lambda: [cl[1](cl[2], *cl[3], **cl[4]) for cl in calls], 1),
                "library_ms": (_graphed(lambda: [torch.bmm(cl[2], cl[6]) for cl in calls]),
                               10)})
            read = {"grouped_onehot": ("mask", "hi", "lo"), "grouped_maskfree": ("lo",),
                    "grouped_dense": ("hi",)}[name]
            nbytes = sum(sum(cl[5][f].numel() for f in read) + 4 * g * n
                         + cl[2].numel() * cl[2].element_size() + 4 * g * c * n
                         for cl, (k, n) in zip(calls, shapes))
            flops = sum(2 * g * c * k * n for k, n in shapes)
            case = dict(t, **_bound(nbytes, flops, PEAK_FLOPS["torch.bfloat16"]))
            case.update(case=f"{label}: {g} experts x capacity {c}, "
                             f"{' + '.join(f'{k}->{n}' for k, n in shapes)}, bf16 x, "
                             f"{cfg.method} p={cfg.p}",
                        max_abs_err=max(cl[7] for cl in calls),
                        limit=max(cl[8] for cl in calls))
            rows[name]["cases"].append(case)
            print(f"  {name:17s} {case['case']}: max |kernel - plain| "
                  f"{case['max_abs_err']:.3e} (limit {case['limit']:.3e}); median [min, "
                  f"max] of {ROUNDS} interleaved rounds: " + ", ".join(
                      f"{lab} {t[key]:.4f} [{t['range_ms'][key][0]:.4f}, "
                      f"{t['range_ms'][key][1]:.4f}] ms" for key, lab in
                      (("ms", "kernel (graph replay)"), ("eager_ms", "eager calls"),
                       ("plain_ms", "plain"), ("library_ms", "torch.bmm bf16"))) +
                  f"; bound {case['bound_ms']:.4f} ms ({case['bound_by']}: "
                  f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.2f} GFLOP); {t['clock']}",
                  flush=True)
            del calls
            torch.cuda.empty_cache()
    for name in ("grouped_onehot", "grouped_maskfree", "grouped_dense"):
        routed = _routed_case(dev, gen, clocks, configs[name], name)
        full = rows[name]["cases"][0]          # all 64 experts live, capacity 6
        _check(routed["ms"] < full["ms"], f"{name}: routed decode {routed['ms']} ms is "
               f"not below the all-live {full['ms']} ms")
        print(f"  {name:17s} routed decode {routed['ms']:.4f} ms against all-live "
              f"{full['ms']:.4f} ms ({routed['ms'] / full['ms']:.3f})", flush=True)
        rows[name]["cases"].append(routed)
    return rows


def _routed_case(dev, gen, clocks, cfg, name):
    """K6 (or K7, K8: ``name``) at a routed Moonshot decode: the port's own
    ``_route`` on 4 tokens at top-6 gives each expert's filled slots
    (``rows``, <= 24 of 64 live), x is zero past each count; kernel and
    plain version take ``rows``, the
    bound counts only the live experts' bytes and rows, and the bf16
    ``torch.bmm`` yardstick stays over all 64 stacks (the one call that
    computes the same function)."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.engine.dispatch import dequant_leaf
    from repro_torch.models import moe
    from repro_torch.models.quantize import _pack_leaf
    mcfg = get_config(MOE_ARCH)
    g, d = mcfg.n_experts, mcfg.d_model
    tokens = 4
    c = moe._capacity(tokens, mcfg)
    route = moe._route(torch.randn((tokens, d), generator=gen, device=dev),
                       torch.randn((d, g), generator=gen, device=dev) / d ** 0.5, mcfg,
                       0, g, c)
    counts = torch.zeros(g, dtype=torch.int32, device=dev).index_add_(
        0, route["exp"], route["keep"].to(torch.int32))
    n_live = int((counts > 0).sum())
    _check(0 < n_live <= tokens * mcfg.top_k and int(counts.sum()) == tokens * mcfg.top_k,
           f"routed case: {n_live} live experts, counts {counts.tolist()}")
    live_rows = torch.arange(c, device=dev)[None, :] < counts[:, None].long()
    wrapper, plain = None, None
    calls = []
    for k, n in MOE_LAYER:
        w = torch.randn((g, k, n), generator=gen, device=dev)
        packed = _pack_leaf(w, cfg)
        del w
        wrapper, plain, fields, kw = _grouped_args(name, packed, cfg)
        x = torch.where(live_rows[..., None],
                        torch.randn((g, c, k), generator=gen, device=dev), 0.0
                        ).to(torch.bfloat16)
        y = wrapper(x, *fields, rows=counts, **kw)
        y_plain = plain(x, *fields, rows=counts, **kw)
        torch.cuda.synchronize()
        err = (y - y_plain).abs().max().item()
        lim = KERNEL_TOL * y_plain.abs().max().item()
        _check(err <= lim, f"{name} routed K={k} N={n}: |kernel - plain| "
               f"{err} > {lim}")
        _check(not bool(y[~live_rows].any()), "routed case: rows past the count not 0")
        wd = dequant_leaf(packed, torch.bfloat16, cfg=cfg, k_dim=k)
        calls.append((x, fields, kw, packed, wd, err, lim))
    def layer():
        return [wrapper(cl[0], *cl[1], rows=counts, **cl[2]) for cl in calls]
    t = _interleaved(clocks, {
        "ms": (_graphed(layer), 10),
        "eager_ms": (layer, 10),
        "plain_ms": (lambda: [plain(cl[0], *cl[1], rows=counts, **cl[2])
                              for cl in calls], 1),
        "library_ms": (_graphed(lambda: [torch.bmm(cl[0], cl[4]) for cl in calls]), 10)})
    live = counts > 0
    rows_live = int(counts.sum())
    read = {"grouped_onehot": ("mask", "hi", "lo"), "grouped_maskfree": ("lo",),
            "grouped_dense": ("hi",)}[name]
    nbytes = sum(sum(cl[3][f][live].numel() for f in read)
                 + 4 * n_live * n + 2 * rows_live * k + 4 * g * c * n
                 for cl, (k, n) in zip(calls, MOE_LAYER))
    flops = sum(2 * rows_live * k * n for k, n in MOE_LAYER)
    case = dict(t, **_bound(nbytes, flops, PEAK_FLOPS["torch.bfloat16"]))
    case.update(case=f"moonshot routed decode: {tokens} tokens top-{mcfg.top_k} -> "
                     f"{n_live} of {g} experts live ({rows_live} rows, capacity {c}), "
                     f"{' + '.join(f'{k}->{n}' for k, n in MOE_LAYER)}, bf16 x, "
                     f"{cfg.method} p={cfg.p}, rows passed",
                max_abs_err=max(cl[5] for cl in calls), limit=max(cl[6] for cl in calls),
                live_experts=n_live)
    print(f"  {name:17s} {case['case']}: max |kernel - plain| "
          f"{case['max_abs_err']:.3e} (limit {case['limit']:.3e}); rows past each count "
          f"exactly 0; median [min, max] of {ROUNDS} interleaved rounds: " + ", ".join(
              f"{lab} {t[key]:.4f} [{t['range_ms'][key][0]:.4f}, "
              f"{t['range_ms'][key][1]:.4f}] ms" for key, lab in
              (("ms", "kernel (graph replay)"), ("eager_ms", "eager calls"),
               ("plain_ms", "plain"), ("library_ms", "torch.bmm bf16 (all 64 stacks)"))) +
          f"; bound {case['bound_ms']:.4f} ms ({case['bound_by']}: live experts "
          f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP); {t['clock']}", flush=True)
    del calls
    torch.cuda.empty_cache()
    return case


def _moe_plan_bytes(plan):
    """(packed payload bytes, int8 bytes) of a plan's entries."""
    import math
    payload = plan.summary()["packed_payload_bytes"]
    return payload, sum(math.prod(e.shape) for e in plan.entries.values())


def _check_moe_cfg(cfg, layers):
    _check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff,
            cfg.vocab_size, cfg.n_experts, cfg.top_k) ==
           (layers, 2048, 16, 16, 128, 1408, 163840, 64, 6),
           f"not full-width Moonshot-16B-A3B at {layers} layers: {cfg}")


def phase_l(dev, counts):
    """Full-width Moonshot-16B-A3B (depth cut) through the paged runtime and
    the dense-cache loop, then teacher-forced against the torch family."""
    import torch
    from repro_torch.kernels import strum_matmul as K
    from repro_torch.launch import serve as S
    print(f"  depth cut: {MOE_LAYERS} of 48 layers at full width (the f32 init of "
          f"all 48 layers needs ~112 GB of the card's 80 GB)", flush=True)
    _reset_kv_counts()
    res = S.run(["--arch", MOE_ARCH, "--layers", str(MOE_LAYERS), "--seed", "0",
                 "--paged", "--kv-cache", "mip2q", "--prompt-len", "128", "--gen", "32"])
    launched = _kv_counts()
    for line in S.report(res):
        print("  " + line, flush=True)
    sched, cfg, plan = res["sched"], res["cfg"], res["plan"]
    _check_moe_cfg(cfg, MOE_LAYERS)
    layers = cfg.n_layers
    # one plan entry per weight stacked over the layers: 4 attention linears
    # and 3 expert stacks (wi, wg, wo), each (layers, 64, K, N)
    dist = plan.summary()["variant_distribution"]
    _check(dist == {"cuda:onehot": 4, "cuda:grouped": 3} and all(
        e.shape[:2] == (layers, 64) for n, e in plan.entries.items() if "/moe/" in n),
           f"plan selected {dist}, want all {3 * layers} expert stacks on "
           f"cuda:grouped and every attention linear on cuda:onehot")
    print(f"  plan: all {3 * layers} expert stacks (3 entries x {layers} layers) on "
          f"cuda:grouped, all {4 * layers} attention linears on cuda:onehot", flush=True)
    _check((sched.spec.variant, sched.spec.attn_variant) ==
           ("cache:cuda_decode", "cache:attn_fused"),
           f"paged serve selected {sched.spec.variant}, {sched.spec.attn_variant}")
    runs = res["lane_runs"]
    lane = runs["decode"] + runs["prefill_chunk"]
    want = {"grouped_onehot": 3 * layers * lane, "onehot": 4 * layers * lane,
            "paged_attention": layers * lane}
    _check_combine(launched)
    _check(all(launched[k] == v for k, v in want.items()) and
           sum(launched.values()) - launched["paged_attention_combine"] ==
           sum(want.values()),
           f"launches {launched}, want {want} and nothing else ({runs})")
    st = sched.cache_stats()
    _check(st["ratio_vs_int8"] == 0.875 and
           st["resident_page_bytes"] == st["expected_page_bytes"],
           f"packed pages x{st['ratio_vs_int8']} of int8, want x0.875 ({st})")
    payload, int8 = _moe_plan_bytes(plan)
    _check(payload * 8 == int8 * 7, f"packed weights {payload} vs int8 {int8}")
    outs = [r.output for r in res["requests"]]
    _check(len(outs) == 4 and all(len(o) == 33 for o in outs),
           f"requests came back with {[len(o) for o in outs]} tokens")
    counts["grouped_onehot"] = launched["grouped_onehot"]
    dec = sorted(ms for kind, ms in res["ticks"] if kind == "decode")
    print(f"  launches: {launched}; K6 = 3 stacks x {layers} layers x {lane} lane runs "
          f"{runs} (one request of them the warm-up); packed weights "
          f"{payload / 1e9:.4f} GB vs int8 {int8 / 1e9:.4f} GB (x{payload / int8:.4f})",
          flush=True)
    out = {"drain_ms": res["drain_s"] * 1e3, "ticks": len(res["ticks"]),
           "decode_tick_ms": _spread(dec), "decode_ticks": len(dec), "lane_runs": runs,
           "ratio_vs_int8": st["ratio_vs_int8"], "weights_ratio_vs_int8": payload / int8,
           "packed_weight_bytes": payload, "layers": layers}

    # the dense-cache loop on the same plan: the serve entry point's defaults
    K.reset_launch_counts()
    gen, tokens = 16, torch.Generator().manual_seed(0)
    prompt = torch.randint(0, cfg.vocab_size, (4, 32), generator=tokens).to(dev)
    toks, t_p, t_d, lg = S.serve(cfg, res["params"], prompt, gen, device=dev,
                                 return_logits=True)
    dense = dict(K.launch_counts)
    steps = 1 + gen + 2          # + the untimed warm-up prefill and decode step
    _check(dense["grouped_onehot"] == 3 * layers * steps and
           dense["onehot"] == 4 * layers * steps,
           f"dense loop launches {dense}, want 3 and 4 x {layers} x {steps}")
    _check(bool(torch.isfinite(lg).all()) and toks.shape == (4, gen + 1),
           "dense loop logits not finite")
    out.update(dense_prefill_ms=t_p * 1e3, dense_decode_ms_per_token=t_d / gen * 1e3,
               dense_launches=dense)
    print(f"  dense-cache loop (batch 4, prompt 32, gen {gen}): prefill "
          f"{t_p * 1e3:.1f} ms, decode {t_d / gen * 1e3:.2f} ms/token; launches "
          f"{dense} (K6 = 3 x {layers} x {steps} steps, 2 of them warm-up)", flush=True)
    out["logits"] = _paged_vs_torch(dev, res)
    del out["logits"]["cuda_logits"]
    return out


def _serve_moe(argv, attn, grouped, counts):
    """A 2-layer MoE serve whose expert stacks run kernel ``grouped`` (K7 or
    K8), each launch with the experts' live-row counts."""
    import torch
    from repro_torch.kernels import strum_matmul as K
    from repro_torch.launch import serve as S
    wrapper = f"strum_matmul_{grouped}"
    kernel, seen = getattr(K, wrapper), []

    def spy(x3, *a, rows=None, **kw):
        seen.append((tuple(x3.shape), rows))
        return kernel(x3, *a, rows=rows, **kw)
    K.reset_launch_counts()
    setattr(K, wrapper, spy)
    try:
        res = S.run(argv)
    finally:
        setattr(K, wrapper, kernel)
    launched = dict(K.launch_counts)
    for line in S.report(res):
        print("  " + line, flush=True)
    cfg = res["cfg"]
    _check_moe_cfg(cfg, 2)
    dist = res["plan"].summary()["variant_distribution"]
    _check(dist == {f"cuda:{attn}": 4, GROUPED[grouped][0]: 3}, f"plan selected {dist}")
    steps = 1 + res["gen"] + 2
    want = {attn: 4 * cfg.n_layers * steps, grouped: 3 * cfg.n_layers * steps}
    _check(all(launched[k] == v for k, v in want.items()) and
           sum(launched.values()) == sum(want.values()),
           f"launches {launched}, want {want} only")
    _check(len(seen) == launched[grouped] and all(
        r is not None and r.is_cuda and r.dtype == torch.int32 and tuple(r.shape) ==
        (shape[0],) and 0 <= int(r.min()) and int(r.max()) <= shape[1]
        for shape, r in seen), f"{grouped}: {len(seen)} calls, not every one of the "
           f"{launched[grouped]} launches with each expert's live rows")
    if grouped == "grouped_dense":
        routes = _dense_routes(res["plan"])
        _check(routes == {"bytes"}, f"K3 / K8's payloads route to {routes}")
    counts[grouped] = launched[grouped]
    live = [int((r > 0).sum()) for _, r in seen]
    print(f"  launches in this run: {launched} (3 expert stacks and 4 attention "
          f"linears x {cfg.n_layers} layers x {steps} steps, 2 of them warm-up); every "
          f"{grouped} launch with the experts' live rows ({min(live)}-{max(live)} of "
          f"{seen[0][0][0]} experts live)", flush=True)


# ---------------------------------------------- speculative decoding (n-o) --

def phase_n(dev, gen, clocks):
    """K9, K10 against their plain versions at OLMo-1B's linear shapes;
    per-layer times with the bf16 ``torch.matmul`` yardstick on the
    draft-decoded weights."""
    import torch
    from repro_torch.core.apply import pack_array
    from repro_torch.core.policy import StruMConfig
    from repro_torch.engine.draft import draft_dequant_packed
    from repro_torch.kernels import strum_matmul as K
    cfg = StruMConfig(method="mip2q", p=0.5, L=5)
    # two layers of distinct weights: their payload exceeds the 50 MB L2
    layers = []
    for k, n in LAYER_SHAPES * 2:
        w = torch.randn((k, n), generator=gen, device=dev)
        layers.append(pack_array(w, cfg))
        del w
    calls = {"histream": (K.strum_matmul_histream, K.strum_matmul_histream_plain,
                          lambda p: (p.mask, p.hi, p.scale), ("mask", "hi")),
             "maskfree_p": (K.strum_matmul_maskfree_p, K.strum_matmul_maskfree_p_plain,
                            lambda p: (p.hi, p.scale), ("hi",))}
    out = {}
    for mode, (kern, plain, fields, read) in calls.items():
        row = {"max_abs_err": 0.0}
        for m in (4, 1, 16):
            xs = {k: torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
                  for k in (2048, 8192)}
            timed = []
            for packed in layers:
                x, f = xs[packed.k_dim], fields(packed)
                kw = dict(w=packed.w, n_low=packed.n_low)
                y, y_plain = kern(x, *f, **kw), plain(x, *f, **kw)
                torch.cuda.synchronize()
                err = (y - y_plain).abs().max().item()
                lim = KERNEL_TOL * y_plain.abs().max().item()
                _check(err <= lim, f"{mode} M={m} K={packed.k_dim} N={packed.n_out}: "
                       f"|kernel - plain| {err} > {lim}")
                row["max_abs_err"] = max(row["max_abs_err"], err)
                timed.append((x, f, kw, packed, draft_dequant_packed(
                    packed, mode, torch.bfloat16)))
            def layer_calls():
                return [kern(c[0], *c[1], **c[2]) for c in timed]
            def library_calls():
                return [torch.matmul(c[0], c[4]) for c in timed]
            t = _interleaved(clocks, {     # two layers timed: times per layer
                "ms": (layer_calls, 20),
                "graph_ms": (_graphed(layer_calls), 20),
                "plain_ms": (lambda: [plain(c[0], *c[1], **c[2]) for c in timed], 2),
                "library_ms": (library_calls, 20),
                "library_graph_ms": (_graphed(library_calls), 20)},
                calls=2)
            nbytes = sum(sum(getattr(c[3], f_).numel() for f_ in read)
                         + 4 * c[3].n_out + c[0].numel() * c[0].element_size()
                         + 4 * m * c[3].n_out for c in timed) / 2
            flops = sum(2 * m * k * n for k, n in LAYER_SHAPES)
            row[m] = dict(t, **_bound(nbytes, flops, PEAK_FLOPS["torch.bfloat16"]))
            print(f"  {mode:10s} M={m:2d} one layer (7 linears), median [min, max] of "
                  f"{ROUNDS} interleaved rounds: " + ", ".join(
                      f"{label} {t[key]:.4f} [{t['range_ms'][key][0]:.4f}, "
                      f"{t['range_ms'][key][1]:.4f}] ms" for key, label in
                      (("ms", "kernel"), ("graph_ms", "kernel (graph replay)"),
                       ("plain_ms", "plain"), ("library_ms", "torch.matmul bf16"),
                       ("library_graph_ms", "torch.matmul bf16 (graph replay)"))) +
                  f"; bound {row[m]['bound_ms']:.4f} ms ({row[m]['bound_by']}: "
                  f"{nbytes / 1e6:.2f} MB); {t['clock']}", flush=True)
            if m == 4:
                row["per_shape"] = _per_shape(clocks, f"{mode:10s} M= 4", [
                    ((c[3].k_dim, c[3].n_out), lambda c=c: kern(c[0], *c[1], **c[2]),
                     lambda c=c: torch.matmul(c[0], c[4])) for c in timed])
            del timed
        print(f"  {mode:10s} max |kernel - plain| {row['max_abs_err']:.3e} (<= "
              f"{KERNEL_TOL} x max|plain| at every shape)", flush=True)
        out[mode] = row
    del layers
    torch.cuda.empty_cache()
    return out


def _leaf_at(tree, name):
    for key in name.split("/"):
        tree = tree[key]
    return tree


def _verify_rows(sched, plen, rows):
    """Wrap ``sched``'s verify lane: keep, per request, each window row's
    logits under the output index it predicts (a later window overwrites a
    row an earlier one predicted but did not commit)."""
    verify = sched._verify

    def wrapped(params, toks, pools, hot, table, slot, start):
        lg, kv = verify(params, toks, pools, hot, table, slot, start)
        uid = sched.slots[int(slot)].req.uid
        for j in range(toks.shape[1]):
            rows.setdefault(uid, {})[int(start) - plen + 1 + j] = lg[0, j]
        return lg, kv
    sched._verify = wrapped


def phase_o(dev, plain, counts):
    """Full-width OLMo-1B through the speculative paged runtime, once per
    draft mode; then phase h's requests teacher-forced through it against
    the plain lane's logits (phase j)."""
    import torch
    from repro_torch.launch import serve as S
    out = {}
    for mode in DRAFT:
        _reset_kv_counts()
        res = S.run(["--arch", "olmo_1b", "--seed", "0", "--paged", "--kv-cache",
                     "mip2q", "--prompt-len", "128", "--gen", "32", "--speculative",
                     str(SPEC_K), "--draft", mode])
        launched = _kv_counts()
        for line in S.report(res):
            print("  " + line, flush=True)
        sched, cfg, plan = res["sched"], res["cfg"], res["plan"]
        _check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.d_ff, cfg.vocab_size) ==
               (16, 2048, 16, 8192, 50304), f"not full-width OLMo-1B: {cfg}")
        runs, spec = res["lane_runs"], res["spec"]
        per = 7 * cfg.n_layers
        other = "maskfree_p" if mode == "histream" else "histream"
        _check(runs["draft"] > 0 and runs["decode"] == 0 and
               launched[mode] == per * runs["draft"] and launched[other] == 0,
               f"{mode} launches {launched[mode]}, want {per} x {runs['draft']} draft "
               f"steps ({runs})")
        # K1 only in the verify windows and prefill chunks: none in the draft lane
        _check(launched["onehot"] == per * (runs["verify"] + runs["prefill_chunk"]),
               f"K1 launches {launched['onehot']}, want {per} x (verify "
               f"{runs['verify']} + prefill {runs['prefill_chunk']})")
        _check(launched["paged_attention"] == cfg.n_layers * (
            runs["draft"] + runs["verify"] + runs["prefill_chunk"]),
            f"K4 launches {launched['paged_attention']} ({runs})")
        _check_combine(launched)
        modes = sched.draft_plan.meta["draft"]
        _check(len(modes) == 7 and set(modes.values()) == {mode},
               f"draft modes {modes}")
        for name in modes:
            got, target = _leaf_at(sched.draft_plan.params, name), _leaf_at(plan.params, name)
            _check(all(got[f].data_ptr() == target[f].data_ptr() for f in
                       ("mask", "hi", "lo", "scale")),
                   f"{name}: the draft's payload is not the target plan's")
            _check(got["spec"].variant == DRAFT[mode][0], f"{name}: {got['spec']}")
        st = sched.cache_stats()
        ratio = {"histream": 10 / 14, "maskfree_p": 8 / 14}[mode]
        _check(st["speculative"]["ratio"] == ratio,
               f"draft payload ratio {st['speculative']['ratio']}, want {ratio}")
        outs = {r.uid: r.output for r in res["requests"]}
        _check(sorted(outs) == [0, 1, 2, 3] and all(len(o) == 33 for o in outs.values()),
               f"requests came back with {[len(o) for o in outs.values()]} tokens")
        counts[mode] = launched[mode]
        rounds = sorted(ms for kind, ms in res["ticks"] if kind == "decode")
        acc = spec["accepted"] / spec["drafted"]
        print(f"  launches: {launched}; K{9 if mode == 'histream' else 10} = {per} x "
              f"{runs['draft']} draft steps, K1 = {per} x ({runs['verify']} verify + "
              f"{runs['prefill_chunk']} prefill); draft tensors are the target's "
              f"({len(modes)} entries); spec counters {spec}; acceptance {acc:.4f}",
              flush=True)
        row = {"drain_ms": res["drain_s"] * 1e3, "ticks": len(res["ticks"]),
               "round_ms": _spread(rounds), "rounds": len(rounds), "lane_runs": runs,
               "spec": spec, "acceptance": acc, "ratio": st["speculative"]["ratio"],
               "launches": launched[mode]}
        row.update(_spec_vs_plain(dev, res, plain, mode))
        out[mode] = row
        del res, sched, plan
        torch.cuda.empty_cache()
    return out


def _spec_vs_plain(dev, res, plain, mode):
    """Phase h's requests teacher-forced on its tokens through a speculative
    scheduler on the served plan: the tokens it serves (its predictions)
    must be its verify lane's argmax at every committed position, and its
    predictions and logits are held against phase h / j's plain lane."""
    import torch
    from repro_torch.serving import BatchScheduler, Request
    sched, cfg = res["sched"], res["cfg"]
    s2 = BatchScheduler(cfg, None, n_slots=sched.n_slots, max_len=sched.max_len,
                        plan=res["plan"], kv_cache=sched.spec.cfg,
                        page_size=sched.spec.page_size, speculative=SPEC_K, draft=mode,
                        device=dev)
    rows: dict = {}
    _verify_rows(s2, plain["prompt"].shape[1], rows)
    chunk = s2._chunk_prefill

    def first(params, toks, pools, hot, table, slot, start, valid):
        o = chunk(params, toks, pools, hot, table, slot, start, valid)
        sl = s2.slots[int(slot)]
        if int(start) + int(valid) >= sl.req.prompt.shape[0]:
            rows.setdefault(sl.req.uid, {})[0] = o[0][0, int(valid) - 1]
        return o
    s2._chunk_prefill = first
    for uid, toks in enumerate(plain["tokens"]):
        s2.submit(Request(uid=uid, prompt=plain["prompt"][uid].cpu(),
                          max_new_tokens=len(toks), force_tokens=toks))
    with torch.inference_mode():
        done = {r.uid: r.output for r in s2.run_to_completion()}
    _check(s2.lane_runs["draft"] > 0, f"no draft step ran: {s2.lane_runs}")
    vocab = cfg.vocab_size
    got = torch.stack([torch.stack([rows[u][i][:vocab] for i in range(len(done[u]))])
                       for u in sorted(done)]).float()
    served = torch.tensor([done[u] for u in sorted(done)], device=got.device)
    _check(torch.equal(got.argmax(-1), served), "served tokens are not the verify "
           "lane's argmax at every committed position")
    ref = plain["logits"].float()
    toks = torch.tensor(plain["tokens"], device=got.device)
    _check(bool(torch.isfinite(got).all()) and got.shape == ref.shape,
           f"speculative logits not finite or of shape {tuple(got.shape)}")
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    agree_mask = got.argmax(-1) == ref.argmax(-1)
    agree = agree_mask.float().mean().item()
    top2 = ref.topk(2, dim=-1).values
    gaps = [(int(u), int(i), (top2[u, i, 0] - top2[u, i, 1]).item())
            for u, i in (~agree_mask).nonzero().tolist()]
    same_h = (got.argmax(-1) == toks).float().mean().item()
    print(f"  teacher-forced on phase h's tokens ({got.shape[1]} positions x "
          f"{got.shape[0]} requests): speculative vs plain-lane logits max|diff| "
          f"{err:.4e} (max|logit| {scale:.4e}), argmax agreement {agree:.3f} "
          f"({len(gaps)} disagreements; plain top-2 gaps "
          f"{[round(g, 5) for _, _, g in gaps]}), predictions = phase h's tokens at "
          f"{same_h:.3f}; served tokens = verify argmax at every committed position",
          flush=True)
    _check(err <= 0.05 * scale, f"speculative logits differ: {err} > 0.05 x {scale}")
    _check(agree >= 0.9 and same_h >= 0.9, f"speculative argmax agreement {agree} "
           f"with the plain lane, {same_h} with phase h's tokens: < 0.9")
    return {"max_abs_diff": err, "max_abs_logit": scale, "argmax_agreement": agree,
            "disagreements": gaps, "tokens_equal_share": same_h}


# ------------------------------------------------- schedule-driven path (p) --

#: where phase p writes its schedules (inside the build directory, which
#: git ignores)
SCHED_DIR = ROOT / "build" / "phase_p"
#: plan variant -> the kernel (launch-count key) it launches
VARIANT_KERNEL = {"cuda:onehot": "onehot", "cuda:maskfree": "maskfree",
                  "cuda:dense": "dense", "cuda:grouped": "grouped_onehot",
                  "cuda:grouped_maskfree": "grouped_maskfree",
                  "cuda:grouped_dense": "grouped_dense"}
K1_L5 = dict(method="mip2q", p=0.5, L=5)
K2_P1 = dict(method="dliq", p=1.0, q=4)
K3_P0 = dict(method="mip2q", p=0.0, L=5)
# p2: each OLMo-1B linear kind its own config (None: dense); the kernel
# each must select; K1 at L = 7 runs off its byte path
P2_SCHEDULE = {"attn/wq/w": (K1_L5, "cuda:onehot"),
               "attn/wk/w": (K2_P1, "cuda:maskfree"),
               "attn/wv/w": (K3_P0, "cuda:dense"),
               "attn/wo/w": (dict(method="mip2q", p=0.5, L=7), "cuda:onehot"),
               "mlp/wi/w": (None, None),
               "mlp/wg/w": (K1_L5, "cuda:onehot"),
               "mlp/wo/w": (K2_P1, "cuda:maskfree")}
# p3: one Moonshot MoE layer position's three expert stacks on K6, K7, K8;
# p3b leaves wo dense
P3_SCHEDULE = {"moe/wi": (K1_L5, "cuda:grouped"),
               "moe/wg": (K2_P1, "cuda:grouped_maskfree"),
               "moe/wo": (K3_P0, "cuda:grouped_dense")}
P_LAYERS = 2                    # p2's and p3's depth, at full width


def _write_schedule(name, table):
    """A StruMSchedule over ``blocks/pos0/<kind>`` names, saved as JSON under
    SCHED_DIR and held to load back; returns (path, {name: variant})."""
    from repro_torch.autotune import StruMSchedule
    from repro_torch.core.policy import StruMConfig
    sched = StruMSchedule(
        assignments={f"blocks/pos0/{k}": c and StruMConfig(**c)
                     for k, (c, _) in table.items()},
        meta={"written_by": "chip_smoke.py phase p"})
    path = sched.save(str(SCHED_DIR / f"{name}.json"))
    _check(StruMSchedule.load(path).to_json() == sched.to_json(),
           f"{path} did not load back")
    return path, {f"blocks/pos0/{k}": v for k, (_, v) in table.items()}


def _plan_launches(plan, groups, steps, modes=None, draft_steps=0) -> dict:
    """Launches a plan's kernels must make: one per entry per layer group
    per step; in a speculative run an entry with a draft mode (``modes``)
    launches that mode's kernel (K9 / K10) in the ``draft_steps`` instead."""
    want: dict = {}
    for name, e in plan.entries.items():
        mode = (modes or {}).get(name, "")
        # torch:dequant (printed by _check_schedule_plan) launches no kernel
        for k, n in ((VARIANT_KERNEL.get(e.variant), steps - (draft_steps if mode else 0)),
                     (mode, draft_steps if mode else 0)):
            if k and n:
                want[k] = want.get(k, 0) + groups * n
    return want


def _check_schedule_plan(plan, schedule, want_variants=None) -> None:
    """Every tensor the schedule assigns a config has an entry with it, on a
    cuda:* variant or, printed, on torch:dequant where no cuda:* predicate
    accepts the config; a None assignment stays dense.  With
    ``want_variants`` each entry has exactly its variant."""
    import torch
    from repro_torch.engine.plan import _is_expert_stack
    from repro_torch.engine.registry import LeafInfo, list_variants
    for name, cfg in schedule.assignments.items():
        if cfg is None:
            _check(name not in plan.entries and isinstance(_leaf_at(plan.params, name),
                                                           torch.Tensor),
                   f"{name}: assigned None, but packed")
            continue
        e = plan.entries.get(name)
        _check(e is not None and e.cfg == cfg, f"{name}: {e and e.cfg}, want {cfg}")
        if want_variants is not None:
            _check(e.variant == want_variants[name],
                   f"{name} selected {e.variant}, want {want_variants[name]}")
        if not e.variant.startswith("cuda:"):
            info = LeafInfo(k_dim=e.shape[-2], n_out=e.shape[-1], name=name,
                            lead=tuple(e.shape[:-2]) if _is_expert_stack(name) else ())
            cands = [v.name for v in list_variants().values() if v.family == "cuda"
                     and not (v.cache or v.draft) and v.supports(e.cfg, info)]
            _check(not cands, f"{name}: {e.variant}, but {cands} accept {e.cfg}")
            print(f"  {name}: {e.variant} (no cuda:* variant accepts {e.cfg})",
                  flush=True)


def _k1_routes(plan) -> dict:
    """{entry: "bytes" | "general"}: where K1 runs each cuda:onehot entry."""
    from repro_torch.kernels import strum_matmul as K
    return {n: "bytes" if K.byte_path_tables(e.cfg.w, e.cfg.n_low, q=e.cfg.q,
                                              method=e.cfg.method, L=e.cfg.L,
                                              kernel="onehot") else "general"
            for n, e in plan.entries.items() if e.variant == "cuda:onehot"}


def _dense_loop_logits(cfg, params, dev, gen=16, batch=4, prompt_len=32):
    """Phase d's prompt (the serve entry point's, seed 0) through the
    dense-cache loop on ``params``: a result dict for phase_f."""
    import torch
    from repro_torch.launch import serve as S
    g = torch.Generator().manual_seed(0)
    prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=g).to(dev)
    toks, t_p, t_d, lg = S.serve(cfg, params, prompt, gen, device=dev,
                                 return_logits=True)
    return {"cfg": cfg, "params": params, "prompt": prompt, "tokens": toks,
            "logits": lg, "gen": gen, "t_prefill": t_p, "t_decode": t_d}


def phase_p1(dev, paged):
    """Profile and search full-width OLMo-1B on the card; save, load, plan,
    serve the schedule paged; phase d's prompt through it, cuda vs torch."""
    import math

    import torch
    from repro_torch.autotune import (DEFAULT_GRID, Budget, StruMSchedule, cache_info,
                                      clear_cache, profile_tree, search_schedule)
    from repro_torch.configs.base import get_config
    from repro_torch.core.apply import tree_compression_report
    from repro_torch.launch.steps import build_serving_plan
    from repro_torch.models import model_defs
    from repro_torch.models.params import init_params
    cfg = get_config("olmo_1b")
    params = init_params(model_defs(cfg), seed=0, device=dev, dtype_override="float32")
    clear_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    prof = profile_tree(params, DEFAULT_GRID)
    torch.cuda.synchronize(dev)
    t_profile = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) - base
    first = cache_info()
    t0 = time.perf_counter()
    again = profile_tree(params, DEFAULT_GRID)
    t_hits = time.perf_counter() - t0
    second = cache_info()
    n = len(prof)
    _check(n == 7 and first == {"hits": 0, "misses": n, "entries": n} and
           second == {"hits": n, "misses": n, "entries": n} and again == prof,
           f"cache after the first profile {first}, after the second {second}: the "
           f"second call must be all hits")
    t0 = time.perf_counter()
    sched = search_schedule(params, Budget(target_ratio=0.875), profile=prof)
    t_search = time.perf_counter() - t0
    elements = sum(r["size"] for r in prof.values())
    print(f"  profile_tree: {n} tensors, {elements / 1e9:.3f} G weights, "
          f"{len(DEFAULT_GRID)} configs each: {t_profile:.2f} s (all misses), peak "
          f"{peak / 1e9:.2f} GB above the weights; the same call again {t_hits:.2f} s "
          f"(all {n} hits: content hashes of {4 * elements / 1e9:.2f} GB, copied to the "
          f"host); search_schedule (allocator on the profile) {t_search * 1e3:.2f} ms",
          flush=True)
    summ = sched.summary()
    print(f"  searched schedule: {summ['config_distribution']}, achieved x"
          f"{summ['achieved_ratio']:.4f} of int8 (budget x0.875), weighted SQNR "
          f"{summ['weighted_sqnr_db']:.3f} dB, feasible {sched.meta['feasible']}",
          flush=True)
    _check(sched.meta["feasible"] and summ["achieved_ratio"] <= 0.875,
           f"schedule misses its budget: {summ}")
    path = sched.save(str(SCHED_DIR / "olmo_1b_searched.json"))
    loaded = StruMSchedule.load(path)
    _check(loaded.to_json() == sched.to_json(), "the saved schedule did not load back")
    plan = build_serving_plan(params, schedule=loaded, device=dev)
    _check_schedule_plan(plan, loaded)
    report = tree_compression_report(params, schedule=loaded)
    packed = {n for n, c in loaded.assignments.items() if c is not None}
    want_bytes = sum(r["packed_bytes"] for r in report["tensors"] if r["name"] in packed)
    payload = plan.summary()["packed_payload_bytes"]
    int8 = sum(math.prod(e.shape) for e in plan.entries.values())
    _check(payload == want_bytes, f"plan's packed bytes {payload} != the report's "
           f"{want_bytes} over the assigned tensors")
    routes = _k1_routes(plan)
    print(f"  plan: {plan.summary()['variant_distribution']}; packed {payload} bytes = "
          f"tree_compression_report's {want_bytes} over the {len(packed)} packed "
          f"tensors; weights x{payload / int8:.4f} of int8; K1 routes {routes}",
          flush=True)
    del plan, params
    torch.cuda.empty_cache()

    launched: dict = {}
    res = _serve_schedule(["--arch", "olmo_1b", "--seed", "0", "--paged", "--kv-cache",
                           "mip2q", "--prompt-len", "128", "--gen", "32"], path, None,
                          launched)
    outs = [r.output for r in res["requests"]]
    _check(len(outs) == 4 and all(len(o) == 33 for o in outs),
           f"requests came back with {[len(o) for o in outs]} tokens")
    runs = res["lane_runs"]
    dec = sorted(ms for kind, ms in res["ticks"] if kind == "decode")
    tick, h = _spread(dec), paged["decode_tick_ms"]
    print(f"  drain {res['drain_s'] * 1e3:.1f} ms, decode-only tick median "
          f"{tick['median']:.3f} ms [{tick['min']:.3f}, {tick['max']:.3f}] over "
          f"{len(dec)}, against phase h's drain {paged['drain_ms']:.1f} ms, tick "
          f"{h['median']:.3f} ms [{h['min']:.3f}, {h['max']:.3f}] (mip2q p=0.5 L=5 "
          f"everywhere)", flush=True)
    # phase d's prompt teacher-forced through the same plan, cuda vs torch
    dl = _dense_loop_logits(res["cfg"], res["params"], dev)
    phase_f(dl)
    return {"profile_s": t_profile, "profile_hits_s": t_hits, "search_s": t_search,
            "profile_peak_bytes": peak, "schedule": summ,
            "weights_ratio_vs_int8": payload / int8, "packed_weight_bytes": payload,
            "drain_ms": res["drain_s"] * 1e3, "ticks": len(res["ticks"]),
            "decode_tick_ms": tick, "decode_ticks": len(dec), "lane_runs": runs,
            "phase_h_decode_tick_ms": h, "phase_h_drain_ms": paged["drain_ms"],
            "launches": launched, "k1_routes": routes,
            "dense_loop_decode_ms_per_token": dl["t_decode"] / dl["gen"] * 1e3}


def _serve_schedule(argv, path, want_variants, counts, spy=()):
    """``serve ... --schedule path`` with the launch counts reset (added to
    ``counts``); the plan must hold the schedule (with ``want_variants``,
    exactly those variants) and the run launch one kernel per entry per
    layer group per step (K4 once per layer per lane run) and nothing else.
    ``spy`` names grouped wrappers whose every call must carry the experts'
    live rows."""
    import torch
    from repro_torch.kernels import strum_matmul as K
    from repro_torch.launch import serve as S
    seen: dict = {name: [] for name in spy}
    kept = {name: getattr(K, f"strum_matmul_{name}") for name in spy}

    def wrap(name):
        def call(x3, *a, rows=None, **kw):
            seen[name].append((tuple(x3.shape), rows))
            return kept[name](x3, *a, rows=rows, **kw)
        return call
    _reset_kv_counts()
    for name in spy:
        setattr(K, f"strum_matmul_{name}", wrap(name))
    try:
        res = S.run(argv + ["--schedule", path])
    finally:
        for name, fn in kept.items():
            setattr(K, f"strum_matmul_{name}", fn)
    launched = _kv_counts()
    for line in S.report(res):
        print("  " + line, flush=True)
    plan, cfg = res["plan"], res["cfg"]
    _check_schedule_plan(plan, plan.schedule, want_variants)
    modes, draft_steps = None, 0
    if res["paged"]:
        runs = res["lane_runs"]
        steps = runs["decode"] + runs["prefill_chunk"] + runs["draft"] + runs["verify"]
        if res["sched"].speculative:
            modes, draft_steps = res["sched"].draft_plan.meta["draft"], runs["draft"]
    else:
        steps = 1 + res["gen"] + 2       # + the untimed warm-up prefill and decode
    want = _plan_launches(plan, cfg.n_layers, steps, modes, draft_steps)
    if res["paged"]:
        want["paged_attention"] = cfg.n_layers * steps
        _check_combine(launched)
    extra = launched["paged_attention_combine"]
    _check(all(launched[k] == v for k, v in want.items()) and
           sum(launched.values()) - extra == sum(want.values()),
           f"launches {launched}, want {want} and nothing else")
    for name, calls in seen.items():
        _check(len(calls) == launched[name] and all(
            r is not None and r.is_cuda and r.dtype == torch.int32 and
            tuple(r.shape) == (shape[0],) and 0 <= int(r.min()) and
            int(r.max()) <= shape[1] for shape, r in calls),
            f"{name}: {len(calls)} calls, not every one of the {launched[name]} "
            f"launches with each expert's live rows")
    for k, v in launched.items():
        counts[k] = counts.get(k, 0) + v
    print(f"  launches: {launched} (one per entry x {cfg.n_layers} layers x {steps} "
          f"steps{', the warm-up included' if res['paged'] else ', 2 of them warm-up'})"
          + "".join(f"; every {n} launch with the experts' live rows" for n in seen),
          flush=True)
    return res


def phase_p2(dev):
    """A mixed schedule the script writes: K1, K2, K3, K1 off its byte path
    and a dense linear in one 2-layer full-width OLMo-1B plan; logits vs the
    torch family; the speculative lane on it against the plain lane."""
    from repro_torch import engine
    path, variants = _write_schedule("olmo_1b_mixed", P2_SCHEDULE)
    counts: dict = {}
    res = _serve_schedule(["--arch", "olmo_1b", "--layers", str(P_LAYERS), "--seed",
                           "0", "--gen", "4"], path, variants, counts)
    routes = _k1_routes(res["plan"])
    _check(routes == {"blocks/pos0/attn/wq/w": "bytes", "blocks/pos0/mlp/wg/w": "bytes",
                      "blocks/pos0/attn/wo/w": "general"}, f"K1 routes {routes}")
    dense = _dense_routes(res["plan"])
    _check(dense == {"bytes"}, f"K3's payloads route to {dense}")
    print(f"  K1 routes {routes}; K3 on its byte path", flush=True)
    phase_f(res)

    argv = ["--arch", "olmo_1b", "--layers", str(P_LAYERS), "--seed", "0", "--paged",
            "--kv-cache", "mip2q", "--prompt-len", "64", "--gen", "16"]
    plain = _serve_schedule(argv, path, variants, counts)
    spec = _serve_schedule(argv + ["--speculative", str(SPEC_K), "--draft", "histream"],
                           path, variants, counts)
    got = {r.uid: r.output for r in spec["requests"]}
    want = {r.uid: r.output for r in plain["requests"]}
    _check(got == want, f"speculative tokens differ from the plain lane's: {got} vs "
           f"{want}")
    s = spec["sched"]
    modes = s.draft_plan.meta["draft"]
    want_modes = engine.build_draft_plan(s.plan, engine.DraftPolicy("histream")).meta["draft"]
    drafted = {n for n, m in modes.items() if m}
    _check(modes == want_modes and drafted == {n for n, e in s.plan.entries.items()
                                               if 0 < e.cfg.n_low < e.cfg.w},
           f"draft modes {modes}, build_draft_plan's {want_modes}")
    runs = spec["lane_runs"]
    _check(runs["draft"] > 0 and runs["decode"] == 0, f"speculative lane runs {runs}")
    acc = spec["spec"]["accepted"] / max(spec["spec"]["drafted"], 1)
    print(f"  speculative (k={SPEC_K}, histream) on the schedule plan: tokens = the "
          f"plain lane's for all {len(got)} requests; drafted on K9 {sorted(drafted)}, "
          f"kept at full fidelity {sorted(set(modes) - drafted)} in {runs['draft']} "
          f"draft steps; acceptance {acc:.4f}; draft payload "
          f"x{s.cache_stats()['speculative']['ratio']:.4f}", flush=True)
    return {"launches": counts, "k1_routes": routes, "acceptance": acc,
            "drafted": sorted(drafted)}


def phase_p3(dev):
    """Moonshot-16B-A3B, 2 of 48 layers, full width: wi, wg, wo of its MoE
    layer position on K6, K7, K8 through the paged scheduler, logits vs the
    torch family; then wo left dense through the dense-cache loop."""
    path, variants = _write_schedule("moonshot_moe_mixed", P3_SCHEDULE)
    counts: dict = {}
    res = _serve_schedule(["--arch", MOE_ARCH, "--layers", str(P_LAYERS), "--seed", "0",
                           "--paged", "--kv-cache", "mip2q", "--prompt-len", "128",
                           "--gen", "16"], path, variants, counts,
                          spy=("grouped_onehot", "grouped_maskfree", "grouped_dense"))
    _check_moe_cfg(res["cfg"], P_LAYERS)
    _check(_dense_routes(res["plan"]) == {"bytes"}, "K8's payload is off its byte path")
    logits = _paged_vs_torch(dev, res, schedule=res["plan"].schedule)
    del logits["cuda_logits"]

    table = {k: v for k, v in P3_SCHEDULE.items() if k != "moe/wo"}
    table["moe/wo"] = (None, None)
    path_b, variants_b = _write_schedule("moonshot_moe_wo_dense", table)
    # wo dense: _serve_schedule holds the run to K6 and K7 only (no K8)
    res_b = _serve_schedule(["--arch", MOE_ARCH, "--layers", str(P_LAYERS), "--seed",
                             "0", "--gen", "4"], path_b, variants_b, counts,
                            spy=("grouped_onehot", "grouped_maskfree"))
    phase_f(res_b)
    return {"launches": counts, "logits": logits}


# --------------------------------------------------------- model zoo (q) --

SSM_ARCH = "mamba2_780m"
HYBRID_ARCH = "jamba_1_5_large_398b"
#: q3: dense configs at published width, depth cut to ZOO_LAYERS
DENSE_ZOO = ("deepseek_67b", "stablelm_12b", "internvl2_26b", "musicgen_medium")
ZOO_LAYERS = 2
#: (K, N) of one Mamba-2 780M layer's two linears: in_proj (z, x, B, C, dt)
#: and out_proj
MAMBA_SHAPES = [(1536, 6448), (3072, 1536)]
#: q3's K4 cases: (label, kv heads, query rows per kv head, head dim), the
#: decode attention of StableLM-2-12B (GQA, hd 160) and MusicGen-medium (MHA)
ZOO_ATTN = [("stablelm-2-12b decode", 8, 4, 160), ("musicgen-medium decode", 24, 1, 64)]


def _full_width(cfg, arch, layers=None) -> None:
    """``cfg`` is ``arch``'s published config, depth cut to ``layers``."""
    from repro_torch.configs.base import get_config
    want = get_config(arch)
    if layers is not None:
        want = dataclasses.replace(want, n_layers=layers)
    _check(dataclasses.replace(cfg, strum=None) == want,
           f"not {arch} at full width: {cfg}")


def _zoo_counts(launched, want: dict, what) -> None:
    """Exactly ``want`` launches of each kernel (and of K4's combine where
    given), nothing else."""
    _check(all(launched[k] == v for k, v in want.items()) and
           sum(launched.values()) == sum(want.values()),
           f"{what}: launches {launched}, want {want} and nothing else")


def _mamba_k1(dev, gen, clocks) -> dict:
    """K1 at Mamba-2 780M's in_proj (1536 -> 6448, N = 50 x 128 + 48) and
    out_proj (3072 -> 1536), M = 4 (decode) and 16 (a prefill chunk), bf16
    x: twice bit-identical and within KERNEL_TOL of the plain version; one
    layer's two linears at M = 4 timed as phase c times a layer."""
    import torch
    from repro_torch.core.apply import pack_array
    from repro_torch.core.policy import StruMConfig
    cfg = StruMConfig(method="mip2q", p=0.5, L=5)
    layer = [pack_array(torch.randn(s, generator=gen, device=dev), cfg)
             for s in MAMBA_SHAPES]
    out = {"max_abs_err": 0.0}
    for m in (4, 16):
        for packed in layer:
            wrapper, plain, fields, kw = _kernel_args("onehot", packed)
            x = torch.randn((m, packed.k_dim), generator=gen, device=dev).to(torch.bfloat16)
            what = f"mamba2 M={m} K={packed.k_dim} N={packed.n_out}"
            y = _twice_equal(f"onehot {what}", wrapper, x, *fields, **kw)
            want = plain(x, *fields, **kw)
            torch.cuda.synchronize()
            err = (y - want).abs().max().item()
            _check(err <= KERNEL_TOL * want.abs().max().item(),
                   f"onehot {what}: |kernel - plain| {err}")
            out["max_abs_err"] = max(out["max_abs_err"], err)
    xs = {k: torch.randn((4, k), generator=gen, device=dev).to(torch.bfloat16)
          for k, _ in MAMBA_SHAPES}
    calls = [(_kernel_args("onehot", p), xs[p.k_dim], packed_dequant(p), p) for p in layer]
    t = _interleaved(clocks, {
        "graph_ms": (_graphed(lambda: [a[0](x, *a[2], **a[3]) for a, x, _, _ in calls]), 20),
        "plain_ms": (lambda: [a[1](x, *a[2], **a[3]) for a, x, _, _ in calls], 2),
        "library_graph_ms": (_graphed(lambda: [torch.matmul(x, w)
                                               for _, x, w, _ in calls]), 20)})
    nbytes = sum(_read_bytes("onehot", p, x) for _, x, _, p in calls)
    out.update(t, **_bound(nbytes, sum(2 * 4 * k * n for k, n in MAMBA_SHAPES),
                           PEAK_FLOPS["torch.bfloat16"]))
    print(f"  K1 at Mamba-2 780M's in_proj {MAMBA_SHAPES[0]} and out_proj "
          f"{MAMBA_SHAPES[1]}, M = 4 and 16: max |kernel - plain| "
          f"{out['max_abs_err']:.3e}, two calls bit-identical; one layer at M = 4: "
          f"kernel {t['graph_ms']:.4f} ms (graph replay), plain {t['plain_ms']:.4f}, "
          f"torch.matmul bf16 {t['library_graph_ms']:.4f} (graph replay), bound "
          f"{out['bound_ms']:.4f} ({out['bound_by']}, {nbytes / 1e6:.2f} MB); "
          f"{t['clock']}", flush=True)
    return out


def _ssm_layer_continuation(dev, plan, cfg) -> dict:
    """Layer 0's packed mixer (K1 on in_proj / out_proj, f32 x): 100 tokens
    through ``ssm_prefill_chunk`` in chunks of 16 (the last of 4) equal a
    one-shot ``ssm_apply``: outputs, conv tail and state, each within rtol
    2e-4 / atol 2e-4 (the CPU tests' tolerance).  Then the mixer's memory
    peak at a 4 x 128-token prefill in the activation dtype."""
    import torch
    from repro_torch.models import mamba2
    from repro_torch.models.transformer import _group
    p = _group(plan.params["blocks"], 0)["pos0"]["ssm"]
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    g = torch.Generator(device=dev).manual_seed(5)
    s, c = 100, 16
    x = torch.randn((1, s, cfg.d_model), generator=g, device=dev) * 0.5
    kw = dict(strum=cfg.strum)
    with torch.inference_mode():
        want, (conv_w, h_w) = mamba2.ssm_apply(p, x, cfg32, return_state=True, **kw)
        _, nh, hp, ns, conv_dim = mamba2._dims(cfg)
        conv = torch.zeros((1, cfg.ssm_conv - 1, conv_dim), device=dev)
        h = torch.zeros((1, nh, hp, ns), device=dev)
        outs = []
        for start in range(0, s, c):
            n = min(c, s - start)
            xc = torch.zeros((1, c, cfg.d_model), device=dev)
            xc[:, :n] = x[:, start:start + n]
            y, (conv, h) = mamba2.ssm_prefill_chunk(
                p, xc, cfg32, (conv, h), torch.tensor(n, device=dev), **kw)
            outs.append(y[:, :n])
        got = torch.cat(outs, dim=1)
    errs = {}
    for key, a, b in (("out", got, want), ("conv", conv, conv_w), ("state", h, h_w)):
        _check(a.shape == b.shape and bool(torch.isfinite(a).all()),
               f"continuation {key}: {tuple(a.shape)} vs {tuple(b.shape)}")
        excess = ((a - b).abs() - 2e-4 * b.abs()).max().item()
        _check(excess <= 2e-4, f"continuation {key} differs from one-shot ssm_apply")
        errs[key] = (a - b).abs().max().item()
    print(f"  one full-width layer (K1, f32 x): {s} tokens in chunks of {c} (last "
          f"{s % c}) through ssm_prefill_chunk = one-shot ssm_apply, max |diff| "
          + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
          + " (rtol 2e-4, atol 2e-4)", flush=True)
    # the scan's peak at a 4 x 128 prefill (one chunk of 128): every chunk
    # step is O(B c c nh), below one (B, c, c, nh, hp) f32 tensor
    x4 = (torch.randn((4, 128, cfg.d_model), generator=g, device=dev) * 0.5).to(
        cfg.activation_dtype)
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    with torch.inference_mode():
        mamba2.ssm_apply(p, x4, cfg, **kw)
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev) - base
    five_d = 4 * 128 * 128 * nh * hp * 4
    _check(peak < five_d, f"ssm_apply at 4 x 128 peaked {peak} bytes above its "
           f"inputs, not below one (B, c, c, nh, hp) f32 tensor ({five_d})")
    print(f"  ssm_apply peak at B 4 x 128 tokens ({cfg.dtype}, one chunk of 128): "
          f"{peak / 1e6:.1f} MB above its inputs, against {five_d / 1e6:.1f} MB for "
          f"one (B, c, c, nh, hp) f32 tensor", flush=True)
    return dict(errs, prefill_peak_bytes=peak)


def _attn_layers(cfg) -> int:
    return sum(cfg.layer_kind(i) == "attn" for i in range(cfg.n_layers))


def _lane_counts(cfg, plan, runs) -> dict:
    """Launches a paged run of ``plan`` must make: every plan entry's kernel
    once per layer group per lane run (chunks, decode ticks, serial
    prefills); K4 once per attention layer per decode tick and prefill
    chunk (the serial prefill attends without pages)."""
    from repro_torch.models import transformer as tfm
    lane = runs["decode"] + runs["prefill_chunk"] + runs["prefill_serial"]
    want = _plan_launches(plan, tfm.n_groups(cfg), lane)
    if _attn_layers(cfg):
        want["paged_attention"] = _attn_layers(cfg) * (runs["decode"]
                                                       + runs["prefill_chunk"])
    return want


def _serial_vs_chunked(dev, res) -> dict:
    """A chunked paged serve's requests again through the chunked and the
    serial lane, teacher-forced on its tokens, every position's logits
    recorded.  The chunked lane must predict the served tokens exactly (the
    kernels give the same bits on every call); the serial lane (one-shot
    prefill, another K1 row count and SSD chunking) the same tokens, where
    a disagreement is allowed only at a near tie: the gap between the two
    tokens' chunked logits within twice the two lanes' max |diff| at that
    position.  Logits held to phase f's tolerance."""
    import torch
    from repro_torch.serving import BatchScheduler, Request
    sched, cfg = res["sched"], res["cfg"]
    toks = torch.tensor([r.output for r in res["requests"]], device=dev)
    logits = {}
    for mode in ("chunked", "serial"):
        s2 = BatchScheduler(cfg, None, n_slots=sched.n_slots, max_len=sched.max_len,
                            plan=res["plan"], kv_cache=sched.spec.cfg,
                            page_size=sched.page_size, prefill=mode, device=dev)
        rec = _recorded(s2, cfg.vocab_size)
        for r in res["requests"]:
            s2.submit(Request(uid=r.uid, prompt=res["prompt"][r.uid].cpu(),
                              max_new_tokens=len(r.output), force_tokens=r.output))
        _reset_kv_counts()
        with torch.inference_mode():
            s2.run_to_completion()
        launched = _kv_counts()
        want = _lane_counts(cfg, res["plan"], s2.lane_runs)
        if "paged_attention" in want:
            want["paged_attention_combine"] = _want_combines(
                s2, {s2.n_slots: s2.lane_runs}, _attn_layers(cfg))
        _zoo_counts(launched, want, f"{mode} lane")
        logits[mode] = torch.stack([torch.stack(rec[r.uid]) for r in res["requests"]])
    got, ref = logits["serial"].float(), logits["chunked"].float()
    _check(bool(torch.equal(ref.argmax(-1), toks)),
           "chunked lane, teacher-forced, does not predict its own served tokens")
    _check(bool(torch.isfinite(got).all()) and got.shape == ref.shape,
           f"serial logits not finite or of shape {tuple(got.shape)}")
    gaps = _near_ties(ref, got, toks, "serial lane")
    err, scale = (got - ref).abs().max().item(), ref.abs().max().item()
    _check(err <= 0.05 * scale, f"serial vs chunked logits: {err} > 0.05 x {scale}")
    same = (got.argmax(-1) == toks).float().mean().item()
    print(f"  serial vs chunked lane, teacher-forced on the served tokens "
          f"({toks.shape[1]} positions x {toks.shape[0]} requests): serial predicts "
          f"the served token at {same:.3f} of positions (near ties otherwise: "
          f"{[(b, t, round(g, 4), round(d, 4)) for b, t, g, d in gaps]}), logits "
          f"max|diff| {err:.4e} (max|logit| {scale:.4e}); each lane's launches exact",
          flush=True)
    return {"tokens_equal_share": same, "near_ties": gaps, "max_abs_diff": err,
            "max_abs_logit": scale}


def _zoo_paged(argv, what):
    """``serve`` with ``argv`` (a paged run), launch counts read around it;
    returns (result, launches, the plan's K1 / K6 / K4 counts wanted)."""
    from repro_torch.launch import serve as S
    _reset_kv_counts()
    res = S.run(argv)
    launched = _kv_counts()
    for line in S.report(res):
        print("  " + line, flush=True)
    sched = res["sched"]
    runs = res["lane_runs"]
    want = _lane_counts(res["cfg"], res["plan"], runs)
    if "paged_attention" in want:
        warm = {k: runs[k] - sched.lane_runs[k] for k in runs}
        want["paged_attention_combine"] = _want_combines(
            sched, {1: warm, sched.n_slots: sched.lane_runs}, _attn_layers(res["cfg"]))
    _zoo_counts(launched, want, what)
    outs = [r.output for r in res["requests"]]
    _check(len(outs) == sched.n_slots and all(len(o) == res["gen"] + 1 for o in outs),
           f"{what}: requests came back with {[len(o) for o in outs]} tokens")
    return res, launched


def phase_q1(dev, gen, clocks) -> dict:
    """Full-width Mamba-2 780M, all 48 layers: K1 at its shapes, the
    dense-cache loop (cuda vs torch family), one layer's chunked
    continuation, the paged runtime (exact K1 counts, nothing else), serial
    vs chunked."""
    import torch
    from repro_torch.launch import serve as S
    from repro_torch.models import mamba2
    out = {"k1": _mamba_k1(dev, gen, clocks)}
    _reset_kv_counts()
    res = S.run(["--arch", SSM_ARCH, "--seed", "0"])
    launched = _kv_counts()
    for line in S.report(res):
        print("  " + line, flush=True)
    cfg, plan = res["cfg"], res["plan"]
    _full_width(cfg, SSM_ARCH)
    _check(plan.summary()["variant_distribution"] == {"cuda:onehot": 2},
           f"plan {plan.summary()['variant_distribution']}, want in_proj and "
           "out_proj on cuda:onehot")
    steps = 1 + res["gen"] + 2     # + the untimed warm-up prefill and decode step
    _zoo_counts(launched, {"onehot": 2 * cfg.n_layers * steps}, "dense-cache loop")
    out["dense_launches"] = launched["onehot"]
    out["dense_prefill_ms"] = res["t_prefill"] * 1e3
    out["dense_decode_ms_per_token"] = res["t_decode"] / res["gen"] * 1e3
    print(f"  dense-cache loop launches {dict(launched)}: K1 = 2 x {cfg.n_layers} "
          f"layers x {steps} steps, nothing else", flush=True)
    # the torch family rounds every dequantized weight to bf16 (as the
    # reference does), which K1 does not: held against the kernels' plain
    # oracle, which computes K1's function; the torch family's distance is
    # printed beside it
    out["dense_logits"] = phase_f(res, family="reference")
    out["dense_logits_torch"] = phase_f(res, gate=False)
    # the same loop at f32 activations (K1 on f32 x): its plain oracle to
    # 1e-3 of max|logit|, where 48 layers of bf16 roundings do not hide a
    # fault
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    with torch.inference_mode():
        toks, _, _, lg = S.serve(cfg32, res["params"], res["prompt"], res["gen"],
                                 device=dev, return_logits=True, warmup=False)
    out["dense_logits_f32"] = phase_f(dict(res, cfg=cfg32, tokens=toks, logits=lg),
                                      family="reference", tol=1e-3)
    out["continuation"] = _ssm_layer_continuation(dev, plan, cfg)
    del res, plan
    torch.cuda.empty_cache()

    res, launched = _zoo_paged(["--arch", SSM_ARCH, "--seed", "0", "--paged",
                                "--kv-cache", "mip2q", "--prompt-len", "128",
                                "--gen", "32"], "paged Mamba-2")
    sched, cfg = res["sched"], res["cfg"]
    runs = res["lane_runs"]
    lane = runs["decode"] + runs["prefill_chunk"]
    payload, int8 = _moe_plan_bytes(res["plan"])
    _check(payload * 8 == int8 * 7, f"packed weights {payload} vs int8 {int8}")
    hot = S.ssm_hot_bytes(sched)
    _, nh, hp, ns, conv_dim = mamba2._dims(cfg)
    want_hot = cfg.n_layers * sched.n_slots * ((cfg.ssm_conv - 1) * conv_dim * 2
                                               + nh * hp * ns * 4)
    _check(hot == want_hot and sched.cache_stats()["n_pages"] == 0,
           f"SSM hot state {hot} bytes, want {want_hot}; pages "
           f"{sched.cache_stats()['n_pages']}")
    dec = sorted(ms for kind, ms in res["ticks"] if kind == "decode")
    out.update(drain_ms=res["drain_s"] * 1e3, ticks=len(res["ticks"]),
               decode_tick_ms=_spread(dec), decode_ticks=len(dec), lane_runs=runs,
               paged_launches=launched["onehot"], hot_state_bytes=hot,
               packed_weight_bytes=payload, weights_ratio_vs_int8=payload / int8)
    print(f"  paged launches {launched}: K1 = 2 x {cfg.n_layers} layers x {lane} lane "
          f"runs {runs}, K4 / K5 / K11 / combine never; weights {payload / 1e9:.4f} GB "
          f"packed vs int8 {int8 / 1e9:.4f} GB (x{payload / int8:.4f}); SSM hot state "
          f"{hot / 1e6:.3f} MB ({sched.n_slots} slots: conv bf16 + state f32)", flush=True)
    out["lanes"] = _serial_vs_chunked(dev, res)
    return out


def phase_q2(dev) -> dict:
    """The Jamba hybrid at its SMOKE shape (4 layers, period 2: SSM + MLP,
    attention + MoE) through the paged runtime with mip2q KV pages: K1, K4
    and K6 in one tick, exact counts; serial vs chunked; logits vs the
    torch family; speculative refused."""
    import torch
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.launch import serve as S
    from repro_torch.serving import BatchScheduler
    print("  the SMOKE shape: the published width does not fit one card at any "
          "depth (one period of 8 layers ~154 GB in f32 before packing)", flush=True)
    res, launched = _zoo_paged(["--arch", HYBRID_ARCH, "--smoke", "--seed", "0",
                                "--paged", "--kv-cache", "mip2q", "--prompt-len", "128",
                                "--gen", "32"], "paged Jamba smoke")
    sched, cfg, plan = res["sched"], res["cfg"], res["plan"]
    _check(dataclasses.replace(cfg, strum=None) == get_smoke_config(HYBRID_ARCH),
           f"not Jamba's smoke config: {cfg}")
    dist = plan.summary()["variant_distribution"]
    _check(dist == {"cuda:onehot": 9, "cuda:grouped": 3},
           f"plan {dist}, want 9 linears on cuda:onehot and 3 expert stacks on "
           "cuda:grouped")
    _check((sched.spec.variant, sched.spec.attn_variant) ==
           ("cache:cuda_decode", "cache:attn_fused"),
           f"paged serve selected {sched.spec.variant}, {sched.spec.attn_variant}")
    st = sched.cache_stats()
    _check(st["ratio_vs_int8"] == 0.875 and
           st["resident_page_bytes"] == st["expected_page_bytes"],
           f"packed pages x{st['ratio_vs_int8']} of int8 ({st})")
    runs = res["lane_runs"]
    print(f"  launches {launched} over lane runs {runs}: per run K1 18 (5 SSM + MLP "
          f"and 4 attention linears x 2 groups), K4 2, K6 6 (3 stacks x 2 MoE layers)",
          flush=True)
    out = {"launches": dict(launched), "lane_runs": runs, "drain_ms": res["drain_s"] * 1e3,
           "hot_state_bytes": S.ssm_hot_bytes(sched),
           "lanes": _serial_vs_chunked(dev, res)}
    logits = _paged_vs_torch(dev, res)
    del logits["cuda_logits"]
    out["logits"] = logits
    try:
        BatchScheduler(cfg, None, plan=plan, speculative=3, device=dev)
    except ValueError as e:
        _check("attention-only" in str(e), f"speculative=3 raised {e}")
        print(f"  speculative=3 refused: {e}", flush=True)
    else:
        _check(False, "speculative=3 on the hybrid did not raise")
    del res, plan, sched
    torch.cuda.empty_cache()
    return out


def _embeds_vs_torch(dev, res) -> dict:
    """The stub frontend: seeded embeddings (2, 32, D) through ``prefill``
    and ``forward_train`` on the run's plan (K1, counted) and on a torch
    family plan of the same weights; logits to phase f's tolerance."""
    import torch
    from repro_torch.launch.steps import build_serving_plan
    from repro_torch.models import forward_train, model_defs, prefill
    from repro_torch.models.params import init_params
    cfg = res["cfg"]
    params = init_params(model_defs(cfg), seed=0, device=dev, dtype_override="float32")
    torch_plan = build_serving_plan(params, cfg=cfg.strum, backend="torch", device=dev)
    del params
    g = torch.Generator(device=dev).manual_seed(3)
    e = torch.randn((2, 32, cfg.d_model), generator=g, device=dev) * 0.02
    got = {}
    for family, plan in (("cuda", res["plan"]), ("torch", torch_plan)):
        _reset_kv_counts()
        with torch.inference_mode():
            last, _ = prefill(plan.params, {"embeds": e}, cfg)
            full, _ = forward_train(plan.params, {"embeds": e}, cfg)
        launched = _kv_counts()
        want = _plan_launches(plan, cfg.n_layers, 2) if family == "cuda" else {}
        _zoo_counts(launched, want, f"embeds through the {family} family")
        got[family] = (last.float(), full.float())
    del torch_plan
    (lc, fc), (lt, ft) = got["cuda"], got["torch"]
    _check(bool(torch.isfinite(lc).all() and torch.isfinite(fc).all()),
           "embeds logits not finite")
    err = max((lc - lt).abs().max().item(), (fc - ft).abs().max().item())
    scale = ft.abs().max().item()
    agree = (fc.argmax(-1) == ft.argmax(-1)).float().mean().item()
    _check(err <= 0.05 * scale and agree >= 0.9,
           f"embeds logits: max|diff| {err} (0.05 x {scale}), argmax agreement {agree}")
    print(f"  embeds (2 x 32 x {cfg.d_model}) through prefill and forward_train, cuda "
          f"vs torch family: max|diff| {err:.4e} (max|logit| {scale:.4e}), argmax "
          f"agreement {agree:.3f}", flush=True)
    return {"max_abs_diff": err, "max_abs_logit": scale, "argmax_agreement": agree}


def _zoo_attention(dev, gen, clocks) -> list:
    """K4 against its plain version at StableLM-2-12B's head dim 160 and
    MusicGen-medium's 64 with 24 KV heads, as phase g holds it (mip2q p=0.5
    L=7 pages of 16, 4 slots at 2048 tokens, one empty, one half -1), and
    timed as phase g times it."""
    import torch
    from repro_torch.core.policy import StruMConfig
    from repro_torch.kernels import strum_attention as A
    cfg = StruMConfig(method="mip2q", p=0.5, L=7)
    kw = dict(w=cfg.w, q=cfg.q, method=cfg.method, n_low=cfg.n_low)
    cases = []
    for label, kv, r, hd in ZOO_ATTN:
        ctx, ps = 2048, PAGE
        p_slot = ctx // ps
        ids, n_valid = _attn_table(dev, p_slot)
        live = int(((ids >= 0) & (torch.arange(p_slot, device=dev)[None, :]
                                  < n_valid[:, None])).sum())
        q4 = (torch.randn((4, kv, r, hd), generator=gen, device=dev) / hd ** 0.5).contiguous()
        k, v = _kv_pools(dev, gen, cfg, 4 * p_slot, kv * hd, ps)
        args = _kv_args("paged_attention", k, v)
        got = A.strum_paged_attention(q4, *args, ids, n_valid, **kw)
        want = A.strum_paged_attention_plain(q4, *args, ids, n_valid, **kw)
        torch.cuda.synchronize()
        errs = _held(got, want, f"paged_attention {label}")
        case = {"case": f"{label}, {kv} kv heads x {hd}, R={r}, context {ctx}, {live} "
                        f"live pages of {ps}", "max_abs_err": max(errs.values()),
                "errs": errs}
        case.update(_time_attention(clocks, "paged_attention", A.strum_paged_attention,
                                    A.strum_paged_attention_plain, q4, args, ids,
                                    n_valid, kw, k, v, live, r, hd, kv, ps))
        print(f"  paged_attention          {case['case']}: max |kernel - plain| on live "
              "rows " + ", ".join(f"{k_} {e_:.3e}" for k_, e_ in errs.items()) +
              f"; kernel {case['ms']:.4f} ms (graph replay; eager call "
              f"{case['eager_ms']:.4f}), plain {case['plain_ms']:.4f}, sdpa bf16 "
              f"{case['library_ms']:.4f}, bound {case['bound_ms']:.4f} "
              f"({case['bound_by']}, {case['bytes'] / 1e6:.2f} MB); {case['clock']}",
              flush=True)
        cases.append(case)
        del k, v, args
        torch.cuda.empty_cache()
    return cases


def phase_q3(dev, gen, clocks) -> dict:
    """DeepSeek-67B, StableLM-2-12B, InternVL2-26B's backbone and
    MusicGen-medium at full width, 2 layers: 2 requests of 64 + 9 tokens
    paged (exact launches), teacher-forced against the torch family; the
    stub-frontend configs through ``embeds``; K4 at head dims 160 and 64."""
    import torch
    from repro_torch.configs.base import get_config
    out = {}
    for arch in DENSE_ZOO:
        res, launched = _zoo_paged(
            ["--arch", arch, "--layers", str(ZOO_LAYERS), "--seed", "0", "--paged",
             "--kv-cache", "mip2q", "--batch", "2", "--prompt-len", "64", "--gen", "8"],
            f"paged {arch}")
        cfg, sched = res["cfg"], res["sched"]
        _full_width(cfg, arch, ZOO_LAYERS)
        linears = 4 + (3 if cfg.gated_mlp else 2)
        _check(res["plan"].summary()["variant_distribution"] == {"cuda:onehot": linears}
               and sched.spec.attn_variant == "cache:attn_fused",
               f"{arch}: plan {res['plan'].summary()['variant_distribution']}, "
               f"attention {sched.spec.attn_variant}")
        st = sched.cache_stats()
        _check(st["ratio_vs_int8"] == 0.875, f"{arch}: pages x{st['ratio_vs_int8']}")
        row = {"launches": dict(launched), "lane_runs": res["lane_runs"],
               "drain_ms": res["drain_s"] * 1e3, "hd": cfg.hd,
               "params": get_config(arch).param_count()}
        row["logits"] = _paged_vs_torch(dev, res)
        del row["logits"]["cuda_logits"]
        if cfg.modality in ("vlm", "audio"):
            row["embeds"] = _embeds_vs_torch(dev, res)
        print(f"  {arch}: d {cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} kv x "
              f"{cfg.hd}, d_ff {cfg.d_ff} ({'gated' if cfg.gated_mlp else 'GELU'}), "
              f"vocab {cfg.vocab_size}; launches {dict(launched)} (K1 {linears} x "
              f"{ZOO_LAYERS} layers, K4 {ZOO_LAYERS} per lane run)", flush=True)
        out[arch] = row
        del res, sched
        torch.cuda.empty_cache()
    out["attention"] = _zoo_attention(dev, gen, clocks)
    return out


def measure_zoo(dev, clocks) -> dict:
    """Phase q, each sub-phase fatal; returns its records with seconds."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(12)
    sub = {}
    for key, what, fn in (
            ("q1", "full-width Mamba-2 780M, all 48 layers: K1 at its shapes, the "
                   "dense-cache loop, the paged runtime",
             lambda: phase_q1(dev, gen, clocks)),
            ("q2", "the Jamba hybrid (SMOKE shape): K1, K4 and K6 in one tick",
             lambda: phase_q2(dev)),
            ("q3", f"DeepSeek-67B, StableLM-2-12B, InternVL2-26B, MusicGen-medium at "
                   f"full width, {ZOO_LAYERS} layers; K4 at hd 160 and 64",
             lambda: phase_q3(dev, gen, clocks))):
        t0 = time.perf_counter()
        print(f"-- {key}. {what} (t = {t0 - _T0:.1f} s)", flush=True)
        sub[key] = fn()
        sub[key]["seconds"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    return sub


# --------------------------------------------------------- phase r: train --

TRAIN_DIR = ROOT / "build" / "phase_r"
# r1: launch.train's own flags at full width (OLMo-1B, 16 layers, f32
# parameters, bf16 activations, the config's remat); steps of each run
TRAIN_ARGV = ["--arch", "olmo_1b", "--batch", "4", "--seq", "2048", "--ckpt-every",
              "0", "--device", "cuda"]
TRAIN_STEPS, COMPRESSED_STEPS = 5, 3
# r4a: tests/test_system.py's model and data
SYS_TINY = dict(name="sys_tiny", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                head_dim=16, d_ff=128, vocab_size=256, remat=False, attn_chunk=32)
SYS_STEPS = 120


def _train_flops(cfg, b: int, s: int) -> dict:
    """Operations of one train step from its shapes: every product (the
    linears and the tied head, ``param_count``) 6·N·T, causal attention
    (QK and PV over the lower triangle) 6·b·s²·H·hd a layer; remat runs the
    blocks' forward a second time."""
    tokens = b * s
    head = cfg.padded_vocab * cfg.d_model
    blocks = cfg.param_count() - cfg.vocab_size * cfg.d_model * (
        1 if cfg.tie_embeddings else 2)
    attn_fwd = 2 * b * s * s * cfg.n_heads * cfg.hd * cfg.n_layers
    model = 6 * (blocks + head) * tokens + 3 * attn_fwd
    remat = (2 * blocks * tokens + attn_fwd) if cfg.remat else 0
    return {"model": model, "with_remat": model + remat}


def _state_on_cuda(state) -> bool:
    from repro_torch.core.apply import _named_leaves
    return all(t.device.type == "cuda" for _, t in _named_leaves(state))


def _train_run(dev, argv, steps, what) -> dict:
    """``launch.train``'s parts from its flags, ``steps`` steps through its
    ``TrainLoopRunner``, each step synchronized and timed; returns the
    final state, per-step ms and metrics, the peak memory and launches."""
    import shutil
    import torch
    from repro_torch.core.apply import _named_leaves
    from repro_torch.data.pipeline import global_batch
    from repro_torch.launch import train as T
    from repro_torch.runtime.fault_tolerance import TrainLoopRunner
    cfg, _, dcfg, cold_start, step_fn = T.build(
        T.parse_args(argv + ["--steps", str(steps)]))
    work = TRAIN_DIR / what
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    resident = torch.cuda.memory_allocated(dev)
    _reset_kv_counts()
    state = cold_start()
    first = {n: t.reshape(-1)[:4096].clone() for n, t in _named_leaves(state["params"])}
    times, metrics = [], []

    def timed(state, batch):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = step_fn(state, batch)
        torch.cuda.synchronize(dev)
        times.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: float(v) for k, v in out[1].items()})
        return out
    runner = TrainLoopRunner(str(work), ckpt_every=0)
    state = runner.run(state, 0, steps, timed,
                       lambda s: global_batch(dcfg, s, device=dev), log_every=1,
                       log_fn=lambda line: print("    " + line, flush=True))
    launched = _kv_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    moved = [n for n, t in _named_leaves(state["params"])
             if not torch.equal(t.reshape(-1)[:4096], first[n])]
    _check(all(math.isfinite(m[k]) for m in metrics for k in ("loss", "grad_norm")),
           f"{what}: a loss or grad norm is not finite: {metrics}")
    _check(len(moved) == len(first), f"{what}: parameters that did not move: "
           f"{sorted(set(first) - set(moved))}")
    _check(_state_on_cuda(state), f"{what}: a leaf of the state left the card")
    _check(sum(launched.values()) == 0, f"{what}: StruM kernels launched: {launched}")
    return {"cfg": cfg, "data": dcfg, "state": state, "step_ms": times,
            "metrics": metrics, "peak_bytes": peak, "resident_before_bytes": resident}


def phase_r1(dev) -> dict:
    """Full-width OLMo-1B, all 16 layers, through ``launch.train``'s code:
    TRAIN_STEPS plain steps, then COMPRESSED_STEPS with --grad-compression;
    finite, moving, on the card, no StruM kernel."""
    import torch
    out = {}
    for key, extra, steps in (("plain", [], TRAIN_STEPS),
                              ("compressed", ["--grad-compression"], COMPRESSED_STEPS)):
        run = _train_run(dev, TRAIN_ARGV + extra, steps, f"r1_{key}")
        cfg, dcfg = run["cfg"], run["data"]
        if key == "plain":
            _full_width(cfg, "olmo_1b")
            _check(cfg.remat and cfg.dtype == "bfloat16", f"r1 config {cfg}")
            out["params"] = run["state"]["params"]      # for r4b
        del run["state"]
        torch.cuda.empty_cache()
        warm = run["step_ms"][1:]
        tokens = dcfg.global_batch * dcfg.seq_len
        flops = _train_flops(cfg, dcfg.global_batch, dcfg.seq_len)
        bound = {k: v / PEAK_FLOPS["torch.float32"] * 1e3 for k, v in flops.items()}
        rec = {"step_ms": run["step_ms"], "warm_step_ms": _spread(warm),
               "tokens_per_s": tokens / statistics.median(warm) * 1e3,
               "peak_bytes": run["peak_bytes"],
               "resident_before_bytes": run["resident_before_bytes"], "flops": flops,
               "f32_bound_ms": bound, "metrics": run["metrics"]}
        out[key] = rec
        w = rec["warm_step_ms"]
        print(f"  r1 {key}: {steps} steps of batch {dcfg.global_batch} x seq "
              f"{dcfg.seq_len}; ms per step after the first: median {w['median']:.1f} "
              f"[{w['min']:.1f}, {w['max']:.1f}] (first {run['step_ms'][0]:.1f}); "
              f"{rec['tokens_per_s']:.0f} tokens/s; peak memory "
              f"{rec['peak_bytes'] / 1e9:.2f} GB (of it "
              f"{rec['resident_before_bytes'] / 1e9:.2f} GB held before the run); losses "
              f"{[round(m['loss'], 4) for m in run['metrics']]}, grad norms "
              f"{[round(m['grad_norm'], 4) for m in run['metrics']]}; f32 bound "
              f"{bound['model']:.1f} ms ({flops['model'] / 1e12:.1f} TFLOP: 6·N·T + "
              f"causal attention), {bound['with_remat']:.1f} ms with remat's second "
              f"forward ({flops['with_remat'] / 1e12:.1f} TFLOP) at "
              f"{PEAK_FLOPS['torch.float32'] / 1e12:.0f} TFLOP/s; median / bound "
              f"{w['median'] / bound['with_remat']:.2f}; no StruM kernel launched",
              flush=True)
    return out


def _step_gap(opt_cfg, params, ga, gb, pa, pb, lr: float, norms: tuple) -> dict:
    """How far two first AdamW steps from the same parameters, one from
    gradients ``ga`` of global norm ``norms[0]`` (giving ``pa``), one from
    ``gb`` (``norms[1]``, giving ``pb``), may differ, element by element,
    and how far they do.  At step 1 the update is lr · (e / (|e| + eps) +
    decay), e the clipped gradient; e / (|e| +
    eps) moves by at most eps · |Δe| / (m + eps)², m the smallest |e| between
    the two (0 where their signs differ), and never by more than 2.  Adding
    f32 rounding, |Δp| <= lr · min(2, eps · |Δe| / (m + eps)²) + 2^-20 ·
    (|p| + lr) must hold everywhere.  Where both |e| >= 1e3 · eps the
    sensitivity is small, and there the steps are also held at 1e-5 of each
    leaf's largest |p| (``rel``); ``outside`` counts the other elements."""
    import torch
    from repro_torch.core.apply import _named_leaves
    sa, sb = (min(1.0, opt_cfg.clip_norm / max(n, 1e-9)) for n in norms)
    la, lb, lpa, lpb = (dict(_named_leaves(t)) for t in (ga, gb, pa, pb))
    eps, ulp = opt_cfg.eps, 2.0 ** -20
    worst_ratio, worst_rel, outside, total, at = 0.0, 0.0, 0, 0, {}
    for n, p in _named_leaves(params):
        ea, eb = la[n].double() * sa, lb[n].double() * sb
        dp = (lpa[n].double() - lpb[n].double()).abs()
        m = torch.where(torch.sign(ea) == torch.sign(eb),
                        torch.minimum(ea.abs(), eb.abs()), torch.zeros_like(ea))
        sens = torch.clamp(eps * (ea - eb).abs() / (m + eps) ** 2, max=2.0)
        bound = lr * sens + ulp * (p.double().abs() + lr)
        r = dp / bound
        ratio = r.max().item()
        if ratio > worst_ratio:
            i = r.argmax()
            worst_ratio, at = ratio, {"leaf": n, "index": int(i), **{
                k: v.reshape(-1)[i].item() for k, v in (
                    ("e", ea), ("e_other", eb), ("p", p), ("p_step", lpa[n]),
                    ("p_step_other", lpb[n]), ("allowed", bound))}}
        big = m >= 1e3 * eps
        outside += int((~big).sum())
        total += m.numel()
        if big.any():
            worst_rel = max(worst_rel, dp[big].max().item()
                            / max(lpb[n].abs().max().item(), 1e-30))
    return {"bound_ratio": worst_ratio, "bound_at": at, "rel": worst_rel,
            "outside": outside, "elements": total}


def phase_r2(dev) -> dict:
    """One train step at full width, 2 layers, batch 1 x seq 256, f32
    activations, on the card and on the CPU from the same parameters."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.core.apply import _named_leaves, map_named
    from repro_torch.data.pipeline import DataConfig, global_batch
    from repro_torch.launch import steps as St
    from repro_torch.launch import train as T
    from repro_torch.models import model_defs
    from repro_torch.models.params import init_params
    from repro_torch.optim.adamw import adamw_update, init_opt_state
    # AdamW as the trainer builds it for r1; the model cut to 2 layers here
    _, opt_cfg, _, _, _ = T.build(T.parse_args(
        ["--arch", "olmo_1b", "--steps", str(TRAIN_STEPS), "--device", "cuda"]))
    cfg = dataclasses.replace(get_config("olmo_1b"), n_layers=2)
    _full_width(cfg, "olmo_1b", layers=2)
    cfg = dataclasses.replace(cfg, dtype="float32")
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=256, global_batch=1, seed=0)
    params = init_params(model_defs(cfg), seed=0, device=dev, dtype_override="float32")
    runs = {}
    for name, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
        p = map_named(lambda _, t: t.to(d), params)
        batch = global_batch(dcfg, 0, device=d)
        # the train step's two calls, so that its gradients can be read: the
        # CPU's embedding gradient is not repeatable from call to call (the
        # backward of ``table[ids]`` adds repeated ids' rows in parallel)
        (loss, _), grads = St._value_and_grad(p, batch, cfg)
        new_p, _, m = adamw_update(opt_cfg, p, grads, init_opt_state(p))
        runs[name] = {"loss": float(loss), "lr": float(m["lr"]),
                      "grad_norm": float(m["grad_norm"]),
                      "grads": map_named(lambda _, g: g.cpu(), grads),
                      "params": map_named(lambda _, t: t.cpu(), new_p)}
        if name == "cuda":   # on the card make_train_step gives those bits
            step_p, _, sm = St.make_train_step(cfg, opt_cfg)(p, init_opt_state(p), batch)
            _check(float(sm["loss"]) == runs[name]["loss"] and all(
                torch.equal(x, y) for (_, x), (_, y) in zip(
                    _named_leaves(step_p), _named_leaves(new_p))),
                "r2: make_train_step on the card is not its gradient and AdamW calls")
            del step_p
        del p, grads, new_p
    a, b = runs["cuda"], runs["cpu"]
    p_cpu = map_named(lambda _, t: t.cpu(), params)
    # AdamW on the CPU from the card's gradients: the update alone, on the
    # same inputs as the card's
    same_in, _, _ = adamw_update(opt_cfg, p_cpu, a["grads"], init_opt_state(p_cpu))

    def worst(x, y):
        """(max |x - y| / max|y| over leaves, the leaf)."""
        ly = dict(_named_leaves(y))
        return max(((t.double() - ly[n].double()).abs().max().item()
                    / max(ly[n].abs().max().item(), 1e-30), n)
                   for n, t in _named_leaves(x))
    loss_rel = abs(a["loss"] - b["loss"]) / abs(b["loss"])
    g_rel, p_rel = worst(a["grads"], b["grads"])[0], worst(a["params"], same_in)[0]
    step_rel, leaf = worst(a["params"], b["params"])
    gap = _step_gap(opt_cfg, p_cpu, a["grads"], b["grads"], a["params"], b["params"],
                    max(a["lr"], b["lr"]), (a["grad_norm"], b["grad_norm"]))
    # the largest whole-step gap, and the two gradients there
    i = (dict(_named_leaves(a["params"]))[leaf]
         - dict(_named_leaves(b["params"]))[leaf]).abs().argmax()
    dp_at, g_at = (tuple(dict(_named_leaves(x[k]))[leaf].reshape(-1)[i].item()
                         for x in (a, b)) for k in ("params", "grads"))
    print(f"  r2 card vs CPU, one step at full width, 2 layers, batch 1 x seq 256, f32: "
          f"loss {a['loss']:.6f} vs {b['loss']:.6f} (rel {loss_rel:.2e}); gradients "
          f"max |diff| / max|g| over leaves {g_rel:.2e}; AdamW from the same gradients "
          f"{p_rel:.2e} of max|p|; the two whole steps: {step_rel:.2e} of max|p| at "
          f"worst ({leaf}: |Δp| {abs(dp_at[0] - dp_at[1]):.3e} where g is "
          f"{g_at[0]:.4e} on the card, {g_at[1]:.4e} on the CPU, grad norms "
          f"{a['grad_norm']:.6f} / {b['grad_norm']:.6f}), at most {gap['bound_ratio']:.3f} of what the gradient gap "
          f"allows (lr · min(2, eps·|Δe|/(m+eps)²) + rounding; worst at "
          f"{gap['bound_at'].get('leaf')}), {gap['rel']:.2e} of max|p| where |e| >= 1e3·eps "
          f"({gap['outside']} of {gap['elements']} elements below it)", flush=True)
    _check(loss_rel <= 1e-4, f"r2 loss differs: {loss_rel} > 1e-4 relative")
    _check(g_rel <= 1e-3, f"r2 gradients differ: {g_rel} > 1e-3 of max|g|")
    _check(p_rel <= 1e-5, f"r2 AdamW differs on the same gradients: {p_rel} > 1e-5")
    _check(gap["bound_ratio"] <= 1.0, f"r2 whole steps differ past what the gradient "
           f"gap allows: {gap}")
    _check(gap["rel"] <= 1e-5, f"r2 whole steps differ where |e| >= 1e3·eps: {gap}")
    return {"loss_rel": loss_rel, "grad_rel": g_rel, "param_rel": p_rel,
            "step_param_rel": step_rel, "step_gap": gap,
            "worst_step": {"leaf": leaf, "p": list(dp_at), "g": list(g_at)}}


def _resume_runs(dev) -> tuple:
    """Six steps of the OLMo smoke config through ``TrainLoopRunner``
    (ckpt_every=3) without a break, and three, a new runner through
    ``resume_or_init`` and three more; returns both final states."""
    import shutil
    from repro_torch.data.pipeline import global_batch
    from repro_torch.launch import train as T
    from repro_torch.runtime.fault_tolerance import TrainLoopRunner, resume_or_init
    argv = ["--arch", "olmo_1b", "--smoke", "--batch", "8", "--seq", "64", "--steps",
            "6", "--ckpt-every", "3", "--device", "cuda"]
    _, _, dcfg, cold_start, step_fn = T.build(T.parse_args(argv))

    def batch(s):
        return global_batch(dcfg, s, device=dev)
    states = []
    for name in ("whole", "resumed"):
        shutil.rmtree(TRAIN_DIR / f"r3_{name}", ignore_errors=True)
    whole = TrainLoopRunner(str(TRAIN_DIR / "r3_whole"), ckpt_every=3)
    states.append(whole.run(cold_start(), 0, 6, step_fn, batch, log_every=0))
    first = TrainLoopRunner(str(TRAIN_DIR / "r3_resumed"), ckpt_every=3)
    first.run(cold_start(), 0, 3, step_fn, batch, log_every=0)
    again = TrainLoopRunner(str(TRAIN_DIR / "r3_resumed"), ckpt_every=3)
    state, start = resume_or_init(again.ckpt_dir, cold_start(), cold_start)
    _check(start == 3 and int(state["opt"].step) == 3 and _state_on_cuda(state),
           f"r3 resumed at step {start}")
    states.append(again.run(state, start, 6, step_fn, batch, log_every=0))
    return states


def _state_diff(a, b) -> list:
    """(max |diff|, leaf) of every leaf that differs, largest first."""
    import torch
    from repro_torch.core.apply import _named_leaves
    lb = dict(_named_leaves(b))
    return sorted(((x.double() - lb[n].double()).abs().max().item(), n)
                  for n, x in _named_leaves(a) if not torch.equal(x, lb[n]))[::-1]


def phase_r3(dev) -> dict:
    """Resume: six steps without a break equal three + restore + three,
    bit for bit (the dense smoke config: no MoE atomics); where they differ,
    the failure names the leaves with the largest differences."""
    diff = _state_diff(*_resume_runs(dev))
    _check(not diff, f"r3 resume is not bit-identical: {len(diff)} leaves differ, "
           f"largest (max |diff|, leaf) {diff[:5]}")
    print("  r3 six steps == three + resume_or_init + three, every parameter and "
          "optimizer leaf bit for bit", flush=True)
    return {"leaves_differing": 0}


def _sys_tiny_trained(dev):
    import torch
    from repro_torch.configs.base import ModelConfig
    from repro_torch.data.pipeline import DataConfig, global_batch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model_defs
    from repro_torch.models.params import init_params
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    cfg = ModelConfig(**SYS_TINY)
    data = DataConfig(vocab_size=256, seq_len=64, global_batch=8, seed=3)
    params = init_params(model_defs(cfg), seed=0, device=dev, dtype_override="float32")
    opt = init_opt_state(params)
    step = make_train_step(cfg, AdamWConfig(lr=3e-3, warmup_steps=10,
                                            total_steps=SYS_STEPS))
    losses = []
    for s in range(SYS_STEPS):
        params, opt, m = step(params, opt, global_batch(data, s, device=dev))
        losses.append(m["ce"])
    return cfg, data, params, [float(x) for x in torch.stack(losses).cpu()]


def _eval_ce(params, cfg, data, dev, steps=(9000, 9001, 9002)) -> float:
    import torch
    from repro_torch.data.pipeline import global_batch
    from repro_torch.models import loss_fn
    with torch.no_grad():
        return statistics.mean(float(loss_fn(params, global_batch(data, s, device=dev),
                                             cfg)[1]["ce"]) for s in steps)


def phase_r4a(dev) -> dict:
    """tests/test_system.py's flow on the card: train sys_tiny, then the
    PTQ CE ordering (its "int8" arm is ``default_policy(None)``, as the
    reference writes it)."""
    from repro_torch.core.policy import StruMConfig, default_policy
    from repro_torch.engine import fake_quantize
    cfg, data, params, losses = _sys_tiny_trained(dev)
    first, last = statistics.mean(losses[:10]), statistics.mean(losses[-10:])
    base = _eval_ce(params, cfg, data, dev)
    ce = {"fp32": base, "int8": _eval_ce(fake_quantize(
        params, policy=default_policy(None), device=dev), cfg, data, dev)}
    for method, kw in [("sparsity", {}), ("dliq", dict(q=4)), ("mip2q", dict(L=7))]:
        ce[method] = _eval_ce(fake_quantize(params, policy=default_policy(
            StruMConfig(method=method, p=0.5, **kw)), device=dev), cfg, data, dev)
    print(f"  r4a sys_tiny, {SYS_STEPS} steps on the card: mean CE of the first 10 "
          f"{first:.4f}, of the last 10 {last:.4f}; PTQ CE "
          f"{ {k: round(v, 4) for k, v in ce.items()} }", flush=True)
    _check(last < first - 0.5, f"r4a loss fell {first - last:.4f} < 0.5")
    _check(abs(ce["int8"] - base) < 0.05, f"r4a int8 CE {ce['int8']} vs fp32 {base}")
    _check(ce["dliq"] - ce["int8"] < 0.10 and ce["mip2q"] - ce["int8"] < 0.10,
           f"r4a mixed precision off int8: {ce}")
    _check(ce["sparsity"] > max(ce["dliq"], ce["mip2q"]), f"r4a sparsity not worst: {ce}")
    return {"first10": first, "last10": last, "ptq_ce": ce}


def _k1_layer_at(dev, params, m, clocks) -> dict:
    """K1 on the trained layer 0's seven linears at M = m (bf16 x), held to
    its plain version, timed beside the plain version and bf16
    ``torch.matmul`` on the dequantized weight; bound as phase c's."""
    import torch
    from repro_torch.core.apply import pack_array
    from repro_torch.core.policy import StruMConfig
    blk = params["blocks"]["pos0"]
    ws = [blk["attn"][k]["w"][0] for k in ("wq", "wk", "wv", "wo")] + \
        [blk["mlp"][k]["w"][0] for k in ("wi", "wg", "wo")]
    gen = torch.Generator(device=dev).manual_seed(21)
    calls, err = [], 0.0
    for w in ws:
        packed = pack_array(w, StruMConfig())
        wrapper, plain, fields, kw = _kernel_args("onehot", packed)
        x = torch.randn((m, packed.k_dim), generator=gen, device=dev).to(torch.bfloat16)
        y, y_plain = wrapper(x, *fields, **kw), plain(x, *fields, **kw)
        lim = KERNEL_TOL * y_plain.abs().max().item()
        e = (y - y_plain).abs().max().item()
        _check(e <= lim, f"K1 at M={m} K={packed.k_dim} N={packed.n_out}: {e} > {lim}")
        err = max(err, e)
        calls.append((wrapper, plain, x, fields, kw, packed, packed_dequant(packed)))
        del y, y_plain
    t = _interleaved(clocks, {
        "ms": (lambda: [c[0](c[2], *c[3], **c[4]) for c in calls], 3),
        "plain_ms": (lambda: [c[1](c[2], *c[3], **c[4]) for c in calls], 1),
        "library_ms": (lambda: [torch.matmul(c[2], c[6]) for c in calls], 3)})
    nbytes = sum(_read_bytes("onehot", c[5], c[2]) for c in calls)
    flops = sum(2 * m * c[5].k_dim * c[5].n_out for c in calls)
    rec = dict(t, max_abs_err=err, **_bound(nbytes, flops, PEAK_FLOPS["torch.bfloat16"]))
    print(f"  r4b K1, one trained layer (7 linears) at M = {m}, bf16 x, median [min, "
          f"max] of {ROUNDS}: kernel {t['ms']:.3f} {t['range_ms']['ms']} ms, plain "
          f"{t['plain_ms']:.3f} ms, torch.matmul bf16 {t['library_ms']:.3f} ms; bound "
          f"{rec['bound_ms']:.3f} ms ({rec['bound_by']}: {nbytes / 1e6:.1f} MB in "
          f"{rec['bytes_ms']:.4f} ms, {flops / 1e12:.3f} TFLOP in {rec['ops_ms']:.3f} "
          f"ms at 989 TFLOP/s); max |kernel - plain| {err:.3e}; {t['clock']}", flush=True)
    return rec


def phase_r4b(dev, params, clocks) -> dict:
    """r1's trained full-width parameters through the default plan: CE
    through ``loss_fn`` over the packed leaves (K1, 112 launches a forward
    at M = 8192) against CE through ``fake_quantize`` of the same config
    (no INT8 baseline on the other leaves: the plan leaves them dense)."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.core.policy import StruMConfig
    from repro_torch.data.pipeline import DataConfig, global_batch
    from repro_torch.engine import build_plan, fake_quantize
    from repro_torch.models import loss_fn
    scfg = StruMConfig()
    cfg = get_config("olmo_1b")
    qcfg = dataclasses.replace(cfg, strum=scfg)
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=2048, global_batch=4, seed=0)
    batch = global_batch(data, 9000, device=dev)
    plan = build_plan(params, cfg=scfg, device=dev)
    _check(set(plan.variants().values()) == {"cuda:onehot"},
           f"r4b plan {plan.summary()['variant_distribution']}")
    with torch.no_grad():
        _reset_kv_counts()
        ce_packed = float(loss_fn(plan.params, batch, qcfg)[1]["ce"])
        launched = _kv_counts()
        want = 7 * cfg.n_layers
        _zoo_counts(launched, {"onehot": want}, "r4b packed loss_fn")
        fq = fake_quantize(params, cfg=scfg, baseline_int8=False, device=dev)
        ce_fq = float(loss_fn(fq, batch, cfg)[1]["ce"])
        del fq
        ce_dense = float(loss_fn(params, batch, cfg)[1]["ce"])
    rel = abs(ce_packed - ce_fq) / abs(ce_fq)
    print(f"  r4b trained OLMo-1B, batch 4 x 2048 (M = 8192): CE packed {ce_packed:.5f} "
          f"(K1 {launched['onehot']} launches = 7 x {cfg.n_layers}), fake-quantized "
          f"{ce_fq:.5f} (rel {rel:.2e}), dense {ce_dense:.5f}", flush=True)
    _check(math.isfinite(ce_packed) and rel <= 1e-2,
           f"r4b packed CE {ce_packed} vs fake-quantized {ce_fq}: {rel} > 1e-2")
    k1 = _k1_layer_at(dev, params, 4 * 2048, clocks)
    return {"plan": plan, "ce_packed": ce_packed, "ce_fake_quant": ce_fq,
            "ce_dense": ce_dense, "rel": rel, "k1_launches": launched["onehot"],
            "k1": k1}


def phase_r4c(dev, plan) -> dict:
    """The trained packed weights served through the paged runtime, 2
    requests of 128 + 8 tokens, mip2q KV pages: K1 and K4 launches exact."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.policy import StruMConfig
    from repro_torch.data.pipeline import DataConfig, global_batch
    from repro_torch.launch import serve as S
    cfg = dataclasses.replace(get_config("olmo_1b"), strum=StruMConfig())
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=128, global_batch=2, seed=0)
    prompt = global_batch(data, 9100, device=dev)["tokens"]
    _reset_kv_counts()
    res = S.serve_paged(cfg, plan.params, prompt, 7, plan=plan, page_size=PAGE,
                        kv_cache=StruMConfig(method="mip2q", p=0.5, q=4, L=7),
                        device=dev)
    launched = _kv_counts()
    runs = res["lane_runs"]
    lane = runs["decode"] + runs["prefill_chunk"]
    sched = res["sched"]
    _check(sched.spec.attn_variant == "cache:attn_fused",
           f"r4c attention {sched.spec.attn_variant}")
    _check(launched["onehot"] == 7 * cfg.n_layers * lane and
           launched["paged_attention"] == cfg.n_layers * lane,
           f"r4c launches {launched}, want K1 7 x {cfg.n_layers} x {lane}, K4 "
           f"{cfg.n_layers} x {lane} ({runs})")
    _check(launched["paged_attention_maskfree"] == launched["page_decode"] == 0 and
           sum(v for k, v in launched.items() if k not in (
               "onehot", "paged_attention", "paged_attention_combine")) == 0,
           f"r4c launched another kernel: {launched}")
    _check_combine(launched)
    outs = [r.output for r in res["requests"]]
    _check(len(outs) == 2 and all(len(o) == 8 for o in outs),
           f"r4c requests came back with {[len(o) for o in outs]} tokens")
    print(f"  r4c trained packed OLMo-1B served paged (2 x 128 + 8, mip2q pages): "
          f"launches {launched} = K1 7 x {cfg.n_layers} x {lane}, K4 {cfg.n_layers} x "
          f"{lane} lane runs {runs}; drain {res['drain_s'] * 1e3:.1f} ms; tokens {outs}",
          flush=True)
    return {"launches": launched, "lane_runs": runs, "drain_ms": res["drain_s"] * 1e3}


def measure_train(dev, clocks) -> dict:
    """Phase r, each sub-phase fatal; returns its records with seconds."""
    import torch
    torch.cuda.init()       # the allocator's statistics exist from here on
    sub, t_start = {}, time.perf_counter()
    r1_params = {}

    def r1():
        rec = phase_r1(dev)
        r1_params["params"] = rec.pop("params")
        return rec

    def r4():
        rec = {"a": phase_r4a(dev)}
        b = phase_r4b(dev, r1_params.pop("params"), clocks)
        rec["c"] = phase_r4c(dev, b.pop("plan"))
        rec["b"] = b
        return rec
    for key, what, fn in (
            ("r1", f"full-width OLMo-1B, 16 layers: {TRAIN_STEPS} train steps, "
                   f"{COMPRESSED_STEPS} with --grad-compression", r1),
            ("r2", "one train step at full width, 2 layers: card vs CPU",
             lambda: phase_r2(dev)),
            ("r3", "resume on the OLMo smoke config: 6 steps == 3 + restore + 3",
             lambda: phase_r3(dev)),
            ("r4", "train -> PTQ -> packed serving: sys_tiny; r1's weights packed "
                   "(K1 at M = 8192) and served paged (K1, K4)", r4)):
        t0 = time.perf_counter()
        print(f"-- {key}. {what} (t = {t0 - _T0:.1f} s)", flush=True)
        sub[key] = fn()
        sub[key]["seconds"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    sub["seconds"] = time.perf_counter() - t_start
    return sub


def _train_report(train, smi) -> None:
    """Phase r's summary line."""
    r1 = train["r1"]
    p, c = r1["plain"], r1["compressed"]
    print(f"train path (OLMo-1B, 16 layers, full width, batch 4 x 2048, f32 params, "
          f"bf16 activations, remat): ms per step median {p['warm_step_ms']['median']:.1f} "
          f"[{p['warm_step_ms']['min']:.1f}, {p['warm_step_ms']['max']:.1f}] over "
          f"{len(p['step_ms']) - 1} warm steps, {p['tokens_per_s']:.0f} tokens/s, peak "
          f"{p['peak_bytes'] / 1e9:.2f} GB, f32 bound {p['f32_bound_ms']['with_remat']:.1f} "
          f"ms; --grad-compression {c['warm_step_ms']['median']:.1f} ms, peak "
          f"{c['peak_bytes'] / 1e9:.2f} GB; r4b K1 layer at M = 8192 "
          f"{train['r4']['b']['k1']['ms']:.3f} ms vs bound "
          f"{train['r4']['b']['k1']['bound_ms']:.3f}; sub-phase seconds "
          f"{ {k: round(v['seconds'], 1) for k, v in train.items() if k != 'seconds'} }, "
          f"phase r {train['seconds']:.1f} s; {smi}")



# ---------------------------------------------------- distributed (s) --

#: s3's OLMo-1B depth, at full width.  s2 and s3 run as gloo ranks sharing
#: cuda:0 (NCCL refuses two ranks on one device); gloo takes CUDA tensors
#: for all_gather / all_reduce in the card's torch build
MESH_LAYERS = 2
#: s2's OLMo-1B depth: 8 of 16 layers (16 until s5 and s6 came), at full
#: width, in the sharded serving layout
S2_LAYERS = 8


def _single_device_refs(dev) -> dict:
    """Phase d's and phase h's runs again (``--only s``): tokens and K1 /
    K4 launches, for s1 to hold the 1x1 mesh to."""
    from repro_torch.launch import serve as S
    _reset_kv_counts()
    d = S.run(["--arch", "olmo_1b", "--seed", "0"])
    d_k1 = _kv_counts()["onehot"]
    _reset_kv_counts()
    h = S.run(["--arch", "olmo_1b", "--seed", "0", "--paged", "--kv-cache", "mip2q",
               "--prompt-len", "128", "--gen", "32"])
    h_k = _kv_counts()
    lane = h["lane_runs"]["decode"] + h["lane_runs"]["prefill_chunk"]
    return {"d_tokens": d["tokens"].cpu(), "d_k1": d_k1,
            "h_tokens": [r.output for r in h["requests"]],
            "h_k1_per_lane_run": h_k["onehot"] / lane,
            "h_k4_per_lane_run": h_k["paged_attention"] / lane}


def phase_s1(dev, refs) -> dict:
    """``serve --mesh 1x1``'s code on NCCL, world 1: the dense-cache loop and
    the paged ``BatchScheduler(mesh=)``, full-width OLMo-1B, 16 layers."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch import serve as S
    out = {}
    _reset_kv_counts()
    res = S.run(["--arch", "olmo_1b", "--seed", "0", "--mesh", "1x1"])
    launched = _kv_counts()
    for line in S.report(res):
        print("  " + line, flush=True)
    _check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
           f"s1 runs on {dist.get_backend()}, world {dist.get_world_size()}")
    dist_v = res["plan"].summary()["variant_distribution"]
    _check(dist_v == {"sharded:gather_pallas": 7}, f"s1 plan selected {dist_v}")
    steps = 1 + res["gen"] + 2
    want = 7 * res["cfg"].n_layers * steps
    _check(launched["onehot"] == want == refs["d_k1"] and
           sum(launched.values()) == want,
           f"s1 dense loop launches {launched}, want {want} of K1 (phase d: "
           f"{refs['d_k1']})")
    same = torch.equal(res["tokens"].cpu(), refs["d_tokens"])
    _check(same, "s1 dense-loop tokens differ from the single-device run's")
    out["dense_launches"] = launched["onehot"]
    print(f"  dense-cache loop on the 1x1 mesh: K1 {launched['onehot']} launches (7 x 16 "
          f"x {steps} steps, as phase d), tokens equal to phase d's: {same}", flush=True)
    _reset_kv_counts()
    res = S.run(["--arch", "olmo_1b", "--seed", "0", "--mesh", "1x1", "--paged",
                 "--kv-cache", "mip2q", "--prompt-len", "128", "--gen", "32"])
    launched = _kv_counts()
    for line in S.report(res):
        print("  " + line, flush=True)
    runs = res["lane_runs"]
    lane = runs["decode"] + runs["prefill_chunk"]
    _check(launched["onehot"] == 7 * 16 * lane == refs["h_k1_per_lane_run"] * lane and
           launched["paged_attention"] == 16 * lane == refs["h_k4_per_lane_run"] * lane,
           f"s1 paged launches {launched}, want 7 x 16 and 16 x {lane} lane runs")
    _check(launched["paged_attention_maskfree"] == launched["page_decode"] == 0,
           f"s1 paged launched K5 or K11: {launched}")
    toks = [r.output for r in res["requests"]]
    _check(toks == refs["h_tokens"], "s1 paged tokens differ from phase h's")
    out.update(paged_launches=launched["onehot"], paged_k4=launched["paged_attention"],
               lane_runs=runs, drain_ms=res["drain_s"] * 1e3)
    print(f"  paged on the 1x1 mesh: K1 {launched['onehot']}, K4 "
          f"{launched['paged_attention']} launches over {lane} lane runs ({runs}; "
          f"per lane run as phase h), tokens equal to phase h's: True", flush=True)
    dist.destroy_process_group()
    return out


def _s_rank(rank: int, world: int, port: int, what: str, out) -> None:
    """One gloo rank on cuda:0 (spawned): runs ``_s2_body`` or
    ``_s3_body`` and puts ``(rank, result, error)`` on ``out``."""
    import traceback

    import torch
    import torch.distributed as dist
    try:
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=world)
        res = {"s2": _s2_body, "s3": _s3_body, "s2_decode": _s2_decode_body,
               "s4": _s4_body, "s5": _s5_body, "s6": _s6_body, "s7": _s7_body}[what](
            rank, torch.device("cuda", 0))
        dist.barrier()
        out.put((rank, res, None))
    except BaseException:
        out.put((rank, None, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _spawn_ranks(what: str, world: int, timeout: float = 600.0) -> list:
    """``world`` gloo ranks sharing cuda:0; every process is joined or
    ended before this returns; a rank's error ends the run."""
    import multiprocessing as mp
    import os
    import queue
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    old = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    procs = [ctx.Process(target=_s_rank, args=(r, world, port, what, out))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
    finally:
        if old is None:
            os.environ.pop("OMP_NUM_THREADS")
        else:
            os.environ["OMP_NUM_THREADS"] = old
    results, error = {}, None
    try:
        while len(results) < world and error is None:
            rank, res, err = out.get(timeout=timeout)
            if err is not None:
                error = f"{what} rank {rank}:\n{err}"
            results[rank] = res
    except queue.Empty:
        error = f"{what}: ranks timed out after {timeout} s ({sorted(results)} done)"
    finally:
        for p in procs:
            p.join(timeout=60 if error is None else 5)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    _check(error is None, str(error))
    return [results[r] for r in range(world)]


def _gather_bytes(plan, calls: int) -> dict:
    """Packed bytes the plan's leaves gather over ``calls`` calls each, the
    dequantized bf16 and the int8 bytes of the same weights."""
    from repro_torch.engine import dense_gather_bytes
    int8 = sum(math.prod(e.shape) for e in plan.entries.values())
    return {"packed": calls * plan.summary()["packed_payload_bytes"],
            "dense_bf16": calls * sum(
                dense_gather_bytes(e.shape[-2], math.prod(e.shape) // e.shape[-2])
                for e in plan.entries.values()),
            "int8": calls * int8}


def _forced_logits(cfg, params, prompt, toks):
    """One device's f32 logits ``(B, gen + 1, V)`` of ``prompt`` and then
    ``toks`` fed back (teacher-forced), as phase f takes them."""
    import torch
    from repro_torch.launch import serve as S
    gen = toks.shape[1] - 1
    with torch.inference_mode():
        lg, caches = S.make_prefill_step(cfg)(params, {"tokens": prompt})
        caches = S.pad_caches(caches, gen + 1)
        ref = [lg[:, -1]]
        step = S.make_decode_step(cfg)
        for i in range(gen):
            lg, caches = step(params, toks[:, i:i + 1], caches, prompt.shape[1] + i)
            ref.append(lg[:, -1])
    return torch.stack(ref, dim=1)[..., :cfg.vocab_size].float()


def _s2_olmo(dev) -> tuple:
    """s2's OLMo: the default StruM config, the bf16 and f32 configs at
    S2_LAYERS layers, f32 weights (seed 0), a 4 x 32 prompt, the 2x2 mesh
    and its rules (the batch of 4 over data)."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.core.policy import StruMConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model_defs
    from repro_torch.models import sharding as shd
    from repro_torch.models.params import init_params
    scfg = StruMConfig()
    cfg16 = dataclasses.replace(get_config("olmo_1b"), n_layers=S2_LAYERS, strum=scfg)
    cfg = dataclasses.replace(cfg16, dtype="float32")
    params = init_params(model_defs(cfg), seed=0, device=dev, dtype_override="float32")
    prompt = torch.randint(0, cfg.vocab_size, (4, 32),
                           generator=torch.Generator().manual_seed(0)).to(dev)
    mesh = make_host_mesh(data=2, model=2)
    return scfg, cfg16, cfg, params, prompt, mesh, shd.rules_for_mesh(mesh, 4)


def _s2_decode_body(rank: int, dev) -> dict:
    """A rank of s2's decode record alone (``--only v``): s2's OLMo plan on
    its 2x2 mesh and :func:`_s2_decode_record`."""
    from repro_torch.launch.steps import build_serving_plan
    scfg, _, cfg, params, prompt, mesh, rules = _s2_olmo(dev)
    plan = build_serving_plan(params, cfg=scfg, mesh=mesh, rules=rules, device=dev)
    return _s2_decode_record(cfg, plan.params, prompt, mesh, rules)


def _s2_body(rank: int, dev) -> dict:
    """A rank of s2 (2 x 2 mesh): full-width OLMo-1B at S2_LAYERS layers,
    packed prefill + 8 decode steps through the dense-cache loop in the
    sharded serving layout (weights placed by ``shard_params``, the batch
    over data, the caches also over ``model``), at f32 activations and at
    the config's bf16; the bytes each rank holds; one full-width
    Moonshot-16B-A3B MoE layer through the expert-parallel body.  Rank 0
    also runs both on one device, in the same process, and compares."""
    import torch
    from repro_torch import telemetry
    from repro_torch.configs.base import get_config
    from repro_torch.engine import build_plan
    from repro_torch.launch import serve as S
    from repro_torch.launch.steps import build_serving_plan
    from repro_torch.models import sharding as shd
    from repro_torch.models import model_defs
    from repro_torch.models.moe import moe_apply, moe_def
    from repro_torch.models.params import init_params, shard_params
    out = {}
    # f32 activations, held to the one-device tokens exactly; then the
    # config's bf16, where the row-parallel partial sums and the one-device
    # split-K sums round at other points (a last-bit difference that can flip
    # a near-tied argmax of a random model's flat logits): held teacher-forced
    scfg, cfg16, cfg, params, prompt, mesh, rules = _s2_olmo(dev)
    gen_steps = 8
    t0 = time.perf_counter()
    plan = build_serving_plan(params, cfg=scfg, mesh=mesh, rules=rules, device=dev)
    # the sharded serving layout: every dense leaf this rank's shard too
    placed = shard_params(plan.params, model_defs(cfg), mesh, rules, device=dev)
    _reset_kv_counts()
    with telemetry.recording() as rec:
        toks, t_p, t_d, lg = S.serve(cfg, placed, prompt, gen_steps, device=dev,
                                     return_logits=True, mesh=mesh, rules=rules)
    launched = _kv_counts()
    steps = 1 + gen_steps + 2
    local = sum(e.leaf[k].numel() for e in plan.entries.values()
                for k in ("mask", "hi", "lo"))
    out["olmo"] = {
        "seconds": time.perf_counter() - t0, "launches": dict(launched),
        "want_k1": 7 * cfg.n_layers * steps, "steps": steps,
        "prefill_ms": t_p * 1e3, "decode_ms_per_token": t_d / gen_steps * 1e3,
        "dist": plan.summary()["variant_distribution"],
        "gathered_counter": int(rec.counter("dispatch/sharded/gathered_packed_bytes")),
        "bytes": _gather_bytes(plan, steps), "local_payload": local,
        "whole_payload": plan.summary()["packed_payload_bytes"],
        "weights": _resident_weights(placed)}
    out["decode_record"] = _s2_decode_record(cfg, placed, prompt, mesh, rules)
    _reset_kv_counts()
    toks16, _, _, lg16 = S.serve(cfg16, placed, prompt, gen_steps, device=dev,
                                 return_logits=True, mesh=mesh, rules=rules)
    out["olmo_bf16"] = {"launches": dict(_kv_counts()), "dtype": cfg16.dtype}
    del plan, placed
    if rank == 0:
        plan1 = build_serving_plan(params, cfg=scfg, device=dev)
        toks1, _, _, lg1 = S.serve(cfg, plan1.params, prompt, gen_steps, device=dev,
                                   return_logits=True)
        got, want = lg[..., :cfg.vocab_size], lg1[..., :cfg.vocab_size]
        out["olmo"].update(
            single_dist=plan1.summary()["variant_distribution"],
            tokens_equal=bool(torch.equal(toks, toks1)),
            max_abs_diff=(got - want).abs().max().item(),
            max_abs_logit=want.abs().max().item(),
            argmax_agreement=(got.argmax(-1) == want.argmax(-1)).float().mean().item())
        got = lg16[..., :cfg.vocab_size].float()
        ref = _forced_logits(cfg16, plan1.params, prompt, toks16)
        out["olmo_bf16"].update(
            served_is_argmax=bool(torch.equal(got.argmax(-1), toks16)),
            max_abs_diff=(got - ref).abs().max().item(),
            max_abs_logit=ref.abs().max().item(),
            argmax_agreement=(got.argmax(-1) == ref.argmax(-1)).float().mean().item(),
            near_ties=_near_ties(ref, got, ref.argmax(-1), "s2 bf16 on 2x2"),
            positions=got.shape[0] * got.shape[1])
        del plan1
    del params
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    mcfg = dataclasses.replace(get_config(MOE_ARCH), strum=scfg)
    params = init_params({"blocks": {"moe": moe_def(mcfg)}}, seed=0, device=dev,
                         dtype_override="float32")
    rules = shd.rules_for_mesh(mesh)
    plan = build_plan(params, cfg=scfg, mesh=mesh, rules=rules, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    # a decode step of 4 slots: at most 4 tokens per expert, under the
    # capacity (top_k) on one device and per token shard alike, so the two
    # drop nothing and compute the same function
    x = torch.randn((4, 1, mcfg.d_model), generator=gen, device=dev).to(
        mcfg.activation_dtype)
    _reset_kv_counts()
    with telemetry.recording() as rec:
        y, aux = moe_apply(plan.params["blocks"]["moe"], x, mcfg, mesh=mesh)
    launched = _kv_counts()
    block = sum(e.leaf[k].numel() for e in plan.entries.values()
                for k in ("mask", "hi", "lo"))
    out["moe"] = {"seconds": time.perf_counter() - t0, "launches": dict(launched),
                  "dist": plan.summary()["variant_distribution"],
                  "gathered_counter": int(rec.counter(
                      "dispatch/sharded/gathered_packed_bytes")),
                  "block_payload": block,
                  "assembled": block * shd.axis_size(mesh, shd.fsdp_axes(mesh)),
                  "bytes": _gather_bytes(plan, 1)}
    if rank == 0:
        plan1 = build_plan(params, cfg=scfg, device=dev)
        y1, aux1 = moe_apply(plan1.params["blocks"]["moe"], x, mcfg)
        out["moe"].update(max_abs_diff=(y.float() - y1.float()).abs().max().item(),
                          max_abs_y=y1.float().abs().max().item(),
                          aux=(float(aux), float(aux1)),
                          single_dist=plan1.summary()["variant_distribution"])
    return out


def _s2_decode_record(cfg, params, prompt, mesh, rules) -> dict:
    """One decode step of s2's OLMo on its 2x2 mesh in the sharded serving
    layout, after a prefill of ``prompt`` into caches of
    ``padded_cache_len(S)`` positions (a decode cell of the dry-run), under
    the dry-run's ``Counter``: the collectives this rank records in order,
    the kernel calls it counts and the wrappers' launches (phase v3 holds
    the abstract mesh's count to them); and the cache bytes this rank holds
    against the whole caches'."""
    import torch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch.specs import padded_cache_len, place_inputs
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import sharding as shd
    b, n = prompt.shape
    with torch.inference_mode():
        placed, batch = place_inputs(cfg, ShapeSpec("s2_prefill", n, b, "prefill"),
                                     (params, {"tokens": prompt}), mesh, rules)
        _, caches = make_prefill_step(cfg, mesh, rules, max_len=padded_cache_len(n))(
            placed, batch)
        token = shd.place_tree(prompt[:, -1:], shd.P(rules.table["batch"], None), mesh)
        held = sum(t.numel() * t.element_size() for c in caches.values()
                   for t in c.values())
        whole = sum(math.prod(shd.placement(t).shape) * t.element_size()
                    for c in caches.values() for t in c.values())
        step = make_decode_step(cfg, mesh, rules)
        _reset_kv_counts()
        counter = dryrun.Counter()
        with counter:
            step(placed, token, caches, n)
        torch.cuda.synchronize()
    return {"collectives": counter.collectives, "kernels": dict(counter.kernels),
            "launches": {k: v for k, v in _kv_counts().items() if v},
            "batch": b, "cache_len": n, "layers": cfg.n_layers,
            "cache_bytes": held, "cache_whole_bytes": whole}


def _resident_weights(placed) -> dict:
    """The weight bytes this rank holds in the sharded serving layout, the
    whole model's, what each leaf's cut predicts (its whole bytes over its
    parts), and the leaves not cut in as many parts as the mesh has ranks
    (replicated over some axis), by name and parts."""
    import torch
    from repro_torch.engine.sharded import field_parts
    from repro_torch.models import sharding as shd
    held = whole = want = 0
    partial = {}

    def walk(tree, name):
        nonlocal held, whole, want
        if isinstance(tree, dict) and "mask" in tree:
            shard = tree["spec"].shard
            parts = field_parts(shard)
            for k in ("mask", "hi", "lo", "scale"):
                t = tree[k]
                nb = t.numel() * t.element_size()
                held += nb
                whole += nb * parts[k]
                want += nb
                if parts[k] < math.prod(n for _, n in shard.mesh_shape):
                    partial[f"{name}/{k}"] = parts[k]
        elif isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{name}/{k}" if name else k)
        elif isinstance(tree, torch.Tensor):
            pl = shd.placement(tree)
            nb = tree.numel() * tree.element_size()
            held += nb
            whole += math.prod(pl.shape) * tree.element_size()
            want += math.prod(pl.shape) * tree.element_size() // pl.parts
            if pl.parts < math.prod(n for _, n in pl.mesh_shape):
                partial[name] = pl.parts
    walk(placed, "")
    return {"held": held, "whole": whole, "want": want, "partial": partial}


def _s3_body(rank: int, dev) -> dict:
    """A rank of s3 (data = 2): the ZeRO-3 train step, full-width OLMo-1B at
    MESH_LAYERS layers, batch 2 x 256, f32.  Rank 0 also takes the step on
    one device and holds the two to r2's bound."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.core.apply import _named_leaves
    from repro_torch.data.pipeline import DataConfig, global_batch
    from repro_torch.launch import steps as St
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model_defs
    from repro_torch.models import sharding as shd
    from repro_torch.models.params import gather_params, init_params, shard_params
    from repro_torch.optim.adamw import adamw_update, init_opt_state
    _, opt_cfg, _, _, _ = T.build(T.parse_args(
        ["--arch", "olmo_1b", "--steps", str(TRAIN_STEPS), "--device", "cuda"]))
    cfg = dataclasses.replace(get_config("olmo_1b"), n_layers=MESH_LAYERS,
                              dtype="float32")
    defs = model_defs(cfg)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=256, global_batch=2, seed=0)
    params = init_params(defs, seed=0, device=dev, dtype_override="float32")
    mesh = make_host_mesh(data=2, model=1)
    rules = shd.rules_for_mesh(mesh)
    batch = global_batch(dcfg, 0, device=dev)
    t0 = time.perf_counter()
    local = shard_params(params, defs, mesh, rules)
    (loss, _), grads = St._zero3_value_and_grad(local, batch, cfg, mesh, rules, defs)
    # the ZeRO-3 step (the MoE, SSM and hybrid families'; OLMo's own step on
    # a mesh is the dense decoders' train layout, s6)
    new_local, _, sm = St._zero3_step(cfg, opt_cfg, mesh, rules, False)(
        local, init_opt_state(local), batch)
    new = gather_params(new_local, defs, mesh, rules)
    torch.cuda.synchronize(dev)
    out = {"seconds": time.perf_counter() - t0, "loss": float(loss),
           "step_loss": float(sm["loss"]), "grad_norm": float(sm["grad_norm"]),
           "lr": float(sm["lr"]),
           "local_bytes": sum(t.numel() * 4 for _, t in _named_leaves(local)),
           "global_bytes": sum(t.numel() * 4 for _, t in _named_leaves(params)),
           "gathered_bytes": _gathered_param_bytes(params, defs, mesh, rules),
           "linear_int8": sum(t.numel() for n, t in _named_leaves(params)
                              if n.endswith("/w") and t.dim() >= 2)}
    # the step is its gradient and AdamW calls: the same bits
    again, _, _ = adamw_update(opt_cfg, local, shard_params(grads, defs, mesh, rules),
                               init_opt_state(local), gnorm=sm["grad_norm"])
    out["step_is_its_calls"] = all(torch.equal(a, b) for (_, a), (_, b) in zip(
        _named_leaves(again), _named_leaves(new_local)))
    if rank == 0:     # on the card: r2's element-wise bound, without host copies
        (l1, _), g1 = St._value_and_grad(params, batch, cfg)
        p1, _, m1 = adamw_update(opt_cfg, params, g1, init_opt_state(params))
        ly = dict(_named_leaves(g1))
        g_rel = max((g.double() - ly[n].double()).abs().max().item()
                    / max(ly[n].abs().max().item(), 1e-30)
                    for n, g in _named_leaves(grads))
        gap = _step_gap(opt_cfg, params, grads, g1, new, p1,
                        max(out["lr"], float(m1["lr"])),
                        (out["grad_norm"], float(m1["grad_norm"])))
        out.update(single_loss=float(l1), single_grad_norm=float(m1["grad_norm"]),
                   grad_rel=g_rel, step_gap=gap)
    return out


def _gathered_param_bytes(params, defs, mesh, rules) -> int:
    """Bytes the ZeRO-3 step's all-gathers assemble: every leaf the rules
    cut over mesh axes of size > 1, whole."""
    from repro_torch.models.params import ParamDef
    from repro_torch.models.sharding import axis_size, spec_for_axes
    if isinstance(defs, ParamDef):
        parts = math.prod(axis_size(mesh, e) for e in spec_for_axes(defs.axes,
                                                                    rules.table))
        return params.numel() * params.element_size() if parts > 1 else 0
    return sum(_gathered_param_bytes(params[k], d, mesh, rules)
               for k, d in defs.items())


def measure_mesh(dev, refs, only=None) -> dict:
    """Phase s, each sub-phase fatal; returns its records with seconds and
    the K1 / K4 / K6 launches of its runs.  ``only`` names the sub-phases to
    run (default: all)."""
    import torch
    sub, t_start = {}, time.perf_counter()
    print(f"  s2, s3 and s4 run as gloo ranks sharing cuda:0 (NCCL refuses two ranks "
          f"on one device), torch {torch.__version__}", flush=True)
    for key, what, fn in (
            ("s1", "NCCL, world 1, a 1x1 mesh: full-width OLMo-1B, 16 layers, through "
                   "serve --mesh 1x1's code, dense-cache loop and paged",
             lambda: phase_s1(dev, refs)),
            ("s2", f"4 gloo ranks on cuda:0, a 2x2 mesh: full-width OLMo-1B at "
                   f"{S2_LAYERS} layers in the sharded serving layout (prefill + 8 "
                   f"decode steps) and one "
                   f"full-width Moonshot-16B-A3B MoE layer", lambda: _spawn_ranks("s2", 4)),
            ("s3", f"2 gloo ranks on cuda:0, data = 2: the ZeRO-3 train step, "
                   f"full-width OLMo-1B at {MESH_LAYERS} layers, batch 2 x 256, f32",
             lambda: _spawn_ranks("s3", 2)),
            ("s4", f"4 gloo ranks on cuda:0, a 2x2 mesh, the sharded serving layout "
                   f"of the MoE, SSM and hybrid families: full-width Moonshot-16B-A3B "
                   f"at {MOE_LAYERS} layers, full-width Mamba-2 780M at "
                   f"{S4_SSM_LAYERS} layers, Jamba at its smoke shape "
                   f"(prefill + {S4_GEN} decode steps each, f32 and bf16)",
             lambda: _spawn_ranks("s4", 4)),
            ("s5", f"4 gloo ranks on cuda:0, a 2x2 mesh, the paged layout: "
                   f"BatchScheduler(mesh=) over the default plan, full-width OLMo-1B "
                   f"(16 layers), Moonshot-16B-A3B ({MOE_LAYERS} layers), Mamba-2 780M "
                   f"({S4_SSM_LAYERS} layers), the Jamba smoke hybrid; f32, teacher-forced",
             lambda: _spawn_ranks("s5", 4)),
            ("s6", f"4 gloo ranks on cuda:0, a 2x2 mesh: one train step of full-width "
                   f"OLMo-1B ({S6_LAYERS} layers, {S6_BATCH[0]} x {S6_BATCH[1]}, f32) in "
                   f"the dense decoders' train layout and as ZeRO-3, against one device",
             lambda: _spawn_ranks("s6", 4)),
            ("s7", f"4 gloo ranks on cuda:0, a 2x2 mesh: one train step in the train "
                   f"layout of the MoE, SSM and hybrid families ({S6_BATCH[0]} x "
                   f"{S6_BATCH[1]}, f32): full-width Moonshot-16B-A3B at 1 layer, "
                   f"full-width Mamba-2 780M at 2 layers (and as ZeRO-3), Jamba at its "
                   f"smoke shape, each against one device",
             lambda: _spawn_ranks("s7", 4))):
        if only is not None and key not in only:
            continue
        t0 = time.perf_counter()
        print(f"-- {key}. {what} (t = {t0 - _T0:.1f} s)", flush=True)
        rec = fn()
        if key == "s2":
            rec = _check_s2(rec)
        elif key == "s3":
            rec = _check_s3(rec)
        elif key == "s4":
            rec = _check_s4(rec)
        elif key == "s5":
            rec = _check_s5(rec)
        elif key == "s6":
            rec = _check_s6(rec)
        elif key == "s7":
            rec = _check_s7(rec)
        sub[key] = rec
        sub[key]["seconds"] = time.perf_counter() - t0
        print(f"  {key} took {sub[key]['seconds']:.1f} s", flush=True)
        torch.cuda.empty_cache()
    sub["seconds"] = time.perf_counter() - t_start
    return sub


def _bytes_line(what: str, b: dict) -> str:
    return (f"  {what}, computed from the plan: packed payload {b['packed']} bytes vs "
            f"dense bf16 {b['dense_bf16']} (x{b['packed'] / b['dense_bf16']:.4f}) and "
            f"int8 {b['int8']} (x{b['packed'] / b['int8']:.4f}, Eq. 1)")


def _check_s2(ranks: list) -> dict:
    """s2's launch counts, payload blocks, gather bytes and parity, exact
    where they are counts."""
    for r, res in enumerate(ranks):
        o, m = res["olmo"], res["moe"]
        _check(o["dist"] == {"sharded:gather_pallas": 7},
               f"s2 rank {r} OLMo plan {o['dist']}")
        _check(o["launches"]["onehot"] == o["want_k1"] and
               sum(o["launches"].values()) == o["want_k1"],
               f"s2 rank {r} OLMo launches {o['launches']}, want {o['want_k1']} K1")
        _check(o["gathered_counter"] == o["bytes"]["packed"],
               f"s2 rank {r} gathered {o['gathered_counter']} vs {o['bytes']}")
        _check(o["local_payload"] * 4 == o["whole_payload"],
               f"s2 rank {r} holds {o['local_payload']} of {o['whole_payload']} bytes")
        w, d = o["weights"], res["decode_record"]
        _check(w["held"] == w["want"] and w["held"] * 4 >= w["whole"],
               f"s2 rank {r} weight bytes {w}")
        _check(d["cache_bytes"] * 4 == d["cache_whole_bytes"],
               f"s2 rank {r} holds {d['cache_bytes']} of {d['cache_whole_bytes']} "
               f"cache bytes, not a quarter")
        b16 = res["olmo_bf16"]
        _check(b16["launches"]["onehot"] == o["want_k1"] and
               sum(b16["launches"].values()) == o["want_k1"],
               f"s2 rank {r} OLMo bf16 launches {b16['launches']}, want {o['want_k1']} K1")
        _check(m["dist"] == {"sharded:grouped_gather": 3}, f"s2 rank {r} MoE {m['dist']}")
        _check(m["gathered_counter"] == m["block_payload"] and
               m["block_payload"] * 4 == m["bytes"]["packed"],
               f"s2 rank {r} MoE gathered counter {m['gathered_counter']}, want its "
               f"block {m['block_payload']} (a quarter of {m['bytes']['packed']})")
        _check(m["launches"]["grouped_onehot"] == 3 and
               sum(m["launches"].values()) == 3,
               f"s2 rank {r} MoE launches {m['launches']}, want 3 K6")
    o, m, b16 = ranks[0]["olmo"], ranks[0]["moe"], ranks[0]["olmo_bf16"]
    w, d = o["weights"], ranks[0]["decode_record"]
    print(f"  OLMo-1B ({S2_LAYERS} layers) on 2x2 in the sharded serving layout, rank "
          f"0 holds {w['held']} of {w['whole']} weight bytes (x{w['held'] / w['whole']:.4f}; "
          f"a quarter but for the leaves cut in fewer parts: {w['partial']}) and "
          f"{d['cache_bytes']} of {d['cache_whole_bytes']} cache bytes "
          f"(x{d['cache_bytes'] / d['cache_whole_bytes']:.4f}; {d['batch']} slots x "
          f"{d['cache_len']} tokens in a cache of padded_cache_len)", flush=True)
    print(f"  OLMo-1B ({S2_LAYERS} layers, f32 activations) on 2x2, plan "
          f"{o['dist']} (one device: {o['single_dist']}); prefill "
          f"{o['prefill_ms']:.1f} ms, decode {o['decode_ms_per_token']:.2f} ms/token "
          f"(rank 0, host clock, gloo's host copies included)", flush=True)
    print(f"  OLMo-1B ({S2_LAYERS} layers) on 2x2, each rank: K1 "
          f"{o['launches']['onehot']} launches (7 x {S2_LAYERS} x {o['steps']} steps); "
          f"payload block {o['local_payload']} of {o['whole_payload']} bytes; vs one "
          f"device: tokens equal {o['tokens_equal']}, logits max|diff| "
          f"{o['max_abs_diff']:.4e} (max|logit| {o['max_abs_logit']:.4e}), argmax "
          f"agreement {o['argmax_agreement']:.3f}; {o['seconds']:.1f} s", flush=True)
    print(f"  OLMo-1B ({S2_LAYERS} layers) on 2x2 at {b16['dtype']} (the config's "
          f"dtype), each rank: K1 {b16['launches']['onehot']} launches; teacher-forced "
          f"on its tokens vs one device over {b16['positions']} positions: logits "
          f"max|diff| {b16['max_abs_diff']:.4e} (max|logit| {b16['max_abs_logit']:.4e}), "
          f"argmax agreement {b16['argmax_agreement']:.3f}, "
          f"{len(b16['near_ties'])} argmax disagreements, each a near tie (gap <= 2 x "
          f"the row's max|diff|): {b16['near_ties']}", flush=True)
    print(f"  OLMo-1B {o['steps']} steps, each rank: gathered-bytes counter "
          f"{o['gathered_counter']} (measured; a 2-D leaf counts whole)", flush=True)
    print(_bytes_line(f"OLMo-1B {o['steps']} steps", o["bytes"]), flush=True)
    print(f"  Moonshot MoE layer on 2x2 (decode, 4 slots), each rank: K6 "
          f"{m['launches']['grouped_onehot']} launches through sharded:grouped_gather; "
          f"vs one device ({m['single_dist']}): max|diff| {m['max_abs_diff']:.4e} "
          f"(max|y| {m['max_abs_y']:.4e}), aux {m['aux'][0]:.6f} vs {m['aux'][1]:.6f}; "
          f"{m['seconds']:.1f} s", flush=True)
    print(f"  Moonshot MoE layer, one call, each rank: gathered-bytes counter "
          f"{m['gathered_counter']} (measured: the rank's block of its 3 stacks, as "
          f"the counter counts a stack); its all-gathers over data assemble "
          f"{m['assembled']} bytes (its experts' whole stacks, packed)", flush=True)
    print(_bytes_line("Moonshot MoE layer, whole plan", m["bytes"]), flush=True)
    _check(o["tokens_equal"], "s2 tokens differ from the one-device run's")
    _check(o["max_abs_diff"] <= 0.05 * o["max_abs_logit"] and
           o["argmax_agreement"] >= 0.9, f"s2 logits differ: {o}")
    # phase f's tolerance at 5%; every disagreement a near tie (checked on rank 0)
    _check(b16["served_is_argmax"] and b16["max_abs_diff"] <= 0.05 * b16["max_abs_logit"]
           and b16["argmax_agreement"] >= 0.9, f"s2 bf16 logits differ: {b16}")
    _check(m["max_abs_diff"] <= 0.05 * m["max_abs_y"] and
           abs(m["aux"][0] - m["aux"][1]) <= 1e-4 * max(1.0, abs(m["aux"][1])),
           f"s2 MoE layer differs: {m}")
    return {"olmo": o, "olmo_bf16": b16, "moe": m,
            "decode_record": ranks[0]["decode_record"],
            "k1_launches_per_rank": [r["olmo"]["launches"]["onehot"] for r in ranks],
            "k6_launches_per_rank": [r["moe"]["launches"]["grouped_onehot"]
                                     for r in ranks]}


def _check_s3(ranks: list) -> dict:
    """s3 against the one-device step, to r2's bound."""
    r0 = ranks[0]
    for r, res in enumerate(ranks):
        _check(res["step_is_its_calls"] and res["step_loss"] == res["loss"],
               f"s3 rank {r}: the step is not its gradient and AdamW calls")
        _check(res["local_bytes"] < res["global_bytes"],
               f"s3 rank {r} holds {res['local_bytes']} of {res['global_bytes']}")
    loss_rel = abs(r0["loss"] - r0["single_loss"]) / abs(r0["single_loss"])
    gap = r0["step_gap"]
    print(f"  ZeRO-3 on data = 2 vs one device, one step: loss {r0['loss']:.6f} vs "
          f"{r0['single_loss']:.6f} (rel {loss_rel:.2e}); gradients max |diff| / max|g| "
          f"{r0['grad_rel']:.2e}; grad norms {r0['grad_norm']:.6f} / "
          f"{r0['single_grad_norm']:.6f}; the steps at most {gap['bound_ratio']:.3f} of "
          f"what the gradient gap allows, {gap['rel']:.2e} of max|p| where |e| >= "
          f"1e3·eps ({gap['outside']} of {gap['elements']} elements below it); each "
          f"rank holds {r0['local_bytes']} of {r0['global_bytes']} parameter bytes; "
          f"{r0['seconds']:.1f} s for the gradient and the step", flush=True)
    print(f"  ZeRO-3 gathers dense f32 parameters: {r0['gathered_bytes']} bytes a step "
          f"(all-gather outputs of the sharded leaves), against "
          f"{int(r0['linear_int8'] * 0.875)} bytes if its linears moved as mip2q "
          f"p=0.5 payloads (x0.875 of their int8 {r0['linear_int8']}, Eq. 1); counts, "
          f"not rates", flush=True)
    _check(loss_rel <= 1e-4, f"s3 loss differs: {loss_rel} > 1e-4 relative")
    _check(r0["grad_rel"] <= 1e-3, f"s3 gradients differ: {r0['grad_rel']} > 1e-3")
    _check(gap["bound_ratio"] <= 1.0, f"s3 steps differ past the gradient gap: {gap}")
    _check(gap["rel"] <= 1e-5, f"s3 steps differ where |e| >= 1e3·eps: {gap}")
    return {k: v for k, v in r0.items() if k != "step_gap"} | {
        "loss_rel": loss_rel, "step_gap": gap}


#: s4's families on the 2x2 mesh: (arch, depth at full width, or None for
#: the smoke shape).  Jamba's full width does not fit one card (one MoE
#: layer's experts are 16 x 3 x 8192 x 24576 parameters, 38.7 GB at f32);
#: the dry-run counts it on meta
S4_SSM_LAYERS = 16             # of Mamba-2's 48, at full width
S4_CASES = ((MOE_ARCH, MOE_LAYERS), (SSM_ARCH, S4_SSM_LAYERS), (HYBRID_ARCH, None))
S4_PROMPT = (4, 32)             # batch (over data = 2) x prompt tokens
S4_GEN = 8


def _s4_cfg(arch: str, layers):
    """s4's config of ``arch`` at its config's dtype (bf16), packed with the
    default StruM config: full width at ``layers``, or the smoke shape."""
    from repro_torch.configs.base import get_config, get_smoke_config
    from repro_torch.core.policy import StruMConfig
    cfg = get_smoke_config(arch) if layers is None else dataclasses.replace(
        get_config(arch), n_layers=layers)
    return dataclasses.replace(cfg, strum=StruMConfig())


def _held_bytes(placed) -> dict:
    """What this rank holds of a served tree against the whole: packed
    payload fields (mask, hi, lo, scale; the whole is each field's block
    times its parts) and dense leaves (the whole from each ``Placement``,
    and the bytes each leaf's cut predicts: its whole over its parts).  A
    tree without placements (one device) holds it all."""
    import torch
    from repro_torch.engine.sharded import field_parts
    from repro_torch.models import sharding as shd
    out = {"payload": {"held": 0, "whole": 0}, "dense": {"held": 0, "whole": 0, "want": 0}}

    def walk(tree):
        if isinstance(tree, dict) and "mask" in tree:
            shard = tree["spec"].shard
            parts = field_parts(shard) if shard is not None else {}
            for k in ("mask", "hi", "lo", "scale"):
                nb = tree[k].numel() * tree[k].element_size()
                out["payload"]["held"] += nb
                out["payload"]["whole"] += nb * parts.get(k, 1)
        elif isinstance(tree, dict):
            for v in tree.values():
                walk(v)
        elif isinstance(tree, torch.Tensor):
            pl = shd.placement(tree)
            nb = tree.numel() * tree.element_size()
            whole = nb if pl is None else math.prod(pl.shape) * tree.element_size()
            o = out["dense"]
            o["held"] += nb
            o["whole"] += whole
            o["want"] += whole if pl is None else whole // pl.parts
    walk(placed)
    return out


def _teacher_forced(got, toks, ref, what: str) -> dict:
    """The served logits ``got`` (greedy ``toks``) against one device's
    logits ``ref`` teacher-forced on the same tokens: every argmax
    disagreement must be a near tie (:func:`_near_ties`)."""
    import torch
    return dict(served_is_argmax=bool(torch.equal(got.argmax(-1), toks)),
                max_abs_diff=(got - ref).abs().max().item(),
                max_abs_logit=ref.abs().max().item(),
                argmax_agreement=(got.argmax(-1) == ref.argmax(-1)).float().mean().item(),
                near_ties=_near_ties(ref, got, ref.argmax(-1), what),
                positions=got.shape[0] * got.shape[1])


def _s4_body(rank: int, dev) -> dict:
    """A rank of s4 (2 x 2 mesh): for each of :data:`S4_CASES`, the default
    mip2q plan built on the mesh and served in the sharded serving layout
    (prefill + S4_GEN decode steps through the dense-cache loop) at f32
    activations and at the config's bf16, the launches and the bytes this
    rank holds, and one f32 decode step under the dry-run's ``Counter``.
    One rank at a time draws the whole model on the card (f32, seed 0),
    packs it and keeps its blocks, so the card holds one whole model at a
    time.  Rank 0 also serves the one-device plan on each data shard's rows
    (the rows a data rank routes its MoE capacity over) and compares."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import serve as S
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.specs import place_inputs
    from repro_torch.launch.steps import build_serving_plan
    from repro_torch.models import model_defs
    from repro_torch.models import sharding as shd
    from repro_torch.models.params import init_params, shard_params
    mesh = make_host_mesh(data=2, model=2)
    b, n = S4_PROMPT
    rules = shd.rules_for_mesh(mesh, b)
    shards = [slice(d * b // 2, (d + 1) * b // 2) for d in range(2)]
    out = {}
    for arch, layers in S4_CASES:
        t0 = time.perf_counter()
        cfg16 = _s4_cfg(arch, layers)
        cfg = dataclasses.replace(cfg16, dtype="float32")
        prompt = torch.randint(0, cfg.vocab_size, (b, n),
                               generator=torch.Generator().manual_seed(0)).to(dev)
        placed = plan1 = None
        for r in range(dist.get_world_size()):
            if r == rank:
                params = init_params(model_defs(cfg), seed=0, device=dev,
                                     dtype_override="float32")
                plan = build_serving_plan(params, cfg=cfg.strum, mesh=mesh, rules=rules,
                                          device=dev)
                dist_v = plan.summary()["variant_distribution"]
                per_step = {"onehot": 0, "grouped_onehot": 0}
                for e in plan.entries.values():     # one launch a group a step
                    per_step["onehot" if len(e.shape) == 3 else "grouped_onehot"] += \
                        e.shape[0]
                placed = shard_params(plan.params, model_defs(cfg), mesh, rules,
                                      device=dev)
                del plan
                if rank == 0:
                    plan1 = build_serving_plan(params, cfg=cfg.strum, device=dev)
                del params
                torch.cuda.empty_cache()
            dist.barrier()
        placed = place_inputs(cfg, ShapeSpec("s4", n, b, "prefill"),
                              (placed, {"tokens": prompt}), mesh, rules)[0]
        steps = 1 + S4_GEN
        _reset_kv_counts()
        t1 = time.perf_counter()
        toks, t_p, t_d, lg = S.serve(cfg, placed, prompt, S4_GEN, device=dev,
                                     return_logits=True, warmup=False, mesh=mesh,
                                     rules=rules)
        serve_s = time.perf_counter() - t1
        launched = dict(_kv_counts())
        rec = {"dist": dist_v, "launches": launched, "steps": steps,
               "want": {k: v * steps for k, v in per_step.items()},
               "held": _held_bytes(placed), "prefill_ms": t_p * 1e3,
               "decode_ms_per_token": t_d / S4_GEN * 1e3, "serve_s": serve_s,
               "layers": cfg.n_layers, "smoke": layers is None}
        rec["decode_record"] = _s2_decode_record(cfg, placed, prompt, mesh, rules)
        _reset_kv_counts()
        toks16, _, _, lg16 = S.serve(cfg16, placed, prompt, S4_GEN, device=dev,
                                     return_logits=True, warmup=False, mesh=mesh,
                                     rules=rules)
        rec["bf16_launches"] = dict(_kv_counts())
        del placed
        if rank == 0:
            ones = [S.serve(cfg, plan1.params, prompt[h], S4_GEN, device=dev,
                            return_logits=True, warmup=False) for h in shards]
            toks1 = torch.cat([o[0] for o in ones])
            lg1 = torch.cat([o[3] for o in ones])
            got, want = lg[..., :cfg.vocab_size], lg1[..., :cfg.vocab_size]
            rec.update(single_held=_held_bytes(plan1.params),
                       single_dist=plan1.summary()["variant_distribution"],
                       tokens_equal=bool(torch.equal(toks, toks1)),
                       first_differing=[tuple(map(int, rt)) for rt in
                                        torch.nonzero(toks != toks1)[:4]],
                       max_abs_diff=(got - want).abs().max().item())
            rec["f32"] = _teacher_forced(
                got, toks, torch.cat([_forced_logits(cfg, plan1.params, prompt[h], toks[h])
                                      for h in shards]), f"s4 {arch} f32 on 2x2")
            rec["bf16"] = _teacher_forced(
                lg16[..., :cfg.vocab_size].float(), toks16,
                torch.cat([_forced_logits(cfg16, plan1.params, prompt[h], toks16[h])
                           for h in shards]), f"s4 {arch} bf16 on 2x2")
            del plan1
        torch.cuda.empty_cache()
        rec["seconds"] = time.perf_counter() - t0
        dist.barrier()
        out[arch] = rec
    return out


def _s4_abstract(arch: str, layers, record: dict) -> dict:
    """s4's f32 decode step of ``arch`` counted on the abstract 2x2 mesh and
    held to rank 0's record (:func:`_abstract_hold`)."""
    cfg = dataclasses.replace(_s4_cfg(arch, layers), dtype="float32")
    rec = _abstract_hold(cfg, record, f"s4 {arch}", "rank 0's")
    return {"n_collectives": len(rec["collective_records"]),
            "per_kind_count": rec["collectives"]["per_kind_count"],
            "link_bytes": rec["collectives"]["link_bytes"], "kernels": rec["kernels"],
            "count_s": rec["seconds"]}


def _check_s4(ranks: list) -> dict:
    """s4's launch counts, held bytes and parity, exact where they are
    counts; the abstract count of each f32 decode step."""
    out = {}
    for arch, layers in S4_CASES:
        for r, res in enumerate(ranks):
            a = res[arch]
            for what, got in (("f32", a["launches"]), ("bf16", a["bf16_launches"])):
                live = {k: v for k, v in got.items() if v}
                want = {k: v for k, v in a["want"].items() if v}
                _check(live == want and a["want"]["onehot"] > 0 and
                       (a["want"]["grouped_onehot"] > 0) == (arch != SSM_ARCH),
                       f"s4 rank {r} {arch} {what} launches {live}, want {want}")
            one = ranks[0][arch]["single_held"]
            h = a["held"]
            _check(h["dense"]["held"] == h["dense"]["want"] and
                   h["dense"]["whole"] == one["dense"]["whole"] and
                   h["payload"]["whole"] == one["payload"]["whole"] and
                   0 < h["payload"]["held"] < h["payload"]["whole"],
                   f"s4 rank {r} {arch} holds {h}; one device {one}")
            d = a["decode_record"]
            _check(d["cache_bytes"] * 4 == d["cache_whole_bytes"],
                   f"s4 rank {r} {arch} holds {d['cache_bytes']} of "
                   f"{d['cache_whole_bytes']} cache bytes, not a quarter")
        a = ranks[0][arch]
        for what in ("f32", "bf16"):
            t = a[what]
            _check(t["served_is_argmax"] and t["max_abs_diff"] <= 0.05 * t["max_abs_logit"]
                   and t["argmax_agreement"] >= 0.9, f"s4 {arch} {what} logits differ: {t}")
        d = a["decode_record"]
        abstract = _s4_abstract(arch, layers, d)
        depth = "smoke shape" if a["smoke"] else f"{a['layers']} layers, full width"
        held = [r[arch]["held"] for r in ranks]
        caches = [r[arch]["decode_record"]["cache_bytes"] for r in ranks]
        print(f"  {arch} ({depth}) on 2x2 in the sharded serving layout, plan "
              f"{a['dist']} (one device: {a['single_dist']}); ranks 0-3 hold "
              f"{[h['payload']['held'] for h in held]} of {held[0]['payload']['whole']} "
              f"payload bytes (rank 0 x{held[0]['payload']['held'] / held[0]['payload']['whole']:.4f}), "
              f"{[h['dense']['held'] for h in held]} of {held[0]['dense']['whole']} "
              f"dense-leaf bytes (x{held[0]['dense']['held'] / held[0]['dense']['whole']:.4f}), "
              f"{caches} of {d['cache_whole_bytes']} cache bytes "
              f"(x{caches[0] / d['cache_whole_bytes']:.4f})", flush=True)
        print(f"  {arch} each rank: K1 {[r[arch]['launches'].get('onehot', 0) for r in ranks]}"
              f", K6 {[r[arch]['launches'].get('grouped_onehot', 0) for r in ranks]} "
              f"launches (want {a['want']}: one a layer group a step, {a['steps']} steps; "
              f"bf16 the same); vs the one-device plan on each data shard's rows: "
              f"tokens equal {a['tokens_equal']} (first differing (row, position): "
              f"{a['first_differing']}), logits max|diff| {a['max_abs_diff']:.4e}", flush=True)
        for what in ("f32", "bf16"):
            t = a[what]
            print(f"  {arch} {what} teacher-forced on the served tokens over "
                  f"{t['positions']} positions: max|diff| {t['max_abs_diff']:.4e} (max|logit| "
                  f"{t['max_abs_logit']:.4e}), argmax agreement {t['argmax_agreement']:.3f}, "
                  f"{len(t['near_ties'])} disagreements, each a near tie (gap <= 2 x the "
                  f"row's max|diff|): {t['near_ties']}", flush=True)
        print(f"  {arch} f32 decode step on the abstract 2x2 mesh: "
              f"{abstract['n_collectives']} collectives equal to rank 0's one by one "
              f"({abstract['per_kind_count']}, link {abstract['link_bytes']} B); kernel "
              f"calls {abstract['kernels']} = launches {d['launches']}; rank 0 host "
              f"clock (gloo on one card): prefill {a['prefill_ms']:.1f} ms, decode "
              f"{a['decode_ms_per_token']:.2f} ms/token; {a['seconds']:.1f} s", flush=True)
        out[arch] = {k: v for k, v in a.items() if k != "decode_record"} | {
            "abstract": abstract,
            "cache": (d["cache_bytes"], d["cache_whole_bytes"]),
            "k1_launches_per_rank": [r[arch]["launches"].get("onehot", 0) for r in ranks],
            "k6_launches_per_rank": [r[arch]["launches"].get("grouped_onehot", 0)
                                     for r in ranks]}
    return out


#: s5's models: full-width OLMo-1B, Moonshot-16B-A3B at MOE_LAYERS of 48,
#: Mamba-2 780M at S4_SSM_LAYERS of 48, the Jamba smoke hybrid
S5_CASES = (("olmo_1b", 16), (MOE_ARCH, MOE_LAYERS), (SSM_ARCH, S4_SSM_LAYERS),
            (HYBRID_ARCH, None))
S5_REQUESTS = (4, 32)           # requests (= slots, 2 a data rank) x prompt tokens
S5_CHUNK = 16
S5_GEN = 6
#: s5 also serves this case on raw f32 pages (no KV codec), one device and
#: 2x2, to show what the codec adds to the mesh's last-bit differences
S5_RAW_ARCH = "olmo_1b"
S6_LAYERS = 2                   # s6's OLMo-1B depth, at full width
S6_BATCH = (4, 256)             # sequences (over data = 2) x tokens


def _s5_want(plan, cfg) -> dict:
    """The launches a rank's paged lane run makes, from the plan alone (the
    prediction s5 holds its counts to): one K1 a 2-D entry a layer group,
    one K6 an expert stack a group, one K4 (and at most one combine) an
    attention layer."""
    from repro_torch.models import transformer as tfm
    want = {"onehot": 0, "grouped_onehot": 0,
            "paged_attention": tfm.n_groups(cfg) * sum(
                cfg.layer_kind(i) == "attn" for i in range(tfm.period(cfg)))}
    for e in plan.entries.values():
        want["onehot" if len(e.shape) == 3 else "grouped_onehot"] += e.shape[0]
    return want


def _s5_run(cfg, plan, dev, prompts, force=None, mesh=None, rules=None,
            raw_pages=False) -> dict:
    """One paged ``BatchScheduler`` run of s5 (chunked prefill, mip2q KV
    pages, or raw pages if ``raw_pages``), every lane's logits kept (the
    decode lane's gathered whole): tokens, logits, lane runs, ticks and
    host ms (synchronized)."""
    import torch
    from repro_torch.core.policy import StruMConfig
    from repro_torch.models import sharding as shd
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import BatchScheduler, Request
    n, plen = S5_REQUESTS
    sched = BatchScheduler(cfg, None, n_slots=n, max_len=64, mesh=mesh, rules=rules,
                           plan=plan, kv_cache=None if raw_pages else StruMConfig(
                               method="mip2q", p=0.5, q=4, L=7),
                           prefill="chunked", prefill_chunk=S5_CHUNK, device=dev)
    log = []
    for name in ("_decode", "_chunk_prefill"):
        lane = getattr(sched, name)

        def run(*a, lane=lane):
            out = lane(*a)
            lg = out[0] if mesh is None else shd.gather_whole(out[0], mesh)
            log.append(lg.reshape(-1, lg.shape[-1])[:, :cfg.vocab_size].float().cpu())
            return out
        setattr(sched, name, run)
    for i in range(n):
        sched.submit(Request(uid=i, prompt=prompts[i], max_new_tokens=S5_GEN,
                             force_tokens=None if force is None else force[i]))
    moved = tfm.lane_gather_bytes["decode"]
    _reset_kv_counts()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    done = sched.run_to_completion()
    torch.cuda.synchronize(dev)
    ms = (time.perf_counter() - t0) * 1e3
    return {"tokens": [r.output for r in sorted(done, key=lambda r: r.uid)],
            "launches": {k: v for k, v in _kv_counts().items() if v},
            "logits": torch.cat(log), "runs": dict(sched.lane_runs), "ticks": sched._steps,
            "ms": ms, "gathered": tfm.lane_gather_bytes["decode"] - moved}


def _s5_body(rank: int, dev) -> dict:
    """A rank of s5 (2 x 2 mesh): for each of :data:`S5_CASES` at f32, the
    default plan built on the mesh and served by ``BatchScheduler(mesh=)``
    in the paged layout, teacher-forced on one device's tokens (rank 0 runs
    the one-device plan first and sends its tokens); the launches against
    the plan's prediction, the bytes the decode lane gathers and ms a tick.
    One rank at a time draws the whole model on the card (seed 0) and packs
    it."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_serving_plan
    from repro_torch.models import model_defs
    from repro_torch.models import sharding as shd
    from repro_torch.models.params import init_params
    mesh = make_host_mesh(data=2, model=2)
    rules = shd.rules_for_mesh(mesh)
    n, plen = S5_REQUESTS
    out = {}
    for arch, layers in S5_CASES:
        t0 = time.perf_counter()
        cfg = dataclasses.replace(_s4_cfg(arch, layers), dtype="float32")
        gen = torch.Generator().manual_seed(0)
        prompts = [torch.randint(0, cfg.vocab_size, (plen,), generator=gen)
                   for _ in range(n)]
        plan = plan1 = None
        for r in range(dist.get_world_size()):
            if r == rank:
                params = init_params(model_defs(cfg), seed=0, device=dev,
                                     dtype_override="float32")
                plan = build_serving_plan(params, cfg=cfg.strum, mesh=mesh, rules=rules,
                                          device=dev)
                if rank == 0:
                    plan1 = build_serving_plan(params, cfg=cfg.strum, device=dev)
                del params
                torch.cuda.empty_cache()
            dist.barrier()
        want = _s5_want(plan, cfg)
        one = _s5_run(cfg, plan1, dev, prompts) if rank == 0 else None
        box = [None if one is None else one["tokens"]]
        dist.broadcast_object_list(box, src=0)
        got = _s5_run(cfg, plan, dev, prompts, force=box[0], mesh=mesh, rules=rules)
        rec = {"want": want, "launches": got["launches"], "runs": got["runs"],
               "ticks": got["ticks"], "ms_per_tick": got["ms"] / got["ticks"],
               "gathered_per_decode": got["gathered"] / max(got["runs"]["decode"], 1),
               "layers": cfg.n_layers, "smoke": layers is None}
        if rank == 0:
            ref, lg = one["logits"], got["logits"]
            rec.update(tokens_equal=got["tokens"] == one["tokens"],
                       tokens=got["tokens"][0], one_tokens=one["tokens"][0],
                       one_ms_per_tick=one["ms"] / one["ticks"],
                       one_launches=one["launches"],
                       max_abs_diff=(lg - ref).abs().max().item(),
                       max_abs_logit=ref.abs().max().item(),
                       near_ties=_near_ties(ref[None], lg[None], ref.argmax(-1)[None],
                                            f"s5 {arch}"))
        if arch == S5_RAW_ARCH:
            one_raw = _s5_run(cfg, plan1, dev, prompts, raw_pages=True) if rank == 0 else None
            box = [None if one_raw is None else one_raw["tokens"]]
            dist.broadcast_object_list(box, src=0)
            raw = _s5_run(cfg, plan, dev, prompts, force=box[0], mesh=mesh, rules=rules,
                          raw_pages=True)
            if rank == 0:
                rec["raw_max_abs_diff"] = (raw["logits"] - one_raw["logits"]).abs().max().item()
                rec["raw_max_abs_logit"] = one_raw["logits"].abs().max().item()
            del one_raw, raw
        del plan, plan1, one, got
        torch.cuda.empty_cache()
        rec["seconds"] = time.perf_counter() - t0
        dist.barrier()
        out[arch] = rec
    return out


def _check_s5(ranks: list) -> dict:
    """s5's launches against the plan's prediction on every rank, the
    tokens and logits against one device's."""
    out = {}
    for arch, _ in S5_CASES:
        for r, res in enumerate(ranks):
            a = res[arch]
            lanes = a["runs"]["decode"] + a["runs"]["prefill_chunk"]
            want = {k: v * lanes for k, v in a["want"].items() if v}
            live = {k: v for k, v in a["launches"].items() if not k.endswith("_combine")}
            _check(live == want, f"s5 rank {r} {arch} launches {live}, want {want} "
                                 f"({a['want']} a lane run x {lanes})")
            # a 64-position window's tables never split: no combine is due
            comb = a["launches"].get("paged_attention_combine", 0)
            _check(comb <= a["launches"].get("paged_attention", 0),
                   f"s5 rank {r} {arch}: {comb} combines, more than K4's launches")
        a = ranks[0][arch]
        _check(a["max_abs_diff"] <= 1e-3 * max(a["max_abs_logit"], 1.0),
               f"s5 {arch} lane logits differ from one device's: {a['max_abs_diff']}")
        if "raw_max_abs_diff" in a:
            _check(a["raw_max_abs_diff"] <= 1e-3 * max(a["raw_max_abs_logit"], 1.0),
                   f"s5 {arch} raw-page lane logits differ from one device's: "
                   f"{a['raw_max_abs_diff']}")
        depth = "smoke shape" if a["smoke"] else f"{a['layers']} layers, full width"
        print(f"  {arch} ({depth}) BatchScheduler(mesh=2x2), {S5_REQUESTS[0]} requests x "
              f"{S5_REQUESTS[1]} tokens, chunk {S5_CHUNK}, {S5_GEN} new, f32, teacher-"
              f"forced on one device's tokens: tokens equal {a['tokens_equal']} "
              f"(request 0: {a['tokens']} vs {a['one_tokens']}), lane logits max|diff| "
              f"{a['max_abs_diff']:.4e} (max|logit| {a['max_abs_logit']:.4e}), "
              f"{len(a['near_ties'])} argmax disagreements, each a near tie: "
              f"{a['near_ties']}", flush=True)
        if "raw_max_abs_diff" in a:
            print(f"  {arch} on raw f32 pages (no KV codec), teacher-forced on one device's "
                  f"raw-page tokens: lane logits max|diff| {a['raw_max_abs_diff']:.4e} "
                  f"(max|logit| {a['raw_max_abs_logit']:.4e}; mip2q pages "
                  f"{a['max_abs_diff']:.4e})", flush=True)
        print(f"  {arch} each rank: launches {[r[arch]['launches'] for r in ranks]} = "
              f"the prediction {a['want']} a lane run x {a['runs']['decode']} decode + "
              f"{a['runs']['prefill_chunk']} prefill-chunk runs (one device: "
              f"{a['one_launches']}); decode lane all-gathers "
              f"{a['gathered_per_decode']:.0f} B a run; {a['ms_per_tick']:.1f} ms a tick "
              f"over {a['ticks']} ticks (one device {a['one_ms_per_tick']:.1f} ms; rank 0 "
              f"host clock, gloo on one card); {a['seconds']:.1f} s", flush=True)
        out[arch] = {k: v for k, v in a.items() if k != "near_ties"} | {
            "near_ties": len(a["near_ties"]),
            "launches_per_rank": [r[arch]["launches"] for r in ranks]}
    return out


def _s6_body(rank: int, dev) -> dict:
    """A rank of s6 (2 x 2 mesh): one train step of full-width OLMo-1B at
    S6_LAYERS layers, batch 4 x 256, f32, in the dense decoders' train
    layout and then as ZeRO-3 (``launch.steps._zero3_step``), each timed
    from the same inputs after a warm-up step (host clock, synchronized)
    with this process's peak memory; rank 0 also takes the step on one
    device and holds the new parameters to it."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import get_config
    from repro_torch.core.apply import _named_leaves
    from repro_torch.data.pipeline import DataConfig, global_batch
    from repro_torch.launch import steps as St
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model_defs
    from repro_torch.models import sharding as shd
    from repro_torch.models.params import gather_params, init_params, shard_params
    from repro_torch.optim.adamw import AdamWConfig, adamw_update, init_opt_state
    cfg = dataclasses.replace(get_config("olmo_1b"), n_layers=S6_LAYERS, dtype="float32")
    defs = model_defs(cfg)
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    mesh = make_host_mesh(data=2, model=2)
    rules = shd.rules_for_mesh(mesh)
    b, s = S6_BATCH
    batch = global_batch(DataConfig(vocab_size=cfg.vocab_size, seq_len=s,
                                    global_batch=b, seed=0), 0, device=dev)
    params = init_params(defs, seed=0, device=dev, dtype_override="float32")
    placed = shard_params(params, defs, mesh, rules)
    opt = init_opt_state(placed)
    if rank != 0:
        del params
    torch.cuda.empty_cache()
    out = {"held_bytes": sum(t.numel() * 4 for _, t in _named_leaves(placed)),
           "whole_bytes": sum(math.prod(shd.placement(t).shape) * 4
                              for _, t in _named_leaves(placed))}
    (_, _), grads = St._tp_value_and_grad(placed, batch, cfg, mesh, rules)
    grads = gather_params(grads, defs, mesh, rules)
    for name, step in (("tp", St.make_train_step(cfg, ocfg, mesh=mesh, rules=rules)),
                       ("zero3", St._zero3_step(cfg, ocfg, mesh, rules, False))):
        step(placed, opt, batch)                           # warm-up
        torch.cuda.synchronize(dev)
        dist.barrier()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        new, _, m = step(placed, opt, batch)
        torch.cuda.synchronize(dev)
        out[name] = {"ms": (time.perf_counter() - t0) * 1e3, "loss": float(m["loss"]),
                     "grad_norm": float(m["grad_norm"]),
                     "peak_bytes": torch.cuda.max_memory_allocated(dev),
                     "peak_over_resident": torch.cuda.max_memory_allocated(dev) - base}
        if name == "tp":
            tp_new = gather_params(new, defs, mesh, rules)
        del new
        torch.cuda.empty_cache()
        dist.barrier()
    if rank == 0:     # s3's holds: the gradients, then r2's element-wise bound
        (l1, _), g1 = St._value_and_grad(params, batch, cfg)
        p1, _, m1 = adamw_update(ocfg, params, g1, init_opt_state(params))
        ly = dict(_named_leaves(g1))
        out["one"] = {"loss": float(l1), "grad_norm": float(m1["grad_norm"])}
        out["grad_rel"] = max((g.double() - ly[n].double()).abs().max().item()
                              / max(ly[n].abs().max().item(), 1e-30)
                              for n, g in _named_leaves(grads))
        out["step_gap"] = _step_gap(ocfg, params, grads, g1, tp_new, p1,
                                    max(float(m1["lr"]), ocfg.lr),
                                    (out["tp"]["grad_norm"], float(m1["grad_norm"])))
    del tp_new, grads
    torch.cuda.empty_cache()
    return out


def _check_s6(ranks: list) -> dict:
    """s6 against the one-device step, to s3's (r2's) limits: loss and grad
    norm within 1e-4 relative, gradients within 1e-3 of each leaf's
    largest, the step within what the gradient gap allows element by
    element and within 1e-5 of each leaf's largest where |e| >= 1e3·eps."""
    r0 = ranks[0]
    one, tp, z3, gap = r0["one"], r0["tp"], r0["zero3"], r0["step_gap"]
    loss_rel = abs(tp["loss"] - one["loss"]) / abs(one["loss"])
    gn_rel = abs(tp["grad_norm"] - one["grad_norm"]) / abs(one["grad_norm"])
    print(f"  OLMo-1B ({S6_LAYERS} layers, full width, f32) one train step on 2x2, batch "
          f"{S6_BATCH[0]} x {S6_BATCH[1]}: loss {tp['loss']:.6f} vs one device "
          f"{one['loss']:.6f} (rel {loss_rel:.2e}, limit 1e-4), grad norm "
          f"{tp['grad_norm']:.6f} vs {one['grad_norm']:.6f} (rel {gn_rel:.2e}, limit "
          f"1e-4), gradients max|diff| / leaf max {r0['grad_rel']:.2e} (limit 1e-3); the "
          f"step at most {gap['bound_ratio']:.3f} of what the gradient gap allows (limit "
          f"1), {gap['rel']:.2e} of max|p| where |e| >= 1e3·eps (limit 1e-5; "
          f"{gap['outside']} of {gap['elements']} elements below it); ZeRO-3 loss "
          f"{z3['loss']:.6f}", flush=True)
    print(f"  each rank holds {[r['held_bytes'] for r in ranks]} of "
          f"{r0['whole_bytes']} parameter bytes; ms a step (host clock, gloo on one "
          f"card): train layout {[round(r['tp']['ms'], 1) for r in ranks]}, ZeRO-3 "
          f"{[round(r['zero3']['ms'], 1) for r in ranks]}; peak memory a rank: train "
          f"layout {[r['tp']['peak_bytes'] for r in ranks]} B "
          f"({[r['tp']['peak_over_resident'] for r in ranks]} over resident), ZeRO-3 "
          f"{[r['zero3']['peak_bytes'] for r in ranks]} B "
          f"({[r['zero3']['peak_over_resident'] for r in ranks]} over resident)",
          flush=True)
    _check(loss_rel <= 1e-4 and gn_rel <= 1e-4, f"s6 loss / grad norm differ: "
                                                f"{loss_rel}, {gn_rel}")
    _check(r0["grad_rel"] <= 1e-3, f"s6 gradients differ: {r0['grad_rel']} > 1e-3")
    _check(gap["bound_ratio"] <= 1.0, f"s6 steps differ past the gradient gap: {gap}")
    _check(gap["rel"] <= 1e-5, f"s6 steps differ where |e| >= 1e3·eps: {gap}")
    _check(all(r["held_bytes"] < r0["whole_bytes"] for r in ranks),
           f"s6 ranks hold {[r['held_bytes'] for r in ranks]} of {r0['whole_bytes']}")
    return {"loss_rel": loss_rel, "grad_norm_rel": gn_rel, "grad_rel": r0["grad_rel"],
            "step_gap": {k: v for k, v in gap.items() if k != "bound_at"},
            "per_rank": [{k: r[k] for k in ("tp", "zero3", "held_bytes")} for r in ranks]}


#: s7's cases: (arch, layers at full width, or None for the smoke shape;
#: whether the ZeRO-3 step is timed beside the train layout).  Moonshot at 1
#: layer: a rank's shards with gradients, moments and the new parameters
#: take ~9 GB, rank 0's one-device step ~35 GB at its peak, on one card;
#: its ZeRO-3 step (whole trees on every rank) is not run
S7_CASES = ((MOE_ARCH, 1, False), (SSM_ARCH, 2, True), (HYBRID_ARCH, None, False))


def _s7_cfg(arch: str, layers):
    """s7's config of ``arch`` at f32 activations: full width at
    ``layers``, or the smoke shape."""
    from repro_torch.configs.base import get_config, get_smoke_config
    cfg = get_smoke_config(arch) if layers is None else dataclasses.replace(
        get_config(arch), n_layers=layers)
    return dataclasses.replace(cfg, dtype="float32")


def _no_drops(cfg):
    """``cfg`` with an MoE capacity factor of at least ``n_experts /
    top_k``: a rank's capacity is then every row it routes and no
    assignment can drop, so the mesh step is one device's.  Below it each
    data rank routes its rows with its own capacity (the reference's
    sharded step), which is not one device's routing."""
    if not cfg.n_experts:
        return cfg
    return dataclasses.replace(cfg, capacity_factor=max(cfg.capacity_factor,
                                                        cfg.n_experts / cfg.top_k))


def _drops(fn, *args, **kw) -> tuple:
    """``(assignments the MoE layers drop, fn's result)`` of one call of a
    forward ``fn`` without autograd (under it, remat's recompute would
    route every layer twice)."""
    import torch
    with torch.no_grad(), _Drops() as drops:
        out = fn(*args, **kw)
    return drops.n, out


class _Drops:
    """While entered, counts the assignments the MoE layers drop: each
    ``moe._route`` call's assignments to its experts that find no slot
    (one host read a call)."""

    def __enter__(self):
        import torch
        from repro_torch.models import moe
        self.n, self.route = 0, moe._route

        def route(x2, router_w, cfg, e_offset, e_local, capacity, split=None):
            r = self.route(x2, router_w, cfg, e_offset, e_local, capacity, split)
            with torch.no_grad():
                probs = torch.softmax(x2.float() @ router_w.float(), dim=-1)
                top = moe._top_k(probs, cfg.top_k)[1]
                mine = ((top >= e_offset) & (top < e_offset + e_local)).sum()
                self.n += int(mine - r["keep"].sum())
            return r
        moe._route = route
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe._route = self.route


def _first_step_state(params):
    """AdamW's state before its first step (``init_opt_state``'s values)
    with each zero moment a broadcast view of one element: four full-width
    Moonshot ranks on one card have no room for two more copies of their
    shards beside the step's own new moments."""
    import torch
    from repro_torch.core.apply import map_named, tree_leaves
    from repro_torch.optim.adamw import OptState

    def zero(_, p):
        return torch.zeros((), dtype=torch.float32, device=p.device).expand(p.shape)
    dev = tree_leaves(params)[0].device
    return OptState(torch.zeros((), dtype=torch.int32, device=dev),
                    map_named(zero, params), map_named(zero, params))


def _s7_case(rank: int, dev, arch: str, layers, zero3: bool) -> dict:
    """One s7 case on this rank of 2x2 (the module docstring), each step
    from AdamW's first-step state (:func:`_first_step_state`): rank 0
    takes the one-device step first while the others wait, and keeps its
    parameters, gradients and new parameters on the host; then one rank
    at a time draws the whole model (seed 0) and keeps its shards; each
    step timed after a warm-up; then the train layout's gradients (dropped
    assignments counted) and the AdamW update from them; then each leaf of
    the gradients and of the new parameters gathered whole in turn, and
    rank 0 holds it to the one-device step.  An MoE config runs at :func:`_no_drops`' capacity
    factor; where its own is lower, the loss, aux and dropped assignments
    of the mesh and of one device at its own factor (the departure) are
    taken too, untimed."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.apply import _named_leaves
    from repro_torch.data.pipeline import DataConfig, global_batch
    from repro_torch.launch import steps as St
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model_defs
    from repro_torch.models import sharding as shd
    from repro_torch.models import transformer as tfm
    from repro_torch.models.params import init_params, shard_params
    from repro_torch.optim.adamw import AdamWConfig, adamw_update, global_norm
    own = _s7_cfg(arch, layers)
    cfg = _no_drops(own)
    defs = model_defs(cfg)
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    mesh = make_host_mesh(data=2, model=2)
    rules = shd.rules_for_mesh(mesh)
    b, s = S6_BATCH
    batch = global_batch(DataConfig(vocab_size=cfg.vocab_size, seq_len=s,
                                    global_batch=b, seed=0), 0, device=dev)
    out = {"layers": cfg.n_layers, "smoke": layers is None,
           "capacity_factor": cfg.capacity_factor,
           "assignments": b * s * cfg.top_k * sum(
               cfg.layer_is_moe(i) for i in range(cfg.n_layers))}
    host = None
    departs = own.capacity_factor < cfg.capacity_factor
    if rank == 0:
        params = init_params(defs, seed=0, device=dev, dtype_override="float32")
        (l1, _), g1 = St._value_and_grad(params, batch, cfg)
        p1, o1, m1 = adamw_update(ocfg, params, g1, _first_step_state(params))
        out["one"] = {"loss": float(l1), "grad_norm": float(m1["grad_norm"]),
                      "lr": float(m1["lr"]),
                      "drops": _drops(tfm.loss_fn, params, batch, cfg)[0]}
        if departs:     # the departure's one-device side, untimed
            n, (loss, m) = _drops(tfm.loss_fn, params, batch, own)
            out["own_one"] = {"loss": float(loss), "aux": float(m["aux"]), "drops": n}
        host = [{n: t.cpu() for n, t in _named_leaves(tree)} for tree in (params, g1, p1)]
        del params, g1, p1, o1, m1
        torch.cuda.empty_cache()
    dist.barrier()
    for r in range(dist.get_world_size()):
        if r == rank:
            whole = init_params(defs, seed=0, device=dev, dtype_override="float32")
            placed = shard_params(whole, defs, mesh, rules)
            del whole
            torch.cuda.empty_cache()
        dist.barrier()
    opt = _first_step_state(placed)
    out["held_bytes"] = sum(t.numel() * 4 for _, t in _named_leaves(placed))
    out["whole_bytes"] = sum(math.prod(shd.placement(t).shape) * 4
                             for _, t in _named_leaves(placed))
    layouts = [("tp", St.make_train_step(cfg, ocfg, mesh=mesh, rules=rules))]
    if zero3:
        layouts.append(("zero3", St._zero3_step(cfg, ocfg, mesh, rules, False)))
    for name, step in layouts:
        step(placed, opt, batch)                           # warm-up
        torch.cuda.synchronize(dev)
        dist.barrier()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        new, new_opt, m = step(placed, opt, batch)
        torch.cuda.synchronize(dev)
        out[name] = {"ms": (time.perf_counter() - t0) * 1e3, "loss": float(m["loss"]),
                     "grad_norm": float(m["grad_norm"]), "aux": float(m["aux"]),
                     "peak_bytes": torch.cuda.max_memory_allocated(dev),
                     "peak_over_resident": torch.cuda.max_memory_allocated(dev) - base}
        del new, new_opt
        torch.cuda.empty_cache()
        dist.barrier()
    (_, _), grads = St._tp_value_and_grad(placed, batch, cfg, mesh, rules)
    local = {k: shd.shard_slice(v, shd.P(rules.table["batch"]), mesh)
             for k, v in batch.items()}
    out["drops"] = _drops(tfm.loss_fn, placed, local, cfg, mesh=mesh, rules=rules)[0]
    # the step from these gradients, as _tp_step takes it: the timed step's
    # own may differ in their last bits (the MoE combine's scatter-add and
    # the embedding's backward add atomically on the card), and AdamW's
    # first step turns that into up to lr on an element whose gradient is
    # near eps
    tp_new = St._held_as(adamw_update(ocfg, placed, grads, opt,
                                      gnorm=global_norm(grads, mesh))[0], placed)
    del opt
    if departs:         # the departure, at the config's own capacity factor
        (loss, m), _ = St._tp_value_and_grad(placed, batch, own, mesh, rules)
        out["own"] = {"capacity_factor": own.capacity_factor, "loss": float(loss),
                      "aux": float(m["aux"]), "drops": _drops(
                          tfm.loss_fn, placed, local, own, mesh=mesh, rules=rules)[0]}
    del placed
    torch.cuda.empty_cache()
    # leaf by leaf: the mesh's gradient and new parameter gathered whole,
    # held by rank 0 to the one-device step (r2's bound, s3's limits)
    gaps, grad_rel = [], 0.0
    if rank == 0:
        norms = (out["tp"]["grad_norm"], out["one"]["grad_norm"])
        lr = max(out["one"]["lr"], ocfg.lr)
    for (n, g), (_, pn) in zip(_named_leaves(grads), _named_leaves(tp_new)):
        gw, pw = shd.gather_whole(g, mesh), shd.gather_whole(pn, mesh)
        if rank == 0:
            p0, g1, p1 = (t[n].to(dev) for t in host)
            grad_rel = max(grad_rel, (gw.double() - g1.double()).abs().max().item()
                           / max(g1.abs().max().item(), 1e-30))
            gaps.append(_step_gap(ocfg, {n: p0}, {n: gw}, {n: g1}, {n: pw}, {n: p1},
                                  lr, norms))
            del p0, g1, p1
        del gw, pw
        torch.cuda.empty_cache()
    if rank == 0:
        worst = max(gaps, key=lambda g: g["bound_ratio"])
        out["grad_rel"] = grad_rel
        out["step_gap"] = {"bound_ratio": worst["bound_ratio"], "bound_at": worst["bound_at"],
                           "rel": max(g["rel"] for g in gaps),
                           "outside": sum(g["outside"] for g in gaps),
                           "elements": sum(g["elements"] for g in gaps)}
    del grads, tp_new, host
    torch.cuda.empty_cache()
    dist.barrier()
    return out


def _s7_body(rank: int, dev) -> dict:
    """A rank of s7 (2 x 2 mesh): every :data:`S7_CASES` case in turn."""
    out = {}
    for arch, layers, zero3 in S7_CASES:
        t0 = time.perf_counter()
        out[arch] = _s7_case(rank, dev, arch, layers, zero3)
        out[arch]["seconds"] = time.perf_counter() - t0
    return out


def _check_s7(ranks: list) -> dict:
    """s7 against the one-device steps, to s3's (r2's) limits, as
    :func:`_check_s6` holds s6."""
    out = {}
    for arch, layers, zero3 in S7_CASES:
        r0 = ranks[0][arch]
        one, tp, gap = r0["one"], r0["tp"], r0["step_gap"]
        loss_rel = abs(tp["loss"] - one["loss"]) / abs(one["loss"])
        gn_rel = abs(tp["grad_norm"] - one["grad_norm"]) / abs(one["grad_norm"])
        drops = sum(r[arch]["drops"] for r in ranks)
        depth = "smoke shape" if r0["smoke"] else f"{r0['layers']} layers, full width"
        z3 = (f"; ZeRO-3 {[round(r[arch]['zero3']['ms'], 1) for r in ranks]} ms, peak "
              f"{[r[arch]['zero3']['peak_bytes'] for r in ranks]} B "
              f"({[r[arch]['zero3']['peak_over_resident'] for r in ranks]} over "
              f"resident), loss {r0['zero3']['loss']:.6f}") if zero3 else ""
        print(f"  {arch} ({depth}, f32, capacity factor {r0['capacity_factor']:.4g}) one "
              f"train step on 2x2, batch {S6_BATCH[0]} x {S6_BATCH[1]}: loss {tp['loss']:.6f} vs one device {one['loss']:.6f} "
              f"(rel {loss_rel:.2e}, limit 1e-4), grad norm {tp['grad_norm']:.6f} vs "
              f"{one['grad_norm']:.6f} (rel {gn_rel:.2e}, limit 1e-4), gradients "
              f"max|diff| / leaf max {r0['grad_rel']:.2e} (limit 1e-3); the step at most "
              f"{gap['bound_ratio']:.3f} of what the gradient gap allows (limit 1), "
              f"{gap['rel']:.2e} of max|p| where |e| >= 1e3·eps (limit 1e-5; "
              f"{gap['outside']} of {gap['elements']} elements below it); dropped "
              f"assignments {drops} on the mesh (the ranks' "
              f"{[r[arch]['drops'] for r in ranks]}), {one['drops']} on one device, of "
              f"{r0['assignments']}", flush=True)
        if "own" in r0:
            mo, oo = r0["own"], r0["own_one"]
            print(f"  {arch} at its own capacity factor {mo['capacity_factor']} (each data "
                  f"rank routes its rows with its own capacity, the reference's sharded "
                  f"step): mesh loss {mo['loss']:.6f}, aux {mo['aux']:.6f}, "
                  f"{sum(r[arch]['own']['drops'] for r in ranks)} assignments dropped; "
                  f"one device loss {oo['loss']:.6f}, aux {oo['aux']:.6f}, {oo['drops']} "
                  f"dropped", flush=True)
        print(f"  {arch} each rank holds {[r[arch]['held_bytes'] for r in ranks]} of "
              f"{r0['whole_bytes']} parameter bytes; ms a step (host clock, gloo on one "
              f"card): train layout {[round(r[arch]['tp']['ms'], 1) for r in ranks]}, "
              f"peak {[r[arch]['tp']['peak_bytes'] for r in ranks]} B "
              f"({[r[arch]['tp']['peak_over_resident'] for r in ranks]} over "
              f"resident){z3}; {r0['seconds']:.1f} s", flush=True)
        _check(loss_rel <= 1e-4 and gn_rel <= 1e-4,
               f"s7 {arch} loss / grad norm differ: {loss_rel}, {gn_rel}")
        _check(r0["grad_rel"] <= 1e-3, f"s7 {arch} gradients differ: {r0['grad_rel']}")
        _check(gap["bound_ratio"] <= 1.0, f"s7 {arch} steps differ past the gradient "
                                          f"gap: {gap}")
        _check(gap["rel"] <= 1e-5, f"s7 {arch} steps differ where |e| >= 1e3·eps: {gap}")
        _check(drops == one["drops"] == 0, f"s7 {arch} dropped assignments at "
                                           f"capacity factor {r0['capacity_factor']}")
        _check(all(r[arch]["held_bytes"] < r0["whole_bytes"] for r in ranks),
               f"s7 {arch} ranks hold {[r[arch]['held_bytes'] for r in ranks]} of "
               f"{r0['whole_bytes']}")
        out[arch] = {"loss_rel": loss_rel, "grad_norm_rel": gn_rel,
                     "grad_rel": r0["grad_rel"], "drops": drops, "one_drops": one["drops"],
                     "own": r0.get("own"), "own_one": r0.get("own_one"),
                     "step_gap": {k: v for k, v in gap.items() if k != "bound_at"},
                     "seconds": r0["seconds"],
                     "per_rank": [{k: r[arch][k] for k in ("tp", "held_bytes")
                                   + (("zero3",) if zero3 else ())} for r in ranks]}
    return out


def _mesh_report(mesh, smi) -> None:
    """Phase s's summary line."""
    s1, s2 = mesh["s1"], mesh["s2"]
    s7_rel = {a: f"{r['loss_rel']:.2e}" for a, r in mesh["s7"].items() if a != "seconds"}
    print(f"mesh path: s1 (NCCL, 1x1) dense K1 {s1['dense_launches']}, paged K1 "
          f"{s1['paged_launches']} / K4 {s1['paged_k4']}, paged drain "
          f"{s1['drain_ms']:.1f} ms; s2 (gloo 2x2) K1 per rank "
          f"{s2['k1_launches_per_rank']}, K6 per rank {s2['k6_launches_per_rank']}; s3 "
          f"ZeRO-3 loss rel {mesh['s3']['loss_rel']:.2e}; s4 (gloo 2x2) K1 / K6 per "
          f"rank {({a: (r['k1_launches_per_rank'], r['k6_launches_per_rank']) for a, r in mesh['s4'].items() if a != 'seconds'})}; s5 (gloo 2x2, paged) "
          f"launches per rank {({a: r['launches_per_rank'][0] for a, r in mesh['s5'].items() if a != 'seconds'})}; "
          f"s6 (gloo 2x2, train) loss rel {mesh['s6']['loss_rel']:.2e}; s7 (gloo 2x2, "
          f"MoE / SSM / hybrid train) loss rel {s7_rel}; sub-phase seconds "
          f"{ {k: round(v['seconds'], 1) for k, v in mesh.items() if k != 'seconds'} }, "
          f"phase s {mesh['seconds']:.1f} s; {smi}")


# ----------------------------------------------------- t. static analysis --

T_LAYERS = 2                    # t4's depth, at full width
#: the kernels every lint on the card must launch: K1-K11
T_KERNELS = ("onehot", "maskfree", "dense", "paged_attention",
             "paged_attention_maskfree", "page_decode", "grouped_onehot",
             "grouped_maskfree", "grouped_dense", "histream", "maskfree_p")
#: the lanes the recompile lint flags today (ROADMAP perf item 1)
T_RETRACING = ("serial-scheduler/serial_prefill", "spec-scheduler/commit")


def phase_t1(dev) -> dict:
    """The registry audit, then the launch-contract lint on the card: every
    point a cuda-family predicate accepts launched and held to its plain
    version, and the C++ refusals probed."""
    from repro_torch.analysis import pallas_lint, registry_audit
    audit, _ = registry_audit.audit_registry()
    _check(audit.ok, f"registry audit: {audit.render()}")
    st: dict = {}
    lint = pallas_lint.lint_pallas(device=dev, stats=st)
    _check(lint.ok, f"launch-contract lint: {lint.render()}")
    missing = [k for k in T_KERNELS if st["launches"].get(k, 0) <= 0]
    _check(not missing, f"the lint launched none of {missing}: {st['launches']}")
    bad = [r for r in st["refusals"] if r[2] != 1]
    _check(st["refusals"] and not bad, f"C++ refusals {st['refusals']}")
    worst = {k: {"max_abs_err": e, "limit": lim} for k, (e, lim) in st["worst"].items()}
    print(f"  accepted points per kernel {st['points']}", flush=True)
    print(f"  launches per kernel {st['launches']}", flush=True)
    print(f"  worst |kernel - plain| (limit) {worst}", flush=True)
    print(f"  C++ refusals (probe, .cu line, CUDA error): {st['refusals']}", flush=True)
    print(f"  findings: audit {len(audit.findings)} ({len(audit.errors())} errors), "
          f"lint {len(lint.findings)} ({len(lint.errors())} errors)", flush=True)
    return {"points": st["points"], "launches": st["launches"], "worst": worst,
            "refusals": st["refusals"],
            "audit_findings": len(audit.findings),
            "lint_findings": len(lint.findings)}


def _t_olmo(dev, layers=None):
    """Full-width OLMo-1B (``layers`` of 16) under phase d's plan: mip2q p=0.5
    L=5, f32 parameters from seed 0."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.policy import StruMConfig
    from repro_torch.launch.steps import build_serving_plan
    from repro_torch.models import model_defs
    from repro_torch.models.params import init_params
    scfg = StruMConfig(method="mip2q", p=0.5, L=5)
    cfg = dataclasses.replace(get_config("olmo_1b"), strum=scfg)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    params = init_params(model_defs(cfg), seed=0, device=dev, dtype_override="float32")
    return cfg, params, build_serving_plan(params, cfg=scfg, device=dev)


def _t_paged(cfg, plan, dev, **kw):
    """Phase h's scheduler (4 slots, mip2q pages of 16) with 4 requests of 128
    tokens admitted and prefilled: every slot decoding."""
    import torch
    from repro_torch.core.policy import StruMConfig
    from repro_torch.serving import BatchScheduler, Request
    sched = BatchScheduler(cfg, None, n_slots=4, max_len=128 + 33 + PAGE, plan=plan,
                           kv_cache=StruMConfig(method="mip2q", p=0.5, q=4, L=7),
                           page_size=PAGE, device=dev, **kw)
    gen = torch.Generator().manual_seed(0)
    for i in range(4):
        sched.submit(Request(uid=i, prompt=torch.randint(0, cfg.vocab_size, (128,),
                                                         generator=gen),
                             max_new_tokens=33))
    while sched.queue or sched._prefill_slots():
        sched.step()
    return sched


def _region_events(trace, prefix) -> dict:
    """Stored regions whose leaf tag starts with ``prefix`` -> the events
    handed them."""
    return {r: [trace.events[i] for i in ev] for r, ev in trace.read_regions.items()
            if r[0].startswith(prefix)}


def phase_t2(dev) -> dict:
    """Dataflow on full-width OLMo-1B: one dense decode step (each linear
    one K1 launch reading its leaf's fields once, no decoded copy) and one
    paged decode tick (K4 the only reader of the sealed pools, the pool
    bytes it reads the packed payload of the live pages: the table's
    entries below each slot's sealed count; ``attn/fused/packed_bytes``
    counts the table's capacity, every entry, as the reference does)."""
    import torch
    from repro_torch import telemetry
    from repro_torch.analysis import dataflow, suite
    from repro_torch.kernels import strum_attention as A
    from repro_torch.kernels import strum_matmul as K
    from repro_torch.launch import serve as S
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    cfg, params, plan = _t_olmo(dev)
    del params
    _check(cfg.n_layers == 16 and cfg.d_model == 2048, f"not full-width OLMo-1B: {cfg}")
    prompt = torch.randint(0, cfg.vocab_size, (4, 32),
                           generator=torch.Generator().manual_seed(0)).to(dev)
    lg, caches = make_prefill_step(cfg)(plan.params, {"tokens": prompt})
    tok = lg[:, -1, :cfg.vocab_size].argmax(-1)[:, None]
    caches = S.pad_caches(caches, 1)
    k1_before = K.launch_counts["onehot"]
    with telemetry.recording() as rec:
        trace = dataflow.trace_dataflow(make_decode_step(cfg), plan.params, tok,
                                        caches, 32)
    torch.cuda.synchronize()
    n_lin = 7 * cfg.n_layers
    calls = trace.kernel_calls()
    _check(len(calls) == n_lin and all(e.name == "cuda:onehot" and e.route == "cuda"
                                       for e in calls),
           f"decode step made {[(e.name, e.route) for e in calls]} kernel calls")
    _check(K.launch_counts["onehot"] - k1_before == n_lin,
           f"K1 launched {K.launch_counts['onehot'] - k1_before}, want {n_lin}")
    per_call = [{f: len(r) for f, r in e.reads.items()} for e in calls]
    _check(all(p == {"mask": 1, "hi": 1, "lo": 1, "scale": 1} for p in per_call),
           f"K1 calls read {per_call[:3]}...")
    weights = _region_events(trace, "0/0/")
    leaves = {(t, off) for t, f, off in weights if f == "mask"}
    _check(len(leaves) == n_lin and all(len(ev) == 1 and ev[0].kind == "kernel"
                                        for ev in weights.values()),
           f"{len(leaves)} weight leaves read, by {set(len(e) for e in weights.values())}"
           " events each")
    sites = [trace.events[i] for i, _ in trace.decode_sites]
    _check(len(sites) == n_lin and all(e.kind == "kernel" for e in sites),
           f"decode sites {[(e.kind, e.name) for e in sites][:5]}... ({len(sites)})")
    counters = rec.counters("dispatch/variant/")
    _check(counters == {"cuda:onehot": n_lin},
           f"dispatch counters {counters}")
    dense = dataflow.verify(None, trace=trace, location="olmo_1b/decode-step")
    _check(dense.ok, dense.render())
    dense_events = len(trace.events)
    print(f"  dense decode step: {dense_events} events, {n_lin} K1 launches, each "
          f"handed its leaf's mask/hi/lo/scale once ({len(weights)} regions, one "
          f"reader each), {len(sites)} decode sites all K1 launches, no decoded copy, "
          f"counters {counters}", flush=True)

    sched = _t_paged(cfg, plan, dev)
    active = sched._decode_slots()
    _check(len(active) == 4, f"slots decoding {active}")
    mask = torch.zeros(4, dtype=torch.bool)
    mask[active] = True
    args = (sched.params, sched._dev(sched._tokens)[:, None], sched.pools,
            suite._clone(sched.hot), sched._dev(sched._cache_len()),
            sched._dev(sched._table), mask.to(dev))
    k4_before = dict(A.launch_counts)
    with telemetry.recording() as rec:
        trace = dataflow.trace_dataflow(sched._decode, *args)
    torch.cuda.synchronize()
    k4 = trace.kernel_calls("cache:attn_fused")
    launched = {k: A.launch_counts[k] - k4_before[k] for k in A.launch_counts}
    _check(len(k4) == cfg.n_layers and all(e.route == "cuda" for e in k4) and
           launched["paged_attention"] == cfg.n_layers,
           f"{len(k4)} K4 calls, launches {launched}")
    pools = _region_events(trace, "0/2/")
    _check(pools and all(all(e.kind == "kernel" and e.name == "cache:attn_fused"
                             for e in ev) for ev in pools.values()),
           "sealed pools read by " + str({e.name for ev in pools.values() for e in ev}))
    lens, table = sched._cache_len(), sched._table
    want = suite.fused_read_bytes(sched, lens=lens, table=table)
    capacity = suite.fused_read_bytes(sched)
    got = trace.sealed_gather_packed_bytes()
    counter = rec.counters().get("attn/fused/packed_bytes")
    _check(0 < got == want < capacity == counter,
           f"pool bytes read {got}, live payload {want}, table capacity {capacity}, "
           f"counter {counter}")
    paged = dataflow.verify(None, trace=trace, location="olmo_1b/paged-tick",
                            expected_gather_packed_bytes=want, forbid_fp_pages=True)
    _check(paged.ok, paged.render())
    n_pools = sum(p["k"]["mask"].shape[0] for p in sched.pools.values() if p)
    ppb = capacity // (n_pools * 2 * sched.n_slots * sched.pages_per_seq)
    live = want // (n_pools * 2 * ppb)
    print(f"  paged decode tick: {len(trace.events)} events, {len(k4)} K4 launches (+ "
          f"{launched['paged_attention_combine']} combines), {len(pools)} pool regions "
          f"read by K4 only; pool bytes read {got} = {n_pools} pools x 2 x {live} live "
          f"(slot, page) entries of {sched.n_slots} x {sched.pages_per_seq} x {ppb} B; "
          f"attn/fused/packed_bytes {counter} = the table's capacity", flush=True)
    return {"decode_events": dense_events, "tick_events": len(trace.events),
            "k1_launches": n_lin, "k4_launches": len(k4),
            "combines": launched["paged_attention_combine"], "pool_bytes": got,
            "live_entries": live, "capacity_bytes": capacity, "counter": counter,
            "plan": plan, "cfg": cfg}


def phase_t3(dev, cfg, plan) -> dict:
    """The draft-payload proof on phase o's speculative scheduler, both modes,
    then a poisoned copy of every skipped stream: the draft step's logits
    bit for bit the same."""
    import torch
    from repro_torch.analysis import dataflow, suite
    from repro_torch.engine import draft_plan_bytes
    from repro_torch.kernels import strum_matmul as K
    out = {}
    for mode in DRAFT:
        sched = _t_paged(cfg, plan, dev, speculative=SPEC_K, draft=mode)
        before = K.launch_counts[mode]
        trace = dataflow.trace_dataflow(
            sched._draft_decode, *suite.decode_lane_args(sched, sched._draft_params))
        torch.cuda.synchronize()
        n = K.launch_counts[mode] - before
        _check(n == 7 * cfg.n_layers and {e.name for e in trace.kernel_calls()} -
               {"cache:attn_fused"} == {DRAFT[mode][0]},
               f"draft step launched {n} {mode}, calls "
               f"{ {e.name for e in trace.kernel_calls()} }")
        rep = suite.verify_draft_payload(sched, location=f"olmo_1b/draft[{mode}]",
                                         trace=trace)
        _check(rep.ok, rep.render())
        poison = suite.draft_poison_check(sched)
        _check(poison["bit_equal"] and poison["leaves"] == 7,
               f"{mode}: poisoned skipped streams changed the draft logits {poison}")
        decl = draft_plan_bytes(sched.draft_plan)
        print(f"  {mode}: {n} launches of {DRAFT[mode][0]} in one draft step; payload "
              f"read {decl['draft_bytes']} of {decl['full_bytes']} B "
              f"(x{decl['ratio']:.4f}); draft leaves share the target's tensors; "
              f"{poison['poisoned_bytes']} skipped bytes of {poison['leaves']} leaves "
              f"set to 0xFF: logits bit-identical ({poison['max_abs_diff']})", flush=True)
        out[mode] = {"launches": n, **decl, **poison}
        del sched
        torch.cuda.empty_cache()
    return out


def phase_t4(dev) -> dict:
    """The recompile lint at full width, 2 layers: chunked, serial and
    speculative schedulers over the reference's mixed-length workload."""
    import torch
    from repro_torch.analysis import recompile, suite
    cfg, params, _ = _t_olmo(dev, T_LAYERS)
    out, flagged = {}, []
    for label, kw in (("scheduler", {}), ("serial-scheduler", {"prefill": "serial"}),
                      ("spec-scheduler", {"speculative": 2})):
        sched = suite.build_tiny_scheduler(cfg, params, device=dev, **kw)
        rep = recompile.lint_scheduler_recompiles(sched=sched, location=label)
        counts = recompile.lane_trace_counts(sched)
        calls = {k: len(v) for k, v in sched._lane_signatures.items() if v}
        flagged += [f.location for f in rep.findings]
        print(f"  {label}: shape signatures per lane {counts} over calls {calls}",
              flush=True)
        for f in rep.findings:
            print(f"    {f.render()}", flush=True)
        out[label] = {"signatures": counts, "calls": calls}
        del sched
    _check(sorted(flagged) == sorted(T_RETRACING),
           f"lanes flagged {flagged}, want exactly {T_RETRACING}")
    del params
    torch.cuda.empty_cache()
    return out


def phase_t5(dev) -> dict:
    """``build_plan(..., validate=True)`` for full-width OLMo-1B and phase l's
    Moonshot-16B-A3B (4 of 48 layers); the time ``validate_plan`` takes."""
    import torch
    from repro_torch import engine
    from repro_torch.analysis import validate_plan
    from repro_torch.configs.base import get_config
    from repro_torch.core.policy import StruMConfig
    from repro_torch.models import model_defs
    from repro_torch.models.params import init_params
    out = {}
    for arch, layers in (("olmo_1b", None), (MOE_ARCH, MOE_LAYERS)):
        cfg = get_config(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        params = init_params(model_defs(cfg), seed=0, device=dev, dtype_override="float32")
        plan = engine.build_plan(params, cfg=StruMConfig(method="mip2q", p=0.5, L=5),
                                 float_only=True, device=dev, validate=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = validate_plan(plan, params=params, device=dev)
        ms = (time.perf_counter() - t0) * 1e3
        _check(not rep.findings, rep.render())
        print(f"  {arch} ({cfg.n_layers} layers): {len(plan.entries)} entries "
              f"{plan.summary()['variant_distribution']}, validate=True passed; "
              f"validate_plan {ms:.2f} ms, {len(rep.findings)} findings", flush=True)
        out[arch] = {"entries": len(plan.entries), "validate_ms": ms,
                     "findings": len(rep.findings)}
        del params, plan
        torch.cuda.empty_cache()
    return out


def measure_analysis(dev) -> dict:
    """Phase t: static analysis on the card, each sub-phase fatal."""
    import torch
    out = {}
    t0 = time.perf_counter()
    print(f"-- t1. registry audit and the launch-contract lint on the card "
          f"(t = {t0 - _T0:.1f} s)", flush=True)
    out["t1"] = phase_t1(dev)
    out["t1"]["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    print(f"-- t2. dataflow, full-width OLMo-1B: a dense decode step, a paged tick "
          f"(t = {t0 - _T0:.1f} s)", flush=True)
    t2 = phase_t2(dev)
    cfg, plan = t2.pop("cfg"), t2.pop("plan")
    out["t2"] = t2
    out["t2"]["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    print(f"-- t3. the draft-payload proof and the poisoned skipped streams "
          f"(t = {t0 - _T0:.1f} s)", flush=True)
    out["t3"] = phase_t3(dev, cfg, plan)
    out["t3"]["seconds"] = time.perf_counter() - t0
    del cfg, plan
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    print(f"-- t4. the recompile lint, full width, {T_LAYERS} layers "
          f"(t = {t0 - _T0:.1f} s)", flush=True)
    out["t4"] = phase_t4(dev)
    out["t4"]["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    print(f"-- t5. build_plan(validate=True) (t = {t0 - _T0:.1f} s)", flush=True)
    out["t5"] = phase_t5(dev)
    out["t5"]["seconds"] = time.perf_counter() - t0
    return out


def _analysis_report(t, smi) -> None:
    """Phase t's summary line."""
    print(f"analysis (phase t): lint launches {t['t1']['launches']}, C++ refusals "
          f"{len(t['t1']['refusals'])} all cudaErrorInvalidValue; dense step "
          f"{t['t2']['k1_launches']} K1, paged tick {t['t2']['k4_launches']} K4 reading "
          f"{t['t2']['pool_bytes']} pool bytes; draft ratios "
          f"{ {m: round(v['ratio'], 4) for m, v in t['t3'].items() if isinstance(v, dict)} }; "
          f"validate_plan ms { {a: round(v['validate_ms'], 2) for a, v in t['t5'].items() if isinstance(v, dict)} }; "
          f"sub-phase seconds { {k: round(v['seconds'], 1) for k, v in t.items()} }; {smi}",
          flush=True)


# ----------------------------------------------- static numerics (u) --

U_TOKENS = (2, 64)              # u1's and u3's teacher-forced batch
U_KV = dict(method="mip2q", p=0.5, q=4, L=7)   # u3's KV pages (phase h's)


def _u_model(dev):
    """Full-width OLMo-1B, all 16 layers, f32 activations, f32 parameters
    from seed 0 and the default plan (mip2q p=0.5 L=5, K1 on the card); the
    forward ``fn(params, tokens)`` and u1's tokens."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.core.policy import StruMConfig
    from repro_torch.launch.steps import build_serving_plan
    from repro_torch.models import model_defs
    from repro_torch.models.params import init_params
    from repro_torch.models.transformer import forward_train
    scfg = StruMConfig(method="mip2q", p=0.5, L=5)
    cfg = dataclasses.replace(get_config("olmo_1b"), dtype="float32", strum=scfg)
    _check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.d_ff, cfg.vocab_size) ==
           (16, 2048, 16, 8192, 50304), f"not full-width OLMo-1B: {cfg}")
    params = init_params(model_defs(cfg), seed=0, device=dev, dtype_override="float32")
    plan = build_serving_plan(params, cfg=scfg, device=dev)
    gen = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, U_TOKENS, generator=gen).to(dev)

    def fn(p, t):
        return forward_train(p, {"tokens": t}, cfg)[0]
    return cfg, params, plan, fn, toks


def phase_u1(dev, cfg, params, plan, fn, toks) -> dict:
    """The numerics pass over a full-width packed forward: every K1 call
    interpreted through the hooks on the card; the bound finite and at
    least the teacher-forced measured error, float vs packed on the card."""
    import torch
    from repro_torch.analysis import numerics
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    stats = numerics.leaf_stats_from_plan(plan, params)
    torch.cuda.synchronize(dev)
    t_stats = time.perf_counter() - t0
    _reset_kv_counts()
    t0 = time.perf_counter()
    res, rep = numerics.analyze(fn, plan.params, toks, stats=stats,
                                location="olmo_1b/numerics[u1]")
    torch.cuda.synchronize(dev)
    t_analyze = time.perf_counter() - t0
    launched = _kv_counts()
    k1 = res.counts.get("kernel:cuda:onehot", 0)
    want = 7 * cfg.n_layers
    _check(k1 == want and launched["onehot"] == want and
           sum(launched.values()) == want,
           f"K1 calls interpreted {k1}, launched {launched}; want {want} K1 and nothing "
           "else")
    _check(not res.unsupported and not rep.errors(),
           f"unsupported {res.unsupported}; {rep.render(min_severity='info')}")
    lo, hi = res.interval
    _check(math.isfinite(lo) and math.isfinite(hi) and math.isfinite(res.total),
           f"bound not finite: total {res.total}, interval {res.interval}")
    t0 = time.perf_counter()
    measured = numerics.measured_error(fn, (params, toks), (plan.params, toks))
    t_measured = time.perf_counter() - t0
    _check(res.total >= measured, f"UNSOUND: static {res.total} < measured {measured}")
    _check(set(res.per_tag) == set(plan.entries), f"tags {sorted(res.per_tag)}")
    print(f"  K1 calls interpreted {k1} (launched {launched['onehot']}); bound total "
          f"{res.total:.6g} >= measured {measured:.6g}; total_err2 "
          f"{res.total_err2:.6g}; interval [{lo:.6g}, {hi:.6g}]; matches "
          f"{res.counts}; findings {len(rep.findings)} (info); stats {t_stats:.2f} s, "
          f"analyze {t_analyze:.2f} s, measured {t_measured:.2f} s", flush=True)
    return {"total": res.total, "total_err2": res.total_err2, "interval": [lo, hi],
            "measured": measured, "per_tag": res.per_tag,
            "per_tag_err2": res.per_tag_err2, "counts": res.counts,
            "k1_launches": launched["onehot"], "info_findings": len(rep.findings),
            "stats_s": t_stats, "analyze_s": t_analyze, "measured_s": t_measured}


def phase_u2(dev, cfg, params, fn, toks) -> dict:
    """The ``output_error`` proxy: per-leaf gains on the card, a schedule
    searched with it at phase p1's budget beside p1's ``sqnr`` search, then
    that schedule served by the dense-cache loop and, from disk, by the
    paged ``BatchScheduler(schedule=)``; teacher-forced on the loop's
    tokens, every paged argmax that is not the loop's token is a near tie."""
    import torch
    from repro_torch.autotune import (DEFAULT_GRID, Budget, config_key,
                                      output_error_profile, profile_tree, search_schedule)
    from repro_torch.launch import serve as S
    from repro_torch.launch.steps import build_serving_plan
    from repro_torch.serving import BatchScheduler, Request
    t0 = time.perf_counter()
    prof = profile_tree(params, DEFAULT_GRID)
    t_profile = time.perf_counter() - t0
    t0 = time.perf_counter()
    oprof = output_error_profile(params, fn, toks, profile=prof)
    torch.cuda.synchronize(dev)
    t_gains = time.perf_counter() - t0
    _check(len(oprof) == 7 and all(r["gain"] > 0 for r in oprof.values()),
           f"gains {({n: r['gain'] for n, r in oprof.items()})}")
    budget = Budget(target_ratio=0.875)
    sq = search_schedule(params, budget, profile=prof)
    oe = search_schedule(params, budget, profile=oprof, proxy="output_error")
    _check(oe.meta["feasible"] and oe.summary()["achieved_ratio"] <= 0.875,
           f"output_error schedule misses its budget: {oe.summary()}")
    tables = {"sqnr": {n: config_key(c) for n, c in sorted(sq.assignments.items())},
              "output_error": {n: config_key(c) for n, c in sorted(oe.assignments.items())}}
    differ = sorted(n for n in tables["sqnr"]
                    if tables["sqnr"][n] != tables["output_error"].get(n))
    print(f"  profile {t_profile:.2f} s, gains {t_gains:.2f} s: "
          f"{ {n: round(r['gain'], 6) for n, r in oprof.items()} }", flush=True)
    for proxy, table in tables.items():
        print(f"  {proxy} schedule (x{(sq if proxy == 'sqnr' else oe).summary()['achieved_ratio']:.4f}"
              f" of int8): {table}", flush=True)
    print(f"  the proxies differ on {differ}", flush=True)
    path = oe.save(str(SCHED_DIR / "olmo_1b_output_error.json"))
    plan = build_serving_plan(params, schedule=oe, device=dev)
    _check_schedule_plan(plan, oe)
    gen_n, batch, plen = 16, 4, 32
    g = torch.Generator().manual_seed(0)
    prompt = torch.randint(0, cfg.vocab_size, (batch, plen), generator=g)
    _reset_kv_counts()
    toks_d, _, t_dec, lg_d = S.serve(cfg, plan.params, prompt, gen_n, device=dev,
                                     return_logits=True)
    loop_launched = _kv_counts()
    _reset_kv_counts()
    paged = S.serve_paged(cfg, plan.params, prompt, gen_n, plan=plan, page_size=PAGE,
                          device=dev)
    paged_launched = _kv_counts()
    del plan
    outs = torch.tensor([r.output for r in paged["requests"]], device=toks_d.device)
    same_free = (outs == toks_d).float().mean().item()
    s2 = BatchScheduler(cfg, params, n_slots=batch, max_len=plen + gen_n + 1 + PAGE,
                        schedule=path, page_size=PAGE, device=dev)
    rec = _recorded(s2, cfg.vocab_size)
    for i in range(batch):
        s2.submit(Request(uid=i, prompt=prompt[i], max_new_tokens=gen_n + 1,
                          force_tokens=toks_d[i].tolist()))
    with torch.inference_mode():
        s2.run_to_completion()
    lg_p = torch.stack([torch.stack(rec[i]) for i in range(batch)]).float()
    ref = lg_d[..., :cfg.vocab_size].float()
    _check(bool(torch.isfinite(lg_p).all()) and lg_p.shape == ref.shape,
           f"paged logits of shape {tuple(lg_p.shape)}, want {tuple(ref.shape)}")
    gaps = _near_ties(ref, lg_p, toks_d, "paged schedule= lane")
    err = (lg_p - ref).abs().max().item()
    same_forced = (lg_p.argmax(-1) == toks_d).float().mean().item()
    dec = sorted(ms for kind, ms in paged["ticks"] if kind == "decode")
    tick = _spread(dec)
    k123 = {k: paged_launched[k] + loop_launched[k] for k in ("onehot", "maskfree", "dense")}
    print(f"  dense loop vs paged (schedule from {path}, fp pages): free-running tokens "
          f"equal at {same_free:.3f} of positions; teacher-forced argmax = loop tokens at "
          f"{same_forced:.3f}, max|logit diff| {err:.4e}, near ties {gaps}; K1/K2/K3 "
          f"launches loop {({k: loop_launched[k] for k in k123})}, paged "
          f"{({k: paged_launched[k] for k in k123})}; paged decode-only tick median "
          f"{tick['median']:.3f} ms [{tick['min']:.3f}, {tick['max']:.3f}] over "
          f"{len(dec)}; loop decode {t_dec / gen_n * 1e3:.3f} ms/token", flush=True)
    return {"profile_s": t_profile, "gains_s": t_gains,
            "gains": {n: r["gain"] for n, r in oprof.items()}, "tables": tables,
            "differ": differ, "schedule": oe.summary(), "tokens_equal_free": same_free,
            "tokens_equal_forced": same_forced, "max_abs_logit_diff": err,
            "near_ties": gaps, "launches": k123, "loop_launches": loop_launched,
            "paged_launches": paged_launched, "decode_tick_ms": tick,
            "loop_decode_ms_per_token": t_dec / gen_n * 1e3}


def phase_u3(dev, cfg, params, plan, fn, toks) -> dict:
    """``search_draft_schedule(plan, fn=forward)``; one request served
    speculatively with the winner, its tokens the greedy lane's."""
    import torch
    from repro_torch.autotune import search_draft_schedule
    from repro_torch.core.policy import StruMConfig
    from repro_torch.launch import serve as S
    t0 = time.perf_counter()
    search = search_draft_schedule(plan, fn=fn, fn_args=(toks,))
    t_search = time.perf_counter() - t0
    best = search["best"]
    policy, k = best["policy"], best["k"]
    g = torch.Generator().manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (1, 32), generator=g)
    kv = StruMConfig(**U_KV)
    _reset_kv_counts()
    spec = S.serve_paged(cfg, plan.params, prompt, 16, plan=plan, kv_cache=kv,
                         page_size=PAGE, speculative=k, draft=policy, device=dev)
    launched = _kv_counts()
    greedy = S.serve_paged(cfg, plan.params, prompt, 16, plan=plan, kv_cache=kv,
                           page_size=PAGE, device=dev)
    got, want = spec["requests"][0].output, greedy["requests"][0].output
    _check(got == want, f"speculative tokens {got} != greedy {want}")
    acc = spec["spec"]["accepted"] / max(spec["spec"]["drafted"], 1)
    print(f"  search {t_search:.2f} s: best {best['policy'].mode} k={k}, predicted "
          f"alpha {best['alpha_pred']:.4f}, speedup {best['speedup_pred']:.4f} (cost "
          f"ratio {best['cost_ratio']:.4f}); served tokens = greedy tokens ({len(got)}); "
          f"measured acceptance {acc:.4f} ({int(spec['spec']['accepted'])} of "
          f"{int(spec['spec']['drafted'])}); launches {launched} (random weights: the "
          f"predicted and the measured acceptance mean little)", flush=True)
    return {"search_s": t_search, "policy": best["policy"].mode, "k": k,
            "alpha_pred": best["alpha_pred"], "speedup_pred": best["speedup_pred"],
            "cost_ratio": best["cost_ratio"], "acceptance": acc, "spec": spec["spec"],
            "tokens": len(got), "launches": launched}


def phase_u4(dev) -> dict:
    """``verify_numerics`` on the card and the CLI's numerics pass."""
    from repro_torch.analysis import __main__ as cli
    from repro_torch.analysis.suite import verify_numerics
    t0 = time.perf_counter()
    report = verify_numerics(device=dev)
    _check(report.ok and not report.errors(), report.render(min_severity="info"))
    rc = cli.main(["--passes", "numerics", "--device", "cuda"])
    _check(rc == 0, f"python -m repro_torch.analysis --passes numerics exited {rc}")
    print(f"  verify_numerics: {len(report.findings)} findings; CLI --passes numerics "
          f"--device cuda exit {rc} ({time.perf_counter() - t0:.1f} s)", flush=True)
    return {"findings": len(report.findings), "cli_rc": rc}


def measure_numerics(dev) -> dict:
    """Phase u: the numerics interpreter and its consumers on the card, each
    sub-phase fatal."""
    import torch
    out = {}
    t0 = time.perf_counter()
    cfg, params, plan, fn, toks = _u_model(dev)
    print(f"  full-width OLMo-1B f32 and its plan in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for key, what, run in (
            ("u1", "analyze a full-width packed forward",
             lambda: phase_u1(dev, cfg, params, plan, fn, toks)),
            ("u2", "output_error proxy: gains, search, serve (loop and paged)",
             lambda: phase_u2(dev, cfg, params, fn, toks)),
            ("u3", "search_draft_schedule(fn=), speculative vs greedy",
             lambda: phase_u3(dev, cfg, params, plan, fn, toks)),
            ("u4", "verify_numerics and the CLI on the card", lambda: phase_u4(dev))):
        t1 = time.perf_counter()
        print(f"-- {key}. {what} (t = {t1 - _T0:.1f} s)", flush=True)
        out[key] = run()
        out[key]["seconds"] = time.perf_counter() - t1
        torch.cuda.empty_cache()
    return out


def _numerics_report(u, smi) -> None:
    """Phase u's summary line."""
    u1, u2, u3 = u["u1"], u["u2"], u["u3"]
    print(f"numerics (phase u, full-width OLMo-1B f32): bound {u1['total']:.6g} >= "
          f"measured {u1['measured']:.6g}, total_err2 {u1['total_err2']:.6g}, "
          f"{u1['k1_launches']} K1 calls interpreted, {u1['counts']}; output_error "
          f"schedule differs from sqnr's on {len(u2['differ'])} of 7, paged = loop "
          f"teacher-forced at {u2['tokens_equal_forced']:.3f}; draft {u3['policy']} "
          f"k={u3['k']} acceptance {u3['acceptance']:.4f}; sub-phase seconds "
          f"{ {k: round(v['seconds'], 1) for k, v in u.items()} }; {smi}", flush=True)


# ------------------------------------------- launch tools and examples (v) --

V_DIR = ROOT / "build" / "phase_v"     # the twins' schedule JSON and checkpoints
V_TRAIN_STEPS = 30                     # v1's train_e2e steps (M100 at 8 x 256)
V_DECODE = (4, 2048)                   # v2's decode step: slots, cache tokens
V_PREFILL = (4, 32)                    # v2's prefill step: batch, tokens
V_WORKERS = 4                          # processes of v2's dry-run sweep


def _v_olmo(dev):
    """Full-width OLMo-1B and its f32 weights from seed 0."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import model_defs
    from repro_torch.models.params import init_params
    cfg = get_config("olmo_1b")
    _full_width(cfg, "olmo_1b")
    return cfg, init_params(model_defs(cfg), seed=0, device=dev, dtype_override="float32")


def phase_v_quickstart(dev, cfg, params) -> dict:
    """The twin of examples/quickstart.py: its 512 x 256 matrix through K1
    held against the plain version, then OLMo-1B packed by the default plan
    (the 112 linears on K1)."""
    from repro_torch.examples import quickstart
    _reset_kv_counts()
    res = quickstart.run(model_cfg=cfg, params=params, seed=0, device=dev)
    launched = _kv_counts()
    _check(res["kernel_max_err"] <= KERNEL_TOL * res["kernel_max_ref"],
           f"quickstart: K1 off its plain version by {res['kernel_max_err']:.3g} "
           f"(max |plain| {res['kernel_max_ref']:.3g})")
    _check(res["variant_distribution"] == {"cuda:onehot": 7},
           f"quickstart: variants {res['variant_distribution']}")
    _zoo_counts(launched, {"onehot": 1 + 7 * cfg.n_layers}, "quickstart")
    _check(res["weight_bytes"] == 512 * 256 * 7 // 8 and res["achieved_ratio"] == 0.875,
           f"quickstart: payload {res['weight_bytes']} B, x{res['achieved_ratio']}")
    _check(math.isfinite(res["tv"]) and 0 <= res["tv"] <= 1, f"quickstart: TV {res['tv']}")
    print(f"  quickstart: K1 max err {res['kernel_max_err']:.3g} (max |plain| "
          f"{res['kernel_max_ref']:.4g}); OLMo-1B {res['dense_bytes'] / 1e6:.2f} MB dense "
          f"-> {res['served_bytes'] / 1e6:.2f} MB StruM; next-token TV "
          f"{res['tv']:.4f}; launches {launched}", flush=True)
    return {k: res[k] for k in ("kernel_max_err", "kernel_max_ref", "weight_bytes",
                                "dense_bytes", "served_bytes", "tv")} | {
        "launches": launched}


def phase_v_serve_batch(dev, cfg, params) -> dict:
    """The twin of examples/serve_batch.py at full width: 6 requests on 3
    slots, mip2q weights and mip2q KV pages of 16, chunked prefill."""
    from repro_torch.examples import serve_batch
    prompts = serve_batch.prompts_for(6, cfg.vocab_size, seed=0)
    _reset_kv_counts()
    res = serve_batch.run(cfg, params, prompts, slots=3, gen=8, strum="mip2q",
                          kv_cache="mip2q", page_size=16, prefill="chunked", device=dev)
    launched = _kv_counts()
    _check(sorted(res["outputs"]) == list(range(6)) and
           all(len(o) == 8 for o in res["outputs"].values()),
           f"serve_batch: not every request retired with 8 tokens: {res['outputs']}")
    c = res["cache"]
    _check(c["ratio_vs_int8"] == 0.875 and c["attn_variant"] == "cache:attn_fused",
           f"serve_batch: cache {c}")
    _check(launched["onehot"] > 0 and launched["paged_attention"] > 0,
           f"serve_batch: launches {launched}")
    print(f"  serve_batch: 6 requests x 8 tokens in {res['ticks']} ticks, drain "
          f"{res['seconds'] * 1e3:.1f} ms; pages {c['codec']} x{c['ratio_vs_int8']:.3f} "
          f"of int8 ({c['resident_page_bytes']} B); launches {launched}", flush=True)
    return {"ticks": res["ticks"], "drain_ms": res["seconds"] * 1e3, "cache": c,
            "launches": launched}


def phase_v_serve_strum(dev, cfg, params) -> dict:
    """The twin of examples/serve_strum.py at full width: the three fixed
    configs, each one's payload over int8 equal to Eq. 1 / 2 of its p and q
    (exactly against K padded to whole blocks; against the true K within
    that padding), and the flow autotuned at a budget of 0.875."""
    import numpy as np
    from repro_torch.core.packing import compression_ratio, compression_ratio_sparsity
    from repro_torch.examples import serve_strum
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 32))
    _reset_kv_counts()
    res = serve_strum.run(cfg, params, prompt, gen=12, target_ratio=0.875,
                          schedule_path=str(V_DIR / "strum_schedule_olmo_1b.json"),
                          device=dev)
    launched = _kv_counts()
    out = {"fixed": {}, "launches": launched}
    for method, r in res["fixed"].items():
        eq = compression_ratio_sparsity(r["p"]) if method == "sparsity" else \
            compression_ratio(r["p"], r["q"])
        got, padded = r["payload_bytes"] / r["int8_bytes"], \
            r["payload_bytes"] / r["padded_int8_bytes"]
        pad = r["padded_int8_bytes"] / r["int8_bytes"] - 1
        _check(padded == eq and abs(got - eq) <= eq * pad,
               f"serve_strum {method}: payload x{got} of int8 (x{padded} padded), "
               f"Eq. x{eq}")
        out["fixed"][method] = {"ratio": got, "eq": eq, "padding": pad,
                                "agreement": r["agreement"], "variants": r["variants"],
                                "proj_us": r["proj_us_per_token"]}
        print(f"  serve_strum {method} p=0.5: payload x{got:.4f} of int8 (Eq. x{eq:.4f}, "
              f"padding {pad:.3g}); variants {r['variants']}; token agreement "
              f"{r['agreement']:.2%}; proj H100 weight-stream "
              f"{r['proj_us_per_token']:.1f} us/tok", flush=True)
    a = res["autotune"]
    _check(a["achieved_ratio"] <= 0.875 + 1e-9,
           f"serve_strum: the searched schedule misses its budget: {a['achieved_ratio']}")
    out["autotune"] = {k: a[k] for k in ("achieved_ratio", "weighted_sqnr_db",
                                         "config_distribution", "variants", "agreement",
                                         "n_packed", "packed_ratio")}
    print(f"  serve_strum autotune r<=0.875: achieved x{a['achieved_ratio']:.4f}, "
          f"{a['config_distribution']}, variants {a['variants']}, token agreement "
          f"{a['agreement']:.2%}; launches {launched}", flush=True)
    return out


def phase_v_train(dev) -> dict:
    """The twin of examples/train_e2e.py: M100 at 8 x 256 for V_TRAIN_STEPS
    steps on the card, then the PTQ eval of the three methods."""
    import statistics as st
    from repro_torch.examples import train_e2e
    cfg = train_e2e.M100
    res = train_e2e.run(cfg, steps=V_TRAIN_STEPS, batch=8, seq=256,
                        workdir=str(V_DIR / "e2e"), device=dev,
                        log_fn=lambda line: print(f"    {line}", flush=True))
    first, last = st.mean(res["losses"][:10]), st.mean(res["losses"][-10:])
    _check(last < first, f"train_e2e: loss {first:.4f} over the first 10 steps, "
                         f"{last:.4f} over the last 10")
    _check(all(math.isfinite(v) for v in res["eval"].values()),
           f"train_e2e: eval CE {res['eval']}")
    ms = res["ms_per_step"][1:]     # the first step pays the first calls' set-up
    print(f"  train_e2e {cfg.name} ({res['param_count'] / 1e6:.1f}M params, 8 x 256): "
          f"loss {first:.4f} -> {last:.4f} (mean of the first / last 10 of "
          f"{V_TRAIN_STEPS}); {st.median(ms):.2f} ms a step (median, [{min(ms):.2f}, "
          f"{max(ms):.2f}], first {res['ms_per_step'][0]:.1f}); eval CE "
          f"{ {k: round(v, 4) for k, v in res['eval'].items()} }", flush=True)
    return {"loss_first10": first, "loss_last10": last, "eval": res["eval"],
            "ms_per_step": _spread(ms), "first_step_ms": res["ms_per_step"][0]}


def _v2_step(dev, cfg, plan, kind, b, s):
    """The dry-run's count of one step on ``meta`` beside the same step on
    the card: per-kernel calls and argument bytes exactly, memory and time
    reported."""
    import torch
    from torch.utils._pytree import tree_flatten

    from repro_torch.analysis.pallas_lint import VARIANT_KERNELS
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun, specs
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import cache_defs
    from repro_torch.models.params import init_params
    shape = ShapeSpec(f"v2_{kind}", s, b, kind)
    rec = dryrun.count_step(cfg, shape, specs.input_specs(cfg, shape,
                                                          param_dtype="float32"))
    if kind == "decode":
        caches = init_params(cache_defs(cfg, b, specs.padded_cache_len(s)), device=dev)
        real = (plan.params, torch.zeros((b, 1), dtype=torch.long, device=dev), caches, s)
        step = make_decode_step(cfg)
    else:
        real = (plan.params, {"tokens": torch.zeros((b, s), dtype=torch.long, device=dev)})
        step = make_prefill_step(cfg)
    args = sum(t.numel() * t.element_size() for t in tree_flatten(real)[0]
               if isinstance(t, torch.Tensor))
    _check(args == rec["memory"]["argument_bytes"],
           f"v2 {kind}: the card's arguments hold {args} B, the dry-run's "
           f"{rec['memory']['argument_bytes']} B")
    with torch.inference_mode():
        step(*real)                      # first calls' set-up
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        _reset_kv_counts()
        t0 = time.perf_counter()
        out = step(*real)
        torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated(dev) - base
        del out
    launched = {k: v for k, v in _kv_counts().items() if v}
    want = {VARIANT_KERNELS[k]: v for k, v in rec["kernels"].items()}
    _check(launched == want, f"v2 {kind}: the card launched {launched}, the dry-run "
                             f"counted {want}")
    roof = dryrun.roofline_terms(dryrun.compute_s(rec["flops_by_dtype"]), rec["bytes"],
                                 0)
    bound_ms = max(roof["compute_s"], roof["memory_s"]) * 1e3
    print(f"  v2 {kind} {b} x {s}: kernel calls {rec['kernels']} = launches {launched}; "
          f"arguments {args} B on both; dry-run temp {rec['memory']['temp_bytes']} B "
          f"beside the card's peak above its prior allocations {peak} B; roofline "
          f"{bound_ms:.3f} ms ({roof['bottleneck']}; compute {roof['compute_s'] * 1e3:.3f}, "
          f"memory {roof['memory_s'] * 1e3:.3f}) beside {ms:.3f} ms measured; count "
          f"{rec['seconds']:.2f} s on meta", flush=True)
    return {"kernels": rec["kernels"], "launches": launched, "argument_bytes": args,
            "temp_bytes": rec["memory"]["temp_bytes"], "peak_above_prior": peak,
            "flops": rec["flops"], "bytes": rec["bytes"], "roofline": roof,
            "bound_ms": bound_ms, "ms": ms, "count_s": rec["seconds"]}


#: the dry-run sweep's meshes: one H100 (v2), and rank 0 of the two
#: production meshes on the stand-in (v3)
V_MESHES = ("1x1", "16x16", "2x16x16")


def _sweep_cells():
    from repro_torch.configs.base import ARCH_IDS, SHAPES
    return [(a, s, m) for m in V_MESHES for a in ARCH_IDS for s in SHAPES]


def _sweep_status(futures, t0, mesh: str) -> dict:
    """Every cell's status on ``mesh``, once all of them are done; a cell
    that raised is ``FAIL`` with its error."""
    status = {}
    for (arch, shape, m), fut in futures.items():
        if m != mesh:
            continue
        err = fut.exception()
        status[f"{arch}/{shape}"] = (fut.result()["status"] if err is None else
                                     f"FAIL: {type(err).__name__}: {err}")
    counts = {k: sum(v.startswith(k) for v in status.values())
              for k in ("OK", "SKIP", "FAIL")}
    fails = {c: v for c, v in status.items() if v.startswith("FAIL")}
    seconds = time.perf_counter() - t0
    print(f"  {'v2' if mesh == '1x1' else 'v3'} dry-run sweep on {mesh}: {len(status)} "
          f"cells, {counts}, all done {seconds:.1f} s after the sweep started "
          f"({V_WORKERS} processes, beside v1)"
          + (f"; failed: {fails}" if fails else ""), flush=True)
    _check(not fails, f"dry-run cells on {mesh} failed: {fails}")
    return {"counts": counts, "seconds": seconds}


def _abstract_hold(cfg, record: dict, what: str, whose: str) -> dict:
    """The dry-run's count of ``cfg``'s decode step on the abstract 2x2 mesh
    (``meta``, rank 0, the card's kernel choices) held to ``record``, a
    live rank 0's record of the same step (``_s2_decode_record``): every
    collective (primitive, kind, result shape and dtype, width, bytes, in
    order) and the kernel calls and launches, exactly.  Returns the count."""
    from repro_torch.analysis.pallas_lint import VARIANT_KERNELS
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun, specs
    from repro_torch.launch.mesh import AbstractMesh
    shape = ShapeSpec(f"{what}_decode", record["cache_len"], record["batch"], "decode")
    rec = dryrun.count_step(cfg, shape, specs.input_specs(cfg, shape,
                                                          param_dtype="float32"),
                            mesh=AbstractMesh((2, 2), ("data", "model")))
    got, live = rec["collective_records"], record["collectives"]
    first = next((i for i, (a, b) in enumerate(zip(got, live)) if a != b),
                 None if len(got) == len(live) else min(len(got), len(live)))
    _check(first is None, f"{what}: the abstract count's collective {first} "
                          f"{got[first] if first is not None and first < len(got) else None}"
                          f" vs {whose} {live[first] if first is not None and first < len(live) else None}"
                          f" ({len(got)} vs {len(live)} collectives)")
    launches = {VARIANT_KERNELS[k]: v for k, v in rec["kernels"].items()}
    _check(rec["kernels"] == record["kernels"] and launches == record["launches"],
           f"{what}: the abstract count's kernel calls {rec['kernels']} (launches "
           f"{launches}) vs {whose} {record['kernels']} (launches {record['launches']})")
    return rec


def _v3_hold(record: dict) -> dict:
    """v3: the dry-run's count of s2's OLMo decode step on the abstract 2x2
    mesh (``meta``, rank 0, the card's kernel choices) beside what s2's
    rank 0 records on cuda:0: every collective (primitive, kind, result
    shape and dtype, width, bytes, in order) and the kernel calls and
    launches, exactly."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.policy import StruMConfig
    from repro_torch.launch.dryrun import lower_cell
    cfg = dataclasses.replace(get_config("olmo_1b"), n_layers=record["layers"],
                              strum=StruMConfig(), dtype="float32")
    rec = _abstract_hold(cfg, record, "v3", "s2's")
    got = rec["collective_records"]
    coll = rec["collectives"]
    packed = {m: lower_cell("olmo_1b", "decode_32k", {"strum": StruMConfig()}, "mip2q",
                            mesh=m) for m in V_MESHES}
    for m, r in packed.items():
        print(f"  v3 full-width OLMo-1B decode_32k, mip2q p=0.5 weights, rank 0 of {m}: "
              f"{r['flops_per_dev']:.6g} FLOPs, {r['bytes_per_dev']:.6g} bytes, "
              f"{r['link_bytes_per_dev']} link bytes a device, kernels {r['kernels']}, "
              f"roofline {r['roofline']}", flush=True)
    dense = lower_cell("olmo_1b", "decode_32k", mesh="16x16")
    one = lower_cell("olmo_1b", "decode_32k")
    print(f"  v3 full-width OLMo-1B decode_32k, dense, rank 0 of 16x16 ({dense['layout']}): "
          f"argument bytes {dense['memory']['argument_bytes']} (one H100: "
          f"{one['memory']['argument_bytes']}), {dense['flops_per_dev']:.6g} FLOPs "
          f"(one H100: {one['flops_per_dev']:.6g}), {dense['bytes_per_dev']:.6g} bytes, "
          f"{dense['link_bytes_per_dev']} link bytes a device "
          f"({dense['collectives']['per_kind_count']}), roofline {dense['roofline']}",
          flush=True)
    _check(dense["layout"] == "input_shardings" and dense["link_bytes_per_dev"] > 0 and
           dense["memory"]["argument_bytes"] * 200 < one["memory"]["argument_bytes"],
           f"v3: the dense decode_32k on 16x16 is not counted in the sharded layout: "
           f"{dense['layout']}, {dense['memory']}")
    packed["dense_16x16"] = dense
    print(f"  v3 s2's OLMo-1B decode ({record['layers']} layers, {record['batch']} "
          f"slots, the sharded serving layout) on the abstract 2x2 mesh: {len(got)} "
          f"collectives equal to s2's rank 0 on "
          f"cuda:0 one by one ({coll['per_kind_count']}, bytes "
          f"{coll['per_kind_bytes']}, link "
          f"{coll['link_bytes']} B); kernel calls {rec['kernels']} = launches "
          f"{record['launches']}; count {rec['seconds']:.2f} s on meta", flush=True)
    return {"collectives": coll, "kernels": rec["kernels"], "launches": record["launches"],
            "n_collectives": len(got), "count_s": rec["seconds"], "packed_decode": packed}


def measure_examples(dev, s2_record=None) -> dict:
    """Phase v, each sub-phase fatal: the example twins at full width (v1),
    then the dry-run held against the card and the whole dry-run sweep
    (v2), then the dry-run on the abstract 2x2 mesh held against s2's live
    ranks (``s2_record``; without it, as ``--only v`` runs, s2's decode
    step runs alone on 4 gloo ranks first) and the sweeps of the two
    production meshes (v3).  The sweeps run in worker processes from the
    start of the phase."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import torch
    from repro_torch.core.policy import StruMConfig
    from repro_torch.engine import build_plan
    from repro_torch.launch.dryrun import lower_cell
    V_DIR.mkdir(parents=True, exist_ok=True)
    out = {}
    with ProcessPoolExecutor(V_WORKERS, mp_context=multiprocessing.get_context("spawn")
                             ) as pool:
        t_sweep = time.perf_counter()
        futures = {(a, sh, m): pool.submit(lower_cell, a, sh, mesh=m)
                   for a, sh, m in _sweep_cells()}
        cfg, params = _v_olmo(dev)
        for key, what, run in (
                ("quickstart", "the 512 x 256 matrix through K1, OLMo-1B packed",
                 lambda: phase_v_quickstart(dev, cfg, params)),
                ("serve_batch", "OLMo-1B, 6 requests, 3 slots, mip2q weights and pages",
                 lambda: phase_v_serve_batch(dev, cfg, params)),
                ("serve_strum", "OLMo-1B, three fixed configs, autotuned at 0.875",
                 lambda: phase_v_serve_strum(dev, cfg, params)),
                ("train_e2e", f"M100 at 8 x 256, {V_TRAIN_STEPS} steps, PTQ eval",
                 lambda: phase_v_train(dev))):
            t0 = time.perf_counter()
            print(f"-- v1 {key}: {what} (t = {t0 - _T0:.1f} s)", flush=True)
            out[key] = run()
            out[key]["seconds"] = time.perf_counter() - t0
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        print(f"-- v2 the dry-run held against the card, full-width OLMo-1B, default "
              f"plan (t = {t0 - _T0:.1f} s)", flush=True)
        scfg = StruMConfig(method="mip2q", p=0.5, L=5)
        pcfg = dataclasses.replace(cfg, strum=scfg)
        plan = build_plan(params, cfg=scfg, device=dev)
        del params
        out["v2"] = {kind: _v2_step(dev, pcfg, plan, kind, *bs)
                     for kind, bs in (("decode", V_DECODE), ("prefill", V_PREFILL))}
        del plan
        torch.cuda.empty_cache()
        out["v2"]["sweep"] = _sweep_status(futures, t_sweep, "1x1")
        out["v2"]["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        print(f"-- v3 the dry-run on the abstract 2x2 mesh held against s2's gloo "
              f"ranks, then the 16x16 and 2x16x16 sweeps (t = {t0 - _T0:.1f} s)",
              flush=True)
        if s2_record is None:
            s2_record = _spawn_ranks("s2_decode", 4)[0]
        out["v3"] = _v3_hold(s2_record)
        out["v3"]["sweep"] = {m: _sweep_status(futures, t_sweep, m) for m in V_MESHES[1:]}
        out["v3"]["seconds"] = time.perf_counter() - t0
        (V_DIR / "dryrun_sweep.json").write_text(json.dumps(
            [f.result() for f in futures.values()], indent=1))
    return out


def _examples_report(v, smi) -> None:
    """Phase v's summary line."""
    d, p = v["v2"]["decode"], v["v2"]["prefill"]
    print(f"examples (phase v, full width): quickstart TV {v['quickstart']['tv']:.4f}; "
          f"serve_batch {v['serve_batch']['ticks']} ticks, drain "
          f"{v['serve_batch']['drain_ms']:.1f} ms; serve_strum agreement "
          f"{ {k: round(r['agreement'], 4) for k, r in v['serve_strum']['fixed'].items()} }"
          f", autotuned {v['serve_strum']['autotune']['agreement']:.4f}; train_e2e "
          f"{v['train_e2e']['ms_per_step']['median']:.2f} ms a step; dry-run decode "
          f"{d['bound_ms']:.3f} ms bound vs {d['ms']:.3f} ms, prefill {p['bound_ms']:.3f} "
          f"vs {p['ms']:.3f} ms; sweep {v['v2']['sweep']['counts']} in "
          f"{v['v2']['sweep']['seconds']:.1f} s; v3 abstract 2x2 = s2 over "
          f"{v['v3']['n_collectives']} collectives, link {v['v3']['collectives']['link_bytes']}"
          f" B, K1 {v['v3']['launches']}; sweeps "
          f"{ {m: (r['counts'], round(r['seconds'], 1)) for m, r in v['v3']['sweep'].items()} }"
          f"; sub-phase seconds "
          f"{ {k: round(r['seconds'], 1) for k, r in v.items()} }; {smi}", flush=True)


def measure(dev, clocks):
    """Phases c-v; returns the kernels' records and the serve (train, mesh,
    analysis, numerics, examples) times."""
    import torch
    _phase("c. kernels vs plain versions at OLMo-1B shapes")
    gen = torch.Generator(device=dev).manual_seed(0)
    timings = phase_c(dev, gen, clocks)

    counts: dict = {}
    _phase("d. serve full-width OLMo-1B (mip2q p=0.5 L=5, batch 4, prompt 32, gen 16)")
    res = _serve(["--arch", "olmo_1b", "--seed", "0"], "onehot", counts)
    refs = {"d_tokens": res["tokens"].cpu(), "d_k1": counts["onehot"]}
    cfg = res["cfg"]
    _check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.d_ff, cfg.vocab_size) ==
           (16, 2048, 16, 8192, 50304), f"not full-width OLMo-1B: {cfg}")
    plan = res["plan"]
    payload = plan.summary()["packed_payload_bytes"]
    int8 = sum(k * n * (e.shape[0] if len(e.shape) > 2 else 1)
               for e in plan.entries.values() for k, n in [e.shape[-2:]])
    print(f"  packed linears {payload / 1e9:.4f} GB vs int8 {int8 / 1e9:.4f} GB "
          f"(x{payload / int8:.4f}); served tree {res['packed_bytes'] / 1e9:.3f} GB "
          f"vs dense f32 {res['dense_bytes'] / 1e9:.3f} GB", flush=True)
    times = serve_times(res, clocks)

    _phase("e. p=1 and p=0 plans (2 layers, full width)")
    _serve(["--arch", "olmo_1b", "--strum", "dliq", "--p", "1.0", "--layers", "2",
            "--gen", "4"], "maskfree", counts)
    _serve(["--arch", "olmo_1b", "--p", "0", "--layers", "2", "--gen", "4"],
           "dense", counts)

    _phase("f. phase d logits vs the torch family, teacher-forced")
    phase_f(res)
    del res
    torch.cuda.empty_cache()

    _phase("g. packed-KV kernels K4, K5, K11 vs plain versions at OLMo-1B and "
           "Qwen2-7B attention shapes")
    kv_rows = phase_g(dev, gen, clocks)

    _phase("h. paged serve, full-width OLMo-1B, mip2q KV pages (batch 4, prompt 128, "
           "gen 32)")
    paged, res = phase_h(counts)
    times["paged"] = paged
    lane = paged["lane_runs"]["decode"] + paged["lane_runs"]["prefill_chunk"]
    refs.update(h_tokens=[r.output for r in res["requests"]], h_k1_per_lane_run=7 * 16,
                h_k4_per_lane_run=counts["paged_attention"] / lane)

    _phase("i. dliq p=1 KV pages (2 layers, full width)")
    phase_i(dev, counts)

    _phase("j. phase h's sealed pages through K11; paged logits vs the torch family")
    times["paged"]["logits"] = phase_j(dev, res, counts)
    plain = {"tokens": [r.output for r in res["requests"]], "prompt": res["prompt"],
             "logits": times["paged"]["logits"].pop("cuda_logits")}
    del res
    torch.cuda.empty_cache()

    _phase("k. grouped MoE kernels K6, K7, K8 vs plain versions at Moonshot-16B-A3B "
           "and Qwen3-MoE expert shapes")
    moe_rows = phase_k(dev, gen, clocks)

    _phase(f"l. serve full-width Moonshot-16B-A3B ({MOE_LAYERS} of 48 layers): paged "
           "runtime (mip2q KV pages, batch 4, prompt 128, gen 32), dense-cache loop")
    times["moe"] = phase_l(dev, counts)
    torch.cuda.empty_cache()

    _phase("m. p=1 and p=0 MoE plans (Moonshot-16B-A3B, 2 layers, full width)")
    _serve_moe(["--arch", MOE_ARCH, "--strum", "dliq", "--p", "1.0", "--layers", "2",
                "--gen", "4"], "maskfree", "grouped_maskfree", counts)
    _serve_moe(["--arch", MOE_ARCH, "--p", "0", "--layers", "2", "--gen", "4"],
               "dense", "grouped_dense", counts)
    torch.cuda.empty_cache()

    _phase("n. draft kernels K9, K10 vs plain versions at OLMo-1B shapes")
    draft_rows = phase_n(dev, gen, clocks)

    _phase(f"o. speculative paged serve, full-width OLMo-1B (k={SPEC_K}, histream and "
           "maskfree_p, mip2q KV pages, batch 4, prompt 128, gen 32)")
    times["speculative"] = phase_o(dev, plain, counts)
    del plain
    torch.cuda.empty_cache()

    _phase("p. schedule-driven serving: a schedule searched on the card (OLMo-1B), "
           "mixed plans (OLMo-1B, Moonshot-16B-A3B)")
    sub = {}
    for key, what, fn in (
            ("p1", "search full-width OLMo-1B on the card, save, load, serve paged",
             lambda: phase_p1(dev, times["paged"])),
            ("p2", f"mixed schedule K1 / K2 / K3 / dense, OLMo-1B {P_LAYERS} layers, "
                   "plain and speculative", lambda: phase_p2(dev)),
            ("p3", f"K6 / K7 / K8 in one Moonshot MoE layer, {P_LAYERS} of 48 layers",
             lambda: phase_p3(dev))):
        t0 = time.perf_counter()
        print(f"-- {key}. {what} (t = {t0 - _T0:.1f} s)", flush=True)
        sub[key] = fn()
        sub[key]["seconds"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    times["schedule"] = sub

    _phase("q. the model zoo: Mamba-2 780M (48 layers), the Jamba hybrid (SMOKE "
           "shape), DeepSeek-67B, StableLM-2-12B, InternVL2-26B, MusicGen-medium "
           f"({ZOO_LAYERS} layers)")
    times["zoo"] = zoo = measure_zoo(dev, clocks)
    zoo_launches = {
        "onehot": {"mamba2_dense_loop": zoo["q1"]["dense_launches"],
                   "mamba2_paged": zoo["q1"]["paged_launches"],
                   "jamba_smoke_paged": zoo["q2"]["launches"]["onehot"],
                   **{a: zoo["q3"][a]["launches"]["onehot"] for a in DENSE_ZOO}},
        "paged_attention": {"jamba_smoke_paged": zoo["q2"]["launches"]["paged_attention"],
                            **{a: zoo["q3"][a]["launches"]["paged_attention"]
                               for a in DENSE_ZOO}},
        "grouped_onehot": {"jamba_smoke_paged": zoo["q2"]["launches"]["grouped_onehot"]}}

    _phase("r. the training path: full-width OLMo-1B train steps (plain and "
           "--grad-compression), card vs CPU, resume, train -> PTQ -> packed serving")
    times["train"] = train = measure_train(dev, clocks)
    train_launches = {
        "onehot": {"r4b_packed_loss_fn": train["r4"]["b"]["k1_launches"],
                   "r4c_paged": train["r4"]["c"]["launches"]["onehot"]},
        "paged_attention": {"r4c_paged": train["r4"]["c"]["launches"]["paged_attention"]}}

    _phase("s. distributed: NCCL world-1 1x1 mesh (full-width OLMo-1B, serve --mesh "
           f"1x1), 4 gloo ranks on a 2x2 mesh (OLMo-1B at {S2_LAYERS} layers in the "
           "sharded serving layout, a Moonshot MoE layer), the ZeRO-3 train step on 2 "
           "gloo ranks, 4 gloo ranks on a 2x2 mesh (Moonshot, Mamba-2 and Jamba in "
           "the sharded serving layout)")
    times["mesh"] = mesh = measure_mesh(dev, refs)
    mesh_launches = {
        "onehot": {"s1_dense_loop": mesh["s1"]["dense_launches"],
                   "s1_paged": mesh["s1"]["paged_launches"],
                   "s2_olmo_per_rank": mesh["s2"]["k1_launches_per_rank"]},
        "paged_attention": {"s1_paged": mesh["s1"]["paged_k4"]},
        "grouped_onehot": {"s2_moe_per_rank": mesh["s2"]["k6_launches_per_rank"]}}
    for arch, _ in S5_CASES:
        for kern, n in mesh["s5"][arch]["launches_per_rank"][0].items():
            if kern in ("onehot", "paged_attention", "grouped_onehot"):
                mesh_launches.setdefault(kern, {})[f"s5_{arch}_rank0"] = n
    for arch, _ in S4_CASES:
        s4 = mesh["s4"][arch]
        for kern, key in (("onehot", "k1_launches_per_rank"),
                          ("grouped_onehot", "k6_launches_per_rank")):
            if any(s4[key]):
                mesh_launches[kern][f"s4_{arch}_per_rank"] = s4[key]

    _phase("t. static analysis: registry audit and launch-contract lint on the card, "
           "dataflow and draft proofs on full-width OLMo-1B, recompile lint, "
           "build_plan(validate=True)")
    times["analysis"] = analysis = measure_analysis(dev)

    _phase("u. static numerics: the interpreter over full-width OLMo-1B (f32), the "
           "output_error proxy searched and served, the draft search, the pass")
    times["numerics"] = numerics = measure_numerics(dev)
    u_launches: dict = {}
    for sub, launched in (("u1_analyze", {"onehot": numerics["u1"]["k1_launches"]}),
                          ("u2_dense_loop", numerics["u2"]["loop_launches"]),
                          ("u2_paged", numerics["u2"]["paged_launches"]),
                          ("u3_speculative", numerics["u3"]["launches"])):
        for name, n in launched.items():
            if n:
                u_launches.setdefault(name, {})[sub] = n

    _phase("v. the launch tools and examples: the example twins at full width "
           "(quickstart, serve_batch, serve_strum on OLMo-1B, train_e2e on M100), the "
           "dry-run held against the card, the dry-run sweep")
    times["examples"] = examples = measure_examples(dev, mesh["s2"]["decode_record"])
    v_launches: dict = {}
    for sub, launched in (("v1_quickstart", examples["quickstart"]["launches"]),
                          ("v1_serve_batch", examples["serve_batch"]["launches"]),
                          ("v1_serve_strum", examples["serve_strum"]["launches"]),
                          ("v2_decode", examples["v2"]["decode"]["launches"]),
                          ("v2_prefill", examples["v2"]["prefill"]["launches"])):
        for name, n in launched.items():
            if n:
                v_launches.setdefault(name, {})[sub] = n

    kernels = []
    for name in ("onehot", "maskfree", "dense"):
        t, mid, pf = timings[name][4], timings[name][16], timings[name][128]
        kernels.append({
            "name": f"cuda:{name}", "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": counts[name],
            "max_abs_err": timings[name]["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "workload": "one OLMo-1B layer's 7 linears at M=4 (decode), bf16 x; "
                        f"median of {ROUNDS} interleaved rounds",
            "range_ms": t["range_ms"], "clock": t["clock"], "graph_ms": t["graph_ms"],
            "library_graph_ms": t["library_graph_ms"],
            "m16_ms": mid["ms"], "m16_graph_ms": mid["graph_ms"],
            "m16_bound_ms": mid["bound_ms"], "m16_library_graph_ms": mid["library_graph_ms"],
            "prefill_ms": pf["ms"], "prefill_graph_ms": pf["graph_ms"],
            "prefill_bound_ms": pf["bound_ms"], "prefill_bound_by": pf["bound_by"],
            "prefill_library_ms": pf["library_ms"],
            "prefill_library_graph_ms": pf["library_graph_ms"],
            "prefill_range_ms": pf["range_ms"],
            "per_shape_graph_ms": timings[name]["per_shape"]})
        if name == "onehot":
            k1 = zoo["q1"]["k1"]
            kernels[-1].update(zoo_launches=zoo_launches["onehot"], mamba2_layer={
                k: k1[k] for k in ("max_abs_err", "graph_ms", "plain_ms",
                                   "library_graph_ms", "bound_ms", "bound_by")})
            r4 = train["r4"]["b"]["k1"]
            kernels[-1]["mesh_launches"] = mesh_launches["onehot"]
            kernels[-1].update(train_launches=train_launches["onehot"], m8192_layer={
                k: r4[k] for k in ("max_abs_err", "ms", "plain_ms", "library_ms",
                                   "bound_ms", "bound_by")})
    for variant, (name, replaces) in KV_KERNELS.items():
        row = kv_rows[name]
        t = row["cases"][0]
        kernels.append({
            "name": variant, "route": "cuda", "source": KV_SOURCE, "replaces": replaces,
            "launches": counts[name], "max_abs_err": row["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "workload": t["case"] + f"; median of {ROUNDS} interleaved rounds",
            "range_ms": t["range_ms"], "clock": t["clock"],
            "cases": [{k: c[k] for k in ("case", "max_abs_err", "errs", "ms", "eager_ms",
                                         "fill_ms", "plain_ms", "library_ms", "bound_ms",
                                         "bound_by")
                       if k in c} for c in row["cases"]]})
        if name != "page_decode":
            kernels[-1]["combine_launches"] = counts[f"{name}_combine"]
        if name == "paged_attention":
            kernels[-1]["zoo_launches"] = zoo_launches["paged_attention"]
            kernels[-1]["train_launches"] = train_launches["paged_attention"]
            kernels[-1]["mesh_launches"] = mesh_launches["paged_attention"]
            kernels[-1]["zoo_cases"] = [
                {k: c[k] for k in ("case", "max_abs_err", "ms", "eager_ms", "plain_ms",
                                   "library_ms", "bound_ms", "bound_by")}
                for c in zoo["q3"]["attention"]]
    for name, (variant, replaces) in GROUPED.items():
        row = moe_rows[name]
        t = row["cases"][0]
        kernels.append({
            "name": variant, "route": "cuda", "source": SOURCE, "replaces": replaces,
            "launches": counts[name], "max_abs_err": row["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "workload": t["case"] + f" (one MoE layer's stacks); median of {ROUNDS} "
                        "interleaved rounds",
            "range_ms": t["range_ms"], "clock": t["clock"],
            "cases": [{k: c[k] for k in ("case", "max_abs_err", "limit", "ms", "eager_ms",
                                         "plain_ms", "library_ms", "bound_ms",
                                         "bound_by")} for c in row["cases"]]})
        if name == "grouped_onehot":
            kernels[-1]["zoo_launches"] = zoo_launches["grouped_onehot"]
            kernels[-1]["mesh_launches"] = mesh_launches["grouped_onehot"]
    for name, (variant, replaces) in DRAFT.items():
        row = draft_rows[name]
        t, one, mid = row[4], row[1], row[16]
        kernels.append({
            "name": variant, "route": "cuda", "source": SOURCE, "replaces": replaces,
            "launches": counts[name], "max_abs_err": row["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "workload": "one OLMo-1B layer's 7 linears at M=4 (the draft lane's four "
                        f"slots), bf16 x, mip2q p=0.5; median of {ROUNDS} interleaved "
                        "rounds",
            "range_ms": t["range_ms"], "clock": t["clock"], "graph_ms": t["graph_ms"],
            "library_graph_ms": t["library_graph_ms"],
            "m1_ms": one["ms"], "m1_graph_ms": one["graph_ms"], "m1_bound_ms": one["bound_ms"],
            "m1_plain_ms": one["plain_ms"], "m1_library_ms": one["library_ms"],
            "m1_library_graph_ms": one["library_graph_ms"],
            "m16_ms": mid["ms"], "m16_graph_ms": mid["graph_ms"],
            "m16_bound_ms": mid["bound_ms"], "m16_library_graph_ms": mid["library_graph_ms"],
            "per_shape_graph_ms": row["per_shape"]})
    from repro_torch.analysis.pallas_lint import VARIANT_KERNELS
    for k in kernels:        # phase t1's launches, each held to its plain version
        k["lint_launches"] = analysis["t1"]["launches"][VARIANT_KERNELS[k["name"]]]
        k["numerics_launches"] = u_launches.get(VARIANT_KERNELS[k["name"]], {})
        k["examples_launches"] = v_launches.get(VARIANT_KERNELS[k["name"]], {})
    return kernels, times


def _zoo_report(zoo, smi) -> None:
    """Phase q's summary lines."""
    q1 = zoo["q1"]
    t = q1["decode_tick_ms"]
    print(f"zoo path (Mamba-2 780M, 48 layers, full width): paged drain "
          f"{q1['drain_ms']:.1f} ms, {q1['ticks']} ticks, decode-only tick median "
          f"{t['median']:.3f} ms [{t['min']:.3f}, {t['max']:.3f}] over "
          f"{q1['decode_ticks']}; SSM hot state {q1['hot_state_bytes']} bytes; weights "
          f"x{q1['weights_ratio_vs_int8']:.4f} of int8; dense loop decode "
          f"{q1['dense_decode_ms_per_token']:.3f} ms/token, prefill "
          f"{q1['dense_prefill_ms']:.1f} ms; K1 layer {q1['k1']['graph_ms']:.4f} ms "
          f"(graph) vs bound {q1['k1']['bound_ms']:.4f}; Jamba smoke drain "
          f"{zoo['q2']['drain_ms']:.1f} ms; 2-layer drains "
          f"{ {a: round(zoo['q3'][a]['drain_ms'], 1) for a in DENSE_ZOO} } ms; "
          f"sub-phase seconds { {k: round(v['seconds'], 1) for k, v in zoo.items()} }; "
          f"{smi}")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv not in ([], ["--only", "q"], ["--only", "r"], ["--only", "s"],
                    ["--only", "s4"], ["--only", "s5"], ["--only", "s6"],
                    ["--only", "s7"], ["--only", "t"], ["--only", "u"], ["--only", "v"]):
        print("usage: chip_smoke.py [--only q|r|s|s4|s5|s6|s7|t|u|v]", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke.py: no src/repro_torch beside {__file__}; run it from "
              "the repo root", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False; this smoke "
              "test needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    global HBM_BYTES_PER_S, PEAK_FLOPS
    from repro_torch.hardware import HBM_BYTES_PER_S, PEAK_FLOPS
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 yardsticks
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    _phase("a. card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    _phase("b. build")
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import build
    t0 = time.perf_counter()
    sources = ("strum_matmul", "strum_attention")
    with ThreadPoolExecutor(len(sources)) as pool:   # one nvcc per source, together
        for lib in list(pool.map(build.build, sources)):
            print(f"  built {lib.name}", flush=True)
    for name in sources:
        build.load(name)
    print(f"  built {', '.join(sources)} in {time.perf_counter() - t0:.1f} s into "
          f"{build.build_dir()}", flush=True)
    for name in sources:
        for line in _ptxas_lines(build.BUILD_LOGS[name]):
            print(f"  {name}: {line}", flush=True)

    clocks = Clocks()
    try:
        if argv == ["--only", "q"]:     # phase q alone: no kernels or result line
            _phase("q. the model zoo")
            zoo = measure_zoo(dev, clocks)
            _zoo_report(zoo, smi)
            print(json.dumps({"zoo": zoo}, default=str))
            return 0
        if argv == ["--only", "s"]:     # phase s alone: no kernels or result line
            _phase("s. distributed")
            mesh = measure_mesh(dev, _single_device_refs(dev))
            _mesh_report(mesh, smi)
            print(json.dumps({"mesh": mesh}, default=str))
            return 0
        if argv[:1] == ["--only"] and argv[1] in ("s4", "s5", "s6", "s7"):
            # one sub-phase of s alone: no kernels or result line
            _phase(f"{argv[1]}. " + {
                "s4": "the sharded serving layout of the MoE, SSM and hybrid families",
                "s5": "the paged layout: BatchScheduler(mesh=) on 2x2",
                "s6": "the dense decoders' train step on 2x2",
                "s7": "the MoE, SSM and hybrid families' train step on 2x2"}[argv[1]])
            mesh = measure_mesh(dev, None, only=(argv[1],))
            print(json.dumps({"mesh": mesh}, default=str))
            return 0
        if argv == ["--only", "t"]:     # phase t alone: no kernels or result line
            _phase("t. static analysis")
            analysis = measure_analysis(dev)
            _analysis_report(analysis, smi)
            print(json.dumps({"analysis": analysis}, default=str))
            return 0
        if argv == ["--only", "u"]:     # phase u alone: no kernels or result line
            _phase("u. static numerics")
            numerics = measure_numerics(dev)
            _numerics_report(numerics, smi)
            print(json.dumps({"numerics": numerics}, default=str))
            return 0
        if argv == ["--only", "v"]:     # phase v alone: no kernels or result line
            _phase("v. the launch tools and examples")
            examples = measure_examples(dev)
            _examples_report(examples, smi)
            print(json.dumps({"examples": examples}, default=str))
            return 0
        if argv == ["--only", "r"]:     # phase r alone: no kernels or result line
            _phase("r. the training path")
            train = measure_train(dev, clocks)
            _train_report(train, smi)
            print(json.dumps({"train": train}, default=str))
            return 0
        kernels, times = measure(dev, clocks)
    finally:
        clocks.close()

    pre, dec = times["prefill_ms"], times["decode_ms_per_token"]
    paged = times["paged"]
    tick = paged["decode_tick_ms"]
    print(f"paged path: drain {paged['drain_ms']:.1f} ms, {paged['ticks']} ticks, "
          f"decode-only tick median {tick['median']:.3f} ms [{tick['min']:.3f}, "
          f"{tick['max']:.3f}] over {paged['decode_ticks']}; phase time "
          f"{json.dumps({k: round(v, 1) for k, v in PHASE_S.items()})} s (start of "
          f"each phase); phase r took {times['train']['seconds']:.1f} s")
    moe = times["moe"]
    mt = moe["decode_tick_ms"]
    print(f"moe path (Moonshot-16B-A3B, {moe['layers']} layers, full width): drain "
          f"{moe['drain_ms']:.1f} ms, {moe['ticks']} ticks, decode-only tick median "
          f"{mt['median']:.3f} ms [{mt['min']:.3f}, {mt['max']:.3f}] over "
          f"{moe['decode_ticks']}; dense loop decode {moe['dense_decode_ms_per_token']:.3f} "
          f"ms/token, prefill {moe['dense_prefill_ms']:.1f} ms; weights "
          f"x{moe['weights_ratio_vs_int8']:.4f} of int8")
    for mode, sp in times["speculative"].items():
        r = sp["round_ms"]
        print(f"speculative path ({mode}, k={SPEC_K}): drain {sp['drain_ms']:.1f} ms, "
              f"{sp['ticks']} ticks, round median {r['median']:.3f} ms [{r['min']:.3f}, "
              f"{r['max']:.3f}] over {sp['rounds']} against the plain decode-only tick "
              f"{tick['median']:.3f} ms; acceptance {sp['acceptance']:.4f} "
              f"({int(sp['spec']['accepted'])} of {int(sp['spec']['drafted'])}); draft "
              f"payload x{sp['ratio']:.4f}")
    p1 = times["schedule"]["p1"]
    pt, ht = p1["decode_tick_ms"], p1["phase_h_decode_tick_ms"]
    print(f"schedule path (searched OLMo-1B, {p1['schedule']['config_distribution']}, "
          f"weights x{p1['weights_ratio_vs_int8']:.4f} of int8): profile "
          f"{p1['profile_s']:.2f} s, again from the cache {p1['profile_hits_s']:.2f} s, "
          f"search {p1['search_s'] * 1e3:.2f} ms; paged drain {p1['drain_ms']:.1f} ms, "
          f"decode-only tick median {pt['median']:.3f} ms [{pt['min']:.3f}, "
          f"{pt['max']:.3f}] against phase h's {ht['median']:.3f} ms; sub-phase seconds "
          f"{ {k: round(v['seconds'], 1) for k, v in times['schedule'].items()} }")
    _zoo_report(times["zoo"], smi)
    _train_report(times["train"], smi)
    _mesh_report(times["mesh"], smi)
    _analysis_report(times["analysis"], smi)
    _numerics_report(times["numerics"], smi)
    _examples_report(times["examples"], smi)
    print(f"main path (median of {times['serves']} warm serves): prefill "
          f"{pre['median']:.3f} ms [{pre['min']:.3f}, {pre['max']:.3f}], decode "
          f"{dec['median']:.3f} ms/token [{dec['min']:.3f}, {dec['max']:.3f}] "
          f"(batch 4), {smi}")
    print(json.dumps({"serve": times}, default=str))
    print(json.dumps({"kernels": kernels}))
    print("kernels launched and held: " + ", ".join(k["name"] for k in kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
