#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

Run from the root of a checkout, on a machine with a CUDA device and nvcc:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch`` (nvcc, sm_90a,
one process per source, all started together) and then runs phases A-U;
any failure raises and exits non-zero.

  (A) The conv kernel against its plain PyTorch version at every distinct
      conv shape of VGG-16 at 224x224, batch 8, in fp32 and bf16, at the
      small shapes of the kernel tests (odd and even R), and, in bf16 from
      a generator of their own, at tests/test_torch_conv2d.py::WGMMA_CASES
      (each on the wgmma route). Tolerance atol = rtol = 2e-4 in fp32,
      2e-2 in bf16. Per VGG shape it prints the plan (route ``wgmma`` or
      ``direct``, pixel box, output channels a block, splits, blocks per
      SM) and times, with CUDA events, the kernel (the wgmma route's
      re-layout of x to NHWC and of w to an (R*S*C, K) matrix included),
      the plain version and one cuDNN ``F.conv2d`` call (the yardstick; the
      port never calls it), single calls and back to back (50 calls between
      one pair of events, as the matmul rows of phase D), the re-layout
      alone back to back, and the host microseconds per call of the
      wrapper and of cuDNN; and it computes the least time the card could
      take (bytes over 3.35 TB/s or operations over the published peak of
      the dtype).
  (B) ``hybrid_forward`` on VGG-16 at 224x224, batch 8, HybridPlan(sp=4,
      n_micro=4), in fp32 and bf16, against ``forward(use_kernel=False)``:
      normalised error max|d| / max|ref| at most 2e-4 (fp32) and 2e-2
      (bf16), and exactly 13 conv kernel launches per forward: in bf16 12
      on the wgmma route and 1 (the first layer, C = 3) direct, in fp32 13
      direct.
  (C) The pipelined head at VGG width: 4 x conv(128, 3) as the head, then
      pool(2) and 2 x conv(256, 3), input (8, 128, 112, 112), against
      ``forward(use_kernel=False)`` at 2e-4.
  (D) The matmul, RMSNorm and flash-attention kernels against their plain
      versions, fp32 and bf16, at every shape StarCoder2-3B's serving path
      gives them (prefill at batch 4 x 512 tokens, decode at 4 slots) and
      at the small shapes of the kernel tests (the window case, head dim
      48, queries shorter than keys, M = 1), and flash attention at
      StarCoder2's heads (hd 128) with S not a multiple of 128, S < Sk, a
      window and no mask (ATTN_ROUTE_CASES), each flash call counted on
      the route its plan names (bf16 ``wgmma``, fp32 ``simt``) and the plan
      printed. Tolerance atol = rtol = 2e-4 in fp32, 2e-2 in bf16. Per
      full-width shape it times the kernel, the plain version and one
      PyTorch call of the same function (``torch.matmul``, ``F.rms_norm``,
      ``F.scaled_dot_product_attention`` with ``enable_gqa``; the yardstick,
      never called by the port) and computes the bound. Each matmul,
      RMSNorm and flash row also prints a back-to-back device time of the
      kernel and of the PyTorch call: 50 calls between one pair of CUDA
      events after an L2 flush, the device kept busy while the host queues
      them (matmul rows cycle over copies of the weight so that each call
      reads it from device memory); matmul rows print the route, tile and
      K splits of the kernel's plan, flash rows the route, RMSNorm rows the
      plan (route, vectors a thread, threads a row, rows a block, 16-byte
      loads or not). The host microseconds per matmul and RMSNorm wrapper
      call on a decode shape are printed beside torch.matmul's and
      F.rms_norm's.
  (E) Prefill: ``api.prefill_logits`` on StarCoder2-3B at full width and
      depth, bf16 weights from a seeded generator, batch 4 x 512 tokens,
      against ``forward(use_kernel=False)``: normalised error at most
      2e-2, finite (4, 512, 49152) logits, and exactly 181 matmul, 61
      RMSNorm and 30 flash-attention launches per forward, every matmul
      and every flash attention on the wgmma route.
  (F) Serving: ``ContinuousBatcher`` on the same weights, 4 slots, 8 seeded
      requests (prompts of 16-64 tokens, 8-16 new tokens each): every
      request completes; every tick makes exactly 181 matmul (all wgmma)
      and 61 RMSNorm launches; on the first 4 ticks the kernel decode step agrees
      with the plain one on the same cache (logits and new caches within
      2e-2 normalised); ``steps`` and ``utilization`` equal a plain-route
      batcher's on the same requests.
  (G) The SSD kernel against its plain version ``ssd_ref`` at Zamba2-2.7B's
      prefill shape (x (4, 512, 80, 64), b and c (4, 512, 64), chunk 256)
      in fp32 and with the model's bf16 x, b, c, at the small shapes of
      the kernel tests (tests/test_kernels.py::SSD_CASES, S < chunk), and
      at Zamba2's heads on SSD_ROUTE_CASES (chunks of 64, 128, 256, S <
      chunk, decays that overflow fp32 above the diagonal), with chunk
      invariance (32 against 128); every SSD call counted on the route its
      plan names (bf16 ``wgmma``, fp32 ``simt``); atol = rtol = 2e-4 (fp32),
      2e-2 (bf16), the normalised error printed beside it. Then flash
      attention at Zamba2's heads (hd 80) on ATTN_ROUTE_CASES, the host
      microseconds per SSD, matmul and RMSNorm wrapper call, and matmul,
      RMSNorm and flash attention at every shape Zamba2's prefill and decode
      tick give them. Times and bounds as in phase D; the SSD row adds its
      back-to-back time (L2 flushed, the inputs cycled over copies so each
      call reads them from device memory) and its device time by kernel
      (``torch.profiler``: the wgmma route's ``ssd_states`` and
      ``ssd_outputs``, the wrapper's ``a = -exp(a_log)``); no PyTorch call
      computes the SSD, so its library time is "none".
  (H) Prefill: ``api.prefill_logits`` on Zamba2-2.7B at full width and depth
      (54 Mamba2 layers, 9 uses of the shared attention block), bf16
      weights from a seeded generator, batch 4 x 512 (two SSD chunks):
      finite (4, 512, 32000) fp32 logits, exactly 280 matmul (all wgmma),
      127 RMSNorm, 9 flash-attention (all wgmma; the fp32 forward's 9 all
      simt) and 54 SSD launches (all wgmma; the fp32 forward's 54 all simt)
      per forward. Each of the 63
      blocks and the head is held kernel route against plain route fed the
      same input: normalised error at most 2e-2 in bf16 and 2e-4 in fp32.
      The end-to-end errors (bf16 and fp32) are printed, not gated: with
      random weights the 63 blocks amplify any rounding difference at
      their input, so the run also prints the plain fp32 route against
      itself with its embeddings nudged by 1e-6 (PERF.md, Findings).
  (I) Serving: ``ContinuousBatcher`` on the same weights, 4 slots, 8 seeded
      requests (so slots are reused): every request completes; every tick
      makes exactly 280 matmul (all wgmma) and 127 RMSNorm launches; on ticks 0-3 every
      block of the kernel decode step agrees with the plain one fed the
      same input and the same cache lines (its output and its new conv,
      ssm, k and v lines within 2e-2 normalised; the end-to-end logits and
      caches are printed);
      the conv and ssm lines of every slot admitted after tick 0 are zero
      before its first tick; ``steps`` and ``utilization`` equal a
      plain-route batcher's.
  (J) The cross-cell DSE screen (``core/screen.py``): VGG-16 and VGG-19 (no
      FC, as the campaign builds them) at inputs 64-448 x the four boards x
      precisions 16 and 8, 96 cells of 4096 seeded candidates within the
      search box at batch_max 8: the card's float64 output equals the same
      call on the CPU bit for bit; the median ms a call (CUDA events, with
      and without the host copies) and candidates/s beside the CPU's.
  (K) Training at full width: StarCoder2-3B, fp32 master weights from a
      seeded generator, bf16 compute, remat "full", 3 steps of
      ``train.steps.build_step``'s train step at 4 x 512 on batches of the
      port's ``TokenPipeline(seed=0)``: finite losses and grad norms, every
      parameter leaf changed after step 0, the in-place AdamW update of
      ``embed`` and ``blocks/attn/wq`` within 1e-6 normalised of the
      reference formula evaluated out of place on copies, no kernel launched
      by the steps (training takes the plain route: the kernels have no
      backward), and the step-0 loss within 2e-2 relative of
      ``softmax_xent`` over ``api.prefill_logits(use_kernel=True)`` on the
      bf16 cast of the same weights and tokens (181 / 61 / 30 launches).
      Then Zamba2-2.7B, 2 steps, the same checks (``embed``,
      ``shared/attn/wq``, ``mamba/dt_proj``), its loss against the kernel
      route printed, not gated. Each prints the step ms (median after the
      first), tokens/s, the peak memory and 6*N*tokens / step time over the
      bf16 peak.
  (L) The Trainer and the launcher at StarCoder2-3B.reduced(): 12 steps
      lower the loss, ``fail_at(5)`` with checkpoints every 2 steps recovers
      to 8 steps with 1 restart, a second Trainer resumes at step 4; then
      ``python -m repro_torch.launch.train --reduced --steps 4`` in a
      subprocess exits 0, prints its ``done:`` line and leaves a checkpoint
      that ``store.restore`` reads back bit-equal (checkpoints under
      ``build/``, removed after).
  (M) The hybrid LM plan on StarCoder2-3B at full width and depth, bf16,
      4 x 512: ``hybrid_lm_forward`` with HybridLMPlan(sp=8, n_stages=4,
      n_micro=4), pipelined on the kernel route, against
      ``api.prefill_logits`` on the kernel route and against the pipelined
      plain route (2e-2), the sequential plan against prefill_logits (1e-6);
      exactly 469 matmul (all wgmma), 157 RMSNorm and 78 flash launches (the
      one-device GPipe calls each head stage at 7 ticks: 56 head block
      calls and 22 tail) against the prefill's 181 / 61 / 30. Then
      ``quantize_params`` of the same weights: ``storage_bytes`` before and
      after, the latter equal to the count from the leaf shapes; every
      dequantized weight within half a scale of the original (fp32); the
      dequantized bf16 prefill's logits error and top-1 agreement against
      the unquantized one printed, not gated.
  (N) xLSTM-350M at full width and depth (24 blocks, an sLSTM every 6th),
      bf16 weights: prefill 4 x 512 in bf16 and in fp32, exactly 2173
      matmul launches (6 an mLSTM block, 1 + 512 an sLSTM block: its
      recurrent product at every step, the head; bf16: wi and wf, N = 4,
      on simt, the rest wgmma; fp32: all simt) and 49 RMSNorm. The random
      model amplifies roundings (the end-to-end errors are printed), so
      every block and the head is held kernel route against plain route
      on the same input (2e-2 bf16, 2e-4 fp32) and the blocks chained by
      hand within 1e-6 of ``prefill_logits`` on both routes. Then
      ``ContinuousBatcher`` with 8 requests on 4 slots: 129 matmul (40
      simt) and 49 RMSNorm launches a tick, every reused slot starts from
      the initial state (m = -1e30), ticks 0-3 block by block against the
      plain route and chained against ``decode_step``, steps and
      utilization equal to a plain-route batcher's.
  (O) Whisper-base at full width and depth (6 + 6 layers, d 512, 8 heads of
      64, vocab 51865), seeded frames (4, 1500, 512) and tokens 4 x 448,
      bf16 and fp32: ``encode`` (36 matmul, 6 flash, not causal) and
      ``decode_train`` (61 matmul, the tied head at N = 51865 on simt; 12
      flash: causal self-attention and cross-attention, 448 queries over
      1500 keys) against the plain route on the same input; then
      ``prefill_cross`` (12 matmul) and 448 ``decode_step``s (49 matmul
      each), whose last logits match ``decode_train``'s at the last
      position (2e-2 bf16, 2e-4 fp32).
  (P) Kimi-K2 at full width, 1 of its 61 layers (one layer's 384 experts
      are 33.8 GB in bf16; the weights drawn expert by expert), prefill 4 x
      512 (capacity 54): exactly 1161 matmul launches (attention 4, router
      1, 1152 expert products, shared expert 3, head 1; all wgmma), 3
      RMSNorm, 1 flash; fed the same input, the attention, the router
      logits and the head within 2e-2 of the plain route, the top-k sets
      of the two routes agreeing on at least 99 % of the tokens and the
      MoE output within 2e-2 on the tokens whose sets and kept assignments
      agree; dropped assignments and the host time of the 1152 expert
      launches printed. Then 8 decode ticks of 4 slots (capacity 4), 1161
      matmul launches each, beside the 10.1 ms that reading every
      expert's weights once takes.
  (Q) The paper's pipeline across processes and expert parallelism:
      Q_RANKS = 4 ranks spawned after P, all on cuda:0 (the machine has one
      card, and NCCL refuses two ranks on one device), in a gloo group
      that moves device tensors through host memory, FileStore rendezvous,
      a 60 s timeout on every collective; the parent builds every kernel
      first, frees P's tensors and fails if a rank fails or the ranks
      outlive 400 s. (Q1) phase C's net, weights and input through
      ``hybrid_forward(mesh=)``, each rank holding its own head conv:
      exactly 9 conv launches a rank (7 ticks + 2 tail convs, 36 in all,
      fp32 direct), the output within 2e-4 of phase C's one-device
      output, and each rank's stage-weight gradient (plain route under
      autograd, loss the output's sum) within 2e-4 of the sequential
      loss's. (Q2) phase M's model, drawn on every rank from phase M's
      generator, through ``hybrid_lm_forward(mesh=)``: exactly 217 matmul
      (wgmma), 73 RMSNorm and 36 flash (wgmma) launches a rank (7 ticks x
      2 head blocks + 22 tail), the logits within 2e-2 of phase M's
      one-device pipelined ones. (Q3) Kimi-K2's MoE MLP at full width,
      expert-parallel over a (data 1, model 4) mesh, each rank drawing
      the whole layer's generator sequence and keeping its 96 experts
      (``init_moe_mlp(experts=)``): exactly 292 matmul launches a rank
      (router, 288 expert products, shared expert), the output within
      1e-2 of the dense kernel route (computed by the parent over all 384
      experts, then freed) on the tokens whose top-k sets and kept
      assignments agree, the aux loss within 1e-5, the same drops. (Q4)
      ``compressed_psum`` of seeded fp32 gradients equal to the formula on
      the host, bit for bit. It prints the backend and transport, each
      rank's walls (4 processes time-sharing one card: no multi-card
      number) and peak memory.
  (R) The sharded steps on a DTensor mesh: R_RANKS = 4 ranks spawned after
      Q on cuda:0 over gloo, a (data 2, model 2) mesh (DTensor's
      collectives run blocking: gloo's functional-collective wait ends
      the process on this machine). The parent first computes each
      step's one-device result on the same seeded weights and batches and
      frees the card. (R0) redistributions of a bf16 tensor on the card
      bit-equal to the source. (R1) StarCoder2-3B at full width and depth,
      bf16, 4 x 512, through ``build_step(prefill, mesh=)``: 181 matmul
      (wgmma), 61 RMSNorm, 30 flash (wgmma) launches a rank at the local
      shapes (M = 1024 rows; column-parallel products split N,
      row-parallel ones K; flash on 2 batch rows and 12 of 24 heads over
      1 of 2 KV heads), no DTensor at any launch, the logits within 2e-2
      of the one-device build_step's; the collectives by kind. (R2) 8
      decode ticks of 4 slots on a sequence-sharded cache, teacher-forced
      on the one-device run's tokens: 181 / 61 a tick a rank at M = 2,
      logits within 2e-2, the argmax equal to one device's wherever the
      top-2 margin exceeds twice the measured error. (R3) 2 train steps
      (fp32 masters and compute, the dtype of the 2e-4 gate; plain route):
      loss, grad norm and every updated param within 2e-4 of the
      one-device steps; no kernel launch. (R4) Kimi-K2's MoE MLP at full width with 32 of its 384
      experts (8 a rank), fp32, expert-parallel with a backward: the
      gradients of the input and of every leaf within 2e-4 of the dense
      route's autograd. (R5) the Trainer at ``.reduced()`` on a (4, 1)
      mesh, 4 steps checkpointed after step 3, restored onto (2, 2) bit
      for bit, and its next loss within 2e-4 of the (4, 1) run's. (R6)
      Zamba2's prefill SSD (bf16, B 4, S 512, 80 heads of 64, chunk 256)
      through ``ssd_on_shards``, batch over data and heads over model: 1
      wgmma launch a rank on 40 heads, the gathered output within 2e-2 of
      the one-device kernel's.
  (S) The dry run on this machine, mesh device type cuda (fake tensors
      over a fake process group: nothing allocated, nothing launched).
      (S1) R1's prefill on a fake (data 2, model 2) mesh: its collectives
      by kind and the kernels' local shapes equal to R1's measured ones,
      its arguments' bytes and its peak above them within 1 % of the
      bytes rank 0's tensors requested of the allocator in R1.
      (S2) ``run_cell`` on the 16 x 16 mesh for every arch at decode_32k
      and StarCoder2-3B at every shape: every enabled cell ok, long_500k
      skipped; FLOPs a rank x 256 against the unsharded step's, collective
      bytes by kind, GiB a device against the card's. (S3) two hill-climb
      variants. A pool of S_WORKERS processes; bounded at S_BOUND seconds.
  (T) The paper's DSE campaign in the port (``repro_torch.dse.campaign``):
      VGG-16 and VGG-19 at 224 x {ku115, zc706, vu9p, zcu102} x
      precisions {16, 8}, 16 cells, the hyperband searcher at its default
      config (screen 4096, survivors 16), rung 0 of every cell screened on
      the card in one cross-cell call (``screen_device="cuda"``). Its
      records equal, field for field but the search time, those of the
      same campaign screening each cell in NumPy (``screen_device=None``);
      a rerun on the card's store reuses all 16 cells with 0 evaluations;
      ``python -m repro_torch.dse.campaign ... --device cuda`` in a
      subprocess exits 0 with the in-process run's design for
      VGG-16/KU115/16-bit; none of the five kernels launches. It prints
      both walls (host clock, the model's caches emptied before each), the
      prescreen's host wall and its screen's time on the card (CUDA
      events) with their shares of the wall, cells/s, and each cell's best
      GOP/s, DSP efficiency and RAV.
  (U) The calibration loop, fed by the card's own kernel timings. (U1) The
      five kernels in bf16, each against its plain version at 2e-2: the
      conv (wgmma route) at VGG-16's conv3 (batch 8, C = K = 256, 56 x
      56), StarCoder2-3B's products at prefill (M = 4 x 512) and at the
      4-slot tick, its RMSNorm and flash attention at prefill, and the SSD
      at Zamba2-2.7B's prefill shape; then each row's calls back to back
      (b2b_ms) over copies of its operands that together exceed twice the
      L2, the counts set to 0 just before and read just after. Each row
      becomes a calibration row (``calib_row``): the term that bounds it
      on ``hw_specs.H100`` (held equal to this script's peaks) predicts
      its time on the compute or the bandwidth axis, the back-to-back time
      of one call is the measurement, and no row may read above 105 % of
      the spec's peak. The rows go to build/calib/h100_kernels.json in the
      ``benchmarks/run.py --json`` shape. (U2) ``python -m
      repro_torch.calib fit`` on them, in a subprocess, gives
      build/calib/h100.json, equal to the in-process fit, and ``validate``
      passes; the fitted h100 scales print beside the published digest's.
      (U3) ``python -m repro_torch.dse.campaign --backend cuda`` over
      StarCoder2-3B and Zamba2-2.7B x {train_4k, prefill_32k, decode_32k}
      x {8, 16} H100s under that calibration: every record carries its
      fingerprint, a rerun reuses every cell with 0 evaluations, and each
      record's step time equals ``gpu_planner.evaluate_point`` on the
      scaled spec; each cell's best calibrated and datasheet step time
      print. (U4) ``python -m repro_torch.dse.report`` over that store
      renders the calibration section with the card rows' provenance, and
      ``python -m repro_torch.dse.placement --selftest`` exits 0. The
      whole run also prints the calibrated roofline of StarCoder2-3B's
      prefill at 4 x 512 on one H100 beside phase E's measured wall.
  Phases M-R print their walls, tokens/s and peak memory; each draws from
  a generator of its own.

Then it holds the bf16 conv of VGG-16 to cuDNN in the same run (the sum of
single calls over one forward at most 1.5x cuDNN's), the bf16 matmul of
both LMs to torch.matmul (the prefill sum of single calls at most 4x
torch.matmul's, the decode tick's back-to-back sum at most 2x), and the
bf16 flash attention of a prefill, back to back, to SDPA's: at most 2x on
StarCoder2 (hd 128), 3x on Zamba2 (hd 80), the bf16 RMSNorm of each LM's
prefill, back to back, to at most 1.05x F.rms_norm's (the single-call and
decode sums printed), and the bf16 SSD at Zamba2's prefill shape, back to
back, to at most 10x its bytes bound. Its last two
lines are the kernel summary (one JSON object; each entry carries the
launches of phases M-R and U by path) and the result
``{"ok": true, "device": {...}}``. There is no CPU fallback: without a CUDA
device it exits non-zero and prints no result.

    python3 chip_smoke.py --q-only

runs phases C and M (what phase Q is held to) and Q alone, with the same
gates, and prints Q's wall but neither summary line: to compare phase Q
of two trees in one call, run each tree's script in turn.

    python3 chip_smoke.py --r-only

runs phase R alone (it computes its own references), with its gates,
and prints R's wall but neither summary line.

    python3 chip_smoke.py --s-only

runs phase S alone, with its gates but S1's tie to R1 (phase R did not
run), and neither summary line.

    python3 chip_smoke.py --t-only

runs phase T alone, with its gates, and neither summary line.

    python3 chip_smoke.py --u-only

runs phase U alone, with its gates but the prefill line (phase E did not
run), and neither summary line.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import tree  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.configs import ARCH_IDS, SHAPES, get_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.core import screen  # noqa: E402
from repro_torch.core.hw_specs import FPGAS, H100  # noqa: E402
from repro_torch.core.netinfo import TABLE1_NETS, _B, vgg16, vgg19  # noqa: E402
from repro_torch.data.pipeline import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.conv2d.conv2d import plan_for as conv_plan_for  # noqa: E402
from repro_torch.kernels.conv2d.conv2d import relayout  # noqa: E402
from repro_torch.kernels.conv2d.ops import conv2d  # noqa: E402
from repro_torch.kernels.conv2d.ref import conv2d_ref  # noqa: E402
from repro_torch.kernels.flash_attention.flash_attention import \
    plan_for as flash_plan_for  # noqa: E402
from repro_torch.kernels.flash_attention.ops import attn_fn as flash_attn_fn  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.matmul.matmul import plan_for  # noqa: E402
from repro_torch.kernels.matmul.ops import matmul  # noqa: E402
from repro_torch.kernels.matmul.ref import matmul_ref  # noqa: E402
from repro_torch.kernels.rmsnorm.ops import rmsnorm  # noqa: E402
from repro_torch.kernels.rmsnorm.rmsnorm import plan_for as rms_plan_for  # noqa: E402
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref  # noqa: E402
from repro_torch.kernels.ssd.ops import ssd, ssd_on_shards  # noqa: E402
from repro_torch.kernels.ssd.ssd import plan_for as ssd_plan_for  # noqa: E402
from repro_torch.kernels.ssd.ref import ssd_ref  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.hillclimb import run_variant  # noqa: E402
from repro_torch.launch.hlo_stats import kind_counts  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh, make_mesh, spawn_ranks  # noqa: E402
from repro_torch.launch.specs import make_batch  # noqa: E402
from repro_torch.models import (api, encdec, layers, moe, recurrent, ssm,  # noqa: E402
                                transformer)
from repro_torch.models.cnn import (HybridPlan, forward, hybrid_forward,  # noqa: E402
                                    init_vgg)
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel import act  # noqa: E402
from repro_torch.parallel.collectives import compressed_psum, on_host  # noqa: E402
from repro_torch.serve.quant import (dequantize_params, quantize_params,  # noqa: E402
                                     storage_bytes)
from repro_torch.serve.scheduler import ContinuousBatcher, Request  # noqa: E402
from repro_torch.train.hybrid import HybridLMPlan, hybrid_lm_forward  # noqa: E402
from repro_torch.train.steps import build_step, cast_bf16, init_params_on_mesh  # noqa: E402
from repro_torch.train.trainer import TrainConfig, Trainer, restore_trainer_state  # noqa: E402

# H100 SXM published peaks (dense): fp32 outside the tensor cores, bf16 on
# them, and HBM3 bandwidth.
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
HBM_BYTES_PER_S = 3.35e12
TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}  # tests/test_kernels.py::_tol
SAME = 1e-6  # a model's blocks chained by hand against its entry point: the same arithmetic
DTYPES = (torch.float32, torch.bfloat16)
BATCH = 8
# (N, C, H, W, K, R) of tests/test_kernels.py::CONV_CASES, plus an even R.
SMALL_CASES = [(1, 16, 16, 16, 32, 3), (2, 3, 20, 24, 64, 5), (1, 8, 10, 10, 16, 1),
               (1, 64, 7, 9, 8, 7), (1, 12, 9, 11, 24, 4)]
# (N, C, H, W, K, R) of tests/test_torch_conv2d.py::WGMMA_CASES, drawn from
# a generator of their own so that phases B-I draw what they drew before.
WGMMA_CASES = [(2, 64, 9, 11, 64, 3), (1, 128, 7, 13, 200, 3), (2, 64, 5, 7, 8, 1),
               (1, 64, 12, 10, 72, 4), (1, 128, 6, 9, 136, 7), (1, 64, 30, 33, 128, 3),
               (2, 128, 17, 19, 64, 3)]
WGMMA_SEED = 15
CONV_FLOOR = 1.5  # the bf16 VGG conv sum at most this times cuDNN's, same run
REPLACES = "src/repro/kernels/conv2d/conv2d.py:40"
SOURCE = "src/repro_torch/kernels/conv2d/csrc/conv2d.cu"


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


L2_BYTES = 50 * 2**20  # the H100's L2 cache
B2B_REPS = 50


def time_ms(fn, warmup: int = 2, reps: int = 10) -> float:
    """Median device time of one call, CUDA events around each call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


@functools.cache
def _l2_flush() -> torch.Tensor:
    return torch.empty(2 * L2_BYTES, dtype=torch.uint8, device="cuda")


def b2b_ms(fn, reps: int = B2B_REPS) -> float:
    """Device time of one call of ``fn(i)``, from ``reps`` calls back to back
    between one pair of CUDA events. The L2 is flushed first and the device
    is kept busy (``torch.cuda._sleep``) while the host queues the calls, so
    the events time the device, not the host's launch path."""
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    _l2_flush().zero_()
    torch.cuda._sleep(20_000_000)  # ~10 ms at the H100's clocks
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def l2_copies(b: torch.Tensor, reps: int = B2B_REPS) -> list:
    """Copies of b, enough that b2b_ms, cycling over them, reads each one from
    device memory as a decode tick reads each weight once."""
    return [b] + [b.clone() for _ in range(min(reps, -(-2 * L2_BYTES // b.nbytes)) - 1)]


def cold_copies(args: tuple, reps: int = B2B_REPS) -> list:
    """``args`` and copies of its tensors, enough that b2b_ms, cycling over
    them, reads every operand from device memory and not from the 50 MB L2."""
    nbytes = sum(t.nbytes for t in args if isinstance(t, torch.Tensor))
    n = min(reps, -(-2 * L2_BYTES // nbytes))
    return [args] + [tuple(t.clone() if isinstance(t, torch.Tensor) else t for t in args)
                     for _ in range(n - 1)]


def max_err_within(out, ref, tol: float) -> float:
    """max |out - ref|; raises if any element misses atol + rtol * |ref|."""
    out, ref = out.float(), ref.float()
    diff = (out - ref).abs()
    check(bool(torch.isfinite(out).all()), "non-finite kernel output")
    check(bool((diff <= tol + tol * ref.abs()).all()),
          f"kernel disagrees with its plain version: max |diff| {diff.max().item():.3e}")
    return diff.max().item()


def least_ms(nbytes: float, ops: float, dtype) -> tuple[float, str]:
    """The larger of bytes over the memory rate and operations over the peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_FLOPS[dtype] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def bound(n, c, h, w, k, r, dtype) -> tuple[float, str]:
    """Least time in ms (bytes or operations) for one conv, and which bounds it."""
    elem = torch.finfo(dtype).bits // 8
    by = elem * (n * c * h * w + k * c * r * r + n * k * h * w)
    return least_ms(by, 2 * n * k * c * h * w * r * r, dtype)


def conv_inputs(n, c, h, w, k, r, dtype, gen):
    x = torch.randn((n, c, h, w), generator=gen, device="cuda").to(dtype)
    wt = torch.randn((k, c, r, r), generator=gen, device="cuda")
    return x, (wt * math.sqrt(2.0 / (c * r * r))).to(dtype)


def counted_conv(x, wt, route: str):
    """One conv2d call that must launch once, on ``route``."""
    before, by = conv2d.launches, dict(conv2d.launches_by_route)
    out = conv2d(x, wt)
    check(conv2d.launches == before + 1
          and conv2d.launches_by_route[route] == by[route] + 1,
          f"conv2d routes {conv2d.launches_by_route} (before {by}), expected one on {route}")
    return out


def plan_text(p) -> str:
    return (f"{p.route} box {p.box[0]}x{p.box[1]} n{p.tile_n} splits {p.splits} "
            f"blocks/SM {p.blocks}" if p.box else p.route)


def phase_a(gen) -> dict:
    """Kernel against plain version; per VGG shape, plan, times and bounds."""
    for dtype in DTYPES:
        for n, c, h, w, k, r in SMALL_CASES:
            x, wt = conv_inputs(n, c, h, w, k, r, dtype, gen)
            p = conv_plan_for(x, wt)
            err = max_err_within(counted_conv(x, wt, p.route), conv2d_ref(x, wt), TOL[dtype])
            print(f"A {str(dtype)[6:]:8s} N={n} C={c} H={h} W={w} K={k} R=S={r}: "
                  f"{plan_text(p)}  max_abs_err {err:.3e}")
    wgen = torch.Generator(device="cuda").manual_seed(WGMMA_SEED)
    for n, c, h, w, k, r in WGMMA_CASES:
        x, wt = conv_inputs(n, c, h, w, k, r, torch.bfloat16, wgen)
        p = conv_plan_for(x, wt)
        check(p.route == "wgmma", f"WGMMA_CASES {(n, c, h, w, k, r)} planned {p}")
        err = max_err_within(counted_conv(x, wt, "wgmma"), conv2d_ref(x, wt),
                             TOL[torch.bfloat16])
        print(f"A bfloat16 N={n} C={c} H={h} W={w} K={k} R=S={r}: {plan_text(p)}  "
              f"max_abs_err {err:.3e}")

    convs = [l for l in vgg16(224).layers if l.kind == "conv"]
    shapes = sorted({(l.c, l.k, l.h) for l in convs}, key=lambda s: (-s[2], s[0], s[1]))
    check(len(shapes) == 9, f"expected 9 distinct VGG-16 conv shapes, got {len(shapes)}")
    summary = {}
    for dtype in DTYPES:
        rows = []
        for c, k, h in shapes:
            x, wt = conv_inputs(BATCH, c, h, h, k, 3, dtype, gen)
            p = conv_plan_for(x, wt)
            err = max_err_within(counted_conv(x, wt, p.route), conv2d_ref(x, wt), TOL[dtype])
            b_ms, b_by = bound(BATCH, c, h, h, k, 3, dtype)
            row = dict(c=c, k=k, h=h, route=p.route, box=list(p.box), splits=p.splits,
                       blocks=p.blocks, tile_n=p.tile_n, max_abs_err=err,
                       ms=time_ms(lambda: conv2d(x, wt)),
                       copies_b2b_ms=(b2b_ms(lambda i: relayout(x, wt))
                                      if p.route == "wgmma" else 0.0),
                       plain_ms=time_ms(lambda: conv2d_ref(x, wt)),
                       library_ms=time_ms(lambda: F.conv2d(x, wt, padding=1)),
                       b2b_ms=b2b_ms(lambda i: conv2d(x, wt)),
                       b2b_library_ms=b2b_ms(lambda i: F.conv2d(x, wt, padding=1)),
                       host_us=host_us_per_call(lambda: conv2d(x, wt), calls=50),
                       library_host_us=host_us_per_call(lambda: F.conv2d(x, wt, padding=1),
                                                        calls=50),
                       bound_ms=b_ms, bound_by=b_by,
                       layers=sum((l.c, l.k, l.h) == (c, k, h) for l in convs))
            rows.append(row)
            print(f"A {str(dtype)[6:]:8s} VGG N={BATCH} C={c:3d} K={k:3d} H=W={h:3d} "
                  f"x{row['layers']}: {plan_text(p)}  max_abs_err {err:.3e}  "
                  f"kernel {row['ms']:.4f} ms  bound {b_ms:.4f} ms ({b_by}), "
                  f"{b_ms / row['b2b_ms']:.1%} of it back to back  plain "
                  f"{row['plain_ms']:.4f} ms  cuDNN {row['library_ms']:.4f} ms  back to back: "
                  f"kernel {row['b2b_ms']:.4f} ms (re-layout {row['copies_b2b_ms']:.4f} ms)  "
                  f"cuDNN {row['b2b_library_ms']:.4f} ms  host: wrapper {row['host_us']:.1f} us "
                  f"per call, cuDNN {row['library_host_us']:.1f} us")
            del x, wt
        summary[dtype] = rows
    return summary


def vgg_forward_summary(rows) -> dict:
    """Per-layer numbers summed over the 13 convs of one VGG-16 forward."""
    tot = {key: sum(r[key] * r["layers"] for r in rows)
           for key in ("ms", "plain_ms", "library_ms", "b2b_ms", "copies_b2b_ms",
                       "b2b_library_ms", "bound_ms")}
    ops_ms = sum(r["bound_ms"] * r["layers"] for r in rows if r["bound_by"] == "operations")
    tot["bound_by"] = "operations" if ops_ms >= tot["bound_ms"] / 2 else "bytes"
    tot["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    return tot


def conv_floor(rows) -> None:
    """The redesigned bf16 conv against cuDNN in this run: the sum of single
    calls over one VGG-16 forward at most CONV_FLOOR x cuDNN's."""
    for dtype in DTYPES:
        tot = vgg_forward_summary(rows[dtype])
        print(f"conv2d VGG-16 {name_of(dtype)}: {tot['ms']:.3f} ms against cuDNN "
              f"{tot['library_ms']:.3f} ms ({tot['ms'] / tot['library_ms']:.2f}x); back to back "
              f"{tot['b2b_ms']:.3f} ms (re-layout {tot['copies_b2b_ms']:.3f} ms) against "
              f"{tot['b2b_library_ms']:.3f} ms ({tot['b2b_ms'] / tot['b2b_library_ms']:.2f}x); "
              f"bound {tot['bound_ms']:.3f} ms ({tot['bound_by']}), "
              f"{tot['bound_ms'] / tot['b2b_ms']:.1%} of it back to back")
    tot = vgg_forward_summary(rows[torch.bfloat16])
    ratio = tot["ms"] / tot["library_ms"]
    check(ratio <= CONV_FLOOR, f"bf16 VGG-16 conv at {ratio:.2f}x cuDNN (floor {CONV_FLOOR}x)")


def phase_b(gen) -> dict:
    """Full-width VGG-16 hybrid forward; returns launches per forward by dtype
    (the total and by route)."""
    net = vgg16(224)
    plan = HybridPlan(sp=4, n_micro=4)
    launches = {}
    for dtype in DTYPES:
        params = init_vgg(net, generator=gen, device="cuda", dtype=dtype)
        x = torch.randn((BATCH, 3, 224, 224), generator=gen, device="cuda").to(dtype)
        hybrid_forward(params, net, x, plan)  # warm-up
        torch.cuda.synchronize()
        walls = []
        want = {"direct": 1, "wgmma": 12} if dtype == torch.bfloat16 else \
            {"direct": 13, "wgmma": 0}
        for _ in range(3):
            conv2d.launches = 0
            conv2d.launches_by_route = dict.fromkeys(conv2d.launches_by_route, 0)
            t0 = time.perf_counter()
            out = hybrid_forward(params, net, x, plan)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            check(conv2d.launches == 13 and conv2d.launches_by_route == want,
                  f"{conv2d.launches} conv2d launches in one forward, by route "
                  f"{conv2d.launches_by_route}; expected 13, {want}")
        launches[dtype] = {"launches": conv2d.launches,
                           "launches_by_route": dict(conv2d.launches_by_route)}
        ref = forward(params, net, x, use_kernel=False)
        check(tuple(out.shape) == (BATCH, 512, 7, 7), f"output shape {tuple(out.shape)}")
        check(bool(torch.isfinite(out).all()), "non-finite forward output")
        err = ((out.float() - ref.float()).abs().max() / ref.float().abs().max()).item()
        check(err <= TOL[dtype], f"hybrid forward vs plain: normalised error {err:.3e}")
        wall = statistics.median(walls)
        print(f"B {str(dtype)[6:]:8s} VGG-16 224x224 N={BATCH} hybrid sp=4 n_micro=4: "
              f"normalised error {err:.3e}  launches {conv2d.launches} "
              f"{conv2d.launches_by_route}  "
              f"wall {wall:.3f} ms (median of {len(walls)})  {BATCH / wall * 1e3:.1f} images/s")
        del params, x, out, ref
    return launches


def group_net():
    """The width of VGG-16's second group: 4 x conv 128 (the pipelined head),
    pool, 2 x conv 256 at 112x112."""
    b = _B("vgg_group2", 112, 112, 128)
    for _ in range(4):
        b.conv(128, 3)
    b.pool(2)
    b.conv(256, 3).conv(256, 3)
    return b.done()


GROUP_PLAN = HybridPlan(sp=4, n_micro=4)


def phase_c(gen, keep: dict) -> None:
    """Pipelined head at the width of VGG-16's second group; its weights,
    input and output are kept on the host for phase Q."""
    net, plan = group_net(), GROUP_PLAN
    params = init_vgg(net, generator=gen, device="cuda")
    x = torch.randn((BATCH, 128, 112, 112), generator=gen, device="cuda")
    conv2d.launches = 0
    out = hybrid_forward(params, net, x, plan, pipelined=True)
    torch.cuda.synchronize()
    # every stage runs at each of n_micro + n_stages - 1 ticks, plus the tail
    expected = 4 * (plan.n_micro + 4 - 1) + 2
    check(conv2d.launches == expected,
          f"{conv2d.launches} conv2d launches in the pipelined run, expected {expected}")
    ref = forward(params, net, x, use_kernel=False)
    check(tuple(out.shape) == (BATCH, 256, 56, 56), f"output shape {tuple(out.shape)}")
    err = ((out - ref).abs().max() / ref.abs().max()).item()
    check(err <= TOL[torch.float32], f"pipelined head vs plain: normalised error {err:.3e}")
    print(f"C float32  group net (8,128,112,112) pipelined sp=4 n_micro=4: "
          f"normalised error {err:.3e}  launches {conv2d.launches}")
    keep["C"] = {"params": [None if w is None else w.cpu() for w in params], "x": x.cpu(),
                 "out": out.cpu()}


# ---------------------------------------------------------------------------
# The dense LM: StarCoder2-3B serving (phases D-F)
# ---------------------------------------------------------------------------

LM_ARCH = "starcoder2-3b"
HYBRID_ARCH = "zamba2-2.7b"
PREFILL_BATCH, PREFILL_SEQ = 4, 512
SLOTS, MAX_SEQ, N_REQUESTS = 4, 256, 8
LM_KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "matmul": ("src/repro_torch/kernels/matmul/csrc/matmul.cu",
               "src/repro/kernels/matmul/matmul.py:36"),
    "rmsnorm": ("src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm/rmsnorm.py:25"),
    "flash_attention": ("src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/flash_attention.py:82"),
    "ssd": ("src/repro_torch/kernels/ssd/csrc/ssd.cu", "src/repro/kernels/ssd/ssd.py:61"),
}
WRAPPERS = {"matmul": matmul, "rmsnorm": rmsnorm, "flash_attention": flash_attention,
            "ssd": ssd}
# Small shapes of the kernel tests: tests/test_kernels.py::MM_CASES (M, K, N)
# plus single rows; tests/test_serving.py's RMSNorm shapes; ATTN_CASES
# (b, s, h, kv, hd, causal, window) and queries shorter than keys
# (b, s, s_k, h, kv, hd, window); SSD_CASES (B, S, H, P, N, chunk) plus
# S < chunk.
MM_SMALL = [(256, 512, 256), (100, 300, 50), (64, 64, 64), (128, 1, 128), (33, 65, 17),
            (1, 200, 129), (1, 3072, 3072)]
RMS_SMALL = [(2, 16, 64), (1, 100, 128), (4, 7, 48)]
ATTN_SMALL = [(1, 128, 4, 2, 64, True, None), (2, 96, 4, 4, 32, True, None),
              (1, 256, 8, 2, 64, True, 64), (1, 64, 2, 2, 64, False, None),
              (1, 128, 6, 2, 48, True, None)]
ATTN_SHORT_Q = [(2, 40, 100, 4, 2, 32, None), (1, 70, 200, 6, 2, 48, 64)]
# The flash kernel's routes at each LM's heads (hd 128 in phase D, 80 in
# phase G), S not a multiple of the 128-row query block, S < Sk, a window:
# (b, s, s_k, causal, window), drawn from a generator of their own so that
# the later phases draw what they drew before.
ATTN_ROUTE_CASES = [(2, 200, 200, True, None), (1, 300, 420, True, None),
                    (1, 330, 330, True, 100), (1, 77, 77, False, None)]
ATTN_ROUTE_SEED = 16
ROUTE_NAMES = ("simt", "wgmma")
# bf16 flash attention per prefill, back to back, at most this times SDPA's
# in the same run: hd 128 (StarCoder2), hd 80 (Zamba2, whose PV runs at
# N = 128 over the zero-filled atom: 37.5 % of it wasted).
FLASH_FLOORS = {LM_ARCH: 2.0, HYBRID_ARCH: 3.0}
SSD_SMALL = [(2, 128, 4, 32, 16, 32), (1, 256, 2, 64, 32, 64), (1, 64, 8, 16, 64, 16),
             (1, 100, 3, 16, 8, 256)]
# The SSD's routes at Zamba2's heads (P = N = 64) in chunks of 64, 128 and
# 256 rows and S < chunk (q = 200, a ragged tile), then decays that overflow
# fp32 above the diagonal (a = -exp(3), dt in [1, 2]): (B, S, H, chunk, steep),
# drawn from a generator of their own so that the later phases draw what they
# drew before.
SSD_ROUTE_CASES = [(2, 512, 8, 64, False), (2, 512, 8, 128, False), (2, 512, 8, 256, False),
                   (1, 200, 4, 256, False), (2, 512, 8, 256, True)]
SSD_ROUTE_SEED = 17
# The bf16 SSD of Zamba2's prefill back to back at most this times its bytes
# bound; the bf16 RMSNorm of each LM's prefill back to back at most this
# times F.rms_norm's (both in this run).
SSD_BOUND_FLOOR = 10.0
RMS_FLOOR = 1.05


def normalised_err(out, ref) -> float:
    out, ref = out.float(), ref.float()
    check(bool(torch.isfinite(out).all()), "non-finite output")
    return ((out - ref).abs().max() / ref.abs().max()).item()


def name_of(dtype) -> str:
    return str(dtype)[6:]


def hybrid_dims(cfg) -> tuple[int, int, int]:
    """(groups, d_inner, SSD heads) of a hybrid config."""
    d_in = cfg.ssm.expansion * cfg.d_model
    return cfg.n_layers // cfg.shared_attn_every, d_in, d_in // cfg.ssm.head_dim


def lm_products(cfg) -> dict:
    """(K, N) -> how many products of that shape one forward (or decode step) makes."""
    hd = cfg.head_dim
    block = [(cfg.d_model, cfg.n_heads * hd), (cfg.d_model, cfg.n_kv * hd),
             (cfg.d_model, cfg.n_kv * hd), (cfg.n_heads * hd, cfg.d_model),
             (cfg.d_model, cfg.d_ff), (cfg.d_ff, cfg.d_model)]
    if cfg.gated_mlp:
        block.append((cfg.d_model, cfg.d_ff))
    per_model = [(kn, cfg.n_layers) for kn in block]
    if cfg.family == "hybrid":  # the attention block runs once per group
        groups, d_in, n_h = hybrid_dims(cfg)
        per_model = [(kn, groups) for kn in block]
        per_model += [(kn, cfg.n_layers) for kn in
                      [(cfg.d_model, 2 * d_in), (cfg.d_model, 2 * cfg.ssm.state_dim),
                       (cfg.d_model, n_h), (d_in, cfg.d_model)]]
    per_model.append(((cfg.d_model, cfg.vocab), 1))
    counts: dict = {}
    for kn, n in per_model:
        counts[kn] = counts.get(kn, 0) + n
    return counts


def lm_norms(cfg) -> dict:
    """D -> how many RMSNorms over rows of width D one forward (or tick) makes."""
    if cfg.family == "hybrid":
        groups, d_in, _ = hybrid_dims(cfg)
        return {cfg.d_model: cfg.n_layers + 2 * groups + 1, d_in: cfg.n_layers}
    return {cfg.d_model: 2 * cfg.n_layers + 1}


def expected_launches(cfg, decode: bool = False) -> dict:
    attn_blocks = hybrid_dims(cfg)[0] if cfg.family == "hybrid" else cfg.n_layers
    return {"matmul": sum(lm_products(cfg).values()), "rmsnorm": sum(lm_norms(cfg).values()),
            "flash_attention": 0 if decode else attn_blocks,
            "ssd": cfg.n_layers if cfg.family == "hybrid" and not decode else 0}


def reset_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
    matmul.launches_by_route = dict.fromkeys(matmul.launches_by_route, 0)
    flash_attention.launches_by_route = dict.fromkeys(flash_attention.launches_by_route, 0)
    ssd.launches_by_route = dict.fromkeys(ssd.launches_by_route, 0)


def check_flash_routes(where: str, route: str, n: int) -> None:
    """The run just counted made ``n`` flash launches, all on ``route``."""
    want = {name: n if name == route else 0 for name in ROUTE_NAMES}
    check(flash_attention.launches_by_route == want,
          f"{where}: flash routes {flash_attention.launches_by_route}, expected {want}")


def expected_flash_route(dtype) -> str:
    return "wgmma" if dtype == torch.bfloat16 else "simt"


def check_ssd_routes(where: str, route: str, n: int) -> None:
    """The run just counted made ``n`` SSD launches, all on ``route``."""
    want = {name: n if name == route else 0 for name in ROUTE_NAMES}
    check(ssd.launches_by_route == want,
          f"{where}: ssd routes {ssd.launches_by_route}, expected {want}")


def counted_ssd(args, chunk: int):
    """One SSD call that must launch once, on the route its plan names
    (bf16 wgmma, fp32 simt)."""
    x, _, _, b, c = args
    route = ssd_plan_for(x, b, c, min(chunk, x.shape[1]))
    check(route == expected_flash_route(x.dtype), f"ssd {x.dtype} planned {route}")
    before, by = ssd.launches, dict(ssd.launches_by_route)
    out = ssd(*args, chunk=chunk)
    check(ssd.launches == before + 1 and ssd.launches_by_route[route] == by[route] + 1,
          f"ssd routes {ssd.launches_by_route} (before {by}), expected one on {route}")
    return out, route


def counted_flash(q, k, v, causal: bool, window):
    """One flash-attention call that must launch once, on the route its plan names."""
    route = flash_plan_for(q, k, v)
    before, by = flash_attention.launches, dict(flash_attention.launches_by_route)
    out = flash_attention(q, k, v, causal=causal, window=window)
    check(flash_attention.launches == before + 1
          and flash_attention.launches_by_route[route] == by[route] + 1,
          f"flash routes {flash_attention.launches_by_route} (before {by}), expected one "
          f"on {route}")
    return out, route


def flash_route_cases(phase: str, cfg) -> None:
    """The flash kernel against its plain version at ``cfg``'s heads on
    ATTN_ROUTE_CASES, bf16 on wgmma and fp32 on simt, the plan printed."""
    gen = torch.Generator(device="cuda").manual_seed(ATTN_ROUTE_SEED)
    h, kv, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    for dtype in DTYPES:
        for b, s, sk, causal, win in ATTN_ROUTE_CASES:
            q = randn((b, s, h, hd), dtype, gen)
            k, v = randn((b, sk, kv, hd), dtype, gen), randn((b, sk, kv, hd), dtype, gen)
            out, route = counted_flash(q, k, v, causal, win)
            check(route == expected_flash_route(dtype), f"flash {dtype} planned {route}")
            err = max_err_within(out, attention_ref(q, k, v, causal=causal, window=win),
                                 TOL[dtype])
            print(f"{phase} {name_of(dtype):8s} flash B={b} S={s} Sk={sk} H={h} KV={kv} hd={hd} "
                  f"causal={causal} window={win}: {route}  max_abs_err {err:.3e}")


def check_wgmma(where: str) -> None:
    """Every bf16 product of the run just counted took the wgmma route."""
    check(matmul.launches_by_route["wgmma"] == matmul.launches,
          f"{where}: matmul routes {matmul.launches_by_route}, expected all "
          f"{matmul.launches} on wgmma")


def counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def n_params(params) -> int:
    """The real parameter count: the sum of numel over the weight tree."""
    return sum(t.numel() for t in tree.leaves(params))


def randn(shape, dtype, gen, scale: float = 1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)


def timed_row(kernel, plain, library, nbytes, ops, dtype, **shape) -> dict:
    """Kernel against its plain version on the same inputs, and the three times
    (``library`` None: no PyTorch call computes the same function)."""
    tol = TOL[dtype]
    out, ref = kernel(), plain()
    err = max_err_within(out, ref, tol)
    b_ms, b_by = least_ms(nbytes, ops, dtype)
    return dict(shape, max_abs_err=err, normalised_err=normalised_err(out, ref),
                ms=time_ms(kernel), plain_ms=time_ms(plain),
                library_ms=None if library is None else time_ms(library),
                bound_ms=b_ms, bound_by=b_by)


def print_row(phase: str, tag: str, dtype, desc: str, row: dict) -> None:
    lib = "none" if row["library_ms"] is None else f"{row['library_ms']:.4f} ms"
    extra = ""
    if "tile" in row:
        extra = f"  {row['route']} {row['tile']} splits {row['splits']}"
    elif "route" in row:
        extra = f"  {row['route']}"
    if "b2b_ms" in row:
        b2b_lib = row.get("b2b_library_ms")
        extra += (f"  back to back: kernel {row['b2b_ms']:.4f} ms  library "
                  + ("none" if b2b_lib is None else f"{b2b_lib:.4f} ms"))
    if "plan" in row:
        extra += f"  plan {row['plan']}"
    print(f"{phase} {name_of(dtype):8s} {tag:15s} {desc}: max_abs_err {row['max_abs_err']:.3e}  "
          f"kernel {row['ms']:.4f} ms  bound {row['bound_ms']:.4f} ms ({row['bound_by']})  "
          f"plain {row['plain_ms']:.4f} ms  library {lib}  "
          f"x{row['count']} per {row['per']}{extra}")


def lm_kernel_rows(cfg, gen, phase: str) -> dict:
    """matmul, RMSNorm and flash attention against their plain versions at every
    shape of ``cfg``'s prefill (batch 4 x 512) and decode tick (4 slots).

    Returns {kernel: {dtype: [rows]}}, each row with its count per prefill
    forward or per decode tick ("per").
    """
    rows_m = PREFILL_BATCH * PREFILL_SEQ
    out = {name: {} for name in ("matmul", "rmsnorm", "flash_attention")}
    for dtype in DTYPES:
        el = torch.finfo(dtype).bits // 8
        mm_rows = []
        for per, m in (("prefill", rows_m), ("decode tick", SLOTS)):
            for (k, n), count in lm_products(cfg).items():
                a, b = randn((m, k), dtype, gen), randn((k, n), dtype, gen, k ** -0.5)
                row = timed_row(lambda: matmul(a, b), lambda: matmul_ref(a, b),
                                lambda: torch.matmul(a, b), el * (m * k + k * n + m * n),
                                2 * m * k * n, dtype, m=m, k=k, n=n, count=count, per=per)
                bs = l2_copies(b)
                row.update(plan_for(a, b)._asdict(),
                           b2b_ms=b2b_ms(lambda i: matmul(a, bs[i % len(bs)])),
                           b2b_library_ms=b2b_ms(lambda i: torch.matmul(a, bs[i % len(bs)])))
                print_row(phase, "matmul", dtype, f"M={m} K={k} N={n}", row)
                mm_rows.append(row)
                del a, b, bs
        rms_rows = []
        for per, m in (("prefill", rows_m), ("decode tick", SLOTS)):
            for d, count in lm_norms(cfg).items():
                x, sc = randn((m, d), dtype, gen), randn((d,), dtype, gen)
                row = timed_row(lambda: rmsnorm(x, sc), lambda: rmsnorm_ref(x, sc),
                                lambda: F.rms_norm(x, (d,), sc, 1e-6),
                                el * (2 * m * d + d), 4 * m * d, dtype,
                                m=m, d=d, count=count, per=per)
                p = rms_plan_for(x, sc, x)
                row.update(b2b_ms=b2b_ms(lambda i: rmsnorm(x, sc)),
                           b2b_library_ms=b2b_ms(lambda i: F.rms_norm(x, (d,), sc, 1e-6)),
                           plan=f"{p.route} vpt {p.vpt} tpr {p.tpr} rows {p.rows} vec {p.vec}")
                print_row(phase, "rmsnorm", dtype, f"rows={m} D={d}", row)
                rms_rows.append(row)
        b, s, h, kv, hd = PREFILL_BATCH, PREFILL_SEQ, cfg.n_heads, cfg.n_kv, cfg.head_dim
        q = randn((b, s, h, hd), dtype, gen)
        k, v = randn((b, s, kv, hd), dtype, gen), randn((b, s, kv, hd), dtype, gen)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)

        row = timed_row(lambda: flash_attention(q, k, v, causal=True),
                        lambda: attention_ref(q, k, v, causal=True), sdpa,
                        el * (2 * q.numel() + k.numel() + v.numel()),
                        4 * b * h * s * s * hd / 2, dtype, b=b, s=s, sk=s, h=h, kv=kv, hd=hd,
                        count=expected_launches(cfg)["flash_attention"], per="prefill")
        route = flash_plan_for(q, k, v)
        check(route == expected_flash_route(dtype), f"flash {dtype} planned {route}")
        row.update(route=route, b2b_ms=b2b_ms(lambda i: flash_attention(q, k, v, causal=True)),
                   b2b_library_ms=b2b_ms(lambda i: sdpa()))
        print_row(phase, "flash_attention", dtype,
                  f"B={b} S=Sk={s} H={h} KV={kv} hd={hd} causal", row)
        out["matmul"][dtype], out["rmsnorm"][dtype] = mm_rows, rms_rows
        out["flash_attention"][dtype] = [row]
        del q, k, v, qt, kt, vt
    return out


def phase_d(gen) -> dict:
    """LM kernels against their plain versions at the small test shapes and at
    every StarCoder2-3B serving shape, with times and bounds."""
    for dtype in DTYPES:
        for m, k, n in MM_SMALL:
            a, b = randn((m, k), dtype, gen), randn((k, n), dtype, gen, k ** -0.5)
            err = max_err_within(matmul(a, b), matmul_ref(a, b), TOL[dtype])
            print(f"D {name_of(dtype):8s} matmul M={m} K={k} N={n}: max_abs_err {err:.3e}")
        for shape in RMS_SMALL:
            x, sc = randn(shape, dtype, gen), randn(shape[-1:], dtype, gen)
            err = max_err_within(rmsnorm(x, sc), rmsnorm_ref(x, sc), TOL[dtype])
            print(f"D {name_of(dtype):8s} rmsnorm {shape}: max_abs_err {err:.3e}")
        cases = [(b, s, s, h, kv, hd, c, w) for b, s, h, kv, hd, c, w in ATTN_SMALL]
        cases += [(b, s, sk, h, kv, hd, True, w) for b, s, sk, h, kv, hd, w in ATTN_SHORT_Q]
        for b, s, sk, h, kv, hd, causal, win in cases:
            q = randn((b, s, h, hd), dtype, gen)
            k, v = randn((b, sk, kv, hd), dtype, gen), randn((b, sk, kv, hd), dtype, gen)
            out, route = counted_flash(q, k, v, causal, win)
            err = max_err_within(out, attention_ref(q, k, v, causal=causal, window=win),
                                 TOL[dtype])
            print(f"D {name_of(dtype):8s} flash B={b} S={s} Sk={sk} H={h} KV={kv} hd={hd} "
                  f"causal={causal} window={win}: {route}  max_abs_err {err:.3e}")
    cfg = get_config(LM_ARCH)
    flash_route_cases("D", cfg)
    print_host_path("D", cfg)
    return lm_kernel_rows(cfg, gen, "D")


def host_us_per_call(fn, calls: int = 200) -> float:
    """Host time of one call, queued without waiting for the device."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def print_host_path(phase: str, cfg) -> None:
    """Host microseconds per wrapper call on the decode tick's first
    projection (matmul) and its norm over d_model (RMSNorm), beside
    torch.matmul's and F.rms_norm's (operands from a generator of their own,
    so the seeded draws of the later phases do not move)."""
    k, n = next(iter(lm_products(cfg)))
    gen = torch.Generator(device="cuda").manual_seed(1)
    a, b = randn((SLOTS, k), torch.bfloat16, gen), randn((k, n), torch.bfloat16, gen)
    print(f"{phase} bfloat16 matmul host path M={SLOTS} K={k} N={n}: wrapper "
          f"{host_us_per_call(lambda: matmul(a, b)):.1f} us per call, torch.matmul "
          f"{host_us_per_call(lambda: torch.matmul(a, b)):.1f} us per call")
    d = cfg.d_model
    x, sc = randn((SLOTS, d), torch.bfloat16, gen), randn((d,), torch.bfloat16, gen)
    print(f"{phase} bfloat16 rmsnorm host path rows={SLOTS} D={d}: wrapper "
          f"{host_us_per_call(lambda: rmsnorm(x, sc)):.1f} us per call, F.rms_norm "
          f"{host_us_per_call(lambda: F.rms_norm(x, (d,), sc, 1e-6)):.1f} us per call")


def lm_summary(rows, per: str) -> dict:
    """Per-shape numbers summed over one prefill forward or one decode tick."""
    rows = [r for r in rows if r["per"] == per]
    keys = ("ms", "plain_ms", "bound_ms") + tuple(
        key for key in ("b2b_ms", "b2b_library_ms") if rows[0].get(key) is not None)
    tot = {key: sum(r[key] * r["count"] for r in rows) for key in keys}
    if "route" in rows[0]:
        tot["routes"] = {route: sum(r["count"] for r in rows if r["route"] == route)
                         for route in ROUTE_NAMES}
    tot["library_ms"] = (None if any(r["library_ms"] is None for r in rows)
                         else sum(r["library_ms"] * r["count"] for r in rows))
    ops_ms = sum(r["bound_ms"] * r["count"] for r in rows if r["bound_by"] == "operations")
    tot["bound_by"] = "operations" if ops_ms >= tot["bound_ms"] / 2 else "bytes"
    tot["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    return tot


def phase_e(gen):
    """Full-width StarCoder2-3B prefill; returns (params, cfg, launches per
    forward, the median wall of a forward in ms)."""
    cfg = get_config(LM_ARCH)
    params = transformer.init_lm(cfg, generator=gen, device="cuda", dtype=torch.bfloat16)
    tokens = torch.randint(0, cfg.vocab, (PREFILL_BATCH, PREFILL_SEQ), generator=gen,
                           device="cuda")
    batch = {"tokens": tokens}
    want = expected_launches(cfg)
    with torch.inference_mode():
        api.prefill_logits(params, cfg, batch)  # warm-up
        torch.cuda.synchronize()
        walls = []
        for _ in range(3):
            reset_counts()
            t0 = time.perf_counter()
            logits = api.prefill_logits(params, cfg, batch)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            got = counts()
            check(got == want, f"prefill launches {got}, expected {want}")
            check_wgmma("StarCoder2 prefill")
            check_flash_routes("StarCoder2 prefill", "wgmma", want["flash_attention"])
            got["matmul_routes"] = dict(matmul.launches_by_route)
            got["flash_attention_routes"] = dict(flash_attention.launches_by_route)
        ref = api.prefill_logits(params, cfg, batch, use_kernel=False)
    check(tuple(logits.shape) == (PREFILL_BATCH, PREFILL_SEQ, cfg.vocab),
          f"logits shape {tuple(logits.shape)}")
    check(logits.dtype == torch.float32, f"logits dtype {logits.dtype}")
    err = normalised_err(logits, ref)
    check(err <= TOL[torch.bfloat16], f"prefill vs plain: normalised error {err:.3e}")
    wall = statistics.median(walls)
    tokens_n = PREFILL_BATCH * PREFILL_SEQ
    print(f"E bfloat16 {LM_ARCH} prefill B={PREFILL_BATCH} S={PREFILL_SEQ} "
          f"({cfg.n_layers} layers, {n_params(params) / 1e9:.3f} B params): normalised error "
          f"{err:.3e}  launches {got}  wall {wall:.3f} ms (median of {len(walls)})  "
          f"{tokens_n / wall * 1e3:.1f} tokens/s")
    del logits, ref, tokens
    return params, cfg, got, wall


def serving_requests(cfg) -> list:
    rng = np.random.default_rng(0)
    return [Request(rid=i, prompt=[int(t) for t in rng.integers(0, cfg.vocab,
                                                                 int(rng.integers(16, 65)))],
                    max_new=int(rng.integers(8, 17))) for i in range(N_REQUESTS)]


def phase_f(params, cfg) -> dict:
    """Full-width continuous-batching serving; returns launches over the counted ticks."""
    reqs = serving_requests(cfg)
    want = expected_launches(cfg, decode=True)
    b = ContinuousBatcher(cfg, params, slots=SLOTS, max_seq=MAX_SEQ, device="cuda")
    for r in reqs:
        b.submit(r)
    ticks, total = [], {name: 0 for name in WRAPPERS}
    total["matmul_routes"] = dict.fromkeys(matmul.launches_by_route, 0)
    max_logit_err = max_cache_err = 0.0
    while True:
        if b.steps < 4:  # the kernel decode step against the plain one, on the same cache
            b._admit()
            toks, pos = b._gather_inputs()
            with torch.inference_mode():
                lk, ck = api.decode_step(params, cfg, b.cache, toks, pos)
                lp, cp = api.decode_step(params, cfg, b.cache, toks, pos, use_kernel=False)
            e_logits = normalised_err(lk, lp)
            e_cache = max(normalised_err(ck[key], cp[key]) for key in ("k", "v"))
            check(e_logits <= TOL[torch.bfloat16] and e_cache <= TOL[torch.bfloat16],
                  f"decode tick {b.steps}: kernel vs plain logits {e_logits:.3e}, "
                  f"cache {e_cache:.3e}")
            max_logit_err, max_cache_err = max(max_logit_err, e_logits), max(max_cache_err,
                                                                              e_cache)
            del lk, ck, lp, cp
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        if not b.step():  # the tick's argmax reaches the host, so the step has ended
            break
        ticks.append((time.perf_counter() - t0) * 1e3)
        got = counts()
        check(got == want, f"tick {b.steps}: launches {got}, expected {want}")
        check_wgmma(f"{cfg.name} tick {b.steps}")
        for name in WRAPPERS:
            total[name] += got[name]
        for route, n in matmul.launches_by_route.items():
            total["matmul_routes"][route] += n
    done = {c.rid: c for c in b.done}
    check(sorted(done) == [r.rid for r in reqs], f"completed {sorted(done)}")
    check(all(len(done[r.rid].tokens) == r.max_new for r in reqs), "a request stopped early")

    plain = ContinuousBatcher(cfg, params, slots=SLOTS, max_seq=MAX_SEQ, device="cuda",
                              use_kernel=False)
    for r in reqs:
        plain.submit(r)
    plain_done = {c.rid: c for c in plain.run()}
    check((plain.steps, plain.utilization) == (b.steps, b.utilization),
          f"steps/utilization {b.steps}/{b.utilization} vs plain "
          f"{plain.steps}/{plain.utilization}")
    same = sum(a == c for r in reqs
               for a, c in zip(done[r.rid].tokens, plain_done[r.rid].tokens))
    generated = sum(r.max_new for r in reqs)
    wall = sum(ticks)
    print(f"F bfloat16 {LM_ARCH} serving {N_REQUESTS} requests on {SLOTS} slots: "
          f"{b.steps} ticks  utilization {b.utilization:.4f} (plain route "
          f"{plain.utilization:.4f})  launches per tick {want}  decode vs plain on ticks 0-3: "
          f"logits {max_logit_err:.3e}, cache {max_cache_err:.3e}  tokens equal to the plain "
          f"route {same}/{generated}")
    print(f"F bfloat16 tick {statistics.median(ticks):.3f} ms (median), "
          f"{wall / len(ticks):.3f} ms (mean); {generated} generated tokens in {wall:.1f} ms "
          f"= {generated / wall * 1e3:.1f} generated tokens/s, "
          f"{b.busy_slot_steps / wall * 1e3:.1f} slot-tokens/s")
    return dict(total, ticks=b.steps, per_tick=want)


# ---------------------------------------------------------------------------
# The hybrid LM: Zamba2-2.7B serving (phases G-I)
# ---------------------------------------------------------------------------


def ssd_inputs(b, s, h, p, n, dtype, gen):
    """x, dt (softplus-like range), a_log, b, c as tests/test_kernels.py draws them."""
    dt = 0.1 + 0.9 * torch.rand((b, s, h), generator=gen, device="cuda")
    a_log = -1.0 + 1.5 * torch.rand((h,), generator=gen, device="cuda")
    return (randn((b, s, h, p), dtype, gen, 0.5), dt, a_log, randn((b, s, n), dtype, gen, 0.3),
            randn((b, s, n), dtype, gen, 0.3))


def ssd_work(b, s, h, p, n, chunk, dtype) -> tuple[float, float]:
    """(bytes, operations) of one SSD call: x, b, c read and y written in the
    input dtype, dt and a in fp32. Per (batch, head, chunk): C B^T and its
    product with xdt on the causal triangle only (L is 0 above the
    diagonal), Q(Q + 1)/2 dot products of N and of P, Q(Q + 1)(N + P)
    operations; C state^T and the state update, 4QPN."""
    el = torch.finfo(dtype).bits // 8
    q = min(chunk, s)
    nbytes = el * (2 * b * s * h * p + 2 * b * s * n) + 4 * (b * s * h + h)
    return nbytes, b * h * (s // q) * (q * (q + 1) * (n + p) + 4 * q * p * n)


def ssd_route_cases(phase: str, cfg) -> None:
    """The SSD kernel against ssd_ref at ``cfg``'s heads on SSD_ROUTE_CASES,
    bf16 on wgmma and fp32 on simt; the steep case must stay finite."""
    gen = torch.Generator(device="cuda").manual_seed(SSD_ROUTE_SEED)
    p, n = cfg.ssm.head_dim, cfg.ssm.state_dim
    for dtype in DTYPES:
        for b, s, h, chunk, steep in SSD_ROUTE_CASES:
            x, dt, a_log, bb, cc = ssd_inputs(b, s, h, p, n, dtype, gen)
            if steep:
                dt, a_log = dt + 1.0, torch.full_like(a_log, 3.0)
            args = (x, dt, a_log, bb, cc)
            out, route = counted_ssd(args, chunk)
            ref = ssd_ref(*args, chunk=chunk)
            err = max_err_within(out, ref, TOL[dtype])
            print(f"{phase} {name_of(dtype):8s} ssd B={b} S={s} H={h} P={p} N={n} chunk={chunk}"
                  f"{' steep' if steep else ''}: {route}  max_abs_err {err:.3e}  normalised "
                  f"{normalised_err(out, ref):.3e}")


def device_us_by_kernel(fn, calls: int = 20) -> dict:
    """Device microseconds a call of ``fn`` by CUDA kernel name, from
    ``torch.profiler`` over ``calls`` calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out: dict = {}
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA and ev.device_time_total:
            name = ev.key.replace("(anonymous namespace)::", "").split("(")[0]
            head, _, args = name.partition("<")
            name = head.split("::")[-1]
            if name.startswith("Kernel") and args:  # cutlass::Kernel2<the_gemm_name>: name it
                name = args.split(",")[0].rstrip(">").split("::")[-1]
            out[name] = out.get(name, 0.0) + ev.device_time_total / calls
    return out


def ssd_host_path(phase: str, shape, chunk: int) -> None:
    """Host microseconds per SSD wrapper call at ``shape`` (bf16, inputs from a
    generator of their own)."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    args = ssd_inputs(*shape, torch.bfloat16, gen)
    print(f"{phase} bfloat16 ssd host path B={shape[0]} S={shape[1]} H={shape[2]} "
          f"P={shape[3]} N={shape[4]} chunk={chunk}: wrapper "
          f"{host_us_per_call(lambda: ssd(*args, chunk=chunk), calls=50):.1f} us per call")


def phase_g(gen) -> dict:
    """The SSD kernel against ssd_ref, and the LM kernels at Zamba2's shapes."""
    for dtype in DTYPES:
        for b, s, h, p, n, chunk in SSD_SMALL:
            args = ssd_inputs(b, s, h, p, n, dtype, gen)
            (out, route), ref = counted_ssd(args, chunk), ssd_ref(*args, chunk=chunk)
            err = max_err_within(out, ref, TOL[dtype])
            print(f"G {name_of(dtype):8s} ssd B={b} S={s} H={h} P={p} N={n} chunk={chunk}: "
                  f"{route}  max_abs_err {err:.3e}  normalised {normalised_err(out, ref):.3e}")
    x, dt, _, b, c = ssd_inputs(1, 128, 2, 16, 8, torch.float32, gen)
    a_log = torch.zeros(2, device="cuda")
    o32, o128 = ssd(x, dt, a_log, b, c, chunk=32), ssd(x, dt, a_log, b, c, chunk=128)
    diff = (o32 - o128).abs().max().item()
    check(diff <= 1e-4, f"ssd chunk 32 against chunk 128: max |diff| {diff:.3e}")
    print(f"G float32  ssd chunk invariance (1, 128, 2, 16, N=8), chunk 32 vs 128: "
          f"max |diff| {diff:.3e}")

    cfg = get_config(HYBRID_ARCH)
    flash_route_cases("G", cfg)
    ssd_route_cases("G", cfg)
    _, _, n_h = hybrid_dims(cfg)
    sc = cfg.ssm
    shape = (PREFILL_BATCH, PREFILL_SEQ, n_h, sc.head_dim, sc.state_dim)
    ssd_host_path("G", shape, sc.chunk)
    print_host_path("G", cfg)
    rows = {}
    for dtype in DTYPES:
        args = ssd_inputs(*shape, dtype, gen)
        route = counted_ssd(args, sc.chunk)[1]
        row = timed_row(lambda: ssd(*args, chunk=sc.chunk),
                        lambda: ssd_ref(*args, chunk=sc.chunk), None,
                        *ssd_work(*shape, sc.chunk, dtype), dtype, shape=shape, chunk=sc.chunk,
                        count=cfg.n_layers, per="prefill")
        # copies of the inputs, cycled, so that each call reads them from
        # device memory as each layer's call does
        copies = cold_copies(args)
        row.update(route=route,
                   b2b_ms=b2b_ms(lambda i: ssd(*copies[i % len(copies)], chunk=sc.chunk)))
        print_row("G", "ssd", dtype, "B={} S={} H={} P={} N={} chunk={}".format(
            *shape, sc.chunk) + f" (normalised {row['normalised_err']:.3e})", row)
        split = device_us_by_kernel(lambda: ssd(*args, chunk=sc.chunk))
        print(f"G {name_of(dtype):8s} ssd device us a call by kernel (torch.profiler): "
              + "  ".join(f"{k} {us:.1f}" for k, us in split.items()))
        rows[dtype] = [row]
        del args, copies
    return {"ssd": rows, **lm_kernel_rows(cfg, gen, "G")}


def cast_tree(params, dtype):
    return tree.map_tree(lambda t: t.to(dtype), params)


def run_blocks(blocks, x) -> tuple[list, tuple, tuple]:
    """Drive blocks [(name, fn(h, use_kernel) -> (output, *new cache lines))]
    from x three ways: the kernel route and the plain route, each on the
    plain route's output of the block before, for [(name, largest normalised
    error over the block's outputs)]; and the kernel route alone, block after
    block. Returns (errors, (final output, {name: new cache lines}) of the
    kernel chain, the same of the plain chain). The callers hold both chains
    against the model's own entry point, so the per-block gate covers the
    blocks of the path that is timed, not a copy of its wiring."""
    errs, xk, xp, lines_k, lines_p = [], x, x, {}, {}
    for name, fn in blocks:
        out, ref = fn(xp, True), fn(xp, False)
        errs.append((name, max(normalised_err(a, b) for a, b in zip(out, ref))))
        xp, lines_p[name] = ref[0], ref[1:]
        out = fn(xk, True)
        xk, lines_k[name] = out[0], out[1:]
    return errs, (xk, lines_k), (xp, lines_p)


def hybrid_blocks(params, cfg) -> list:
    """The hybrid forward (recurrent.zamba_forward) after the embedding, block
    by block: [(name, fn(h, use_kernel) -> (output,))], the head last."""
    shared, blocks = params["shared"], []

    def norm(h, key, uk, tree=shared):
        return layers.rms_norm(h, tree[key], use_kernel=uk)

    for g in range(hybrid_dims(cfg)[0]):
        gp = transformer.layer(params["mamba"], g)
        for i in range(cfg.shared_attn_every):
            blocks.append((f"mamba {g}.{i}", lambda h, uk, mp=transformer.layer(gp, i): (
                h + ssm.mamba2_apply(norm(h, "mamba_ln", uk, params), mp, cfg.ssm,
                                     use_kernel=uk),)))
        blocks.append((f"attention {g}", lambda h, uk: (h + layers.gqa_attention(
            norm(h, "ln1", uk), shared["attn"], cfg.n_heads, cfg.n_kv, rope=cfg.rope,
            rope_theta=cfg.rope_theta, attn_fn=flash_attn_fn if uk else None,
            use_kernel=uk),)))
        blocks.append((f"mlp {g}", lambda h, uk: (h + layers.mlp(
            norm(h, "ln2", uk), shared["mlp"], cfg.activation, use_kernel=uk),)))
    blocks.append(("head", lambda h, uk: (layers.linear(
        norm(h, "ln_f", uk, params), params["lm_head"], uk).float(),)))
    return blocks


def hybrid_block_errors(params, cfg, tokens, dtype, logits, plain) -> tuple[list, float]:
    """Every block of the hybrid forward and the head, the kernel route and the
    plain route fed the same input (the plain route's residual stream):
    ([(block, normalised error of its output)], the larger normalised
    difference of the kernel chain's logits from ``logits`` and the plain
    chain's from ``plain``, api.prefill_logits' on the two routes)."""
    errs, (xk, _), (xp, _) = run_blocks(hybrid_blocks(params, cfg),
                                        params["embed"][tokens].to(dtype))
    return errs, max(normalised_err(xk, logits), normalised_err(xp, plain))


def phase_h(gen):
    """Full-width Zamba2-2.7B prefill; returns (params, cfg, launches per forward)."""
    cfg = get_config(HYBRID_ARCH)
    params = api.init_params(cfg, generator=gen, device="cuda", dtype=torch.bfloat16)
    tokens = torch.randint(0, cfg.vocab, (PREFILL_BATCH, PREFILL_SEQ), generator=gen,
                           device="cuda")
    batch = {"tokens": tokens}
    want = expected_launches(cfg)
    with torch.inference_mode():
        api.prefill_logits(params, cfg, batch)  # warm-up
        torch.cuda.synchronize()
        walls = []
        for _ in range(3):
            reset_counts()
            t0 = time.perf_counter()
            logits = api.prefill_logits(params, cfg, batch)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            got = counts()
            check(got == want, f"prefill launches {got}, expected {want}")
            check_wgmma("Zamba2 prefill")
            check_flash_routes("Zamba2 prefill", "wgmma", want["flash_attention"])
            check_ssd_routes("Zamba2 prefill", "wgmma", want["ssd"])
            got["matmul_routes"] = dict(matmul.launches_by_route)
            got["flash_attention_routes"] = dict(flash_attention.launches_by_route)
            got["ssd_routes"] = dict(ssd.launches_by_route)
        plain16 = api.prefill_logits(params, cfg, batch, use_kernel=False)
        err16 = normalised_err(logits, plain16)
        blocks16, chain16 = hybrid_block_errors(params, cfg, tokens, torch.bfloat16, logits,
                                                plain16)
        params32 = cast_tree(params, torch.float32)
        reset_counts()
        out32 = api.prefill_logits(params32, cfg, batch, compute_dtype=torch.float32)
        check_flash_routes("Zamba2 fp32 prefill", "simt", want["flash_attention"])
        check_ssd_routes("Zamba2 fp32 prefill", "simt", want["ssd"])
        plain32 = api.prefill_logits(params32, cfg, batch, compute_dtype=torch.float32,
                                     use_kernel=False)
        err32 = normalised_err(out32, plain32)
        blocks32, chain32 = hybrid_block_errors(params32, cfg, tokens, torch.float32, out32,
                                                plain32)
        # the model's own conditioning: the plain fp32 route against itself,
        # its embeddings nudged by a relative 1e-6
        nudged = dict(params32, embed=params32["embed"] * (
            1 + 1e-6 * torch.randn(params32["embed"].shape, generator=gen, device="cuda")))
        sens32 = normalised_err(api.prefill_logits(nudged, cfg, batch,
                                                   compute_dtype=torch.float32,
                                                   use_kernel=False), plain32)
        del params32, out32, nudged, plain32, plain16
    check(tuple(logits.shape) == (PREFILL_BATCH, PREFILL_SEQ, cfg.vocab),
          f"logits shape {tuple(logits.shape)}")
    check(logits.dtype == torch.float32, f"logits dtype {logits.dtype}")
    check(bool(torch.isfinite(logits).all()), "non-finite logits")
    wall = statistics.median(walls)
    tokens_n = PREFILL_BATCH * PREFILL_SEQ
    groups = hybrid_dims(cfg)[0]
    print(f"H bfloat16 {HYBRID_ARCH} prefill B={PREFILL_BATCH} S={PREFILL_SEQ} "
          f"({cfg.n_layers} Mamba2 layers + {groups} shared-attention blocks, "
          f"{n_params(params) / 1e9:.3f} B params; cfg.param_count() says "
          f"{cfg.param_count() / 1e9:.3f} B): launches {got}  wall {wall:.3f} ms "
          f"(median of {len(walls)})  {tokens_n / wall * 1e3:.1f} tokens/s")
    for (name, e16), (_, e32) in zip(blocks16[:cfg.shared_attn_every + 2], blocks32):
        print(f"H block {name:12s} kernel vs plain, same input: bf16 {e16:.3e}  fp32 {e32:.3e}")
    max16, max32 = max(e for _, e in blocks16), max(e for _, e in blocks32)
    print(f"H all {len(blocks16) - 1} blocks and the head, same input: max bf16 {max16:.3e} "
          f"({max(blocks16, key=lambda t: t[1])[0]}), max fp32 {max32:.3e} "
          f"({max(blocks32, key=lambda t: t[1])[0]})")
    print(f"H the blocks chained against api.prefill_logits on each route: bf16 "
          f"{chain16:.3e}  fp32 {chain32:.3e}")
    check(max(chain16, chain32) <= SAME,
          f"the blocks chained differ from api.prefill_logits: {chain16:.3e}, {chain32:.3e}")
    print(f"H end to end, kernel route against plain route (not gated): bf16 {err16:.3e}  "
          f"fp32 {err32:.3e}; plain fp32 route against itself, embeddings nudged by 1e-6: "
          f"{sens32:.3e}")
    check(max16 <= TOL[torch.bfloat16] and max32 <= TOL[torch.float32],
          f"a block's kernel route misses its plain route: bf16 {max16:.3e}, fp32 {max32:.3e}")
    del logits, tokens
    return params, cfg, got


def hybrid_decode_blocks(params, cfg, cache, pos) -> list:
    """One hybrid decode step (recurrent.zamba_decode_step) after the
    embedding, block by block: [(name, fn(h, use_kernel) -> (output, *new
    cache lines))], the head last."""
    shared, blocks = params["shared"], []

    def norm(h, key, uk, tree=shared):
        return layers.rms_norm(h, tree[key], use_kernel=uk)

    def mamba(h, uk, mp, g, i):
        y, conv, state = ssm.mamba2_decode(norm(h, "mamba_ln", uk, params), mp, cfg.ssm,
                                           cache["conv"][g, i], cache["ssm"][g, i],
                                           use_kernel=uk)
        return h + y, conv, state

    def attention(h, uk, g):
        out, k, v = layers.gqa_decode_attention(
            norm(h, "ln1", uk), shared["attn"], cfg.n_heads, cfg.n_kv, cache["k"][g],
            cache["v"][g], pos, rope=cfg.rope, rope_theta=cfg.rope_theta, use_kernel=uk)
        return h + out, k, v

    for g in range(hybrid_dims(cfg)[0]):
        gp = transformer.layer(params["mamba"], g)
        for i in range(cfg.shared_attn_every):
            blocks.append((f"mamba {g}.{i}", lambda h, uk, mp=transformer.layer(gp, i), g=g,
                           i=i: mamba(h, uk, mp, g, i)))
        blocks.append((f"attention {g}", lambda h, uk, g=g: attention(h, uk, g)))
        blocks.append((f"mlp {g}", lambda h, uk: (h + layers.mlp(
            norm(h, "ln2", uk), shared["mlp"], cfg.activation, use_kernel=uk),)))
    blocks.append(("head", lambda h, uk: (layers.linear(
        norm(h, "ln_f", uk, params)[:, 0], params["lm_head"], uk).float(),)))
    return blocks


def hybrid_decode_block_errors(params, cfg, cache, toks, pos, step, plain) -> tuple[list, float]:
    """Every block of one hybrid decode step and the head, the kernel route and
    the plain route fed the same input and the same cache lines: ([(block,
    largest normalised error over its output and new cache lines)], the
    largest normalised difference of the kernel chain's logits and cache
    lines from ``step`` and the plain chain's from ``plain``, the (logits,
    new cache) of api.decode_step on the two routes)."""
    errs, *chains = run_blocks(hybrid_decode_blocks(params, cfg, cache, pos),
                               params["embed"][toks].to(torch.bfloat16))
    pairs = []
    for (x, lines), (logits, new) in zip(chains, (step, plain)):
        pairs.append((x, logits))
        for g in range(hybrid_dims(cfg)[0]):
            for i in range(cfg.shared_attn_every):
                conv, state = lines[f"mamba {g}.{i}"]
                pairs += [(conv, new["conv"][g, i]), (state, new["ssm"][g, i])]
            k, v = lines[f"attention {g}"]
            pairs += [(k, new["k"][g]), (v, new["v"][g])]
    return errs, max(normalised_err(a, b) for a, b in pairs)


def phase_i(params, cfg) -> dict:
    """Full-width Zamba2 continuous batching; returns launches over the counted ticks."""
    reqs = serving_requests(cfg)
    want = expected_launches(cfg, decode=True)
    b = ContinuousBatcher(cfg, params, slots=SLOTS, max_seq=MAX_SEQ, device="cuda")
    for r in reqs:
        b.submit(r)
    ticks, total = [], {name: 0 for name in WRAPPERS}
    total["matmul_routes"] = dict.fromkeys(matmul.launches_by_route, 0)
    errs = {key: 0.0 for key in ("logits", "conv", "ssm", "k", "v")}
    block_err, chain_err, admitted_later = ("", 0.0), 0.0, 0
    while True:
        b._admit()
        for slot, st in enumerate(b.active):  # a slot reused: its recurrent state is zero
            if st is not None and b.steps > 0 and st["start_step"] == b.steps:
                admitted_later += 1
                check(bool((b.cache["conv"][:, :, slot] == 0).all())
                      and bool((b.cache["ssm"][:, :, slot] == 0).all()),
                      f"slot {slot}, admitted at tick {b.steps}, starts from a used state")
        if b.steps < 4:  # the kernel decode step against the plain one, on the same cache
            toks, pos = b._gather_inputs()
            with torch.inference_mode():
                lk, ck = api.decode_step(params, cfg, b.cache, toks, pos)
                lp, cp = api.decode_step(params, cfg, b.cache, toks, pos, use_kernel=False)
                blocks, chained = hybrid_decode_block_errors(params, cfg, b.cache, toks, pos,
                                                             (lk, ck), (lp, cp))
            check(chained <= SAME, f"decode tick {b.steps}: the blocks chained differ from "
                  f"api.decode_step by {chained:.3e}")
            chain_err = max(chain_err, chained)
            tick = {"logits": normalised_err(lk, lp),
                    **{key: normalised_err(ck[key], cp[key]) for key in ck}}
            errs = {key: max(errs[key], tick[key]) for key in errs}
            worst = max(blocks, key=lambda t: t[1])
            check(worst[1] <= TOL[torch.bfloat16],
                  f"decode tick {b.steps}: block {worst[0]}, kernel vs plain {worst[1]:.3e}")
            block_err = max(block_err, worst, key=lambda t: t[1])
            del lk, ck, lp, cp
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        if not b.step():  # the tick's argmax reaches the host, so the step has ended
            break
        ticks.append((time.perf_counter() - t0) * 1e3)
        got = counts()
        check(got == want, f"tick {b.steps}: launches {got}, expected {want}")
        check_wgmma(f"{cfg.name} tick {b.steps}")
        for name in WRAPPERS:
            total[name] += got[name]
        for route, n in matmul.launches_by_route.items():
            total["matmul_routes"][route] += n
    done = {c.rid: c for c in b.done}
    check(sorted(done) == [r.rid for r in reqs], f"completed {sorted(done)}")
    check(all(len(done[r.rid].tokens) == r.max_new for r in reqs), "a request stopped early")
    check(admitted_later == N_REQUESTS - SLOTS,
          f"{admitted_later} admissions after tick 0, expected {N_REQUESTS - SLOTS}")

    plain = ContinuousBatcher(cfg, params, slots=SLOTS, max_seq=MAX_SEQ, device="cuda",
                              use_kernel=False)
    for r in reqs:
        plain.submit(r)
    plain_done = {c.rid: c for c in plain.run()}
    check((plain.steps, plain.utilization) == (b.steps, b.utilization),
          f"steps/utilization {b.steps}/{b.utilization} vs plain "
          f"{plain.steps}/{plain.utilization}")
    same = sum(a == c for r in reqs
               for a, c in zip(done[r.rid].tokens, plain_done[r.rid].tokens))
    generated = sum(r.max_new for r in reqs)
    wall = sum(ticks)
    print(f"I bfloat16 {HYBRID_ARCH} serving {N_REQUESTS} requests on {SLOTS} slots: "
          f"{b.steps} ticks  utilization {b.utilization:.4f} (plain route "
          f"{plain.utilization:.4f})  launches per tick {want}  {admitted_later} slots reused, "
          f"each from a zero state  decode vs plain on ticks 0-3, every block fed the same "
          f"input and cache lines: max {block_err[1]:.3e} ({block_err[0]}), the blocks "
          f"chained against api.decode_step {chain_err:.3e}; end to end (not "
          f"gated): " + "  ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f"  tokens equal to the plain route {same}/{generated}")
    print(f"I bfloat16 tick {statistics.median(ticks):.3f} ms (median), "
          f"{wall / len(ticks):.3f} ms (mean); {generated} generated tokens in {wall:.1f} ms "
          f"= {generated / wall * 1e3:.1f} generated tokens/s, "
          f"{b.busy_slot_steps / wall * 1e3:.1f} slot-tokens/s")
    return dict(total, ticks=b.steps, per_tick=want)


# ---------------------------------------------------------------------------
# The DSE screen on the card (phase J)
# ---------------------------------------------------------------------------

SCREEN_INPUTS = (64, 128, 224, 320, 384, 448)
SCREEN_FPGAS = ("ku115", "zc706", "vu9p", "zcu102")
SCREEN_PRECISIONS = (16, 8)
SCREEN_N, SCREEN_BATCH_MAX, SCREEN_SEED = 4096, 8, 18
# repro/core/search.py::SearchSpace.lo()/hi() at batch_max 8: [SP, batch,
# dsp, bram, bw fractions], SP up to the net's major layers.
FRAC_LO, FRAC_HI = 0.05, 0.95


def screen_grid() -> tuple[list, list]:
    """(cells, tables) of the phase J grid: VGG-16 and VGG-19 (as the campaign
    builds them, no FC) at each input, then every net of the paper's Table 1
    (``TABLE1_NETS``) at its native input; each x board x precision."""
    nets = [(name, h, build(h)) for name, build in
            (("vgg16", vgg16), ("vgg19", lambda h: vgg19(h, with_fc=False)))
            for h in SCREEN_INPUTS]
    nets += [(name, 0, build()) for name, build in TABLE1_NETS.items()]
    cells, tables = [], []
    for name, h, net in nets:
        for fp in SCREEN_FPGAS:
            for prec in SCREEN_PRECISIONS:
                cells.append((name, h, fp, prec, len(net.major_layers)))
                tables.append(screen.cell_tables(net, FPGAS[fp], prec, prec))
    return cells, tables


def phase_j() -> dict:
    """The cross-cell DSE screen: the card's output equals the CPU's, bit for
    bit; times a call on each."""
    cells, tables = screen_grid()
    stacked = screen.stack_cells(tables)
    rng = np.random.default_rng(SCREEN_SEED)
    positions = np.stack([
        rng.uniform([0.0, 1.0, FRAC_LO, FRAC_LO, FRAC_LO],
                    [float(sp_max), float(SCREEN_BATCH_MAX), FRAC_HI, FRAC_HI, FRAC_HI],
                    size=(SCREEN_N, 5)) for *_, sp_max in cells])
    out = screen.screen_cells(stacked, positions, device="cuda")
    ref = screen.screen_cells(stacked, positions, device="cpu")
    check(out.shape == (len(cells), SCREEN_N) and bool(np.isfinite(out).all()),
          f"screen output {out.shape}, finite {bool(np.isfinite(out).all())}")
    check(bool((out > 0).any()), "the screen scored no candidate above 0")
    if not np.array_equal(out, ref):
        bad = tuple(np.argwhere(out != ref)[0])
        raise RuntimeError(f"the screen on the card differs from the CPU at cell "
                           f"{cells[bad[0]][:4]} row {bad[1]}: {out[bad]!r} vs {ref[bad]!r}")
    ms = time_ms(lambda: screen.screen_cells(stacked, positions, device="cuda"), reps=20)
    tab = {k: torch.from_numpy(v).cuda() for k, v in stacked.items()}
    pos = torch.from_numpy(positions).cuda()
    device_ms = time_ms(lambda: screen._screen(tab, pos), reps=20)
    cpu = []
    for _ in range(5):
        t0 = time.perf_counter()
        screen.screen_cells(stacked, positions, device="cpu")
        cpu.append((time.perf_counter() - t0) * 1e3)
    cpu_ms = statistics.median(cpu)
    rows = len(cells) * SCREEN_N
    table1 = sum(c[1] == 0 for c in cells)
    print(f"J float64 screen {len(cells)} cells ({len(cells) - table1} VGG grid, {table1} "
          f"Table 1 nets at their native inputs) x {SCREEN_N} candidates ({rows} rows): equal to "
          f"the CPU bit for bit; {ms:.3f} ms a call (median, CUDA events, the host copies in and "
          f"out included; {rows / ms * 1e3:.4g} candidates/s), {device_ms:.3f} ms on the device "
          f"alone ({rows / device_ms * 1e3:.4g} candidates/s); CPU {cpu_ms:.3f} ms a call "
          f"(host clock, median of 5; {rows / cpu_ms * 1e3:.4g} candidates/s)")
    return {"cells": len(cells), "rows": rows, "ms": ms, "device_ms": device_ms, "cpu_ms": cpu_ms}


# ---------------------------------------------------------------------------
# Training on the card (phases K, L)
# ---------------------------------------------------------------------------

TRAIN_SHAPE = ShapeSpec("smoke_train", "train", 512, 4)
TRAIN_STEPS = {LM_ARCH: 3, HYBRID_ARCH: 2}
# the leaves whose in-place AdamW update is held to the reference formula out of place
ADAMW_CHECKED = {LM_ARCH: ("embed", "blocks/attn/wq"),
                 HYBRID_ARCH: ("embed", "shared/attn/wq", "mamba/dt_proj")}
KERNEL_LOSS_TOL = 2e-2  # relative: StarCoder2's step-0 loss against the kernel route's prefill


def leaf_at(params, key: str):
    for part in key.split("/"):
        params = params[part]
    return params


def adamw_reference(p, g, m, v, gnorm, count: int, ocfg):
    """repro/optim/adamw.py::apply on one leaf, out of place: (p, mu, nu)."""
    step = torch.tensor(float(count), device=p.device)
    scale = torch.clamp(ocfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    g = g.float() * scale
    m = ocfg.b1 * m + (1 - ocfg.b1) * g
    v = ocfg.b2 * v + (1 - ocfg.b2) * g * g
    c1, c2 = 1 - torch.pow(ocfg.b1, step), 1 - torch.pow(ocfg.b2, step)
    upd = (m / c1) / (torch.sqrt(v / c2) + ocfg.eps) + ocfg.weight_decay * p.float()
    return (p.float() - adamw.schedule(ocfg, step) * upd).to(p.dtype), m, v


def checked_adamw(apply, keys, errs: list):
    """``apply`` (adamw.apply) that also holds each call, on the leaves
    ``keys``, to adamw_reference: the inputs are copied before the in-place
    update and the reference runs on the copies after it; the worst
    normalised error of each call goes to ``errs``."""

    def wrapped(grads, state, params, ocfg):
        snap = {k: [leaf_at(t, k).clone() for t in (params, grads, state.mu, state.nu)]
                for k in keys}
        out = apply(grads, state, params, ocfg)
        worst = 0.0
        for k, (p, g, m, v) in snap.items():
            want = adamw_reference(p, g, m, v, out[2]["grad_norm"], int(state.count), ocfg)
            got = (leaf_at(params, k), leaf_at(state.mu, k), leaf_at(state.nu, k))
            worst = max([worst] + [normalised_err(a, b) for a, b in zip(got, want)])
        errs.append(worst)
        return out

    return wrapped


def train_at_full_width(arch: str, gen) -> dict:
    """``TRAIN_STEPS[arch]`` steps of build_step's train step at full width
    (fp32 master weights, bf16 compute, remat "full"), batches from the
    port's TokenPipeline(seed=0)."""
    cfg = get_config(arch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = api.init_params(cfg, generator=gen, device="cuda")
    opt = adamw.init(params)
    n = n_params(params)
    data = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SHAPE.seq_len,
                                    global_batch=TRAIN_SHAPE.global_batch, seed=0))
    batches = [{k: torch.from_numpy(v).to("cuda", torch.int64) for k, v in data.make(s).items()}
               for s in range(TRAIN_STEPS[arch])]

    # the same weights and tokens on the kernel route: bf16 cast, use_kernel=True
    reset_counts()
    with torch.no_grad():
        logits = api.prefill_logits(cast_bf16(params), cfg, batches[0], use_kernel=True)
        kernel_loss = transformer.softmax_xent(logits, batches[0]["labels"]).item()
    kernel_launches = counts()
    check(kernel_launches == expected_launches(cfg),
          f"{arch}: kernel-route prefill launches {kernel_launches}")
    del logits

    before = [t.to("cpu", copy=True) for t in tree.leaves(params)]  # the card holds the state
    step_fn = build_step(cfg, TRAIN_SHAPE, device="cuda")
    errs: list = []
    apply = adamw.apply
    adamw.apply = checked_adamw(apply, ADAMW_CHECKED[arch], errs)
    losses, gnorms, walls, changed = [], [], [], []
    try:
        reset_counts()
        for batch in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, loss, gnorm = step_fn(params, opt, batch)
            losses.append(loss.item())
            gnorms.append(gnorm.item())
            walls.append((time.perf_counter() - t0) * 1e3)
            if before:
                changed = [not torch.equal(t, b.to("cuda"))
                           for t, b in zip(tree.leaves(params), before)]
                before = None
    finally:
        adamw.apply = apply
    train_launches = counts()
    peak = torch.cuda.max_memory_allocated()
    check(all(math.isfinite(x) for x in losses + gnorms),
          f"{arch} training: losses {losses}, grad norms {gnorms}")
    check(all(changed), f"{arch}: {changed.count(False)} parameter leaves did not change "
                        f"at step 0")
    check(max(errs) <= SAME, f"{arch}: in-place AdamW against the reference formula: "
                             f"normalised errors {errs}")
    check(sum(train_launches.values()) == 0,
          f"{arch}: the training steps launched kernels {train_launches}")
    tokens_n = TRAIN_SHAPE.seq_len * TRAIN_SHAPE.global_batch
    step_ms = statistics.median(walls[1:])
    # two more steps, the second under torch.profiler: device time by kernel
    by_kernel = device_us_by_kernel(lambda: step_fn(params, opt, batches[-1]), calls=1)
    return dict(arch=arch, cfg=cfg, params=n, losses=losses, gnorms=gnorms, walls=walls,
                by_kernel=by_kernel,
                step_ms=step_ms, tokens_per_s=tokens_n / step_ms * 1e3, peak_bytes=peak,
                model_tflops=6 * n * tokens_n / (step_ms * 1e-3) / 1e12,
                kernel_loss=kernel_loss, rel=abs(losses[0] - kernel_loss) / abs(kernel_loss),
                adamw_err=max(errs), leaves=len(changed), kernel_launches=kernel_launches)


def print_training(r: dict, gated: bool) -> None:
    arch = r["arch"]
    print(f"K {arch} train {TRAIN_SHAPE.global_batch} x {TRAIN_SHAPE.seq_len} "
          f"({r['cfg'].n_layers} layers, {r['params'] / 1e9:.3f} B params; fp32 master weights, "
          f"bf16 compute, remat full, the plain route): losses "
          + " ".join(f"{x:.4f}" for x in r["losses"]) + "  grad norms "
          + " ".join(f"{x:.4f}" for x in r["gnorms"])
          + f"  all {r['leaves']} leaves changed at step 0; in-place AdamW against the "
          f"reference formula {r['adamw_err']:.3e} (gate {SAME}); 0 kernel launches in the steps")
    print(f"K {arch} step-0 loss {r['losses'][0]:.5f} against the kernel route's prefill "
          f"(bf16 cast, use_kernel=True, launches {r['kernel_launches']}) {r['kernel_loss']:.5f}: "
          f"relative {r['rel']:.3e} "
          + (f"(gate {KERNEL_LOSS_TOL})" if gated else "(printed, not gated)"))
    print(f"K {arch} step walls " + " ".join(f"{w:.1f}" for w in r["walls"])
          + f" ms; step {r['step_ms']:.1f} ms (median after the first), "
          f"{r['tokens_per_s']:.1f} tokens/s, peak memory {r['peak_bytes'] / 1e9:.2f} GB "
          f"(max_memory_allocated); 6*N*tokens / step time = {r['model_tflops']:.2f} TFLOP/s, "
          f"{r['model_tflops'] / (PEAK_FLOPS[torch.bfloat16] / 1e12):.2%} of the bf16 peak "
          f"989 TFLOP/s (the plain route's products run in fp32)")
    by = sorted(r["by_kernel"].items(), key=lambda kv: -kv[1])
    device_ms = sum(r["by_kernel"].values()) / 1e3
    gemm_ms = sum(us for name, us in by if "gemm" in name.lower()) / 1e3
    print(f"K {arch} one step's device time (torch.profiler): {device_ms:.1f} ms in "
          f"{len(by)} kernel names, {device_ms / r['step_ms']:.1%} of the step wall; GEMM "
          f"kernels {gemm_ms:.1f} ms ({gemm_ms / max(device_ms, 1e-9):.1%}); top: "
          + "  ".join(f"{name} {us / 1e3:.1f} ms ({us / 1e3 / device_ms:.1%})"
                      for name, us in by[:6]))


def phase_k(gen) -> dict:
    """Training at full width: StarCoder2-3B (3 steps, the step-0 loss gated
    against the kernel route) then Zamba2-2.7B (2 steps, that loss printed)."""
    out = {}
    for arch in (LM_ARCH, HYBRID_ARCH):
        r = train_at_full_width(arch, gen)
        gated = arch == LM_ARCH
        print_training(r, gated)
        if gated:
            check(r["rel"] <= KERNEL_LOSS_TOL,
                  f"{arch}: step-0 loss {r['losses'][0]} vs kernel route {r['kernel_loss']}")
        out[arch] = {k: r[k] for k in ("params", "losses", "step_ms", "tokens_per_s",
                                       "peak_bytes", "model_tflops", "rel")}
        del r
        torch.cuda.empty_cache()
    return out


def phase_l() -> None:
    """The Trainer and the launcher at StarCoder2-3B.reduced() on the card:
    tests/test_runtime.py's three Trainer checks, then the launcher in a
    subprocess, its checkpoint read back bit-equal."""
    cfg, shape = get_config(LM_ARCH).reduced(), ShapeSpec("t", "train", 64, 4)
    scratch = ROOT / "build"
    scratch.mkdir(exist_ok=True)
    reset_counts()
    with tempfile.TemporaryDirectory(dir=scratch) as d:
        tr = Trainer(cfg, shape, TrainConfig(steps=12, ckpt_every=100, ckpt_dir=f"{d}/a",
                                             log_every=100), device="cuda")
        tr.run()
        first = statistics.mean(s["loss"] for s in tr.stats[:3])
        last = statistics.mean(s["loss"] for s in tr.stats[-3:])
        check(last < first, f"Trainer: loss did not decrease: {first} -> {last}")

        tr2 = Trainer(cfg, shape, TrainConfig(steps=8, ckpt_every=2, ckpt_dir=f"{d}/b",
                                              log_every=100), device="cuda")
        tr2.fail_at(5)
        tr2.run()
        check(tr2.step == 8 and tr2._restarts == 1
              and {s["step"] for s in tr2.stats} == set(range(8)),
              f"failure injection: step {tr2.step}, restarts {tr2._restarts}, "
              f"steps {sorted(s['step'] for s in tr2.stats)}")

        Trainer(cfg, shape, TrainConfig(steps=4, ckpt_every=4, ckpt_dir=f"{d}/c",
                                        log_every=100), device="cuda").run()
        tr3 = Trainer(cfg, shape, TrainConfig(steps=8, ckpt_every=4, ckpt_dir=f"{d}/c",
                                              log_every=100), device="cuda")
        tr3.run()
        check(min(s["step"] for s in tr3.stats) == 4, "the second Trainer did not resume at 4")
        trainer_launches = counts()
        check(sum(trainer_launches.values()) == 0, f"the Trainer launched {trainer_launches}")

        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch", LM_ARCH,
                              "--reduced", "--steps", "4", "--batch", "4", "--seq", "64",
                              "--ckpt-dir", f"{d}/cli"], cwd=ROOT, capture_output=True,
                             text=True, timeout=600,
                             env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
        cli_s = time.perf_counter() - t0
        done = [line for line in run.stdout.splitlines() if line.startswith("done:")]
        check(run.returncode == 0 and len(done) == 1,
              f"launcher exit {run.returncode}: {run.stdout[-1000:]} {run.stderr[-2000:]}")
        step = store.latest_step(f"{d}/cli")
        check(step == 4, f"the launcher left checkpoint step {step}")
        like = api.init_params(cfg, generator=torch.Generator(device="cuda").manual_seed(1),
                               device="cuda")
        restored = store.restore(f"{d}/cli", step, {"params": like, "opt": adamw.init(like)})
        flat = tree.flatten(restored)
        with np.load(f"{d}/cli/step_{step:08d}/arrays.npz") as z:
            equal = sorted(z.files) == sorted(k for k, _ in flat) and all(
                np.array_equal(t.cpu().numpy(), z[k]) for k, t in flat)
        check(equal, "the launcher's checkpoint did not read back bit-equal")
    print(f"L {LM_ARCH}.reduced() Trainer on the card: 12 steps, loss {first:.4f} -> {last:.4f} "
          f"(mean of the first and last 3); fail_at(5) with ckpt_every=2: 8 steps, 1 restart, "
          f"all 8 in stats; a second Trainer resumed at step 4; 0 kernel launches")
    print(f"L launcher: {done[0]} (exit 0, {cli_s:.1f} s with the process start); its step-4 "
          f"checkpoint restored bit-equal ({len(flat)} leaves)")


# ---------------------------------------------------------------------------
# The rest of the model zoo (phases M-P)
# ---------------------------------------------------------------------------

XLSTM_ARCH, WHISPER_ARCH, MOE_ARCH = "xlstm-350m", "whisper-base", "kimi-k2-1t-a32b"
HYBRID_LM_PLAN = HybridLMPlan(sp=8, n_stages=4, n_micro=4)
WHISPER_BATCH, WHISPER_TOKENS = 4, 448  # Whisper's decoder context (arXiv:2212.04356)
MOE_LAYERS = 1  # of Kimi-K2's 61: one layer's 384 experts are 33.8 GB in bf16
MOE_SLOTS, MOE_TICKS, MOE_MAX_SEQ = 4, 8, 64
TOPK_AGREE = 0.99  # Kimi-K2: tokens whose top-k sets agree across the routes
QUANT_SLACK = 1e-5  # fp32 rounding of w / scale and q * scale, in scales
ZOO_SEED = 19  # phases M-P draw from generators of their own


def zoo_gen(phase: str) -> torch.Generator:
    return torch.Generator(device="cuda").manual_seed(ZOO_SEED + "MNOP".index(phase))


def timed_counted(fn, reps: int = 1):
    """(the last fn(), the launches of that call by kernel and by matmul and
    flash route, the median wall in ms of ``reps`` calls, each ending in a
    synchronize)."""
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    got = counts()
    got["matmul_routes"] = dict(matmul.launches_by_route)
    got["flash_attention_routes"] = dict(flash_attention.launches_by_route)
    return out, got, statistics.median(walls)


def check_launches(where: str, got: dict, matmul_routes: dict, rms: int, flash: int = 0,
                   flash_route: str = "wgmma") -> None:
    """Exactly these launches: matmul by route, RMSNorm, flash on one route, no SSD."""
    want = {"matmul": sum(matmul_routes.values()), "rmsnorm": rms, "flash_attention": flash,
            "ssd": 0}
    check({k: got[k] for k in want} == want, f"{where}: launches {got}, expected {want}")
    mm = {r: matmul_routes.get(r, 0) for r in ROUTE_NAMES}
    check(got["matmul_routes"] == mm, f"{where}: matmul routes {got['matmul_routes']}, "
          f"expected {mm}")
    fl = {r: flash if r == flash_route else 0 for r in ROUTE_NAMES}
    check(got["flash_attention_routes"] == fl, f"{where}: flash routes "
          f"{got['flash_attention_routes']}, expected {fl}")


def on_route(dtype, n: int, simt: int = 0) -> dict:
    """``n`` products, ``simt`` of them on simt whatever the dtype (an N that
    is not a multiple of 8), the rest on the dtype's route."""
    if dtype == torch.float32:
        return {"simt": n}
    return {"wgmma": n - simt, "simt": simt}


def peak_gb() -> float:
    return torch.cuda.max_memory_allocated() / 1e9


def requested_bytes(which: str = "current") -> int:
    """The bytes the tensors asked the caching allocator for (its
    ``requested_bytes``), before it rounds a block up: what a count of
    storage sizes sees."""
    return torch.cuda.memory_stats()[f"requested_bytes.all.{which}"]


def path_entry(got: dict) -> dict:
    return {"matmul": {"launches": got["matmul"], "launches_by_route": got["matmul_routes"]},
            "rmsnorm": {"launches": got["rmsnorm"]},
            "flash_attention": {"launches": got["flash_attention"],
                                "launches_by_route": got["flash_attention_routes"]}}


def quant_bytes(t: torch.Tensor) -> int:
    """Bytes of a leaf after quantize_params: int8 values and one fp32 scale a
    column for a floating leaf of two or more axes; the leaf itself otherwise."""
    if t.dim() >= 2 and t.is_floating_point():
        return t.numel() + 4 * t.shape[-1]
    return t.numel() * t.element_size()


def phase_m(keep: dict) -> dict:
    """StarCoder2-3B at full width and depth, bf16, 4 x 512: the hybrid LM plan
    (sp 8, 4 stages, 4 microbatches) pipelined on the kernel route against
    api.prefill_logits on the kernel route; then int8 weight-only
    quantization of the same weights. The pipelined logits are kept on the
    host for phase Q."""
    gen, cfg, plan = zoo_gen("M"), get_config(LM_ARCH), HYBRID_LM_PLAN
    torch.cuda.reset_peak_memory_stats()
    params = transformer.init_lm(cfg, generator=gen, device="cuda", dtype=torch.bfloat16)
    tokens = torch.randint(0, cfg.vocab, (PREFILL_BATCH, PREFILL_SEQ), generator=gen,
                           device="cuda")
    want = expected_launches(cfg)
    per_block = (want["matmul"] - 1) // cfg.n_layers
    # the one-device GPipe calls every head stage at each of n_micro + n_stages - 1 ticks
    calls = (plan.n_micro + plan.n_stages - 1) * plan.sp + cfg.n_layers - plan.sp
    with torch.inference_mode():
        ref, got_ref, ref_ms = timed_counted(
            lambda: api.prefill_logits(params, cfg, {"tokens": tokens}), reps=3)
        check_launches("M prefill", got_ref, {"wgmma": want["matmul"]}, want["rmsnorm"],
                       want["flash_attention"])
        seq, got_seq, seq_ms = timed_counted(
            lambda: hybrid_lm_forward(params, cfg, tokens, plan), reps=3)
        check_launches("M sequential plan", got_seq, {"wgmma": want["matmul"]}, want["rmsnorm"],
                       want["flash_attention"])
        out, got, pipe_ms = timed_counted(
            lambda: hybrid_lm_forward(params, cfg, tokens, plan, pipelined=True), reps=3)
        check_launches("M pipelined plan", got, {"wgmma": calls * per_block + 1}, 2 * calls + 1,
                       calls)
        plain = hybrid_lm_forward(params, cfg, tokens, plan, pipelined=True, use_kernel=False)
    check(tuple(out.shape) == (PREFILL_BATCH, PREFILL_SEQ, cfg.vocab), f"shape {out.shape}")
    e_seq, e_pipe = normalised_err(seq, ref), normalised_err(out, ref)
    e_plain = normalised_err(out, plain)
    check(e_seq <= SAME, f"M: the sequential plan differs from api.prefill_logits by {e_seq:.3e}")
    check(e_pipe <= TOL[torch.bfloat16] and e_plain <= TOL[torch.bfloat16],
          f"M: pipelined kernel route against api.prefill_logits {e_pipe:.3e}, against its "
          f"plain route {e_plain:.3e}")
    n_tok = PREFILL_BATCH * PREFILL_SEQ
    print(f"M bfloat16 {LM_ARCH} hybrid plan sp={plan.sp} stages={plan.n_stages} "
          f"micro={plan.n_micro} B={PREFILL_BATCH} S={PREFILL_SEQ}: pipelined kernel route "
          f"against api.prefill_logits {e_pipe:.3e}, against the pipelined plain route "
          f"{e_plain:.3e}; sequential plan {e_seq:.3e}  launches {got} ({calls} block calls: "
          f"{plan.n_micro + plan.n_stages - 1} ticks x {plan.sp} head blocks + "
          f"{cfg.n_layers - plan.sp} tail; the prefill's {want})")
    print(f"M bfloat16 walls: prefill {ref_ms:.3f} ms ({n_tok / ref_ms * 1e3:.1f} tokens/s), "
          f"sequential plan {seq_ms:.3f} ms, pipelined plan {pipe_ms:.3f} ms "
          f"({n_tok / pipe_ms * 1e3:.1f} tokens/s) (medians of 3)")
    keep["M"] = out.cpu()
    del seq, plain, out

    q = quantize_params(params)
    before, after = storage_bytes(params), storage_bytes(q)
    expect = sum(quant_bytes(t) for t in tree.leaves(params))
    check(after == expect, f"M: quantized storage {after} B, expected {expect} B")
    worst = []

    def half_scale(w, node):
        if not isinstance(node, dict):
            check(node is w, "M: a leaf that stays as it is was replaced")
            return
        d = dequantize_params({"w": node}, torch.float32)["w"]
        ratio = ((d - w.float()).abs() / node["scale"]).max().item()
        check(ratio <= 0.5 + QUANT_SLACK, f"M: a dequantized weight {ratio:.6f} scales from "
              f"its original")
        worst.append(ratio)

    tree.map_tree(half_scale, params, q)
    deq = dequantize_params(q)
    with torch.inference_mode():
        qlogits, got_q, q_ms = timed_counted(
            lambda: api.prefill_logits(deq, cfg, {"tokens": tokens}))
        check_launches("M dequantized prefill", got_q, {"wgmma": want["matmul"]},
                       want["rmsnorm"], want["flash_attention"])
    agree = (qlogits.argmax(-1) == ref.argmax(-1)).float().mean().item()
    print(f"M int8 weight-only: storage {before} B -> {after} B ({before / after:.4f}x; "
          f"{expect} B expected from the leaf shapes), every dequantized weight within "
          f"{max(worst):.6f} scales of the original ({len(worst)} quantized leaves); the "
          f"dequantized bf16 prefill (not gated): logits {normalised_err(qlogits, ref):.3e} "
          f"from the unquantized, top-1 agreement {agree:.4f}, wall {q_ms:.3f} ms; "
          f"peak memory {peak_gb():.2f} GB")
    del params, q, deq, qlogits, ref
    return {f"{LM_ARCH} hybrid plan": path_entry(got)}


def xlstm_launches(cfg, seq: int, dtype) -> tuple[dict, int]:
    """(matmul launches by route, RMSNorm launches) of one xLSTM forward over
    ``seq`` tokens (1: a decode tick): 6 products an mLSTM block (wi and wf
    have N = n_heads, not a multiple of 8: simt), 1 + seq an sLSTM block
    (its recurrent product at every step), the head; 2 norms a block and ln_f."""
    n_s = sum(recurrent._is_slstm(cfg, i) for i in range(cfg.n_layers))
    n_m = cfg.n_layers - n_s
    return on_route(dtype, 6 * n_m + (1 + seq) * n_s + 1, 2 * n_m), 2 * cfg.n_layers + 1


def block_name(bp, i: int) -> str:
    return f"{'sLSTM' if 'kind_slstm' in bp else 'mLSTM'} {i}"


def xlstm_blocks(params, cfg) -> list:
    """recurrent.xlstm_forward after the embedding, block by block, the head last."""
    blocks = [(block_name(bp, i), lambda h, uk, bp=bp: (
        recurrent.xlstm_block(h, bp, cfg, use_kernel=uk),))
        for i, bp in enumerate(params["blocks"])]
    blocks.append(("head", lambda h, uk: (layers.linear(
        layers.rms_norm(h, params["ln_f"], use_kernel=uk), params["lm_head"], uk).float(),)))
    return blocks


def xlstm_decode_blocks(params, cfg, cache) -> list:
    """One recurrent.xlstm_decode_step after the embedding, block by block:
    (output, *the block's new states in the cache's key order), the head last."""
    def block(h, uk, bp, cc):
        x = layers.rms_norm(h, bp["ln"], use_kernel=uk)
        if "kind_mlstm" in bp:
            y, *state = ssm.mlstm_decode(x, bp["kind_mlstm"], cfg.n_heads, cc["c"], cc["n"],
                                         cc["m"], use_kernel=uk)
        else:
            y, *state = ssm.slstm_apply(x, bp["kind_slstm"], cc["h"], cc["c"], use_kernel=uk)
        return (h + y, *state)

    blocks = [(block_name(bp, i), lambda h, uk, bp=bp, cc=cc: block(h, uk, bp, cc))
              for i, (bp, cc) in enumerate(zip(params["blocks"], cache))]
    blocks.append(("head", lambda h, uk: (layers.linear(
        layers.rms_norm(h, params["ln_f"], use_kernel=uk)[:, 0], params["lm_head"],
        uk).float(),)))
    return blocks


def xlstm_decode_errors(params, cfg, cache, toks, step, plain) -> tuple[list, float]:
    """Every block of one xLSTM decode step, both routes fed the same input and
    state, and both chains against api.decode_step's (logits, new cache)."""
    errs, *chains = run_blocks(xlstm_decode_blocks(params, cfg, cache),
                               params["embed"][toks].to(torch.bfloat16))
    pairs = []
    for (x, lines), (logits, new) in zip(chains, (step, plain)):
        pairs.append((x, logits))
        for i, (bp, states) in enumerate(zip(params["blocks"], new)):
            pairs += list(zip(lines[block_name(bp, i)], states.values()))
    return errs, max(normalised_err(a, b) for a, b in pairs)


def phase_n() -> dict:
    """xLSTM-350M at full width and depth: prefill 4 x 512 in bf16 and fp32,
    every block held kernel route against plain route on the same input;
    then ContinuousBatcher serving 8 requests on 4 slots."""
    gen, cfg = zoo_gen("N"), get_config(XLSTM_ARCH)
    torch.cuda.reset_peak_memory_stats()
    params = api.init_params(cfg, generator=gen, device="cuda", dtype=torch.bfloat16)
    tokens = torch.randint(0, cfg.vocab, (PREFILL_BATCH, PREFILL_SEQ), generator=gen,
                           device="cuda")
    n_tok, numel = PREFILL_BATCH * PREFILL_SEQ, n_params(params)
    paths = {}
    for dtype in (torch.bfloat16, torch.float32):
        p = params if dtype == torch.bfloat16 else cast_tree(params, dtype)
        mm, rms = xlstm_launches(cfg, PREFILL_SEQ, dtype)
        with torch.inference_mode():
            logits, got, wall = timed_counted(
                lambda: api.prefill_logits(p, cfg, {"tokens": tokens}, compute_dtype=dtype),
                reps=3 if dtype == torch.bfloat16 else 1)
            check_launches(f"N {name_of(dtype)} prefill", got, mm, rms)
            plain = api.prefill_logits(p, cfg, {"tokens": tokens}, compute_dtype=dtype,
                                       use_kernel=False)
            errs, (xk, _), (xp, _) = run_blocks(xlstm_blocks(p, cfg),
                                                p["embed"][tokens].to(dtype))
            chain = max(normalised_err(xk, logits), normalised_err(xp, plain))
            e2e = normalised_err(logits, plain)
        check(tuple(logits.shape) == (PREFILL_BATCH, PREFILL_SEQ, cfg.vocab),
              f"logits {tuple(logits.shape)}")
        worst = max(errs, key=lambda t: t[1])
        print(f"N {name_of(dtype):8s} {XLSTM_ARCH} prefill B={PREFILL_BATCH} S={PREFILL_SEQ} "
              f"({cfg.n_layers} blocks, {numel / 1e6:.3f} M params; cfg.param_count() says "
              f"{cfg.param_count() / 1e6:.3f} M): launches {got}  wall {wall:.3f} ms "
              f"({n_tok / wall * 1e3:.1f} tokens/s)  every block and the head, same input: max "
              f"{worst[1]:.3e} ({worst[0]}); the blocks chained against api.prefill_logits "
              f"{chain:.3e}; end to end kernel vs plain (not gated) {e2e:.3e}")
        check(chain <= SAME, f"N: the blocks chained differ from api.prefill_logits by {chain:.3e}")
        check(worst[1] <= TOL[dtype], f"N {name_of(dtype)}: block {worst[0]} kernel vs plain "
              f"{worst[1]:.3e}")
        if dtype == torch.bfloat16:
            paths[f"{XLSTM_ARCH} prefill"] = path_entry(got)
        del p, logits, plain, xk, xp

    reqs = serving_requests(cfg)
    mm, rms = xlstm_launches(cfg, 1, torch.bfloat16)
    b = ContinuousBatcher(cfg, params, slots=SLOTS, max_seq=MAX_SEQ, device="cuda")
    for r in reqs:
        b.submit(r)
    fresh = api.init_cache(cfg, 1, 1, device="cuda")
    ticks, reused, block_err, chain_err, tick_got = [], 0, ("none", 0.0), 0.0, None
    while True:
        b._admit()
        for slot, st in enumerate(b.active):  # a reused slot starts from the initial state
            if st is not None and b.steps > 0 and st["start_step"] == b.steps:
                reused += 1
                check(all(torch.equal(states[k][slot], init[k][0])
                          for states, init in zip(b.cache, fresh) for k in states),
                      f"N: slot {slot}, admitted at tick {b.steps}, starts from a used state")
        if b.steps < 4:  # every block of the kernel decode step against the plain one
            toks, pos = b._gather_inputs()
            with torch.inference_mode():
                step = api.decode_step(params, cfg, b.cache, toks, pos)
                plain = api.decode_step(params, cfg, b.cache, toks, pos, use_kernel=False)
                errs, chained = xlstm_decode_errors(params, cfg, b.cache, toks, step, plain)
            check(chained <= SAME, f"N decode tick {b.steps}: the blocks chained differ from "
                  f"api.decode_step by {chained:.3e}")
            chain_err = max(chain_err, chained)
            worst = max(errs, key=lambda t: t[1])
            check(worst[1] <= TOL[torch.bfloat16], f"N decode tick {b.steps}: block {worst[0]} "
                  f"kernel vs plain {worst[1]:.3e}")
            block_err = max(block_err, worst, key=lambda t: t[1])
            del step, plain
        more, got_t, wall = timed_counted(b.step)
        if not more:  # the tick's argmax reaches the host, so a step ends on the device
            break
        ticks.append(wall)
        tick_got = got_t
        check_launches(f"N tick {b.steps}", tick_got, mm, rms)
    done = {c.rid: c for c in b.done}
    check(sorted(done) == [r.rid for r in reqs], f"N completed {sorted(done)}")
    check(reused == N_REQUESTS - SLOTS, f"N: {reused} reused slots, expected "
          f"{N_REQUESTS - SLOTS}")
    plain_b = ContinuousBatcher(cfg, params, slots=SLOTS, max_seq=MAX_SEQ, device="cuda",
                                use_kernel=False)
    for r in reqs:
        plain_b.submit(r)
    plain_b.run()
    check((plain_b.steps, plain_b.utilization) == (b.steps, b.utilization),
          f"N steps/utilization {b.steps}/{b.utilization} vs plain "
          f"{plain_b.steps}/{plain_b.utilization}")
    generated, wall = sum(r.max_new for r in reqs), sum(ticks)
    print(f"N bfloat16 {XLSTM_ARCH} serving {N_REQUESTS} requests on {SLOTS} slots: {b.steps} "
          f"ticks  utilization {b.utilization:.4f}  launches per tick {tick_got}  {reused} "
          f"slots reused, each from the initial state (m = -1e30)  decode vs plain on ticks "
          f"0-3, every block fed the same input and state: max {block_err[1]:.3e} "
          f"({block_err[0]}), the blocks chained against api.decode_step {chain_err:.3e}")
    print(f"N bfloat16 tick {statistics.median(ticks):.3f} ms (median); {generated} generated "
          f"tokens in {wall:.1f} ms = {generated / wall * 1e3:.1f} generated tokens/s; peak "
          f"memory {peak_gb():.2f} GB")
    paths[f"{XLSTM_ARCH} decode tick"] = path_entry(tick_got)
    del params, b, plain_b
    return paths


def phase_o() -> dict:
    """Whisper-base at full width and depth: encode 4 x 1500 frames and the
    teacher-forced decoder over 4 x 448 tokens, kernel route against plain
    route, bf16 and fp32; then prefill_cross + 448 decode steps against the
    teacher-forced logits at the last position."""
    gen, cfg = zoo_gen("O"), get_config(WHISPER_ARCH)
    torch.cuda.reset_peak_memory_stats()
    params = api.init_params(cfg, generator=gen, device="cuda", dtype=torch.bfloat16)
    frames = torch.randn((WHISPER_BATCH, cfg.n_audio_frames, cfg.d_model), generator=gen,
                         device="cuda")
    tokens = torch.randint(0, cfg.vocab, (WHISPER_BATCH, WHISPER_TOKENS), generator=gen,
                           device="cuda")
    le, ld = cfg.n_enc_layers, cfg.n_layers
    head_simt = int(cfg.vocab % 8 != 0)  # the tied head embed.T: N = 51865 takes simt
    paths = {}
    for dtype in (torch.bfloat16, torch.float32):
        p = params if dtype == torch.bfloat16 else cast_tree(params, dtype)
        fr = expected_flash_route(dtype)
        with torch.inference_mode():
            mem, got_e, enc_ms = timed_counted(
                lambda: encdec.encode(p, cfg, frames, compute_dtype=dtype), reps=3)
            check_launches(f"O {name_of(dtype)} encode", got_e, on_route(dtype, 6 * le), 0, le,
                           fr)
            e_enc = normalised_err(mem, encdec.encode(p, cfg, frames, compute_dtype=dtype,
                                                      use_kernel=False))
            logits, got_d, dec_ms = timed_counted(
                lambda: encdec.decode_train(p, cfg, tokens, mem, compute_dtype=dtype), reps=3)
            check_launches(f"O {name_of(dtype)} decode_train", got_d,
                           on_route(dtype, 10 * ld + 1, head_simt), 0, 2 * ld, fr)
            e_dec = normalised_err(logits, encdec.decode_train(
                p, cfg, tokens, mem, compute_dtype=dtype, use_kernel=False))
            cache, got_x, _ = timed_counted(lambda: encdec.prefill_cross(
                p, cfg, mem, api.init_cache(cfg, WHISPER_BATCH, WHISPER_TOKENS, dtype,
                                            device="cuda")))
            check_launches(f"O {name_of(dtype)} prefill_cross", got_x, on_route(dtype, 2 * ld), 0)

            def steps(cache=cache, p=p, dtype=dtype):
                for t in range(WHISPER_TOKENS):
                    last, cache = api.decode_step(p, cfg, cache, tokens[:, t:t + 1],
                                                  torch.full((WHISPER_BATCH,), t, device="cuda"),
                                                  compute_dtype=dtype)
                return last, cache

            (last, cache), got_s, steps_ms = timed_counted(steps)
            step_ms = steps_ms / WHISPER_TOKENS
            per_step = on_route(dtype, 8 * ld + 1, head_simt)
            check_launches(f"O {name_of(dtype)} {WHISPER_TOKENS} decode steps", got_s,
                           {r: n * WHISPER_TOKENS for r, n in per_step.items()}, 0)
            # the launches of one step, read from the counters of the 448
            got_step = {k: ({r: n // WHISPER_TOKENS for r, n in v.items()} if isinstance(v, dict)
                            else v // WHISPER_TOKENS) for k, v in got_s.items()}
            e_inc = normalised_err(last, logits[:, -1])
        tol = TOL[dtype]
        frames_n, toks_n = WHISPER_BATCH * cfg.n_audio_frames, WHISPER_BATCH * WHISPER_TOKENS
        print(f"O {name_of(dtype):8s} {WHISPER_ARCH} ({le} + {ld} layers, "
              f"{n_params(p) / 1e6:.3f} M params) B={WHISPER_BATCH}: encode {cfg.n_audio_frames} "
              f"frames kernel vs plain {e_enc:.3e}, {enc_ms:.3f} ms ({frames_n / enc_ms * 1e3:.1f} "
              f"frames/s), launches {got_e}; decode_train S={WHISPER_TOKENS} kernel vs plain "
              f"{e_dec:.3e}, {dec_ms:.3f} ms ({toks_n / dec_ms * 1e3:.1f} tokens/s), launches "
              f"{got_d}; prefill_cross + {WHISPER_TOKENS} decode steps ({step_ms:.3f} ms a step, "
              f"{WHISPER_BATCH / step_ms * 1e3:.1f} tokens/s; launches a step {got_step}) "
              f"last logits against decode_train's at the last position {e_inc:.3e}")
        check(max(e_enc, e_dec, e_inc) <= tol, f"O {name_of(dtype)}: encode {e_enc:.3e}, "
              f"decode_train {e_dec:.3e}, incremental decode {e_inc:.3e} (tolerance {tol})")
        if dtype == torch.bfloat16:
            paths[f"{WHISPER_ARCH} encode"] = path_entry(got_e)
            paths[f"{WHISPER_ARCH} decode_train"] = path_entry(got_d)
            paths[f"{WHISPER_ARCH} decode step"] = path_entry(got_step)
        del p, mem, logits, cache, last
    print(f"O peak memory {peak_gb():.2f} GB")
    del params
    return paths


def moe_agreement(h, mp, cfg) -> tuple:
    """The MoE layer on both routes fed the same input h (B, S, d): (router
    logits error, share of tokens whose top-k sets agree, the layer output's
    error on the tokens whose sets agree and whose kept assignments agree
    expert by expert, those tokens, dropped assignments on each route, the
    kernel route's (y, host ms of the call, wall ms))."""
    xf = h.reshape(-1, h.shape[-1])
    k, t = cfg.moe.top_k, xf.shape[0]
    lk, _, _, ik = moe.route(xf, mp["router"], cfg, use_kernel=True)
    lp, _, _, ip = moe.route(xf, mp["router"], cfg, use_kernel=False)
    (ek, ok), (ep, op) = ik.sort(-1), ip.sort(-1)
    same = (ek == ep).all(-1)
    # each token's kept flags in expert order: (T, k)
    kept_k = moe.dispatch(ik, cfg)[2].reshape(k, t).t().gather(1, ok)
    kept_p = moe.dispatch(ip, cfg)[2].reshape(k, t).t().gather(1, op)
    mask = same & (kept_k == kept_p).all(-1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    yk, _, drop_k = moe.moe_mlp(h, mp, cfg, use_kernel=True)
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    yp, _, drop_p = moe.moe_mlp(h, mp, cfg, use_kernel=False)
    e_y = normalised_err(yk.reshape(t, -1)[mask], yp.reshape(t, -1)[mask])
    return (normalised_err(lk, lp), same.float().mean().item(), e_y, int(mask.sum()),
            int(drop_k), int(drop_p), (yk, host_ms, wall_ms))


def moe_layer_gate(where: str, attention, x, params, bp, cfg) -> dict:
    """One MoE layer and the head, each part held kernel route against plain
    route on the same input: ``attention(x, uk)`` is the residual after the
    block's attention on route uk; the MoE layer and the head then take the
    plain route's. Gated: attention, router logits and head within the bf16
    tolerance, top-k sets agreeing on TOPK_AGREE of the tokens, the MoE
    output within the tolerance on the tokens whose sets and kept
    assignments agree."""
    tol = TOL[torch.bfloat16]
    xa = attention(x, False)
    e_attn = normalised_err(attention(x, True), xa)
    h = layers.rms_norm(xa, bp["ln2"])
    e_router, agree, e_y, n_same, drop_k, drop_p, (_, host_ms, moe_ms) = moe_agreement(
        h, bp["moe"], cfg)
    hf = layers.rms_norm(xa + moe.moe_mlp(h, bp["moe"], cfg)[0], params["ln_f"])
    e_head = normalised_err(layers.linear(hf, params["lm_head"], True),
                            layers.linear(hf, params["lm_head"], False))
    t = h.shape[0] * h.shape[1]
    print(f"{where}, same input, kernel vs plain (capacity {moe.capacity(t, cfg)}): attention "
          f"{e_attn:.3e}, router logits {e_router:.3e}, top-k sets agree on {agree:.4f} of {t} "
          f"tokens, MoE output on the {n_same} tokens whose sets and kept assignments agree "
          f"{e_y:.3e}, head {e_head:.3e}; dropped assignments: kernel route {drop_k}, plain "
          f"route {drop_p} of {t * cfg.moe.top_k}; the MoE layer on the kernel route: "
          f"{3 * cfg.moe.n_experts} expert launches, host {host_ms:.1f} ms to queue the call "
          f"({host_ms / cfg.moe.n_experts * 1e3:.1f} us an expert), {moe_ms:.1f} ms to its end")
    check(e_attn <= tol and e_router <= tol and e_head <= tol,
          f"{where}: attention {e_attn:.3e}, router {e_router:.3e}, head {e_head:.3e}")
    check(agree >= TOPK_AGREE, f"{where}: top-k sets agree on {agree:.4f} of the tokens")
    check(n_same > 0 and e_y <= tol, f"{where}: MoE output on {n_same} agreeing tokens {e_y:.3e}")
    return {"host_ms": host_ms, "moe_ms": moe_ms}


def phase_p() -> dict:
    """Kimi-K2 at full width, depth cut to MOE_LAYERS: prefill 4 x 512 and
    4-slot decode ticks through every expert on the kernel route; at the
    prefill and at decode tick 0 the attention, the MoE layer (router logits,
    top-k sets, output) and the head held to the plain route on the same
    input."""
    gen, full = zoo_gen("P"), get_config(MOE_ARCH)
    cfg = dataclasses.replace(full, n_layers=MOE_LAYERS)
    e = cfg.moe
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init_params(cfg, generator=gen, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tokens = torch.randint(0, cfg.vocab, (PREFILL_BATCH, PREFILL_SEQ), generator=gen,
                           device="cuda")
    per_layer = 4 + 1 + 3 * e.n_experts + 3  # attention, router, experts, shared expert
    router_simt = int(e.n_experts % 8 != 0)  # 384 experts: the router's N takes wgmma
    mm = on_route(torch.bfloat16, per_layer * cfg.n_layers + 1, router_simt * cfg.n_layers)
    rms = 2 * cfg.n_layers + 1
    t = PREFILL_BATCH * PREFILL_SEQ
    bp = transformer.layer(params["blocks"], 0)
    with torch.inference_mode():
        logits, got, wall = timed_counted(
            lambda: api.prefill_logits(params, cfg, {"tokens": tokens}), reps=3)
        check_launches("P prefill", got, mm, rms, cfg.n_layers)
        e2e = normalised_err(logits, api.prefill_logits(params, cfg, {"tokens": tokens},
                                                        use_kernel=False))

        def attention(h, uk):
            return h + layers.gqa_attention(
                layers.rms_norm(h, bp["ln1"], use_kernel=uk), bp["attn"], cfg.n_heads,
                cfg.n_kv, rope=cfg.rope, rope_theta=cfg.rope_theta,
                attn_fn=flash_attn_fn if uk else None, use_kernel=uk)

        print(f"P bfloat16 {MOE_ARCH} at full width, {cfg.n_layers} of {full.n_layers} layers "
              f"({n_params(params) / 1e9:.3f} B params, drawn in {init_s:.1f} s) prefill "
              f"B={PREFILL_BATCH} S={PREFILL_SEQ}: launches {got}  wall {wall:.3f} ms "
              f"({t / wall * 1e3:.1f} tokens/s)  end to end kernel vs plain (not gated) "
              f"{e2e:.3e}")
        moe_layer_gate("P prefill", attention, params["embed"][tokens].to(torch.bfloat16),
                       params, bp, cfg)
    del logits

    cache = api.init_cache(cfg, MOE_SLOTS, MOE_MAX_SEQ, device="cuda")
    toks = torch.randint(0, cfg.vocab, (MOE_SLOTS, MOE_TICKS), generator=gen, device="cuda")
    tick_ms = []
    with torch.inference_mode():
        for i in range(MOE_TICKS):
            pos = torch.full((MOE_SLOTS,), i, device="cuda")
            if i == 0:  # every part of the tick on both routes, fed the same input and cache
                plain, _ = api.decode_step(params, cfg, cache, toks[:, :1], pos, use_kernel=False)

                def decode_attention(h, uk, cache=cache, pos=pos):
                    return h + layers.gqa_decode_attention(
                        layers.rms_norm(h, bp["ln1"], use_kernel=uk), bp["attn"], cfg.n_heads,
                        cfg.n_kv, cache["k"][0], cache["v"][0], pos, rope=cfg.rope,
                        rope_theta=cfg.rope_theta, use_kernel=uk)[0]

                moe_layer_gate("P decode tick 0", decode_attention,
                               params["embed"][toks[:, :1]].to(torch.bfloat16), params, bp, cfg)
            (step, cache), tick_got, ms = timed_counted(
                lambda: api.decode_step(params, cfg, cache, toks[:, i:i + 1], pos))
            check_launches(f"P tick {i}", tick_got, mm, rms)
            check(bool(torch.isfinite(step).all()), f"P tick {i}: non-finite logits")
            if i == 0:
                e_tick = normalised_err(step, plain)
            else:
                tick_ms.append(ms)
    bound = 3 * e.n_experts * cfg.d_model * e.d_ff_expert * 2 / HBM_BYTES_PER_S * 1e3
    print(f"P bfloat16 decode {MOE_SLOTS} slots (capacity {moe.capacity(MOE_SLOTS, cfg)}), "
          f"{MOE_TICKS} ticks: launches per tick {tick_got}  tick {statistics.median(tick_ms):.3f} "
          f"ms (median of ticks 1-{MOE_TICKS - 1}; reading every expert's weights once takes "
          f"at least {bound:.3f} ms)  {MOE_SLOTS / statistics.median(tick_ms) * 1e3:.1f} "
          f"tokens/s; tick 0 end to end kernel vs plain logits (not gated) {e_tick:.3e}; peak "
          f"memory {peak_gb():.2f} GB")
    del params, cache, bp
    return {f"{MOE_ARCH} prefill": path_entry(got), f"{MOE_ARCH} decode tick":
            path_entry(tick_got)}


# ---------------------------------------------------------------------------
# The paper's pipeline across processes, expert parallelism (phase Q)
# ---------------------------------------------------------------------------

Q_RANKS = 4
Q_BACKEND = "gloo"  # NCCL refuses two ranks on one device ("Duplicate GPU detected")
Q_TIMEOUT = 60  # seconds: any collective of the ranks' group
Q_JOIN = 400  # seconds: the whole of phase Q's ranks
Q_SEED = 20
MOE_GATE = 1e-2  # Q3: EP against the dense route, on the tokens whose routes agree
AUX_GATE = 1e-5
# Q4's gradient tree (fp32): an embedding, a stacked block weight, a vector
Q4_SHAPES = {"embed": (4096, 512), "blocks": {"w": (8, 1024, 256)}, "scale": (512,)}


def q_grads(rank: int) -> tuple[dict, dict]:
    """Rank ``rank``'s seeded fp32 gradients and error feedback for Q4, drawn
    on the host (a generator a rank; the ranks' scales differ)."""
    gen = torch.Generator().manual_seed(Q_SEED * 100 + rank)

    def tree(shapes, scale):
        return {k: tree(v, scale) if isinstance(v, dict)
                else torch.randn(v, generator=gen) * scale * (rank + 1)
                for k, v in shapes.items()}

    return tree(Q4_SHAPES, 1.0), tree(Q4_SHAPES, 0.01)


def q_formula(ranks: int) -> tuple[dict, list]:
    """compressed_psum's result on the host: the int32 sum of every rank's int8
    values times the largest scale, and each rank's error feedback
    ``acc - q * scale`` with its own scale."""
    per = [q_grads(r) for r in range(ranks)]
    flat = [(dict(tree.flatten(g)), dict(tree.flatten(e))) for g, e in per]
    total, errs = {}, [{} for _ in range(ranks)]
    for key in flat[0][0]:
        qs, scales = [], []
        for r, (g, e) in enumerate(flat):
            acc = g[key] + e[key]
            scale = torch.clamp(acc.abs().max(), min=1e-12) / 127.0
            q = torch.clamp(torch.round(acc / scale), -127, 127).to(torch.int8)
            errs[r][key] = acc - q.float() * scale
            qs.append(q.to(torch.int32))
            scales.append(scale)
        total[key] = torch.stack(qs).sum(0).float() * torch.stack(scales).max()
    return total, errs


def q_counted(fn, reps: int):
    """timed_counted with the conv's counts beside the LM kernels': (the last
    fn(), its launches, the median wall in ms)."""
    def run():
        conv2d.launches = 0
        conv2d.launches_by_route = dict.fromkeys(conv2d.launches_by_route, 0)
        return fn()

    out, got, ms = timed_counted(run, reps)
    got["conv2d"], got["conv2d_routes"] = conv2d.launches, dict(conv2d.launches_by_route)
    return out, got, ms


def errs_text(results, q: str, key: str = "err") -> str:
    return "[" + ", ".join(f"{r[q][key]:.3e}" for r in results) + "]"


def per_rank(results, q: str, key: str, digits: int = 3) -> list:
    return [round(r[q][key], digits) for r in results]


def q_rank(rank: int, world: int, tmp: str) -> dict:
    """Phase Q on one rank of ``world``, all on cuda:0: Q1 the VGG group's head
    over a stage mesh, Q2 StarCoder2-3B's hybrid plan over a stage mesh, Q3
    Kimi-K2's MoE MLP expert-parallel, Q4 compressed_psum. Returns this rank's
    launches, errors, walls and peak memory; the parent checks them."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    stages = make_mesh((world,), ("stage",), device_type="cuda")
    out = {"backend": torch.distributed.get_backend(), "transport": (
        "host" if on_host(torch.distributed.group.WORLD) else "device")}

    # Q1: this rank holds its own head conv and the tail
    c = torch.load(os.path.join(tmp, "q1.pt"))
    own = [None if w is None or (i < GROUP_PLAN.sp and i != rank) else w.cuda()
           for i, w in enumerate(c["params"])]
    x, net = c["x"].cuda(), group_net()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        y, got, ms = q_counted(lambda: hybrid_forward(own, net, x, GROUP_PLAN, mesh=stages), 3)
    own[rank].requires_grad_(True)
    hybrid_forward(own, net, x, GROUP_PLAN, mesh=stages, use_kernel=False).sum().backward()
    out["q1"] = {"err": normalised_err(y, c["out"].cuda()), "launches": got, "ms": ms,
                 "grad_err": normalised_err(own[rank].grad, c["grads"][rank].cuda()),
                 "peak_gb": peak_gb()}
    del c, own, x, y

    # Q2: the same seeded StarCoder2-3B as phase M on every rank; rank i reads
    # stage i's head blocks
    gen, cfg = zoo_gen("M"), get_config(LM_ARCH)
    torch.cuda.reset_peak_memory_stats()
    params = transformer.init_lm(cfg, generator=gen, device="cuda", dtype=torch.bfloat16)
    tokens = torch.randint(0, cfg.vocab, (PREFILL_BATCH, PREFILL_SEQ), generator=gen,
                           device="cuda")
    with torch.inference_mode():
        logits, got, ms = q_counted(
            lambda: hybrid_lm_forward(params, cfg, tokens, HYBRID_LM_PLAN, stages), 3)
    out["q2"] = {"err": normalised_err(logits, torch.load(os.path.join(tmp, "q2.pt")).cuda()),
                 "launches": got, "ms": ms, "peak_gb": peak_gb()}
    del params, logits

    # Q3: this rank's 96 experts, drawn as the whole layer is drawn
    mesh = make_local_mesh(model=world, device_type="cuda")
    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_LAYERS)
    n_local = cfg.moe.n_experts // world
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(Q_SEED)
    p = moe.init_moe_mlp(gen, cfg, torch.bfloat16, device="cuda",
                         experts=(rank * n_local, (rank + 1) * n_local))
    d = torch.load(os.path.join(tmp, "q3.pt"))
    x = d["x"].cuda()
    specs = dict(act.default_specs(mesh), _ep_mesh=(mesh, "model"))
    with torch.inference_mode(), act.activation_specs(specs):
        (y, aux, dropped), got, ms = q_counted(lambda: moe.moe_mlp(x, p, cfg, use_kernel=True), 3)
        xf = x.reshape(-1, x.shape[-1])
        idx = moe.route(xf, p["router"], cfg, use_kernel=True)[3]
    k, t = cfg.moe.top_k, xf.shape[0]
    (e_ep, o_ep), (e_d, o_d) = idx.sort(-1), d["idx"].cuda().sort(-1)
    same = (e_ep == e_d).all(-1)
    kept = moe.dispatch(idx, cfg)[2].reshape(k, t).t().gather(1, o_ep)
    kept_d = d["keep"].cuda().reshape(k, t).t().gather(1, o_d)
    mask = same & (kept == kept_d).all(-1)
    out["q3"] = {"err": normalised_err(y.reshape(t, -1)[mask], d["y"].cuda().reshape(t, -1)[mask]),
                 "tokens": int(mask.sum()), "agree": same.float().mean().item(),
                 "aux": aux.item(), "aux_dense": d["aux"], "dropped": int(dropped),
                 "dropped_dense": d["dropped"], "launches": got, "ms": ms,
                 "expert_gb": sum(p[name].numel() * 2 for name in ("w_up", "w_gate", "w_down"))
                 / 1e9, "peak_gb": peak_gb()}
    del p, d, x, y

    # Q4: compressed_psum of seeded gradients
    g, e = (tree.map_tree(torch.Tensor.cuda, t) for t in q_grads(rank))
    total, err = compressed_psum(g, None, e)
    out["q4"] = {"total": {k: v.cpu() for k, v in tree.flatten(total)},
                 "err": {k: v.cpu() for k, v in tree.flatten(err)}}
    return out


def q_moe_reference(tmp: str) -> dict:
    """Kimi-K2's MoE MLP, all 384 experts (33.8 GB), seeded, and its input at
    phase P's prefill shape: the dense kernel route's output, aux loss, experts
    and kept assignments, saved for the ranks; the layer is freed."""
    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(Q_SEED)
    p = moe.init_moe_mlp(gen, cfg, torch.bfloat16, device="cuda")
    x = torch.randn((PREFILL_BATCH, PREFILL_SEQ, cfg.d_model), generator=gen,
                    device="cuda").to(torch.bfloat16)
    with torch.inference_mode():
        (y, aux, dropped), got, ms = timed_counted(lambda: moe.moe_mlp(x, p, cfg, use_kernel=True))
        idx = moe.route(x.reshape(-1, cfg.d_model), p["router"], cfg, use_kernel=True)[3]
        keep = moe.dispatch(idx, cfg)[2]
    torch.save({"x": x.cpu(), "y": y.cpu(), "aux": aux.item(), "dropped": int(dropped),
                "idx": idx.cpu(), "keep": keep.cpu()}, os.path.join(tmp, "q3.pt"))
    del p
    return {"launches": got, "ms": ms}


def q_paths(results: list) -> dict:
    """The launches of each Q path by kernel: summed over the ranks, per rank,
    and by route."""
    names = {"q1": "VGG group net, 4 stage ranks", "q2": f"{LM_ARCH} hybrid plan, 4 stage ranks",
             "q3": f"{MOE_ARCH} MoE MLP, expert-parallel over 4 ranks"}
    paths = {}
    for q, path in names.items():
        by = {}
        for kernel in ("conv2d", "matmul", "rmsnorm", "flash_attention"):
            per = [r[q]["launches"][kernel] for r in results]
            if not any(per):
                continue
            by[kernel] = {"launches": sum(per), "launches_per_rank": per}
            if f"{kernel}_routes" in results[0][q]["launches"]:
                routes = [r[q]["launches"][f"{kernel}_routes"] for r in results]
                by[kernel]["launches_by_route"] = {k: sum(x[k] for x in routes) for k in routes[0]}
        paths[f"{path} (Q)"] = by
    return paths


def phase_q(keep: dict) -> dict:
    """Phase C's pipelined head and phase M's hybrid plan across Q_RANKS
    processes, one stage a rank; Kimi-K2's MoE MLP expert-parallel; and
    compressed_psum. The ranks share cuda:0 and talk over gloo through host
    memory: their walls are 4 processes time-sharing one card and say
    nothing of scaling across cards."""
    net, plan = group_net(), GROUP_PLAN
    t_ref = time.perf_counter()
    # Q1's reference gradient: the sequential loss sum(forward) on the plain route
    c = keep.pop("C")
    params = [None if w is None else w.cuda().requires_grad_(i < plan.sp)
              for i, w in enumerate(c["params"])]
    forward(params, net, c["x"].cuda(), use_kernel=False).sum().backward()
    c["grads"] = [params[i].grad.cpu() for i in range(plan.sp)]
    del params
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="phase-q-") as tmp:
        torch.save(c, os.path.join(tmp, "q1.pt"))
        torch.save(keep.pop("M"), os.path.join(tmp, "q2.pt"))
        torch.cuda.reset_peak_memory_stats()
        dense = q_moe_reference(tmp)
        dense_peak = peak_gb()
        torch.cuda.empty_cache()
        ref_s = time.perf_counter() - t_ref
        _build.build_all()  # built in setup: the ranks load the libraries, none builds
        t0 = time.perf_counter()
        results = spawn_ranks(q_rank, Q_RANKS, backend=Q_BACKEND, timeout=Q_TIMEOUT,
                              join_timeout=Q_JOIN, args=(tmp,))
        ranks_s = time.perf_counter() - t0
    r0 = results[0]
    print(f"Q {Q_RANKS} ranks on one {torch.cuda.get_device_name(0)}: backend "
          f"{r0['backend']}, transport through {r0['transport']} memory (NCCL refuses two "
          f"ranks on one device); collectives time out after {Q_TIMEOUT} s; references "
          f"{ref_s:.1f} s, the ranks {ranks_s:.1f} s (spawn to join). Walls below are "
          f"{Q_RANKS} processes time-sharing one card, not a multi-card number.")
    check(all(r["backend"] == Q_BACKEND and r["transport"] == "host" for r in results),
          f"Q: backends {[(r['backend'], r['transport']) for r in results]}")

    # Q1: 7 ticks + the 2 tail convs a rank, all fp32 on the direct route
    tail = sum(l.kind == "conv" for l in net.layers[plan.sp:])
    per = plan.n_micro + Q_RANKS - 1 + tail
    for rank, r in enumerate(results):
        q = r["q1"]
        check(q["launches"]["conv2d_routes"] == {"direct": per, "wgmma": 0},
              f"Q1 rank {rank}: conv launches {q['launches']['conv2d_routes']}, expected {per}")
        check(q["err"] <= TOL[torch.float32] and q["grad_err"] <= TOL[torch.float32],
              f"Q1 rank {rank}: against phase C {q['err']:.3e}, stage gradient {q['grad_err']:.3e}")
    print(f"Q1 float32 group net (8,128,112,112) sp=4 n_micro=4 over {Q_RANKS} stage ranks: "
          f"against phase C's one-device output {max(r['q1']['err'] for r in results):.3e}, "
          f"stage-weight gradients (plain route) against the sequential loss's "
          f"{errs_text(results, 'q1', 'grad_err')}; conv launches per rank "
          f"{[r['q1']['launches']['conv2d'] for r in results]} ({plan.n_micro + Q_RANKS - 1} "
          f"ticks + {tail} tail); walls {per_rank(results, 'q1', 'ms')} ms (medians of 3); "
          f"peak {per_rank(results, 'q1', 'peak_gb', 2)} GB")

    # Q2: the one-device plan's block calls, spread over the stages
    cfg, hp = get_config(LM_ARCH), HYBRID_LM_PLAN
    want = expected_launches(cfg)
    per_block = (want["matmul"] - 1) // cfg.n_layers
    calls = (hp.n_micro + hp.n_stages - 1) * hp.layers_per_stage + cfg.n_layers - hp.sp
    for rank, r in enumerate(results):
        check_launches(f"Q2 rank {rank}", r["q2"]["launches"], {"wgmma": calls * per_block + 1},
                       2 * calls + 1, calls)
        check(r["q2"]["err"] <= TOL[torch.bfloat16],
              f"Q2 rank {rank}: against phase M's pipelined logits {r['q2']['err']:.3e}")
    n_tok = PREFILL_BATCH * PREFILL_SEQ
    print(f"Q2 bfloat16 {LM_ARCH} hybrid plan sp={hp.sp} stages={hp.n_stages} "
          f"micro={hp.n_micro} over {Q_RANKS} stage ranks: against phase M's one-device "
          f"pipelined logits {errs_text(results, 'q2')}; launches per rank "
          f"{r0['q2']['launches']} ({calls} block calls: {hp.n_micro + hp.n_stages - 1} ticks "
          f"x {hp.layers_per_stage} head blocks + {cfg.n_layers - hp.sp} tail); walls "
          f"{per_rank(results, 'q2', 'ms')} ms (medians of 3; "
          f"{n_tok / max(r['q2']['ms'] for r in results) * 1e3:.1f} tokens/s at the slowest); "
          f"peak {per_rank(results, 'q2', 'peak_gb', 2)} GB")

    # Q3: a router, its 96 experts and the shared expert a rank, against the dense route
    mcfg = get_config(MOE_ARCH)
    per = 1 + 3 * mcfg.moe.n_experts // Q_RANKS + 3 * bool(mcfg.moe.n_shared)
    for rank, r in enumerate(results):
        q = r["q3"]
        check_launches(f"Q3 rank {rank}", q["launches"], {"wgmma": per}, 0)
        check(q["tokens"] > 0 and q["err"] <= MOE_GATE,
              f"Q3 rank {rank}: EP against dense {q['err']:.3e} on {q['tokens']} tokens")
        check(abs(q["aux"] - q["aux_dense"]) <= AUX_GATE and q["dropped"] == q["dropped_dense"],
              f"Q3 rank {rank}: aux {q['aux']} against {q['aux_dense']}, dropped "
              f"{q['dropped']} against {q['dropped_dense']}")
    print(f"Q3 bfloat16 {MOE_ARCH} MoE MLP at full width, {mcfg.moe.n_experts} experts over "
          f"{Q_RANKS} ranks ({mcfg.moe.n_experts // Q_RANKS} a rank, "
          f"{r0['q3']['expert_gb']:.2f} GB of experts each), {n_tok} tokens: against the dense "
          f"kernel route {errs_text(results, 'q3')} on "
          f"{r0['q3']['tokens']} tokens whose top-k sets and kept assignments agree (sets agree "
          f"on {r0['q3']['agree']:.4f}); aux {r0['q3']['aux']:.6f} against "
          f"{r0['q3']['aux_dense']:.6f}; dropped {r0['q3']['dropped']} against "
          f"{r0['q3']['dropped_dense']}; matmul launches per rank "
          f"{[r['q3']['launches']['matmul'] for r in results]} (dense route "
          f"{dense['launches']['matmul']}, wall {dense['ms']:.3f} ms, peak {dense_peak:.2f} GB); "
          f"walls {per_rank(results, 'q3', 'ms')} ms (medians of 3); peak "
          f"{per_rank(results, 'q3', 'peak_gb', 2)} GB")

    # Q4: compressed_psum against the formula on the host, exactly
    total, errs = q_formula(Q_RANKS)
    for rank, r in enumerate(results):
        for key, want_t in total.items():
            check(torch.equal(r["q4"]["total"][key], want_t)
                  and torch.equal(r["q4"]["err"][key], errs[rank][key]),
                  f"Q4 rank {rank} {key}: compressed_psum differs from the formula")
    print(f"Q4 float32 compressed_psum over {Q_RANKS} ranks, {len(total)} leaves "
          f"({sum(t.numel() for t in total.values())} values): the int32 sum, the max scale "
          f"and every rank's error feedback equal the formula on the host exactly")
    return q_paths(results)


# ---------------------------------------------------------------------------
# Phase R: the sharded steps on a DTensor mesh (4 gloo ranks on the one card)
# ---------------------------------------------------------------------------

R_RANKS = 4
R_BACKEND = "gloo"  # NCCL refuses two ranks on one device ("Duplicate GPU detected")
R_TIMEOUT = 600  # seconds: any collective of the ranks' group (weights move through host memory)
R_JOIN = 1200  # seconds: the whole of phase R's ranks
R_SEED = 21
R_PREFILL = ShapeSpec("r_prefill", "prefill", PREFILL_SEQ, PREFILL_BATCH)
R_DECODE = ShapeSpec("r_decode", "decode", 64, SLOTS)  # a 64-slot cache, 32 a rank on `model`
R_TICKS = 8
R_TRAIN = ShapeSpec("r_train", "train", PREFILL_SEQ, PREFILL_BATCH)
R_TRAIN_STEPS = 2
R_EP_EXPERTS = 32  # of Kimi-K2's 384: the dense reference's fp32 weights and grads, 11.3 GB
R_AUX_WEIGHT = 0.01
R_TRAINER = ShapeSpec("r_trainer", "train", 64, 8)
R_TRAINER_STEPS = 4  # checkpoints after step 3 (restored onto the other mesh) and step 4
R_TRAINER_CKPT = 3
R_SSD = (4, 512, 80, 64, 64, 256)  # Zamba2-2.7B's prefill SSD: B, S, heads, P, N, chunk
R_SEEN: dict = {}  # rank 0's R1 collectives and launch shapes, for phase S


def r_ep_config():
    """Kimi-K2's MoE MLP at full width (d_model, expert width, top-k, the
    shared expert as published), one layer, R_EP_EXPERTS experts."""
    cfg = get_config(MOE_ARCH)
    return dataclasses.replace(cfg, n_layers=1,
                               moe=dataclasses.replace(cfg.moe, n_experts=R_EP_EXPERTS))


def r_ep_inputs(gen, cfg, experts=None):
    """The MoE MLP's seeded fp32 weights (``experts``: a rank's range), then
    its input and the loss's weights, drawn after them on every rank."""
    p = moe.init_moe_mlp(gen, cfg, torch.float32, device="cuda", experts=experts)
    shape = (PREFILL_BATCH, PREFILL_SEQ, cfg.d_model)
    return p, torch.randn(shape, generator=gen, device="cuda"), \
        torch.randn(shape, generator=gen, device="cuda")


def r_ep_grads(p, x, c, cfg) -> dict:
    """Autograd of sum(y * c) + R_AUX_WEIGHT * aux through moe_mlp (the
    plain route): {"x": dx, leaf path: its gradient}."""
    leaves = dict(tree.flatten(p))
    for t in [x, *leaves.values()]:
        t.requires_grad_()
    y, aux, _ = moe.moe_mlp(x, p, cfg)
    grads = torch.autograd.grad(torch.sum(y * c) + R_AUX_WEIGHT * aux, [x, *leaves.values()])
    return dict(zip(["x", *leaves], grads))


def r_references(tmp: str) -> dict:
    """The one-device result of each step, on the seeded weights and batches
    the ranks draw, saved to ``tmp`` for them; everything on the card is
    freed after each."""
    cfg, out = get_config(LM_ARCH), {}
    # R1, R2: bf16 weights, build_step's prefill and 8 greedy decode ticks
    params = api.init_params(cfg, generator=torch.Generator(device="cuda").manual_seed(R_SEED),
                             device="cuda", dtype=torch.bfloat16)
    batch = make_batch(cfg, R_PREFILL, seed=R_SEED, device="cuda")
    step = build_step(cfg, R_PREFILL, device="cuda")
    logits, got, ms = timed_counted(lambda: step(params, batch), 2)
    out["r1"] = {"launches": got, "ms": ms}
    torch.save(logits.cpu(), os.path.join(tmp, "r1.pt"))
    del logits
    step = build_step(cfg, R_DECODE, device="cuda")
    cache = api.init_cache(cfg, SLOTS, R_DECODE.seq_len, device="cuda")
    toks, inputs, ticks, walls = batch["tokens"][:SLOTS, :1], [], [], []
    for i in range(R_TICKS):
        pos = torch.full((SLOTS,), i, dtype=torch.int32, device="cuda")
        (lg, cache), got, ms = timed_counted(lambda: step(params, cache, toks, pos))
        inputs.append(toks.cpu())
        ticks.append(lg.cpu())
        walls.append(ms)
        toks = lg.argmax(-1, keepdim=True).to(torch.int32)
    torch.save({"inputs": inputs, "logits": ticks}, os.path.join(tmp, "r2.pt"))
    out["r2"] = {"launches": got, "ms": statistics.median(walls)}
    del params, cache, batch
    torch.cuda.empty_cache()

    # R3: fp32 master weights, build_step's train step (phase K's code path)
    # computing in fp32, the dtype of R3's 2e-4 gate
    gen = torch.Generator(device="cuda").manual_seed(R_SEED + 1)
    params = api.init_params(cfg, generator=gen, device="cuda")
    opt = adamw.init(params)
    batch = make_batch(cfg, R_TRAIN, seed=R_SEED + 1, device="cuda")
    step, losses = build_step(cfg, R_TRAIN, device="cuda", compute_dtype=torch.float32), []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(R_TRAIN_STEPS):
        (params, opt, loss, gnorm), got, ms = timed_counted(lambda: step(params, opt, batch))
        losses.append((loss.item(), gnorm.item(), ms))
    out["r3"] = {"losses": losses, "launches": got, "peak_gb": peak_gb()}
    del opt
    torch.save({k: v.cpu() for k, v in tree.flatten(params)}, os.path.join(tmp, "r3.pt"))
    del params, batch
    torch.cuda.empty_cache()

    # R4: the dense route's autograd over all R_EP_EXPERTS experts
    ecfg = r_ep_config()
    p, x, c = r_ep_inputs(torch.Generator(device="cuda").manual_seed(R_SEED + 2), ecfg)
    grads = r_ep_grads(p, x, c, ecfg)
    torch.save({k: g.cpu() for k, g in grads.items()}, os.path.join(tmp, "r4.pt"))
    del p, x, c, grads
    torch.cuda.empty_cache()

    # R6: one bf16 SSD call at Zamba2's prefill shape on the one device's kernel
    args = ssd_inputs(*R_SSD[:5], torch.bfloat16,
                      torch.Generator(device="cuda").manual_seed(R_SEED + 3))
    y, route = counted_ssd(args, R_SSD[5])
    check(route == "wgmma", f"R6 one device: the SSD planned {route}")
    torch.save({"args": [a.cpu() for a in args], "y": y.cpu()}, os.path.join(tmp, "r6.pt"))
    del args, y
    return out


def r_probe(mesh) -> dict:
    """R0: DTensor redistributions of a seeded bf16 tensor on cuda:0 over the
    ranks' backend, each against the source bit for bit, and the
    placements of a DTensor matmul."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor

    gen = torch.Generator(device="cuda").manual_seed(R_SEED)
    src = torch.randn(8, 12, generator=gen, device="cuda").to(torch.bfloat16)
    out = {}
    for name, (a, b) in {"S0->R": ((Shard(0), Shard(0)), (Replicate(), Replicate())),
                         "R->S1": ((Replicate(), Replicate()), (Shard(1), Shard(1))),
                         "S0->S1": ((Shard(0), Replicate()), (Shard(1), Replicate())),
                         "S0S1->S1S0": ((Shard(0), Shard(1)), (Shard(1), Shard(0)))}.items():
        d = distribute_tensor(src, mesh, a, src_data_rank=None).redistribute(mesh, b)
        out[name] = d.to_local().device == src.device and torch.equal(d.full_tensor(), src)
    d = DTensor.from_local(src.clone(), mesh, (Partial(), Replicate()), run_check=False)
    d = d.redistribute(mesh, (Shard(0), Replicate()))
    out["P->S0"] = d.to_local().device == src.device and torch.equal(d.full_tensor(), 2 * src)
    a = distribute_tensor(src.float(), mesh, (Shard(0), Shard(1)), src_data_rank=None)
    b = distribute_tensor(src.float().t().contiguous(), mesh, (Replicate(), Shard(0)),
                          src_data_rank=None)
    out["matmul"] = str(tuple((a @ b).placements))
    return out


class LaunchShapes:
    """Wraps the ctypes launchers of the matmul, RMSNorm and flash kernels in
    this process: each launch's tensor shapes are counted, and a DTensor at
    a launch raises (``refuse_dtensor`` refuses one before; this holds the
    path to it)."""

    def __init__(self):
        from repro_torch.kernels.flash_attention import ops as flash_ops
        from repro_torch.kernels.matmul import ops as matmul_ops
        from repro_torch.kernels.rmsnorm import ops as rmsnorm_ops

        self.shapes = {"matmul": {}, "rmsnorm": {}, "flash_attention": {}}
        for mod, attr, name, n in ((matmul_ops, "launch", "matmul", 2),
                                   (rmsnorm_ops, "rmsnorm_rows", "rmsnorm", 1),
                                   (flash_ops, "launch", "flash_attention", 2)):
            setattr(mod, attr, self._wrap(getattr(mod, attr), name, n))

    def _wrap(self, fn, name: str, n: int):
        from torch.distributed.tensor import DTensor

        def launch(*args, **kw):
            if any(isinstance(a, DTensor) for a in args):
                raise RuntimeError(f"a DTensor reached the {name} kernel's launch")
            key = tuple(tuple(a.shape) for a in args[:n])
            self.shapes[name][key] = self.shapes[name].get(key, 0) + 1
            return fn(*args, **kw)

        return launch

    def take(self) -> dict:
        out = {k: dict(v) for k, v in self.shapes.items()}
        for v in self.shapes.values():
            v.clear()
        return out


def local_err(dt, ref: torch.Tensor) -> float:
    """max |this rank's shard of ``dt`` - the same slice of ``ref``| (``ref``
    the global tensor, on the host)."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    shape, offset = compute_local_shape_and_global_offset(dt.shape, dt.device_mesh,
                                                          dt.placements)
    part = ref[tuple(slice(o, o + s) for o, s in zip(offset, shape))]
    return (dt.to_local().float() - part.cuda().float()).abs().max().item()


def r_sharded_counted(fn, launch_shapes, reps: int = 1):
    """timed_counted of a sharded call, with its collectives by kind
    (``CommDebugMode``) and its launches' shapes."""
    from torch.distributed.tensor.debug import CommDebugMode

    comm = CommDebugMode()
    with comm:
        out, got, ms = timed_counted(fn, reps)
    comms = {str(k).split(".")[-1]: v // reps for k, v in comm.get_comm_counts().items()}
    shapes = {k: {s: n // reps for s, n in v.items()} for k, v in launch_shapes.take().items()}
    return out, got, ms, comms, shapes


def r_rank(rank: int, world: int, tmp: str) -> dict:
    """Phase R on one rank of ``world``, all on cuda:0: R0 the probe, R1 the
    sharded prefill, R2 decode ticks, R3 train steps, R4 expert parallelism
    with a backward, R5 the Trainer across meshes. Returns this rank's
    launches, local shapes, collectives, errors, walls and peaks; the
    parent checks them."""
    import logging

    from torch.distributed.tensor import DTensor

    # DTensor warns at every (Partial, Partial) -> Replicate that a 2-D mesh
    # takes two all-reduces; CommDebugMode counts them
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_local_mesh(model=2, device_type="cuda")  # (data 2, model 2)
    cfg = get_config(LM_ARCH)
    shapes = LaunchShapes()
    out = {"r0": r_probe(mesh)}

    # R1: the seeded bf16 weights, each rank keeping its shards (the ranks
    # draw the whole model in turn: its peak is one rank's at a time)
    torch.cuda.reset_peak_memory_stats()
    before = requested_bytes()
    params = init_params_on_mesh(cfg, mesh, seed=R_SEED, dtype=torch.bfloat16)
    draw_gb = peak_gb()
    torch.cuda.reset_peak_memory_stats()
    step = build_step(cfg, R_PREFILL, mesh=mesh)
    batch = make_batch(cfg, R_PREFILL, seed=R_SEED, device="cuda")
    arg_bytes = requested_bytes() - before  # this rank's shards and batch
    logits, got, ms, comms, seen = r_sharded_counted(lambda: step(params, batch), shapes, 2)
    ref = torch.load(os.path.join(tmp, "r1.pt"))
    out["r1"] = {"err": local_err(logits, ref), "ref_max": ref.abs().max().item(),
                 "placements": str(tuple(logits.placements)), "launches": got, "ms": ms,
                 "comms": comms, "shapes": seen, "peak_gb": peak_gb(), "draw_gb": draw_gb,
                 "arg_bytes": arg_bytes}
    del logits, ref
    # the step's own peak: what it allocates above its arguments (phase S1's count)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = requested_bytes()
    logits = step(params, batch)
    torch.cuda.synchronize()
    out["r1"]["step_peak"] = requested_bytes("peak") - base
    del logits
    shapes.take()

    # R2: decode ticks on the one-device run's tokens (teacher-forced)
    ref = torch.load(os.path.join(tmp, "r2.pt"))
    step = build_step(cfg, R_DECODE, mesh=mesh)
    cache = api.init_cache(cfg, SLOTS, R_DECODE.seq_len, device="cuda")
    ticks = []
    for i in range(R_TICKS):
        toks = ref["inputs"][i].cuda()
        pos = torch.full((SLOTS,), i, dtype=torch.int32, device="cuda")
        (lg, cache), got, ms, comms, seen = r_sharded_counted(
            lambda: step(params, cache, toks, pos), shapes)
        ticks.append({"err": local_err(lg, ref["logits"][i]),
                      "ref_max": ref["logits"][i].abs().max().item(),
                      "argmax": lg.full_tensor().argmax(-1).cpu(), "launches": got, "ms": ms,
                      "comms": comms, "shapes": seen})
    out["r2"] = {"ticks": ticks, "cache": str(tuple(cache["k"].placements)),
                 "peak_gb": peak_gb()}
    del params, cache, ref
    torch.cuda.empty_cache()

    # R3: fp32 master weights, build_step's train step on the mesh
    torch.cuda.reset_peak_memory_stats()
    params = init_params_on_mesh(cfg, mesh, seed=R_SEED + 1)
    draw_gb = peak_gb()
    torch.cuda.reset_peak_memory_stats()
    opt = adamw.init(params)
    step = build_step(cfg, R_TRAIN, mesh=mesh, compute_dtype=torch.float32)
    batch = make_batch(cfg, R_TRAIN, seed=R_SEED + 1, device="cuda")
    losses = []
    for _ in range(R_TRAIN_STEPS):
        (params, opt, loss, gnorm), got, ms, comms, _ = r_sharded_counted(
            lambda: step(params, opt, batch), shapes)
        losses.append((loss.item(), gnorm.item(), ms))
    out["r3"] = {"losses": losses, "launches": got, "comms": comms, "peak_gb": peak_gb(),
                 "draw_gb": draw_gb}
    del opt
    ref = torch.load(os.path.join(tmp, "r3.pt"), mmap=True)
    out["r3"]["errs"] = {k: (local_err(v, ref[k]), ref[k].abs().max().item())
                         for k, v in tree.flatten(params)}
    del params, ref
    torch.cuda.empty_cache()

    # R4: rank r holds experts [r n, (r + 1) n) of the seeded layer; grads of every leaf
    ecfg = r_ep_config()
    n_local = R_EP_EXPERTS // world
    ep = make_mesh((1, world), ("data", "model"), device_type="cuda")
    lo, hi = rank * n_local, (rank + 1) * n_local
    p, x, c = r_ep_inputs(torch.Generator(device="cuda").manual_seed(R_SEED + 2), ecfg, (lo, hi))
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with act.activation_specs(dict(act.default_specs(ep), _ep_mesh=(ep, "model"))):
        grads = r_ep_grads(p, x, c, ecfg)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    ref = torch.load(os.path.join(tmp, "r4.pt"), mmap=True)
    errs = {}
    for k, g in grads.items():
        want = ref[k][lo:hi] if k in ("w_up", "w_gate", "w_down") else ref[k]
        errs[k] = (g - want.cuda()).abs().max().item() / max(want.abs().max().item(), 1e-30)
    out["r4"] = {"errs": errs, "ms": ms, "peak_gb": peak_gb(), "experts": hi - lo}
    del p, x, c, grads, ref
    torch.cuda.empty_cache()

    # R6: the same SSD call, its batch split over `data` and its heads over
    # `model` (ssd_on_shards): one kernel launch a rank, on its 40 heads
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    ref = torch.load(os.path.join(tmp, "r6.pt"))
    want = [(Shard(0), Shard(2)), (Shard(0), Shard(2)), (Replicate(), Shard(0)),
            (Shard(0), Replicate()), (Shard(0), Replicate())]
    args = [distribute_tensor(a.cuda(), mesh, pl, src_data_rank=None)
            for a, pl in zip(ref["args"], want)]
    torch.cuda.synchronize()
    reset_counts()
    y = ssd_on_shards(*args, chunk=R_SSD[5])
    torch.cuda.synchronize()
    out["r6"] = {"launches": ssd.launches, "routes": dict(ssd.launches_by_route),
                 "local": tuple(y.to_local().shape), "placements": str(tuple(y.placements)),
                 "err": (y.full_tensor().float() - ref["y"].cuda().float()).abs().max().item(),
                 "ref_max": ref["y"].float().abs().max().item()}
    del args, y, ref
    torch.cuda.empty_cache()

    # R5: the Trainer on (4, 1), restored onto (2, 2)
    rcfg, ckpt = get_config(LM_ARCH).reduced(), os.path.join(tmp, "r5")
    tcfg = TrainConfig(steps=R_TRAINER_STEPS, ckpt_every=R_TRAINER_CKPT, ckpt_dir=ckpt,
                       log_every=100, compute_dtype="float32")
    ta = Trainer(rcfg, R_TRAINER, tcfg, mesh=make_mesh((world, 1), ("data", "model"),
                                                       device_type="cuda"))
    ta.run()
    tb = Trainer(rcfg, R_TRAINER, tcfg, mesh=mesh)
    params, opt = restore_trainer_state(tb, R_TRAINER_CKPT)
    with np.load(os.path.join(ckpt, f"step_{R_TRAINER_CKPT:08d}", "arrays.npz")) as z:
        saved = {k: torch.from_numpy(z[k]) for k in z.files}
    restored = dict(tree.flatten({"params": params, "opt": opt}))
    exact = sorted(restored) == sorted(saved) and all(
        (local_err(v, saved[k]) if isinstance(v, DTensor)
         else (v.cpu() - saved[k]).abs().max().item()) == 0 for k, v in restored.items())
    _, _, loss, _ = tb.train_step(params, opt, tb._make_batch(R_TRAINER_CKPT))
    out["r5"] = {"exact": exact, "leaves": len(saved), "losses": [s["loss"] for s in ta.stats],
                 "loss_b": loss.item(), "placements": str(tuple(
                     params["blocks"]["attn"]["wq"].placements))}
    return out


def r_local_products(cfg, rows: int) -> dict:
    """((M, K), (K, N)) -> matmul launches a rank makes in one forward on the
    (data 2, model 2) mesh: ``rows`` rows a rank; the column-parallel
    products (wq, wk, wv, w_up, the head) split N over ``model``, the
    row-parallel ones (wo, w_down) split K."""
    hd, n = cfg.head_dim, cfg.n_layers
    out: dict = {}

    def add(k, nn, count):
        key = ((rows, k), (k, nn))
        out[key] = out.get(key, 0) + count

    for k, nn in [(cfg.d_model, cfg.n_heads * hd), (cfg.d_model, cfg.n_kv * hd),
                  (cfg.d_model, cfg.n_kv * hd), (cfg.d_model, cfg.d_ff)]:
        add(k, nn // 2, n)
    for k, nn in [(cfg.n_heads * hd, cfg.d_model), (cfg.d_ff, cfg.d_model)]:
        add(k // 2, nn, n)
    add(cfg.d_model, cfg.vocab // 2, 1)
    return out


def r_check_shapes(where: str, seen: dict, cfg, rows: int, flash: int) -> None:
    """The local shapes each kernel saw on one rank: every product at ``rows``
    rows and its split, every RMSNorm over ``rows`` rows, every flash call
    on this rank's batch rows and heads."""
    check(seen["matmul"] == r_local_products(cfg, rows),
          f"{where}: matmul local shapes {seen['matmul']}")
    check(seen["rmsnorm"] == {((rows, cfg.d_model),): 2 * cfg.n_layers + 1},
          f"{where}: rmsnorm local shapes {seen['rmsnorm']}")
    b = PREFILL_BATCH // 2
    want = {((b, PREFILL_SEQ, cfg.n_heads // 2, cfg.head_dim),
             (b, PREFILL_SEQ, cfg.n_kv // 2, cfg.head_dim)): flash} if flash else {}
    check(seen["flash_attention"] == want,
          f"{where}: flash local shapes {seen['flash_attention']}")


def r_paths(results: list) -> dict:
    """The launches of R1's prefill and one R2 tick by kernel, summed over the
    ranks and per rank, with the matmul and flash routes."""
    paths = {}
    for name, pick in ((f"{LM_ARCH} prefill, 4 ranks on a (data 2, model 2) mesh (R1)",
                        lambda r: r["r1"]["launches"]),
                       (f"{LM_ARCH} decode tick, 4 ranks on a (data 2, model 2) mesh (R2)",
                        lambda r: r["r2"]["ticks"][-1]["launches"])):
        by = {}
        for kernel in ("matmul", "rmsnorm", "flash_attention"):
            per = [pick(r)[kernel] for r in results]
            if any(per):
                by[kernel] = {"launches": sum(per), "launches_per_rank": per}
                if f"{kernel}_routes" in pick(results[0]):
                    by[kernel]["launches_by_route"] = {
                        k: sum(pick(r)[f"{kernel}_routes"][k] for r in results)
                        for k in pick(results[0])[f"{kernel}_routes"]}
        paths[name] = by
    per = [r["r6"]["launches"] for r in results]
    paths[f"{HYBRID_ARCH} prefill SSD on shards, 4 ranks on a (data 2, model 2) mesh (R6)"] = {
        "ssd": {"launches": sum(per), "launches_per_rank": per,
                "launches_by_route": {k: sum(r["r6"]["routes"][k] for r in results)
                                      for k in results[0]["r6"]["routes"]}}}
    return paths


def phase_r() -> dict:
    """StarCoder2-3B's sharded steps (``build_step(mesh=)``) on a (data 2,
    model 2) DTensor mesh of R_RANKS processes sharing cuda:0 over gloo: the
    prefill and decode with the matmul, RMSNorm and flash kernels on each
    rank's local shards, the train step on the plain route, each held to the
    one-device step on the same seeded weights and batches; Kimi-K2's MoE MLP
    expert-parallel with a backward, held to the dense route's autograd;
    the Trainer checkpointing on (4, 1) and restoring onto (2, 2). The walls
    are 4 processes time-sharing one card through host memory: no number
    here speaks of scaling across cards."""
    cfg = get_config(LM_ARCH)
    t_ref = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="phase-r-") as tmp:
        torch.cuda.reset_peak_memory_stats()
        ref = r_references(tmp)
        ref_peak = peak_gb()
        torch.cuda.empty_cache()
        ref_s = time.perf_counter() - t_ref
        _build.build_all()  # built in setup: the ranks load the libraries, none builds
        t0 = time.perf_counter()
        results = spawn_ranks(r_rank, R_RANKS, backend=R_BACKEND, timeout=R_TIMEOUT,
                              join_timeout=R_JOIN, args=(tmp,))
        ranks_s = time.perf_counter() - t0
        r2_ref = torch.load(os.path.join(tmp, "r2.pt"))
    r0 = results[0]
    print(f"R {R_RANKS} ranks on one {torch.cuda.get_device_name(0)} as a (data 2, model 2) "
          f"DTensor mesh over {R_BACKEND} (NCCL refuses two ranks on one device); references "
          f"{ref_s:.1f} s (peak {ref_peak:.2f} GB), the ranks {ranks_s:.1f} s (spawn to join). "
          f"Walls below are {R_RANKS} processes time-sharing one card, not a multi-card number.")

    # R0: redistributions on the card over gloo
    for rank, r in enumerate(results):
        check(all(v is True for k, v in r["r0"].items() if k != "matmul")
              and r["r0"]["matmul"] == "(Shard(dim=0), Partial(sum))",
              f"R0 rank {rank}: {r['r0']}")
    print(f"R0 bfloat16 redistributions on cuda:0 over {R_BACKEND}, every rank: "
          f"{', '.join(k for k in r0['r0'] if k != 'matmul')} bit-equal to the source; a "
          f"DTensor matmul of (S0, S1) by (R, S0) gives {r0['r0']['matmul']}")

    # R1: the one-device prefill's launches a rank, at the local shapes
    want = expected_launches(cfg)
    check_launches("R1 one device", ref["r1"]["launches"], {"wgmma": want["matmul"]},
                   want["rmsnorm"], want["flash_attention"])
    rows = PREFILL_BATCH * PREFILL_SEQ // 2
    for rank, r in enumerate(results):
        check_launches(f"R1 rank {rank}", r["r1"]["launches"], {"wgmma": want["matmul"]},
                       want["rmsnorm"], want["flash_attention"])
        r_check_shapes(f"R1 rank {rank}", r["r1"]["shapes"], cfg, rows, want["flash_attention"])
    err = max(r["r1"]["err"] for r in results) / r0["r1"]["ref_max"]
    check(err <= TOL[torch.bfloat16], f"R1: the sharded prefill against one device {err:.3e}")
    print(f"R1 bfloat16 {LM_ARCH} prefill B={PREFILL_BATCH} S={PREFILL_SEQ} through "
          f"build_step(prefill, mesh=), kernels on local shards: logits {r0['r1']['placements']}"
          f" against the one-device build_step {err:.3e}; launches per rank "
          f"{[r['r1']['launches']['matmul'] for r in results]} matmul (all wgmma), "
          f"{r0['r1']['launches']['rmsnorm']} rmsnorm, {r0['r1']['launches']['flash_attention']}"
          f" flash (all wgmma), as one device's; local shapes: matmul M = {rows} "
          f"{sorted(r0['r1']['shapes']['matmul'].items())}, rmsnorm "
          f"{r0['r1']['shapes']['rmsnorm']}, flash {r0['r1']['shapes']['flash_attention']}; no "
          f"DTensor at a launch; collectives a prefill {r0['r1']['comms']}; walls "
          f"{per_rank(results, 'r1', 'ms')} ms (median of 2; one device {ref['r1']['ms']:.3f} "
          f"ms); peak {per_rank(results, 'r1', 'peak_gb', 2)} GB (the draw, one rank at a "
          f"time: {r0['r1']['draw_gb']:.2f} GB)")

    # R2: decode ticks, teacher-forced on the one-device tokens
    want_tick = expected_launches(cfg, decode=True)
    errs, same, margin_ok, n = [], 0, True, 0
    for i in range(R_TICKS):
        lg = r2_ref["logits"][i]
        top2 = lg.topk(2, dim=-1).values
        e = max(r["r2"]["ticks"][i]["err"] for r in results)
        errs.append(e / results[0]["r2"]["ticks"][i]["ref_max"])
        for rank, r in enumerate(results):
            t = r["r2"]["ticks"][i]
            check_launches(f"R2 rank {rank} tick {i}", t["launches"],
                           {"wgmma": want_tick["matmul"]}, want_tick["rmsnorm"])
            r_check_shapes(f"R2 rank {rank} tick {i}", t["shapes"], cfg, SLOTS // 2, 0)
        got = results[0]["r2"]["ticks"][i]["argmax"]
        for s in range(SLOTS):
            n += 1
            same += int(got[s] == lg[s].argmax())
            if top2[s, 0] - top2[s, 1] > 2 * e:
                margin_ok &= bool(got[s] == lg[s].argmax())
        check(all(torch.equal(r["r2"]["ticks"][i]["argmax"], got) for r in results),
              f"R2 tick {i}: the ranks' tokens differ")
    check(max(errs) <= TOL[torch.bfloat16], f"R2: logits against one device {max(errs):.3e}")
    check(margin_ok, "R2: a token differs from one device's where the top-2 margin exceeds "
          "twice the logits' error")
    t0r = r0["r2"]["ticks"]
    print(f"R2 bfloat16 {LM_ARCH} decode, {SLOTS} slots ({SLOTS // 2} a rank on data), a "
          f"{R_DECODE.seq_len}-slot cache placed {r0['r2']['cache']}, {R_TICKS} ticks "
          f"teacher-forced on the one-device tokens: logits against one device max "
          f"{max(errs):.3e} (per tick {[f'{e:.2e}' for e in errs]}); tokens equal to one "
          f"device's {same}/{n} (every one whose top-2 margin exceeds twice the error); "
          f"launches a tick per rank {t0r[-1]['launches']['matmul']} matmul (all wgmma), "
          f"{t0r[-1]['launches']['rmsnorm']} rmsnorm at M = {SLOTS // 2}; collectives a tick "
          f"{t0r[-1]['comms']}; tick {statistics.median(t['ms'] for t in t0r):.1f} ms (median "
          f"of rank 0; one device {ref['r2']['ms']:.3f} ms); peak "
          f"{per_rank(results, 'r2', 'peak_gb', 2)} GB")

    # R3: train steps against the one-device steps
    for i, (loss, gnorm, _) in enumerate(ref["r3"]["losses"]):
        for rank, r in enumerate(results):
            l_r, g_r, _ = r["r3"]["losses"][i]
            check(abs(l_r - loss) <= TOL[torch.float32] * abs(loss)
                  and abs(g_r - gnorm) <= TOL[torch.float32] * abs(gnorm),
                  f"R3 rank {rank} step {i}: loss {l_r} / {loss}, grad norm {g_r} / {gnorm}")
    leaf_errs = {k: max(r["r3"]["errs"][k][0] for r in results) / r0["r3"]["errs"][k][1]
                 for k in r0["r3"]["errs"]}
    worst = max(leaf_errs, key=leaf_errs.get)
    check(leaf_errs[worst] <= TOL[torch.float32],
          f"R3: updated {worst} against one device {leaf_errs[worst]:.3e}")
    check(all(sum(r["r3"]["launches"][k] for k in WRAPPERS) == 0 for r in results),
          "R3: a kernel launched in the train step")
    rel = [(abs(a[0] - b[0]) / abs(b[0]), abs(a[1] - b[1]) / abs(b[1]))
           for a, b in zip(r0["r3"]["losses"], ref["r3"]["losses"])]
    print(f"R3 {LM_ARCH} train step through build_step(train, mesh=), fp32 masters, fp32 "
          f"compute, plain route, B={R_TRAIN.global_batch} S={R_TRAIN.seq_len}, full depth: "
          f"losses {[round(x[0], 6) for x in r0['r3']['losses']]} against one device "
          f"{[round(x[0], 6) for x in ref['r3']['losses']]} (relative loss, grad norm "
          f"{[(f'{a:.2e}', f'{b:.2e}') for a, b in rel]}); updated params against one device "
          f"max {leaf_errs[worst]:.3e} ({worst}; {len(leaf_errs)} leaves); step "
          f"{[round(x[2], 1) for x in r0['r3']['losses']]} ms (one device "
          f"{[round(x[2], 1) for x in ref['r3']['losses']]}); collectives a step "
          f"{r0['r3']['comms']}; peak in the steps per rank "
          f"{per_rank(results, 'r3', 'peak_gb', 2)} GB, "
          f"{sum(r['r3']['peak_gb'] for r in results):.2f} GB summed (the draw, one rank at a "
          f"time: {r0['r3']['draw_gb']:.2f} GB; one device {ref['r3']['peak_gb']:.2f} GB)")

    # R4: expert-parallel gradients against the dense route's
    ecfg = r_ep_config()
    for rank, r in enumerate(results):
        bad = {k: e for k, e in r["r4"]["errs"].items() if not e <= TOL[torch.float32]}
        check(not bad, f"R4 rank {rank}: gradients against the dense route {bad}")
    print(f"R4 float32 {MOE_ARCH} MoE MLP d={ecfg.d_model} expert width "
          f"{ecfg.moe.d_ff_expert} top-{ecfg.moe.top_k}, {R_EP_EXPERTS} experts (cut from "
          f"{get_config(MOE_ARCH).moe.n_experts}), {r0['r4']['experts']} a rank, "
          f"{PREFILL_BATCH * PREFILL_SEQ} tokens, expert-parallel with a backward: the "
          f"gradients of x and of every leaf against the dense route's autograd, max per rank "
          f"{[f'{max(r['r4']['errs'].values()):.2e}' for r in results]}; walls "
          f"{per_rank(results, 'r4', 'ms', 1)} ms; peak {per_rank(results, 'r4', 'peak_gb', 2)}"
          f" GB")

    # R6: the SSD on shards against the one-device kernel
    b, s, h, p, n, chunk = R_SSD
    for rank, r in enumerate(results):
        q = r["r6"]
        check(q["launches"] == 1 and q["routes"]["wgmma"] == 1,
              f"R6 rank {rank}: {q['launches']} SSD launches {q['routes']}, expected 1 wgmma")
        check(q["local"] == (b // 2, s, h // 2, p), f"R6 rank {rank}: local {q['local']}")
        check(q["err"] <= TOL[torch.bfloat16] * q["ref_max"],
              f"R6 rank {rank}: against the one device {q['err'] / q['ref_max']:.3e}")
    q = r0["r6"]
    print(f"R6 bfloat16 SSD B={b} S={s} H={h} P={p} N={n} chunk {chunk} through ssd_on_shards, "
          f"batch over data and heads over model: output {q['placements']}, local {q['local']}, "
          f"{[r['r6']['launches'] for r in results]} launch a rank (all wgmma); gathered output "
          f"against the one-device kernel {max(r['r6']['err'] for r in results) / q['ref_max']:.3e}"
          f" (gate {TOL[torch.bfloat16]})")
    R_SEEN["r1"] = {k: r0["r1"][k] for k in ("comms", "shapes", "arg_bytes", "step_peak")}

    # R5: the Trainer on (4, 1), restored onto (2, 2)
    for rank, r in enumerate(results):
        q = r["r5"]
        want_loss = q["losses"][R_TRAINER_CKPT]
        check(q["exact"], f"R5 rank {rank}: the restore onto (2, 2) is not bit-equal")
        check(abs(q["loss_b"] - want_loss) <= TOL[torch.float32] * abs(want_loss),
              f"R5 rank {rank}: step {R_TRAINER_CKPT} on (2, 2) {q['loss_b']} against "
              f"(4, 1) {want_loss}")
    q = r0["r5"]
    print(f"R5 float32 Trainer({LM_ARCH}.reduced(), mesh=(4, 1)) {R_TRAINER_STEPS} steps "
          f"B={R_TRAINER.global_batch} S={R_TRAINER.seq_len}, losses "
          f"{[round(x, 6) for x in q['losses']]}; the step-{R_TRAINER_CKPT} checkpoint "
          f"restored onto (2, 2) ({q['placements']} for wq): {q['leaves']} leaves bit-equal; "
          f"the next step's loss {q['loss_b']:.6f} against (4, 1)'s "
          f"{q['losses'][R_TRAINER_CKPT]:.6f}")
    return r_paths(results)


# ---------------------------------------------------------------------------
# Phase S: the dry run (fake tensors over a fake process group)
# ---------------------------------------------------------------------------

S_MESH = (2, 2)
S1_ARG_TOL, S1_PEAK_TOL = 0.01, 0.01  # S1's memory against R1's requested bytes
S_PROD = 256  # ranks of the single-pod mesh (16 x 16)
S_WORKERS = 7  # processes of the S2/S3 pool (the machine has 8 cores)
S_BOUND = 180  # seconds: phase S's wall
S_CELLS = [(a, "decode_32k") for a in ARCH_IDS] + \
    [(LM_ARCH, s) for s in ("train_4k", "prefill_32k", "long_500k")]
S_VARIANT_CELL = (LM_ARCH, "train_4k")
S_VARIANTS = ("v0_baseline", "v4_remat_dots")


def s_job(job: tuple):
    """One job of phase S's pool (a spawned process, its own fake process
    group): ("cell", arch, shape) -> run_cell's record on the 16 x 16 mesh;
    ("whole", arch, shape) -> the unsharded step's FLOPs; ("variant", name)
    -> run_variant's record on S_VARIANT_CELL."""
    kind, *rest = job
    if kind == "cell":
        return dryrun.run_cell(*rest, False, device_type="cuda")
    if kind == "whole":
        arch, shape = rest
        return dryrun.count_unsharded(get_config(arch), SHAPES[shape], device_type="cuda").flops
    return run_variant(*S_VARIANT_CELL, rest[0], device_type="cuda")


def phase_s() -> dict:
    """The dry run on this machine, mesh device type cuda: S1 StarCoder2-3B's
    prefill on a fake (data 2, model 2) mesh, its collectives by kind and
    its kernels' local shapes equal to phase R1's measured ones; S2 run_cell
    on the 16 x 16 mesh for every arch at decode_32k and StarCoder2-3B at
    every shape (long_500k skipped), each with its FLOPs a rank against the
    unsharded step's; S3 two hill-climb variants. Nothing is allocated on
    the card and nothing launches. Bounded at S_BOUND seconds."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    from repro_torch.train.steps import BASELINE

    t0 = time.perf_counter()
    cfg = get_config(LM_ARCH)
    with dryrun.fake_world(S_MESH, device_type="cuda") as mesh:
        c = dryrun.count_step(cfg, R_PREFILL, mesh, BASELINE, param_dtype=torch.bfloat16)
    st = c.collective_stats()
    r1 = R_SEEN.get("r1")
    if r1 is None:
        print("S1 not tied to R1: phase R did not run in this call")
    else:
        want = kind_counts(r1["comms"])
        check(st.count_by_kind == want,
              f"S1: collectives {st.count_by_kind}, R1 measured {want}")
        for name in ("matmul", "rmsnorm", "flash_attention"):
            check(c.kernel_shapes.get(name, {}) == r1["shapes"][name],
                  f"S1: {name} local shapes {c.kernel_shapes.get(name)}, R1 "
                  f"{r1['shapes'][name]}")
        # memory: the arguments' local bytes and the step's peak above them,
        # against rank 0's requested bytes in R1 (the matmul's K-split
        # workspace is unseen here)
        for what, got, want, tol in (("arguments", c.argument_bytes, r1["arg_bytes"], S1_ARG_TOL),
                                     ("step peak", c.peak_bytes, r1["step_peak"], S1_PEAK_TOL)):
            print(f"S1 {what}: counted {got} B, R1 measured {want} B "
                  f"({got / want - 1:+.4%}; gate {tol:.0%})")
            check(abs(got - want) <= tol * want,
                  f"S1: {what} counted {got} B, R1 measured {want} B")
    print(f"S1 {LM_ARCH} prefill B={PREFILL_BATCH} S={PREFILL_SEQ} bf16 on a fake (data 2, "
          f"model 2) mesh, device cuda: {c.flops:.6e} FLOPs a rank, collectives "
          f"{st.count_by_kind} ({st.total_bytes} bytes){'' if r1 is None else ', equal to R1'}; "
          f"local products {sorted(c.kernel_shapes['matmul'].items())}; run {c.run_s:.2f} s")

    jobs = [("cell", a, sh) for a, sh in S_CELLS] + \
        [("whole", a, sh) for a, sh in S_CELLS if sh != "long_500k"] + \
        [("variant", v) for v in S_VARIANTS]
    with ProcessPoolExecutor(S_WORKERS, mp_context=mp.get_context("spawn")) as pool:
        got = dict(zip(jobs, pool.map(s_job, jobs)))
    card_gib = torch.cuda.get_device_properties(0).total_memory / 2**30
    for arch, sh in S_CELLS:
        rec = got[("cell", arch, sh)]
        if sh == "long_500k":
            check(rec["status"] == "skipped", f"S2 {arch} {sh}: {rec['status']}")
            print(f"S2 {arch} {sh}: skipped ({rec['reason']})")
            continue
        check(rec["status"] == "ok", f"S2 {arch} {sh}: {rec.get('error', rec['status'])}")
        whole = got[("whole", arch, sh)]
        flops, coll = rec["exact"]["flops"], rec["collectives"]
        gib = rec["memory"]["total_per_device"] / 2**30
        print(f"S2 {arch} {sh} on 16x16: {flops:.6e} FLOPs a rank (x{S_PROD} = "
              f"{flops * S_PROD:.6e} against the unsharded step's {whole:.6e}, ratio "
              f"{flops * S_PROD / whole:.4f}); collectives "
              f"{ {k: v for k, v in coll['bytes_by_kind'].items() if v} } bytes "
              f"({coll['total_count']} calls); {gib:.2f} GiB a device of the card's "
              f"{card_gib:.1f} GiB; run {rec['run_s']} s")
    for v in S_VARIANTS:
        rec = got[("variant", v)]
        e = rec["exact"]
        print(f"S3 {'/'.join(S_VARIANT_CELL)} {v}: {e['flops']:.6e} FLOPs a rank, "
              f"{e['coll_total']:.6e} collective bytes, temp "
              f"{rec['memory']['temp_size_in_bytes'] / 2**30:.2f} GiB, run {rec['run_s']} s")
    wall = time.perf_counter() - t0
    print(f"S wall {wall:.1f} s (bound {S_BOUND} s, {S_WORKERS} processes)")
    check(wall <= S_BOUND, f"phase S took {wall:.1f} s, over its bound of {S_BOUND} s")
    return {}


# ---------------------------------------------------------------------------
# Phase T: the paper's DSE campaign, hyperband's rung 0 screened on the card
# ---------------------------------------------------------------------------

T_NETS = ("vgg16", "vgg19")
T_INPUTS = [(224, 224)]
T_FPGAS = ("ku115", "zc706", "vu9p", "zcu102")
T_PRECISIONS = (16, 8)
T_CLI_CELL = ("vgg16", "ku115", 16)  # the cell the CLI subprocess is held to


def t_without_time(records: list) -> list:
    return [{k: v for k, v in r.items() if k != "search_time_s"} for r in records]


def t_cold_caches() -> None:
    """Empty the analytical model's process-wide caches (the packed layer
    tables and the split/BRAM memos), so each campaign run starts cold."""
    from repro_torch.core import batch_eval, layer_arrays
    for fn in (batch_eval._split_pf, batch_eval._stage_bram, layer_arrays.pack_layers):
        fn.cache_clear()


def t_timed_prescreen(campaign) -> tuple:
    """Wrap ``campaign.prescreen_cells`` (host wall) and the one
    ``screen.screen_cells`` call inside it (CUDA events around it: the
    tables and positions copied in, the screen, the fitnesses copied out);
    returns the list the timings land in and the function that unwraps."""
    seen, prescreen, screen_cells = [], campaign.prescreen_cells, screen.screen_cells

    def timed_screen(*args, **kw):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = screen_cells(*args, **kw)
        end.record()
        torch.cuda.synchronize()
        seen[-1]["card_ms"] = start.elapsed_time(end)
        return out

    def timed_prescreen(*args, **kw):
        seen.append({})
        t0 = time.perf_counter()
        out = prescreen(*args, **kw)
        seen[-1]["host_ms"] = (time.perf_counter() - t0) * 1e3
        return out

    campaign.prescreen_cells, screen.screen_cells = timed_prescreen, timed_screen

    def unwrap():
        campaign.prescreen_cells, screen.screen_cells = prescreen, screen_cells
    return seen, unwrap


def phase_t() -> dict:
    """The port's DSE campaign at the hyperband searcher's default config
    over 16 cells, rung 0 of every cell screened on the card in one call:
    records equal to the run that screens each cell in NumPy (all but the
    search time), a rerun on the card's store that reuses every cell, and
    the CLI in a subprocess giving the in-process run's best design. No
    kernel of the five launches on this path."""
    from repro_torch.dse import campaign
    from repro_torch.dse.store import is_ok

    cells = campaign.expand_cells(T_NETS, T_INPUTS, T_FPGAS, T_PRECISIONS, [1])
    check(len(cells) == 16, f"T: {len(cells)} cells, expected 16")
    with tempfile.TemporaryDirectory(prefix="phase_t_") as tmp:
        reset_counts()
        t_cold_caches()
        seen, unwrap = t_timed_prescreen(campaign)
        try:
            card = campaign.run_campaign(cells, f"{tmp}/card.jsonl", searcher="hyperband",
                                         screen_device="cuda")
            again = campaign.run_campaign(cells, f"{tmp}/card.jsonl", searcher="hyperband",
                                          screen_device="cuda")
            warm = campaign.prescreen_cells(cells, device="cuda")
        finally:
            unwrap()
        launched = counts()
        check(not any(launched.values()), f"T: kernel launches {launched}, expected none")
        check(len(seen) == 2, f"T: {len(seen)} prescreens, expected 2 (the campaign's and "
                              f"one warm call; the rerun screens nothing)")
        check(len(warm) == 16 and all(len(v) == 4096 for v in warm.values()),
              "T: the warm prescreen's fitnesses")
        t_cold_caches()
        host = campaign.run_campaign(cells, f"{tmp}/host.jsonl", searcher="hyperband",
                                     screen_device=None)
        check(len(card.records) == 16 and all(is_ok(r) for r in card.records),
              f"T: {len(card.records)} records, {card.failed_cells} failed")
        for r in card.records:
            o = r["objectives"]
            check(o["feasible"] and math.isfinite(o["gops"]) and o["gops"] > 0
                  and 0 < o["dsp_eff"] <= 1, f"T {r['cell_key']}: objectives {o}")
        if t_without_time(card.records) != t_without_time(host.records):
            bad = next(a["cell_key"] for a, b in zip(card.records, host.records)
                       if t_without_time([a]) != t_without_time([b]))
            raise RuntimeError(f"T: the card-screened record of {bad} differs from the "
                               f"NumPy-screened one")
        check(card.new_evaluations == host.new_evaluations,
              f"T: {card.new_evaluations} evaluations, NumPy-screened {host.new_evaluations}")
        check((again.new_cells, again.reused_cells, again.new_evaluations) == (0, 16, 0),
              f"T: rerun {again.new_cells} new, {again.reused_cells} reused, "
              f"{again.new_evaluations} evaluations")

        net, fpga, prec = T_CLI_CELL
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        t0 = time.perf_counter()
        cli = subprocess.run(
            [sys.executable, "-m", "repro_torch.dse.campaign", "--nets", net, "--fpgas", fpga,
             "--precisions", str(prec), "--searcher", "hyperband", "--device", "cuda",
             "--store", f"{tmp}/cli.jsonl", "-q"],
            env=env, capture_output=True, text=True, timeout=300, cwd=ROOT)
        cli_s = time.perf_counter() - t0
        check(cli.returncode == 0, f"T: the CLI exited {cli.returncode}: {cli.stderr[-2000:]}")
        (cli_rec,) = [json.loads(line) for line in Path(f"{tmp}/cli.jsonl").read_text().splitlines()]
        mine = next(r for r in card.records if r["cell_key"] == cli_rec["cell_key"])
        check((cli_rec["rav"], cli_rec["objectives"]) == (mine["rav"], mine["objectives"]),
              f"T: the CLI's design {cli_rec['rav']} differs from the in-process "
              f"{mine['rav']}")

    wall, host_wall = card.wall_time_s, host.wall_time_s
    first, again_ms = seen[0], seen[1]
    print(f"T campaign {'x'.join(T_NETS)} at 224 x {','.join(T_FPGAS)} x precisions "
          f"{T_PRECISIONS}: 16 cells, hyperband (screen 4096, survivors 16), "
          f"{card.new_evaluations} evaluations; records equal to the NumPy-screened run's "
          f"but the search time; rerun 16 reused, 0 evaluations; CLI exit 0 in "
          f"{cli_s:.2f} s, its {net}/{fpga}/{prec}-bit design equal to the in-process one")
    print(f"T wall {wall:.4f} s card-screened ({16 / wall:.4g} cells/s), {host_wall:.4f} s "
          f"NumPy-screened ({16 / host_wall:.4g} cells/s; both from cold model caches, "
          f"host clock); the campaign's prescreen "
          f"{first['host_ms']:.3f} ms host wall ({first['host_ms'] / 1e3 / wall:.2%} of the "
          f"wall), its screen {first['card_ms']:.3f} ms on the card (CUDA events, copies "
          f"included; {first['card_ms'] / 1e3 / wall:.2%} of the wall); a second prescreen "
          f"of the 16 cells {again_ms['host_ms']:.3f} ms host, {again_ms['card_ms']:.3f} ms "
          f"on the card")
    for r in card.records:
        o, rav = r["objectives"], r["rav"]
        print(f"T {r['cell_key']}: {o['gops']:.6g} GOP/s, DSP eff {o['dsp_eff']:.6g}, RAV "
              f"sp={rav['sp']} b={rav['batch']} dsp={rav['dsp_frac']:.6g} "
              f"bram={rav['bram_frac']:.6g} bw={rav['bw_frac']:.6g}; {r['evaluations']} "
              f"evaluations, {r['search_time_s']} s")
    return {}


# ---------------------------------------------------------------------------
# Phase U: the calibration loop, fed by the card's own kernel timings
# ---------------------------------------------------------------------------

CALIB_DIR = ROOT / "build" / "calib"
U_CONV = (BATCH, 256, 56, 56, 256, 3)  # VGG-16's conv3 at 224 x 224, batch 8
U_OVER_PEAK = 1.05  # no row may read above this times the spec's peak
U_ARCHS = (LM_ARCH, HYBRID_ARCH)
U_SHAPES = ("train_4k", "prefill_32k", "decode_32k")
U_GPUS = (8, 16)
U_PATH = "calibration_rows"
U_SEED = 22


def calib_term(nbytes: float, ops: float) -> tuple[str, float]:
    """The term that bounds a call on the H100 spec, as (axis, predicted s):
    operations over ``peak_flops`` (compute) or bytes over ``hbm_bw``
    (bandwidth)."""
    t_ops, t_bytes = ops / H100.peak_flops, nbytes / H100.hbm_bw
    return ("compute", t_ops) if t_ops >= t_bytes else ("bandwidth", t_bytes)


def calib_row(name: str, nbytes: float, ops: float, meas_s: float) -> dict:
    """One kernel timing as a row of ``benchmarks/run.py --json``'s shape,
    which ``repro_torch.calib.bench_measurements`` reads: ``calib_term``
    predicts the call's time and ``meas_s`` is the time the card took."""
    axis, pred = calib_term(nbytes, ops)
    return {"name": name, "us_per_call": meas_s * 1e6,
            "derived": f"calib_part={H100.name};calib_axis={axis};"
                       f"calib_pred_s={pred!r};calib_meas_s={meas_s!r}"}


def calib_bench(rows: list) -> dict:
    return {"benchmarks": {"h100_kernels": rows}}


def u_cases(gen) -> list:
    """(kernel name, row name, kernel, plain, library, args, bytes, operations)
    of every U1 row, bf16: the conv at VGG-16's conv3, StarCoder2-3B's
    products at prefill and at the 4-slot tick, its RMSNorm and flash
    attention at prefill, and the SSD at Zamba2-2.7B's prefill shape."""
    dt, el = torch.bfloat16, 2
    n, c, h, w, k, r = U_CONV
    x, wt = conv_inputs(n, c, h, w, k, r, dt, gen)
    cases = [("conv2d", f"conv2d.vgg16.N{n}.C{c}.H{h}.W{w}.K{k}.R{r}", conv2d, conv2d_ref,
              lambda x, wt: F.conv2d(x, wt, padding=r // 2), (x, wt),
              el * (n * c * h * w + k * c * r * r + n * k * h * w), 2 * n * k * c * h * w * r * r)]
    cfg = get_config(LM_ARCH)
    for per, m in (("prefill", PREFILL_BATCH * PREFILL_SEQ), ("tick", SLOTS)):
        for kk, nn in lm_products(cfg):
            a, b = randn((m, kk), dt, gen), randn((kk, nn), dt, gen, kk ** -0.5)
            cases.append(("matmul", f"matmul.{LM_ARCH}.{per}.M{m}.K{kk}.N{nn}", matmul,
                          matmul_ref, torch.matmul, (a, b), el * (m * kk + kk * nn + m * nn),
                          2 * m * kk * nn))
    m, d = PREFILL_BATCH * PREFILL_SEQ, cfg.d_model
    cases.append(("rmsnorm", f"rmsnorm.{LM_ARCH}.prefill.rows{m}.D{d}", rmsnorm, rmsnorm_ref,
                  lambda x, sc: F.rms_norm(x, (d,), sc, 1e-6),
                  (randn((m, d), dt, gen), randn((d,), dt, gen)), el * (2 * m * d + d), 4 * m * d))
    b, s, hh, kv, hd = PREFILL_BATCH, PREFILL_SEQ, cfg.n_heads, cfg.n_kv, cfg.head_dim
    q = randn((b, s, hh, hd), dt, gen)
    kt, vt = randn((b, s, kv, hd), dt, gen), randn((b, s, kv, hd), dt, gen)
    cases.append(("flash_attention", f"flash_attention.{LM_ARCH}.prefill.B{b}.S{s}.H{hh}.KV{kv}"
                  f".hd{hd}.causal", lambda q, k, v: flash_attention(q, k, v, causal=True),
                  lambda q, k, v: attention_ref(q, k, v, causal=True),
                  lambda q, k, v: F.scaled_dot_product_attention(
                      q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True,
                      enable_gqa=True),
                  (q, kt, vt), el * (2 * q.numel() + kt.numel() + vt.numel()),
                  4 * b * hh * s * s * hd / 2))
    hcfg = get_config(HYBRID_ARCH)
    _, _, n_h = hybrid_dims(hcfg)
    sc = hcfg.ssm
    shape = (PREFILL_BATCH, PREFILL_SEQ, n_h, sc.head_dim, sc.state_dim)
    cases.append(("ssd", "ssd.{}.prefill.B{}.S{}.H{}.P{}.N{}.chunk{}".format(
                      HYBRID_ARCH, *shape, sc.chunk),
                  lambda *a: ssd(*a, chunk=sc.chunk), lambda *a: ssd_ref(*a, chunk=sc.chunk),
                  None, ssd_inputs(*shape, dt, gen), *ssd_work(*shape, sc.chunk, dt)))
    return cases


def u_kernel_rows(gen) -> tuple[list, dict]:
    """U1: each kernel against its plain version, then every row's calls back
    to back over cold copies of its operands, the counts set to 0 just before
    and read just after; returns the calibration rows and the launches."""
    check(H100.peak_flops == PEAK_FLOPS[torch.bfloat16] and H100.hbm_bw == HBM_BYTES_PER_S,
          f"U: hw_specs.H100 ({H100.peak_flops}, {H100.hbm_bw}) and this script's peaks "
          f"({PEAK_FLOPS[torch.bfloat16]}, {HBM_BYTES_PER_S}) differ")
    cases = u_cases(gen)
    timed = []
    for _, _, kernel, plain, library, args, nbytes, ops in cases:
        row = timed_row(lambda: kernel(*args), lambda: plain(*args),
                        None if library is None else (lambda: library(*args)),
                        nbytes, ops, torch.bfloat16)
        timed.append((row, cold_copies(args)))
    reset_counts()
    conv2d.launches, conv2d.launches_by_route = 0, dict.fromkeys(conv2d.launches_by_route, 0)
    for (_, _, kernel, *_), (row, copies) in zip(cases, timed):
        row["b2b_ms"] = b2b_ms(lambda i: kernel(*copies[i % len(copies)]))
    got = {"conv2d": conv2d.launches, **counts()}
    per = B2B_REPS + 3  # b2b_ms's warm-up calls and its timed ones
    want = {name: per * sum(c[0] == name for c in cases) for name in got}
    check(got == want, f"U: launches {got}, expected {want}")
    check(conv2d.launches_by_route["wgmma"] == want["conv2d"],
          f"U: conv routes {conv2d.launches_by_route}, expected all on wgmma")
    rows = []
    for (_, row_name, *_, nbytes, ops), (row, copies) in zip(cases, timed):
        meas = row["b2b_ms"] / 1e3
        rows.append(calib_row(row_name, nbytes, ops, meas))
        axis, pred = calib_term(nbytes, ops)
        lib = "none" if row["library_ms"] is None else f"{row['library_ms']:.4f} ms"
        print(f"U1 bfloat16 {row_name}: max_abs_err {row['max_abs_err']:.3e}  kernel "
              f"{row['ms']:.4f} ms  plain {row['plain_ms']:.4f} ms  library {lib}  back to "
              f"back {row['b2b_ms']:.4f} ms over {len(copies)} cold copies; "
              f"{axis} axis: predicted {pred:.4e} s, measured {meas:.4e} s, "
              f"{pred / meas:.2%} of the H100 spec's peak")
        check(meas >= pred / U_OVER_PEAK,
              f"U: {row_name} reads {pred / meas:.2%} of the spec's peak (at most "
              f"{U_OVER_PEAK:.0%}): its operands did not come from device memory")
    paths = {name: {"launches": n} for name, n in got.items()}
    paths["conv2d"]["launches_by_route"] = dict(conv2d.launches_by_route)
    return rows, paths


def u_run(*args, timeout: int = 300) -> subprocess.CompletedProcess:
    """``python -m <args>`` from the checkout's root; fails the run unless it exits 0."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-m", *map(str, args)], env=env, capture_output=True,
                       text=True, timeout=timeout, cwd=ROOT)
    check(r.returncode == 0, f"U: python -m {' '.join(map(str, args[:2]))} exited "
                             f"{r.returncode}: {r.stdout[-1500:]} {r.stderr[-2000:]}")
    return r


def u_fit(bench_path: Path, cal_path: Path):
    """U2: the calib CLI's fit of the card's rows, equal to the in-process
    fit and valid; prints the scales beside the published digest's."""
    from repro_torch.calib import (Calibration, bench_measurements, fit_corrections,
                                   published_measurements)
    u_run("repro_torch.calib", "fit", "--bench", bench_path, "--out", cal_path)
    cal = Calibration.load(cal_path)
    mine = fit_corrections(bench_measurements(json.loads(bench_path.read_text())))
    check(cal.fingerprint() == mine.fingerprint() and cal.as_dict() == mine.as_dict(),
          f"U: the CLI's calibration {cal.as_dict()} differs from the in-process fit "
          f"{mine.as_dict()}")
    u_run("repro_torch.calib", "validate", cal_path, "--bench", bench_path)
    c, pub = cal.correction(H100.name), fit_corrections(published_measurements()).correction(
        H100.name)
    print(f"U2 fit of {c.n_compute} compute and {c.n_bandwidth} bandwidth rows "
          f"(fingerprint {cal.fingerprint()}): h100 compute x{c.compute_scale:.4f} "
          f"(published digest x{pub.compute_scale:.2f}), bandwidth x{c.bw_scale:.4f} "
          f"(published x{pub.bw_scale:.2f}); error raw {c.raw_err_pct:.2f} %, calibrated "
          f"{c.cal_err_pct:.2f} %; validate exit 0")
    return cal


def u_campaign(cal, cal_path: Path, tmp: str) -> dict:
    """U3: the cuda campaign under the card's calibration in a subprocess:
    every record stamped with its fingerprint, a rerun that reuses every
    cell, and each record's step time equal to evaluate_point on the scaled
    spec; prints the calibrated and the datasheet best step time a cell."""
    from repro_torch.configs import SHAPES as ALL_SHAPES
    from repro_torch.core import gpu_planner
    from repro_torch.core.hw_specs import scaled_spec
    from repro_torch.dse import campaign
    from repro_torch.dse.backends import get_backend

    store = Path(tmp) / "cuda.jsonl"
    args = ["repro_torch.dse.campaign", "--backend", "cuda", "--archs", ",".join(U_ARCHS),
            "--shapes", ",".join(U_SHAPES), "--gpus", ",".join(map(str, U_GPUS)),
            "--gpu-types", H100.name, "--calibration", cal_path, "--store", store, "-q"]
    u_run(*args)
    recs = [json.loads(line) for line in store.read_text().splitlines()]
    fp, c = cal.fingerprint(), cal.correction(H100.name)
    check(recs and all(r["search"].get("calibration") == fp
                       and r["calibration"]["fingerprint"] == fp for r in recs),
          f"U: records without the calibration's fingerprint {fp}")
    again = u_run(*args)
    check(f"(0 new, {len(recs)} reused; 0 new evaluations" in again.stdout,
          f"U: the rerun did not reuse all {len(recs)} cells: {again.stdout[-800:]}")
    spec = scaled_spec(H100, c.compute_scale, c.bw_scale)
    for r in recs:
        cell, plan = r["cell"], r["plan"]
        p = gpu_planner.evaluate_point(get_config(cell["arch"]), ALL_SHAPES[cell["shape"]],
                                       cell["gpus"], plan["dp"], plan["tp"], cell["remat"],
                                       cell["microbatches"], spec)
        check(r["objectives"]["step_time_s"] == p.predicted_step_s,
              f"U: {r['cell_key']} step {r['objectives']['step_time_s']!r}, evaluate_point "
              f"on the scaled spec {p.predicted_step_s!r}")
    cells = get_backend("cuda").expand_cells(
        archs=U_ARCHS, shapes=U_SHAPES, gpus=U_GPUS, gpu_types=(H100.name,))
    sheet = {r["cell_key"]: r for r in campaign.run_campaign(
        cells, str(Path(tmp) / "datasheet.jsonl"), backend="cuda").records}
    check(sorted(sheet) == sorted(r["cell_key"] for r in recs),
          "U: the datasheet campaign's cells differ from the calibrated one's")
    print(f"U3 cuda campaign {','.join(U_ARCHS)} x {','.join(U_SHAPES)} x {U_GPUS} h100: "
          f"{len(recs)} cells, every record stamped {fp}, rerun {len(recs)} reused with 0 "
          f"evaluations, every step time equal to evaluate_point on the scaled spec")
    best = {}
    for r in recs:
        key = (r["cell"]["arch"], r["cell"]["shape"], r["cell"]["gpus"])
        if key not in best or r["objectives"]["step_time_s"] < best[key][0]["objectives"][
                "step_time_s"]:
            best[key] = (r, sheet[r["cell_key"]])
    for (arch, shape, gpus), (r, s) in sorted(best.items()):
        ro, so, p = r["objectives"], s["objectives"], r["plan"]
        print(f"U3 {arch}/{shape} on {gpus} h100, best cell {r['cell_key']}: calibrated "
              f"step {ro['step_time_s']:.6g} s (dp{p['dp']}xtp{p['tp']}, {p['bound']}); "
              f"datasheet {so['step_time_s']:.6g} s (dp{s['plan']['dp']}xtp"
              f"{s['plan']['tp']}, {s['plan']['bound']}); x{ro['step_time_s'] / so['step_time_s']:.4f}")
    return {"store": store, "cells": len(recs)}


def u_report(store: Path, cal_path: Path, bench_path: Path, rows: list, tmp: str) -> None:
    """U4: the report over U3's store renders with the calibration section
    and the card rows' provenance; placement's selftest passes."""
    out = Path(tmp) / "report.md"
    u_run("repro_torch.dse.report", store, "--calibration", cal_path, "--bench", bench_path,
          "--out", out)
    md = out.read_text()
    check("## Calibration (predicted vs measured)" in md,
          "U: the report has no calibration section")
    missing = [r["name"] for r in rows if f"benchmarks/run.py:{r['name']}" not in md]
    check(not missing, f"U: the report's calibration section lacks the provenance of {missing}")
    u_run("repro_torch.dse.placement", "--selftest")
    print(f"U4 report {len(md)} chars with the calibration section and the provenance of "
          f"all {len(rows)} card rows; placement --selftest exit 0")


def phase_u(prefill_ms: float | None = None) -> dict:
    """The calibration loop on the card: U1 the five kernels timed in bf16
    into calibration rows (build/calib/h100_kernels.json), U2 the calib
    CLI's fit of them (build/calib/h100.json), U3 the cuda campaign under
    that fit, U4 the report. ``prefill_ms`` (phase E's StarCoder2-3B prefill
    wall) adds the calibrated roofline of that prefill beside it."""
    gen = torch.Generator(device="cuda").manual_seed(U_SEED)
    rows, launches = u_kernel_rows(gen)
    torch.cuda.empty_cache()
    CALIB_DIR.mkdir(parents=True, exist_ok=True)
    bench_path, cal_path = CALIB_DIR / "h100_kernels.json", CALIB_DIR / "h100.json"
    bench_path.write_text(json.dumps(calib_bench(rows), indent=1))
    cal = u_fit(bench_path, cal_path)
    with tempfile.TemporaryDirectory(prefix="phase_u_") as tmp:
        done = u_campaign(cal, cal_path, tmp)
        u_report(done["store"], cal_path, bench_path, rows, tmp)
    if prefill_ms is not None:
        from repro_torch.core import gpu_model
        from repro_torch.core.hw_specs import scaled_spec
        from repro_torch.core.tpu_model import MeshDesc
        c = cal.correction(H100.name)
        shape = ShapeSpec("smoke_prefill", "prefill", PREFILL_SEQ, PREFILL_BATCH)
        cfg, mesh = get_config(LM_ARCH), MeshDesc(1, 1, 1)
        for label, spec in (("calibrated", scaled_spec(H100, c.compute_scale, c.bw_scale)),
                            ("datasheet", H100)):
            rl = gpu_model.analytic_roofline(cfg, shape, mesh, spec)
            print(f"U {label} gpu_model.analytic_roofline {LM_ARCH} prefill "
                  f"B={PREFILL_BATCH} S={PREFILL_SEQ} on one h100: step "
                  f"{rl.step_time * 1e3:.4f} ms ({rl.bound}; compute {rl.t_compute * 1e3:.4f}, "
                  f"memory {rl.t_memory * 1e3:.4f}, collective {rl.t_collective * 1e3:.4f} ms) "
                  f"against phase E's measured "
                  f"{prefill_ms:.4f} ms (x{prefill_ms / (rl.step_time * 1e3):.3f})")
    return {U_PATH: launches}


def matmul_floors(rows, hybrid_rows) -> None:
    """The redesigned matmul against torch.matmul in this run, bf16: the
    prefill sum of single calls at most 4x torch.matmul's, the decode tick's
    back-to-back sum at most 2x."""
    for arch, by in ((LM_ARCH, rows["matmul"]), (HYBRID_ARCH, hybrid_rows["matmul"])):
        pre = lm_summary(by[torch.bfloat16], "prefill")
        tick = lm_summary(by[torch.bfloat16], "decode tick")
        r_pre, r_tick = pre["ms"] / pre["library_ms"], tick["b2b_ms"] / tick["b2b_library_ms"]
        print(f"matmul {arch} bf16: prefill {pre['ms']:.3f} ms against torch.matmul "
              f"{pre['library_ms']:.3f} ms ({r_pre:.2f}x; bound {pre['bound_ms']:.3f} ms, "
              f"{pre['bound_ms'] / pre['ms']:.1%} of it); decode tick back to back "
              f"{tick['b2b_ms']:.3f} ms against {tick['b2b_library_ms']:.3f} ms ({r_tick:.2f}x; "
              f"bound {tick['bound_ms']:.3f} ms, {tick['bound_ms'] / tick['b2b_ms']:.1%} of it)")
        check(r_pre <= 4 and r_tick <= 2,
              f"{arch}: matmul at {r_pre:.2f}x torch.matmul at prefill (floor 4x), "
              f"{r_tick:.2f}x back to back at decode (floor 2x)")


def flash_floor(rows, hybrid_rows) -> None:
    """The redesigned flash attention against SDPA in this run, bf16: the sum
    over one prefill of back-to-back calls at most FLASH_FLOORS[arch] x
    SDPA's."""
    for arch, by in ((LM_ARCH, rows), (HYBRID_ARCH, hybrid_rows)):
        fl = lm_summary(by["flash_attention"][torch.bfloat16], "prefill")
        ratio = fl["b2b_ms"] / fl["b2b_library_ms"]
        print(f"flash_attention {arch} bf16 prefill: {fl['ms']:.3f} ms of single calls against "
              f"SDPA {fl['library_ms']:.3f} ms; back to back {fl['b2b_ms']:.3f} ms against "
              f"{fl['b2b_library_ms']:.3f} ms ({ratio:.2f}x; bound {fl['bound_ms']:.3f} ms "
              f"({fl['bound_by']}), {fl['bound_ms'] / fl['b2b_ms']:.1%} of it)")
        check(ratio <= FLASH_FLOORS[arch],
              f"{arch}: bf16 flash attention at {ratio:.2f}x SDPA back to back "
              f"(floor {FLASH_FLOORS[arch]}x)")


def rmsnorm_ssd_floors(rows, hybrid_rows) -> None:
    """The redesigned RMSNorm against F.rms_norm in this run, bf16: the sum
    over one prefill of back-to-back calls at most RMS_FLOOR x F.rms_norm's
    on each LM (the decode tick's and the single-call sums printed); the bf16
    SSD of Zamba2's prefill back to back at most SSD_BOUND_FLOOR x its
    bytes bound."""
    ratios = {}
    for arch, by in ((LM_ARCH, rows), (HYBRID_ARCH, hybrid_rows)):
        for per in ("prefill", "decode tick"):
            rm = lm_summary(by["rmsnorm"][torch.bfloat16], per)
            ratio = rm["b2b_ms"] / rm["b2b_library_ms"]
            print(f"rmsnorm {arch} bf16 {per}: {rm['ms']:.3f} ms of single calls against "
                  f"F.rms_norm {rm['library_ms']:.3f} ms; back to back {rm['b2b_ms']:.3f} ms "
                  f"against {rm['b2b_library_ms']:.3f} ms ({ratio:.2f}x); bound "
                  f"{rm['bound_ms']:.3f} ms, {rm['bound_ms'] / rm['b2b_ms']:.1%} of it back to "
                  f"back")
            if per == "prefill":
                ratios[arch] = ratio
    row = hybrid_rows["ssd"][torch.bfloat16][0]
    ssd_ratio = row["b2b_ms"] / row["bound_ms"]
    print(f"ssd {HYBRID_ARCH} bf16 prefill shape: {row['b2b_ms']:.4f} ms a call back to back, "
          f"{row['ms']:.4f} single; bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
          f"{ssd_ratio:.2f}x it; x{row['count']} per prefill: {row['b2b_ms'] * row['count']:.3f} "
          f"ms back to back")
    check(all(r <= RMS_FLOOR for r in ratios.values()),
          f"bf16 RMSNorm back to back at {ratios} x F.rms_norm's (floor {RMS_FLOOR}x)")
    check(ssd_ratio <= SSD_BOUND_FLOOR,
          f"bf16 SSD back to back at {ssd_ratio:.2f}x its bound (floor {SSD_BOUND_FLOOR}x)")


def lm_entries(rows, launches, serving, hybrid_rows, hybrid_launches, hybrid_serving) -> list:
    """One entry per LM kernel: StarCoder2-3B's prefill (phases D-F) at the top
    level with Zamba2-2.7B's (phases G-I) beside it; the SSD runs on Zamba2 only."""

    def numbers(by, prefill, serve, name):
        out = {"launches": prefill[name], **lm_summary(by[torch.bfloat16], "prefill"),
               "float32": lm_summary(by[torch.float32], "prefill")}
        if serve["per_tick"][name]:
            out["decode_tick"] = {"launches": serve["per_tick"][name],
                                  **lm_summary(by[torch.bfloat16], "decode tick")}
        out["serving_launches"] = serve[name]
        if name == "matmul":
            out["launches_by_route"] = prefill["matmul_routes"]
            out["serving_launches_by_route"] = serve["matmul_routes"]
        if name in ("flash_attention", "ssd"):
            out["launches_by_route"] = prefill[f"{name}_routes"]
        return out

    entries = []
    for name, (source, replaces) in LM_KERNELS.items():
        entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                 "dtype": "bfloat16", "per": "prefill forward"}
        hybrid = numbers(hybrid_rows[name], hybrid_launches, hybrid_serving, name)
        if name in rows:
            entry.update(arch=LM_ARCH, **numbers(rows[name], launches, serving, name))
            entry[HYBRID_ARCH] = hybrid
        else:
            entry.update(arch=HYBRID_ARCH, **hybrid)
        entries.append(entry)
    return entries


def main() -> int:
    if sys.argv[1:] not in ([], ["--q-only"], ["--r-only"], ["--s-only"], ["--t-only"],
                            ["--u-only"]):
        print("usage: chip_smoke.py [--q-only | --r-only | --s-only | --t-only | --u-only]",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"setup: built {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    for name in sorted(libs):
        for line in _build.build_log(name).splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                print(f"setup: {name}: {line.strip()}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    if sys.argv[1:] == ["--q-only"]:
        keep = {}
        phase_c(gen, keep)
        torch.cuda.empty_cache()
        phase_m(keep)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        phase_q(keep)
        print(f"Q wall {time.perf_counter() - t0:.1f} s")
        return 0
    if sys.argv[1:] == ["--r-only"]:
        t0 = time.perf_counter()
        phase_r()
        print(f"R wall {time.perf_counter() - t0:.1f} s")
        return 0
    if sys.argv[1:] == ["--s-only"]:
        phase_s()
        return 0
    if sys.argv[1:] == ["--t-only"]:
        phase_t()
        return 0
    if sys.argv[1:] == ["--u-only"]:
        phase_u()
        return 0
    rows = phase_a(gen)
    launches = phase_b(gen)
    keep = {}  # phases C and M leave on the host what phase Q is held to
    phase_c(gen, keep)
    torch.cuda.empty_cache()
    lm_rows = phase_d(gen)
    torch.cuda.empty_cache()
    params, cfg, prefill_launches, prefill_ms = phase_e(gen)
    serving = phase_f(params, cfg)
    del params
    torch.cuda.empty_cache()
    hybrid_rows = phase_g(gen)
    torch.cuda.empty_cache()
    params, cfg, hybrid_launches = phase_h(gen)
    torch.cuda.empty_cache()
    hybrid_serving = phase_i(params, cfg)
    del params
    torch.cuda.empty_cache()
    for name, phase in (("J", phase_j), ("K", lambda: phase_k(gen)), ("L", phase_l)):
        t0 = time.perf_counter()
        phase()
        torch.cuda.empty_cache()
        print(f"{name} wall {time.perf_counter() - t0:.1f} s")
    zoo = {}
    for name, phase in (("M", lambda: phase_m(keep)), ("N", phase_n), ("O", phase_o),
                        ("P", phase_p), ("Q", lambda: phase_q(keep)), ("R", phase_r),
                        ("S", phase_s), ("T", phase_t), ("U", lambda: phase_u(prefill_ms))):
        t0 = time.perf_counter()
        zoo.update(phase())
        torch.cuda.empty_cache()
        print(f"{name} wall {time.perf_counter() - t0:.1f} s")

    conv_floor(rows)
    matmul_floors(lm_rows, hybrid_rows)
    flash_floor(lm_rows, hybrid_rows)
    rmsnorm_ssd_floors(lm_rows, hybrid_rows)
    entry = {"name": "conv2d", "route": "cuda", "source": SOURCE, "replaces": REPLACES,
             "dtype": "float32", **launches[torch.float32],
             **vgg_forward_summary(rows[torch.float32]),
             "bfloat16": {**launches[torch.bfloat16],
                          **vgg_forward_summary(rows[torch.bfloat16])}}
    entries = lm_entries(lm_rows, prefill_launches, serving, hybrid_rows, hybrid_launches,
                         hybrid_serving)
    for e in [entry, *entries]:  # the launches of phases M-R and U, path by path
        paths = {path: by[e["name"]] for path, by in zoo.items()
                 if by.get(e["name"], {}).get("launches")}
        if paths:
            e["paths"] = paths
    print(json.dumps({"kernels": [entry, *entries]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
