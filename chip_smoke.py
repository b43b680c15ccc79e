#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one NVIDIA H100, end to end.

Run from the root of the repository on a machine with the card and nvcc:

    python3 chip_smoke.py [--out details.json]

Phases, each printing its own lines; any failure exits non-zero:
  1. device: the card's name and power limit as nvidia-smi gives them, and the
     build of the CUDA kernels from csrc/ (one nvcc per source, in parallel);
  2. each hand-written kernel against its plain PyTorch version on the card,
     at the main path's shapes and on ragged ones, max errors beside the
     tolerance (the systolic GEMM on each of its wgmma tiles, with ragged
     M, N and K that TMA zero-fills; flash attention at head dims 16, 64,
     120 and 128, K/V at 1/1, 1/2 and 1/8 of the query heads, in the
     model's strided layout, with windows, a masked tail and without the
     causal mask; the block-scaled int8 / fp8 GEMM on K-major weights, as
     w8a8 serves them, also over scale blocks of 256, 128, 64, 32, 16 and
     whole-K; the grouped
     GEMM at capacities 8, 100, 160 and 200 with each expert's token rows
     empty, partial, full or as a decode step routes them; the systolic GEMM
     at the recurrent families' projections -- N = 8 and fp32 out (mLSTM's
     gates), N = 14576 (Mamba2's in_proj), K = 7168 (its out_proj) -- at M
     = 1, 4, 8, 1000 and 2048 and in fp32 at M = 512; flash attention at
     zamba2's 32 / 32 heads of 112; the frontend models' projections, the
     vit projector and internvl2-1b's continuous prompt lengths; the
     systolic GEMM reading B K-major -- the tied head's 151655 x 896 table,
     fp32 out, at M = 1, 4, 8 and 1024 -- and on ragged K-major shapes;
     flash attention at musicgen-medium's 24 / 24 heads and internvl2-1b's
     14 / 2, a group of 7);
  3. full-width internlm2-1.8b in bf16 (random weights from a seed) served
     through ServeEngine: batch 4, prompt 512, 32 greedy tokens, with the
     kernels' launch counts checked exactly, in all and per GEMM shape, every
     prefill launch of each GEMM on a wgmma path and every decode one on its
     decode tile, and every flash launch given K/V at the model's own KV
     heads; the
     kernel path's prefill logits and two decode steps from the same cache
     against the same model run through the plain versions on the card; and
     the SMOKE config in fp32 on the card against the port's CPU path;
     then the tuner on the same parameters (an empty plan cache is pinned
     before any launch, so a cache left on the machine moves no path): K1
     autotuned at the model's four projections at M = 2048 and M = 4 and at
     minicpm3-4b's (2560, 2560), K5 int8 at (2048, 8192, 2048), K4 at
     (C 160, 2048, 768), every candidate against its plain version and no
     faster than its bound, the rule's tile, each candidate's time and the
     winner printed, a second pass a pure cache hit, the model served on the
     tuned tiles (every K1 launch at a tuned shape on its cached path and
     chunk, logits within 5e-2 of the plain path, two prefills
     bit-identical, the decode-plan report), the Table I analogue at 4096^3
     and BlockPlan.smem_bytes() against each wgmma tile's shared memory in
     the binaries, the Python twin of the decode split rule against the
     binary's at the tuned decode shapes; then the obs phase on the same parameters, the plan cache pinned empty
     again: the continuous trace's first 8 requests over 8 slots served with telemetry off and then on with every
     K1 call in a sampled window (tokens bit-identical, launches equal and exact, every K1 launch recorded, the
     engine's decode_totals exactly one decode step's GEMM work from the first tick to the last, one decode MFU
     and model residual reading a decode tick, one window a K1 call), the drift probe re-measuring the six
     decode GEMMs with CUDA events (its launches counted apart), a plan injected 3x off its reading and
     flagged stale, `python -m repro_torch.obs doctor` on the run's metrics (exit 0, coverage >= 0.9; exit 1
     with the injected plan), the decode MFU, residual, probe readings, the doctor's top sinks and the
     decode ms/step with telemetry off and on printed; then the same parameters served continuously: 16 requests of a
     Poisson trace (prompts up to 512 tokens, generations up to 64) through
     ContinuousScheduler over 8 slots, with the lifecycle checked (every
     request finished with all its tokens, the pool drained, slots reused,
     slots at different positions in one tick), launch counts exact per
     kernel, per GEMM shape and path and per flash shape and head count
     (warmup included), every request's prefill and decode-step logits
     against the same request served alone at batch 1 with the scheduler's
     tokens fed back, and the continuous serving numbers; the same trace
     through the kv8 pool (int8 K/V, fp32 scales per slot and head): its
     resident bytes exact, the same launches, each request's logits within
     0.15 of the largest logit of the request served alone on the fp cache,
     the dequantized K of a live slot within 0.05 x max|K| of the fp pool's
     after a decode step, its step time and kernels per step beside the fp
     pool's; the long-prompt trace (four requests of 128 tokens decoding, one
     of 8192 arriving mid-answer, 5 slots) prefilled monolithically and in
     chunks of 512, one turn each (A B): lifecycle, prefill chunks, exact
     launches per kernel, shape and path, each request's last-prompt-position
     logits chunked vs monolithic, and the tick / step / TTFT readings;
     the shared-prefix trace (16 requests in two groups sharing a
     4096-token system prompt, 64-token suffixes, 32 tokens each, 8 slots)
     over the slot pool, the paged pool (pages of 16), the paged pool with
     the prefix cache and the same over an arena of 556 pages: the exact
     ticks, decode steps, prefix hits and hit tokens, preemptions, tokens,
     peak pages and bytes of the reference scheduler's run, exact launches,
     the null page intact, the paged pool's tokens and logits bit-identical
     to the slot pool's and the prefix arms' within 5e-2 of the largest
     logit, with tok/s, TTFT, step times, peak bytes and kernels per decode
     step beside each other;
     then the same model served w8a8 (int8 weights quantized from the same
     fp32 masters, per-token int8 activations), every projection on the
     block-scaled kernel, with the same launch, kernel-vs-plain and decode
     checks (each kernel call of the prefill also against its plain version
     on the model's own inputs), and its logits against the bf16 model's
     within the reference's bound of 0.15 x the largest logit; then
     full-width qwen3-moe-30b-a3b in bf16, every expert GEMM on the grouped
     kernel, with the same launch and decode checks, kernel-vs-plain logits
     with the plain path routed to the kernel path's experts (bf16's
     tolerance) and routing freely (twice it), a routing witness (each
     grouped call of the prefill against its plain version on the model's
     own dispatched tokens; the (token, choice) assignments and capacity
     drops that differ between the paths, by layer; one-ulp nudges of the
     plain path alone), the same checks and witness on models and prompts
     from two more seeds, and the SMOKE MoE config in fp32 on the card
     against the port's CPU path; then the MoE model in w8a8 (built as the
     launcher builds it, one layer of fp32 masters at a time: attention and
     the head int8, the router and the experts bf16) with the same MoE gates
     and exact launches of all four of its kernels, its logits beside the
     bf16 model's for information; minicpm3-4b at full width and 31 of its
     62 layers (MLA: its
     attention plain, as the reference computes it, every projection on the
     GEMM kernels, wkv_b at prefill and per chunk only) in bf16 and w8a8 with
     the dense model's gates, served continuously on the same trace,
     monolithically, in chunks of 128 and over the paged latent pool (its
     tokens and logits bit-identical to the monolithic run's), with its
     latent pool's resident bytes exact, and its SMOKE config in fp32
     against the CPU path; full-width xlstm-125m (SSM: mLSTM + sLSTM) and
     zamba2-7b (hybrid: Mamba2 + one shared attention block, 5.89 B
     parameters) in bf16 with their fp32 leaves kept fp32, each served
     through ServeEngine (batch 4, prompt 512 -- a prefill of 512 decode
     steps, as the reference scans them -- and 32 tokens) with exact K1
     launches per shape (60 and 217 a step, all at M = 4 on the decode tile)
     and no flash launch, kernel vs plain on a 4 x 64-token prompt, two
     prefills bit-identical, fp32 forward (chunked mLSTM / SSD, K1 at M =
     512, flash at D = 112) against fp32 prefill on one 512-token row, and
     the SMOKE config in fp32 against the CPU path; xlstm-125m also served
     continuously on the same trace, monolithic and in chunks of 128 (the
     staged path), its state pool's resident bytes exact; full-width
     musicgen-medium (audio: four codebook streams, 1.84 B parameters) and
     internvl2-1b (vlm: 256 projected patches, then 256 text tokens) served
     as internlm2-1.8b is (exact K1 launches per shape -- the projector's
     two per prefill -- and K3 per head count, kernel vs plain, device
     kernels per decode step), internvl2-1b also continuously on the
     continuous trace with the continuous gates, and with a tied head (one
     prefill and two decode steps: the table's K1 launches on the K-major
     decode tile exact, 1 + 2, kernel vs plain), and the SMOKE configs of
     both and a tied one in fp32 against the CPU path; every path's prefill
     twice, bit-identical; then training: full-width internlm2-1.8b with fp32
     masters from the seed, computing in bf16, batch 4 x 512 tokens: one
     step's loss, gradient norm and every gradient leaf on the kernel path
     against the plain path on the card (K1's forward, dA and dB launches;
     K3 with its logsumexp output, the attention backward plain), exact
     launches of a step (K1 504 per shape and path, K3 24) and of a remat
     step (672, 48), six AdamW steps through the Trainer on one batch (the
     loss falls, every parameter finite and changed, the step counter, no
     retry), a traced step (device kernels, busy ms, idle share, K1's
     forward and backward ms), step ms, tokens/s, peak memory, the SMOKE
     checkpoint round trip on the card and the SMOKE model's fp32
     gradients against the CPU path; then the static checks
     (repro_torch.check) on the card: the auditor over every distinct plan
     the run launched (K1, K5 and K4 plans, K3 shapes; coverage 1.0, zero
     findings: each binary's own report of its grid, threads, shared
     memory, split-K workspace and spills held to the Python accounting),
     its dispatch paths and the paper sweep, each path's registers, spill
     bytes and shared memory as the binaries report them, and the CLI in
     a process of its own (exit 1 on a corrupt plan spec, 0 on the clean
     tree); each phase's wall;
  4. each kernel timed at the served paths' shapes (CUDA events) beside its
     bound, its plain version and one PyTorch library call (a yardstick the
     port never calls; none computes the block-scaled product, so the
     quantized kernel's is null; it is also timed beside K1 and with whole-K
     scales); the systolic GEMM's prefill shapes also on each wgmma tile; the
     grouped GEMM at all rows and with the rows the MoE model's routing gave
     in phase 3, each with its own bound; flash attention in each model's
     layout, K/V at its KV heads (batch 1 up to S 8192 for the continuous
     and long-prompt runs; zamba2's D = 112, which no served path launches);
     the chunked path's plain chunk attention (no
     kernel) beside SDPA, also a prefix hit's; the paged pool's gather and
     scatter at the paged arms' arena beside their bound; K1 at the training
     step's dA shapes (W^T read K-major and copied row-major) and dB shapes
     (X^T copied), the copies apart, and K3 with and without its lse output
     beside SDPA, the plain attention backward beside SDPA's; one JSON line lists
     the kernels, each shape's time
     weighted by the launches the served paths made at that shape;
  5. the last line: {"ok": true, "device": {...}}.
Without a card, or without the rest of the repository beside it, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from unittest import mock

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile, record_function  # noqa: E402

from repro_torch import configs, obs, quant  # noqa: E402
from repro_torch.check import audit as check_audit  # noqa: E402
from repro_torch.checkpoint import latest_step  # noqa: E402
from repro_torch.core import tree as tree_util  # noqa: E402
from repro_torch.configs import paper  # noqa: E402
from repro_torch.core import dse  # noqa: E402
from repro_torch.core.blocking import BlockPlan, derive_block_plan  # noqa: E402
from repro_torch.core.hw import H100, dtype_bytes  # noqa: E402
from repro_torch.data.synthetic import (  # noqa: E402
    make_adversarial_trace,
    make_batch,
    make_request_trace,
    make_shared_prefix_trace,
)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.attention import kernel as attn_kernel  # noqa: E402
from repro_torch.kernels.attention import ops as attn_ops  # noqa: E402
from repro_torch.kernels.attention.ref import flash_attention_call_ref  # noqa: E402
from repro_torch.kernels.grouped import kernel as grouped_kernel  # noqa: E402
from repro_torch.kernels.grouped import ops as grouped_ops  # noqa: E402
from repro_torch.kernels.grouped.ref import grouped_matmul_ref  # noqa: E402
from repro_torch.kernels.systolic import kernel as mm_kernel  # noqa: E402
from repro_torch.kernels.systolic import ops as mm_ops  # noqa: E402
from repro_torch.kernels.systolic.ref import (  # noqa: E402
    ACTIVATIONS,
    matmul_ref,
    quant_matmul_ref,
    quant_systolic_matmul_ref,
)
from repro_torch.launch import trace as trace_tools  # noqa: E402
from repro_torch.launch.serve import init_params  # noqa: E402
from repro_torch.models import attention as attn_model  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.models.layers import FP32_KEYS  # noqa: E402
from repro_torch.models.transformer import cast_params, hybrid_counts, xlstm_counts  # noqa: E402
from repro_torch.obs import doctor as obs_doctor  # noqa: E402
from repro_torch.obs import drift as obs_drift  # noqa: E402
from repro_torch.obs import metrics as obs_metrics  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402
from repro_torch.serving import ContinuousScheduler, KVPool, ServeConfig, ServeEngine, requests_from_trace  # noqa: E402
from repro_torch.serving.engine import chunk_schedule, decode_gemm_problems  # noqa: E402
from repro_torch.serving.kvpool import _nbytes  # noqa: E402
from repro_torch.serving.paged import PagedKVPool, _gather_pages, _scatter_pages  # noqa: E402
from repro_torch.serving.scheduler import FINISHED  # noqa: E402
from repro_torch.optim import global_norm  # noqa: E402
from repro_torch.train.loop import TrainConfig, Trainer, make_grad_fn  # noqa: E402
from repro_torch.tune import autotune, candidates, measure_matmul  # noqa: E402
from repro_torch.tune import cache as tune_cache  # noqa: E402
from repro_torch.tune.measure import cycler, time_ms  # noqa: E402

ARCH = "internlm2-1.8b"
MOE_ARCH = "qwen3-moe-30b-a3b"
MLA_ARCH = "minicpm3-4b"
BATCH, PROMPT, GEN = 4, 512, 32
SEED = 0
# The continuous path: a Poisson request trace (0.5 arrivals per tick,
# prompts geometric around 128 tokens in [4, 512], generations around 24 in
# [1, 64]) over 8 slots.
CONT_SLOTS = 8
CONT_TRACE = dict(n_requests=16, mean_prompt=128, mean_gen=24, rate=0.5, seed=SEED, max_prompt=512, max_gen=64)
# The long-prompt path: make_adversarial_trace -- four requests of 128 tokens
# decoding 48 each from tick 0, and one of 8192 tokens arriving at tick 2
# for 4 tokens (a user pasting a document into a chat while others are
# mid-answer) -- over 5 slots, prefilled monolithically and then in chunks
# of 512 (one per tick), one turn each (a second A B turn was cut to keep the
# script's wall under 900 s).
LONG_TRACE = dict(n_short=4, short_prompt=128, short_gen=48, long_prompt=8192, long_gen=4, long_arrival=2.0,
                  seed=SEED)
LONG_SLOTS = 5
LONG_CHUNK = 512
# The paged phase: make_shared_prefix_trace -- 16 requests in two groups, each
# request one of two 4096-token system prompts and a 64-token user suffix,
# 32 tokens each, Poisson 0.5 per tick (a chat or agent service whose
# requests share a long system prompt) -- over 8 slots, max_len 4192, pages
# of 16 rows (262 a slot).  Four arms one after another: the slot pool (the
# oracle), the paged pool, the paged pool with the prefix cache, and the
# same with an arena of 556 pages, where the scheduler reclaims prefix pages
# and preempts.  The exact counts are the reference scheduler's on this
# trace (scheduling depends only on lengths and arrivals: the trace has no
# EOS); tests/test_torch_paged_trace.py holds the port's and the
# reference's schedulers to them on the CPU.
PAGED_TRACE = dict(n_requests=16, prefix_len=4096, suffix_len=64, gen=32, n_groups=2, rate=0.5, seed=SEED)
PAGED_SLOTS, PAGE_SIZE, PREEMPT_PAGES = 8, 16, 556
PAGED_PROMPT = PAGED_TRACE["prefix_len"] + PAGED_TRACE["suffix_len"]
PAGED_MAX_LEN = PAGED_PROMPT + PAGED_TRACE["gen"]
_NO_REUSE = dict(ticks=81, decode_steps=80, prefix_hits=0, prefix_hit_tokens=0, preempted=0, tokens_out=512,
                 mean_occupancy=0.775)
PAGED_ARMS = {  # arm -> (ContinuousScheduler options, exact gates)
    "stripe": ({}, _NO_REUSE),
    "paged": (dict(paged=True, page_size=PAGE_SIZE), dict(_NO_REUSE, peak_pages=2093)),
    "prefix": (dict(paged=True, page_size=PAGE_SIZE, prefix_cache=True),
               dict(_NO_REUSE, prefix_hits=14, prefix_hit_tokens=57_344, peak_pages=588)),
    "preempt": (dict(paged=True, page_size=PAGE_SIZE, prefix_cache=True, n_pages=PREEMPT_PAGES),
                dict(ticks=81, decode_steps=80, prefix_hits=18, prefix_hit_tokens=73_920, preempted=4, tokens_out=523,
                     mean_occupancy=0.7859, peak_pages=PREEMPT_PAGES)),
}
# Bytes of one token of full-width internlm2-1.8b in the KV cache: 24 layers
# x (bf16 K and V at 8 heads x 128, and an int32 position) = 98,400; a page
# holds 16 of them (1,574,400 bytes), the slot pool 8 x 4192 (3,299,942,400).
TOKEN_BYTES = 24 * (2 * 8 * 128 * 2 + 4)
PAGE_BYTES = PAGE_SIZE * TOKEN_BYTES
STRIPE_BYTES = PAGED_SLOTS * PAGED_MAX_LEN * TOKEN_BYTES
# kv8: the continuous trace through the int8 pool.  Its resident bytes for 8
# slots x 411 positions: int8 K/V (8 x 411 x 24 x 2 x 8 x 128), fp32 scales
# per slot, layer, K/V and head (8 x 24 x 2 x 8 x 4), int32 positions
# (8 x 411 x 24 x 4).
KV8_BYTES = 161_611_776 + 12_288 + 315_648
# minicpm3-4b (MLA) through the same continuous trace, monolithic and then in
# chunks of MLA_CHUNK (one a tick).  Its fp pool holds the latents: 8 slots x
# 411 positions x 62 layers x (bf16 c_kv 256 + k_rope 32, 2 x 288 bytes, and
# an int32 position, 4 bytes).
MLA_CHUNK = 128
# minicpm3-4b runs at full width but 31 of its 62 layers (cut to keep the
# script's wall under 900 s once the training phase came in; its paths were
# the longest, 211-251 s at 62 layers).
MLA_LAYERS = 31
MLA_CONT_BYTES = 8 * 411 * MLA_LAYERS * (2 * (256 + 32) + 4)
# ... and over the paged latent pool, pages of 16 rows: 26 a slot hold 416
# rows, of which the gather keeps 411; one page is 575,360 bytes.
MLA_PAGE_BYTES = PAGE_SIZE * MLA_LAYERS * (2 * (256 + 32) + 4)
# The recurrent families: xlstm-125m (SSM: groups of one mLSTM and one sLSTM)
# and zamba2-7b (hybrid: Mamba2 layers and one shared attention + SwiGLU
# block applied every 6 of them).  Both prefill, as the reference does, by a
# loop of decode steps over the prompt, so every served GEMM is a decode
# step's.  Their kernel-vs-plain check runs a 4 x 64-token prompt (the plain
# path repeats every step); ``forward`` (the parallel path: chunked mLSTM /
# SSD, K1 at M = 512, zamba2's flash attention at D = 112) is held against
# ``prefill`` on one 512-token row in fp32; xlstm-125m is also served
# continuously on the continuous trace, monolithic and in chunks of 128.
SSM_ARCH, HYBRID_ARCH = "xlstm-125m", "zamba2-7b"
RECURRENT = ("ssm", "hybrid")
# The modality frontends: musicgen-medium (audio: four codebook streams
# embedded and summed, one output head per stream -- an einsum outside any
# kernel, as in the reference) and internvl2-1b (vlm: 256 patches projected
# by two K1 launches per prefill, then the text; its 512-position prompts
# hold 256 patches and 256 text tokens), each served like internlm2-1.8b,
# internvl2-1b also continuously on the continuous trace (its prompts the
# patches and then text drawn as the trace draws prompts); and internvl2-1b
# with a tied head (the Qwen2-0.5B backbone ties it): K1 reads the 151655 x
# 896 table K-major, one launch per prefill and per decode step, checked on
# one prefill and TIED_STEPS decode steps.
AUDIO_ARCH, VLM_ARCH = "musicgen-medium", "internvl2-1b"
TIED_STEPS = 2
RECURRENT_CHECK_PROMPT = 64
SSM_CHUNK = 128
SSM_CHUNKED_REQUESTS = 10  # the first 10 of the trace's 16 requests (cut for time; > CONT_SLOTS, so slots are reused)
BF16 = torch.bfloat16
# Tolerances (|got - want| <= atol + rtol * |want|), with their reasons:
GEMM_TOL_BF16 = (2e-2, 2e-2)  # one bf16 ulp where kernel and plain round the fp32 sum
GEMM_RTOL_FP32 = 1e-5  # fp32 atol is 1e-5 * sqrt(K): summation order, growing with sqrt(K)
ATTN_TOL = {BF16: 3e-2, torch.float32: 2e-4}  # P rounded to bf16 / online vs direct softmax
LOGITS_TOL_BF16 = 5e-2  # of the largest logit: bf16 activations rounded at other points
LOGITS_TOL_FP32 = 1e-4  # fp32 SMOKE model, card vs CPU: summation order only
# fp32 forward (parallel: chunked mLSTM / SSD, flash attention) vs fp32
# prefill (the recurrence, one token at a time) at full width, of the
# largest logit: two algorithms whose fp32 sums run in other orders over 512
# positions and up to 81 layers.
FORWARD_TOL_FP32 = 1e-2
# Block-scaled GEMM vs its dequantize-then-fp32 plain version: atol 1e-5 x
# (max|sum| + 1), the reference's own (same quantized values, other fp32
# order; the activations are <= 1.1-Lipschitz), plus one bf16 ulp (2^-7
# relative) where the output is bf16 and the two round different fp32 sums.
QGEMM_ATOL = 1e-5
QGEMM_RTOL_BF16 = 2**-7
# w8a8 kernel path vs plain path at full width: bf16 activations rounded at
# other points (as LOGITS_TOL_BF16), and each layer's per-token int8 rounding
# turns a one-ulp bf16 difference into a one-step int8 difference where a
# value sits near a rounding boundary (a bf16 ulp is about a sixth of an int8
# step at typical magnitudes).  Phase 3 prints the witnesses: every kernel
# call inside the model against its plain version, the int8 activations that
# differ between the paths, and how far a one-ulp nudge of the input moves
# the plain path alone.
LOGITS_TOL_W8A8 = 5e-2
W8A8_VS_BF16_TOL = 0.15  # of the bf16 model's largest logit: tests/test_quant.py's w8a8 bound
# MoE kernel path vs plain path at full width: bf16's reason, and routing is
# discrete, so a rounding difference near a top-k tie sends a token to
# another expert (and moves which slots overflow capacity), a jump far
# larger than an ulp.  The kernel gate is the comparison with the plain path
# routed exactly as the kernel path (same experts per token, its own
# weights), held at bf16's 5e-2.  Each path routing freely moves as far as
# the model moves under a one-ulp nudge of its input, so that comparison is
# held at 1e-1: above the largest nudge reading (8.65 % of the largest
# logit, over three model seeds x three nudges x prefill and three decode
# steps, first measured on an H100).  Phase 3 prints the witnesses: every
# grouped call of the prefill against its plain version on the model's own
# dispatched tokens, the assignments and drops that differ between the paths
# by layer, the routed-alike gap, and the nudge readings, for the model of
# the main path and for models and prompts from two more seeds.
LOGITS_TOL_MOE = 1e-1
# kv8 vs the same request served alone on the fp cache: the reference's own
# quantized-vs-fp bound (tests/test_quant.py), of the largest logit; and its
# payload gate, the dequantized K of a live slot within 0.05 x max|K| of the
# fp pool's after a decode step (tests/test_quant.py test_kv8_decode_close_to_fp).
KV8_VS_FP_TOL = 0.15
KV8_K_TOL = 0.05
# Training: full-width internlm2-1.8b, fp32 masters computing in bf16,
# kernel path vs plain path on the card, one step from the same masters and
# batch.  bf16 rounds the activations at other points on the two paths (the
# served logits differ by up to ~1.8 % of the largest logit); a loss is a
# mean over 2048 tokens, so it moves far less: 1e-2 relative.  Each gradient
# leaf sums bf16 products over 2048 tokens through 24 layers of such
# roundings: its relative L2 gap measured 2.6-3.6 % (first measured on an
# H100), held at 1e-1; the global norm at 5e-2.  The SMOKE model in fp32,
# card vs CPU: summation order only, 1e-4 of each leaf's largest value.
TRAIN_STEPS = 6
TRAIN_TCFG = dict(peak_lr=3e-4, warmup_steps=1, total_steps=TRAIN_STEPS)
TRAIN_LOSS_RTOL = 1e-2
TRAIN_NORM_RTOL = 5e-2
TRAIN_LEAF_RTOL = 1e-1
TRAIN_FP32_TOL = 1e-4
MOE_WITNESS_SEEDS = (1, 2)  # more models and prompts for the MoE witness
# The tune phase: each candidate timed TUNE_REPEATS times (the best kept, as
# the reference's tuner keeps it); the tuned serve decodes TUNE_DECODE_STEPS
# steps; the DSE table at DSE_SIZE^3 (one of paper design G's sizes).  The
# plan caches live in TUNE_DIR, made by main and removed at its end.
TUNE_REPEATS = 3
TUNE_DECODE_STEPS = 8
DSE_SIZE = 4096
TUNE_DIR = ""
# The obs phase: the continuous trace's first OBS_REQUESTS requests over
# CONT_SLOTS slots, served with telemetry off and then on with every K1 call
# in a sampled window; the drift probe; the doctor on the run's metrics; the
# decode step with telemetry off and on (sampler off), OBS_BLOCKS alternating
# blocks of OBS_STEPS synchronized steps; the stale plan injected at
# OBS_STALE times the probe's reading of OBS_STALE_GEMM.
OBS_REQUESTS = 8
OBS_BLOCKS, OBS_STEPS = 4, 4
OBS_STALE, OBS_STALE_GEMM = 3.0, "ffn_in"
MOE_NUDGES, MOE_NUDGE_STEPS = 2, 2  # one-ulp nudges per model, decode steps each (3, 3 until cut for time)
SOURCES = {
    "systolic_mmm": ("src/repro_torch/csrc/systolic_mmm.cu", "src/repro/kernels/systolic/kernel.py:37"),
    "systolic_qmm": ("src/repro_torch/csrc/systolic_qmm.cu", "src/repro/kernels/systolic/kernel.py:174"),
    "flash_attn": ("src/repro_torch/csrc/flash_attn.cu", "src/repro/kernels/attention/kernel.py:30"),
    "grouped_mmm": ("src/repro_torch/csrc/grouped_mmm.cu", "src/repro/kernels/grouped/kernel.py:26"),
}
KERNELS = tuple(SOURCES)


def projections(cfg) -> collections.Counter:
    """(K, N) -> launches per layer and forward pass of the projection GEMM
    (fp or block-scaled): q, k, v, o -- MLA's wq_a, wq_b, wkv_a, wo --, then
    the SwiGLU's gate, up and down or the MoE router.  MLA's wkv_b is apart
    (``latent_expansion``): it runs at prefill and per chunk only."""
    d, hd, h = cfg.d_model, cfg.resolved_head_dim, cfg.n_heads
    c = collections.Counter()
    if cfg.attention == "mla":
        m = cfg.mla
        c[(d, m.q_lora_rank)] += 1
        c[(m.q_lora_rank, h * (m.qk_nope_head_dim + m.qk_rope_head_dim))] += 1
        c[(d, m.kv_lora_rank + m.qk_rope_head_dim)] += 1
        c[(h * m.v_head_dim, d)] += 1
    else:
        c[(d, h * hd)] += 1
        c[(d, cfg.n_kv_heads * hd)] += 2
        c[(h * hd, d)] += 1
    if cfg.moe is None:
        c[(d, cfg.d_ff)] += 2
        c[(cfg.d_ff, d)] += 1
    else:
        c[(d, cfg.moe.n_experts)] += 1
    return c


def latent_expansion(cfg) -> tuple[int, int] | None:
    """MLA's wkv_b (K, N): once per layer at prefill over the prompt's rows
    and per chunk over the whole cache's; decode folds it into plain
    einsums.  Never quantized, as in the reference."""
    if cfg.attention != "mla":
        return None
    m = cfg.mla
    return m.kv_lora_rank, cfg.n_heads * (m.qk_nope_head_dim + m.v_head_dim)


def stays_wide(cfg, k: int, n: int) -> bool:
    """The projections w8a8 leaves on the fp kernel: the MoE router (its
    subtree is skipped whole, as the reference skips it)."""
    return cfg.moe is not None and (k, n) == (cfg.d_model, cfg.moe.n_experts)


def quantized_projections(cfg) -> list[tuple[int, int]]:
    """(K, N) of the projections w8a8 runs on the block-scaled kernel."""
    return [kn for kn in projections(cfg) if not stays_wide(cfg, *kn)]


def expert_gemms(cfg) -> collections.Counter:
    """(K, N) -> grouped launches per MoE layer: gate and up, then down."""
    if cfg.moe is None:
        return collections.Counter()
    d, ff = cfg.d_model, cfg.moe.d_ff_expert
    c = collections.Counter()
    c[(d, ff)] += 2
    c[(ff, d)] += 1
    return c


def gemm_out_dtype(cfg, k: int, n: int) -> torch.dtype:
    """The router writes fp32 logits; every other projection the compute dtype."""
    return torch.float32 if cfg.moe is not None and (k, n) == (cfg.d_model, cfg.moe.n_experts) else BF16


def recurrent_gemms(cfg) -> list[tuple[int, int, torch.dtype, int]]:
    """(K, N, output dtype, launches per decode step) of a recurrent model's
    projections: per mLSTM layer w_up, wq / wk / wv, w_if (fp32 gates) and
    w_down; per sLSTM layer w_x (fp32 pre-activations) and its SwiGLU's gate
    and up, then down; per Mamba2 layer in_proj and out_proj; per
    application of the hybrid's shared block its attention and SwiGLU
    projections.  ``forward`` launches each once per layer at M = B x S."""
    d, s = cfg.d_model, cfg.ssm
    di = s.expand * d
    if cfg.family == "ssm":
        n_groups, n_m = xlstm_counts(cfg)
        nm, d_up = n_groups * n_m, int(4 * d / 3 / 8) * 8 or 8
        return [(d, 2 * di, BF16, nm), (di, di, BF16, 3 * nm), (di, 2 * cfg.n_heads, torch.float32, nm),
                (di, d, BF16, nm), (d, 4 * d, torch.float32, n_groups), (d, d_up, BF16, 2 * n_groups),
                (d_up, d, BF16, n_groups)]
    n_mamba, n_apps, _ = hybrid_counts(cfg)
    nh, gn = di // s.head_dim, s.n_groups * s.state_size
    return [(d, 2 * di + 2 * gn + nh, BF16, n_mamba), (di, d, BF16, n_mamba),
            *[(k, n, BF16, c * n_apps) for (k, n), c in projections(cfg).items()]]


def recurrent_projections(cfg) -> collections.Counter:
    """(K, N) -> K1 launches per decode step of a recurrent model (xlstm-125m:
    60, zamba2-7b: 217)."""
    c = collections.Counter()
    for k, n, _, per_step in recurrent_gemms(cfg):
        c[(k, n)] += per_step
    return c


def timed_out_dtype(k: int, n: int) -> torch.dtype:
    """The output dtype phase 4 times a served (K, N) at: fp32 where every
    served launch at that shape writes fp32 (the MoE router, mLSTM's gates),
    else bf16 (xlstm's w_x writes fp32 at the shape of w_up, which writes
    bf16)."""
    outs = set()
    for arch in (ARCH, MOE_ARCH, MLA_ARCH, SSM_ARCH, HYBRID_ARCH):
        cfg = configs.get_config(arch)
        if cfg.family in RECURRENT:
            outs |= {out for kk, nn, out, _ in recurrent_gemms(cfg) if (kk, nn) == (k, n)}
        elif (k, n) in projections(cfg):
            outs.add(gemm_out_dtype(cfg, k, n))
    return torch.float32 if outs == {torch.float32} else BF16


def state_bytes(cfg, slots: int) -> int:
    """Bytes of a recurrent model's decode state for ``slots`` slots, from
    its leaves (no sequence axis, so independent of max_len): per mLSTM
    layer fp32 C (H, hd, hd), n (H, hd) and m (H) and the bf16 conv window
    (K - 1, d_inner); per sLSTM layer fp32 c, n, m and h (d each)."""
    if cfg.family != "ssm":
        raise ValueError("state_bytes covers the SSM family's state")
    n_groups, n_m = xlstm_counts(cfg)
    di = cfg.ssm.expand * cfg.d_model
    h, hd = cfg.n_heads, di // cfg.n_heads
    mlstm = 4 * (h * hd * hd + h * hd + h) + 2 * (cfg.ssm.conv_kernel - 1) * di
    slstm = 4 * 4 * cfg.d_model
    return slots * (n_groups * n_m * mlstm + n_groups * slstm)


def prefix_len(cfg) -> int:
    """Cache positions a prompt holds before its tokens: the vit frontend's patches."""
    return cfg.n_patches if cfg.frontend == "vit" else 0


def projector_gemms(cfg) -> list[tuple[int, int]]:
    """(K, N) of the vit projector's two K1 launches, once per prefill over
    its batch's patches."""
    return [(cfg.vit_dim, cfg.d_model), (cfg.d_model, cfg.d_model)] if cfg.frontend == "vit" else []


def tied_head(cfg) -> tuple[int, int] | None:
    """(K, N) of the tied head's K1 launch (``layers.unembed``: the (V, d)
    table read K-major), once per pass over one row per sequence; None when
    the head is untied (a library product, no kernel)."""
    return (cfg.d_model, cfg.vocab_size) if cfg.tie_embeddings and cfg.frontend != "audio_codec" else None


failures: list[str] = []


def say(msg: str) -> None:
    print(msg, flush=True)


def expect(ok: bool, what: str) -> None:
    say(f"  {'ok  ' if ok else 'FAIL'} {what}")
    if not ok:
        failures.append(what)


# Every distinct plan the run launched, by counter (K1's launches_by_plan,
# K5's quant_launches_by_plan, K4's and K3's launches_by_plan): folded in by
# every reset, read by the audit phase.
RUN_PLANS: dict[str, set] = {"systolic": set(), "quant": set(), "grouped": set(), "attention": set()}


def reset_counts() -> None:
    """Zero every launch counter, after folding its plan keys into
    ``RUN_PLANS``."""
    RUN_PLANS["systolic"].update(mm_kernel.launches_by_plan)
    RUN_PLANS["quant"].update(mm_kernel.quant_launches_by_plan)
    RUN_PLANS["grouped"].update(grouped_kernel.launches_by_plan)
    RUN_PLANS["attention"].update(attn_kernel.launches_by_plan)
    mm_kernel.launches = 0
    mm_kernel.launches_by_shape.clear()
    mm_kernel.launches_by_path.clear()
    mm_kernel.launches_by_plan.clear()
    mm_kernel.quant_launches = 0
    mm_kernel.quant_launches_by_shape.clear()
    mm_kernel.quant_launches_by_path.clear()
    mm_kernel.quant_launches_by_plan.clear()
    attn_kernel.launches = 0
    attn_kernel.launches_by_plan.clear()
    grouped_kernel.launches = 0
    grouped_kernel.launches_by_shape.clear()
    grouped_kernel.launches_by_path.clear()
    grouped_kernel.launches_by_plan.clear()


def counts() -> dict:
    """Launches of each kernel since the last reset."""
    return {"systolic_mmm": mm_kernel.launches, "systolic_qmm": mm_kernel.quant_launches,
            "flash_attn": attn_kernel.launches, "grouped_mmm": grouped_kernel.launches}


def shape_counts() -> dict:
    """Launches of each GEMM since the last reset, by shape at the launch site:
    (M, K, N) for the projection GEMMs, (E, C, K, N) for the grouped one."""
    return {"systolic_mmm": dict(mm_kernel.launches_by_shape),
            "systolic_qmm": dict(mm_kernel.quant_launches_by_shape),
            "grouped_mmm": dict(grouped_kernel.launches_by_shape)}


def flash_shape_counts() -> dict:
    """Flash launches since the last reset by (B, Sq, Skv)."""
    return dict(attn_kernel.launches_by_shape())


def route_counts() -> dict:
    """Since the last reset: the launches of each GEMM by path, and flash
    attention's by the (H, Hkv) head counts it was given."""
    return {"systolic_mmm_paths": dict(mm_kernel.launches_by_path),
            "systolic_qmm_paths": dict(mm_kernel.quant_launches_by_path),
            "grouped_mmm_paths": dict(grouped_kernel.launches_by_path),
            "flash_attn_heads": dict(attn_kernel.launches_by_heads())}


@contextlib.contextmanager
def plain_versions():
    """Route the kernel wrappers' CUDA calls to their plain versions (for the
    comparison run only; the port itself has no such switch)."""

    def mm(a, b, bias, *, out_dtype, activation="none", **_path):
        return matmul_ref(a, b, bias, activation=activation, out_dtype=out_dtype)

    def qmm(a, a_s, b, b_s, path=None, plan_source=None, settled=False, **kw):
        return quant_systolic_matmul_ref(a, a_s, b, b_s, **kw)

    with mock.patch.object(mm_kernel, "systolic_matmul_call", mm), \
            mock.patch.object(mm_kernel, "quant_systolic_matmul_call", qmm), \
            mock.patch.object(attn_kernel, "flash_attention_call", flash_attention_call_ref), \
            mock.patch.object(grouped_kernel, "grouped_matmul_call", lambda x, w, rows=None, **_: grouped_matmul_ref(x, w)):
        yield


@contextlib.contextmanager
def quantized_activations(record: list, against: list | None = None):
    """Record each activation that core.ops quantizes for a GEMM, in call
    order: its int8 values, or, with ``against`` (the values another run
    recorded), how many of them differ from that run's at the same call, how
    many by more than one int8 step, and the largest difference in steps."""
    real = quant.quantize_act

    def rec(x, *args, **kw):
        q = real(x, *args, **kw)
        if against is None:
            record.append(q.values)
        else:
            d = (q.values.int() - against[len(record)].int()).abs()
            record.append((int((d > 0).sum()), int((d > 1).sum()), d.numel(), int(d.max())))
        return q

    with mock.patch.object(quant, "quantize_act", rec):
        yield


@contextlib.contextmanager
def checked_quant_calls(worst: list):
    """Hold every block-scaled kernel call against its plain version on the
    same inputs -- the model's own activations and scales -- within phase
    2's tolerance, recording each call's largest error as a share of its
    tolerance (the comparison itself launches no kernel)."""
    real = mm_kernel.quant_systolic_matmul_call

    def call(a, a_s, b, b_s, *, qk_a, qk_b, out_dtype, activation="none", **path):
        kw = dict(qk_a=qk_a, qk_b=qk_b)
        got = real(a, a_s, b, b_s, out_dtype=out_dtype, activation=activation, **kw, **path)
        want = quant_systolic_matmul_ref(a, a_s, b, b_s, out_dtype=out_dtype, activation=activation, **kw)
        pre = quant_systolic_matmul_ref(a, a_s, b, b_s, out_dtype=torch.float32, **kw)
        tol = QGEMM_ATOL * (pre.abs().max() + 1.0)
        tol = tol + (QGEMM_RTOL_BF16 if out_dtype == BF16 else 0.0) * want.float().abs()
        worst.append(((got.float() - want.float()).abs() / tol).max().item())
        return got

    with mock.patch.object(mm_kernel, "quant_systolic_matmul_call", call):
        yield

@contextlib.contextmanager
def checked_grouped_calls(worst: list):
    """Hold every grouped kernel call against its plain version on the same
    inputs -- the model's own dispatched tokens -- within phase 2's bf16
    tolerance, recording each call's largest error as a share of it."""
    real = grouped_kernel.grouped_matmul_call
    atol, rtol = GEMM_TOL_BF16

    def call(x, w, rows=None, **path):
        got = real(x, w, rows, **path)
        want = grouped_matmul_ref(x, w)  # every row, as the reference computes them
        worst.append(((got.float() - want.float()).abs() / (atol + rtol * want.float().abs())).max().item())
        return got

    with mock.patch.object(grouped_kernel, "grouped_matmul_call", call):
        yield


@contextlib.contextmanager
def topk_choices(record: list, replay: bool = False):
    """Record each MoE layer's top-k experts in call order; or, with
    ``replay``, route each layer to the recorded experts instead, weighting
    them by this run's own router probabilities (the run then dispatches
    and drops exactly as the recorded one did)."""
    real = moe._topk_shardable
    recorded = iter(record)

    def topk(probs, k):
        if replay:
            e = next(recorded)
            return probs.gather(-1, e), e
        w, e = real(probs, k)
        record.append(e.clone())
        return w, e

    with mock.patch.object(moe, "_topk_shardable", topk):
        yield


@contextlib.contextmanager
def recorded_routing(record: list):
    """Record each MoE layer's routing, in call order: the (token, choice)
    experts (G, T, k), which of those slots were dropped past capacity, and
    each expert's rows that hold a token (G, E), as the grouped kernel gets them."""
    real = moe._dispatch_group

    def dispatch(xf, top_e, top_w, cap, cfg):
        out = real(xf, top_e, top_w, cap, cfg)
        _, _, pos, order, _, rows = out
        dropped = torch.zeros_like(pos, dtype=torch.bool).scatter_(-1, order, pos >= cap)
        record.append((top_e.clone(), dropped.reshape(top_e.shape), rows.clone()))
        return out

    with mock.patch.object(moe, "_dispatch_group", dispatch):
        yield


def _keyed_leaves(tree, key=None):
    """(dict key, leaf) of every leaf; a list's items keep the key above them."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _keyed_leaves(v, k)
    elif isinstance(tree, list):
        for v in tree:
            yield from _keyed_leaves(v, key)
    else:
        yield key, tree


def randn(shape, gen, dtype):
    return torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32).to(dtype)


def close(got: torch.Tensor, want: torch.Tensor, atol: float, rtol: float) -> tuple[bool, float, float]:
    d = (got.float() - want.float()).abs()
    w = want.float().abs()
    ok = bool(torch.isfinite(got.float()).all()) and bool((d <= atol + rtol * w).all())
    return ok, d.max().item(), (d / w.clamp_min(1e-6)).max().item()


# ---------------------------------------------------------------------------
# Phase 1: device and build
# ---------------------------------------------------------------------------


def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    say("[1] device (nvidia-smi --query-gpu=name,power.limit --format=csv,noheader):")
    say(smi)
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    say(f"    device {name} sm_{cap[0]}{cap[1]} x{torch.cuda.device_count()}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}; python {sys.version.split()[0]}")
    if cap != (9, 0):
        raise RuntimeError(f"the kernels are built for sm_90a, this card is sm_{cap[0]}{cap[1]}")
    secs = _build.build_all()
    say(f"    kernel build: {secs:.1f} s (nvcc {_build.nvcc_path()}, one process per source)")
    for src, log in sorted(_build.build_log().items()):
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                say(f"    ptxas {src}: {line.split(':', 1)[-1].strip()}")
    return {"nvidia_smi": smi, "name": name, "build_s": secs, "torch": torch.__version__}


# ---------------------------------------------------------------------------
# Phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------


def check_gemm(m, k, n, dtype, gen, *, bias=False, act="none", out_dtype=None, model_weights=False,
               k_major=False) -> float:
    """K1 against its plain version on N(0, 1) operands; ``model_weights``
    draws B as the models draw their weights (N(0, 1) x K^-0.5,
    ``layers._dense_init``), so the outputs are O(1), as the model's are;
    ``k_major`` hands B over as the transpose of an (N, K) tensor, as the
    tied head hands over its table."""
    a = randn((m, k), gen, dtype)
    b = randn((n, k), gen, dtype).T if k_major else randn((k, n), gen, dtype)
    if model_weights:
        b = (b.float() * k**-0.5).to(dtype)
    bv = randn((n,), gen, torch.float32) if bias else None
    before = collections.Counter(mm_kernel.launches_by_path)
    got = mm_ops.matmul(a, b, bv, activation=act, out_dtype=out_dtype)
    path = next(iter(mm_kernel.launches_by_path - before))
    want = matmul_ref(a, b, bv, activation=act, out_dtype=out_dtype)
    atol, rtol = GEMM_TOL_BF16 if dtype == BF16 else (1e-5 * math.sqrt(k), GEMM_RTOL_FP32)
    ok, err, rel = close(got, want, atol, rtol)
    expect(ok and path.endswith("_kmajor") == k_major,
           f"gemm {str(dtype)[6:]:8s} M={m:<5d} K={k:<5d} N={n:<5d} bias={bias!s:5s} act={act:5s} "
           f"{path:13s} max_abs={err:.3e} max_rel={rel:.3e} (atol {atol:.1e}, rtol {rtol:.0e})")
    return err


def flash_operand(b, s, h, d, dtype, gen, layout):
    """A (B, H, S, D) operand: contiguous ("bhsd"), the transposed view of a
    (B, S, H, D) tensor ("bshd", as the models hold q, k and v), or that of
    every other head of a wider one ("sliced": uneven head and row strides)."""
    if layout == "bhsd":
        return randn((b, h, s, d), gen, dtype)
    if layout == "bshd":
        return randn((b, s, h, d), gen, dtype).transpose(1, 2)
    return randn((b, s, 2 * h, d), gen, dtype)[:, :, ::2].transpose(1, 2)


def check_flash(b, h, s, d, dtype, gen, *, hkv=None, window=None, causal=True, kv_valid=None, skv=None,
                layout="bshd") -> float:
    """Flash attention, K/V at ``hkv`` heads (default ``h``), against its
    plain version (K/V repeated to the query heads) on the same operands."""
    hkv, skv = hkv or h, skv or s
    q = flash_operand(b, s, h, d, dtype, gen, layout)
    k, v = (flash_operand(b, skv, hkv, d, dtype, gen, layout) for _ in range(2))
    got = attn_ops.flash_attention(q, k, v, causal=causal, window=window, kv_valid=kv_valid)
    kw = dict(scale=d**-0.5, causal=causal, window=window, kv_valid=skv if kv_valid is None else kv_valid)
    want = flash_attention_call_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), **kw).transpose(1, 2)
    tol = ATTN_TOL[dtype]
    ok, err, rel = close(got, want, tol, tol)
    expect(ok, f"flash {str(dtype)[6:]:8s} B={b} H={h}/{hkv} Sq={s} Skv={skv} D={d} {layout} causal={causal} "
               f"window={window} kv_valid={kv_valid} max_abs={err:.3e} max_rel={rel:.3e} (tol {tol:.0e})")
    return err


def check_qgemm(m, k, n, qd, gen, *, qk=(128, 128), act="none", out_dtype=BF16) -> float:
    """The block-scaled kernel against its plain version on one quantized
    pair, the weight K-major as the served w8a8 weights are."""
    qa = quant.quantize(randn((m, k), gen, torch.float32), qd, block=(1, qk[0]))
    qb = quant.quantize(randn((k, n), gen, torch.float32), qd, block=(qk[1], 1))
    qbk = quant.k_major({"w": qb})["w"]
    before = collections.Counter(mm_kernel.quant_launches_by_path)
    got = mm_ops.quant_matmul(qa, qbk, out_dtype=out_dtype, activation=act)
    path = next(iter(mm_kernel.quant_launches_by_path - before))
    want = quant_matmul_ref(qa, qb, activation=act, out_dtype=out_dtype)
    pre = quant_matmul_ref(qa, qb, out_dtype=torch.float32)
    atol = QGEMM_ATOL * (pre.abs().max().item() + 1.0)
    rtol = QGEMM_RTOL_BF16 if out_dtype == BF16 else 0.0
    ok, err, rel = close(got, want, atol, rtol)
    expect(ok and got.dtype == out_dtype,
           f"qgemm {qd:4s} M={m:<5d} K={k:<5d} N={n:<5d} qk={qk!s:9s} act={act:5s} out={str(out_dtype)[6:]:8s} "
           f"{path:6s} max_abs={err:.3e} max_rel={rel:.3e} (atol {atol:.1e}, rtol {rtol:.1e})")
    return err


def rows_pattern(name: str, e: int, c: int, gen) -> list | None:
    """Rows that can hold a token, per expert: None (the kernel computes all
    C), "empty" (0), "partial" (random counts in [0, C]), "full" (C), or
    "decode" (a batch-4 top-8 decode step: 32 slots on random experts)."""
    if name == "none":
        return None
    if name == "decode":
        picks = torch.randint(0, e, (BATCH * 8,), generator=gen, device="cuda")
        return torch.bincount(picks, minlength=e).clamp(max=c).tolist()
    if name == "partial":
        return torch.randint(0, c + 1, (e,), generator=gen, device="cuda").tolist()
    return [0 if name == "empty" else c] * e


def check_grouped(e, c, k, n, dtype, gen, rows: str = "none") -> float:
    """The grouped expert GEMM against its plain version (output in the
    operands' dtype), with the rows of a ``rows_pattern`` (x zero past each
    expert's count, as the dispatch leaves it)."""
    x, w = randn((e, c, k), gen, dtype), randn((e, k, n), gen, dtype)
    counts = rows_pattern(rows, e, c, gen)
    r = None
    if counts is not None:
        r = torch.tensor(counts, dtype=torch.int32, device="cuda")
        x = x * (torch.arange(c, device="cuda")[None, :, None] < r[:, None, None]).to(dtype)
    before = collections.Counter(grouped_kernel.launches_by_path)
    got = grouped_ops.grouped_matmul(x, w, rows=r)
    path = next(iter(grouped_kernel.launches_by_path - before))
    want = grouped_matmul_ref(x, w)
    atol, rtol = GEMM_TOL_BF16 if dtype == BF16 else (1e-5 * math.sqrt(k), GEMM_RTOL_FP32)
    ok, err, rel = close(got, want, atol, rtol)
    same = "" if r is None else (" bits = all rows" if torch.equal(got, grouped_ops.grouped_matmul(x, w))
                                 else " BITS DIFFER from all rows")
    expect(ok and tuple(got.shape) == (e, c, n) and got.dtype == dtype and "DIFFER" not in same,
           f"grouped {str(dtype)[6:]:8s} E={e:<4d} C={c:<4d} K={k:<5d} N={n:<5d} rows={rows:7s} {path:13s} "
           f"max_abs={err:.3e} max_rel={rel:.3e} (atol {atol:.1e}, rtol {rtol:.0e}){same}")
    return err


def continuous_trace(cfg) -> list[dict]:
    """The continuous path's request trace, on the card.  A vit request's
    prompt holds the model's patches and then text: the trace's prompt
    lengths (mean, least and most) count the patches too, so the text is
    drawn around the others' prompt lengths (its tokens are the text)."""
    p = prefix_len(cfg)
    kw = dict(CONT_TRACE, mean_prompt=CONT_TRACE["mean_prompt"] + p, min_prompt=4 + p,
              max_prompt=CONT_TRACE["max_prompt"] + p) if p else CONT_TRACE
    return make_request_trace(cfg, device="cuda", **kw)


def prompt_positions(cfg, trace: list[dict]) -> list[int]:
    """Each request's cache positions after its prefill: tokens and patches."""
    return [t["prompt"]["tokens"].shape[1] + prefix_len(cfg) for t in trace]


def phase_kernels() -> dict:
    say("[2] kernels against their plain versions on the card")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    mm_err = 0.0
    for arch in (ARCH, MOE_ARCH, MLA_ARCH):
        cfg = configs.get_config(arch)
        for m in (4, BATCH * PROMPT):
            for k, n in projections(cfg):
                mm_err = max(mm_err, check_gemm(m, k, n, BF16, gen, out_dtype=gemm_out_dtype(cfg, k, n)))
    # minicpm3-4b (MLA): wkv_b over the prefill's rows (K = 256); the
    # continuous runs' batch-1 prefills (wkv_b over each prompt) and decode
    # over the slots; the chunked run's pieces, each chunk expanding the
    # whole batch-1 cache (max_len rows) through wkv_b.
    mla = configs.get_config(MLA_ARCH)
    mla_trace = continuous_trace(mla)
    mla_lens = sorted({t["prompt"]["tokens"].shape[1] for t in mla_trace})
    mla_max_len = max(t["prompt"]["tokens"].shape[1] + t["max_new_tokens"] for t in mla_trace)
    pieces = {length for p in mla_lens for _, length in chunk_schedule(p, MLA_CHUNK)}
    for m in sorted({CONT_SLOTS, *mla_lens, *pieces}):
        for k, n in projections(mla):
            mm_err = max(mm_err, check_gemm(m, k, n, BF16, gen))
    for m in sorted({BATCH * PROMPT, *mla_lens, mla_max_len}):
        mm_err = max(mm_err, check_gemm(m, *latent_expansion(mla), BF16, gen))
    # The continuous path's GEMMs: the decode step over the slots, and each
    # request's batch-1 prefill at its prompt length.
    cfg = configs.get_config(ARCH)
    cont_lens = sorted({t["prompt"]["tokens"].shape[1] for t in continuous_trace(cfg)})
    for m in (CONT_SLOTS, *cont_lens):
        for k, n in projections(cfg):
            mm_err = max(mm_err, check_gemm(m, k, n, BF16, gen))
    # The long-prompt path's: chunks of 512 and the short prompts of 128 (each
    # one chunk), the monolithic 8192-token prompt, the decode step over 5 slots.
    for m in (LONG_CHUNK, LONG_TRACE["short_prompt"], LONG_TRACE["long_prompt"], LONG_SLOTS):
        for k, n in projections(cfg):
            mm_err = max(mm_err, check_gemm(m, k, n, BF16, gen))
    # The paged path's: a miss's whole prompt, a prefix hit's suffix.
    for m in (PAGED_PROMPT, PAGED_TRACE["suffix_len"]):
        for k, n in projections(cfg):
            mm_err = max(mm_err, check_gemm(m, k, n, BF16, gen))
    for m, n, k in ((33, 257, 129), (100, 130, 70)):
        for dt in (torch.float32, BF16):
            check_gemm(m, k, n, dt, gen)
    check_gemm(1, 1000, 300, BF16, gen)  # decode tile, K split across blocks, ragged N and K
    for act in ACTIVATIONS:
        check_gemm(64, 96, 160, torch.float32, gen, bias=True, act=act)
        check_gemm(4, 1000, 300, BF16, gen, bias=True, act=act)  # epilogue after the split-K sum
        check_gemm(100, 130, 70, BF16, gen, bias=True, act=act, out_dtype=torch.float32)
    check_gemm(BATCH * PROMPT, 2048, 8192, BF16, gen, bias=True)  # the shape K2 is timed at
    # Ragged M, N and K (multiples of 8) that TMA zero-fills, on each wgmma
    # tile the path rule picks (128x256, 128x128, 64x128), every epilogue.
    for m, n, k in ((2000, 8184, 2040), (1000, 2040, 1000), (300, 264, 200), (17, 8, 8)):
        for act in ACTIVATIONS:
            check_gemm(m, k, n, BF16, gen, bias=True, act=act, out_dtype=torch.float32 if act == "gelu" else None)
    # The recurrent families' projections: M = 1 (the continuous run's batch-1
    # prefill steps), 4 (every served step of the synchronized batch), 8 (the
    # continuous decode over 8 slots), 2048 (forward over 4 x 512: the wgmma
    # tiles; N = 8 on a 64x128 tile) and a ragged 1000, fp32 out where the
    # model asks for it (mLSTM's gates, sLSTM's pre-activations); and in fp32
    # at M = 512, the fp32 forward's rows, the weights at the model's scale:
    # with N(0, 1) weights the outputs grow as sqrt(K) and so does each
    # partial sum's rounding, past atol 1e-5 x sqrt(K) at K = 14336.
    for arch in (SSM_ARCH, HYBRID_ARCH):
        for k, n, out, _ in recurrent_gemms(configs.get_config(arch)):
            for m in (1, BATCH, CONT_SLOTS, 1000, BATCH * PROMPT):
                mm_err = max(mm_err, check_gemm(m, k, n, BF16, gen, out_dtype=out))
            check_gemm(PROMPT, k, n, torch.float32, gen, model_weights=True)
    # The frontends' GEMMs: musicgen-medium's and internvl2-1b's layers at
    # decode (M = 4) and prefill (4 x 512); internvl2-1b's continuous run
    # (each prompt's positions, the decode step over the slots); the vit
    # projector over the batch's patches (4 x 256) and one request's (256);
    # the tied head's table read K-major, fp32 out, at decode (M = 1, 4, 8)
    # and over a forward's 1024 rows; ragged K-major shapes on each tile
    # that reads B so, with an epilogue.
    for arch in (AUDIO_ARCH, VLM_ARCH):
        for m in (4, BATCH * PROMPT):
            for k, n in projections(configs.get_config(arch)):
                mm_err = max(mm_err, check_gemm(m, k, n, BF16, gen))
    vlm = configs.get_config(VLM_ARCH)
    vlm_lens = sorted(set(prompt_positions(vlm, continuous_trace(vlm))))
    for m in (CONT_SLOTS, *vlm_lens):
        for k, n in projections(vlm):
            mm_err = max(mm_err, check_gemm(m, k, n, BF16, gen))
    for m in (BATCH * vlm.n_patches, vlm.n_patches):
        for k, n in projector_gemms(vlm):
            mm_err = max(mm_err, check_gemm(m, k, n, BF16, gen))
    head = tied_head(dataclasses.replace(vlm, tie_embeddings=True))
    for m in (1, BATCH, CONT_SLOTS, 1024):
        mm_err = max(mm_err, check_gemm(m, *head, BF16, gen, out_dtype=torch.float32, k_major=True))
    for m, n, k in ((1, 300, 1000), (9, 4000, 70), (100, 130, 70), (300, 264, 200)):
        for dt in (torch.float32, BF16):
            check_gemm(m, k, n, dt, gen, k_major=True, bias=True, act="gelu")
    q_err = 0.0
    for qd in quant.QDTYPES:
        for m in (4, BATCH * PROMPT):
            for k, n in projections(configs.get_config(ARCH)):
                err = check_qgemm(m, k, n, qd, gen)
                q_err = max(q_err, err) if qd == "int8" else q_err  # the main path's dtype
    for arch in (MLA_ARCH, MOE_ARCH):  # the other w8a8 paths' projections, int8 as served
        for m in (4, BATCH * PROMPT):
            for k, n in quantized_projections(configs.get_config(arch)):
                q_err = max(q_err, check_qgemm(m, k, n, "int8", gen))
    for qd in quant.QDTYPES:
        # Ragged: the WMMA tiles (K off the 16 grid, N off the 8 grid, the
        # decode tile) and the wgmma tile (K a multiple of 16, N of 8).
        for m, k, n in ((72, 100, 130), (300, 515, 257), (1, 300, 1000), (9, 70, 4000),
                        (300, 528, 264), (2000, 2064, 1032), (17, 16, 8)):
            check_qgemm(m, k, n, qd, gen, out_dtype=torch.float32)
        for qk in ((64, 64), (32, 32), (0, 0), (128, 64), (32, 0), (48, 32), (256, 256)):
            check_qgemm(4, 1000, 300, qd, gen, qk=qk, out_dtype=torch.float32)  # split-K, partial last block
            check_qgemm(100, 520, 130, qd, gen, qk=qk, out_dtype=torch.float32)
            check_qgemm(100, 528, 136, qd, gen, qk=qk, out_dtype=torch.float32)  # int8 whole-K: the wgmma tile
        for act in ACTIVATIONS:
            check_qgemm(4, 1000, 300, qd, gen, act=act)
            check_qgemm(100, 520, 130, qd, gen, act=act, out_dtype=torch.float32)
            check_qgemm(300, 528, 264, qd, gen, act=act)
            check_qgemm(300, 528, 264, qd, gen, act=act, out_dtype=torch.float32)
    attn_err = 0.0
    for arch in (ARCH, MOE_ARCH):  # each model's heads, in its own (B, S, H, D) layout
        cfg = configs.get_config(arch)
        for s, window in ((PROMPT, None), (PROMPT, 128), (500, None)):
            attn_err = max(attn_err, check_flash(BATCH, cfg.n_heads, s, cfg.resolved_head_dim, BF16, gen,
                                                 hkv=cfg.n_kv_heads, window=window))
    cfg = configs.get_config(ARCH)
    for s in (*cont_lens, LONG_TRACE["short_prompt"], LONG_TRACE["long_prompt"], PAGED_PROMPT):  # batch-1 prefills
        attn_err = max(attn_err, check_flash(1, cfg.n_heads, s, cfg.resolved_head_dim, BF16, gen, hkv=cfg.n_kv_heads))
    for arch in (AUDIO_ARCH, VLM_ARCH):  # musicgen's 24/24 heads; internvl2's 14/2, a group of 7
        cfg = configs.get_config(arch)
        attn_err = max(attn_err, check_flash(BATCH, cfg.n_heads, PROMPT, cfg.resolved_head_dim, BF16, gen,
                                             hkv=cfg.n_kv_heads))
    for s in vlm_lens:  # internvl2's batch-1 prefills in its continuous run
        attn_err = max(attn_err, check_flash(1, vlm.n_heads, s, vlm.resolved_head_dim, BF16, gen, hkv=vlm.n_kv_heads))
    hyb = configs.get_config(HYBRID_ARCH)  # zamba2's shared attention: 32/32 heads of 112
    for b, dt in ((1, BF16), (BATCH, BF16), (1, torch.float32)):  # forward's row (bf16, fp32) and a batch
        attn_err = max(attn_err, check_flash(b, hyb.n_heads, PROMPT, hyb.resolved_head_dim, dt, gen,
                                             hkv=hyb.n_kv_heads))
    for d in (16, 64, 112, 120, 128):  # head dims of the zoo (112: zamba2; 120: h2o-danube3; 16, 64: SMOKE)
        for hkv in (8, 4, 1):  # 1, 2 and 8 query heads per KV head
            for layout in ("bshd", "bhsd", "sliced"):
                check_flash(2, 8, 200, d, BF16, gen, hkv=hkv, layout=layout)
            check_flash(2, 8, 190, d, BF16, gen, hkv=hkv, window=64, kv_valid=150)
            check_flash(2, 8, 100, d, BF16, gen, hkv=hkv, causal=False, kv_valid=70)
            check_flash(2, 8, 130, d, torch.float32, gen, hkv=hkv, window=32, skv=230, layout="sliced")
    g_err = 0.0
    moe_cfg = configs.get_config(MOE_ARCH)
    e_moe = moe_cfg.moe.n_experts
    for t in (BATCH * PROMPT, BATCH):  # prefill and decode capacity: 160 and 8 rows per expert
        c = moe.capacity(t, moe_cfg)
        for k, n in expert_gemms(moe_cfg):
            for rows in ("none", "full", "partial", "empty", "decode"):
                g_err = max(g_err, check_grouped(e_moe, c, k, n, BF16, gen, rows))
    for c in (100, 200):  # the 128-row wgmma tile, one and two row tiles per expert
        for k, n in expert_gemms(moe_cfg):
            for rows in ("none", "partial", "decode"):
                check_grouped(16, c, k, n, BF16, gen, rows)
    for c in (100, 160, 200):  # K and N not multiples of 64, multiples of 8 (TMA zero-fills)
        for rows in ("none", "empty", "partial", "full"):
            check_grouped(5, c, 200, 136, BF16, gen, rows)
    for c in (1, 13, 100):  # ragged C (the decode and WMMA tiles), K and N
        check_grouped(4, c, 70, 130, BF16, gen)
        check_grouped(4, c, 70, 130, BF16, gen, "partial")
        check_grouped(4, c, 70, 130, torch.float32, gen)
        check_grouped(4, c, 70, 130, torch.float32, gen, "partial")
    check_grouped(1, 160, 2048, 768, BF16, gen)  # one expert
    check_grouped(1, 8, 768, 2048, torch.float32, gen)
    torch.cuda.synchronize()
    return {"systolic_mmm": mm_err, "systolic_qmm": q_err, "flash_attn": attn_err, "grouped_mmm": g_err}


# ---------------------------------------------------------------------------
# Phase 3: serve full-width internlm2-1.8b
# ---------------------------------------------------------------------------


def launches_at(cfg, gemm: str, tokens: int, steps: int, prefill: bool,
                kv_rows: int | None = None, seqs: int | None = None) -> tuple[dict, dict]:
    """(launches per kernel, launches per kernel and shape) that ``steps``
    forward passes over ``tokens`` rows (M) must make, each a monolithic
    prefill, a chunk or a decode step: every projection on ``gemm``
    ("systolic_mmm" or "systolic_qmm") but the router, which stays on the fp
    kernel; MLA's wkv_b on the fp kernel over ``kv_rows`` rows (a prefill's
    own tokens; a chunk's whole cache; none at decode); every expert GEMM on
    the grouped kernel at the dispatch capacity; flash attention once per
    layer in a monolithic GQA prefill only (MLA's attention is plain).  A
    recurrent model's pass is a decode step (its prefill scans them): its
    projections at M = ``tokens``, ``steps`` times, and no flash launch.
    The frontends (``seqs``: the pass's sequences, default ``tokens``, as in
    a decode step): the vit projector's two launches on the fp kernel at
    M = ``seqs`` x n_patches in a monolithic prefill; a tied head's one
    K-major launch per pass at M = ``seqs`` (prefill and chunks head their
    last position only)."""
    n_layers = cfg.n_layers
    seqs = tokens if seqs is None else seqs
    shapes = {"systolic_mmm": {}, "systolic_qmm": {}, "grouped_mmm": {}}
    if cfg.family in RECURRENT:
        shapes[gemm] = {(tokens, k, n): c * steps for (k, n), c in recurrent_projections(cfg).items()}
        total = {name: sum(by.values()) for name, by in shapes.items()}
        return {**total, "flash_attn": 0}, shapes
    for (k, n), mult in projections(cfg).items():
        shapes["systolic_mmm" if stays_wide(cfg, k, n) else gemm][(tokens, k, n)] = mult * n_layers * steps
    kv_rows = tokens if prefill else kv_rows
    if latent_expansion(cfg) is not None and kv_rows is not None:
        key = (kv_rows, *latent_expansion(cfg))
        shapes["systolic_mmm"][key] = shapes["systolic_mmm"].get(key, 0) + n_layers * steps
    extra = [(seqs * cfg.n_patches, k, n) for k, n in projector_gemms(cfg)] if prefill else []
    extra += [(seqs, *tied_head(cfg))] if tied_head(cfg) else []
    for key in extra:
        shapes["systolic_mmm"][key] = shapes["systolic_mmm"].get(key, 0) + steps
    if cfg.moe is not None:
        g = cfg.moe.dispatch_groups
        rows = g * moe.capacity(tokens // g, cfg)  # the groups fold into one launch
        shapes["grouped_mmm"] = {(cfg.moe.n_experts, rows, k, n): mult * n_layers * steps
                                 for (k, n), mult in expert_gemms(cfg).items()}
    total = {name: sum(by.values()) for name, by in shapes.items()}
    total["flash_attn"] = n_layers * steps if prefill and cfg.attention != "mla" else 0
    return total, shapes


def expected_launches(cfg, gemm: str, prefill: bool) -> tuple[dict, dict]:
    """``launches_at`` for a synchronized prefill (BATCH x PROMPT rows) or
    its GEN - 1 decode steps (BATCH rows)."""
    if prefill:
        return launches_at(cfg, gemm, BATCH * PROMPT, 1, True, seqs=BATCH)
    return launches_at(cfg, gemm, BATCH, GEN - 1, False)


def expected_routes(cfg, shapes: dict, prefills: int) -> dict:
    """Each GEMM's launches by path that the shapes ``shapes`` (from
    launches_at) must make with operands the model hands over aligned, int8
    weights K-major and 128-k scale blocks (every launch at M > 16 on a
    wgmma tile, every one at M <= 16 on the decode tile; a tied head's on
    the tile of its shape that reads B K-major), and flash
    attention's by the model's (H, Hkv), once per layer in each of
    ``prefills`` prefills."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    prefills = prefills if cfg.attention != "mla" else 0  # MLA reaches no flash kernel
    mm, qmm, grouped = collections.Counter(), collections.Counter(), collections.Counter()
    for (m, k, n), c in shapes["systolic_mmm"].items():
        mm[mm_kernel.gemm_path(m, n, k, BF16, True, sms, k_major=(k, n) == tied_head(cfg))] += c
    for (m, k, n), c in shapes["systolic_qmm"].items():
        qmm[mm_kernel.qgemm_path(m, n, k, quant.DEFAULT_BLOCK_K, torch.int8, True)] += c
    for (e, rows, k, n), c in shapes["grouped_mmm"].items():
        grouped[grouped_kernel.grouped_path(rows, k, n, BF16, True)] += c
    return {"systolic_mmm_paths": dict(mm), "systolic_qmm_paths": dict(qmm), "grouped_mmm_paths": dict(grouped),
            "flash_attn_heads": {(cfg.n_heads, cfg.n_kv_heads): cfg.n_layers * prefills} if prefills else {}}


def serve_path(label: str, model, params, want: dict, batch, feed=None) -> dict:
    """Serve one synchronized batch through ServeEngine on the kernels, with
    the counts set to 0 just before prefill and decode and read just after;
    then hold the kernel path's prefill logits and two decode steps from one
    cache against the plain path, and a second kernel-path prefill against
    the first, bit for bit.  ``want``: the kernel that the projections must
    hit ("systolic_mmm" or "systolic_qmm") and the logits tolerance.
    ``feed``: the tokens to feed the two decode steps (default: the kernel
    path's own greedy tokens)."""
    cfg = model.cfg
    engine = ServeEngine(model, params, ServeConfig(max_len=PROMPT + GEN, batch=BATCH), device="cuda")
    engine.generate(batch, 2)  # warm-up: library handles, first launches (not counted)
    torch.cuda.synchronize()

    reset_counts()
    t0 = time.perf_counter()
    first = engine.prefill(batch)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    pf_counts, pf_shapes, pf_routes = counts(), shape_counts(), route_counts()
    reset_counts()
    t0 = time.perf_counter()
    rest = engine.decode(first, GEN - 1)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    dec_counts, dec_shapes, dec_routes = counts(), shape_counts(), route_counts()
    tokens = torch.cat([first, rest], dim=1)
    say(f"    {label}: prefill {t_prefill * 1e3:.3f} ms; decode {t_decode / (GEN - 1) * 1e3:.3f} ms/step, "
        f"{BATCH * (GEN - 1) / t_decode:.1f} tok/s over {GEN - 1} steps")
    want_pf, want_pf_shapes = expected_launches(cfg, want["gemm"], prefill=True)
    want_dec, want_dec_shapes = expected_launches(cfg, want["gemm"], prefill=False)
    expect(pf_counts == want_pf, f"{label} prefill launches: {pf_counts}, want {want_pf}")
    expect(dec_counts == want_dec, f"{label} decode launches over {GEN - 1} steps: {dec_counts}, want {want_dec}")
    want_shape = (BATCH, GEN, cfg.n_codebooks) if cfg.frontend == "audio_codec" else (BATCH, GEN)
    expect(tuple(tokens.shape) == want_shape and bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
           f"{label} tokens {tuple(tokens.shape)} in [0, {cfg.vocab_size}): {tokens[0, :12].tolist()}")
    # Per-shape counts, from the launch site: the timing phase weights each
    # shape's time by these, so they must be the model's own GEMMs.
    for name, by in pf_shapes.items():
        expect(by == want_pf_shapes[name], f"{label} prefill {name} launches by shape: {sorted(by.items())}")
        expect(dec_shapes[name] == want_dec_shapes[name],
               f"{label} decode {name} launches by shape: {sorted(dec_shapes[name].items())}")
    # Routes: each GEMM's path of every launch (a prefill operand off TMA's
    # alignment would land on a WMMA tile),
    # flash's K/V heads.
    for name in ("systolic_mmm", "systolic_qmm", "grouped_mmm"):
        pf_paths = pf_routes[f"{name}_paths"]
        if pf_counts[name]:
            expect(all(p.startswith("wgmma") for p in pf_paths) and sum(pf_paths.values()) == pf_counts[name],
                   f"{label} prefill: all {pf_counts[name]} {name} launches on a wgmma tile: {pf_paths}")
    for phase, got_r, want_r in (("prefill", pf_routes, expected_routes(cfg, want_pf_shapes, 1)),
                                 ("decode", dec_routes, expected_routes(cfg, want_dec_shapes, 0))):
        for key in got_r:
            expect(got_r[key] == want_r[key], f"{label} {phase} {key}: {got_r[key]}, want {want_r[key]}")

    logits = []  # the kernel path's prefill and two decode-step logits
    # w8a8: each GEMM's int8 activations on the kernel path, the plain path's
    # differences from them, and each kernel call against its plain version.
    # MoE: each grouped call against its plain version, and each layer's
    # routing on both paths.
    acts_k, flips, routing_k, routing_p, choices = [], [], [], [], []
    quantized = want["gemm"] == "systolic_qmm"
    is_moe = cfg.moe is not None
    in_model = {"systolic_qmm": [], "grouped_mmm": []}  # each kernel call's error as a share of its tolerance
    with torch.no_grad():
        reset_counts()
        with contextlib.ExitStack() as stack:
            if quantized:
                stack.enter_context(quantized_activations(acts_k))
                stack.enter_context(checked_quant_calls(in_model["systolic_qmm"]))
            if is_moe:
                stack.enter_context(checked_grouped_calls(in_model["grouped_mmm"]))
                stack.enter_context(recorded_routing(routing_k))
                stack.enter_context(topk_choices(choices))
            got, cache_k = model.prefill(params, batch, max_len=PROMPT + GEN)
        again, _ = model.prefill(params, batch, max_len=PROMPT + GEN)
        expect(torch.equal(got, again), f"{label} two kernel-path prefills give bit-identical logits")
        del again
        kernel_counts = counts()
        for name, shares in in_model.items():
            if not shares:
                continue
            n_calls = sum(want_pf_shapes[name].values())
            expect(len(shares) == n_calls and max(shares) <= 1.0,
                   f"{label} prefill: each of the {len(shares)} {name} kernel calls against its plain version on "
                   f"the model's own inputs: worst error {max(shares):.3f} of the tolerance")
        with contextlib.ExitStack() as stack:
            stack.enter_context(plain_versions())
            if quantized:
                stack.enter_context(quantized_activations(flips, acts_k))
            if is_moe:
                stack.enter_context(recorded_routing(routing_p))
            want_l, _ = model.prefill(params, batch, max_len=PROMPT + GEN)
        plain_counts = {k: c - kernel_counts[k] for k, c in counts().items()}
        expect(not any(plain_counts.values()), f"{label} plain-path prefill launched no kernel ({plain_counts})")
        err, scale = compare_logits(f"{label} prefill", got, want_l, want["tol"])
        if quantized:
            flips = activation_flips(label, flips, cfg)
        routing = routing_witness(label, routing_k, routing_p) if is_moe else None
        # MoE: each layer's rows per expert (G = 1), for phase 4's timing at the model's routing.
        prefill_rows = [r[2][0].tolist() for r in routing_k]
        alike = []  # MoE: the gaps with the plain path routed as the kernel path
        if is_moe:
            with plain_versions(), topk_choices(choices, replay=True):
                want_r, _ = model.prefill(params, batch, max_len=PROMPT + GEN)
            alike.append(compare_logits(f"{label} prefill, plain path routed as the kernel path", got, want_r,
                                        LOGITS_TOL_BF16)[0])
        del acts_k, routing_k, routing_p, choices
        logits.append(got)
        # Two decode steps from one cache: the kernel path's primed cache, and
        # a copy of it for the plain path (and, MoE, another for the plain
        # path routed as the kernel path); all are fed the same tokens.
        cache_p = tree_util.tree_map(torch.clone, cache_k)
        cache_r = tree_util.tree_map(torch.clone, cache_k) if is_moe else None
        tok, dec_err, fed, routing_dec = got.argmax(-1).to(torch.int32), 0.0, [], []
        for step in range(2):
            tok = tok if feed is None else feed[step]
            fed.append(tok)
            choices = []
            with contextlib.ExitStack() as stack:
                if is_moe:
                    stack.enter_context(topk_choices(choices))
                    if step == 0:
                        stack.enter_context(recorded_routing(routing_dec))
                lk, cache_k = model.decode_step(params, tok, cache=cache_k, pos=PROMPT + step)
            n0 = counts()
            with plain_versions():
                lp, cache_p = model.decode_step(params, tok, cache=cache_p, pos=PROMPT + step)
                if is_moe:
                    with topk_choices(choices, replay=True):
                        lr, cache_r = model.decode_step(params, tok, cache=cache_r, pos=PROMPT + step)
                    alike.append(compare_logits(f"{label} decode step {step}, plain path routed as the kernel path",
                                                lk, lr, LOGITS_TOL_BF16)[0])
            expect(counts() == n0, f"{label} plain-path decode step {step} launched no kernel")
            dec_err = max(dec_err, compare_logits(f"{label} decode step {step}", lk, lp, want["tol"])[0])
            logits.append(lk)
            tok = lk.argmax(-1).to(torch.int32)
    del engine, cache_k, cache_p, cache_r

    return {
        "arch": cfg.name,
        "prefill_ms": t_prefill * 1e3,
        "decode_ms_per_step": t_decode / (GEN - 1) * 1e3,
        "decode_tok_s": BATCH * (GEN - 1) / t_decode,
        "prefill_launches": pf_counts,
        "decode_launches": dec_counts,
        "prefill_shapes": listed(pf_shapes),
        "decode_shapes": listed(dec_shapes),
        "prefill_routes": {k: {str(kk): c for kk, c in v.items()} for k, v in pf_routes.items()},
        "decode_routes": {k: {str(kk): c for kk, c in v.items()} for k, v in dec_routes.items()},
        "logits_max_abs_err": err,
        "logits_scale": scale,
        "prefill_activation_flips": flips,
        "prefill_routing": routing,
        "routed_alike_max_abs_err": alike,  # MoE: prefill, decode step 0, decode step 1
        "prefill_kernel_calls_worst_share_of_tol": {k: max(v) for k, v in in_model.items() if v} or None,
        "prefill_rows": prefill_rows,  # MoE: rows per expert by layer, prefill and decode step 0
        "decode_rows": [r[2][0].tolist() for r in routing_dec],
        "decode_logits_max_abs_err": dec_err,
        "logits": logits,
        "fed": fed,
    }


def routing_witness(label: str, kernel: list, plain: list) -> dict:
    """By layer, the (token, choice) expert assignments in which the plain
    path's prefill differs from the kernel path's, the tokens whose set of
    experts differs, and the slots dropped past capacity on each path and on
    one path only.  Layer 0 routes the same normed embedding after one
    attention block on both paths, so any difference there comes from the
    attention and projection kernels' rounding."""
    expect(len(kernel) == len(plain), f"{label} prefill routed {len(kernel)} layers on the kernel path, "
                                      f"{len(plain)} on the plain path")
    rows = []
    for (ek, dk, _), (ep, dp, _) in zip(kernel, plain):
        sets_differ = (ek.sort(dim=-1).values != ep.sort(dim=-1).values).any(dim=-1)
        rows.append({"assignments_differ": int((ek != ep).sum()), "tokens_other_experts": int(sets_differ.sum()),
                     "dropped_kernel": int(dk.sum()), "dropped_plain": int(dp.sum()),
                     "drops_differ": int((dk != dp).sum())})
    n = kernel[0][0].numel() if kernel else 0
    say(f"    {label} prefill routing, plain vs kernel path, by layer ((token, choice) assignments that differ of "
        f"{n}): {' '.join(str(r['assignments_differ']) for r in rows)}")
    say(f"    ... tokens routed to another set of experts: {' '.join(str(r['tokens_other_experts']) for r in rows)}")
    say(f"    ... slots dropped past capacity (kernel path): {' '.join(str(r['dropped_kernel']) for r in rows)}; "
        f"dropped on one path only: {' '.join(str(r['drops_differ']) for r in rows)}")
    return {"slots_per_layer": n, "by_layer": rows}


def continuous_expected(cfg, prompt_lens: list, decode_steps: int, slots: int | None = None,
                        chunk: int | None = None, max_len: int | None = None, hits: list = (),
                        warmup_lens: list | None = None) -> tuple[dict, dict, dict, dict]:
    """(launches per kernel, per kernel and shape, by route, flash launches by
    (B, Sq, Skv)) that a continuous run must make: a batch-1 prefill per
    admission at M = its prompt length (its cache positions: a vit prompt's
    patches count), one more per distinct prompt length
    of ``warmup_lens`` (default: ``prompt_lens``) in warmup, and
    ``decode_steps`` + 1 (warmup's all-empty step) decode steps at M = the
    slot count.  With ``chunk``, each prompt is prefilled in the pieces of
    ``chunk_schedule`` instead (K1 at M = each piece's length, no flash
    attention; MLA's wkv_b at M = ``max_len``, the batch-1 cache each chunk
    expands) and warmup runs one dummy chunk per distinct length.
    ``hits``: the suffix lengths of the admissions that hit the prefix cache
    (``prompt_lens`` then lists the others), each prefilled as one chunk at
    M = its suffix, with no flash attention.  A recurrent model prefills a
    prompt, a chunk or a hit's suffix of p tokens as p decode steps at M = 1."""
    warm = prompt_lens if warmup_lens is None else warmup_lens
    if chunk is None:
        pieces, warm_pieces = list(prompt_lens), set(warm)
    else:
        pieces = [length for p in prompt_lens for _, length in chunk_schedule(p, chunk)]
        warm_pieces = {length for p in warm for _, length in chunk_schedule(p, chunk)}
    prefills = collections.Counter(pieces) + collections.Counter(warm_pieces)
    recurrent = cfg.family in RECURRENT
    if recurrent:
        steps = sum(m * c for m, c in prefills.items()) + sum(hits)
        runs = [launches_at(cfg, "systolic_mmm", 1, steps, True)]
    else:
        runs = [launches_at(cfg, "systolic_mmm", m, c, chunk is None, kv_rows=max_len, seqs=1)
                for m, c in prefills.items()]
        runs += [launches_at(cfg, "systolic_mmm", m, c, False, kv_rows=max_len, seqs=1)
                 for m, c in collections.Counter(hits).items()]
    runs.append(launches_at(cfg, "systolic_mmm", slots or CONT_SLOTS, decode_steps + 1, False))
    total, shapes = collections.Counter(), {"systolic_mmm": {}, "systolic_qmm": {}, "grouped_mmm": {}}
    for t, by in runs:
        total.update(t)
        for name, sh in by.items():
            for key, c in sh.items():
                shapes[name][key] = shapes[name].get(key, 0) + c
    total = {name: total[name] for name in KERNELS}
    if chunk is not None or recurrent:
        return total, shapes, expected_routes(cfg, shapes, 0), {}
    flash = {(1, m, m): cfg.n_layers * c for m, c in prefills.items()} if cfg.attention != "mla" else {}
    return total, shapes, expected_routes(cfg, shapes, sum(prefills.values())), flash


def check_run_launches(label: str, got: tuple, want: tuple) -> None:
    """Hold a run's (launches per kernel, per GEMM shape, by route, flash by
    (B, Sq, Skv)) against ``continuous_expected``'s."""
    (g_total, g_shapes, g_routes, g_flash), (w_total, w_shapes, w_routes, w_flash) = got, want
    expect(g_total == w_total, f"{label} launches (warmup included): {g_total}, want {w_total}")
    for name, by in g_shapes.items():
        expect(by == w_shapes[name], f"{label} {name} launches by shape: {len(by)} shapes, {sum(by.values())} "
                                     f"launches" + ("" if by == w_shapes[name] else f": {sorted(by.items())}"))
    for key in g_routes:
        expect(g_routes[key] == w_routes[key], f"{label} {key}: {g_routes[key]}, want {w_routes[key]}")
    expect(g_flash == w_flash, f"{label} flash_attn launches by (B, Sq, Skv): {sorted(g_flash.items())}, "
                               f"want {sorted(w_flash.items())}")


def listed(shapes: dict) -> dict:
    """{kernel: [[*shape, launches], ...]} of launch counts by shape."""
    return {name: [[*key, c] for key, c in sorted(by.items())] for name, by in shapes.items() if by}


def replay_alone(model, params, prompt: dict, out, max_len: int) -> list:
    """A request alone at batch 1 on the fp cache: its prefill, then a decode
    step for each of its tokens but the last, fed back; the logits of each."""
    p = prompt["tokens"].shape[1] + prefix_len(model.cfg)
    logits, cache = model.prefill(params, prompt, max_len=max_len)
    replay = [logits]
    for j in range(len(out) - 1):
        tok = torch.as_tensor(out[j:j + 1], dtype=torch.int32, device="cuda").unsqueeze(0)  # (1, 1[, n_codebooks])
        logits, cache = model.decode_step(params, tok, cache=cache, pos=p + j)
        replay.append(logits)
    return replay


def phase_continuous(model, params, smi: str, fp: dict | None = None, chunk: int | None = None,
                     resident: int | None = None, alone: dict | None = None, paged: bool = False,
                     same_as: dict | None = None, n_requests: int | None = None) -> dict:
    """Serve the continuous trace through ContinuousScheduler with the counts
    set to 0 just before the run and read just after; check the lifecycle
    and the launches; then replay each request alone at batch 1 on the fp
    cache (prefill, then decode with the scheduler's tokens fed back) and
    hold the scheduler's prefill and decode-step logits against the
    replay's.  The model's prefill, prefill_chunk and decode_step are
    wrapped here, in the script, to record what the scheduler's engine
    computed.

    With ``fp`` (the fp pool's run of the same trace) the pool is kv8: its
    resident bytes are checked exactly, its launches and decode steps must
    equal the fp run's, and its logits are held at the quantized-vs-fp bound.
    With ``chunk`` the prompts are prefilled in chunks of that length, one a
    tick.  ``resident``: the fp pool's resident bytes, checked exactly.
    ``alone``: the replays of an earlier run of the same model, reused for a
    request whose tokens equal that run's (the replay is the same then).
    With ``paged`` the pool is the paged one (pages of PAGE_SIZE rows;
    ``resident`` is then one page's bytes): after the run it validates,
    holds no page and its null page is still 0 / -1; ``same_as`` (the slot
    pool's run of the same trace) must then give the same tokens and
    bit-identical prefill and decode-step logits.  The output's
    ``logit_rows`` ({rid: {position: logits}}) are for such a comparison.
    ``n_requests``: serve the trace's first n requests only (default: all)."""
    kv8 = fp is not None
    cfg = model.cfg
    label, tol = ("kv8", KV8_VS_FP_TOL) if kv8 else ("continuous", LOGITS_TOL_BF16)
    if cfg.name != ARCH:
        label = f"{cfg.name} {'chunked' if chunk else 'paged' if paged else 'continuous'}"
    trace = continuous_trace(cfg)[:n_requests]
    lens = prompt_positions(cfg, trace)  # a vit prompt's patches included
    gens = [t["max_new_tokens"] for t in trace]
    max_len = max(p + g for p, g in zip(lens, gens))
    say(f"[3] {label} serving of {cfg.name} bf16{' over the int8 (kv8) pool' if kv8 else ''}: {len(trace)} requests "
        f"arriving over {trace[-1]['arrival']:.1f} ticks, prompts {min(lens)}-{max(lens)} (mean "
        f"{sum(lens) / len(lens):.1f}), generations {min(gens)}-{max(gens)} (mean {sum(gens) / len(gens):.1f}), "
        f"{CONT_SLOTS} slots, max_len {max_len}" + (f", prefill in chunks of {chunk} (one a tick)" if chunk else ""))
    rid_of = {id(t["prompt"]): t["rid"] for t in trace}
    first_logits, steps, sched = {}, [], None

    def prefill(p, batch, max_len):
        logits, cache = model.prefill(p, batch, max_len=max_len)
        if id(batch) in rid_of:  # warmup's call comes first; the admission's overwrites it
            first_logits[rid_of[id(batch)]] = logits.clone()
        return logits, cache

    def prefill_chunk(p, batch, cache, offset, wrapped):
        logits, cache = model.prefill_chunk(p, batch, cache=cache, offset=offset, wrapped=wrapped)
        req = sched._prefilling[0] if sched._prefilling else None  # None in warmup
        if req is not None and offset + batch["tokens"].shape[1] == req.prompt_len:
            first_logits[req.rid] = logits.clone()
        return logits, cache

    def decode_step(p, tok, cache, pos):
        logits, cache = model.decode_step(p, tok, cache=cache, pos=pos)
        rids = {slot: r.rid for slot, r in sched._slot_req.items()}
        if rids:  # warmup's all-empty step serves no request
            steps.append((sched.pool.positions.copy(), logits.clone(), rids))  # the host's copy of pos
        return logits, cache

    recorded = dataclasses.replace(model, prefill=prefill, prefill_chunk=prefill_chunk, decode_step=decode_step)
    engine = ServeEngine(recorded, params, ServeConfig(max_len=max_len, batch=CONT_SLOTS), device="cuda")
    sched = ContinuousScheduler(engine, policy="continuous", quantize_kv=kv8, chunked_prefill=chunk is not None,
                                chunk_size=chunk or 128, paged=paged, page_size=PAGE_SIZE)
    if resident is not None and paged:
        expect(sched.pool.page_bytes() == resident and sched.pool.pages_per_slot * PAGE_SIZE > max_len,
               f"{label} pool: one page {sched.pool.page_bytes():,} bytes (want {resident:,}), "
               f"{sched.pool.pages_per_slot} pages of {PAGE_SIZE} a slot for {max_len} rows")
    elif resident is not None:
        expect(sched.pool.bytes_resident() == resident,
               f"{label} pool resident bytes {sched.pool.bytes_resident():,} (want {resident:,})")
    if kv8:
        leaves = list(tree_util.leaves(sched.pool._qcache))
        dtypes = sorted({str(t.dtype)[6:] for t in leaves})
        expect(sched.pool.bytes_resident() == KV8_BYTES and dtypes == ["float32", "int32", "int8"],
               f"kv8 pool resident bytes {sched.pool.bytes_resident():,} (want {KV8_BYTES:,}; the fp pool "
               f"{fp['summary']['kv_bytes_resident']:,}), held as {dtypes}")
    reqs = requests_from_trace(trace)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    results = sched.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = (counts(), shape_counts(), route_counts(), flash_shape_counts())
    st = sched.stats.summary()

    # Lifecycle.
    expect(all(r.state == FINISHED and len(results[r.rid]) == r.max_new_tokens for r in reqs),
           f"{label}: all {len(reqs)} requests finished with exactly max_new_tokens tokens "
           f"({st['tokens_out']} tokens, want {sum(gens)})")
    expect(sched.pool.n_free == CONT_SLOTS and (sched.pool.positions == -1).all(),
           f"{label}: the pool drained ({sched.pool.n_free} of {CONT_SLOTS} slots free)")
    if paged:
        errs = sched.pool.validate()
        expect(errs == [] and sched.pool.pages_in_use == 0 and null_page_intact(sched.pool),
               f"{label}: validate() {errs or '[]'}, {sched.pool.pages_in_use} pages in use after the drain, "
               f"the null page still 0 / -1")
    rids_by_slot = collections.defaultdict(set)
    for _, _, rids in steps:
        for slot, rid in rids.items():
            rids_by_slot[slot].add(rid)
    admitted = int(sched.stats.registry.counter_value("sched.admitted"))
    reused = sum(len(v) > 1 for v in rids_by_slot.values())
    expect(admitted == len(reqs) > CONT_SLOTS and reused > 0,
           f"{label}: {admitted} admissions into {CONT_SLOTS} slots, {reused} slots served more than one request")
    ragged = sum(len({int(pos[s]) for s in rids}) > 1 for pos, _, rids in steps)
    expect(ragged > 0, f"{label}: {ragged} of {len(steps)} decode ticks decoded slots at different positions")

    # Launches: exact per kernel, GEMM shape and path, flash shape and heads.
    if kv8:
        expect(st["decode_steps"] == fp["summary"]["decode_steps"] and st["ticks"] == fp["summary"]["ticks"],
               f"kv8: {st['ticks']} ticks and {st['decode_steps']} decode steps, as the fp pool's run "
               f"({fp['summary']['ticks']}, {fp['summary']['decode_steps']})")
    if chunk:
        want_chunks = sum(len(chunk_schedule(p, chunk)) for p in lens)
        expect(st["prefill_chunks"] == want_chunks, f"{label}: {st['prefill_chunks']} prefill chunks, want {want_chunks}")
    check_run_launches(label, got, continuous_expected(cfg, lens, st["decode_steps"], chunk=chunk, max_len=max_len))

    # Each request alone at batch 1 on the fp cache, the scheduler's tokens fed back.
    pf_err, dec_err, same, rows_seen = 0.0, 0.0, 0, 0
    replays = {}  # (rid, tokens) -> the replay's logits: prefill, then each decode step
    logit_rows = {}
    with torch.no_grad():
        for t, r in zip(trace, reqs):
            out, p = results[r.rid], lens[r.rid]
            rows = {int(pos[s]): logits[s:s + 1] for pos, logits, rids in steps for s, rid in rids.items()
                    if rid == r.rid}
            logit_rows[r.rid] = {p - 1: first_logits[r.rid], **rows}
            key = (r.rid, tuple(int(x) for x in out))
            replay = (alone or {}).get(key)
            if replay is None:
                replay = replay_alone(model, params, t["prompt"], out, max_len)
            replays[key] = replay
            errs = [(replay[0] - first_logits[r.rid]).abs().max().item() / max(1.0, replay[0].abs().max().item())]
            argmax = [int(replay[0].argmax())]
            taken = [int(first_logits[r.rid].argmax())]
            for j in range(len(out) - 1):
                row = rows[p + j]
                errs.append((replay[j + 1] - row).abs().max().item() / max(1.0, replay[j + 1].abs().max().item()))
                argmax.append(int(replay[j + 1].argmax()))
                taken.append(int(row.argmax()))
            rows_seen += len(rows)
            pf_err, dec_err = max(pf_err, errs[0]), max([dec_err, *errs[1:]])
            same += argmax == [int(x) for x in out]
            expect(len(rows) == len(out) - 1 and taken == [int(x) for x in out] and max(errs) <= tol,
                   f"{label} request {r.rid} (prompt {p}, {len(out)} tokens, slot ticks {len(rows)}): logits vs "
                   f"alone at batch 1 on the fp cache, largest error {max(errs):.2%} of the largest logit (tol "
                   f"{tol:.0%}); its tokens are the argmax of its own logits")
    say(f"    {label} vs alone: prefill logits within {pf_err:.2%}, decode-step rows within {dec_err:.2%} of the "
        f"largest logit over {rows_seen} rows; {same} of {len(reqs)} requests' greedy tokens equal their isolated "
        f"generate() exactly (bf16 near-ties may flip; for information only)")
    if same_as is not None:
        want_rows = same_as["logit_rows"]
        differ = [rid for rid in want_rows if list(want_rows[rid]) != list(logit_rows[rid])
                  or not all(torch.equal(logit_rows[rid][k], v) for k, v in want_rows[rid].items())]
        tokens_same = all(results[r.rid].tolist() == same_as["tokens"][r.rid] for r in reqs)
        expect(tokens_same and not differ and st["ticks"] == same_as["summary"]["ticks"],
               f"{label} vs the slot pool's run: tokens equal, prefill and decode-step logits bit-identical over "
               f"{sum(len(v) for v in logit_rows.values())} rows (differing requests: {differ}), "
               f"{st['ticks']} ticks")
    say(f"    {label} numbers ({smi}): {len(reqs)} requests, {st['ticks']} ticks ({st['idle_ticks']} idle), "
        f"{st['decode_steps']} decode steps, {st['tokens_out']} tokens; {st['tok_per_s']} tok/s; step p50 "
        f"{st['p50_step_ms']} / p99 {st['p99_step_ms']} ms; tick p50 {st['p50_tick_ms']} / p99 {st['p99_tick_ms']} ms; "
        f"TTFT p50 {st['ttft_p50_ms']} / p99 {st['ttft_p99_ms']} ms; mean occupancy {st['mean_occupancy']}; "
        f"kv_bytes_resident {st['kv_bytes_resident']}; prefill {st['prefill_s']} s + decode {st['decode_s']} s; "
        f"run wall {st['run_wall_s']} s ({wall:.3f} s with warmup)")
    out = {"arch": cfg.name, "summary": st, "wall_s_with_warmup": wall, "prompt_lens": lens, "max_new_tokens": gens,
           "launches": got[0], "shapes": listed(got[1]),
           "routes": {k: {str(kk): c for kk, c in v.items()} for k, v in got[2].items()},
           "flash_shapes": [[*key, c] for key, c in sorted(got[3].items())],
           "prefill_logits_max_share": pf_err, "decode_logits_max_share": dec_err,
           "requests_tokens_equal_alone": same, "replays": replays, "logit_rows": logit_rows,
           "tokens": {rid: toks.tolist() for rid, toks in results.items()}}
    if kv8:
        say(f"    kv8 decode step p50 {st['p50_step_ms']} ms beside the fp pool's {fp['summary']['p50_step_ms']} ms "
            f"(same call): the pool is dequantized before and re-quantized after every step")
        out["payload"] = kv8_payload(model, params, trace[0], max_len)
        out["step_kernels"] = {name: decode_step_profile(model, params, max_len, q)["device_kernels"]
                               for name, q in (("fp", False), ("kv8", True))}
        say(f"    device kernels of one decode step over {CONT_SLOTS} slots: fp pool "
            f"{out['step_kernels']['fp']}, kv8 pool {out['step_kernels']['kv8']} "
            f"(+{out['step_kernels']['kv8'] - out['step_kernels']['fp']})")
    del engine, sched, steps, first_logits
    return out


def kv8_payload(model, params, request: dict, max_len: int) -> dict:
    """The reference's kv8 payload gate: one prompt prefilled, scattered into
    an fp and a kv8 pool, one decode step on each from the same token; the
    kv8 pool's dequantized K of the live slot against the fp pool's, every
    layer, within KV8_K_TOL x max|K|."""
    engine = ServeEngine(model, params, ServeConfig(max_len=max_len, batch=CONT_SLOTS), device="cuda")
    first, cache_one = engine.prefill_request(request["prompt"])
    n = request["prompt"]["tokens"].shape[1]
    pools = [KVPool(model, CONT_SLOTS, max_len, quantize_kv_cache=q, device="cuda") for q in (False, True)]
    for pool in pools:
        pool.write_prefill(pool.alloc(), cache_one, n)
    toks = first.repeat(CONT_SLOTS, 1)
    caches = []
    for pool in pools:
        _, pool.cache = engine.decode_slots(toks, pool.cache, pool.pos_vector())
        caches.append(pool.cache)
    err, scale = 0.0, 0.0
    for l_fp, l_q in zip(caches[0]["layers"], caches[1]["layers"]):
        err = max(err, (l_fp["k"][0] - l_q["k"][0]).abs().max().item())
        scale = max(scale, l_fp["k"][0].abs().max().item())
    expect(err < KV8_K_TOL * scale, f"kv8 K of the live slot after one decode step vs the fp pool's, every layer: "
                                    f"max_abs={err:.4e} (bound {KV8_K_TOL} x max|K| = {KV8_K_TOL * scale:.4e})")
    return {"k_max_abs_err": err, "k_max_abs": scale}


def decode_step_profile(model, params, max_len: int, quantize_kv: bool, slots: int = CONT_SLOTS,
                        paged: dict | None = None) -> dict:
    """One decode step over an empty pool of ``slots`` slots, traced
    (torch.profiler): its host wall, device busy time, idle share and device
    kernels (``launch/trace.py``'s phase row), the pool's dequantize and
    re-quantize included; with ``paged`` (PagedKVPool options) over the
    paged pool, its page gather and scatter included.  Empty slots cost the
    plain decode attention what live ones do (it scores every row and masks)."""
    engine = ServeEngine(model, params, ServeConfig(max_len=max_len, batch=slots), device="cuda")
    if paged:
        pool = PagedKVPool(model, slots, max_len, quantize_kv_cache=quantize_kv, device="cuda", **paged)
    else:
        pool = KVPool(model, slots, max_len, quantize_kv_cache=quantize_kv, device="cuda")
    tail = (model.cfg.n_codebooks,) if model.cfg.frontend == "audio_codec" else ()
    tok = torch.zeros((slots, 1, *tail), dtype=torch.int32, device="cuda")
    _, pool.cache = engine.decode_slots(tok, pool.cache, pool.pos_vector())  # first launches outside the trace
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("decode_step"):
            out, pool.cache = engine.decode_slots(tok, pool.cache, pool.pos_vector())
            out.cpu()
            torch.cuda.synchronize()
    (row,) = trace_tools.phase_breakdown(prof.events())
    return row


def null_page_intact(pool) -> bool:
    """The (fp) paged pool's null page holds floats 0 and positions -1 in
    every arena tensor."""
    return all(bool((t[-1] == (-1 if name == "pos" else 0)).all())
               for layer in pool.phys["layers"] for name, t in layer.items())


def long_prompt_run(model, params, chunked: bool, smi: str, turn: int) -> dict:
    """Serve the long-prompt trace through ContinuousScheduler, prefilling
    monolithically or in chunks of LONG_CHUNK, with the counts set to 0 just
    before the run and read just after; check the lifecycle and the launches
    and record each request's last-prompt-position logits (the model's
    prefill / prefill_chunk are wrapped here, in the script)."""
    cfg = model.cfg
    trace = make_adversarial_trace(cfg, device="cuda", **LONG_TRACE)
    lens = [t["prompt"]["tokens"].shape[1] for t in trace]
    gens = [t["max_new_tokens"] for t in trace]
    max_len = max(p + g for p, g in zip(lens, gens))
    label = f"long-prompt {'chunked' if chunked else 'monolithic'} #{turn}"
    rid_of = {id(t["prompt"]): t["rid"] for t in trace}
    last_logits, sched = {}, None

    def prefill(p, batch, max_len):
        logits, cache = model.prefill(p, batch, max_len=max_len)
        if id(batch) in rid_of:  # warmup's call comes first; the admission's overwrites it
            last_logits[rid_of[id(batch)]] = logits.clone()
        return logits, cache

    def prefill_chunk(p, batch, cache, offset, wrapped):
        logits, cache = model.prefill_chunk(p, batch, cache=cache, offset=offset, wrapped=wrapped)
        req = sched._prefilling[0] if sched._prefilling else None  # None in warmup
        if req is not None and offset + batch["tokens"].shape[1] == req.prompt_len:
            last_logits[req.rid] = logits.clone()
        return logits, cache

    recorded = dataclasses.replace(model, prefill=prefill, prefill_chunk=prefill_chunk)
    engine = ServeEngine(recorded, params, ServeConfig(max_len=max_len, batch=LONG_SLOTS), device="cuda")
    sched = ContinuousScheduler(engine, chunked_prefill=chunked, chunk_size=LONG_CHUNK)
    reqs = requests_from_trace(trace)
    long_req = reqs[-1]
    first_tick, ticks = [], []  # ticks: (tick, latency in s) of each tick that decoded

    def on_tick(s):
        if long_req.out and not first_tick:
            first_tick.append(s.tick)  # the tick that gave the long request its first token, + 1
        lat = s.stats.tick_latency_s
        if len(lat) > len(ticks):
            ticks.append((s.tick - 1, lat[-1]))

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    results = sched.run(reqs, on_tick=on_tick)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = (counts(), shape_counts(), route_counts(), flash_shape_counts())
    st = sched.stats.summary()
    want_chunks = sum(len(chunk_schedule(p, LONG_CHUNK)) for p in lens) if chunked else 0
    expect(all(r.state == FINISHED and len(results[r.rid]) == r.max_new_tokens for r in reqs)
           and st["tokens_out"] == sum(gens) and sched.pool.n_free == LONG_SLOTS and (sched.pool.positions == -1).all(),
           f"{label}: all {len(reqs)} requests finished, {st['tokens_out']} tokens (want {sum(gens)}), the pool "
           f"drained")
    expect(st["prefill_chunks"] == want_chunks, f"{label}: {st['prefill_chunks']} prefill chunks, want {want_chunks}")
    check_run_launches(label, got, continuous_expected(cfg, lens, st["decode_steps"], LONG_SLOTS,
                                                       LONG_CHUNK if chunked else None))
    expect(sorted(last_logits) == [r.rid for r in reqs] and all(bool(torch.isfinite(v).all())
                                                                for v in last_logits.values()),
           f"{label}: finite last-prompt-position logits of all {len(reqs)} requests recorded")
    ttft_ticks = first_tick[0] - long_req.admitted_tick
    ttft_ms = (long_req.first_token_s - long_req.admitted_s) * 1e3
    # The ticks in which the long prompt was prefilled (monolithic: its
    # admission tick; chunked: one per chunk), and tick 0, which admits the
    # four short prompts.
    during = max(lat for t, lat in ticks if long_req.admitted_tick <= t < first_tick[0]) * 1e3
    tick0 = ticks[0][1] * 1e3 if ticks and ticks[0][0] == 0 else float("nan")
    say(f"    {label} ({smi}): {st['ticks']} ticks ({st['idle_ticks']} idle), {st['decode_steps']} decode steps, "
        f"{st['prefill_chunks']} prefill chunks, {st['tokens_out']} tokens; {st['tok_per_s']} tok/s; tick p50 "
        f"{st['p50_tick_ms']} / p99 {st['p99_tick_ms']} ms; step p50 {st['p50_step_ms']} / p99 {st['p99_step_ms']} "
        f"ms; the long request's TTFT {ttft_ms:.3f} ms over {ttft_ticks} ticks, its prefill ticks at most "
        f"{during:.3f} ms; tick 0 {tick0:.3f} ms; prefill {st['prefill_s']} s + decode {st['decode_s']} s; run wall "
        f"{st['run_wall_s']} s ({wall:.3f} s with warmup)")
    out = {"chunked": chunked, "summary": st, "wall_s_with_warmup": wall, "long_ttft_ms": ttft_ms,
           "long_ttft_ticks": ttft_ticks, "long_prefill_tick_max_ms": during, "tick0_ms": tick0,
           "tick_ms": [[t, lat * 1e3] for t, lat in ticks], "launches": got[0], "shapes": listed(got[1]),
           "routes": {k: {str(kk): c for kk, c in v.items()} for k, v in got[2].items()},
           "flash_shapes": [[*key, c] for key, c in sorted(got[3].items())],
           "tokens": {rid: toks.tolist() for rid, toks in results.items()}, "last_logits": last_logits}
    del engine, sched
    torch.cuda.empty_cache()
    return out


def obs_run(model, params, trace: list[dict], max_len: int, on: bool) -> dict:
    """One continuous run of ``trace`` with the counts set to 0 just before
    and read just after: with telemetry off (``obs.disabled()``), or on with
    every K1 call in a sampled window (``obs.sampling(1.0)``), the registry
    and the tracer cleared first.  The engine's decode_totals are read after
    every tick that decoded."""
    engine = ServeEngine(model, params, ServeConfig(max_len=max_len, batch=CONT_SLOTS), device="cuda")
    sched = ContinuousScheduler(engine, policy="continuous")
    totals = []

    def on_tick(sc) -> None:
        if sc.stats.decode_steps > len(totals):
            totals.append((sc.engine.decode_totals.flops, sc.engine.decode_totals.calls))

    obs_metrics.reset()
    obs_trace.get_tracer().clear()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with obs.sampling(1.0) if on else obs.disabled():
        results = sched.run(requests_from_trace(trace), on_tick=on_tick)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = (counts(), shape_counts(), route_counts(), flash_shape_counts())
    return {"arch": model.cfg.name, "engine": engine, "sched": sched, "totals": totals, "wall_s": wall,
            "summary": sched.stats.summary(), "got": got, "launches": got[0], "shapes": listed(got[1]),
            "flash_shapes": [[*key, c] for key, c in sorted(got[3].items())],
            "tokens": {rid: toks.tolist() for rid, toks in results.items()}}


@contextlib.contextmanager
def telemetry(on: bool):
    """Telemetry set on or off for the scope, whatever REPRO_OBS says, and
    restored after it."""
    prev = obs.enabled()
    obs.enable(on)
    try:
        yield
    finally:
        obs.enable(prev)


def decode_ms_on_off(model, params, batch) -> dict:
    """Untraced synchronized decode ms/step of the BATCH x PROMPT batch with
    telemetry off and on (the sampler off), OBS_BLOCKS blocks of OBS_STEPS
    steps alternating off, on, on, off; each step synchronized; with each
    arm's K1 launches and the launches it recorded (``gemm.calls``)."""
    engine = ServeEngine(model, params, ServeConfig(max_len=PROMPT + OBS_BLOCKS * OBS_STEPS + 4, batch=BATCH),
                         device="cuda")
    tok = engine.decode(engine.prefill(batch), 2)[:, -1:]  # warm-up
    torch.cuda.synchronize()
    ms = {"off": [], "on": []}
    recorded, launched = {"off": 0.0, "on": 0.0}, {"off": 0, "on": 0}
    reg = obs_metrics.get_registry()
    for arm in ("off", "on", "on", "off")[:OBS_BLOCKS]:
        before, k1 = reg.counter_value("gemm.calls", backend="cuda-systolic", dtype="bfloat16"), mm_kernel.launches
        with telemetry(arm == "on"):
            for _ in range(OBS_STEPS):
                t0 = time.perf_counter()
                tok = engine.decode(tok, 1)
                torch.cuda.synchronize()
                ms[arm].append((time.perf_counter() - t0) * 1e3)
        recorded[arm] += reg.counter_value("gemm.calls", backend="cuda-systolic", dtype="bfloat16") - before
        launched[arm] += mm_kernel.launches - k1
    del engine
    return {**ms, "recorded": recorded, "launched": launched}


def run_doctor(mdir: str, *extra: str) -> subprocess.Popen:
    """``python -m repro_torch.obs doctor <mdir> --json`` in a process of its own."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.Popen([sys.executable, "-m", "repro_torch.obs", "doctor", mdir, "--json", *extra], cwd=ROOT,
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def phase_obs(model, params, batch, smi: str) -> dict:
    """Observability on the bf16 model's parameters, the plan cache pinned
    empty: the continuous trace's first OBS_REQUESTS requests served twice,
    telemetry off and on (every K1 call in a sampled window): tokens bit
    for bit and launches equal between the two and exact; every K1 launch
    recorded, decode_totals exactly one step's GEMM work from the first tick
    to the last, one decode MFU and residual reading a decode tick, one
    window a K1 call; the drift probe (its launches counted apart), a stale
    plan injected and flagged; the doctor on the run's metrics, exit 0 and
    1; decode ms/step with telemetry off and on."""
    t_phase = time.perf_counter()
    cfg = model.cfg
    trace = continuous_trace(cfg)[:OBS_REQUESTS]
    lens = prompt_positions(cfg, trace)
    max_len = max(p + t["max_new_tokens"] for p, t in zip(lens, trace))
    say(f"[3] obs: {len(trace)} requests of the continuous trace over {CONT_SLOTS} slots, telemetry off then on "
        f"(sampling rate 1.0), the drift probe and the doctor")
    off = obs_run(model, params, trace, max_len, on=False)
    on = obs_run(model, params, trace, max_len, on=True)
    st = on["summary"]
    expect(on["tokens"] == off["tokens"] and st["ticks"] == off["summary"]["ticks"],
           f"obs: tokens bit-identical with telemetry and windows on and off ({st['tokens_out']} tokens, "
           f"{st['ticks']} ticks)")
    expect(on["launches"] == off["launches"] and on["got"][1] == off["got"][1] and on["got"][3] == off["got"][3],
           f"obs: launches equal on and off, by kernel, GEMM shape and flash shape ({on['launches']}; windows add "
           f"none)")
    check_run_launches("obs", on["got"], continuous_expected(cfg, lens, st["decode_steps"]))

    # Every K1 launch recorded; decode_totals one step's work, from the first tick to the last.
    snap = obs_metrics.get_registry().snapshot()
    c = snap["counters"]
    k1 = on["launches"]["systolic_mmm"]
    recorded = c.get('gemm.calls{backend="cuda-systolic",dtype="bfloat16"}', 0.0)
    misses = c.get('tune.plan.miss{backend="cuda-systolic"}', 0.0)
    expect(recorded == k1 == misses and c.get('tune.plan.hit{backend="cuda-systolic"}', 0.0) == 0,
           f"obs: every K1 launch recorded: gemm.calls {recorded:.0f}, launches {k1}, plan misses {misses:.0f} "
           f"(an empty cache: the rule's tiles)")
    per_layer = sum(cnt * k * n for (k, n), cnt in projections(cfg).items())
    want = (2.0 * CONT_SLOTS * cfg.n_layers * per_layer, cfg.n_layers * sum(projections(cfg).values()))
    got_totals = (on["engine"].decode_totals.flops, on["engine"].decode_totals.calls)
    expect(got_totals == want and on["totals"][0] == on["totals"][-1] == want and len(on["totals"]) ==
           st["decode_steps"],
           f"obs: decode_totals {got_totals[0]:.0f} flops, {got_totals[1]} GEMMs = 2 x {CONT_SLOTS} x "
           f"{cfg.n_layers} x {per_layer} (want {want}), the same after tick 1 and after the last of "
           f"{len(on['totals'])} decode ticks")
    mfu_h = on["sched"].stats.registry.snapshot()["histograms"]["serve.decode_mfu"]
    resid_h = on["sched"].stats.registry.snapshot()["histograms"]["serve.model_residual"]
    expect(mfu_h["count"] == resid_h["count"] == st["decode_steps"] and 0 < mfu_h["min"] <= mfu_h["max"] <= 1
           and resid_h["min"] > 0,
           f"obs: serve.decode_mfu {mfu_h['count']} readings over {st['decode_steps']} decode ticks, in "
           f"[{mfu_h['min']:.6f}, {mfu_h['max']:.6f}]; serve.model_residual {resid_h['count']} readings")
    windows = sum(h["count"] for series, h in snap["histograms"].items()
                  if obs.parse_series(series)[0] == "profile.gemm_us")
    expect(windows == k1, f"obs: profile.gemm_us holds {windows} samples, one per K1 call ({k1})")
    expect(off["engine"].decode_totals.calls == 0 and not off["sched"].stats.registry.histogram(
        "serve.decode_mfu").count, "obs: with telemetry off nothing is recorded")
    say(f"    obs numbers ({smi}): decode MFU mean {mfu_h['mean']:.6f} (of the card's bf16 datasheet peak, "
        f"{mfu_h['min']:.6f}-{mfu_h['max']:.6f}), model residual mean {resid_h['mean']:.4f}x the roofline "
        f"({resid_h['min']:.4f}-{resid_h['max']:.4f}); step p50 off {off['summary']['p50_step_ms']} / on with "
        f"every K1 call windowed {st['p50_step_ms']} ms; run wall off {off['wall_s']:.3f} / on {on['wall_s']:.3f} s")

    # The drift probe, its launches apart; a stale plan injected.
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    rows = obs_drift.probe_decode_plans(on["engine"])
    torch.cuda.synchronize()
    probe_s, probe_launches = time.perf_counter() - t0, counts()
    reset_counts()
    problems = decode_gemm_problems(cfg, CONT_SLOTS)
    expect(len(rows) == len(problems) and all("mean_us" in r and r["method"] == "cuda-events" for r in rows),
           f"obs: drift probe {len(rows)} rows for {len(problems)} decode GEMMs, none failed "
           f"({[r['error'] for r in rows if 'error' in r]}); its own launches {probe_launches}, counted apart")
    for r in rows:
        if "mean_us" in r:
            say(f"      probe {r['name']:8s} {r['problem']:14s} on {r['path']:7s} {r['mean_us']:9.3f} us "
                f"(best {r['best_us']:.3f}) [{r['method']}], model {r['model_us']:.3f} us")
    snap = obs_metrics.snapshot_doc(obs_metrics.get_registry(), on["sched"].stats.registry, extra=st)
    mdir = tempfile.mkdtemp(prefix="chip_smoke_obs_", dir=TUNE_DIR)
    with open(os.path.join(mdir, "snapshot.json"), "w") as f:
        json.dump(snap, f)
    obs_trace.get_tracer().export_chrome(os.path.join(mdir, "trace.json"))
    row = next((r for r in rows if r["name"] == OBS_STALE_GEMM and "mean_us" in r), None)
    stale_path = os.path.join(mdir, "stale_plans.json")
    stale_key = None
    if row is not None:
        m, n, k = (int(x) for x in row["problem"].split("x"))
        stale_key = tune_cache.CacheKey("cuda-systolic", "h100", m, n, k, cfg.dtype)
        tune_cache.PlanCache(stale_path).store(stale_key, tune_cache.TunedPlan(
            *row["blocks"], mean_us=OBS_STALE * row["mean_us"], best_us=OBS_STALE * row["mean_us"],
            method="cuda-events"))
        flagged = [f.key for f in obs_drift.check_drift(snap, cache=tune_cache.PlanCache(stale_path)) if f.stale]
        expect(flagged == [stale_key.encode()],
               f"obs: check_drift flags exactly the injected plan ({OBS_STALE}x {OBS_STALE_GEMM}'s probe reading): "
               f"{flagged}")
    healthy, stale = run_doctor(mdir), run_doctor(mdir, "--tune-cache", stale_path)
    (h_out, h_err), (s_out, s_err) = healthy.communicate(timeout=300), stale.communicate(timeout=300)
    report = json.loads(h_out) if healthy.returncode == 0 else {}
    errs = obs_doctor.validate_doctor_report(report)
    expect(healthy.returncode == 0 and not errs and report["coverage"] >= 0.9,
           f"obs: python -m repro_torch.obs doctor exit {healthy.returncode} (want 0), report valid ({errs or 'yes'}), "
           f"coverage {report.get('coverage', 0):.3f} of the run's wall (>= 0.9) {h_err[-300:]}")
    stale_report = json.loads(s_out) if s_out.strip().startswith("{") else {}
    expect(stale.returncode == 1 and [p["key"] for p in stale_report.get("stale_plans", [])] ==
           [stale_key and stale_key.encode()],
           f"obs: doctor with the injected plan exit {stale.returncode} (want 1), stale "
           f"{[p['key'] for p in stale_report.get('stale_plans', [])]} {s_err[-300:]}")
    for r in report.get("top_sinks", [])[:6]:
        say(f"      doctor sink {r['component']:44s} {r['seconds']:.4f} s")
    ms = decode_ms_on_off(model, params, batch)
    expect(ms["recorded"]["off"] == 0 and ms["recorded"]["on"] == ms["launched"]["on"] > 0,
           f"obs: decode ms/step arms: telemetry on recorded {ms['recorded']['on']:.0f} of its "
           f"{ms['launched']['on']} K1 launches, off {ms['recorded']['off']:.0f} of {ms['launched']['off']}")
    say(f"    untraced decode ms/step ({smi}), sampler off, alternated off on on off: telemetry off "
        f"{[round(x, 3) for x in ms['off']]}, on {[round(x, 3) for x in ms['on']]} (median off "
        f"{statistics.median(ms['off']):.3f}, on {statistics.median(ms['on']):.3f})")
    wall = time.perf_counter() - t_phase
    say(f"    obs phase wall {wall:.1f} s")
    runs = [{key: r[key] for key in ("arch", "launches", "shapes", "flash_shapes", "summary", "wall_s", "totals")}
            for r in (off, on)]
    out = {"runs": runs, "decode_mfu": mfu_h, "model_residual": resid_h, "windows": windows, "recorded": recorded,
           "decode_totals": list(got_totals), "probe": rows, "probe_s": probe_s, "probe_launches": probe_launches,
           "doctor": {"exit": healthy.returncode, "stale_exit": stale.returncode, "coverage": report.get("coverage"),
                      "top_sinks": report.get("top_sinks")},
           "decode_ms": ms, "wall_s": wall}
    del off, on
    return out


def phase_long_prompt(model, params, smi: str) -> list[dict]:
    """The long-prompt trace monolithic (A) and then chunked (B) in one call,
    so the host's spread between calls cannot decide the comparison; the
    chunked run's last-prompt-position logits held against the monolithic
    run's."""
    t = LONG_TRACE
    say(f"[3] long-prompt serving of {ARCH} bf16: {t['n_short']} requests of {t['short_prompt']} tokens decoding "
        f"{t['short_gen']} from tick 0, one of {t['long_prompt']} arriving at tick {t['long_arrival']} for "
        f"{t['long_gen']}; {LONG_SLOTS} slots; monolithic, then chunks of {LONG_CHUNK}")
    runs = []
    for turn in (1,):
        mono = long_prompt_run(model, params, False, smi, turn)
        chunked = long_prompt_run(model, params, True, smi, turn)
        worst = 0.0
        for rid, want in mono["last_logits"].items():
            got = chunked["last_logits"][rid]
            err = (got - want).abs().max().item() / max(1.0, want.abs().max().item())
            worst = max(worst, err)
        same = sum(mono["tokens"][rid] == chunked["tokens"][rid] for rid in mono["tokens"])
        expect(worst <= LOGITS_TOL_BF16,
               f"long-prompt #{turn}: each request's last-prompt-position logits, chunked (plain attention over the "
               f"cache) vs monolithic (flash kernel), largest error {worst:.2%} of the largest logit (tol "
               f"{LOGITS_TOL_BF16:.0%}); {same} of {len(mono['tokens'])} requests' greedy tokens identical "
               f"(bf16 near-ties may flip; for information only)")
        for r in (mono, chunked):
            r["vs_monolithic_max_share"] = worst
            del r["last_logits"]
        runs += [mono, chunked]
    return runs


def paged_arm(model, params, name: str, smi: str, stripe: dict | None) -> dict:
    """One arm of the paged phase: the shared-prefix trace through
    ContinuousScheduler with PAGED_ARMS[name]'s options, the counts set to 0
    just before the run and read just after.  Gates: PAGED_ARMS's exact
    counts, the peak pages in use (sampled after every tick through
    ``run(on_tick=)``) and the bytes they reserve, the lifecycle, the pool
    after the drain (``validate()``, only the prefix cache's pages held, the
    null page 0 / -1), exact launches (K1 at each miss's whole prompt, each
    hit's suffix and the decode step; K3 at each miss), and each request's
    tokens the argmax of its own logits.  Against ``stripe`` (the slot
    pool's arm, the oracle): the paged pool's tokens equal and its logits
    bit-identical; with the prefix cache each request's logits within
    LOGITS_TOL_BF16 of the largest logit -- row by row while its tokens agree
    with the stripe arm's, and against the request alone at batch 1 with its
    own tokens fed back once they part (a hit prefills its suffix through
    the plain chunk attention, not K3) -- and a miss's first-token logits
    bit-identical (the same batch-1 prefill).  The model's prefill,
    prefill_chunk and decode_step are wrapped here, in the script, to record
    each request's logits by position; a re-admission starts its record
    afresh."""
    kw, gates = PAGED_ARMS[name]
    cfg = model.cfg
    trace = make_shared_prefix_trace(cfg, device="cuda", **PAGED_TRACE)
    label = f"paged arm {name}"
    rows, hit_rids, miss_lens, hit_lens, sched = {}, set(), [], [], None

    def prefill(p, batch, max_len):
        logits, cache = model.prefill(p, batch, max_len=max_len)
        rid = obs_trace.current_request()  # None in warmup
        if rid is not None:
            rows[rid] = {batch["tokens"].shape[1] - 1: logits[0, -1].clone()}
            hit_rids.discard(rid)
            miss_lens.append(batch["tokens"].shape[1])
        return logits, cache

    def prefill_chunk(p, batch, cache, offset, wrapped):
        logits, cache = model.prefill_chunk(p, batch, cache=cache, offset=offset, wrapped=wrapped)
        rid = obs_trace.current_request()  # a prefix hit's suffix (prefill is monolithic here)
        if rid is not None:
            rows[rid] = {offset + batch["tokens"].shape[1] - 1: logits[0, -1].clone()}
            hit_rids.add(rid)
            hit_lens.append(batch["tokens"].shape[1])
        return logits, cache

    def decode_step(p, tok, cache, pos):
        logits, cache = model.decode_step(p, tok, cache=cache, pos=pos)
        if sched._slot_req:  # warmup's all-empty step serves no request
            last = logits[:, -1].clone()
            for slot, r in sched._slot_req.items():
                rows[r.rid][int(sched.pool.positions[slot])] = last[slot]
        return logits, cache

    recorded = dataclasses.replace(model, prefill=prefill, prefill_chunk=prefill_chunk, decode_step=decode_step)
    engine = ServeEngine(recorded, params, ServeConfig(max_len=PAGED_MAX_LEN, batch=PAGED_SLOTS), device="cuda")
    sched = ContinuousScheduler(engine, **kw)
    pool = sched.pool
    reqs = requests_from_trace(trace)
    peak = {"pages": 0, "reserved": 0, "live": 0}

    def on_tick(s):
        rep = s.pool.bytes_report()
        peak["pages"] = max(peak["pages"], s.pool.pages_in_use if s.paged else 0)
        peak["reserved"] = max(peak["reserved"], rep["reserved"])
        peak["live"] = max(peak["live"], rep["live"])

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    results = sched.run(reqs, on_tick=on_tick)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = (counts(), shape_counts(), route_counts(), flash_shape_counts())
    st = sched.stats.summary()
    tokens = {r.rid: [int(x) for x in results[r.rid]] for r in reqs}

    # Counts, pages, bytes, the lifecycle and the pool after the drain.
    counted = {key: st[key] for key in gates if key != "peak_pages"}
    want = {key: v for key, v in gates.items() if key != "peak_pages"}
    expect(counted == want, f"{label}: {counted} (want {want})")
    expect(all(r.state == FINISHED and len(tokens[r.rid]) == r.max_new_tokens for r in reqs)
           and pool.n_free == PAGED_SLOTS and (pool.positions == -1).all(),
           f"{label}: all {len(reqs)} requests finished with exactly max_new_tokens tokens, the slots drained")
    if sched.paged:
        errs = pool.validate()
        cached = len(pool.prefix.pids()) if pool.prefix is not None else 0
        arena = _nbytes(pool._resident())
        expect(peak["pages"] == gates["peak_pages"] and peak["reserved"] == gates["peak_pages"] * PAGE_BYTES
               and pool.page_bytes() == PAGE_BYTES and arena == (pool.n_pages + 1) * PAGE_BYTES,
               f"{label}: peak {peak['pages']} of {pool.n_pages} pages in use (want {gates['peak_pages']}), "
               f"{peak['reserved']:,} bytes reserved at the peak; a page {pool.page_bytes():,} bytes; the arena "
               f"{arena:,} bytes ({pool.n_pages} pages and the null page)")
        expect(errs == [] and pool.pages_in_use == cached and null_page_intact(pool),
               f"{label}: validate() {errs or '[]'}, {pool.pages_in_use} pages in use after the drain (the prefix "
               f"cache's {cached}), the null page still 0 / -1")
    else:
        expect(pool.bytes_resident() == STRIPE_BYTES == peak["reserved"],
               f"{label}: the slot pool holds {pool.bytes_resident():,} bytes (want {STRIPE_BYTES:,})")

    # Launches: K1 at each miss's prompt, each hit's suffix and each decode
    # step (warmup's prefill and decode step included); K3 at each miss.
    admitted = int(sched.stats.registry.counter_value("sched.admitted"))
    expect(len(hit_lens) == st["prefix_hits"] and len(miss_lens) == admitted - st["prefix_hits"]
           and sum(PAGED_PROMPT - m for m in hit_lens) == st["prefix_hit_tokens"],
           f"{label}: {admitted} admissions: {len(miss_lens)} whole prefills, {len(hit_lens)} suffix prefills of "
           f"{sorted(collections.Counter(hit_lens).items())} tokens")
    lens = [t["prompt"]["tokens"].shape[1] for t in trace]
    check_run_launches(label, got, continuous_expected(cfg, miss_lens, st["decode_steps"], PAGED_SLOTS,
                                                       max_len=PAGED_MAX_LEN, hits=hit_lens, warmup_lens=lens))

    # Logits: each request's own argmax; against the stripe arm.
    taken = all([int(rows[r.rid][k].argmax()) for k in sorted(rows[r.rid])] == tokens[r.rid] for r in reqs)
    expect(taken, f"{label}: every request's tokens are the argmax of its own logits")
    out = {"arm": name, "summary": st, "wall_s_with_warmup": wall, "peak_pages": peak["pages"],
           "peak_reserved_bytes": peak["reserved"], "peak_live_bytes": peak["live"], "launches": got[0],
           "shapes": listed(got[1]), "routes": {k: {str(kk): c for kk, c in v.items()} for k, v in got[2].items()},
           "flash_shapes": [[*key, c] for key, c in sorted(got[3].items())], "tokens": tokens,
           "ttft_ms_hits": sorted((r.first_token_s - r.admitted_s) * 1e3 for r in reqs if r.rid in hit_rids)}
    if stripe is None:
        out["rows"] = rows
    elif name == "paged":
        exact = all(tokens[rid] == stripe["tokens"][rid] and list(rows[rid]) == list(stripe["rows"][rid])
                    and all(torch.equal(v, stripe["rows"][rid][k]) for k, v in rows[rid].items()) for rid in tokens)
        expect(exact, f"{label} vs the stripe arm: every request's tokens equal, its first-token and decode-step "
                      f"logits bit-identical ({sum(len(v) for v in rows.values())} rows)")
    else:
        worst, replayed, agreeing = 0.0, 0, 0
        with torch.no_grad():
            for r in reqs:
                mine, theirs, want_rows = tokens[r.rid], stripe["tokens"][r.rid], stripe["rows"][r.rid]
                agree = next((i for i, (a, b) in enumerate(zip(mine, theirs)) if a != b), len(mine))
                agreeing += agree == len(mine)
                replay = None
                for i, k in enumerate(sorted(rows[r.rid])):  # row i follows prompt + mine[:i]
                    if i <= agree:
                        want = want_rows[k]
                    else:
                        if replay is None:
                            replay = replay_alone(model, params, trace[r.rid]["prompt"], mine, PAGED_MAX_LEN)
                            replayed += 1
                        want = replay[i][0, -1]
                    worst = max(worst, (rows[r.rid][k] - want).abs().max().item() / max(1.0, want.abs().max().item()))
        expect(worst <= LOGITS_TOL_BF16,
               f"{label} vs the stripe arm: every request's first-token and decode-step logits within {worst:.2%} of "
               f"the largest logit (tol {LOGITS_TOL_BF16:.0%}); {agreeing} of {len(reqs)} requests' tokens equal the "
               f"stripe arm's, {replayed} held after they part against the request alone at batch 1")
        misses = sorted(set(tokens) - hit_rids)
        first = PAGED_PROMPT - 1
        expect(bool(misses) and all(torch.equal(rows[rid][first], stripe["rows"][rid][first]) for rid in misses),
               f"{label}: the misses' (requests {misses}) first-token logits bit-identical to the stripe arm's")
        out["vs_stripe_max_share"] = worst
    del engine, sched, pool, rows
    torch.cuda.empty_cache()
    pool_kw = {k: v for k, v in kw.items() if k in ("page_size", "n_pages")} if kw.get("paged") else None
    out["decode_step_trace"] = decode_step_profile(model, params, PAGED_MAX_LEN, False, PAGED_SLOTS, paged=pool_kw)
    hits = out["ttft_ms_hits"]
    say(f"    {label} ({smi}): {st['ticks']} ticks, {st['decode_steps']} decode steps, {st['tokens_out']} tokens, "
        f"{st['prefix_hits']} prefix hits ({st['prefix_hit_tokens']} tokens), {st['preempted']} preempted; "
        f"{st['tok_per_s']} tok/s; TTFT p50 {st['ttft_p50_ms']} / p99 {st['ttft_p99_ms']} ms"
        + (f" (hits' median {hits[len(hits) // 2]:.3f} ms)" if hits else "")
        + f"; step p50 {st['p50_step_ms']} / p99 {st['p99_step_ms']} ms; tick p50 {st['p50_tick_ms']} / p99 "
        f"{st['p99_tick_ms']} ms; peak pages {out['peak_pages']}, peak bytes reserved {out['peak_reserved_bytes']:,} "
        f"/ live {out['peak_live_bytes']:,}; one decode step traced: {trace_row(out['decode_step_trace'])}; prefill "
        f"{st['prefill_s']} s + decode {st['decode_s']} s; run wall {st['run_wall_s']} s ({wall:.3f} s with warmup)")
    return out


def trace_row(r: dict) -> str:
    return (f"wall {r['wall_ms']:.3f} ms, device busy {r['device_busy_ms']:.3f} ms, idle {r['idle_share']:.3f}, "
            f"{r['device_kernels']} device kernels")


def paged_prefill_profiles(model, params) -> dict:
    """A miss and a prefix hit of the paged phase's trace as the scheduler
    runs them, traced (torch.profiler) after one untraced round: the miss's
    whole prompt through ``prefill_request`` and its scatter into fresh
    pages; the hit's slot gather, its suffix through ``prefill_chunk`` at the
    hit offset (the plain chunk attention over the slot's cache, no K3) and
    its scatter; each with the first token's readback, as a TTFT has it."""
    trace = make_shared_prefix_trace(model.cfg, device="cuda", **PAGED_TRACE)
    miss, other = trace[0]["prompt"]["tokens"], trace[PAGED_TRACE["n_groups"]]["prompt"]["tokens"]  # one group
    engine = ServeEngine(model, params, ServeConfig(max_len=PAGED_MAX_LEN, batch=PAGED_SLOTS), device="cuda")
    pool = PagedKVPool(model, PAGED_SLOTS, PAGED_MAX_LEN, page_size=PAGE_SIZE, prefix_cache=True, device="cuda")

    def serve_both(traced: bool) -> None:
        with record_function("prefill") if traced else contextlib.nullcontext():
            slot = pool.alloc()
            first, cache = engine.prefill_request({"tokens": miss})
            first.cpu()
            pool.prepare_write(slot, 0, PAGED_PROMPT)
            pool.write_slot(slot, cache, next_pos=PAGED_PROMPT)
            torch.cuda.synchronize()
        pool.register_prefix(slot, miss[0].cpu().numpy(), PAGED_PROMPT)
        hit, pids = pool.lookup_prefix(other[0].cpu().numpy())
        with record_function("prefill_chunk") if traced else contextlib.nullcontext():
            slot = pool.alloc()
            pool.attach_prefix(slot, pids)
            first, view = engine.prefill_chunk(other[:, hit:], pool.gather_slot(slot), hit, last=True)
            first.cpu()
            pool.prepare_write(slot, hit, PAGED_PROMPT)
            pool.write_slot(slot, view, next_pos=PAGED_PROMPT)
            torch.cuda.synchronize()

    serve_both(False)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        serve_both(True)
    rows = {"miss" if r["phase"] == "prefill" else "hit": r for r in trace_tools.phase_breakdown(prof.events())}
    del engine, pool
    torch.cuda.empty_cache()
    return rows


def phase_paged(model, params, smi: str) -> list[dict]:
    """The shared-prefix trace through the four arms of PAGED_ARMS, one after
    another, each pool freed before the next; then the reference
    benchmark's two comparisons, for information."""
    t = PAGED_TRACE
    say(f"[3] paged serving of {ARCH} bf16: {t['n_requests']} requests in {t['n_groups']} groups sharing a "
        f"{t['prefix_len']}-token system prompt, {t['suffix_len']}-token suffixes, {t['gen']} tokens each, "
        f"{t['rate']} arrivals per tick; {PAGED_SLOTS} slots, max_len {PAGED_MAX_LEN}, pages of {PAGE_SIZE}; arms "
        f"{', '.join(PAGED_ARMS)} ({PREEMPT_PAGES} pages)")
    runs, stripe = [], None
    for name in PAGED_ARMS:
        r = paged_arm(model, params, name, smi, stripe)
        stripe = stripe or r
        runs.append(r)
    del stripe["rows"]
    prefills = paged_prefill_profiles(model, params)
    for what in ("miss", "hit"):
        say(f"    a prefix {what}'s prefill as the scheduler runs it ({smi}), traced: {trace_row(prefills[what])}")
    runs[0]["prefill_traces"] = prefills
    by = {r["arm"]: r for r in runs}
    hits = by["prefix"]["ttft_ms_hits"]
    say(f"    [for information] prefix-hit TTFT median {hits[len(hits) // 2]:.3f} ms against the paged arm's TTFT p50 "
        f"{by['paged']['summary']['ttft_p50_ms']} ms; the prefix arm's peak live bytes "
        f"{by['prefix']['peak_live_bytes']:,} against the stripe's reserved {STRIPE_BYTES:,} "
        f"({by['prefix']['peak_live_bytes'] / STRIPE_BYTES:.3f})")
    return runs


def phase_serve(smi: str) -> tuple[dict, dict, dict, dict, list, list]:
    """The bf16 model; the same parameters served continuously over the fp
    pool and over the kv8 pool, through the long-prompt trace monolithic and
    chunked, and through the shared-prefix trace over the slot pool, the
    paged pool, the prefix cache and an undersized arena; then the w8a8
    model quantized from the same fp32 masters."""
    cfg = configs.get_config(ARCH)
    say(f"[3] serve {ARCH} (full width: {cfg.n_layers}L d={cfg.d_model} H={cfg.n_heads}/{cfg.n_kv_heads} "
        f"d_ff={cfg.d_ff} V={cfg.vocab_size}) in {cfg.dtype}, batch {BATCH}, prompt {PROMPT}, {GEN} tokens")
    model = get_model(cfg)
    t0 = time.perf_counter()
    masters = model.init(SEED, "cuda", dtype=torch.float32)  # the fp32 values both models come from
    params = cast_params(masters, BF16)
    qparams = quant.k_major(cast_params(quant.quantize_params(masters), BF16))  # as launch/serve.py lays them out
    del masters
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    n_q, q_bytes = quant.count_quantized(qparams)
    say(f"    init {time.perf_counter() - t0:.1f} s, {torch.cuda.memory_allocated() / 1e9:.2f} GB on the card; "
        f"w8a8: {n_q} projection weights -> int8 ({q_bytes / 1e6:.1f} MB resident values)")
    batch = make_batch(cfg, batch=BATCH, seq=PROMPT, kind="prefill", seed=SEED, device="cuda")
    bf16 = serve_path("bf16", model, params, {"gemm": "systolic_mmm", "tol": LOGITS_TOL_BF16}, batch)
    bf16["tune"] = phase_tune(model, params, batch)
    bf16["obs"] = phase_obs(model, params, batch, smi)
    cont = phase_continuous(model, params, smi)
    kv8 = phase_continuous(model, params, smi, fp=cont, alone=cont["replays"])
    for r in (cont, kv8):
        del r["replays"], r["logit_rows"]
    long_runs = phase_long_prompt(model, params, smi)
    paged_runs = phase_paged(model, params, smi)
    with quant.use_act_quant("int8"):
        w8a8 = serve_path("w8a8", model, qparams, {"gemm": "systolic_qmm", "tol": LOGITS_TOL_W8A8}, batch,
                          feed=bf16["fed"])
    w8a8["rounding_sensitivity"] = rounding_sensitivity(
        model, batch, [("bf16", params, contextlib.nullcontext()), ("w8a8", qparams, quant.use_act_quant("int8"))]
    )
    w8a8_vs_bf16("w8a8", w8a8, bf16)
    for r in (bf16, w8a8):
        del r["logits"], r["fed"]
    del params, qparams, model, batch
    torch.cuda.empty_cache()
    return bf16, w8a8, cont, kv8, long_runs, paged_runs


def pin_cache(path: str) -> None:
    """Point the port's plan cache at ``path``: every dispatch reads it from
    the next launch on.  ``main`` pins an empty file before any launch, so a
    cache left on the machine cannot move an untuned phase's paths."""
    os.environ[tune_cache._ENV_VAR] = path
    tune_cache.reset_default_cache()


def tune_problems(cfg) -> list[tuple[str, str, str, int, int, int]]:
    """(label, backend, dtype, M, N, K) of the tune phase: K1 at the model's
    projections at prefill (4 x 512 rows) and decode (4 rows), K1 at
    minicpm3-4b's widest projection (its shape rule's 128x256 tile was
    slower than 128x128 there, PERF.md), K5 int8 at the model's
    widest, and K4 at qwen3-moe-30b-a3b's expert shape (E = 1, C = 160)."""
    out = [("K1", "cuda-systolic", "bfloat16", m, n, k)
           for m in (BATCH * PROMPT, BATCH) for (k, n) in sorted(projections(cfg))]
    out.append(("K1 minicpm3", "cuda-systolic", "bfloat16", BATCH * PROMPT, 2560, 2560))
    out.append(("K5", "cuda-systolic", "int8", BATCH * PROMPT, cfg.d_ff, cfg.d_model))
    out.append(("K4", "cuda-grouped", "bfloat16", 160, 768, 2048))
    return out


def check_plan(backend: str, dtype: str, m: int, n: int, k: int, plan: BlockPlan, gen) -> tuple[bool, float]:
    """One launch of ``backend``'s kernel on ``plan``'s path against its plain
    version, within phase 2's tolerance for that kernel; weights at the
    models' scale (K^-0.5), so the outputs are O(1) as the model's are."""
    if backend == "cuda-grouped":
        x, w = randn((1, m, k), gen, BF16), (randn((1, k, n), gen, torch.float32) * k**-0.5).to(BF16)
        got, want = grouped_ops.grouped_matmul(x, w, plan=plan), grouped_matmul_ref(x, w)
        ok, err, _ = close(got, want, *GEMM_TOL_BF16)
        return ok, err
    if dtype == "int8":
        qa = quant.quantize(randn((m, k), gen, torch.float32), "int8", block=(1, 128))
        qb = quant.quantize(randn((k, n), gen, torch.float32), "int8", block=(128, 1))
        got = mm_ops.quant_matmul(qa, quant.k_major({"w": qb})["w"], out_dtype=BF16, plan=plan)
        want = quant_matmul_ref(qa, qb, out_dtype=BF16)
        atol = QGEMM_ATOL * (quant_matmul_ref(qa, qb, out_dtype=torch.float32).abs().max().item() + 1.0)
        ok, err, _ = close(got, want, atol, QGEMM_RTOL_BF16)
        return ok, err
    a, b = randn((m, k), gen, BF16), (randn((k, n), gen, torch.float32) * k**-0.5).to(BF16)
    ok, err, _ = close(mm_ops.matmul(a, b, plan=plan), matmul_ref(a, b, out_dtype=BF16), *GEMM_TOL_BF16)
    return ok, err


def least_us(backend: str, dtype: str, m: int, n: int, k: int) -> float:
    """The datasheet bound of one problem: its operations at the peak, or each
    input read and the output written once at the HBM rate (a plan's own
    memory term counts re-reads that the 50 MB L2 serves on the card)."""
    if backend == "cuda-grouped":
        return H100.bound_s(*_grouped_cost(k, n, m, [m]), "bfloat16")[0] * 1e6
    if dtype == "int8":
        return H100.bound_s(*_qgemm_cost(m, k, n), "int8")[0] * 1e6
    return H100.bound_s(*_gemm_cost(m, k, n), "bfloat16")[0] * 1e6


def tune_one(label: str, backend: str, dtype: str, m: int, n: int, k: int, gen) -> dict:
    """Autotune one problem on the card, every candidate held to its plain
    version and to the problem's bound before it is timed; prints the rule's
    tile and time, every candidate's and the winner."""
    rule_path, rule_blk = candidates.rule_block(m, n, k, dtype, backend)
    least = least_us(backend, dtype, m, n, k)

    def measure_fn(rec):
        plan = BlockPlan(m, n, k, rec.bm, rec.bn, rec.bk, in_dtype=dtype)
        ok, err = check_plan(backend, dtype, m, n, k, plan, gen)
        ms = measure_matmul(m, n, k, rec.bm, rec.bn, rec.bk, dtype=dtype, backend=backend, repeats=TUNE_REPEATS)
        expect(ok and ms.best_us >= least,
               f"tune {label} ({m}, {n}, {k}) {dtype} {rec.path} {rec.ident}: max_abs={err:.3e}, "
               f"{ms.best_us:.3f} us (mean {ms.mean_us:.3f}) >= bound {least:.3f} us")
        return ms

    res = autotune(m, n, k, dtype=dtype, backend=backend, top_k=None, measure_fn=measure_fn)
    times = {r.ident: r.measured_us for r in res.records}
    rule_id = "x".join(map(str, rule_blk))
    w = res.winner
    expect(not res.cache_hit and rule_id in times,
           f"tune {label} ({m}, {n}, {k}) {dtype}: rule {rule_path} {rule_id} {times.get(rule_id, float('nan')):.3f} us; "
           f"measured " + ", ".join(f"{r.path} {r.ident} {r.measured_us:.3f}" for r in res.records)
           + f"; winner {w.bm}x{w.bn}x{w.bk} {w.best_us:.3f} us [{w.method}], bound {least:.3f} us")
    return {"label": label, "backend": backend, "dtype": dtype, "m": m, "n": n, "k": k, "rule_path": rule_path,
            "rule_block": list(rule_blk), "rule_us": times.get(rule_id), "bound_us": least,
            "candidates": [{"path": r.path, "block": [r.bm, r.bn, r.bk], "us": r.measured_us} for r in res.records],
            "winner": [w.bm, w.bn, w.bk], "winner_us": w.best_us}


def serve_tuned(model, params, batch, tuned: dict) -> dict:
    """Serve the batch (4 x 512 prefill, TUNE_DECODE_STEPS decode steps)
    through ServeEngine with the tuned cache active: every K1 launch at a
    tuned shape on its cached path and chunk; then the logits of a prefill
    and two decode steps against the plain path, and two prefills bit for
    bit.  ``tuned``: (M, K, N) -> (path, k_chunk) of each tuned K1 problem."""
    cfg = model.cfg
    engine = ServeEngine(model, params, ServeConfig(max_len=PROMPT + GEN, batch=BATCH), device="cuda")
    engine.generate(batch, 2)  # warm-up (not counted)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    first = engine.prefill(batch)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine.decode(first, TUNE_DECODE_STEPS)
    torch.cuda.synchronize()
    t_decode = (time.perf_counter() - t0) / TUNE_DECODE_STEPS
    plans = dict(mm_kernel.launches_by_plan)
    at_tuned = sum(c for key, c in plans.items() if key[:3] in tuned)
    off = {str(key): c for key, c in plans.items() if key[:3] in tuned and (key[5] != "tuned" or key[3:5] != tuned[key[:3]])}
    expect(not off and at_tuned == mm_kernel.launches and at_tuned > 0,
           f"tuned serve: {at_tuned} of {mm_kernel.launches} K1 launches at tuned shapes, every one on its cached "
           f"path and chunk (off: {off})")
    report = engine.decode_plan_report()
    say(f"    tuned serve: prefill {t_prefill * 1e3:.3f} ms; decode {t_decode * 1e3:.3f} ms/step over "
        f"{TUNE_DECODE_STEPS} steps; {report}")
    n_dec = len(decode_gemm_problems(cfg, BATCH))
    expect(report == f"decode plans: {n_dec}/{n_dec} tuned (batch={BATCH})", f"tuned serve decode plans: {report}")
    with torch.no_grad():
        got, cache_t = model.prefill(params, batch, max_len=PROMPT + GEN)
        again, _ = model.prefill(params, batch, max_len=PROMPT + GEN)
        expect(torch.equal(got, again), "tuned serve: two prefills give bit-identical logits")
        del again
        cache_p = tree_util.tree_map(torch.clone, cache_t)
        with plain_versions():
            want, _ = model.prefill(params, batch, max_len=PROMPT + GEN)
        errs = [compare_logits("tuned serve prefill", got, want, LOGITS_TOL_BF16)[0]]
        tok = got.argmax(-1).to(torch.int32)
        for step in range(2):
            lk, cache_t = model.decode_step(params, tok, cache=cache_t, pos=PROMPT + step)
            with plain_versions():
                lp, cache_p = model.decode_step(params, tok, cache=cache_p, pos=PROMPT + step)
            errs.append(compare_logits(f"tuned serve decode step {step}", lk, lp, LOGITS_TOL_BF16)[0])
            tok = lk.argmax(-1).to(torch.int32)
    del engine, cache_t, cache_p
    return {"prefill_ms": t_prefill * 1e3, "decode_ms_per_step": t_decode * 1e3, "report": report,
            "launches_by_plan": {str(k): c for k, c in plans.items()}, "logits_max_abs_err": errs}


def dse_table(d2: int = DSE_SIZE) -> list[dict]:
    """The Table I analogue on the card: ``dse.explore`` over bm 64-256, bn
    128-256, bk 32-64 at d2^3 in bf16, the geometries no tile runs marked as
    fitter failures, the rest measured (``attach_measurements``); beside it
    paper design G's plan on the card (``configs/paper.block_plan_for``) and
    the balance equation's (``derive_block_plan``)."""
    recs = dse.explore(d2, d2, d2, bms=(64, 128, 256), bns=(128, 256), bks=(32, 64))
    recs = dse.attach_measurements(recs, lambda r: measure_matmul(d2, d2, d2, r.bm, r.bn, r.bk, repeats=1).best_us)
    say(f"    Table I analogue at {d2}^3 bf16 (fits: a tile runs it within shared memory and registers):")
    say(f"      {'block':>12} {'path':>14} {'smem KiB':>9} {'fits':>5} {'AI':>7} {'compute us':>11} "
        f"{'memory us':>10} {'measured us':>12}")
    for r in recs:
        meas = f"{r.measured_us:12.3f}" if r.measured_us is not None else f"{'-':>12}"
        say(f"      {r.ident:>12} {str(r.path):>14} {r.smem_kib:9.1f} {str(r.fits):>5} {r.arithmetic_intensity:7.1f} "
            f"{r.compute_us:11.3f} {r.memory_us:10.3f} {meas}")
    design = paper.designs()["G"]
    g = paper.block_plan_for(design, d2)
    balance = derive_block_plan(d2, d2, d2)
    win = dse.best(recs)
    say(f"      measured best {win.ident} ({win.path}); design G {design.array} -> {g.bm}x{g.bn}x{g.bk}; "
        f"derive_block_plan -> {balance.bm}x{balance.bn}x{balance.bk} ({balance.smem_bytes()} B shared memory)")
    expect(all(r.measured_us is not None for r in recs if r.fits) and any(not r.fits for r in recs),
           f"DSE table: {sum(r.fits for r in recs)} of {len(recs)} geometries fit and were measured")
    return [dataclasses.asdict(r) for r in recs]


def audit_gate(what: str, findings: list, stats: dict) -> None:
    """One auditor verdict: zero findings (the first few printed) at full
    coverage."""
    for f in findings[:12]:
        say(f"      {f.render()}")
    expect(not findings and stats.get("coverage", 1.0) == 1.0,
           f"{what}: {len(findings)} finding(s), coverage {stats.get('coverage', 1.0)}")


def smem_check() -> dict:
    """``BlockPlan.smem_bytes()`` against the shared memory each wgmma path
    allocates, held by the auditor (repro_torch.check.audit: the binary's
    own launch report against the Python accounting, smem-mismatch /
    smem-underdeclared) at one prefill launch of each wgmma tile; the
    auditor's stats."""
    findings, stats = check_audit.audit_launches(
        systolic=[(2048, 2048, 2048, p, 0, "explicit", True) for p, _, _ in mm_kernel.WGMMA_TILES],
        grouped=[(8, 256, 2048, 768, p, "explicit", True) for p in grouped_kernel.WGMMA_ROWS],
        quant=[(2048, 2048, 2048, "wgmma", "explicit", "int8", 128, 128, True)], device="cuda")
    audit_gate("smem of every wgmma tile, binary vs BlockPlan.smem_bytes()", findings, stats)
    return stats


def split_check(problems) -> dict:
    """``kernel.plan_split``, the Python twin by which the tuner reports the
    rule's decode chunk, against the binary's rule, held by the auditor
    (workspace-mismatch: csrc/common.cuh's ``split_workspace``, splits x M x
    N fp32; grid-mismatch: the binary's splits and chunk) at each rule
    decode launch of ``problems`` (M, N, K); the auditor's stats."""
    findings, stats = check_audit.audit_launches(
        systolic=[(m, k, n, "decode", 0, "rule", True) for m, n, k in problems], device="cuda")
    audit_gate(f"decode split rule at {len(problems)} problems, binary vs plan_split", findings, stats)
    return stats


def phase_tune(model, params, batch) -> dict:
    """The tuner on the card, on the bf16 model's parameters: autotune each of
    ``tune_problems`` into a fresh plan cache, a second pass a pure cache hit,
    the model served on the tuned tiles, the DSE table, the shared-memory
    check and the decode split rule's twin; then the empty cache pinned again
    for the untuned phases."""
    t0 = time.perf_counter()
    say(f"    tune: {len(tune_problems(model.cfg))} problems into a fresh plan cache")
    pin_cache(os.path.join(TUNE_DIR, "plans.json"))
    try:
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        results = [tune_one(*p, gen) for p in tune_problems(model.cfg)]
        reset_counts()
        measured = []
        hits = [autotune(r["m"], r["n"], r["k"], dtype=r["dtype"], backend=r["backend"],
                         measure_fn=lambda rec: measured.append(rec)) for r in results]
        expect(all(h.cache_hit for h in hits) and not measured and not any(counts().values()),
               f"tune: second pass {sum(h.cache_hit for h in hits)} of {len(hits)} cache hits, "
               f"{len(measured)} measurements, launches {counts()}")
        tuned = {(r["m"], r["k"], r["n"]): mm_kernel.path_of_block(*r["winner"])
                 for r in results if r["backend"] == "cuda-systolic" and r["dtype"] == "bfloat16"}
        serve = serve_tuned(model, params, batch, tuned)
        table = dse_table()
        smem = smem_check()
        split = split_check([(r["m"], r["n"], r["k"]) for r in results if r["backend"] == "cuda-systolic"
                             and r["dtype"] == "bfloat16" and r["m"] <= mm_kernel.DECODE_MAX_M])
    finally:
        pin_cache(os.path.join(TUNE_DIR, "untuned.json"))
    wall = time.perf_counter() - t0
    say(f"    tune phase wall {wall:.1f} s")
    return {"problems": results, "serve": serve, "dse": table, "smem": smem, "split": split, "wall_s": wall}


# The audit phase's corrupt plan spec: the 128x256 wgmma tile declared with
# 1000 B of shared memory, which the CLI must refuse (exit 1).
CORRUPT_PLAN = {"m": 2048, "n": 2048, "k": 2048, "bm": 128, "bn": 256, "bk": 64, "dtype": "bfloat16",
                "declared_smem_bytes": 1000}


def run_check_cli(*args: str) -> subprocess.Popen:
    """``python -m repro_torch.check <args>`` in a process of its own."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.Popen([sys.executable, "-m", "repro_torch.check", *args], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def phase_audit(smi: str) -> dict:
    """The static checks on the card (repro_torch.check), after every serving
    and training phase: the auditor over every distinct plan the run
    launched (``RUN_PLANS``; tuned launches read against the tune phase's
    cache), coverage 1.0 and zero findings; its dispatch paths and the paper
    sweep; each path's registers, spill bytes and shared memory as the
    binaries report them, no spill; and the CLI in two processes, started
    first: exit 1 on CORRUPT_PLAN, 0 on the clean tree (lint and the card
    audit).  Every audited launch is made once more on seeded operands and
    held against its plain version (``output-mismatch``)."""
    t0 = time.perf_counter()
    corrupt = os.path.join(TUNE_DIR, "corrupt_plans.json")
    with open(corrupt, "w") as f:
        json.dump({"plans": [CORRUPT_PLAN]}, f)
    cli = {"corrupt": run_check_cli("--no-lint", "--plans", corrupt), "clean": run_check_cli()}
    reset_counts()
    plans = {k: sorted(v) for k, v in RUN_PLANS.items()}
    say(f"    audit: {', '.join(f'{len(v)} {k}' for k, v in plans.items())} distinct launched plan keys")
    pin_cache(os.path.join(TUNE_DIR, "plans.json"))  # the cache the tuned launches read
    try:
        findings, stats = check_audit.audit_launches(**plans, device="cuda")
    finally:
        pin_cache(os.path.join(TUNE_DIR, "untuned.json"))
    say(f"    audit of launched plans: {stats['audited']} audited of {stats['launched']}, coverage "
        f"{stats['coverage']}")
    audit_gate("audit of every launched plan", findings, stats)
    expect(all(stats["launched"].get(f, 0) > 0 for f in ("systolic", "quant", "grouped", "attention")),
           f"audit: the run launched every family ({stats['launched']})")
    d_findings, d_stats = check_audit.audit_dispatch_paths("cuda")
    say(f"    audit dispatch paths: {d_stats['paths']}, max_abs_err {d_stats['max_abs_err']}")
    audit_gate("audit of the dispatch paths", d_findings, d_stats)
    s_findings, s_stats = check_audit.sweep_paper_candidates("cuda")
    say(f"    audit paper sweep: {s_stats['plans_audited']} candidates over {s_stats['problems']} x "
        f"{s_stats['dtypes']}")
    audit_gate("audit of the paper sweep", s_findings, s_stats)
    report = check_audit.kernel_report("cuda")
    say(f"    binaries ({smi}):")
    say(f"      {'library':12} {'path':16} {'dtype':14} {'out':9} {'regs':>4} {'spill B':>7} {'static B':>8} "
        f"{'dynamic B':>9} {'threads':>7}")
    for r in report:
        say(f"      {r['library']:12} {r['path']:16} {r['dtype']:14} {r['out']:9} {r['regs']:4d} "
            f"{r['local_bytes']:7d} {r['static_smem']:8d} {r['dyn_smem']:9d} {r['threads']:7d}")
    spills = [f"{r['library']}:{r['path']}:{r['out']}" for r in report if r["local_bytes"]]
    expect(not spills, f"no compiled path spills to local memory ({len(report)} kernels; spilling: {spills})")
    rcs = {}
    for name, proc in cli.items():
        out, _ = proc.communicate(timeout=600)
        rcs[name] = proc.returncode
        say(f"    check CLI ({name}): exit {proc.returncode}; {out.strip().splitlines()[-1] if out.strip() else ''}")
    expect(rcs == {"corrupt": 1, "clean": 0}, f"check CLI exits 1 on the corrupt plan spec, 0 on the clean tree "
                                              f"({rcs})")
    reset_counts()
    wall = time.perf_counter() - t0
    say(f"    audit phase wall {wall:.1f} s")
    return {"launched": stats, "dispatch": d_stats, "sweep": s_stats,
            "kernels": report, "cli": rcs, "findings": [f.to_dict() for f in findings + d_findings + s_findings],
            "wall_s": wall}


def w8a8_vs_bf16(label: str, w8a8: dict, bf16: dict, gate: bool = True) -> None:
    """w8a8 against the bf16 model from the same fp32 weights, both on the
    kernels, prefill and two decode steps fed the same tokens, within the
    reference's bound of W8A8_VS_BF16_TOL x the largest logit (``gate``), or
    printed for information only."""
    w8a8["vs_bf16_max_abs_err"], w8a8["vs_bf16_bound"] = [], []
    for what, got, want in zip(("prefill", "decode step 0", "decode step 1"), w8a8["logits"], bf16["logits"]):
        err = (got - want).abs().max().item()
        bound = W8A8_VS_BF16_TOL * want.abs().max().item()
        msg = (f"{label} vs bf16 {what} logits: max_abs={err:.3e} (bound {W8A8_VS_BF16_TOL} x max|logit| = "
               f"{bound:.3e}); greedy tokens agree in {int((got.argmax(-1) == want.argmax(-1)).sum())} of "
               f"{got.shape[0]} rows")
        if gate:
            expect(bool(torch.isfinite(got).all()) and err < bound, msg)
        else:
            say(f"    [for information, not a gate] {msg}")
        w8a8["vs_bf16_max_abs_err"].append(err)
        w8a8["vs_bf16_bound"].append(bound)


def phase_serve_mla(smi: str) -> tuple[dict, dict, dict, dict, dict]:
    """Full-width minicpm3-4b (MLA), drawn in fp32 from SEED and served in
    bf16 and in w8a8 from the same masters, each built as the launcher builds
    it (``launch/serve.py::init_params``: w8a8 one layer at a time, weights
    K-major); the bf16 parameters also through ContinuousScheduler on the
    continuous trace, monolithic, chunked and over the paged latent pool."""
    cfg = dataclasses.replace(configs.get_config(MLA_ARCH), n_layers=MLA_LAYERS)
    m = cfg.mla
    say(f"[3] serve {MLA_ARCH} (full width, {cfg.n_layers} of its 62 layers: {cfg.n_layers}L d={cfg.d_model} H={cfg.n_heads} MLA q_lora "
        f"{m.q_lora_rank} kv_lora {m.kv_lora_rank} nope {m.qk_nope_head_dim} rope {m.qk_rope_head_dim} v "
        f"{m.v_head_dim} d_ff={cfg.d_ff} V={cfg.vocab_size}) in {cfg.dtype}, batch {BATCH}, prompt {PROMPT}, "
        f"{GEN} tokens")
    model = get_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, _ = init_params(model, SEED, torch.device("cuda"), "none")
    qparams, act_ctx = init_params(model, SEED, torch.device("cuda"), "w8a8")
    torch.cuda.synchronize()
    n = sum(t.numel() for t in tree_util.leaves(params))
    say(f"    init {time.perf_counter() - t0:.1f} s: {n:,} parameters, {torch.cuda.memory_allocated() / 1e9:.2f} GB "
        f"on the card with the w8a8 tree (peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB)")
    norms = cfg.n_layers * (m.q_lora_rank + m.kv_lora_rank)  # count_params leaves MLA's two norms out
    expect(n == model.n_params + norms,
           f"{MLA_ARCH} parameters {n} = the config's count {model.n_params} + {norms} MLA norm scales")
    batch = make_batch(cfg, batch=BATCH, seq=PROMPT, kind="prefill", seed=SEED, device="cuda")
    bf16 = serve_path("mla bf16", model, params, {"gemm": "systolic_mmm", "tol": LOGITS_TOL_BF16}, batch)
    cont = phase_continuous(model, params, smi, resident=MLA_CONT_BYTES)
    chunked = phase_continuous(model, params, smi, chunk=MLA_CHUNK, resident=MLA_CONT_BYTES, alone=cont["replays"])
    paged = phase_continuous(model, params, smi, resident=MLA_PAGE_BYTES, alone=cont["replays"], paged=True,
                             same_as=cont)
    for r in (cont, chunked, paged):
        del r["replays"], r["logit_rows"]
    with act_ctx:
        w8a8 = serve_path("mla w8a8", model, qparams, {"gemm": "systolic_qmm", "tol": LOGITS_TOL_W8A8}, batch,
                          feed=bf16["fed"])
    w8a8_vs_bf16("mla w8a8", w8a8, bf16)
    for r in (bf16, w8a8):
        del r["logits"], r["fed"]
    bf16["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    say(f"    peak device memory over the MLA phase: {bf16['peak_gb']:.2f} GB")
    del params, qparams, model, batch
    torch.cuda.empty_cache()
    return bf16, w8a8, cont, chunked, paged


def phase_serve_moe() -> tuple[dict, dict]:
    """The MoE model in bf16, built directly in bf16 (fp32 drawn one tensor
    at a time), after the dense models' memory has been given back; then,
    with the bf16 trees freed, in w8a8 from the same seed, built as the
    launcher builds it (one layer of fp32 masters at a time: attention and
    the head quantized, the router and the experts bf16, as the reference
    leaves them)."""
    cfg = configs.get_config(MOE_ARCH)
    m = cfg.moe
    say(f"[3] serve {MOE_ARCH} (full width: {cfg.n_layers}L d={cfg.d_model} H={cfg.n_heads}/{cfg.n_kv_heads} "
        f"qk_norm={cfg.qk_norm} experts {m.n_experts} top-{m.top_k} d_ff_expert={m.d_ff_expert} "
        f"V={cfg.vocab_size}) in {cfg.dtype}, batch {BATCH}, prompt {PROMPT}, {GEN} tokens")
    model = get_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(SEED, "cuda")
    torch.cuda.synchronize()
    n = sum(t.numel() for t in tree_util.leaves(params))
    say(f"    init {time.perf_counter() - t0:.1f} s: {n:,} parameters, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card (peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB)")
    qk_scales = 2 * cfg.resolved_head_dim * cfg.n_layers if cfg.qk_norm else 0  # count_params leaves them out
    expect(n == model.n_params + qk_scales,
           f"{MOE_ARCH} parameters {n} = the config's count {model.n_params} + {qk_scales} qk-norm scales")
    want = {"gemm": "systolic_mmm", "tol": LOGITS_TOL_MOE}
    out, seeds = None, {}
    # The model of the main path, then the same checks and witnesses on
    # models and prompts drawn from other seeds (the MoE tolerance rests on
    # the largest readings over all of them).
    for seed in (SEED, *MOE_WITNESS_SEEDS):
        if seed != SEED:
            del params
            torch.cuda.empty_cache()
            params = model.init(seed, "cuda")
        batch = make_batch(cfg, batch=BATCH, seq=PROMPT, kind="prefill", seed=seed, device="cuda")
        label = "moe" if seed == SEED else f"moe seed {seed}"
        r = serve_path(label, model, params, want, batch)
        r["rounding_sensitivity"] = rounding_sensitivity(model, batch, [(label, params, contextlib.nullcontext())],
                                                         nudges=MOE_NUDGES, steps=MOE_NUDGE_STEPS, seed=seed)
        if seed == SEED:
            bf16_main = {"logits": r["logits"], "fed": r["fed"]}  # for the w8a8 model's comparison
        del r["logits"], r["fed"], batch
        seeds[seed] = r
        out = out or r
    out["witness_seeds"] = {seed: {k: r[k] for k in ("logits_max_abs_err", "logits_scale", "decode_logits_max_abs_err",
                                                     "routed_alike_max_abs_err", "rounding_sensitivity")}
                            for seed, r in seeds.items()}
    free = max(max(r["logits_max_abs_err"] / r["logits_scale"], r["decode_logits_max_abs_err"] / r["logits_scale"])
               for r in seeds.values())
    alike = max(max(r["routed_alike_max_abs_err"]) / r["logits_scale"] for r in seeds.values())
    nudge = max(max(v["prefill"], v["decode_step"]) for r in seeds.values() for v in r["rounding_sensitivity"].values())
    say(f"    MoE witness over seeds {[SEED, *MOE_WITNESS_SEEDS]}: kernel vs plain path, largest gap as a share of "
        f"the prefill's largest logit: {free:.2%} routing freely (tol {LOGITS_TOL_MOE:.0%}), {alike:.2%} routed alike "
        f"(tol {LOGITS_TOL_BF16:.0%}); one-ulp nudge of the plain path alone, largest reading {nudge:.2%}")
    out["witness_max"] = {"free": free, "routed_alike": alike, "nudge": nudge}
    del params
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    qparams, act_ctx = init_params(model, SEED, torch.device("cuda"), "w8a8")
    torch.cuda.synchronize()
    n_q, q_bytes = quant.count_quantized(qparams)
    say(f"    w8a8 init, one layer of fp32 masters at a time: {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card, {n_q} weights int8 ({q_bytes / 1e9:.3f} GB)")
    batch = make_batch(cfg, batch=BATCH, seq=PROMPT, kind="prefill", seed=SEED, device="cuda")
    with act_ctx:
        w8 = serve_path("moe w8a8", model, qparams, {"gemm": "systolic_qmm", "tol": LOGITS_TOL_MOE}, batch,
                        feed=bf16_main["fed"])
    w8a8_vs_bf16("moe w8a8", w8, bf16_main, gate=False)
    del w8["logits"], w8["fed"]
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    say(f"    peak device memory over the MoE phase: {out['peak_gb']:.2f} GB")
    del qparams, model, batch, bf16_main
    torch.cuda.empty_cache()
    return out, w8


def serve_recurrent(model, params, batch) -> dict:
    """Serve one synchronized batch of a recurrent model through ServeEngine
    (BATCH x PROMPT, GEN greedy tokens), the counts set to 0 just before the
    prefill and the decode and read just after: the prefill is PROMPT decode
    steps, so every K1 launch is at M = BATCH on the decode tile, per shape
    ``recurrent_projections`` x steps, and no flash launch.  The model's
    prefill is wrapped here, in the script, to keep the served logits.  Then
    the kernel path against the plain path on the batch's first
    RECURRENT_CHECK_PROMPT tokens (last logits, and two decode steps from one
    cache), and a second kernel-path prefill against the first, bit for bit."""
    cfg = model.cfg
    label = cfg.name
    served = []

    def prefill(p, b, max_len):
        logits, cache = model.prefill(p, b, max_len=max_len)
        served.append(logits.clone())
        return logits, cache

    engine = ServeEngine(dataclasses.replace(model, prefill=prefill), params,
                         ServeConfig(max_len=PROMPT + GEN, batch=BATCH), device="cuda")
    # Warm-up: library handles and every kernel's first launch (not counted).
    # A prefill is decode steps at M = BATCH whatever its length, so 4 tokens do.
    engine.generate({"tokens": batch["tokens"][:, :4].contiguous()}, 2)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    first = engine.prefill(batch)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    pf = (counts(), shape_counts(), route_counts())
    reset_counts()
    t0 = time.perf_counter()
    rest = engine.decode(first, GEN - 1)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    dec = (counts(), shape_counts(), route_counts())
    tokens = torch.cat([first, rest], dim=1)
    per_step = sum(recurrent_projections(cfg).values())
    say(f"    {label}: prefill {BATCH}x{PROMPT} ({PROMPT} decode steps) {t_prefill * 1e3:.3f} ms "
        f"({t_prefill / PROMPT * 1e3:.3f} ms a step); decode {t_decode / (GEN - 1) * 1e3:.3f} ms/step, "
        f"{BATCH * (GEN - 1) / t_decode:.1f} tok/s over {GEN - 1} steps; {per_step} K1 launches a step")
    for phase, (got_c, got_s, got_r), steps in (("prefill", pf, PROMPT), ("decode", dec, GEN - 1)):
        want_c, want_s = launches_at(cfg, "systolic_mmm", BATCH, steps, phase == "prefill")
        expect(got_c == want_c, f"{label} {phase} launches over {steps} steps: {got_c}, want {want_c} "
                                f"({per_step} a step, no flash)")
        for name, by in got_s.items():
            expect(by == want_s[name], f"{label} {phase} {name} launches by shape: {sorted(by.items())}")
        want_r = expected_routes(cfg, want_s, 0)
        for key in got_r:
            expect(got_r[key] == want_r[key], f"{label} {phase} {key}: {got_r[key]}, want {want_r[key]}")
    expect(tuple(tokens.shape) == (BATCH, GEN) and bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
           f"{label} tokens {tuple(tokens.shape)} in [0, {cfg.vocab_size}): {tokens[0, :12].tolist()}")
    expect(bool(torch.isfinite(served[-1]).all()), f"{label} served prefill logits finite")

    small = {"tokens": batch["tokens"][:, :RECURRENT_CHECK_PROMPT].contiguous()}
    max_len = RECURRENT_CHECK_PROMPT + 2
    with torch.no_grad():
        reset_counts()
        got, cache_k = model.prefill(params, small, max_len=max_len)
        again, _ = model.prefill(params, small, max_len=max_len)
        expect(torch.equal(got, again), f"{label} two kernel-path prefills give bit-identical logits")
        del again
        kernel_counts = counts()
        with plain_versions():
            want_l, _ = model.prefill(params, small, max_len=max_len)
        plain_counts = {k: c - kernel_counts[k] for k, c in counts().items()}
        expect(not any(plain_counts.values()), f"{label} plain-path prefill launched no kernel ({plain_counts})")
        err, scale = compare_logits(f"{label} prefill ({BATCH}x{RECURRENT_CHECK_PROMPT})", got, want_l,
                                    LOGITS_TOL_BF16)
        cache_p = tree_util.tree_map(torch.clone, cache_k)
        tok, dec_err = got.argmax(-1).to(torch.int32), 0.0
        for step in range(2):
            lk, cache_k = model.decode_step(params, tok, cache=cache_k, pos=RECURRENT_CHECK_PROMPT + step)
            n0 = counts()
            with plain_versions():
                lp, cache_p = model.decode_step(params, tok, cache=cache_p, pos=RECURRENT_CHECK_PROMPT + step)
            expect(counts() == n0, f"{label} plain-path decode step {step} launched no kernel")
            dec_err = max(dec_err, compare_logits(f"{label} decode step {step}", lk, lp, LOGITS_TOL_BF16)[0])
            tok = lk.argmax(-1).to(torch.int32)
    del engine, cache_k, cache_p
    return {
        "arch": cfg.name, "prefill_ms": t_prefill * 1e3, "prefill_ms_per_step": t_prefill / PROMPT * 1e3,
        "decode_ms_per_step": t_decode / (GEN - 1) * 1e3, "decode_tok_s": BATCH * (GEN - 1) / t_decode,
        "k1_launches_per_step": per_step, "prefill_launches": pf[0], "decode_launches": dec[0],
        "prefill_shapes": listed(pf[1]), "decode_shapes": listed(dec[1]),
        "logits_max_abs_err": err, "logits_scale": scale, "decode_logits_max_abs_err": dec_err,
        "served_prefill_logits": served[-1],
    }


def forward_vs_prefill(model, masters, params, batch, served_logits) -> dict:
    """``forward`` (the parallel path: chunked mLSTM / SSD, zamba2's shared
    attention on the flash kernel at D = 112) against ``prefill`` (the
    recurrence) on the batch's first row, in fp32 at full width (the fp32
    masters): forward's launches exact (K1 once per projection and layer at
    M = PROMPT, flash once per application of the shared block), its last
    logits within FORWARD_TOL_FP32 of the largest.  The bf16 forward on the
    same row beside the served bf16 prefill's row 0 is printed for
    information."""
    cfg = model.cfg
    model32 = get_model(dataclasses.replace(cfg, dtype="float32"))
    row = {"tokens": batch["tokens"][:1].contiguous()}
    n_apps = hybrid_counts(cfg)[1] if cfg.family == "hybrid" else 0
    with torch.no_grad():
        reset_counts()
        t0 = time.perf_counter()
        f32 = model32.forward(masters, row)[:, -1:]
        torch.cuda.synchronize()
        t_fwd = time.perf_counter() - t0
        got_c, got_s, got_f = counts(), shape_counts(), flash_shape_counts()
        want_c, want_s = launches_at(cfg, "systolic_mmm", PROMPT, 1, False)
        want_c["flash_attn"] = n_apps
        expect(got_c == want_c and got_s["systolic_mmm"] == want_s["systolic_mmm"]
               and got_f == ({(1, PROMPT, PROMPT): n_apps} if n_apps else {}),
               f"{cfg.name} fp32 forward 1x{PROMPT} launches: {got_c}, K1 at M={PROMPT} by shape "
               f"{sorted(got_s['systolic_mmm'].items())}, flash by (B, Sq, Skv) {got_f}")
        t0 = time.perf_counter()
        p32, _ = model32.prefill(masters, row, max_len=PROMPT + 1)
        torch.cuda.synchronize()
        t_pf = time.perf_counter() - t0
        err = (f32 - p32).abs().max().item()
        scale = max(1.0, p32.abs().max().item())
        expect(bool(torch.isfinite(f32).all()) and err <= FORWARD_TOL_FP32 * scale,
               f"{cfg.name} fp32 forward (parallel) vs prefill (recurrent) last logits on 1x{PROMPT}: "
               f"max_abs={err:.3e} (tol {FORWARD_TOL_FP32} x {scale:.2f}); argmax equal: "
               f"{int(f32.argmax(-1)) == int(p32.argmax(-1))}")
        fb = model.forward(params, row)[:, -1:]
        err16 = (fb - served_logits[:1]).abs().max().item()
        scale16 = max(1.0, served_logits[:1].abs().max().item())
        say(f"    [for information, not a gate] {cfg.name} bf16 forward 1x{PROMPT} vs the served bf16 prefill's row 0: "
            f"max_abs={err16:.3e} ({err16 / scale16:.2%} of the largest logit)")
    say(f"    {cfg.name} fp32: forward 1x{PROMPT} {t_fwd * 1e3:.1f} ms, prefill ({PROMPT} steps) {t_pf * 1e3:.1f} ms")
    return {"forward_vs_prefill_fp32_max_abs_err": err, "forward_vs_prefill_fp32_scale": scale,
            "forward_bf16_vs_served_max_abs_err": err16, "forward_fp32_ms": t_fwd * 1e3,
            "prefill_fp32_ms": t_pf * 1e3, "forward_launches": got_c,
            "forward_flash_shapes": [[*k, c] for k, c in sorted(got_f.items())]}


def phase_serve_recurrent(arch: str, smi: str) -> tuple[dict, list]:
    """A recurrent model at full width, drawn in fp32 from SEED and served in
    bf16 (its fp32 leaves kept fp32): ``serve_recurrent``, then
    ``forward_vs_prefill`` on the fp32 masters; the SSM model also through
    ContinuousScheduler on the continuous trace, monolithic and in chunks of
    SSM_CHUNK (the staged path), its state pool's resident bytes exact."""
    cfg = configs.get_config(arch)
    s = cfg.ssm
    if cfg.family == "ssm":
        n_groups, n_m = xlstm_counts(cfg)
        shape = (f"{n_groups} groups of {n_m} mLSTM + 1 sLSTM, d={cfg.d_model} H={cfg.n_heads} expand {s.expand} "
                 f"(mLSTM heads {s.expand * cfg.d_model // cfg.n_heads} wide)")
    else:
        n_mamba, n_apps, _ = hybrid_counts(cfg)
        shape = (f"{n_mamba} Mamba2 layers (d_inner {s.expand * cfg.d_model}, {s.expand * cfg.d_model // s.head_dim} "
                 f"heads of {s.head_dim}, state {s.state_size}) and {n_apps} applications of one shared attention "
                 f"block (H={cfg.n_heads}/{cfg.n_kv_heads} D={cfg.resolved_head_dim}, d_ff={cfg.d_ff})")
    say(f"[3] serve {arch} (full width: {cfg.n_layers}L, {shape}, V={cfg.vocab_size}) in {cfg.dtype}, batch "
        f"{BATCH}, prompt {PROMPT}, {GEN} tokens")
    model = get_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    masters = model.init(SEED, "cuda", dtype=torch.float32)
    params = cast_params(masters, BF16)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in tree_util.leaves(params))
    kept = [t for k, t in _keyed_leaves(params) if k in FP32_KEYS]
    say(f"    init {time.perf_counter() - t0:.1f} s: {n:,} parameters (count_params: {model.n_params:,}), "
        f"{_nbytes(params):,} bytes in bf16, {torch.cuda.memory_allocated() / 1e9:.2f} GB on the card with the "
        f"fp32 masters")
    expect(all(t.dtype == torch.float32 for t in kept) and len(kept) > 0,
           f"{arch}: all {len(kept)} leaves of {sorted(FP32_KEYS)} kept fp32 in the bf16 model")
    batch = make_batch(cfg, batch=BATCH, seq=PROMPT, kind="prefill", seed=SEED, device="cuda")
    r = serve_recurrent(model, params, batch)
    r.update(forward_vs_prefill(model, masters, params, batch, r.pop("served_prefill_logits")))
    del masters
    torch.cuda.empty_cache()
    r.update(n_params=n, count_params=model.n_params, param_bytes=_nbytes(params))
    runs = []
    if cfg.family == "ssm":
        resident = state_bytes(cfg, CONT_SLOTS)
        cont = phase_continuous(model, params, smi, resident=resident)
        chunked = phase_continuous(model, params, smi, chunk=SSM_CHUNK, resident=resident, alone=cont["replays"],
                                   n_requests=SSM_CHUNKED_REQUESTS)
        for run in (cont, chunked):
            del run["replays"], run["logit_rows"]
        runs = [cont, chunked]
    r["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    say(f"    peak device memory over the {arch} phase: {r['peak_gb']:.2f} GB")
    del params, model, batch
    torch.cuda.empty_cache()
    return r, runs


def phase_serve_frontend(arch: str, smi: str) -> tuple[dict, dict | None]:
    """A frontend model at full width, drawn in fp32 from SEED and built in
    bf16 as the launcher builds it (the projector's norm fp32): served like
    internlm2-1.8b (``serve_path``: exact K1 launches per shape -- the vit
    projector's two per prefill, the audio heads none -- and K3 per head
    count, kernel vs plain, two prefills bit-identical), its device kernels
    per decode step traced; internvl2-1b also through ContinuousScheduler on
    the continuous trace."""
    cfg = configs.get_config(arch)
    front = (f"{cfg.n_codebooks} codebooks of {cfg.vocab_size}" if cfg.frontend == "audio_codec"
             else f"{cfg.n_patches} patches of {cfg.vit_dim}, V={cfg.vocab_size}")
    say(f"[3] serve {arch} (full width: {cfg.n_layers}L d={cfg.d_model} H={cfg.n_heads}/{cfg.n_kv_heads} "
        f"d_ff={cfg.d_ff}, {front}) in {cfg.dtype}, batch {BATCH}, prompt {PROMPT} positions"
        + (f" ({cfg.n_patches} patches + {PROMPT - cfg.n_patches} text)" if cfg.frontend == "vit" else "")
        + f", {GEN} tokens")
    model = get_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, _ = init_params(model, SEED, torch.device("cuda"), "none")
    torch.cuda.synchronize()
    n = sum(t.numel() for t in tree_util.leaves(params))
    # count_params leaves the vit projector out (its norm and two weights)
    projector = cfg.vit_dim + sum(k * nn for k, nn in projector_gemms(cfg)) if cfg.frontend == "vit" else 0
    say(f"    init {time.perf_counter() - t0:.1f} s: {n:,} parameters, {_nbytes(params):,} bytes")
    expect(n == model.n_params + projector,
           f"{arch} parameters {n:,} = the config's count {model.n_params:,} + {projector:,} of the projector")
    batch = make_batch(cfg, batch=BATCH, seq=PROMPT, kind="prefill", seed=SEED, device="cuda")
    r = serve_path(arch, model, params, {"gemm": "systolic_mmm", "tol": LOGITS_TOL_BF16}, batch)
    del r["logits"], r["fed"]
    r["decode_step_trace"] = decode_step_profile(model, params, PROMPT + GEN, False, slots=BATCH)
    cont = None
    if cfg.frontend == "vit":
        cont = phase_continuous(model, params, smi)
        del cont["replays"], cont["logit_rows"]
    r.update(n_params=n, param_bytes=_nbytes(params), peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    say(f"    {arch} ({smi}): prefill {r['prefill_ms']:.3f} ms, decode {r['decode_ms_per_step']:.3f} ms/step, "
        f"{r['decode_tok_s']:.1f} tok/s; one decode step over {BATCH} slots traced: {trace_row(r['decode_step_trace'])}; "
        f"peak device memory {r['peak_gb']:.2f} GB")
    del params, model, batch
    torch.cuda.empty_cache()
    return r, cont


def phase_tied(smi: str) -> dict:
    """internvl2-1b with a tied head (``dataclasses.replace(...,
    tie_embeddings=True)``: no lm_head; K1 reads the (V, d) table K-major,
    ``layers.unembed``) at full width in bf16: one prefill of BATCH x PROMPT
    and TIED_STEPS greedy decode steps with the counts set to 0 just before
    and read just after, every launch exact by shape and path -- the
    table's 1 + TIED_STEPS on the K-major decode tile --; then the kernel
    path's logits against the plain path's from the same cache, and a
    second kernel-path prefill against the first, bit for bit."""
    cfg = dataclasses.replace(configs.get_config(VLM_ARCH), tie_embeddings=True)
    k, v = tied_head(cfg)
    say(f"[3] {VLM_ARCH} with a tied head (the {v} x {k} table read K-major), bf16, one prefill of {BATCH}x{PROMPT} "
        f"and {TIED_STEPS} decode steps")
    model = get_model(cfg)
    params, _ = init_params(model, SEED, torch.device("cuda"), "none")
    batch = make_batch(cfg, batch=BATCH, seq=PROMPT, kind="prefill", seed=SEED, device="cuda")
    max_len = PROMPT + TIED_STEPS
    with torch.no_grad():
        model.prefill(params, batch, max_len=max_len)  # warm-up: first launches (not counted)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        got, cache_k = model.prefill(params, batch, max_len=max_len)
        cache_p = tree_util.tree_map(torch.clone, cache_k)
        tok, logits_k, feed = got.argmax(-1).to(torch.int32), [got], []
        for step in range(TIED_STEPS):
            feed.append(tok)
            lk, cache_k = model.decode_step(params, tok, cache=cache_k, pos=PROMPT + step)
            logits_k.append(lk)
            tok = lk.argmax(-1).to(torch.int32)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got_c, got_s, got_r, got_f = counts(), shape_counts(), route_counts(), flash_shape_counts()
        want_c, want_s = launches_at(cfg, "systolic_mmm", BATCH * PROMPT, 1, True, seqs=BATCH)
        dec_c, dec_s = launches_at(cfg, "systolic_mmm", BATCH, TIED_STEPS, False)
        for key, c in dec_s["systolic_mmm"].items():
            want_s["systolic_mmm"][key] = want_s["systolic_mmm"].get(key, 0) + c
        want_c = {name: want_c[name] + dec_c[name] for name in want_c}
        want_r = expected_routes(cfg, want_s, 1)
        expect(got_c == want_c, f"tied prefill + {TIED_STEPS} decode steps launches: {got_c}, want {want_c}")
        for name, by in got_s.items():
            expect(by == want_s[name], f"tied {name} launches by shape: {sorted(by.items())}")
        for key in got_r:
            expect(got_r[key] == want_r[key], f"tied {key}: {got_r[key]}, want {want_r[key]}")
        head = got_s["systolic_mmm"].get((BATCH, k, v), 0)
        paths = got_r["systolic_mmm_paths"]
        expect(head == 1 + TIED_STEPS and paths.get("decode_kmajor", 0) == 1 + TIED_STEPS,
               f"tied head: {head} K1 launches at (M, K, N) = ({BATCH}, {k}, {v}), {paths.get('decode_kmajor', 0)} "
               f"on decode_kmajor (want {1 + TIED_STEPS}: the prefill's and each decode step's)")
        again, _ = model.prefill(params, batch, max_len=max_len)
        expect(torch.equal(got, again), "tied: two kernel-path prefills give bit-identical logits")
        del again
        n0 = counts()
        with plain_versions():
            want_l, _ = model.prefill(params, batch, max_len=max_len)
            errs = [compare_logits("tied prefill", got, want_l, LOGITS_TOL_BF16)[0]]
            for step in range(TIED_STEPS):
                lp, cache_p = model.decode_step(params, feed[step], cache=cache_p, pos=PROMPT + step)
                errs.append(compare_logits(f"tied decode step {step}", logits_k[step + 1], lp, LOGITS_TOL_BF16)[0])
        expect(counts() == n0, "tied plain path launched no kernel")
    say(f"    tied ({smi}): prefill + {TIED_STEPS} decode steps {wall * 1e3:.3f} ms")
    out = {"arch": cfg.name, "tie_embeddings": True, "launches": got_c, "shapes": listed(got_s),
           "routes": {key: {str(kk): c for kk, c in val.items()} for key, val in got_r.items()},
           "flash_shapes": [[*key, c] for key, c in sorted(got_f.items())],
           "logits_max_abs_err": errs, "wall_ms": wall * 1e3}
    del params, model, batch, cache_k, cache_p
    torch.cuda.empty_cache()
    return out


def activation_flips(label: str, flips: list, cfg) -> dict:
    """Summarise, by layer, the int8 activation values in which the plain
    path's prefill differs from the kernel path's (the quantized GEMM inputs
    of each layer: q, k, v, o -- MLA: wq_a, wq_b, wkv_a, wo --, then gate, up
    and down unless the FFN is a MoE block, which stays wide).  The first
    layer's inputs taken straight from the normed embedding (q, k and v;
    MLA's wq_a and wkv_a) are the same on both paths, so they must agree
    exactly; every later difference starts from the paths' bf16 GEMM outputs
    differing by rounding."""
    mla = cfg.attention == "mla"
    names = ["wq_a", "wq_b", "wkv_a", "wo"] if mla else ["q", "k", "v", "o"]
    names += [] if cfg.moe is not None else ["gate", "up", "down"]
    per, n_layers = len(names), cfg.n_layers
    expect(len(flips) == per * n_layers, f"{label} prefill quantized {len(flips)} GEMM inputs per path, "
                                         f"want {per * n_layers}")
    by_layer = [flips[per * i:per * i + per] for i in range(n_layers)]
    frac = [sum(f[0] for f in lay) / sum(f[2] for f in lay) for lay in by_layer]
    frac2 = [sum(f[1] for f in lay) / sum(f[2] for f in lay) for lay in by_layer]
    exact = (0, 2) if mla else (0, 1, 2)
    first = sum(flips[i][0] for i in exact)
    expect(first == 0, f"{label} prefill: layer 0's {'/'.join(names[i] for i in exact)} inputs quantize "
                       f"identically on both paths ({first} values differ)")
    say(f"    {label} prefill int8 activations differing, plain vs kernel path, share by layer: "
        f"{' '.join(f'{x:.2e}' for x in frac)}")
    say(f"    ... by more than one int8 step: {' '.join(f'{x:.2e}' for x in frac2)}; "
        f"largest difference {max(f[3] for f in flips)} steps; layer 0 by GEMM input ({' '.join(names)}): "
        f"{' '.join(f'{f[0] / f[2]:.2e}' for f in flips[:per])}")
    return {"share_by_layer": frac, "share_over_one_step_by_layer": frac2, "max_step": max(f[3] for f in flips),
            "layer0_share_by_input": [f[0] / f[2] for f in flips[:per]],
            "differing": sum(f[0] for f in flips), "elements": sum(f[2] for f in flips)}


def rounding_sensitivity(model, batch, variants: list, nudges: int = 1, steps: int = 1, seed: int = SEED) -> dict:
    """How far the plain path alone moves under a rounding-sized change of
    its input: the embedding table nudged up by one bf16 ulp on a random half
    of its elements (``nudges`` draws from ``seed``), prefill logits of each
    nudged against the unchanged model, as a share of the largest logit, for
    each (label, params, activation-quant context) variant in turn; then
    ``steps`` greedy decode steps of the unchanged model from its primed
    cache, each step also run by every nudged model from a copy of the
    unchanged cache (so only that step's own token is nudged).  Read beside
    each model's kernel-vs-plain error."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)

    def share(a, b):
        return (b - a).abs().max().item() / max(1.0, a.abs().max().item())

    out = {}
    with torch.no_grad(), plain_versions():
        for label, p, ctx in variants:
            table = p["embed"]["table"]
            nudged = []
            for _ in range(nudges):
                bump = torch.randint(0, 2, table.shape, generator=gen, device="cuda", dtype=torch.int16)
                nudged.append({**p, "embed": {**p["embed"], "table": (table.view(torch.int16) + bump).view(table.dtype)}})
                del bump
            readings = []  # per nudge: the prefill's share, then each decode step's
            with ctx:
                base, cache = model.prefill(p, batch, max_len=PROMPT + GEN)
                for q in nudged:
                    readings.append([share(base, model.prefill(q, batch, max_len=PROMPT + GEN)[0])])
                tok = base.argmax(-1).to(torch.int32)
                for step in range(steps):
                    moved = [model.decode_step(q, tok, cache=tree_util.tree_map(torch.clone, cache), pos=PROMPT + step)[0]
                             for q in nudged]
                    logits, cache = model.decode_step(p, tok, cache=cache, pos=PROMPT + step)
                    for r, m in zip(readings, moved):
                        r.append(share(logits, m))
                    tok = logits.argmax(-1).to(torch.int32)
            del cache, nudged
            out[label] = {"prefill": max(r[0] for r in readings), "decode_step": max(x for r in readings for x in r[1:]),
                          "readings": readings}
            expect(all(math.isfinite(x) for r in readings for x in r),
                   f"{label} plain path, embedding nudged by one bf16 ulp: logits move by "
                   f"{out[label]['prefill']:.2%} of the largest at prefill, {out[label]['decode_step']:.2%} "
                   f"in a decode step" + (f" (largest of {nudges} nudges x {steps} steps)" if nudges * steps > 1 else ""))
    return out


def compare_logits(what: str, got: torch.Tensor, want: torch.Tensor, tol: float) -> tuple[float, float]:
    """Kernel-path logits (B, 1, V) against the plain path's, within ``tol``
    of the largest; then the greedy tokens.  Random weights leave near-ties among
    the top logits, which bf16 rounding may order either way (one row in four
    flipped in an earlier run), so a row may pick another token than the
    plain path only if that token's plain logit is within twice the row's
    measured error of the plain maximum; any other disagreement fails."""
    d = (got - want).abs()
    err = d.max().item()
    scale = max(1.0, want.abs().max().item())
    expect(bool(torch.isfinite(got).all()) and err <= tol * scale,
           f"{what} logits {tuple(got.shape)}, kernel path vs plain path: max_abs={err:.3e} "
           f"(tol {tol} x {scale:.2f})")
    tk, tp = got.argmax(-1), want.argmax(-1)
    row_err = d.amax(-1)
    gap = want.amax(-1) - want.gather(-1, tk.unsqueeze(-1)).squeeze(-1)
    same = tk == tp
    expect(bool((same | (gap <= 2 * row_err)).all()),
           f"{what} greedy tokens: {int(same.sum())} of {same.numel()} rows identical, the rest "
           f"near-ties (plain-logit gap {[round(g, 4) for g in gap[~same].tolist()]} <= 2 x row error)")
    return err, scale


def phase_small_reference(arch: str, **over) -> None:
    """SMOKE config in fp32 (with the ArchConfig overrides ``over``, e.g. a
    tied head): the card (kernels) against the port's CPU path, which
    tests/test_torch_serve.py, tests/test_torch_moe.py and the other
    tests/test_torch_*.py hold against the JAX package."""
    cfg = dataclasses.replace(configs.get_smoke(arch), dtype="float32", **over)
    label = arch + "".join(f" {k}={v}" for k, v in over.items())
    model = get_model(cfg)
    cpu = model.init(SEED, "cpu")
    gpu = tree_util.tree_map(lambda t: t.to("cuda"), cpu)
    out = {}
    for dev, params in (("cpu", cpu), ("cuda", gpu)):
        eng = ServeEngine(model, params, ServeConfig(max_len=40, batch=2), device=dev)
        b = make_batch(cfg, batch=2, seq=32, kind="prefill", seed=SEED, device=dev)
        with torch.no_grad():
            logits, _ = model.prefill(params, b, max_len=40)
        out[dev] = (logits.cpu(), eng.generate(b, 8).cpu())
    err = (out["cpu"][0] - out["cuda"][0]).abs().max().item()
    expect(err <= LOGITS_TOL_FP32,
           f"{label} SMOKE fp32 prefill logits, card vs CPU: max_abs={err:.3e} (tol {LOGITS_TOL_FP32})")
    expect(torch.equal(out["cpu"][1], out["cuda"][1]),
           f"{label} SMOKE fp32 8 greedy tokens, card vs CPU identical: {out['cuda'][1][0].tolist()}")


# ---------------------------------------------------------------------------
# Phase 3 (training): full-width internlm2-1.8b takes optimizer steps
# ---------------------------------------------------------------------------


def train_expected(cfg, forwards: int) -> tuple[dict, dict]:
    """K1's launches (by (M, K, N) and by path) of one training step over
    BATCH x PROMPT tokens with ``forwards`` forward passes (2 under remat):
    each projection's forward at (M, K, N), its dA at (M, N, K) with B = W^T
    (a row-major copy) and its dB at (K, M, N) with A = X^T (a copy), once
    per layer.  The untied head is a
    library product (no launch)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    m = BATCH * PROMPT
    shapes, paths = collections.Counter(), collections.Counter()
    for (k, n), c in projections(cfg).items():
        c *= cfg.n_layers
        shapes[(m, k, n)] += forwards * c
        paths[mm_kernel.gemm_path(m, n, k, BF16, True, sms)] += forwards * c
        shapes[(m, n, k)] += c
        paths[mm_kernel.gemm_path(m, k, n, BF16, True, sms)] += c
        shapes[(k, m, n)] += c
        paths[mm_kernel.gemm_path(k, n, m, BF16, True, sms)] += c
    return dict(shapes), dict(paths)


def check_train_launches(label: str, cfg, forwards: int) -> dict:
    """Exact launches of the step just run: K1 in all, per shape and per
    path; K3 once per layer and forward at the model's heads and (B, S, S);
    no K4 or K5."""
    shapes, paths = train_expected(cfg, forwards)
    got, routes = counts(), route_counts()
    n_flash = cfg.n_layers * forwards
    per_pass = sum(projections(cfg).values()) * cfg.n_layers
    expect(got == {"systolic_mmm": sum(shapes.values()), "systolic_qmm": 0, "flash_attn": n_flash, "grouped_mmm": 0},
           f"{label} launches exact: {got} (K1 {sum(shapes.values())} = {forwards} forward x {per_pass} + {per_pass} "
           f"dA + {per_pass} dB, K3 {n_flash})")
    expect(shape_counts()["systolic_mmm"] == shapes,
           f"{label} K1 launches per (M, K, N) exact: {listed({'systolic_mmm': shapes})}")
    expect(routes["systolic_mmm_paths"] == paths, f"{label} K1 launches per path exact: {routes['systolic_mmm_paths']}")
    heads = {(cfg.n_heads, cfg.n_kv_heads): n_flash}
    expect(routes["flash_attn_heads"] == heads and flash_shape_counts() == {(BATCH, PROMPT, PROMPT): n_flash},
           f"{label} K3 launches per heads and shape exact: {routes['flash_attn_heads']} {flash_shape_counts()}")
    return {"launches": got, "shapes": {"systolic_mmm": [[*s, c] for s, c in sorted(shapes.items())]},
            "flash_shapes": [[BATCH, PROMPT, PROMPT, n_flash]], "paths": routes["systolic_mmm_paths"]}


def leaf_gaps(got, want) -> list[tuple[float, str]]:
    """(||g - g_plain|| / ||g_plain||, leaf path) of every gradient leaf."""
    return [(((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30)).item(), key)
            for (key, a), (_, b) in zip(tree_util.leaves_with_path(got), tree_util.leaves_with_path(want))]


def train_gradient_gate(label: str, grads, metrics, plain_grads, plain_metrics) -> dict:
    loss, want = float(metrics["loss"]), float(plain_metrics["loss"])
    norm, want_norm = float(global_norm(grads)), float(global_norm(plain_grads))
    gaps = leaf_gaps(grads, plain_grads)
    worst = max(gaps)
    loss_gap, norm_gap = abs(loss - want) / abs(want), abs(norm - want_norm) / want_norm
    expect(math.isfinite(loss) and loss_gap <= TRAIN_LOSS_RTOL,
           f"{label} loss kernel vs plain: {loss:.6f} vs {want:.6f}, {loss_gap:.2e} relative (tol {TRAIN_LOSS_RTOL})")
    expect(math.isfinite(norm) and norm_gap <= TRAIN_NORM_RTOL,
           f"{label} gradient norm kernel vs plain: {norm:.6f} vs {want_norm:.6f}, {norm_gap:.2e} relative "
           f"(tol {TRAIN_NORM_RTOL})")
    expect(worst[0] <= TRAIN_LEAF_RTOL,
           f"{label} every gradient leaf within {TRAIN_LEAF_RTOL} of the plain path's norm: worst {worst[1]} "
           f"{worst[0]:.4f} (median {sorted(gaps)[len(gaps) // 2][0]:.4f}, {len(gaps)} leaves)")
    return {"loss": loss, "plain_loss": want, "grad_norm": norm, "plain_grad_norm": want_norm,
            "worst_leaf": worst[1], "worst_leaf_gap": worst[0], "median_leaf_gap": sorted(gaps)[len(gaps) // 2][0]}


def traced_train_step(trainer, batch) -> dict:
    """One Trainer step under torch.profiler: ``launch/trace.py``'s phase row
    (host wall, device busy, idle share, device kernels) and K1's device ms,
    forward and backward apart, and K3's.  A K1 kernel is the forward's when
    it runs inside the device span of ``make_grad_fn``'s ``train_forward``
    range; without that span (or with more than one) the split is printed
    as unresolved (None).  The kernels counted stand beside the times: a
    trace that dropped events shows it there."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("train_step"):
            trainer.run(iter([batch]), 1, log_every=0)
            torch.cuda.synchronize()
    events = prof.events()
    (row,) = trace_tools.phase_breakdown(events)
    ms = lambda es: sum((e.time_range.end - e.time_range.start) / 1e3 for e in es)
    work = trace_tools._device_work(events)
    k1 = [e for e in work if "mmm_" in e.name]
    spans = [(e.time_range.start, e.time_range.end) for e in events
             if e.device_type == DeviceType.CUDA and e.name == "train_forward"]
    split = dict(k1_forward_ms=None, k1_backward_ms=None, k1_forward_kernels=None, k1_backward_kernels=None)
    if len(spans) == 1:
        lo, hi = spans[0]
        fwd = [e for e in k1 if lo <= e.time_range.start < hi]
        bwd = [e for e in k1 if e.time_range.start >= hi]
        split = dict(k1_forward_ms=ms(fwd), k1_backward_ms=ms(bwd), k1_forward_kernels=len(fwd),
                     k1_backward_kernels=len(bwd))
    row.update(k1_kernels=len(k1), k1_ms=ms(k1), **split, forward_spans=len(spans),
               k3_ms=ms(e for e in work if "flash" in e.name), top=trace_tools.top_kernels(events, 8))
    return row


def train_checkpoint_roundtrip() -> None:
    """The checkpoint on the card at SMOKE size (full width would write
    ~30 GB): a Trainer writes every step, another from other weights
    resumes and holds the first one's parameters and moments bit for bit,
    each leaf back on the card in its dtype."""
    cfg = dataclasses.replace(configs.get_smoke(ARCH), dtype="float32")
    model = get_model(cfg)
    root = os.path.join(ROOT, "chiprun_out", "train_ckpt")
    shutil.rmtree(root, ignore_errors=True)
    try:
        tcfg = TrainConfig(peak_lr=1e-3, warmup_steps=1, total_steps=4, ckpt_dir=root, ckpt_every=1)
        batch = make_batch(cfg, batch=2, seq=16, kind="train", seed=SEED, device="cuda")
        first = Trainer(model, tcfg, model.init(SEED, "cuda", dtype=torch.float32))
        first.run(iter([batch] * 2), 2, log_every=0)
        second = Trainer(model, tcfg, model.init(SEED + 1, "cuda", dtype=torch.float32))
        resumed = second.try_resume()
        same = all(a.device.type == "cuda" and a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(
            tree_util.leaves({"p": second.params, "o": second.opt_state}),
            tree_util.leaves({"p": first.params, "o": first.opt_state})))
        expect(resumed and second.step == 2 and same and latest_step(root) == 2,
               f"SMOKE checkpoint round trip on the card: resumed at step {second.step}, parameters and moments "
               f"bit-identical, on the card, dtypes kept")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_train(smi: str) -> dict:
    """Full-width internlm2-1.8b with fp32 masters from SEED, computing in
    bf16: one step's gradients on the kernel path against the plain path on
    the card, exact launches of a step (and of a remat step), TRAIN_STEPS
    Trainer steps on one fixed batch, a traced step, the readings."""
    cfg = configs.get_config(ARCH)
    say(f"[3] train {ARCH} (full width: {cfg.n_layers}L d={cfg.d_model} H={cfg.n_heads}/{cfg.n_kv_heads} "
        f"d_ff={cfg.d_ff} V={cfg.vocab_size}), fp32 masters computing in {cfg.dtype}, batch {BATCH} x {PROMPT} "
        f"tokens, AdamW {TRAIN_TCFG}")
    model = get_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    params = model.init(SEED, "cuda", dtype=torch.float32)
    n = sum(t.numel() for t in tree_util.leaves(params))
    expect(n == model.n_params and all(t.dtype == torch.float32 for t in tree_util.leaves(params)),
           f"{ARCH} fp32 masters: {n:,} parameters = the config's count")
    batch = make_batch(cfg, batch=BATCH, seq=PROMPT, kind="train", seed=SEED, device="cuda")
    tcfg = TrainConfig(**TRAIN_TCFG)
    out: dict = {"arch": ARCH, "n_params": n, "nvidia_smi": smi}

    grads_of = make_grad_fn(model, tcfg)
    reset_counts()
    grads, metrics = grads_of(params, batch)
    torch.cuda.synchronize()
    out["step"] = check_train_launches("train step", cfg, 1)
    with plain_versions():
        plain_grads, plain_metrics = grads_of(params, batch)
    out["gate"] = train_gradient_gate("train step", grads, metrics, plain_grads, plain_metrics)
    del plain_grads
    reset_counts()
    remat_grads, remat_metrics = make_grad_fn(model, dataclasses.replace(tcfg, remat=True))(params, batch)
    torch.cuda.synchronize()
    out["remat_step"] = check_train_launches("remat step", cfg, 2)
    remat_gap = max(leaf_gaps(remat_grads, grads))
    expect(float(remat_metrics["loss"]) == float(metrics["loss"]) and remat_gap[0] <= TRAIN_LEAF_RTOL,
           f"remat step: the same loss, gradients within {TRAIN_LEAF_RTOL} of the step's (worst {remat_gap[1]} "
           f"{remat_gap[0]:.2e})")
    del grads, remat_grads

    start = [t.clone() for t in tree_util.leaves(params)]
    trainer = Trainer(model, tcfg, params)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, walls, norms, lrs = [], [], [], []
    # telemetry off and on by turns (odd steps on): the host cost of recording
    # the forward's K1 launches, which run outside any scope, read per arm
    reg = obs_metrics.get_registry()
    arm_ms, recorded, launched = {"off": [], "on": []}, {"off": 0.0, "on": 0.0}, {"off": 0, "on": 0}
    for i in range(TRAIN_STEPS):
        arm = "on" if i % 2 else "off"
        before, k1 = reg.counter_value("gemm.calls", backend="cuda-systolic", dtype="bfloat16"), mm_kernel.launches
        with telemetry(arm == "on"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = trainer.run(iter([batch]), 1, log_every=0)
            torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        recorded[arm] += reg.counter_value("gemm.calls", backend="cuda-systolic", dtype="bfloat16") - before
        launched[arm] += mm_kernel.launches - k1
        if i:
            arm_ms[arm].append(walls[-1])
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        lrs.append(float(m["lr"]))
    peak = torch.cuda.max_memory_allocated() / 1e9
    say(f"    {TRAIN_STEPS} steps on one batch: loss {[round(x, 4) for x in losses]}, grad norm "
        f"{[round(x, 3) for x in norms]}, lr {[f'{x:.3e}' for x in lrs]}, step ms {[round(x, 1) for x in walls]}")
    expect(all(map(math.isfinite, losses)) and losses[-1] < losses[0] and min(losses[2:]) < losses[1],
           f"the loss falls on the fixed batch: {losses[0]:.4f} -> {losses[-1]:.4f}")
    changed = [bool(torch.isfinite(p).all()) and not torch.equal(p, p0) for p, p0 in zip(tree_util.leaves(trainer.params), start)]
    expect(all(changed), f"every parameter finite and changed: {sum(changed)} of {len(changed)} leaves")
    expect(trainer.step == TRAIN_STEPS and int(trainer.opt_state.step) == TRAIN_STEPS and trainer.retries == 0,
           f"step counter {trainer.step}, optimizer step {int(trainer.opt_state.step)}, retries {trainer.retries}")
    del start
    fwd = cfg.n_layers * sum(projections(cfg).values())  # a step's forward K1 launches; the backward's go unrecorded
    expect(recorded["off"] == 0 and recorded["on"] == fwd * len(arm_ms["on"]),
           f"train steps with telemetry on recorded {recorded['on']:.0f} K1 launches (want {fwd} a step, the "
           f"forward's, of {launched['on']} launched), off {recorded['off']:.0f} of {launched['off']}")
    say(f"    train step ms ({smi}), steps 2-{TRAIN_STEPS} telemetry on and off by turns: off "
        f"{[round(x, 3) for x in arm_ms['off']]}, on {[round(x, 3) for x in arm_ms['on']]}; median off "
        f"{statistics.median(arm_ms['off']):.3f}, on {statistics.median(arm_ms['on']):.3f}")
    out["telemetry_ms"] = arm_ms
    step_ms = sorted(walls[1:])[len(walls[1:]) // 2]
    tokens = BATCH * PROMPT
    out.update(losses=losses, grad_norms=norms, lrs=lrs, step_ms=walls, step_ms_p50=step_ms,
               tokens_per_s=tokens / step_ms * 1e3, peak_gb=peak,
               model_flops_share=6 * n * tokens / (step_ms / 1e3) / H100.peak_flops("bfloat16"), retries=trainer.retries)
    row = traced_train_step(trainer, batch)
    out["trace"] = row
    steps = TRAIN_STEPS + 1
    shapes, _ = train_expected(cfg, 1)
    expect(counts() == {"systolic_mmm": sum(shapes.values()) * steps, "systolic_qmm": 0, "flash_attn": cfg.n_layers * steps,
                        "grouped_mmm": 0} and shape_counts()["systolic_mmm"] == {k: c * steps for k, c in shapes.items()},
           f"{steps} Trainer steps (the traced one included): launches exact, {counts()}")
    # every full-width kernel-path launch of the phase, for the kernels line
    total = collections.Counter()
    for run, times in ((out["step"], 1 + steps), (out["remat_step"], 1)):
        for *shp, c in run["shapes"]["systolic_mmm"]:
            total[tuple(shp)] += c * times
    out["shapes"] = {"systolic_mmm": [[*shp, c] for shp, c in sorted(total.items())]}
    out["flash_shapes"] = [[BATCH, PROMPT, PROMPT, cfg.n_layers * (1 + steps + 2)]]
    say(f"    train step (steady, p50 of steps 2-{TRAIN_STEPS}) {step_ms:.3f} ms, {out['tokens_per_s']:.1f} tokens/s, "
        f"peak device memory {peak:.2f} GB, 6 N tokens / step time / 989e12 = {out['model_flops_share']:.4f} "
        f"(for information); {smi}")
    if row["k1_forward_ms"] is None:
        k1_split = f"forward / backward unresolved ({row['forward_spans']} forward spans in the trace)"
    else:
        k1_split = (f"forward {row['k1_forward_kernels']} kernels {row['k1_forward_ms']:.3f} ms, backward "
                    f"{row['k1_backward_kernels']} kernels {row['k1_backward_ms']:.3f} ms")
    say(f"    traced step: {trace_row(row)}; K1 {row['k1_kernels']} of the step's {sum(shapes.values())} kernels in "
        f"the trace, {row['k1_ms']:.3f} ms: {k1_split}; K3 {row['k3_ms']:.3f} ms")
    for r in row["top"]:
        say(f"      {r['device_ms']:9.3f} ms  x{r['calls']:<5d} {r['kernel'][:100]}")
    del trainer, params, batch
    torch.cuda.empty_cache()
    train_checkpoint_roundtrip()
    # fp32 SMOKE gradients on the card (K1's FMA tiles, the fp32 flash
    # kernel with its lse) against the port's CPU path
    cfg32 = dataclasses.replace(configs.get_smoke(ARCH), dtype="float32")
    small = get_model(cfg32)
    cpu = small.init(SEED, "cpu", dtype=torch.float32)
    got = {}
    for dev, p in (("cpu", cpu), ("cuda", tree_util.tree_map(lambda t: t.to("cuda"), cpu))):
        b = make_batch(cfg32, batch=2, seq=32, kind="train", seed=SEED, device=dev)
        got[dev] = make_grad_fn(small, tcfg)(p, b)
    err = max(((a.cpu() - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
              for a, b in zip(tree_util.leaves(got["cuda"][0]), tree_util.leaves(got["cpu"][0])))
    expect(err <= TRAIN_FP32_TOL, f"{ARCH} SMOKE fp32 gradients, card vs CPU: worst leaf {err:.2e} of its largest "
                                  f"(tol {TRAIN_FP32_TOL})")
    return out


# ---------------------------------------------------------------------------
# Phase 4: timing and the kernels line
# ---------------------------------------------------------------------------


def _gemm_cost(m, k, n, out_dtype=BF16):
    """Operations and HBM bytes of one bf16 projection: each input read once,
    the output written once."""
    flops = 2 * m * n * k
    nbytes = (m * k + k * n) * dtype_bytes(BF16) + m * n * dtype_bytes(out_dtype)
    return flops, nbytes


def time_gemm(m, k, n, gen, out_dtype=BF16, tiles: bool = True, k_major: bool = False) -> dict:
    """Kernel, plain and library times of one bf16 projection.  Weights are
    cycled through enough copies to exceed the 50 MB L2, as the main path
    reads each layer's weights cold.  With ``tiles``, a shape on a wgmma path
    is also timed on each wgmma tile through the C entry (launches that no
    counter sees), for the path rule's record.  ``k_major``: B is the
    transpose of an (N, K) tensor, as the tied head's table (the library
    call then multiplies by the same transposed view)."""
    a = randn((m, k), gen, BF16)
    copies = max(1, math.ceil(150e6 / (k * n * dtype_bytes(BF16))))
    nxt = cycler([randn((n, k), gen, BF16).T if k_major else randn((k, n), gen, BF16) for _ in range(copies)])
    iters = 20 if m <= 16 else 10
    lib = (lambda: torch.mm(a, nxt(), out_dtype=torch.float32)) if out_dtype == torch.float32 \
        else (lambda: torch.matmul(a, nxt()))
    t = {
        "kernel": time_ms(lambda: mm_ops.matmul(a, nxt(), out_dtype=out_dtype), iters),
        "plain": time_ms(lambda: matmul_ref(a, nxt(), out_dtype=out_dtype), iters),
        "library": time_ms(lib, iters),
    }
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    path = mm_kernel.gemm_path(m, n, k, BF16, True, sms, k_major)
    by_path = {}
    if tiles and path.startswith("wgmma"):
        lib_, fn = mm_kernel._entry("systolic_mmm")
        out = torch.empty((m, n), dtype=out_dtype, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream

        def on(tile):
            code = fn(a.data_ptr(), nxt().data_ptr(), None, out.data_ptr(), m, n, k, mm_kernel.DTYPE_CODES[BF16],
                      mm_kernel.DTYPE_CODES[out_dtype], 0, mm_kernel.PATHS.index(tile), 0, None, 0, stream)
            _build.check(lib_, "systolic_mmm launch", code)

        by_path = {tile: time_ms(lambda: on(tile), iters) for tile, _, _ in mm_kernel.WGMMA_TILES}
    flops, nbytes = _gemm_cost(m, k, n, out_dtype)
    bound_s, bound_by = H100.bound_s(flops, nbytes, "bfloat16")
    return {"m": m, "k": k, "n": n, "out": str(out_dtype)[6:], "path": path, "ms": t["kernel"], "plain_ms": t["plain"],
            "library_ms": t["library"], "bound_ms": bound_s * 1e3, "bound_by": bound_by, "ms_by_path": by_path}


def _grouped_cost(k, n, c, rows):
    """Operations and HBM bytes one expert GEMM must move with each expert's
    rows that hold a token (``rows``, one count per expert): the weights of
    the experts that hold any, those rows of x read once, all of y written."""
    used = sum(rows)
    nbytes = (sum(1 for r in rows if r) * k * n + used * k + len(rows) * c * n) * dtype_bytes(BF16)
    return 2 * used * k * n, nbytes


def time_grouped(e, c, k, n, gen, patterns: list) -> dict:
    """Kernel, plain and library (torch.bmm, bf16 in and out) times of one
    expert GEMM over all C rows (the reference's work, the bound's too), the
    expert weights cycled through >= 150 MB of copies (one copy at the
    path's shapes, 403 MB), as the main path reads each layer's experts
    cold; then, apart (``routed_*``), the kernel given the model's rows:
    ``patterns``, one per MoE layer of the served run (recorded in phase 3),
    cycled with the weights (which tiles the kernel computes depends on the
    rows alone, not on x's values), with its own bound over the experts and
    rows it reads."""
    x = randn((e, c, k), gen, BF16)
    copies = max(1, math.ceil(150e6 / (e * k * n * dtype_bytes(BF16))))
    nxt = cycler([randn((e, k, n), gen, BF16) for _ in range(copies)])
    t = {
        "kernel": time_ms(lambda: grouped_ops.grouped_matmul(x, nxt()), 10),
        "plain": time_ms(lambda: grouped_matmul_ref(x, nxt()), 5),
        "library": time_ms(lambda: torch.bmm(x, nxt()), 10),
    }
    rows = cycler([torch.tensor(p, dtype=torch.int32, device="cuda") for p in patterns])
    t["routed"] = time_ms(lambda: grouped_ops.grouped_matmul(x, nxt(), rows=rows()), max(10, len(patterns)))
    flops, nbytes = _grouped_cost(k, n, c, [c] * e)
    bound_s, bound_by = H100.bound_s(flops, nbytes, "bfloat16")
    routed_bounds = [H100.bound_s(*_grouped_cost(k, n, c, p), "bfloat16") for p in patterns]
    routed_bound_s = sum(b for b, _ in routed_bounds) / len(routed_bounds)
    return {"e": e, "c": c, "k": k, "n": n, "path": grouped_kernel.grouped_path(c, k, n, BF16, True),
            "ms": t["kernel"], "plain_ms": t["plain"], "library_ms": t["library"],
            "bound_ms": bound_s * 1e3, "bound_by": bound_by,
            "experts_with_tokens": sum(sum(1 for r in p if r) for p in patterns) / len(patterns),
            "rows_with_tokens": sum(sum(p) for p in patterns) / len(patterns),
            "routed_ms": t["routed"], "routed_bound_ms": routed_bound_s * 1e3, "routed_bound_by": routed_bounds[0][1]}


def time_flash(gen, cfg, b: int = BATCH, s: int = PROMPT) -> dict:
    """Flash attention as the model calls it: q (B, S, H, D) and k, v (B, S,
    Hkv, D), handed over as (B, H, S, D) views; the plain version repeats
    K/V; SDPA (the yardstick) takes the same views with enable_gqa.  The
    bound reads K and V at Hkv heads."""
    h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = randn((b, s, h, d), gen, BF16).transpose(1, 2)
    k, v = (randn((b, s, hkv, d), gen, BF16).transpose(1, 2) for _ in range(2))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    kw = dict(scale=d**-0.5, causal=True, window=None, kv_valid=s)
    t = {
        "kernel": time_ms(lambda: attn_ops.flash_attention(q, k, v, causal=True), 20),
        "plain": time_ms(lambda: flash_attention_call_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                                          **kw), 10),
        "library": time_ms(lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True), 20),
    }
    pairs = s * (s + 1) // 2  # causal: the (q, k) pairs this run's mask keeps
    flops = 4 * b * h * pairs * d
    nbytes = 2 * b * s * (h + hkv) * d * dtype_bytes(BF16)  # q and k, v read, o written
    bound_s, bound_by = H100.bound_s(flops, nbytes, "bfloat16")
    return {"b": b, "h": h, "hkv": hkv, "s": s, "d": d, "ms": t["kernel"], "plain_ms": t["plain"],
            "library_ms": t["library"], "bound_ms": bound_s * 1e3, "bound_by": bound_by}


def time_chunk_attention(gen, cfg, offset: int, chunk: int = LONG_CHUNK, cache: int | None = None) -> dict:
    """What one chunk pays for attention on the chunked path: the plain
    ``_sdpa`` of ``attention.gqa_prefill_chunk`` (no kernel: the reference
    computes chunk attention outside Pallas too) for a chunk of ``chunk``
    queries at ``offset`` against a cache of ``cache`` slots (default: the
    long-prompt run's max_len) under the decode mask, beside SDPA with the
    same boolean mask and ``enable_gqa``.  The bound counts the (q, k) pairs
    the mask keeps, q and the whole cache's K and V read once, o written."""
    h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    size = cache or LONG_TRACE["long_prompt"] + LONG_TRACE["long_gen"]
    q = randn((1, chunk, h, d), gen, BF16)
    k, v = (randn((1, size, hkv, d), gen, BF16) for _ in range(2))
    qpos = torch.arange(chunk, device="cuda") + offset
    kpos = torch.arange(size, device="cuda")
    kpos = torch.where(kpos < offset + chunk, kpos, -1)  # the slots this prompt has written so far
    valid = (kpos[None, None, :] >= 0) & (kpos[None, None, :] <= qpos[None, :, None])
    sdpa = torch.nn.functional.scaled_dot_product_attention
    t = {
        "plain": time_ms(lambda: attn_model._sdpa(q, k, v, valid, h // hkv), 10),
        "library": time_ms(lambda: sdpa(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                        attn_mask=valid[:, None], enable_gqa=True), 10),
    }
    pairs = int(valid.sum())
    flops = 4 * h * pairs * d
    nbytes = (2 * chunk * h + 2 * size * hkv) * d * dtype_bytes(BF16)
    bound_s, bound_by = H100.bound_s(flops, nbytes, "bfloat16")
    return {"chunk": chunk, "offset": offset, "cache": size, "h": h, "hkv": hkv, "d": d, "plain_ms": t["plain"],
            "library_ms": t["library"], "bound_ms": bound_s * 1e3, "bound_by": bound_by, "pairs": pairs}


def time_paged_pool(gen) -> dict:
    """The paged pool's page gather (what ``pool.cache`` materialises before
    every decode step) and scatter (``pool.cache = ...`` after it) at the
    paged arms' arena -- 8 slots x 262 pages of 16 rows x 24 layers of
    internlm2-1.8b, every slot's pages mapped, the page index on the card --
    with CUDA events.  Plain PyTorch (``index_select`` / ``index_copy_`` per
    cache tensor), as the reference computes them outside any kernel.  The
    bound moves the slots' 3.3 GB once each way (pages read and the logical
    cache written, or back); a contiguous ``copy_`` of the same tensors is
    the yardstick."""
    pool = PagedKVPool(get_model(configs.get_config(ARCH)), PAGED_SLOTS, PAGED_MAX_LEN, page_size=PAGE_SIZE,
                       device="cuda")
    for slot in range(PAGED_SLOTS):
        pool.prepare_write(pool.alloc(), 0, PAGED_MAX_LEN)
    for t in tree_util.leaves(pool.phys):
        if t.is_floating_point():
            t.copy_(randn(t.shape, gen, t.dtype))
    idx = pool._idx()
    logical = _gather_pages(pool.phys, idx, pool.seq_len, PAGE_SIZE)
    dst = tree_util.tree_map(torch.empty_like, logical)
    pairs = list(zip(tree_util.leaves(dst), tree_util.leaves(logical)))

    def copy():
        for a, b in pairs:
            a.copy_(b)

    t = {"gather": time_ms(lambda: _gather_pages(pool.phys, idx, pool.seq_len, PAGE_SIZE), 10),
         "scatter": time_ms(lambda: _scatter_pages(pool.phys, logical, idx, pool.seq_len, PAGE_SIZE), 10),
         "copy": time_ms(copy, 10)}
    nbytes = 2 * _nbytes(logical)  # read once, written once
    bound_s, bound_by = H100.bound_s(0, nbytes, "bfloat16")
    out = {"slots": PAGED_SLOTS, "pages": pool.n_pages, "page_size": PAGE_SIZE, "layers": len(pool.phys["layers"]),
           "logical_bytes": _nbytes(logical), "gather_ms": t["gather"], "scatter_ms": t["scatter"],
           "copy_ms": t["copy"], "bound_ms": bound_s * 1e3, "bound_by": bound_by}
    del pool, logical, dst, pairs
    torch.cuda.empty_cache()
    return out


def _qgemm_cost(m, k, n, qk=quant.DEFAULT_BLOCK_K):
    """Operations and HBM bytes of one w8a8 projection: int8 values and fp32
    per-row / per-column scales read once, the bf16 output written once."""
    kb = -(-k // qk)
    nbytes = m * k + k * n + 4 * (m * kb + kb * n) + m * n * dtype_bytes(BF16)
    return 2 * m * n * k, nbytes


def time_qgemm(m, k, n, gen) -> dict:
    """Kernel and plain times of one w8a8 projection (int8, 128-k scale
    blocks, bf16 out, the weights K-major as served), weights cycled through
    >= 150 MB of copies as in time_gemm.  No PyTorch call computes a product
    scaled per k block, so library_ms is null.  For information only: the
    same kernel with one scale block over all of K (one retire instead of
    one per 128 k), K1 (the bf16 systolic GEMM) at the same shape, and two
    other functions, torch._int_mm (int8 -> int32, no scales; it refuses
    M <= 16) and the bf16 torch.matmul of the same shape."""
    qa = quant.quantize_act(randn((m, k), gen, torch.float32))
    qbs = [quant.quantize_weight(randn((k, n), gen, torch.float32)) for _ in range(math.ceil(150e6 / (k * n)))]
    qbs = [quant.k_major({"w": qb})["w"] for qb in qbs]
    nxt = cycler(qbs)
    iters = 20 if m <= 16 else 10
    t = {
        "kernel": time_ms(lambda: mm_ops.quant_matmul(qa, nxt(), out_dtype=BF16), iters),
        "plain": time_ms(lambda: quant_matmul_ref(qa, nxt(), out_dtype=BF16), iters),
    }
    qa0 = quant.quantize(qa.dequantize(), block=(1, 0))
    nxt0 = cycler([quant.k_major({"w": quant.quantize(qb.dequantize(), block=(0, 1))})["w"] for qb in qbs])
    t["whole_k"] = time_ms(lambda: mm_ops.quant_matmul(qa0, nxt0(), out_dtype=BF16), iters)
    a16 = randn((m, k), gen, BF16)
    nxt16 = cycler([randn((k, n), gen, BF16) for _ in range(math.ceil(150e6 / (2 * k * n)))])
    t["k1_bf16"] = time_ms(lambda: mm_ops.matmul(a16, nxt16()), iters)
    t["bf16_matmul"] = time_ms(lambda: torch.matmul(a16, nxt16()), iters)
    t["int_mm"] = time_ms(lambda: torch._int_mm(qa.values, nxt().values), iters) if m > 16 else None
    flops, nbytes = _qgemm_cost(m, k, n)
    bound_s, bound_by = H100.bound_s(flops, nbytes, "int8")
    path = mm_kernel.qgemm_path(m, n, k, quant.DEFAULT_BLOCK_K, torch.int8, True)
    return {"m": m, "k": k, "n": n, "path": path, "ms": t["kernel"], "plain_ms": t["plain"], "library_ms": None,
            "info_int_mm_ms": t["int_mm"], "info_bf16_matmul_ms": t["bf16_matmul"], "info_k1_bf16_ms": t["k1_bf16"],
            "info_whole_k_scales_ms": t["whole_k"],
            "bound_ms": bound_s * 1e3, "bound_by": bound_by}


def time_gemm_bias(m, k, n, gen) -> dict:
    """The bias epilogue (TPU kernel _mmm_bias_kernel) at one stated shape:
    bf16, fp32 bias, no activation; torch.addmm is the one PyTorch call that
    computes the same function.  The main path passes no bias."""
    a = randn((m, k), gen, BF16)
    copies = max(1, math.ceil(150e6 / (k * n * dtype_bytes(BF16))))
    nxt = cycler([randn((k, n), gen, BF16) for _ in range(copies)])
    bias = randn((n,), gen, torch.float32)
    bias16 = bias.to(BF16)
    t = {
        "kernel": time_ms(lambda: mm_ops.matmul(a, nxt(), bias), 10),
        "plain": time_ms(lambda: matmul_ref(a, nxt(), bias), 10),
        "library": time_ms(lambda: torch.addmm(bias16, a, nxt()), 10),
    }
    flops, nbytes = _gemm_cost(m, k, n)
    bound_s, bound_by = H100.bound_s(flops + m * n, nbytes + 4 * n, "bfloat16")
    return {"m": m, "k": k, "n": n, "ms": t["kernel"], "plain_ms": t["plain"], "library_ms": t["library"],
            "bound_ms": bound_s * 1e3, "bound_by": bound_by, "launches": 0}


def time_train(gen, cfg) -> tuple[list[dict], dict]:
    """The training step's kernels at its shapes: for each projection (K, N)
    at M = BATCH x PROMPT, K1's dA = dC W^T at (M, N, K) with W^T read
    K-major in place and with W^T copied row-major (the kernel apart from the
    copy, and the copy), and dB = X^T dC at (K, M, N) (the kernel, and the
    copy of X^T); each beside its bound, its plain version and the library
    call on the same views (``torch.matmul``).  Weights are cycled through
    >= 150 MB of copies, as the step reads each layer's cold.  K3 at the
    step's shape with and without its lse output, beside SDPA, and the
    plain block backward (``attention._flash_bwd``) beside SDPA's
    forward + backward."""
    m = BATCH * PROMPT
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for k, n in projections(cfg):
        x, dc = randn((m, k), gen, BF16), randn((m, n), gen, BF16)
        copies = max(1, math.ceil(150e6 / (k * n * dtype_bytes(BF16))))
        ws = cycler([randn((k, n), gen, BF16) for _ in range(copies)])
        wts = cycler([randn((n, k), gen, BF16) for _ in range(copies)])  # W^T already row-major
        xt = x.t().contiguous()
        r = {"m": m, "k": k, "n": n,
             "da_path": mm_kernel.gemm_path(m, k, n, BF16, True, sms),
             "da_kmajor_path": mm_kernel.gemm_path(m, k, n, BF16, True, sms, k_major=True),
             "db_path": mm_kernel.gemm_path(k, n, m, BF16, True, sms),
             "da_ms": time_ms(lambda: mm_ops._matmul(dc, wts(), out_dtype=BF16), 10),
             "da_kmajor_ms": time_ms(lambda: mm_ops._matmul(dc, ws().t(), out_dtype=BF16), 10),
             "da_copy_ms": time_ms(lambda: ws().t().contiguous(), 10),
             "db_ms": time_ms(lambda: mm_ops._matmul(xt, dc, out_dtype=BF16), 10),
             "db_copy_ms": time_ms(lambda: x.t().contiguous(), 10),
             "da_plain_ms": time_ms(lambda: matmul_ref(dc, ws().t(), out_dtype=BF16), 5),
             "db_plain_ms": time_ms(lambda: matmul_ref(x.t(), dc, out_dtype=BF16), 5),
             "da_library_ms": time_ms(lambda: torch.matmul(dc, ws().t()), 10),
             "db_library_ms": time_ms(lambda: torch.matmul(x.t(), dc), 10)}
        for side, (mm_, kk, nn) in (("da", (m, n, k)), ("db", (k, m, n))):
            bound_s, by = H100.bound_s(*_gemm_cost(mm_, kk, nn), "bfloat16")
            r[f"{side}_bound_ms"], r[f"{side}_bound_by"] = bound_s * 1e3, by
        rows.append(r)
        say(f"    train K1 (K={k}, N={n}) dA (M={m}, K={n}, N={k}): {r['da_path']} {r['da_ms']:.4f} + W^T copy "
            f"{r['da_copy_ms']:.4f}; K-major {r['da_kmajor_path']} {r['da_kmajor_ms']:.4f}; plain {r['da_plain_ms']:.4f}  "
            f"torch.matmul {r['da_library_ms']:.4f}  bound {r['da_bound_ms']:.4f} ({r['da_bound_by']}) | dB (M={k}, "
            f"K={m}, N={n}): {r['db_path']} {r['db_ms']:.4f} + X^T copy {r['db_copy_ms']:.4f}; plain "
            f"{r['db_plain_ms']:.4f}  torch.matmul {r['db_library_ms']:.4f}  bound {r['db_bound_ms']:.4f} "
            f"({r['db_bound_by']})")
    h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = randn((BATCH, PROMPT, h, d), gen, BF16)
    kk, vv, do = randn((BATCH, PROMPT, hkv, d), gen, BF16), randn((BATCH, PROMPT, hkv, d), gen, BF16), \
        randn((BATCH, PROMPT, h, d), gen, BF16)
    kw = dict(scale=d**-0.5, causal=True, window=None, kv_valid=PROMPT)
    o, lse = attn_kernel.flash_attention_call(q, kk, vv, return_lse=True, **kw)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qs, ks, vs = (t.transpose(1, 2) for t in (q, kk, vv))
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (qs, ks, vs))

    def sdpa_fwd_bwd():
        sdpa(qg, kg, vg, is_causal=True, enable_gqa=True).backward(do.transpose(1, 2))

    bwd = dict(causal=True, window=None, scale=d**-0.5, bq=512, bkv=1024)
    fl = {"b": BATCH, "h": h, "hkv": hkv, "s": PROMPT, "d": d,
          "ms": time_ms(lambda: attn_kernel.flash_attention_call(q, kk, vv, return_lse=True, **kw), 20),
          "no_lse_ms": time_ms(lambda: attn_kernel.flash_attention_call(q, kk, vv, **kw), 20),
          "plain_ms": time_ms(lambda: flash_attention_call_ref(q, kk, vv, return_lse=True, **kw), 10),
          "library_ms": time_ms(lambda: sdpa(qs, ks, vs, is_causal=True, enable_gqa=True), 20),
          "backward_plain_ms": time_ms(lambda: attn_model._flash_bwd(q, kk, vv, o, lse, do, **bwd), 5),
          "sdpa_fwd_bwd_ms": time_ms(sdpa_fwd_bwd, 10)}
    pairs = PROMPT * (PROMPT + 1) // 2
    nbytes = 2 * BATCH * PROMPT * (h + hkv) * d * dtype_bytes(BF16) + 4 * BATCH * h * PROMPT  # + the lse
    bound_s, fl["bound_by"] = H100.bound_s(4 * BATCH * h * pairs * d, nbytes, "bfloat16")
    fl["bound_ms"] = bound_s * 1e3
    say(f"    train K3 B={BATCH} H={h}/{hkv} S={PROMPT} D={d} causal with lse {fl['ms']:.4f} (without {fl['no_lse_ms']:.4f})"
        f"  plain {fl['plain_ms']:.4f}  sdpa(enable_gqa) {fl['library_ms']:.4f}  bound {fl['bound_ms']:.4f} "
        f"({fl['bound_by']}); the plain block backward {fl['backward_plain_ms']:.4f}, SDPA forward + backward "
        f"{fl['sdpa_fwd_bwd_ms']:.4f}")
    return rows, fl


def _merged(paths: list, kernel: str) -> dict:
    """shape -> launches of ``kernel`` over prefill and decode of every path
    (a continuous run lists its launches under "shapes")."""
    out = collections.Counter()
    for r in paths:
        for phase in ("prefill_shapes", "decode_shapes", "shapes"):
            for *shape, c in r.get(phase, {}).get(kernel, []):
                out[tuple(shape)] += c
    return dict(out)


def phase_timing(errs: dict, sync_fp: list, sync_w8a8: list, moe_runs: list,
                 served: list, train: dict) -> tuple[list[dict], dict, list, dict, dict]:
    """``sync_fp``: the synchronized bf16 paths (internlm2, the MoE model's
    main path, minicpm3); ``sync_w8a8``: the synchronized w8a8 paths
    (internlm2, minicpm3, the MoE model); ``moe_runs``: the MoE model's bf16
    and w8a8 paths (the grouped GEMM's launches and flash launches at its
    heads); ``served``: the continuous-style runs (the continuous, kv8 and
    long-prompt runs of internlm2, minicpm3's continuous and chunked runs),
    whose launches count with the synchronized paths'; the paged arms and
    minicpm3's paged run too).  The recurrent models' synchronized paths
    come in ``sync_fp``, xlstm-125m's continuous runs in ``served``; so do
    the frontend models' (musicgen-medium's and internvl2-1b's synchronized
    paths in ``sync_fp``; internvl2-1b's continuous run and the tied check
    in ``served``).  ``train``: the training phase's full-width kernel-path
    launches (K1 at its forward, dA and dB shapes; K3 with its lse output,
    timed so)."""
    say("[4] kernel times at the served paths' shapes (CUDA events; ms per call)")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    moe_r = moe_runs[0]
    shapes = []
    synchronized = _merged(sync_fp, "systolic_mmm")
    tied = tied_head(dataclasses.replace(configs.get_config(VLM_ARCH), tie_embeddings=True))
    for (m, k, n), n_calls in _merged([*sync_fp, *sync_w8a8, *served, train], "systolic_mmm").items():
        # each wgmma tile timed at the synchronized paths' shapes only; the
        # tied head's table K-major, fp32 out
        k_major = (k, n) == tied
        r = time_gemm(m, k, n, gen, torch.float32 if k_major else timed_out_dtype(k, n),
                      tiles=(m, k, n) in synchronized, k_major=k_major)
        r["launches"] = n_calls  # as counted at the launch site on the served paths
        shapes.append(r)
        tiles = "".join(f"  {p[6:]} {t:.4f}" for p, t in r["ms_by_path"].items())
        say(f"    systolic_mmm M={m:<5d} K={k:<5d} N={n:<5d} out={r['out']:8s} x{r['launches']:<5d} "
            f"{r['path']:13s} kernel {r['ms']:.4f}  plain {r['plain_ms']:.4f}  torch.matmul {r['library_ms']:.4f}  "
            f"bound {r['bound_ms']:.4f} ({r['bound_by']})" + (f"  [each wgmma tile:{tiles}]" if tiles else ""))
    qshapes = []
    for (m, k, n), n_calls in _merged(sync_w8a8, "systolic_qmm").items():
        r = time_qgemm(m, k, n, gen)
        r["launches"] = n_calls
        qshapes.append(r)
        int_mm = "n/a" if r["info_int_mm_ms"] is None else f"{r['info_int_mm_ms']:.4f}"
        say(f"    systolic_qmm M={m:<5d} K={k:<5d} N={n:<5d} x{r['launches']:<5d} {r['path']:6s} kernel {r['ms']:.4f}  "
            f"plain {r['plain_ms']:.4f}  library null  bound {r['bound_ms']:.4f} ({r['bound_by']})  "
            f"[info: whole-K scales {r['info_whole_k_scales_ms']:.4f}; K1 bf16 {r['info_k1_bf16_ms']:.4f}; other "
            f"functions: torch._int_mm {int_mm}, bf16 torch.matmul {r['info_bf16_matmul_ms']:.4f}]")
    gshapes = []
    for (e, c, k, n), n_calls in _merged(moe_runs, "grouped_mmm").items():
        patterns = moe_r["prefill_rows"] if c > grouped_kernel.DECODE_MAX_M else moe_r["decode_rows"]
        r = time_grouped(e, c, k, n, gen, patterns)
        r["launches"] = n_calls
        gshapes.append(r)
        say(f"    grouped_mmm E={e:<4d} C={c:<4d} K={k:<5d} N={n:<5d} x{r['launches']:<5d} {r['path']:13s} all rows: "
            f"kernel {r['ms']:.4f}  plain {r['plain_ms']:.4f}  torch.bmm {r['library_ms']:.4f}  bound "
            f"{r['bound_ms']:.4f} ({r['bound_by']}); the model's rows ({r['experts_with_tokens']:.1f} "
            f"experts, {r['rows_with_tokens']:.1f} rows with tokens, mean of {len(patterns)} layers): kernel "
            f"{r['routed_ms']:.4f}  bound {r['routed_bound_ms']:.4f} ({r['routed_bound_by']})")
    k2 = time_gemm_bias(BATCH * PROMPT, 2048, 8192, gen)
    say(f"    systolic_mmm + bias (K2) M={k2['m']} K={k2['k']} N={k2['n']} x0 (not on the main path) "
        f"kernel {k2['ms']:.4f}  plain {k2['plain_ms']:.4f}  torch.addmm {k2['library_ms']:.4f}  "
        f"bound {k2['bound_ms']:.4f} ({k2['bound_by']})")
    flash = []
    # Flash launches are counted by head counts: each synchronized path's
    # prefill launches are at its model's (H, Hkv) (phase 3 checks them),
    # over BATCH x PROMPT; the served runs' also by (B, Sq, Skv) -- batch 1
    # at each prompt length, the tied check's BATCH x PROMPT --, each at its
    # model's heads (a run names its model under "arch"; the long-prompt and
    # paged runs are internlm2's).  MLA's paths and the recurrent ones make
    # no flash launch.
    dense_cfg = configs.get_config(ARCH)
    by_shape, served_shapes = collections.Counter(), collections.Counter()
    for r in (*sync_fp, *sync_w8a8):
        by_shape[(r["arch"], BATCH, PROMPT)] += r["prefill_launches"]["flash_attn"]
    for r in served:
        for b, sq, _, n_calls in r["flash_shapes"]:
            served_shapes[(r.get("arch", ARCH), b, sq)] += n_calls
    by_shape.update(dict(sorted(served_shapes.items())))
    runs = [(configs.get_config(arch), b, sq, n_calls) for (arch, b, sq), n_calls in by_shape.items() if n_calls]
    # zamba2's shared attention (D = 112): no served launch (its prefill is
    # decode steps, whose attention is plain); forward reaches it once per
    # application, as in phase 3's forward check.
    hyb_cfg = configs.get_config(HYBRID_ARCH)
    runs += [(hyb_cfg, 1, PROMPT, 0), (hyb_cfg, BATCH, PROMPT, 0)]
    for cfg, b, sq, n_calls in runs:
        fl = time_flash(gen, cfg, b, sq)
        fl["launches"] = n_calls
        flash.append(fl)
        say(f"    flash_attn B={fl['b']} H={fl['h']}/{fl['hkv']} S={fl['s']} D={fl['d']} causal x{fl['launches']} "
            f"kernel {fl['ms']:.4f}  plain {fl['plain_ms']:.4f}  sdpa(enable_gqa) {fl['library_ms']:.4f}  "
            f"bound {fl['bound_ms']:.4f} ({fl['bound_by']})")

    train_rows, train_flash = time_train(gen, dense_cfg)
    train_flash["launches"] = train["flash_shapes"][0][-1]
    flash.append(train_flash)

    chunk_attn = [time_chunk_attention(gen, dense_cfg, off) for off in (0, LONG_TRACE["long_prompt"] - LONG_CHUNK)]
    # a prefix hit's suffix over the paged arms' slot cache
    chunk_attn.append(time_chunk_attention(gen, dense_cfg, PAGED_TRACE["prefix_len"], PAGED_TRACE["suffix_len"],
                                           PAGED_MAX_LEN))
    for r in chunk_attn:
        say(f"    chunk attention (plain _sdpa, no kernel: the reference's too) B=1 H={r['h']}/{r['hkv']} "
            f"chunk {r['chunk']} at offset {r['offset']} over a cache of {r['cache']} ({r['pairs']} (q, k) pairs "
            f"unmasked) plain {r['plain_ms']:.4f}  sdpa(mask, enable_gqa) {r['library_ms']:.4f}  bound "
            f"{r['bound_ms']:.4f} ({r['bound_by']})")
    paging = time_paged_pool(gen)
    say(f"    paged pool (plain index_select / index_copy_, no kernel: the reference's too) {paging['slots']} slots x "
        f"{paging['pages'] // paging['slots']} pages of {paging['page_size']} x {paging['layers']} layers, "
        f"{paging['logical_bytes']:,} logical bytes: gather {paging['gather_ms']:.4f}  scatter "
        f"{paging['scatter_ms']:.4f}  contiguous copy_ {paging['copy_ms']:.4f}  bound {paging['bound_ms']:.4f} "
        f"({paging['bound_by']})")

    def entry(name, rows):
        # Totals over every launch the served paths made (prefill + decode);
        # the grouped GEMM's also at the model's own rows, apart.
        keys = ("ms", "plain_ms", "bound_ms") + (("routed_ms", "routed_bound_ms") if "routed_ms" in rows[0] else ())
        tot = {key: sum(r[key] * r["launches"] for r in rows) for key in keys}
        lib = [r["library_ms"] for r in rows]
        by = {}
        for r in rows:
            by[r["bound_by"]] = by.get(r["bound_by"], 0.0) + r["bound_ms"] * r["launches"]
        src, replaces = SOURCES[name]
        return {"name": name, "route": "cuda", "source": src, "replaces": replaces,
                "launches": sum(r["launches"] for r in rows), "max_abs_err": errs[name], "ms": tot["ms"],
                "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
                "bound_by": max(by, key=by.get),
                "library_ms": None if None in lib else sum(x * r["launches"] for x, r in zip(lib, rows)),
                **{key: tot[key] for key in keys[3:]}, "shapes": rows}

    # Each kernel's launches are those of every served path that runs it: the
    # fp GEMM on the bf16 paths (synchronized, continuous, kv8, long-prompt,
    # chunked), on the MoE models' router and on minicpm3 w8a8's wkv_b; flash
    # attention on the GQA paths but the chunked runs; the block-scaled GEMM
    # on the w8a8 paths; the grouped GEMM on the MoE paths.
    return [entry("systolic_mmm", shapes), entry("flash_attn", flash), entry("systolic_qmm", qshapes),
            entry("grouped_mmm", gshapes)], k2, chunk_attn, paging, {"k1": train_rows, "k3": train_flash}


def main() -> int:
    ap = argparse.ArgumentParser(description="Drive the PyTorch port on one NVIDIA card.")
    ap.add_argument("--out", default=None, help="also write every number to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    global TUNE_DIR
    TUNE_DIR = tempfile.mkdtemp(prefix="chip_smoke_tune_")
    try:
        pin_cache(os.path.join(TUNE_DIR, "untuned.json"))
        return run(args)
    finally:
        shutil.rmtree(TUNE_DIR, ignore_errors=True)


def run(args) -> int:
    # The plain GEMMs are fp32 matmuls, which TF32 would round to ~3 digits:
    # they rely on PyTorch's default of full fp32.
    expect(not torch.backends.cuda.matmul.allow_tf32 and torch.get_float32_matmul_precision() == "highest",
           f"fp32 matmuls in full fp32 (allow_tf32={torch.backends.cuda.matmul.allow_tf32}, "
           f"precision={torch.get_float32_matmul_precision()})")
    t_start = time.perf_counter()
    walls = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        walls[name] = time.perf_counter() - t0
        say(f"    phase wall [{name}] {walls[name]:.1f} s")
        return out

    device = timed("device and build", phase_device)
    errs = timed("kernels vs plain", phase_kernels)
    bf16, w8a8, cont, kv8, long_runs, paged_runs = timed(f"serve {ARCH}", phase_serve, device["nvidia_smi"])
    timed(f"small reference {ARCH}", phase_small_reference, ARCH)
    mla_bf16, mla_w8a8, mla_cont, mla_chunked, mla_paged = timed(f"serve {MLA_ARCH}", phase_serve_mla,
                                                                  device["nvidia_smi"])
    timed(f"small reference {MLA_ARCH}", phase_small_reference, MLA_ARCH)
    moe_r, moe_w8a8 = timed(f"serve {MOE_ARCH}", phase_serve_moe)
    timed(f"small reference {MOE_ARCH}", phase_small_reference, MOE_ARCH)
    ssm_r, ssm_runs = timed(f"serve {SSM_ARCH}", phase_serve_recurrent, SSM_ARCH, device["nvidia_smi"])
    timed(f"small reference {SSM_ARCH}", phase_small_reference, SSM_ARCH)
    hyb_r, _ = timed(f"serve {HYBRID_ARCH}", phase_serve_recurrent, HYBRID_ARCH, device["nvidia_smi"])
    timed(f"small reference {HYBRID_ARCH}", phase_small_reference, HYBRID_ARCH)
    audio_r, _ = timed(f"serve {AUDIO_ARCH}", phase_serve_frontend, AUDIO_ARCH, device["nvidia_smi"])
    timed(f"small reference {AUDIO_ARCH}", phase_small_reference, AUDIO_ARCH)
    vlm_r, vlm_cont = timed(f"serve {VLM_ARCH}", phase_serve_frontend, VLM_ARCH, device["nvidia_smi"])
    timed(f"small reference {VLM_ARCH}", phase_small_reference, VLM_ARCH)
    tied_r = timed(f"tied {VLM_ARCH}", phase_tied, device["nvidia_smi"])
    timed(f"small reference {VLM_ARCH} tied", lambda: phase_small_reference(VLM_ARCH, tie_embeddings=True))
    train_r = timed(f"train {ARCH}", phase_train, device["nvidia_smi"])
    audit_r = timed("audit", phase_audit, device["nvidia_smi"])
    kernels, k2, chunk_attn, paging, train_t = timed("timing", phase_timing, errs,
                                            [bf16, moe_r, mla_bf16, ssm_r, hyb_r, audio_r, vlm_r],
                                            [w8a8, mla_w8a8, moe_w8a8], [moe_r, moe_w8a8],
                                            [cont, kv8, *bf16["obs"]["runs"], *long_runs, *paged_runs, mla_cont,
                                             mla_chunked, mla_paged, *ssm_runs, vlm_cont, tied_r], train_r)
    obs_launches = collections.Counter()
    for r in bf16["obs"]["runs"]:
        obs_launches.update(r["launches"])
    for e in kernels:
        e["launches_obs"] = obs_launches[e["name"]]  # of "launches": the obs phase's two runs
    say(f"    wall {time.perf_counter() - t_start:.1f} s")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"device": device, "serve": bf16, "serve_continuous": cont, "serve_kv8": kv8,
                       "serve_long_prompt": long_runs, "serve_w8a8": w8a8, "serve_moe": moe_r,
                       "serve_moe_w8a8": moe_w8a8, "serve_mla": mla_bf16, "serve_mla_w8a8": mla_w8a8,
                       "serve_mla_continuous": mla_cont, "serve_mla_chunked": mla_chunked,
                       "serve_mla_paged": mla_paged, "serve_paged": paged_runs, "serve_xlstm": ssm_r,
                       "serve_xlstm_continuous": ssm_runs, "serve_zamba2": hyb_r, "serve_musicgen": audio_r,
                       "serve_internvl2": vlm_r, "serve_internvl2_continuous": vlm_cont, "serve_tied": tied_r,
                       "train": train_r, "train_timing": train_t, "audit": audit_r,
                       "kernels": kernels,
                       "systolic_mmm_bias": k2, "chunk_attention": chunk_attn, "paged_pool": paging,
                       "phase_wall_s": walls,
                       "failures": failures}, f, indent=1)
    if failures:
        print(f"chip_smoke: {len(failures)} check(s) failed:", file=sys.stderr)
        for f_ in failures:
            print(f"  {f_}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": [{k: v for k, v in e.items() if k != "shapes"} for e in kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
