#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (qwen3_asr_rs_tpu_torch).

    python3 chip_smoke.py        # from the repository root, one CUDA GPU

Phases, each printing one JSON line; any failure raises and exits non-zero:

1. device  — requires CUDA; prints nvidia-smi's name and power limit.
2. build   — compiles every kernel of csrc/ with nvcc (sm_90a), in parallel.
3. kernels — each kernel against its plain PyTorch version on the same
             inputs at the 0.6B main-path shapes, max abs error against a
             stated tolerance, median CUDA-event time of both, its bound
             (bytes over 3.35 TB/s or FLOPs over 989 TFLOP/s, from the
             shapes) and, where one exists (all but K1), one PyTorch
             call's time on the same inputs (LIBRARY): K2, K1
             (bf16/f32 weights, and int8 merged, int4 merged, int8
             unmerged weights quantized by the port's own quantizer), K3,
             K4 (int4 lm_head at 1, 8 and 32 rows) and K5 (the int8
             prefill linears at the rows of the 30 s and 300 s clips and
             of the 5-clip batch, the same linears at an int8 serving
             step's 1 and 8 rows, a ragged shape, the lm_head at 1, 8, 16
             and 32 rows: each with its device time, its bound and two
             library calls, bf16 x element by element against the
             float64 product); then K1 at B = 2, 8, 32 with per-row
             starts (float weights, int8 merged at B = 8, int4 merged at
             B = 8 and 32), K1 and K2 on int8 slabs at B = 1 and 8, S =
             360 and 4992, and K3 at B = 2 with per-row kv_start and at
             the offline 32-clip batch's shapes (the audio tower's
             windows, empty ones among them; 32 right-aligned 432-slot
             prompts), held on the rows with a key, timed beside SDPA
             with the same masks and reported in the kernels line as
             ``main_path``; then K1
             with int4g weights at group sizes 128, 64 and 32 (B = 1 at
             S = 360 and 4992, B = 8 and 32, B = 1 and 8 on int8 slabs),
             K1 with the folded lm_head (bf16/f32 and int8 lm_head, B = 1
             and 8, and a constructed tie), K6 (decode_attention_slab and
             the single-layer decode_attention) on the JAX package's test
             cases and at S = 4992, K1's bf16 GEMV alone (gemv_single:
             every weight kind and epilogue at B = 1, 8 and 32; and the
             wgmma GEMV and the mma.sync GEMV, each forced, at the 1.7B
             and 0.6B shapes, two launches bit-equal), and K1's
             kernels per call in every weight layout (at most 6 per
             layer, counted by torch.profiler). K2 (B = 1, S = 360; B =
             8, S = 4992 on bf16 and int8 slabs), K3 (bf16 causal, B = 1
             and 2, and its main-path cases), K4 (bf16) and K6 (S = 4992) also report their device
             time from torch.profiler (device_ms), and so do their library
             calls (library_device_ms). Every bf16 case of K2, K3 and K6,
             and every GEMV case, is also held element by element
             (ELEMENT_TOL) against a float32 reference with the kernel's
             roundings. A yardstick for K1's GEMVs, one layer's seven
             products as torch.mm at B = 1, 8 and 32, is timed beside
             them, and the two GEMV routes alone and in a layer's order at
             the 1.7B shapes and B = 1, 8, 16, 32 beside torch.mm, the
             plain version and the bytes bound. The build phase counts the
             tensor-core instructions (HMMA, HGMMA) in the SASS of K3, K1,
             K4 and K5 and fails if a library has none (K5, and every
             instance of K1's wgmma GEMV: no HGMMA), and fails if a
             tensor-core kernel spills (or its wgmma is serialized). Last, the draw kernel (gumbel_argmax: JAX's
             threefry categorical, not a TPU kernel) against its plain
             version at B = 1, 8 and 32 x 151,936 and on half a 32-slot
             pool at its row offset (and at picked rows), three seeds and
             the engine's fold_in chains: bits and uniforms bit-equal,
             Gumbel noise within GUMBEL_ULPS, tokens equal but at stated
             near-ties (DRAW_TIE), a split chain's key and draw; times
             (CUDA events, device, plain) against the bytes bound.
4. main    — AsrEngine at full Qwen3-ASR-0.6B width (28 decoder + 18
             encoder layers, bf16, seeded synthetic weights) transcribes
             synthetic 4 s, 30 s and 300 s WAV files; then AsrEngine with
             quantize='int8' and 'int4g' (4 s, 30 s, 300 s), 'int4' (4 s,
             30 s), and on the 4 s clip quantize='lm8', the crossed
             lm_head widths (ASR_LM_BITS=4 under int8 and int4g, 8 under
             int4), int4g at ASR_INT4_GROUP=64, and ASR_FOLD_LM=1 with
             bf16 and with int8 weights. Each path runs with the launch
             counters set to 0, and they must show that it went through
             its kernels (and, folded, that no lm_head product ran outside
             K1 after the prefill).
5. batch   — AsrEngine.transcribe_batch at full width, bf16 weights:
             clips of 4, 8, 15, 22 and 30 s (B = 8, 3 born-done rows) with
             bf16 and with int8 KV, 32 clips of 4 s, 8 clips of 300 s with
             int8 KV, and the 4 s clip alone with int8 KV; then the five
             clips with int8 weights and int8 KV, with int4 weights, with
             int4g weights and with int4g weights and ASR_FOLD_LM=1;
             per run B, live rows, bucket, wall, aggregate xRT, tokens/s,
             prefill s, decode ms per step and the launch counts, which
             must show K1 once per step whatever B is, K2 once per layer
             and step, K3 once a layer of the audio tower's call and of
             the decoder prefill, and K4/K5 as the weights need them;
             then 32 clips
             twice: the wgmma GEMV's launch counter (gemv_wgmma, replays
             counted) 4 a layer and step, tokens equal over the two
             runs.
6. parity  — the 4 s clip teacher-forced in float32 at full width, with
             float, int8, int4 and int4g weights: the decode-kernel path
             against the plain per-layer path, per-step logits within a
             stated tolerance (int4g: and the folded step's token equal
             to the argmax of the plain logits); then a batch of 3 clips
             (4, 8, 15 s) with bf16 and with int8 KV, every live row's
             logits from the same slab state on both paths.
7. graphs  — the engine's decode loop (CUDA graphs replayed over device
             state) against the same step function run eagerly on the
             card, tokens equal, per step of both: wall, GPU elapsed
             (CUDA events around the loop) and busy ms (the union of the
             loop's kernel intervals in a torch.profiler run; eager only
             for bf16 at B = 1 and 8): bf16 at B = 1, 8 and 32 on the 4 s
             clip,
             int8 weights with the int8 KV slab at B = 8, ASR_FOLD_LM=1
             at B = 1; sampling (temperature 0.7, top-k 50, top-p 0.9) at
             B = 1 and 8, the same seed twice equal, graph equal to
             eager, another seed other tokens, top-k 1 equal to greedy up
             to a tie of the scaled logits (shown), with the sampled
             step's times, one draw per sampled step and at the prefill
             and none in a greedy run; the draw's bits on the card (the
             kernel) equal to the CPU's (the plain version) bit for bit;
             the segmented slab at B = 1 and 8
             (max_new_tokens 300: caps [256, 300], one grow copy, the
             second stage captured in the call, the first stage's slab
             released, tokens equal to one 300-token segment); and a 400
             s clip through transcribe (two overlapped decode segments in
             one B = 2 batch, stitched). Every run's launch counts hold
             with the replays counted. Phases 4-6 run the same graphs
             through the engine.
8. serving — the continuous batcher (runtime/serving.py: every slot at
             its own position, K2 at per-row ends, one CUDA graph per
             segment variant and precision) at full width: a float32
             pool of 4 slots on 4 / 8 / 15 s clips, tokens equal to the
             float32 offline engine's (where not, the step and both
             paths' top-2 logits, and a failure unless the two tokens'
             logits lie within SERVING_TIE); a float32 pool with
             serving_precision="auto" on 4 / 15 s clips, every segment
             int8, tokens equal (with the same tie rule) to offline
             decode steps over the pool's own int8 tree after the
             engine's prefill; bf16, 8 slots after
             warmup: a burst of 4 / 8 / 15 / 30 / 4 / 8 / 120 s clips
             (batched, chunked and segmented-encode admission) with a
             sampled request (T 0.7, top-p 0.9) submitted mid-flight,
             no capture during it, one draw per sampled step and one at
             the sampled admission; the 8-slot pool's steady step with
             every slot sampled; 16 and 32 slots of 4 s clips; an
             int8 KV pool; serving_precision="auto" (int8 segments with
             K5 at low occupancy); per run: latency p50/p95, aggregate
             xRT, tokens/s, ms per decode step (wall, GPU elapsed from
             CUDA events around each segment; in a steady window
             profiled on its own, GPU elapsed and busy over the same
             segments), admission GPU ms per kind, replays, captures,
             slab, kept and peak GiB, and launch counts (K2 28 per
             decode step, K1 never, K5 113 per int8 step, K3 in a bf16
             pool 18 per encoder call and 28 per one-pass admission
             prefill, from the pool's stats, none in float32; the kernels
             line gives each run's measured count per step); then an
             in-process HTTP server on 127.0.0.1 (/healthz,
             /transcribe, /v1/audio/transcriptions: text equal to the
             same request submitted directly). The kernels phase also
             holds K2 at distinct per-row ends (B = 8, S = 2048, one row
             at end 0, bf16 and int8 slabs) against its plain version,
             with device time and SDPA's over a mask.
9. streaming — runtime/streaming.py at full 0.6B width, bf16 (max_new
             128): the 30 s clip fed in 1 s updates (no update after the
             first encodes more than 2 windows; finalize() equals
             engine.transcribe_samples on the same buffer; the decode
             graph captured once, at the first decoding update; K1 once
             per re-decode step), a 40 s feed through 16 s sessions (at
             least one rollover; JAX's commit rule: each update's delta
             is the committed text past its old length, between
             rollovers the text changes only to a longer agreed prefix,
             at each rollover it is the stitched final hypothesis, and
             the updates that rewrote it are counted; no capture at the
             rollover), each with wall ms p50 / p95 per
             update, decoded tokens, replays and captures; and a float32
             session over 11 s in 2 s increments whose final hypothesis
             equals the float32 offline engine's (a difference fails
             unless the two tokens' logits tie within SERVING_TIE there,
             both paths teacher-forced, shown).
10. speculative — AsrEngine(speculative=..., spec_k=4) at full width,
             bf16: same-checkpoint drafts bf16 (self), int8, int4 and
             int4g on the 4 s and 30 s clips, tokens equal to
             plain greedy's, or each held against the plain K1 step
             teacher-forced on the run's tokens (its argmax, or a tie:
             within SERVING_TIE in float32, within twice the target
             width's SPEC_BF16_SPREAD in bf16, where the verify's logits
             must also lie within that bound of the step's at every
             position, as they must along each plain reference; shown
             with the first difference from plain greedy), graph equal
             to eager for the self-draft; a
             DraftBundle of the target's own weights (the cross-model
             path with its drafts accepted: tokens and counts equal to
             the self-draft's; then both slabs growing through two
             stages); an int8 target with the int8 KV slab and an int8
             draft against its own plain greedy (the verify attends its
             block's own K/V as stored, as JAX's does: where a token
             departs from plain greedy, its gap to the plain step's best
             there must be at most twice the run's largest |verify -
             step|; departures and that maximum reported); speculative
             sampling
             (T 0.7, top-p 0.9) on the self-draft: the same seed twice
             equal, graph equal to eager, another seed other tokens,
             top-k 1 held as greedy is, k + 2 draws and one set of
             acceptance uniforms per iteration; a float32 self-draft whose
             sampled drafts are all accepted; a 1.7B target
             (synthetic_17b_config) with the 0.6B model drafting, bf16
             and int8, held against the 1.7B plain step, and the 1.7B
             plain step at B = 1 (wall, GPU elapsed, busy ms). Per run: iterations, tokens, mean accepted
             drafts, ms per iteration and per emitted token (wall, GPU
             elapsed) against the plain loop's per token, launches per
             iteration (K1 k + 1 for the draft steps, K2 in each of the
             draft's layers, K5 per int8 verify linear and int8 draft
             lm_head, K4 per int4 draft lm_head; the prefills' taken off,
             K3 among them once a layer of each audio tower and decoder
             in bf16, checked exactly), the two slabs' GiB and the peak
             memory.
11. training — fine-tuning at full 0.6B width and depth: AsrDataset over
             eight ~28 s WAVs (30-chunk bucket, P = 544, a word-level
             stub tokenizer) through prefetch_to_device, then six
             float32 AdamW(1e-3) steps with remat at B = 8 on one batch
             (every loss finite, the last below the first; step time as
             the median of steps 2-6 by CUDA events, tokens/s, peak
             memory, the step's FLOPs from the shapes and their share of
             the float32 peak; no kernel launched); remat against no remat
             (loss and each leaf's gradient norm, rel 1e-5, B = 2); one
             bf16 SGD step (finite loss; the lm_head gradient of
             matmul_f32's CUDA backward against the float32 product of
             its bf16 operands, rtol 2^-8); save_checkpoint of the trained
             state, then AsrEngine(<dir>) on the card (tensors equal to
             the exported ones; one clip transcribed); forward_full on an
             int8 tree with an int4 lm_head against the plain versions
             (K5 and K4 launches counted exactly); a 2 + 2 layer model at
             the real widths, one AdamW step on the card and on the CPU
             from the same tree (B = 2, 4-chunk bucket; tolerances at
             CARD_CPU_*); and a checkpoint round trip of that card state
             (the next step's loss equal with and without it).
12. parallel — (a) a 1 x 1 mesh over NCCL in this process against no
             mesh: the 4 s and 30 s clips (bf16; tokens equal, K1 once
             per decode step, xRT of both), a ContinuousBatcher on 4 x
             4 s (tokens equal), one float32 train step (loss equal);
             (b) two ranks on cuda:0 over gloo (spawned; NCCL refuses
             two ranks on one card, scripts/nccl_two_ranks.py), every
             run at the full 0.6B width and depth: dp = 2 on the 5-clip
             batch with bf16 and int8 weights, tp = 2 on the 4 s clip in
             float32, bf16, int8 and blocked int4 (every token held to
             the one-device K1 step teacher-forced on the run's tokens:
             its argmax or within SERVING_TIE (float32) / twice
             SPEC_BF16_SPREAD (bf16); the bf16 |tp - one device| logit
             spread at every position of the tp run reported; tp runs
             decode PARALLEL_TP_TOKENS tokens: their steps run eagerly
             over gloo), a dp = 2 serving burst of 4 x 4 s, and float32
             train steps on dp = 2 (B = 2 a rank, unequal loss masks) and
             tp = 2 against the one-process step on the same 4 rows
             (CARD_CPU_* tolerances), a tp = 2 serving_precision="auto"
             burst of 2 x 4 s (PARALLEL_TP_TOKENS tokens, every segment
             on the int8 copy the batcher builds from each rank's pieces;
             tokens held to the one-device int8 engine's step by phase
             10's rule, K5 197 per int8 step per rank), and checkpoint
             round trips of an AdamW state at dp = 2 and tp = 2 on phase
             11's 2 + 2 layer model at the real widths (a full-depth
             state is ~11.3 GB on disk, so depth is cut there): the file
             holds whole tensors, written by the lead rank, save and
             restore seconds, the next step's loss equal with and
             without the round trip. Launches per rank are checked
             exactly (K1 once per step under dp, 0 under tp; K2 per layer
             and step; K5 per int8 linear and lm_head), collectives too:
             none in a dp rank's decode, 2 all-reduces per layer plus
             the embedding's and one all-gather per tp decode step, one
             all-gather per serving segment. The ranks share the card:
             their times are not scaling numbers. A rank's failure fails
             the phase.

13. routed — the routed decoder of benchmark/configs/kimi-vl-a3b-asr.json
             (not a TPU path: the JAX package runs no routed decoder), at
             its published widths and weight scale: K7 (the router's
             route, the grouping align and the expert products, CUDA
             csrc/moe_experts.cu) at a decode step's 64 rows and a
             64-clip prefill's 64 x 432 (a third of them prompt), K8's
             RMSNorm at 64 x 432 rows and its latent prologue, each
             against its plain version (ROUTED_* tolerances) with ms,
             plain ms, bound and a library yardstick; then a
             transcribe_batch of 64 clips through the routed decoder at
             ROUTED_LAYERS layers, its launch counters set to 0 just
             before it, K7 and K8 launched exactly as often as its
             forwards need (replays counted). ``python3 chip_smoke.py
             --only routed`` runs phases 1, 2 and 13 alone;
             ``--only gemv`` phases 1 and 2, then K1's bf16 GEMV checks
             and times of phase 3 and the wgmma counter run of phase 5.

Then a {"kernels": [...]} summary line (launches also per stream update
and per speculative iteration), the nvidia-smi line, and as the
last line {"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import wave
from pathlib import Path

REPO = Path(__file__).resolve().parent
SEED = 0

# Tolerances, kernel vs plain version on the same inputs: a case passes
# when max|kernel - plain| <= atol + rtol * max|plain|. float32: both sides
# compute in float32 and differ only in summation order. bf16: both round
# to bf16 at the same stages, but an order difference can flip a rounding
# (one bf16 ulp is 2^-8..2^-7 of the value): attention outputs may differ by
# two ulps of the largest value. The decode step carries such flips through
# 28 layers: over 8 input seeds x SLAB_CASES on an H100 its max|err| /
# max|plain| ran from 0.008 to 0.040, median 0.024
# (scripts/profile_torch_cuda.py, PERF.md); its bound is 2^-4.
TOL = {
    ("decode_attention_dma", "float32"): (2e-5, 0.0),
    ("decode_attention_dma", "bfloat16"): (2e-2, 2 ** -7),
    # K6 runs K2's device code: K2's tolerances
    ("decode_attention_slab", "float32"): (2e-5, 0.0),
    ("decode_attention_slab", "bfloat16"): (2e-2, 2 ** -7),
    ("decode_attention", "float32"): (2e-5, 0.0),
    ("decode_attention", "bfloat16"): (2e-2, 2 ** -7),
    ("decode_layers_fused", "float32"): (1e-4, 1e-5),
    ("decode_layers_fused", "bfloat16"): (1e-2, 2 ** -4),
    ("flash_attention", "float32"): (1e-4, 0.0),
    ("flash_attention", "bfloat16"): (2e-2, 2 ** -7),
    # K5 and K4: float32 sums of the same exact products in another order;
    # a bf16 output may flip one rounding (2^-8 of the value, at most)
    ("quant_matmul", "float32"): (1e-4, 1e-5),
    ("quant_matmul", "bfloat16"): (1e-4, 2 ** -7),
    ("quant_matmul", "bfloat16->float32"): (1e-4, 1e-5),
    ("quant_matvec_int4", "float32"): (1e-4, 1e-5),
    ("quant_matvec_int4", "bfloat16->float32"): (1e-4, 1e-5),
}
# The bf16 attention kernels are also held element by element, |kernel -
# ref| <= atol + rtol * |ref| at every compared element, against a float32
# reference that makes the kernel's roundings up to its output: K2 and K6
# (float32 inside, only the output rounds) against their plain version
# computed from float32 queries; K3 against flash_attention_tile_reference
# (P rounded to bf16 per 64-key tile). rtol 2^-8 is the output's own
# rounding; atol is summation order (K2, K6) and, for K3, the P entries
# whose bf16 rounding the kernel's and the reference's exponentials can
# flip (scripts/attention_check_strength.py measures both on the card and
# shows that this check fails kernels with a key tile or a slot dropped).
ELEMENT_TOL = {
    "decode_attention_dma": (2e-5, 2 ** -8),
    "decode_attention_slab": (2e-5, 2 ** -8),
    "decode_attention": (2e-5, 2 ** -8),
    "flash_attention": (2e-3, 2 ** -8),
    # K1's bf16 GEMV alone, against the float32 product with its scales and
    # the epilogue's roundings (plus their flips, gemv_single_reference's
    # slack): rtol 2^-8 is the output's rounding; atol the float32
    # summation order, the tensor cores' additions included (they may
    # truncate; the real kernel's largest excess on the H100 was 1e-7,
    # scripts/gemv_check_strength.py, where a dropped K split exceeds 0.5)
    "gemv_single": (1e-5, 2 ** -8),
    # K5 against the float64 product with its scales (k5_reference): rtol
    # the output's one rounding (bf16 2^-8, float32 1e-6), atol the float32
    # summation order (the real kernel's largest excess on the H100 was
    # 1.6e-6, scripts/k5_check_strength.py, where a dropped K stage or a
    # split partial added twice exceeds 0.7)
    ("quant_matmul", "bfloat16"): (1e-5, 2 ** -8),
    ("quant_matmul", "bfloat16->float32"): (1e-5, 1e-6),
}
# float32 teacher-forced logits, decode kernel vs plain per-layer path
PARITY_LOGITS_ATOL = 1e-3
# The folded lm_head: the kernel's token, scored by the plain fold
# arithmetic on the kernel's own final hidden state, lies within atol +
# rtol * max|logit| of the best plain logit. float32: summation order.
# bf16: the normed row rounds to bf16 after a factor summed in another
# order, which can flip a rounding (2^-8 of an element): 2^-7 of the
# largest logit allows it and bf16 near-ties.
FOLD_LOGIT_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-5, 2 ** -7)}
# The H100 SXM data sheet's rates: HBM bytes per second and dense bf16
# tensor-core operations per second (the bound of every kernel here:
# bf16 activations, whatever the weights' width)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 989e12

REPLACES = {
    "decode_layers_fused": "qwen3_asr_rs_tpu/ops/pallas/decode_layer.py:678",
    "decode_attention_dma": "qwen3_asr_rs_tpu/ops/pallas/decode_attention.py:413",
    "decode_attention_slab": "qwen3_asr_rs_tpu/ops/pallas/decode_attention.py:157",
    "flash_attention": "qwen3_asr_rs_tpu/ops/pallas/flash_attention.py:152",
    "quant_matmul": "qwen3_asr_rs_tpu/ops/pallas/quant_matmul.py:66",
    "quant_matvec_int4": "qwen3_asr_rs_tpu/ops/pallas/quant_matmul.py:351",
    "gumbel_argmax": "jax.random.categorical (XLA, no Pallas): "
                     "qwen3_asr_rs_tpu/runtime/sampling.py:141",
}
SOURCES = {
    "decode_layers_fused": "qwen3_asr_rs_tpu_torch/csrc/decode_layer.cu",
    "decode_attention_dma": "qwen3_asr_rs_tpu_torch/csrc/decode_attention.cuh",
    "decode_attention_slab": "qwen3_asr_rs_tpu_torch/csrc/decode_attention.cuh",
    "flash_attention": "qwen3_asr_rs_tpu_torch/csrc/flash_attention.cu",
    "quant_matmul": "qwen3_asr_rs_tpu_torch/csrc/quant_matmul.cu",
    "quant_matvec_int4": "qwen3_asr_rs_tpu_torch/csrc/quant_matvec_int4.cu",
    "gumbel_argmax": "qwen3_asr_rs_tpu_torch/csrc/gumbel_argmax.cu",
}
K1_COVERS = ("B=1..32 with per-row starts; bf16/f32 activations; bf16/f32, "
             "int8 and int4 weights, merged qkv|gate-up and per projection; "
             "int4g weights (merged; group sizes 32, 64 and multiples of "
             "128); bf16/f32 and int8 slabs; the folded lm_head (final "
             "RMSNorm, (V, H) bf16/f32 or int8 (H, V) lm_head, argmax with "
             "ties to the lowest index) returning token ids")
K6_CALLERS = ("no runtime caller in the JAX package: decode_attention_slab "
              "and decode_attention are called from "
              "tests/test_decode_attention.py and scripts/tpu_kernel_check.py "
              "only, so K6 has no main-path launches; its launches are the "
              "kernel phase's")
# the one PyTorch call each kernel's library_ms times on its headline case
# (never called on the port's path), or why there is none
_SDPA = "torch.nn.functional.scaled_dot_product_attention"
LIBRARY = {
    "decode_layers_fused": "none: no single PyTorch call computes a whole "
                           "28-layer decode step",
    "decode_attention_dma": f"{_SDPA}(enable_gqa=True) over the live slots "
                            "with the self K/V appended (the concatenation "
                            "untimed)",
    "decode_attention_slab": f"{_SDPA}(enable_gqa=True) over the live slots "
                             "with the self K/V appended (the concatenation "
                             "untimed)",
    "flash_attention": f"{_SDPA}(is_causal=True, enable_gqa=True) on (B, "
                       "heads, S, D) copies of the inputs (the transposes "
                       "untimed)",
    "quant_matmul": "torch._weight_int8pack_mm: x @ int8 W^T times "
                    "per-column scales, bf16 out (the (N, K) copy of the "
                    "weights and the bf16 scales made untimed); and "
                    "library_mm: torch.mm(x, W) on a copy of the weights "
                    "with the scales folded in, in x's dtype (made "
                    "untimed), the tensor-core yardstick",
    "quant_matvec_int4": "torch._weight_int4pack_mm (tinygemm): bf16 x @ "
                         "int4 W with a bf16 scale and zero per 256-row "
                         "group, K4's per-column scale repeated over the "
                         "groups, zero 0, bf16 out (the repacking into "
                         "tinygemm's layout untimed)",
    "gumbel_argmax": "none: no single PyTorch call computes a threefry "
                     "Gumbel-max draw (torch.multinomial draws from its own "
                     "Philox stream, not JAX's)",
}
# the draw kernel's checks: batch sizes at the full vocabulary, a pool of
# POOL_SLOTS slots of which a dp rank holds the second half, the fold_in
# chains (the engine's step, a speculative draft step, the accept's
# replacement draw); Gumbel noise within GUMBEL_ULPS units in the last
# place of max(1, |g|) of the plain version's (both take IEEE logf), tokens
# equal but where the two best values of logit + noise lie within
# DRAW_TIE * max(1, |best|)
DRAW_ROWS = (1, 8, 32)
POOL_SLOTS = 32
GUMBEL_ULPS = 4
DRAW_TIE = 1e-5
# K1 int4g checks: group sizes, (B, S, end, int8 slab)
K1_INT4G_GROUPS = (128, 64, 32)
K1_INT4G_CASES = ((1, 360, 217, False), (1, 4992, 4737, False),
                  (8, 360, 301, False), (32, 360, 301, False),
                  (1, 360, 301, True), (8, 360, 301, True))
# K6 checks: tests/test_decode_attention.py's cases, then the 300 s
# bucket's slab: (B, S, Hq, Hkv, D, starts, ends)
K6_CASES = ((1, 584, 16, 8, 128, None, [450]),
            (2, 304, 16, 8, 128, [0, 37], [296, 120]),
            (1, 64, 4, 2, 64, None, [64]),
            (3, 136, 8, 4, 128, [5, 0, 60], [100, 136, 61]),
            (1, 4992, 16, 8, 128, None, [4737]))
# K1 quantized layouts checked in phase 3: (label, bits, merge)
K1_QUANT = (("int8 merged", 8, True), ("int4 merged", 4, True),
            ("int8 unmerged", 8, False))
# K4's rows: one decode step, and batched steps of 8 and 32 rows
K4_ROWS = (1, 8, 32)
# K5's prefill rows (the 30 s prompt, the 5-clip batch's 8 x 432 and the
# 300 s prompt; float32 x at the first and last), its decode rows (an int8
# serving segment's step at 1 and 8 live slots: the GEMV blocks, split-K
# at K = 2048 and 3072), its four linears (K, N), a ragged shape (R, K, N:
# no tile, stage or 16-byte multiple) and the lm_head's rows (a decode
# step, batched steps of 8, 16 and 32 rows)
K5_ROWS = (432, 3456, 4736)
K5_DECODE_ROWS = (1, 8)
K5_ROWS_F32 = (432, 4736)
K5_LINEARS = (("qkv_w", 1024, 4096), ("o_w", 2048, 1024),
              ("gateup_w", 1024, 6144), ("down_w", 3072, 1024))
K5_RAGGED = (37, 600, 136)
K5_LM_ROWS = (1, 8, 16, 32)


# (S, start, end) of the decode kernels' checks: the 4 s bucket's slab and
# the 300 s bucket's (4736 prompt + 256), start 0 and > 0, ends at no block
# boundary
SLAB_CASES = ((360, 0, 217), (360, 37, 301), (4992, 0, 4737),
              (4992, 129, 4990))
# K1 at B > 1 (S=360, shared end 301) and K1/K2 on int8 slabs: (B, S, end)
K1_BATCH = (2, 8, 32)
# K1 at B > 1 with merged quantized weights: (bits, batch sizes)
K1_BATCH_QUANT = ((8, (8,)), (4, (8, 32)))
KV8_CASES = ((1, 360, 301), (8, 360, 301), (1, 4992, 4737), (8, 4992, 4737))
# K2 at distinct per-row ends (serving's route: every slot at its own
# position; an empty slot at end 0 attends only to its own K/V), start
# None, on an S-slot slab
K2_ROW_ENDS = (0, 1, 37, 217, 1000, 2047, 64, 511)
K2_ROW_END_S = 2048
# Qwen3-ASR-0.6B decoder dims
L, HQ, HKV, D, H, V = 28, 16, 8, 128, 1024, 151936


def row_starts(b: int) -> list:
    """Per-row first live slots of a right-aligned batch of b rows."""
    return [(0, 37, 129, 200, 5, 77, 150, 263)[i % 8] for i in range(b)]


def k1_inputs(torch, gen, dtype, s_max: int, end: int, b: int = 1):
    """Inputs of one decode step at slot ``end`` of an (L, b, Hkv, s_max, D)
    slab: (x, cos, sin, k_slabs, v_slabs), slab values at the scale of
    normalized, rotated keys and of the values, row r at position
    end - row_starts(b)[r]."""
    dev = torch.device("cuda")
    ks = torch.randn((L, b, HKV, s_max, D), generator=gen,
                     device=dev).to(dtype)
    vs = (0.05 * torch.randn((L, b, HKV, s_max, D), generator=gen,
                             device=dev)).to(dtype)
    x = (0.02 * torch.randn((b, H), generator=gen, device=dev)).to(dtype)
    pos = end - torch.tensor(row_starts(b), device=dev)[:, None]
    ang = pos * torch.logspace(0, -6, D // 2, base=10.0, device=dev)
    cos = torch.cat([ang.cos(), ang.cos()], -1).contiguous()
    sin = torch.cat([ang.sin(), ang.sin()], -1).contiguous()
    return x, cos, sin, ks, vs


def quantized_tree(torch, dec_params_f32, dtype, bits, merge,
                   group_size=None):
    """The decoder layers (and lm_head) cast to dtype, then quantized by
    the port's own quantizer (``group_size``: int4g)."""
    from qwen3_asr_rs_tpu_torch.weights.quantize import quantize_decoder_params

    tree = {"layers": {k: v.to(dtype)
                       for k, v in dec_params_f32["layers"].items()},
            "lm_head": dec_params_f32["lm_head"].to(dtype)}
    return quantize_decoder_params(tree, bits=bits, merge=merge, lm_bits=8,
                                   group_size=group_size)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound_of(nbytes_moved: float, ops: float) -> dict:
    """The least time the card could take: the larger of the bytes over
    the HBM rate and the operations over the bf16 tensor-core rate."""
    t_bytes, t_ops = nbytes_moved / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes_moved, "ops": ops}


def k1_work(lay, x, ks, vs, starts, end, k_scales=None, lm_head=None,
            lm_scales=None) -> dict:
    """K1's bound: every weight, norm and scale read once, each row's
    live K/V slots (and their int8 scales) of every layer, x in, h (or the
    token ids) and the fresh K/V out; two operations per logical weight
    and row, and the attention's four per live slot, head and dim."""
    nl, b, hkv, _, d = ks.shape
    live = sum(end - s for s in starts)
    slot_bytes = 2 * hkv * d * ks.element_size() + (
        0 if k_scales is None else 2 * hkv * 4)
    logical = sum(t.numel() * (2 if n.endswith("_q4") else 1)
                  for n, t in lay.items()
                  if n.endswith(("_w", "_q", "_q4")) and "ln" not in n
                  and "norm" not in n)
    moved = (nbytes(*lay.values(), lm_head, lm_scales)
             + nl * live * slot_bytes + 3 * nbytes(x)
             + 2 * nl * b * hkv * d * x.element_size())
    ops = 2 * b * logical + 4 * nl * (live + b) * HQ * d
    if lm_head is not None:
        ops += 2 * b * lm_head.numel()
    return bound_of(moved, ops)


def attn_work(q, ks, starts, ends, int8=False) -> dict:
    """K2/K6's bound: one layer's live K/V (and scales), q, the self K/V
    and the output; four operations per live slot, query head and dim."""
    _, _, hkv, _, d = ks.shape
    live = sum(e - s for s, e in zip(starts, ends))
    slot_bytes = 2 * hkv * d * ks.element_size() + (8 * hkv if int8 else 0)
    return bound_of(live * slot_bytes + 2 * nbytes(q) + 2 * q.shape[0] * hkv * d
                 * q.element_size(), 4 * (live + q.shape[0]) * q.shape[1] * d)


# the libraries whose bf16 kernels run on the tensor cores: K3, K1's
# GEMVs, K4, K5; K5's prefill tiles must run wgmma (HGMMA)
TENSOR_CORE_LIBS = ("flash_attention", "decode_layer", "quant_matvec_int4",
                    "quant_matmul", "moe_experts")
NEEDS_HGMMA = ("quant_matmul",)


def tensor_core_sass(build, name: str) -> dict:
    """The tensor-core instructions (HMMA: mma.sync; HGMMA: wgmma) in
    ``cuobjdump -sass`` of a kernel library; raises unless there are
    some (HGMMA among them, for the libraries of NEEDS_HGMMA)."""
    tool = Path(build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(build.library_path(name))],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    counts = {op: sum(f" {op}." in ln or f" {op} " in ln
                      for ln in sass.splitlines())
              for op in ("HMMA", "HGMMA")}
    if not sum(counts.values()) > 0 or (name in NEEDS_HGMMA
                                        and not counts["HGMMA"] > 0):
        raise AssertionError(f"{name}: no (or no wgmma) tensor-core "
                             f"instruction in its SASS ({counts})")
    return counts


def ptxas_spills(build) -> dict:
    """{library: ptxas lines that report spill stores or loads, or wgmma
    serialized (C7513)}; raises if a tensor-core kernel (gemv_mma_kernel,
    qmv4_mma_kernel, qmv8_mma_kernel, qmm_wgmma_kernel,
    moe_experts_kernel) spills."""
    out = {}
    for n in build.KERNEL_SOURCES:
        log = build.BUILD_DIR / f"{n}.log"
        if not log.exists():
            continue
        lines, fn = [], ""
        for ln in log.read_text().splitlines():
            if "Compiling entry function" in ln:
                fn = ln.split("'")[1] if "'" in ln else ln
            elif ("spill" in ln and not ln.strip().startswith(
                    "0 bytes stack frame, 0 bytes spill stores, 0 bytes "
                    "spill loads")) or "C7513" in ln:
                lines.append(f"{fn}: {ln.strip()}")
        out[n] = lines
        bad = [ln for ln in lines if ("mma_kernel" in ln
                                      or "moe_experts_kernel" in ln)
               and "spill" in ln
               or "gemv_wgmma_kernel" in ln and "C7513" in ln]
        if bad:
            raise AssertionError(f"{n}: a tensor-core GEMV spills: {bad[:3]}")
    return out


T_START = time.perf_counter()


def emit(obj) -> None:
    """Print one JSON line; a phase's line carries the seconds since the
    script started (``t_s``)."""
    if "phase" in obj:
        obj = {**obj, "t_s": round(time.perf_counter() - T_START, 1)}
    print(json.dumps(obj), flush=True)


def cuda_ms(torch, fn, reps: int = 10, warmup: int = 2) -> float:
    """Median milliseconds of fn() between CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def busy_us(events) -> float:
    """Microseconds in which at least one of the device events ran: the
    union of their intervals. Kernels launched with programmatic dependent
    launch overlap their predecessor (they start early and wait), so a sum
    of their durations counts that overlap twice."""
    total, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end)
                       for e in events):
        total += max(0.0, b - max(a, end))
        end = max(end, b)
    return total


# profiler windows: "short" were kept with device events missing
# ("events_missing" in all; their time is divided by the calls they
# hold), "retaken" held less than half or exceeded the CUDA-event time
PROFILER_WINDOWS = {"short": 0, "events_missing": 0, "retaken": 0}
# slack of a window's busy time over the CUDA-event time of its own calls
# (the events are recorded around them while the profiler runs)
EVENT_SLACK = (1.05, 0.001)
# idle seconds at each end of a profiler window
WINDOW_MARGIN_S = 0.005


def device_events(torch, fn, reps: int) -> tuple:
    """(the device events (kernels, copies, sets) torch.profiler records
    in a window of reps fn() calls between two idle margins, the
    CUDA-event milliseconds of those reps calls)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(WINDOW_MARGIN_S)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        time.sleep(WINDOW_MARGIN_S)
    return ([e for e in prof.events() if e.device_type == DeviceType.CUDA],
            start.elapsed_time(end))


def device_ms(torch, fn, reps: int = 10, windows: int = 3,
              warmup: int = 2, tries: int = 5) -> float:
    """Device milliseconds of one fn() call: the time in which the device
    ran any of the events (every kernel, copy and set, busy_us) of a
    profiler window of reps calls, over the calls the window holds; the
    median of ``windows`` windows.

    The profiler loses events: whole windows, and on the card up to 3 of
    the 10 of a window, the same case in window after window. So p, the
    events of one call, is the largest count of the windows taken over
    reps, rounded up; a window counts when it holds at least half of its
    reps p events, its busy time is divided by its events / p calls, and
    that time per call is at most the CUDA-event time per call of the
    window's own calls (within EVENT_SLACK: busy time cannot exceed the
    elapsed time it lies in). Up to ``tries`` more windows are taken in
    place of those that do not count, then it raises. PROFILER_WINDOWS,
    which the run reports, counts both kinds."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ratio, extra = EVENT_SLACK
    seen = []  # (events, busy ms, CUDA-event ms) per window
    for _ in range(windows + tries):
        events, elapsed = device_events(torch, fn, reps)
        seen.append((len(events), busy_us(events) / 1e3, elapsed))
        per_fn = -(-max(n for n, _, _ in seen) // reps)
        kept = [(n, busy * per_fn / n) for n, busy, el in seen
                if n and 2 * n >= reps * per_fn
                and busy * per_fn / n <= ratio * el / reps + extra]
        if len(kept) >= windows:
            break
    else:
        raise AssertionError(
            f"profiler: {len(seen)} windows of {reps} calls, (device events, "
            f"busy ms, event ms) {seen}, {len(kept)} of them within half of "
            f"{reps * per_fn} events and their event time")
    PROFILER_WINDOWS["retaken"] += len(seen) - len(kept)
    for n, _ in kept:
        if n < reps * per_fn:
            PROFILER_WINDOWS["short"] += 1
            PROFILER_WINDOWS["events_missing"] += reps * per_fn - n
    return statistics.median(ms for _, ms in kept)


def max_err(torch, a, b) -> float:
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
        raise AssertionError("non-finite values in the kernel output or "
                             "its plain version")
    return float((a.float() - b.float()).abs().max())


def element_excess(torch, got, ref, rtol: float) -> float:
    """max over elements of |got - ref| - rtol * |ref|: the per-element
    check passes when it is at most the atol of ELEMENT_TOL."""
    if not torch.isfinite(got).all():
        raise AssertionError("non-finite values in the kernel output")
    ref = ref.float()
    return float(((got.float() - ref).abs() - rtol * ref.abs()).max())


def check_case(torch, results, name, dtype, case, kernel_fn, plain_fn,
               rows=slice(None), work=None, library=None, headline=False,
               device=False, reference=None, library_mm=None):
    """Compare kernel_fn() with plain_fn() (a tensor or a tuple of them,
    each against its own tolerance), and with ``reference()`` element by
    element (ELEMENT_TOL) where one is given, then time both; ``work`` is
    the case's ``bound_of()``, ``library`` one PyTorch call that computes
    the same function (timed, never compared), ``library_mm`` a second
    one (K5's tensor-core yardstick), ``headline`` marks the case the
    kernels line reports, ``device`` adds the device time of the kernel's
    call (and of the library calls) from torch.profiler."""
    out, ref = kernel_fn(), plain_fn()
    torch.cuda.synchronize()
    if isinstance(out, torch.Tensor):
        out, ref = (out,), (ref,)
    dt = str(dtype).replace("torch.", "")
    if isinstance(out[0], torch.Tensor) and out[0].dtype != dtype:
        dt = f"{dt}->{str(out[0].dtype).replace('torch.', '')}"
    atol, rtol = TOL[(name, dt)]
    err = bound = scale = 0.0
    for o, r in zip(out, ref):
        e = max_err(torch, o[rows], r[rows])
        sc = float(r[rows].float().abs().max())
        if not e <= atol + rtol * sc:
            emit({"phase": "kernel", "kernel": name, "dtype": dt,
                  "case": case, "max_abs_err": e, "ref_max": sc,
                  "bound": atol + rtol * sc, "ok": False})
            raise AssertionError(f"{name} {case} {dt}: error {e} > "
                                 f"{atol} + {rtol} * {sc}")
        err, bound, scale = max(err, e), max(bound, atol + rtol * sc), max(scale, sc)
    element = {}
    if reference is not None:
        eatol, ertol = ELEMENT_TOL.get((name, dt)) or ELEMENT_TOL[name]
        excess = element_excess(torch, out[0][rows], reference()[rows], ertol)
        element = {"element_excess": excess, "element_atol": eatol,
                   "element_rtol": ertol}
        if not excess <= eatol:
            emit({"phase": "kernel", "kernel": name, "dtype": dt,
                  "case": case, **element, "ok": False})
            raise AssertionError(f"{name} {case} {dt}: |err| - {ertol} * "
                                 f"|ref| reaches {excess} > {eatol}")
    ms = cuda_ms(torch, kernel_fn)
    plain_ms = cuda_ms(torch, plain_fn, reps=3, warmup=1)
    row = {"phase": "kernel", "kernel": name, "dtype": dt, "case": case,
           "max_abs_err": err, "ref_max": scale, "bound": bound,
           "atol": atol, "rtol": rtol, **element, "ms": ms,
           "plain_ms": plain_ms, **(work or {}), "headline": headline}
    if library is not None:
        row["library_ms"] = cuda_ms(torch, library)
    if library_mm is not None:
        row["library_mm_ms"] = cuda_ms(torch, library_mm)
    if device:
        row["device_ms"] = device_ms(torch, kernel_fn)
        if library is not None:
            row["library_device_ms"] = device_ms(torch, library)
        if library_mm is not None:
            row["library_mm_device_ms"] = device_ms(torch, library_mm)
    emit(row)
    results.append(row)


def sdpa_decode(torch, q, ks, vs, k_self, v_self, layer, start, end):
    """One PyTorch call computing K2's (and K6's) function at B = 1:
    scaled_dot_product_attention with GQA over the live slots with the
    self K/V appended (the concatenation is made here, untimed)."""
    k = torch.cat([ks[layer, :, :, start:end], k_self[:, :, None]], 2)
    v = torch.cat([vs[layer, :, :, start:end], v_self[:, :, None]], 2)
    qq = q[:, :, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(qq, k, v, enable_gqa=True)


def sdpa_causal(torch, q, k, v):
    """One PyTorch call computing K3's causal function: SDPA with GQA on
    (B, heads, S, D) copies of the inputs (made here, untimed)."""
    qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)


def int8pack_mm(torch, x, w_q, scales):
    """One PyTorch call computing K5's function: torch._weight_int8pack_mm
    on an (N, K) copy of the (K, N) int8 weights, with the per-column
    scales in x's dtype (made here, untimed)."""
    w_nk, s = w_q.T.contiguous(), scales.to(x.dtype)
    return lambda: torch._weight_int8pack_mm(x, w_nk, s)


def mm_yardstick(torch, x, w_q, scales):
    """K5's tensor-core yardstick: torch.mm(x, W) on a copy of the weights
    with the scales folded in, in x's dtype (made here, untimed)."""
    w = (w_q.float() * scales.float()).to(x.dtype)
    return lambda: torch.mm(x, w)


def k5_reference(x, w_q, scales):
    """K5's element reference: the float64 product of x's values and the
    int8 weights times the scales, unrounded (ELEMENT_TOL's rtol is the
    kernel's one output rounding)."""
    return (x.double() @ w_q.double()) * scales.double()


def k5_work(x, w_q, out_bytes: int) -> dict:
    """K5's bound: x, the int8 weight and the scales read once, the (R, N)
    output written once; two operations per weight and row."""
    r, n = x.shape[0], w_q.shape[1]
    return bound_of(nbytes(x, w_q) + 4 * n + out_bytes * r * n,
                    2 * r * w_q.numel())


def int4pack_mm(torch, x, w_q4, scales, group: int = 256):
    """One PyTorch call computing K4's function: torch._weight_int4pack_mm
    (bf16 x times int4 weights stored as q + 8 in [1, 15], each weight
    (q - 8) * scale + zero per ``group`` rows) with K4's per-column scale
    repeated over the groups and zero 0. The nibbles are repacked into
    that call's layout here, untimed."""
    from qwen3_asr_rs_tpu_torch.ops.quant import unpack_int4_tiled

    k, n = w_q4.shape[0], scales.shape[0]
    q = unpack_int4_tiled(w_q4, dtype=torch.int32)[:, :n].T + 8  # (N, K)
    packed = ((q[:, ::2] << 4) | q[:, 1::2]).to(torch.uint8).contiguous()
    w4 = torch._convert_weight_to_int4pack(packed, 8)
    sz = torch.stack([scales.float().repeat(k // group, 1),
                      torch.zeros((k // group, n), device=scales.device)],
                     -1).to(torch.bfloat16).contiguous()
    return lambda: torch._weight_int4pack_mm(x, w4, group, sz)


def kernel_checks(torch, dec_params_f32):
    """Phase 3: K2, K1, K3 against their plain versions."""
    from qwen3_asr_rs_tpu_torch.ops.kernels.decode_attention import (
        decode_attention_dma, decode_attention_dma_plain)
    from qwen3_asr_rs_tpu_torch.ops.kernels.decode_layer import (
        decode_layers_fused, decode_layers_fused_plain)
    from qwen3_asr_rs_tpu_torch.ops.kernels.flash_attention import (
        flash_attention, flash_attention_plain, flash_attention_tile_reference)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    results = []

    def idx(v):
        return torch.tensor([v], dtype=torch.int32, device=dev)

    for dtype in (torch.float32, torch.bfloat16):
        for s_max, start, end in SLAB_CASES:
            ks = torch.randn((L, 1, HKV, s_max, D), generator=gen,
                             device=dev).to(dtype)
            vs = torch.randn_like(ks)
            q = torch.randn((1, HQ, D), generator=gen, device=dev).to(dtype)
            k_self = torch.randn((1, HKV, D), generator=gen,
                                 device=dev).to(dtype)
            v_self = torch.randn_like(k_self)
            case = f"S={s_max} start={start} end={end} layer=27"
            check_case(
                torch, results, "decode_attention_dma", dtype, case,
                lambda: decode_attention_dma(q, ks, vs, k_self, v_self, 27,
                                             start, end),
                lambda: decode_attention_dma_plain(q, ks, vs, k_self, v_self,
                                                   27, idx(start), idx(end)),
                reference=(lambda: decode_attention_dma_plain(
                    q.float(), ks, vs, k_self, v_self, 27, idx(start),
                    idx(end))) if dtype == torch.bfloat16 else None,
                work=attn_work(q, ks, [start], [end]),
                library=(sdpa_decode(torch, q, ks, vs, k_self, v_self, 27,
                                     start, end)
                         if dtype == torch.bfloat16 else None),
                headline=dtype == torch.bfloat16 and s_max == 360,
                device=dtype == torch.bfloat16 and s_max == 360,
            )
            del ks, vs

    layers = {
        torch.float32: dec_params_f32["layers"],
        torch.bfloat16: {k: v.to(torch.bfloat16)
                         for k, v in dec_params_f32["layers"].items()},
    }
    for dtype in (torch.float32, torch.bfloat16):
        lay = layers[dtype]
        for s_max, start, end in SLAB_CASES:
            x, cos, sin, ks, vs = k1_inputs(torch, gen, dtype, s_max, end)
            case = f"L=28 S={s_max} start={start} end={end}"
            check_case(
                torch, results, "decode_layers_fused", dtype, case,
                lambda: decode_layers_fused(x, cos, sin, lay, ks, vs, start,
                                            end, eps=1e-6),
                lambda: decode_layers_fused_plain(x, cos, sin, lay, ks, vs,
                                                  idx(start), idx(end),
                                                  eps=1e-6),
                work=k1_work(lay, x, ks, vs, [start], end),
                headline=(dtype == torch.bfloat16
                          and (s_max, start) == SLAB_CASES[0][:2]),
            )
            del ks, vs
    del layers

    # K3 at the 360-chunk prefill bucket: 4736 tokens, causal
    S = 4736
    flash_cases = [
        (torch.float32, "causal", dict(causal=True), 0),
        (torch.bfloat16, "causal", dict(causal=True), 0),
        (torch.bfloat16, "causal kv_valid=4000",
         dict(causal=True, kv_valid=idx(4000)), 0),
        (torch.bfloat16, "causal kv_start=100",
         dict(causal=True, kv_start=idx(100)), 100),
        (torch.bfloat16, "kv_valid=3001 (not causal)",
         dict(kv_valid=idx(3001)), 0),
    ]
    for dtype, case, kw, first_row in flash_cases:
        q = torch.randn((1, S, HQ, D), generator=gen, device=dev).to(dtype)
        k = torch.randn((1, S, HKV, D), generator=gen, device=dev).to(dtype)
        v = torch.randn((1, S, HKV, D), generator=gen, device=dev).to(dtype)
        kv_valid, kv_start = kw.get("kv_valid"), kw.get("kv_start")
        causal = kw.get("causal", False)
        # rows with no attendable key are discarded by callers
        headline = dtype == torch.bfloat16 and case == "causal"
        check_case(
            torch, results, "flash_attention", dtype, f"Sq=Sk={S} {case}",
            lambda: flash_attention(q, k, v, kv_valid, kv_start,
                                    causal=causal),
            lambda: flash_attention_plain(q, k, v, kv_valid, kv_start,
                                          causal=causal),
            rows=(slice(None), slice(first_row, None)),
            reference=(lambda: flash_attention_tile_reference(
                q, k, v, kv_valid, kv_start, causal=causal))
            if dtype == torch.bfloat16 else None,
            # causal: half the score matrix (plus its diagonal) is computed
            work=bound_of(nbytes(q, k, v, q),
                          4 * HQ * D * (S * (S + 1) // 2 if causal
                                        else S * S)),
            library=sdpa_causal(torch, q, k, v) if headline else None,
            headline=headline,
            device=headline,
        )
        del q, k, v
    torch.cuda.empty_cache()
    quant_kernel_checks(torch, dec_params_f32, gen, results)
    batch_kernel_checks(torch, dec_params_f32, gen, results)
    k3_main_path_checks(torch, gen, results)
    int4g_kernel_checks(torch, dec_params_f32, gen, results)
    fold_kernel_checks(torch, dec_params_f32, gen, results)
    slab_kernel_checks(torch, gen, results)
    k2_row_end_checks(torch, gen, results)
    gemv_kernel_checks(torch, gen, results)
    gemv_wgmma_checks(torch, gen, results)
    k1_layout_launches(torch, dec_params_f32, gen, results)
    draw_kernel_checks(torch, gen, results)
    return results


def draw_ties(torch, noisy, rows) -> list:
    """The rows of ``noisy`` (logit + noise) whose two best values lie
    within DRAW_TIE * max(1, |best|) of each other."""
    top = torch.topk(noisy[rows], 2, dim=-1).values
    gap = top[:, 0] - top[:, 1]
    return (gap <= DRAW_TIE * top[:, 0].abs().clamp(min=1)).tolist()


def draw_kernel_checks(torch, gen, results):
    """The draw kernel (csrc/gumbel_argmax.cu) against its plain version
    (ops/prng.py on the card) at the full vocabulary: B = 1, 8 and 32 rows
    of scaled logits (every 7th column filtered to -inf), three seeds, the
    engine's fold_in chains; and a pool of POOL_SLOTS slots of which a dp
    rank holds the second half (row_offset) or picked rows (a row-index
    tensor). Bits and both uniforms bit-equal (threefry_noise), Gumbel
    noise within GUMBEL_ULPS, tokens equal but at near-ties (counted, shown);
    a split chain draws with fold_in(key, 1) and leaves fold_in(key, 0).
    Times: the kernel (CUDA events and device time), the plain version,
    the bound (the logits read once over 3.35 TB/s)."""
    from qwen3_asr_rs_tpu_torch.ops import prng
    from qwen3_asr_rs_tpu_torch.ops.kernels.gumbel_argmax import (
        gumbel_argmax, gumbel_argmax_plain, threefry_noise,
        threefry_noise_plain)

    dev = torch.device("cuda")
    v = V
    counter = torch.tensor(41, dtype=torch.int64, device=dev)
    chains = (("fold_in(key, step + 1)", ((counter, 1),)),
              ("draft step: fold_in(fold_in(key, it + 1), 2 + i)",
               ((counter, 1), 4)),
              ("accept: fold_in(fold_in(fold_in(key, it + 1), 0), 1)",
               ((counter, 1), 0, 1)))
    cases = [(b, 0, None) for b in DRAW_ROWS] + [
        (POOL_SLOTS // 2, POOL_SLOTS // 2, None),
        (4, 0, torch.tensor([3, 17, 30, 8], dtype=torch.int64, device=dev))]
    for b, offset, rows in cases:
        x = torch.randn((b, v), generator=gen, device=dev) * 3
        x[:, ::7] = -torch.inf
        at = rows if rows is not None else offset
        ties = differ = gumbel_bits_equal = 0
        worst = worst_abs = 0.0
        for seed in (0, 7, 2**33 + 5):
            base = prng.prng_key(seed, dev)
            for _, data in chains:
                chain = prng.KeyChain(base, data)
                for mode in ("bits", "uniform", "uniform_tiny"):
                    got = threefry_noise(chain, (b, v), mode, at)
                    want = threefry_noise_plain(chain, (b, v), mode, at)
                    if not torch.equal(got, want):
                        raise AssertionError(
                            f"draw kernel: {mode} differ from the plain "
                            f"version's (B={b}, seed={seed}, {data})")
                g = threefry_noise(chain, (b, v), "gumbel", at)
                gp = threefry_noise_plain(chain, (b, v), "gumbel", at)
                err = ((g - gp).abs() / gp.abs().clamp(min=1)).max()
                worst = max(worst, float(err) / 2.0**-23)
                worst_abs = max(worst_abs, max_err(torch, g, gp))
                gumbel_bits_equal += int(torch.equal(g, gp))
                tok = gumbel_argmax(x, chain, at)
                ref = gumbel_argmax_plain(x, chain, at)
                bad = (tok != ref).nonzero().flatten()
                if len(bad):
                    near = draw_ties(torch, x + gp, bad)
                    if not all(near):
                        raise AssertionError(
                            f"draw kernel: tokens {tok[bad].tolist()} != "
                            f"{ref[bad].tolist()} away from a tie (B={b}, "
                            f"seed={seed}, {data})")
                    differ += len(bad)
                ties += sum(draw_ties(torch, x + gp, slice(None)))
        if worst > GUMBEL_ULPS:
            raise AssertionError(f"draw kernel: Gumbel noise {worst} ulps "
                                 "from the plain version's")
        # a split chain (serving's key, sub = split(key)): the draw takes
        # fold_in(key, 1), the key becomes fold_in(key, 0)
        key = prng.prng_key(11, dev)
        want_tok = gumbel_argmax_plain(x, prng.fold_in(key, 1), at)
        want_key = prng.fold_in(key, 0)
        tok = gumbel_argmax(x, prng.KeyChain(key, then_split=True), at)
        split_ok = torch.equal(key, want_key) and (
            torch.equal(tok, want_tok)
            or all(draw_ties(torch, x + threefry_noise_plain(
                prng.fold_in(prng.prng_key(11, dev), 1), (b, v), "gumbel",
                at), (tok != want_tok).nonzero().flatten())))
        if not split_ok:
            raise AssertionError(f"draw kernel: split chain (B={b})")
        head_key = prng.KeyChain(base, chains[0][1])
        case = (f"B={b} V={v}" + (f" row_offset={offset}" if offset else "")
                + (" row indices" if rows is not None else ""))
        row = {"phase": "kernel", "kernel": "gumbel_argmax",
               "dtype": "float32", "case": case,
               "max_abs_err": worst_abs, "bits_equal": True,
               "uniforms_equal": True,
               "gumbel_ulps_max": worst, "gumbel_bit_equal_draws":
                   gumbel_bits_equal, "draws": 9,
               "tokens_differ": differ, "near_ties": ties,
               "split_ok": split_ok,
               "ms": cuda_ms(torch, lambda: gumbel_argmax(x, head_key, at),
                             reps=50, warmup=5),
               "device_ms": device_ms(torch, lambda: gumbel_argmax(
                   x, head_key, at)),
               "plain_ms": cuda_ms(torch, lambda: gumbel_argmax_plain(
                   x, head_key, at), reps=3, warmup=1),
               **bound_of(b * v * 4 + b * 8, 0),
               "library_ms": None, "headline": b == 8 and not offset,
               "tie": DRAW_TIE, "gumbel_ulps": GUMBEL_ULPS}
        emit(row)
        results.append(row)
        del x
    torch.cuda.empty_cache()


def quant_kernel_checks(torch, dec_params_f32, gen, results):
    """Phase 3, quantized: K1 with int8/int4 weights, K5, K4."""
    from qwen3_asr_rs_tpu_torch.ops.kernels.decode_layer import (
        decode_layers_fused, decode_layers_fused_plain)
    from qwen3_asr_rs_tpu_torch.ops.kernels.quant_matmul import (
        quant_matmul, quant_matmul_plain)
    from qwen3_asr_rs_tpu_torch.ops.kernels.quant_matvec_int4 import (
        quant_matvec_int4, quant_matvec_int4_plain)
    from qwen3_asr_rs_tpu_torch.ops.quant import quantize_weight_int4_tiled

    dev = torch.device("cuda")

    def idx(v):
        return torch.tensor([v], dtype=torch.int32, device=dev)

    for dtype in (torch.float32, torch.bfloat16):
        for label, bits, merge in K1_QUANT:
            qtree = quantized_tree(torch, dec_params_f32, dtype, bits, merge)
            lay = qtree["layers"]
            for s_max, start, end in (SLAB_CASES[0], SLAB_CASES[2]):
                x, cos, sin, ks, vs = k1_inputs(torch, gen, dtype, s_max, end)
                case = f"{label} L=28 S={s_max} start={start} end={end}"
                check_case(
                    torch, results, "decode_layers_fused", dtype, case,
                    lambda: decode_layers_fused(x, cos, sin, lay, ks, vs,
                                                start, end, eps=1e-6),
                    lambda: decode_layers_fused_plain(
                        x, cos, sin, lay, ks, vs, idx(start), idx(end),
                        eps=1e-6),
                )
                del ks, vs
            if label == "int8 merged":
                k5_checks(torch, gen, results, dtype, qtree)
            del qtree, lay
            torch.cuda.empty_cache()

    # K4 at the int4 lm_head's shape, one row (a decode step) and the rows
    # of batched steps: one read of the weight for all of them
    w_q4, sc = quantize_weight_int4_tiled(dec_params_f32["lm_head"].T)
    for dtype in (torch.float32, torch.bfloat16):
        for rows in K4_ROWS:
            x = torch.randn((rows, H), generator=gen, device=dev).to(dtype)
            bf16 = dtype == torch.bfloat16
            check_case(
                torch, results, "quant_matvec_int4", dtype,
                f"lm_head ({rows}, {H}) @ unpack{tuple(w_q4.shape)} -> "
                f"({rows}, {sc.shape[0]})",
                lambda: quant_matvec_int4(x, w_q4, sc),
                lambda: quant_matvec_int4_plain(x, w_q4, sc),
                work=bound_of(nbytes(x, w_q4, sc) + 4 * rows * sc.shape[0],
                              2 * rows * H * sc.shape[0]),
                library=int4pack_mm(torch, x, w_q4, sc) if bf16 else None,
                headline=bf16 and rows == 1,
                device=bf16,
            )
    del w_q4, sc
    torch.cuda.empty_cache()


def k5_cases(bf16: bool = True) -> list:
    """(weight, rows, K, N, float32 logits) of K5's cases: layer 0's merged
    linears over the prefill rows (K5_ROWS; float32 x: K5_ROWS_F32) and,
    bf16 x, the decode rows (K5_DECODE_ROWS), the ragged shape, the
    lm_head at K5_LM_ROWS rows (float32 x: one)."""
    out = [(name, rows, k, n, False)
           for rows in (K5_ROWS + K5_DECODE_ROWS if bf16 else K5_ROWS_F32)
           for name, k, n in K5_LINEARS]
    out.append(("ragged", *K5_RAGGED, False))
    out += [("lm_head", rows, H, V, True)
            for rows in (K5_LM_ROWS if bf16 else K5_LM_ROWS[:1])]
    return out


def k5_case_name(weight, rows, k, n, logits) -> str:
    return (f"{weight} ({rows}, {k}) @ ({k}, {n})"
            + (" -> float32" if logits else ""))


def k5_checks(torch, gen, results, dtype, qtree):
    """Phase 3, K5 at the int8 path's shapes (k5_cases; the ragged
    weight quantized here), each case with its device time, bound, both
    library times and (bf16 x) the element check against k5_reference."""
    from qwen3_asr_rs_tpu_torch.ops.kernels.quant_matmul import (
        quant_matmul, quant_matmul_plain)
    from qwen3_asr_rs_tpu_torch.ops.quant import quantize_weight

    dev = torch.device("cuda")
    bf16 = dtype == torch.bfloat16
    for weight, rows, k, n, logits in k5_cases(bf16):
        if weight == "lm_head":
            w_q, sc = qtree["lm_head_q"], qtree["lm_head_s"]
        elif weight == "ragged":
            w_q, sc = quantize_weight(0.02 * torch.randn(
                (k, n), generator=gen, device=dev))
        else:
            w_q, sc = (qtree["layers"][f"{weight}_{t}"][0] for t in "qs")
        x = torch.randn((rows, k), generator=gen, device=dev).to(dtype)
        out_dtype = torch.float32 if logits else dtype
        check_case(
            torch, results, "quant_matmul", dtype,
            k5_case_name(weight, rows, k, n, logits),
            lambda: quant_matmul(x, w_q, sc, out_dtype=out_dtype),
            lambda: quant_matmul_plain(x, w_q, sc, out_dtype=out_dtype),
            reference=(lambda: k5_reference(x, w_q, sc)) if bf16 else None,
            work=k5_work(x, w_q, 4 if logits else 2),
            library=int8pack_mm(torch, x, w_q, sc) if bf16 else None,
            library_mm=mm_yardstick(torch, x, w_q, sc),
            headline=bf16 and logits and rows == 1,
            device=True,
        )
        del x, w_q, sc


def k1_check(torch, gen, results, dtype, lay, b, s_max, end, label,
             int8_slabs=False):
    """K1 against its plain version at B = b rows with row_starts(b) and
    a shared end, on a slab of the compute dtype or an int8 one."""
    from qwen3_asr_rs_tpu_torch.models.text_decoder import quantize_kv
    from qwen3_asr_rs_tpu_torch.ops.kernels.decode_layer import (
        decode_layers_fused, decode_layers_fused_plain)

    x, cos, sin, ks, vs = k1_inputs(torch, gen, dtype, s_max, end, b)
    scales = {}
    if int8_slabs:
        (ks, kscale), (vs, vscale) = quantize_kv(ks), quantize_kv(vs)
        scales = dict(k_scales=kscale, v_scales=vscale)
    starts = row_starts(b)
    start, ends = (torch.tensor(v, dtype=torch.int32, device="cuda")
                   for v in (starts, [end] * b))
    check_case(
        torch, results, "decode_layers_fused", dtype,
        f"{label} B={b} L=28 S={s_max} start={starts[:8]} end={end}",
        lambda: decode_layers_fused(x, cos, sin, lay, ks, vs, start, end,
                                    eps=1e-6, **scales),
        lambda: decode_layers_fused_plain(x, cos, sin, lay, ks, vs, start,
                                          ends, eps=1e-6, **scales),
        work=k1_work(lay, x, ks, vs, starts, end, scales.get("k_scales")),
    )


# K1's bf16 tensor-core GEMV alone (gemv_single): (weight kind, epilogue,
# SwiGLU from the low and high nibbles of one int4 weight), each at
# GEMV_ROWS rows
GEMV_CASES = (
    [(k, e, False) for e in ("store", "residual")
     for k in ("float", "int8", "int4", "int4g32", "int4g64", "int4g128")]
    + [(k, "swiglu", False) for k in ("float", "int8", "int4")]
    + [(k, "swiglu", True) for k in ("int4", "int4g32", "int4g64",
                                     "int4g128")])
GEMV_ROWS = (1, 8, 32)


def gemv_single_inputs(torch, gen, kind, epilogue, nibbles, rows):
    """(x, w, scales, keyword arguments) of one GEMV of K1 at the 0.6B
    widths: q|k|v (1024 -> 4096, RMSNorm prologue) for "store", down (3072
    -> 1024) for "residual", gate and up (1024 -> 3072 each, RMSNorm
    prologue) for "swiglu"; weights from the port's quantizers."""
    from qwen3_asr_rs_tpu_torch.ops import quant

    dev = torch.device("cuda")
    k, n = {"store": (H, 4096), "residual": (3072, H),
            "swiglu": (H, 3072)}[epilogue]

    def weight(cols):
        w = 0.02 * torch.randn((k, cols), generator=gen, device=dev)
        if kind == "float":
            return w.bfloat16(), None
        if kind == "int8":
            return quant.quantize_weight(w)
        if kind == "int4":
            return quant.quantize_weight_int4(w)
        return quant.quantize_weight_int4_grouped(w, int(kind[5:]))

    x = torch.randn((rows, k), generator=gen, device=dev).bfloat16()
    kw = dict(int4=kind.startswith("int4"), epilogue=epilogue)
    if epilogue == "residual":
        kw["res"] = torch.randn((rows, n), generator=gen,
                                device=dev).bfloat16()
    else:
        kw["norm_w"] = (1 + 0.1 * torch.randn(k, generator=gen, device=dev)
                        ).bfloat16()
    if epilogue == "swiglu" and nibbles:
        w, s = weight(2 * n)
    else:
        w, s = weight(n)
        if epilogue == "swiglu":
            kw["w_up"], kw["s_up"] = weight(n)
    return x, w, s, kw


def gemv_excess(torch, got, ref, slack) -> float:
    """max over elements of |got - ref| - 2^-8 |ref| - slack (ELEMENT_TOL
    of gemv_single; slack: the epilogue's inner roundings)."""
    if not torch.isfinite(got.float()).all():
        raise AssertionError("non-finite values in the GEMV output")
    rtol = ELEMENT_TOL["gemv_single"][1]
    return float(((got.float() - ref).abs() - rtol * ref.abs() - slack).max())


def gemv_kernel_checks(torch, gen, results):
    """Phase 3, K1's bf16 GEMV alone: every weight kind and epilogue at
    B = 1, 8 and 32, element by element against the float32 reference
    with the kernel's roundings (a whole-step check of K1 is too loose to
    see a dropped K split or a skipped group scale)."""
    from qwen3_asr_rs_tpu_torch.ops.kernels.decode_layer import (
        gemv_single, gemv_single_reference)

    from qwen3_asr_rs_tpu_torch.ops.kernels.decode_layer import (
        GEMV_TN, ssq_parts)

    atol = ELEMENT_TOL["gemv_single"][0]
    for kind, epilogue, nibbles in GEMV_CASES:
        for rows in GEMV_ROWS:
            x, w, s, kw = gemv_single_inputs(torch, gen, kind, epilogue,
                                             nibbles, rows)
            ref, slack = gemv_single_reference(x, w, s, **kw)
            # as the decode step runs it: each row's sum of squares in parts
            # (a residual GEMV leaves them, a normed one takes them); and a
            # normed GEMV that sums its rows itself (layer 0)
            for ssq in (True, False) if "norm_w" in kw else (True,):
                got = gemv_single(x, w, s, ssq=ssq, **kw)
                parts_err = None
                if epilogue == "residual":
                    got, parts = got
                    want = ssq_parts(got, GEMV_TN, kw["int4"])
                    parts_err = float(((parts - want).abs()
                                       / want.abs().clamp(min=1e-6)).max())
                excess = gemv_excess(torch, got, ref, slack)
                row = {"phase": "kernel", "kernel": "gemv_single",
                       "case": f"{kind} {epilogue}"
                               f"{' (nibbles)' if nibbles else ''} B={rows}"
                               f"{'' if ssq else ' (own sums)'}",
                       "element_excess": excess, "element_atol": atol,
                       "ref_max": float(ref.abs().max()),
                       "ssq_parts_rel_err": parts_err}
                emit(row)
                results.append(row)
                if not excess <= atol:
                    raise AssertionError(
                        f"gemv_single {row['case']}: |err| - 2^-8 |ref| "
                        f"reaches {excess} > {atol}")
                if parts_err is not None and not parts_err <= 1e-5:
                    raise AssertionError(
                        f"gemv_single {row['case']}: sums of squares off by "
                        f"{parts_err} (relative)")


# K1's GEMVs on the wgmma GEMV (bf16 weights): (label, K, output columns
# per segment, epilogue) at the 1.7B decoder's widths (the offline cell's)
# and at the 0.6B's; q|k|v in three column segments as the step launches
# them
WGMMA_SHAPES = (("1.7b q|k|v", 2048, (2048, 1024, 1024), "store"),
                ("1.7b o", 2048, (2048,), "residual"),
                ("1.7b gate|up", 2048, (6144,), "swiglu"),
                ("1.7b down", 6144, (2048,), "residual"),
                ("0.6b q|k|v", 1024, (2048, 1024, 1024), "store"),
                ("0.6b o", 2048, (1024,), "residual"),
                ("0.6b gate|up", 1024, (3072,), "swiglu"),
                ("0.6b down", 3072, (1024,), "residual"))
# rows the two routes are timed at: each of the staged widths 8, 16, 32
WGMMA_TIMED_ROWS = (1, 8, 16, 32)
# consecutive launches per timed CUDA graph, and its replays
WGMMA_GRAPH_CALLS = 20


def wgmma_sass(build) -> dict:
    """{function: HGMMA count} of every gemv_wgmma_kernel instance in the
    SASS of K1's library (``cuobjdump -sass``); raises unless every one
    runs wgmma."""
    tool = Path(build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass",
                           str(build.library_path("decode_layer"))],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    counts, fn = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            name = ln.split("Function :")[1].strip()
            fn = name if "gemv_wgmma_kernel" in name else None
            if fn is not None:
                counts[fn] = 0
        elif fn is not None and (" HGMMA." in ln or " HGMMA " in ln):
            counts[fn] += 1
    if not counts or not all(counts.values()):
        raise AssertionError(f"gemv_wgmma_kernel: no wgmma (HGMMA) in its "
                             f"SASS ({counts})")
    return counts


def gemv_wgmma_inputs(torch, gen, k, cols, epilogue, rows):
    """(x, w, keyword arguments) of one GEMV of K1 on bf16 weights: w a
    list of the column segments for "store" (with an RMSNorm prologue),
    one weight for "residual", gate (with up in ``w_up``) for "swiglu"."""
    dev = torch.device("cuda")

    def weight(c):
        return (0.02 * torch.randn((k, c), generator=gen, device=dev)
                ).bfloat16()

    x = torch.randn((rows, k), generator=gen, device=dev).bfloat16()
    kw = dict(epilogue=epilogue)
    if epilogue == "residual":
        kw["res"] = torch.randn((rows, cols[0]), generator=gen,
                                device=dev).bfloat16()
    else:
        kw["norm_w"] = (1 + 0.1 * torch.randn(k, generator=gen, device=dev)
                        ).bfloat16()
    w = [weight(c) for c in cols] if epilogue == "store" else weight(cols[0])
    if epilogue == "swiglu":
        kw["w_up"] = weight(cols[0])
    return x, w, kw


def gemv_wgmma_case(torch, x, w, kw, route, ssq):
    """One check of a route: (output, its element excess over the float32
    reference with the kernel's roundings, the residual's parts' relative
    error or None, whether a second launch gave the same bits, the wgmma
    launches counted)."""
    from qwen3_asr_rs_tpu_torch.ops.kernels import decode_layer as dl

    wcat = torch.cat(w, 1) if isinstance(w, list) else w
    ref, slack = dl.gemv_single_reference(x, wcat, None, **kw)
    n0 = dl.gemv_wgmma.launches
    got = dl.gemv_single(x, w, ssq=ssq, route=route, **kw)
    again = dl.gemv_single(x, w, ssq=ssq, route=route, **kw)
    counted = dl.gemv_wgmma.launches - n0
    parts_err = None
    if isinstance(got, tuple):
        (got, parts), again = got, again[0]
        want = dl.ssq_parts(got, dl.GEMV_TN, False)
        parts_err = float(((parts - want).abs()
                           / want.abs().clamp(min=1e-6)).max())
    return (got, gemv_excess(torch, got, ref, slack), parts_err,
            bool(torch.equal(got, again)), counted)


def gemv_wgmma_checks(torch, gen, results):
    """K1's bf16-weight GEMV on both routes (the wgmma GEMV and the
    mma.sync GEMV, forced) at WGMMA_SHAPES and B = 1, 8 and 32, element by
    element against the float32 reference with the kernel's roundings
    (ELEMENT_TOL["gemv_single"]), with the step's sums of squares in parts
    and (normed) with the GEMV's own; a second launch must give the same
    bits (the rank-order sum is deterministic) and the counter must count
    the wgmma GEMV's launches and no other."""
    atol = ELEMENT_TOL["gemv_single"][0]
    for label, k, cols, epi in WGMMA_SHAPES:
        for rows in GEMV_ROWS:
            x, w, kw = gemv_wgmma_inputs(torch, gen, k, cols, epi, rows)
            for route in ("wgmma", "mma"):
                for ssq in (True, False) if "norm_w" in kw else (True,):
                    _, excess, parts_err, same, counted = gemv_wgmma_case(
                        torch, x, w, kw, route, ssq)
                    row = {"phase": "kernel", "kernel": "gemv_wgmma",
                           "case": f"{label} B={rows} {route}"
                                   f"{'' if ssq else ' (own sums)'}",
                           "element_excess": excess, "element_atol": atol,
                           "ssq_parts_rel_err": parts_err,
                           "deterministic": same, "wgmma_launches": counted}
                    emit(row)
                    results.append(row)
                    if not excess <= atol:
                        raise AssertionError(
                            f"gemv_wgmma {row['case']}: |err| - 2^-8 |ref| "
                            f"reaches {excess} > {atol}")
                    if parts_err is not None and not parts_err <= 1e-5:
                        raise AssertionError(
                            f"gemv_wgmma {row['case']}: sums of squares off "
                            f"by {parts_err} (relative)")
                    if not same:
                        raise AssertionError(f"gemv_wgmma {row['case']}: two "
                                             f"launches differ")
                    if counted != (2 if route == "wgmma" else 0):
                        raise AssertionError(
                            f"gemv_wgmma {row['case']}: {counted} wgmma "
                            f"launches counted for 2 launches")


def graph_call_ms(torch, fn, calls: int = WGMMA_GRAPH_CALLS) -> dict:
    """fn() captured ``calls`` times in a row in one CUDA graph (its
    launches back to back, with programmatic dependent launch between
    them as in the step): per call, the replay's CUDA-event ms and its
    device ms (busy_us over a profiled replay)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return {"ms": cuda_ms(torch, graph.replay) / calls,
            "device_ms": device_ms(torch, graph.replay, reps=4) / calls}


def gemv_wgmma_timing(torch, gen, card) -> list:
    """The two routes of K1's bf16-weight GEMV alone at the 1.7B shapes and
    WGMMA_TIMED_ROWS rows (gemv_single as the step launches it: the sums of
    squares in parts), beside torch.mm's products on the same weights (the
    yardstick, never on the port's path), the plain version
    (gemv_single_plain, eager) and the bytes bound (weights, x and the
    output over 3.35 TB/s); per (shape, rows) one row with the faster
    route, then the four GEMVs in the step's order (gemv_layer_chain),
    then per row count which route is faster over the four shapes' device
    time, which gemv_route's fixed rule follows (reported, not held)."""
    from qwen3_asr_rs_tpu_torch.ops.kernels import decode_layer as dl

    rows_out = []
    for label, k, cols, epi in WGMMA_SHAPES[:4]:
        for rows in WGMMA_TIMED_ROWS:
            x, w, kw = gemv_wgmma_inputs(torch, gen, k, cols, epi, rows)
            ws = (w if isinstance(w, list) else [w]) + (
                [kw["w_up"]] if "w_up" in kw else [])
            row = {"phase": "kernel", "kernel": "gemv_wgmma_timing",
                   "case": f"{label} B={rows}", "card": card}
            for route in ("wgmma", "mma"):
                launch, _, _ = dl.gemv_single_launcher(
                    x, w, ssq=True, route=route, **kw)
                t = graph_call_ms(torch, launch)
                row[f"{route}_ms"], row[f"{route}_device_ms"] = (
                    t["ms"], t["device_ms"])
            t = graph_call_ms(torch, lambda: [torch.mm(x, m) for m in ws])
            row["mm_ms"], row["mm_device_ms"] = t["ms"], t["device_ms"]
            wcat = torch.cat(w, 1) if isinstance(w, list) else w
            row["plain_ms"] = cuda_ms(torch, lambda: dl.gemv_single_plain(
                x, wcat, **kw))
            n_out = sum(cols)
            moved = sum(nbytes(m) for m in ws) + nbytes(x) + 2 * rows * n_out
            row.update(bound_of(moved, 2 * rows * k * sum(
                m.shape[1] for m in ws)))
            row["weight_mb"] = sum(nbytes(m) for m in ws) / 1e6
            for route in ("wgmma", "mma", "mm"):
                row[f"{route}_bytes_bound_pct"] = (
                    100 * row["bound_ms"] / row[f"{route}_device_ms"])
            row["faster"] = min(("wgmma", "mma"),
                                key=lambda r: row[f"{r}_device_ms"])
            row["route_rule"] = dl.gemv_route(
                0, rows, k, sum(-(-c // dl.GW_TN) for c in cols),
                2 if epi == "swiglu" else 1)
            emit(row)
            rows_out.append(row)
    for rows in WGMMA_TIMED_ROWS:
        row = {"phase": "kernel", "kernel": "gemv_wgmma_layer",
               "case": f"1.7b layer's 4 GEMVs in the step's order B={rows}",
               "card": card, **gemv_layer_chain(torch, gen, rows)}
        emit(row)
        rows_out.append(row)
    by_rows = {}
    for rows in WGMMA_TIMED_ROWS:
        mine = [r for r in rows_out if r["case"].endswith(f"B={rows}")
                and r["kernel"] == "gemv_wgmma_timing"]
        tot = {rt: sum(r[f"{rt}_device_ms"] for r in mine)
               for rt in ("wgmma", "mma")}
        by_rows[f"B={rows}"] = {**{f"{rt}_device_ms_4_shapes": v
                                   for rt, v in tot.items()},
                                "faster": min(tot, key=tot.get),
                                "rule": mine[0]["route_rule"]}
    emit({"phase": "kernel", "kernel": "gemv_wgmma_routes",
          "by_rows": by_rows, "card": card})
    return rows_out


def gemv_layer_chain(torch, gen, rows: int) -> dict:
    """The 1.7B layer's four GEMVs (q|k|v, o, gate|up, down) back to back
    in the step's order, as each route launches them (programmatic
    dependent launch between them; no attention between q|k|v and o), and
    torch.mm's products of the same weights: microseconds a layer (CUDA
    events over a captured run of 5 layers), beside the layer's bytes
    bound."""
    from qwen3_asr_rs_tpu_torch.ops.kernels import decode_layer as dl

    cases = [gemv_wgmma_inputs(torch, gen, k, cols, epi, rows)
             for _, k, cols, epi in WGMMA_SHAPES[:4]]
    out, moved = {}, 0
    for x, w, kw in cases:
        moved += sum(nbytes(m) for m in (w if isinstance(w, list) else [w]))
        moved += nbytes(kw["w_up"]) if "w_up" in kw else 0
    out["bound_us"] = 1e6 * moved / HBM_BYTES_PER_S
    for route in ("wgmma", "mma"):
        launches = [dl.gemv_single_launcher(x, w, ssq=True, route=route,
                                            **kw)[0] for x, w, kw in cases]
        t = graph_call_ms(torch, lambda: [f() for f in launches], calls=5)
        out[f"{route}_us"] = 1e3 * t["ms"]
        out[f"{route}_device_us"] = 1e3 * t["device_ms"]
    mats = [(x, (w if isinstance(w, list) else [w])
             + ([kw["w_up"]] if "w_up" in kw else [])) for x, w, kw in cases]
    t = graph_call_ms(torch, lambda: [torch.mm(x, m) for x, ms in mats
                                      for m in ms], calls=5)
    out["mm_us"], out["mm_device_us"] = 1e3 * t["ms"], 1e3 * t["device_ms"]
    for route in ("wgmma", "mma", "mm"):
        out[f"{route}_bytes_bound_pct"] = (100 * out["bound_us"]
                                           / out[f"{route}_device_us"])
    return out


def wgmma_engine_check(torch, config, enc32, dec32, audio, card) -> dict:
    """AsrEngine at full 0.6B width, bf16 weights, 32 clips in one
    transcribe_batch: the wgmma GEMV's launch counter (``gemv_wgmma``,
    replays counted through ``ops.kernels.COUNTED``) must read 4 launches
    a layer and decode step across the call (112 a step at 28 layers); a
    second run of the same batch must give the same tokens."""
    from qwen3_asr_rs_tpu_torch.ops.kernels.decode_layer import gemv_wgmma
    from qwen3_asr_rs_tpu_torch.runtime.engine import AsrEngine

    engine = AsrEngine(None, dtype=torch.bfloat16, max_new_tokens=128,
                       config=config, params=(enc32, dec32),
                       tokenizer=StubTokenizer(), device="cuda")
    samples = [audio[c] for c in FIVE_CLIPS] * 6 + [audio[4]] * 2
    engine.transcribe_batch(samples)  # warm-up: captures
    layers = config.text.num_hidden_layers
    n0 = gemv_wgmma.launches
    first = engine.transcribe_batch(samples)
    steps = engine.last_stats["decode_steps"]
    counted = gemv_wgmma.launches - n0
    second = engine.transcribe_batch(samples)
    same = [a.text for a in first] == [b.text for b in second]
    row = {"phase": "batch", "run": "wgmma counter, 32 clips",
           "B": len(samples), "decode_steps": steps,
           "gemv_wgmma_launches": counted,
           "per_step": counted / steps if steps else None,
           "want_per_step": 4 * layers,
           "tokens_identical_over_two_runs": same, "card": card}
    emit(row)
    del engine
    torch.cuda.empty_cache()
    if not (steps and counted == 4 * layers * steps):
        raise AssertionError(f"wgmma counter: {counted} for {steps} steps, "
                             f"want {4 * layers} a step")
    if not same:
        raise AssertionError("two runs of one batch gave other tokens")
    return row


def gemv_yardstick(torch, dec_params_f32) -> dict:
    """The GEMVs' yardstick per layer: one 0.6B layer's seven products (q,
    k, v, o, gate, up, down) as torch.mm on bf16 weights at B = 1, 8 and
    32; event and device ms. Timed here only, never on the port's path."""
    lay = dec_params_f32["layers"]
    ws = [lay[n][0].to(torch.bfloat16) for n in ("q_w", "k_w", "v_w", "o_w",
                                                 "gate_w", "up_w", "down_w")]
    out = {}
    for b in GEMV_ROWS:
        xs = [torch.randn((b, w.shape[0]), device="cuda").bfloat16()
              for w in ws]

        def products():
            return [torch.mm(x, w) for x, w in zip(xs, ws)]

        out[f"B={b}"] = {"ms": cuda_ms(torch, products),
                         "device_ms": device_ms(torch, products)}
    return out


def k5_summary(rows) -> dict:
    """K5's bf16 cases for the kernels line: each case's device time,
    bound, both library times and element excess."""
    keys = ("case", "dtype", "ms", "device_ms", "bound_ms", "bound_by",
            "library_device_ms", "library_mm_device_ms", "element_excess")
    return {"cases": [{k: r[k] for k in keys if k in r} for r in rows]}


def kernel_launches(torch, fn, reps: int = 5) -> tuple:
    """(K1's kernels, PyTorch's kernels, their names) launched per fn()
    call, counted from torch.profiler's device events (copies and sets
    not counted; PyTorch's kernels are those of its at:: namespace)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA
             and not e.name.startswith(("Memcpy", "Memset"))]
    torch_names = [n for n in names if "at::" in n]
    mine = len(names) - len(torch_names)
    if not mine > 0:
        raise AssertionError("profiler: no K1 kernel launches recorded")
    return (mine / reps, len(torch_names) / reps,
            sorted({n[:60] for n in torch_names}))


def k1_launch_check(torch, results, label, fn, extra: int = 0) -> None:
    """K1's kernels per call, which must be at most 6 per layer (+ extra:
    the folded lm_head's); the wrapper's own (a fill of a start index
    given as an int) are reported beside them."""
    n, other, other_names = kernel_launches(torch, fn)
    row = {"phase": "kernel", "kernel": "k1_launches", "case": label,
           "launches_per_call": n, "per_layer": (n - extra) / L,
           "pytorch_kernels_per_call": other,
           "pytorch_kernels": other_names}
    emit(row)
    results.append(row)
    if not n <= 6 * L + extra:
        raise AssertionError(f"K1 {label}: {n} kernels per call, more than "
                             f"6 per layer")


# K1 layouts whose kernels per call are counted: (label, bits or None,
# merged, int4g group size or None, folded int8 lm_head)
K1_LAYOUTS = (("bf16 per projection", None, False, None, False),
              ("int8 merged", 8, True, None, False),
              ("int8 per projection", 8, False, None, False),
              ("int4 merged", 4, True, None, False),
              ("int4 per projection", 4, False, None, False),
              ("int4g g128 merged", 4, True, 128, False),
              ("bf16 per projection, folded int8 lm_head", None, False, None,
               True))


def k1_layout_launches(torch, dec_params_f32, gen, results):
    """Phase 3: K1's kernels per call in every weight layout (B = 1, S =
    360, bf16), at most 6 per layer; the folded lm_head adds its GEMV and
    the argmax's finish."""
    from qwen3_asr_rs_tpu_torch.ops.kernels.decode_layer import (
        decode_layers_fused)
    from qwen3_asr_rs_tpu_torch.ops.quant import quantize_weight

    dt = torch.bfloat16
    x, cos, sin, ks, vs = k1_inputs(torch, gen, dt, 360, 217)
    for label, bits, merge, group, fold in K1_LAYOUTS:
        if bits is None:
            lay = {k: v.to(dt) for k, v in dec_params_f32["layers"].items()}
        else:
            lay = quantized_tree(torch, dec_params_f32, dt, bits, merge,
                                 group)["layers"]
        kw = {}
        if fold:
            lm_w, lm_s = quantize_weight(dec_params_f32["lm_head"].T)
            kw = dict(fold_lm=True, final_ln_w=torch.ones(H, dtype=dt,
                                                          device="cuda"),
                      lm_head=lm_w, lm_scales=lm_s)
        k1_launch_check(torch, results, label, lambda: decode_layers_fused(
            x, cos, sin, lay, ks, vs, 0, 217, eps=1e-6, **kw),
            extra=2 if fold else 0)
        del lay, kw
    torch.cuda.empty_cache()


def int4g_kernel_checks(torch, dec_params_f32, gen, results):
    """Phase 3, int4g: K1 with merged group-wise int4 weights (the
    port's quantizer) at group sizes 128 and 64."""
    for group in K1_INT4G_GROUPS:
        for dtype in (torch.float32, torch.bfloat16):
            lay = quantized_tree(torch, dec_params_f32, dtype, 4, True,
                                 group)["layers"]
            for b, s_max, end, int8_slab in K1_INT4G_CASES:
                k1_check(torch, gen, results, dtype, lay, b, s_max, end,
                         f"int4g g{group} merged", int8_slab)
            del lay
            torch.cuda.empty_cache()


def fold_kernel_checks(torch, dec_params_f32, gen, results):
    """Phase 3, the folded lm_head: K1 with fold_lm against the plain
    fold, bf16/f32 (V, H) and int8 (H, V) lm_heads, B = 1 and 8; then a
    constructed tie. float32: the kernel's tokens must equal the plain
    version's (decode_layers_fused_plain with fold_lm) on the same inputs.
    Both dtypes: the kernel's token is scored by the plain fold on the
    final hidden state of the same kernel run unfolded (its split-K sums
    have a fixed order, so its layers are deterministic: the folded run's
    K/V must come out equal), so the check holds the fold alone; in bf16,
    where 28 layers of rounding flips separate the two sides' hidden
    states, the plain version's own tokens are reported."""
    from qwen3_asr_rs_tpu_torch.ops.kernels.decode_layer import (
        _rms, decode_layers_fused, decode_layers_fused_plain)
    from qwen3_asr_rs_tpu_torch.ops.quant import quantize_weight

    dev = torch.device("cuda")

    def logits_of(h, final_ln, lm_w, lm_s):
        xn = _rms(h, final_ln, 1e-6).to(h.dtype).float()
        if lm_s is None:
            return xn @ lm_w.float().T
        return (xn @ lm_w.float()) * lm_s

    for dtype in (torch.float32, torch.bfloat16):
        lay = {k: v.to(dtype) for k, v in dec_params_f32["layers"].items()}
        lm_f = dec_params_f32["lm_head"].to(dtype)
        final_ln = torch.ones(H, dtype=dtype, device=dev)
        lm_int8 = quantize_weight(lm_f.T)
        for lm_name, (lm_w, lm_s) in (("bf16" if dtype == torch.bfloat16
                                       else "f32", (lm_f, None)),
                                      ("int8", lm_int8)):
            for b in (1, 8):
                x, cos, sin, ks, vs = k1_inputs(torch, gen, dtype, 360, 301,
                                                b)
                starts = row_starts(b)
                start = torch.tensor(starts, dtype=torch.int32, device=dev)
                ends = torch.full((b,), 301, dtype=torch.int32, device=dev)
                kw = dict(eps=1e-6, fold_lm=True, final_ln_w=final_ln,
                          lm_head=lm_w, lm_scales=lm_s)

                def kernel():
                    return decode_layers_fused(x, cos, sin, lay, ks, vs,
                                               start, 301, **kw)

                def plain():
                    return decode_layers_fused_plain(x, cos, sin, lay, ks, vs,
                                                     start, ends, **kw)

                tok, fks, fvs = kernel()
                h, uks, uvs = decode_layers_fused(x, cos, sin, lay, ks, vs,
                                                  start, 301, eps=1e-6)
                if not (torch.equal(fks, uks) and torch.equal(fvs, uvs)):
                    raise AssertionError("K1 fold: the folded run's K/V "
                                         "differ from the unfolded run's")
                logits = logits_of(h, final_ln, lm_w, lm_s)
                best = logits.max(-1).values
                gap = float((best - logits.gather(
                    1, tok.long()[:, None])[:, 0]).max())
                atol, rtol = FOLD_LOGIT_TOL[str(dtype)[6:]]
                tol = atol + rtol * float(logits.abs().max())
                plain_tok = plain()[0]
                if dtype == torch.float32 and not torch.equal(
                        plain_tok.long(), tok.long()):
                    raise AssertionError(
                        f"K1 fold {lm_name} B={b} float32: tokens "
                        f"{tok.tolist()} != plain {plain_tok.tolist()}")
                row = {"phase": "kernel", "kernel": "decode_layers_fused",
                       "dtype": str(dtype)[6:],
                       "case": f"fold {lm_name} lm_head B={b} L=28 S=360 "
                               f"start={starts} end=301",
                       "max_logit_gap": gap, "bound": tol,
                       "atol": atol, "rtol": rtol,
                       "plain_tokens_equal": (plain_tok.long() == tok.long())
                       .float().mean().item(),
                       "ms": cuda_ms(torch, kernel),
                       "unfolded_ms": cuda_ms(
                           torch, lambda: decode_layers_fused(
                               x, cos, sin, lay, ks, vs, start, 301,
                               eps=1e-6)),
                       "plain_ms": cuda_ms(torch, plain, reps=3, warmup=1),
                       **k1_work(lay, x, ks, vs, starts, 301, None, lm_w,
                                 lm_s),
                       "headline": False}
                row["max_abs_err"] = gap
                emit(row)
                results.append(row)
                if not gap <= tol:
                    raise AssertionError(f"K1 fold {row['case']}: the "
                                         f"token's logit is {gap} below the "
                                         f"best, bound {tol}")
        # a tie: two equal rows (int8: columns) that beat every other
        # logit give the lower index
        x, cos, sin, ks, vs = k1_inputs(torch, gen, dtype, 360, 301, 1)
        h = decode_layers_fused(x, cos, sin, lay, ks, vs, 0, 301,
                                eps=1e-6)[0]
        lm_tie = lm_f.clone()
        lm_tie[1000] = lm_tie[2000] = (50 * _rms(h, final_ln, 1e-6))[0].to(
            dtype)
        for lm_name, (lm_w, lm_s) in (("float", (lm_tie, None)),
                                      ("int8", quantize_weight(lm_tie.T))):
            tok = decode_layers_fused(
                x, cos, sin, lay, ks, vs, 0, 301, eps=1e-6, fold_lm=True,
                final_ln_w=final_ln, lm_head=lm_w, lm_scales=lm_s)[0]
            emit({"phase": "kernel", "kernel": "decode_layers_fused",
                  "dtype": str(dtype)[6:],
                  "case": f"fold {lm_name} lm_head tie rows 1000 = 2000",
                  "token": tok.tolist()})
            if tok.tolist() != [1000]:
                raise AssertionError(f"K1 fold tie ({lm_name}): token "
                                     f"{tok.tolist()}, expected [1000]")
        del lay, lm_f, lm_int8, lm_tie
        torch.cuda.empty_cache()


def slab_kernel_checks(torch, gen, results):
    """Phase 3, K6: decode_attention_slab at layer 1 of a 3-layer slab,
    and the single-layer decode_attention, against their plain
    versions."""
    from qwen3_asr_rs_tpu_torch.ops.kernels.decode_attention import (
        decode_attention, decode_attention_plain, decode_attention_slab,
        decode_attention_slab_plain)

    dev = torch.device("cuda")
    for dtype in (torch.float32, torch.bfloat16):
        for b, s, hq, hkv, d, starts, ends in K6_CASES:
            k3, v3 = (torch.randn((3, b, hkv, s, d), generator=gen,
                                  device=dev).to(dtype) for _ in range(2))
            q = torch.randn((b, hq, d), generator=gen, device=dev).to(dtype)
            k_self, v_self = (torch.randn((b, hkv, d), generator=gen,
                                          device=dev).to(dtype)
                              for _ in range(2))
            start = None if starts is None else torch.tensor(
                starts, dtype=torch.int32, device=dev)
            end = torch.tensor(ends, dtype=torch.int32, device=dev)
            first = [0] * b if starts is None else starts
            case = f"B={b} S={s} Hq={hq} Hkv={hkv} D={d} start={starts} end={ends}"
            headline = dtype == torch.bfloat16 and s == 4992
            check_case(
                torch, results, "decode_attention_slab", dtype,
                case + " layer=1",
                lambda: decode_attention_slab(q, k3, v3, k_self, v_self, 1,
                                              start, end),
                lambda: decode_attention_slab_plain(q, k3, v3, k_self, v_self,
                                                    1, start, end),
                reference=(lambda: decode_attention_slab_plain(
                    q.float(), k3, v3, k_self, v_self, 1, start, end))
                if dtype == torch.bfloat16 else None,
                work=attn_work(q, k3, first, ends),
                library=(sdpa_decode(torch, q, k3, v3, k_self, v_self, 1,
                                     first[0], ends[0]) if headline else None),
                headline=headline,
                device=headline,
            )
            check_case(
                torch, results, "decode_attention", dtype,
                case + " (single-layer wrapper)",
                lambda: decode_attention(q, k3[2], v3[2], k_self, v_self,
                                         start, end),
                lambda: decode_attention_plain(q, k3[2], v3[2], k_self,
                                               v_self, start, end),
                reference=(lambda: decode_attention_plain(
                    q.float(), k3[2], v3[2], k_self, v_self, start, end))
                if dtype == torch.bfloat16 else None,
                work=attn_work(q, k3, first, ends),
            )
            del k3, v3
    torch.cuda.empty_cache()


def sdpa_rows(torch, q, ks, vs, k_self, v_self, layer, ends):
    """One PyTorch call computing K2's function at per-row ends: SDPA with
    GQA over the whole slab with the self K/V appended and a boolean mask
    of each row's live slots and its self slot (made here, untimed)."""
    b, _, s, _ = ks[layer].shape
    k = torch.cat([ks[layer], k_self[:, :, None]], 2)
    v = torch.cat([vs[layer], v_self[:, :, None]], 2)
    slot = torch.arange(s + 1, device=q.device)[None, :]
    end = torch.tensor(ends, device=q.device)[:, None]
    mask = ((slot < end) | (slot == s))[:, None, None, :]
    qq = q[:, :, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(qq, k, v, attn_mask=mask, enable_gqa=True)


def k2_row_end_checks(torch, gen, results):
    """Phase 3, serving's K2 route: B = 8 rows at the distinct ends of
    K2_ROW_ENDS (one at 0: only its own K/V) with start None, on bf16
    and int8 slabs (bf16 queries), each against its plain version and
    element by element against it from float32 queries, with device
    times; the bf16 case also times SDPA with a mask over the same rows
    (one call)."""
    from qwen3_asr_rs_tpu_torch.models.text_decoder import quantize_kv
    from qwen3_asr_rs_tpu_torch.ops.kernels.decode_attention import (
        decode_attention_dma, decode_attention_dma_plain)

    dev = torch.device("cuda")
    b, s, dtype = len(K2_ROW_ENDS), K2_ROW_END_S, torch.bfloat16
    ends = torch.tensor(K2_ROW_ENDS, dtype=torch.int32, device=dev)
    q = torch.randn((b, HQ, D), generator=gen, device=dev).to(dtype)
    k_self, v_self = (torch.randn((b, HKV, D), generator=gen,
                                  device=dev).to(dtype) for _ in range(2))
    for int8 in (False, True):
        raw = [torch.randn((L, b, HKV, s, D), generator=gen, device=dev)
               for _ in range(2)]
        if int8:
            (ks, kscale), (vs, vscale) = (quantize_kv(t) for t in raw)
            kw = dict(k_scales=kscale, v_scales=vscale)
        else:
            ks, vs = (t.to(dtype) for t in raw)
            kw = {}
        del raw
        check_case(
            torch, results, "decode_attention_dma", dtype,
            f"{'int8 slab ' if int8 else ''}per-row ends B={b} S={s} "
            f"start=None end={list(K2_ROW_ENDS)} layer=27",
            lambda: decode_attention_dma(q, ks, vs, k_self, v_self, 27, None,
                                         ends, **kw),
            lambda: decode_attention_dma_plain(q, ks, vs, k_self, v_self, 27,
                                               None, ends, **kw),
            reference=lambda: decode_attention_dma_plain(
                q.float(), ks, vs, k_self, v_self, 27, None, ends, **kw),
            work=attn_work(q, ks, [0] * b, K2_ROW_ENDS, int8=int8),
            library=None if int8 else sdpa_rows(torch, q, ks, vs, k_self,
                                                v_self, 27, K2_ROW_ENDS),
            device=True,
        )
        del ks, vs
        kw.clear()
    torch.cuda.empty_cache()


def batch_kernel_checks(torch, dec_params_f32, gen, results):
    """Phase 3, batched: K1 at B > 1 with per-row starts, K1 and K2 on
    int8 slabs, K3 at B = 2 with per-row kv_start."""
    from qwen3_asr_rs_tpu_torch.models.text_decoder import quantize_kv
    from qwen3_asr_rs_tpu_torch.ops.kernels.decode_attention import (
        decode_attention_dma, decode_attention_dma_plain)
    from qwen3_asr_rs_tpu_torch.ops.kernels.decode_layer import (
        decode_layers_fused, decode_layers_fused_plain)
    from qwen3_asr_rs_tpu_torch.ops.kernels.flash_attention import (
        flash_attention, flash_attention_plain, flash_attention_tile_reference)

    dev = torch.device("cuda")

    def idx(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    def k1_case(dtype, lay, b, s_max, end, label, int8_slabs=False):
        k1_check(torch, gen, results, dtype, lay, b, s_max, end, label,
                 int8_slabs)

    for dtype in (torch.float32, torch.bfloat16):
        lay = {k: v.to(dtype) for k, v in dec_params_f32["layers"].items()}
        for b in K1_BATCH:
            k1_case(dtype, lay, b, 360, 301, "float weights")
        for b, s_max, end in KV8_CASES:
            k1_case(dtype, lay, b, s_max, end, "int8 slab", int8_slabs=True)
        del lay
        for bits, batches in K1_BATCH_QUANT:
            qlay = quantized_tree(torch, dec_params_f32, dtype, bits,
                                  True)["layers"]
            for b in batches:
                k1_case(dtype, qlay, b, 360, 301, f"int{bits} merged weights")
            del qlay
        torch.cuda.empty_cache()

        for b, s_max, end in KV8_CASES:
            (kq, kscale), (vq, vscale) = (
                quantize_kv(torch.randn((L, b, HKV, s_max, D), generator=gen,
                                        device=dev)) for _ in range(2))
            q = torch.randn((b, HQ, D), generator=gen, device=dev).to(dtype)
            k_self = torch.randn((b, HKV, D), generator=gen,
                                 device=dev).to(dtype)
            v_self = torch.randn_like(k_self)
            start, ends = idx(row_starts(b)), idx([end] * b)
            check_case(
                torch, results, "decode_attention_dma", dtype,
                f"int8 slab B={b} S={s_max} start={row_starts(b)} end={end} "
                "layer=27",
                lambda: decode_attention_dma(q, kq, vq, k_self, v_self, 27, start,
                                         ends, k_scales=kscale,
                                         v_scales=vscale),
                lambda: decode_attention_dma_plain(q, kq, vq, k_self, v_self, 27,
                                               start, ends, k_scales=kscale,
                                               v_scales=vscale),
                reference=(lambda: decode_attention_dma_plain(
                    q.float(), kq, vq, k_self, v_self, 27, start, ends,
                    k_scales=kscale, v_scales=vscale))
                if dtype == torch.bfloat16 else None,
                work=attn_work(q, kq, row_starts(b), [end] * b, int8=True),
                device=dtype == torch.bfloat16 and b > 1 and s_max > 360,
            )
            del kq, vq, kscale, vscale
        # the same rows on a slab of the compute dtype (the bf16 cell of
        # K2 inside K1 at B = 8, S = 4992)
        for b, s_max, end in (c for c in KV8_CASES if c[0] > 1 and c[1] > 360):
            ks, vs = (torch.randn((L, b, HKV, s_max, D), generator=gen,
                                  device=dev).to(dtype) for _ in range(2))
            q = torch.randn((b, HQ, D), generator=gen, device=dev).to(dtype)
            k_self, v_self = (torch.randn((b, HKV, D), generator=gen,
                                          device=dev).to(dtype)
                              for _ in range(2))
            start, ends = idx(row_starts(b)), idx([end] * b)
            check_case(
                torch, results, "decode_attention_dma", dtype,
                f"B={b} S={s_max} start={row_starts(b)} end={end} layer=27",
                lambda: decode_attention_dma(q, ks, vs, k_self, v_self, 27,
                                             start, ends),
                lambda: decode_attention_dma_plain(q, ks, vs, k_self, v_self,
                                                   27, start, ends),
                reference=(lambda: decode_attention_dma_plain(
                    q.float(), ks, vs, k_self, v_self, 27, start, ends))
                if dtype == torch.bfloat16 else None,
                work=attn_work(q, ks, row_starts(b), [end] * b),
                device=dtype == torch.bfloat16,
            )
            del ks, vs

    # K3 at the 360-chunk prefill bucket, B = 2 right-aligned rows; query
    # rows before a row's start have no key (compared from the later one)
    S, kv_start = 4736, (0, 517)
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randn((2, S, HQ, D), generator=gen, device=dev).to(dtype)
        k = torch.randn((2, S, HKV, D), generator=gen, device=dev).to(dtype)
        v = torch.randn((2, S, HKV, D), generator=gen, device=dev).to(dtype)
        start = idx(list(kv_start))
        check_case(
            torch, results, "flash_attention", dtype,
            f"B=2 Sq=Sk={S} causal kv_start={kv_start}",
            lambda: flash_attention(q, k, v, None, start, causal=True),
            lambda: flash_attention_plain(q, k, v, None, start, causal=True),
            rows=(slice(None), slice(max(kv_start), None)),
            reference=(lambda: flash_attention_tile_reference(
                q, k, v, None, start, causal=True))
            if dtype == torch.bfloat16 else None,
            work=bound_of(nbytes(q, k, v, q), 4 * HQ * D * sum(
                (S - s0) * (S - s0 + 1) // 2 for s0 in kv_start)),
            device=dtype == torch.bfloat16,
        )
        del q, k, v
    torch.cuda.empty_cache()


PROMPT_IDS = 15  # the prompt's ids around the audio tokens
# K3's cases at the offline 32-clip batch's shapes (k3_main_path_checks),
# which the kernels line reports beside the headline
K3_MAIN_PATH = ("32 clips x 30 chunks: audio-tower windows",
                "32 clips x 30 chunks: decoder prefill")


def clip_frames(rng, n: int, chunks: int, chunk_frames: int) -> list:
    """True mel frames of n clips of one chunk bucket: lognormal seconds of
    median chunks / 3, sigma 0.5, within [1, chunks] (100 frames a s)."""
    secs = rng.lognormal(math.log(chunks / 3), 0.5, n).clip(1.0, chunks)
    return [min(int(s * 100), chunks * chunk_frames) for s in secs]


def sdpa_masked(torch, q, k, v, causal, kv_valid=None, kv_start=None):
    """One PyTorch call computing K3's function with its masks: SDPA with
    GQA on (B, heads, S, D) copies of the inputs, ``kv_valid`` and
    ``kv_start`` as an additive bf16 mask (copies and mask made here,
    untimed); without either, ``is_causal``."""
    from qwen3_asr_rs_tpu_torch.ops.attention import MASK_VALUE

    qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if kv_valid is None and kv_start is None:
        return lambda: sdpa(qt, kt, vt, is_causal=causal, enable_gqa=True)
    s = k.shape[1]
    pos = torch.arange(s, device=q.device)
    ok = torch.ones((q.shape[0], q.shape[1], s), dtype=torch.bool,
                    device=q.device)
    if causal:
        ok &= (pos[None, :] <= pos[:, None])[None]
    if kv_start is not None:
        ok &= pos[None, None, :] >= kv_start[:, None, None]
    if kv_valid is not None:
        ok &= pos[None, None, :] < kv_valid[:, None, None]
    mask = torch.where(ok, 0.0, MASK_VALUE).to(q.dtype)[:, None]
    return lambda: sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True)


def k3_main_path_checks(torch, gen, results):
    """Phase 3, K3 where the main path calls it in the offline batch of 32
    clips of the 30-chunk bucket (clip lengths by ``clip_frames``): the
    audio tower's windows (one per ``chunks_per_window`` chunks of a clip,
    not causal, ``kv_valid`` each window's valid tokens, windows past a
    clip's end empty) and the decoder's prefill (32 right-aligned prompts
    in the 432-slot bucket, causal, ``kv_start`` each row's first slot).
    bf16, held to flash_attention_plain on the query rows that have a key
    (the others are discarded by callers), and not element by element:
    against the tile reference the prefill case's largest excess reads
    about ELEMENT_TOL's atol (0.0011 to 0.0021 over four inputs on an
    H100), so that check would fail on some draws. Times beside SDPA with the same masks (``sdpa_masked``) and
    the bound of the live work."""
    import numpy as np

    from qwen3_asr_rs_tpu_torch.config import AsrConfig, audio_tokens
    from qwen3_asr_rs_tpu_torch.ops.kernels.flash_attention import (
        flash_attention, flash_attention_plain)

    dev = torch.device("cuda")
    audio = AsrConfig().audio
    clips, chunks, p = 32, 30, 432
    frames = clip_frames(np.random.default_rng(SEED), clips, chunks,
                         audio.chunk_frames)
    nh = audio.encoder_attention_heads
    hd = audio.d_model // nh
    s = min(chunks, audio.chunks_per_window) * audio.tokens_per_chunk
    per_clip = -(-chunks // audio.chunks_per_window)
    counts = [int(min(max(audio_tokens(audio, f) - w * s, 0), s))
              for f in frames for w in range(per_clip)]
    lens = [audio_tokens(audio, f) + PROMPT_IDS for f in frames]
    starts = [p - n for n in lens]
    # (label, B, S, Hq, Hkv, D, causal, masks, rows with a key, operations)
    cases = (
        (K3_MAIN_PATH[0], len(counts), s, nh, nh, hd, False,
         dict(kv_valid=counts),
         torch.tensor(counts, device=dev)[:, None].gt(0).repeat(1, s),
         4 * nh * hd * s * sum(counts)),
        (K3_MAIN_PATH[1], clips, p, HQ, HKV, D, True,
         dict(kv_start=starts),
         torch.arange(p, device=dev)[None, :]
         >= torch.tensor(starts, device=dev)[:, None],
         4 * HQ * D * sum(n * (n + 1) // 2 for n in lens)),
    )
    for label, b, sq, hq, hkv, d, causal, kw, live, ops in cases:
        q = torch.randn((b, sq, hq, d), generator=gen,
                        device=dev).bfloat16()
        k = torch.randn((b, sq, hkv, d), generator=gen,
                        device=dev).bfloat16()
        v = torch.randn_like(k)
        kv = {n: torch.tensor(x, dtype=torch.int32, device=dev)
              for n, x in kw.items()}
        kv_valid, kv_start = kv.get("kv_valid"), kv.get("kv_start")
        check_case(
            torch, results, "flash_attention", torch.bfloat16,
            f"{label}: B={b} Sq=Sk={sq} {hq}/{hkv} heads of {d}, "
            f"{'causal ' if causal else ''}{next(iter(kw))}, "
            f"{int(live.sum())} of {live.numel()} query rows with keys",
            lambda: flash_attention(q, k, v, kv_valid, kv_start,
                                    causal=causal),
            lambda: flash_attention_plain(q, k, v, kv_valid, kv_start,
                                          causal=causal),
            rows=live,
            work=bound_of(nbytes(q, k, v, q), ops),
            library=sdpa_masked(torch, q, k, v, causal, kv_valid, kv_start),
            device=True,
        )
        del q, k, v
    torch.cuda.empty_cache()


def write_wav(path: Path, seconds: float, seed: int) -> float:
    """16 kHz PCM16 WAV: a chirp-like tone plus noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n = int(16000 * seconds)
    t = np.arange(n) / 16000.0
    x = 0.3 * np.sin(2 * np.pi * (220 + 40 * np.sin(0.5 * t)) * t)
    x = x + 0.05 * rng.standard_normal(n)
    pcm = (np.clip(x, -1, 1) * 32767).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())
    return seconds


class StubTokenizer:
    """Token ids as text (no tokenizer.json needed)."""

    def encode(self, text):
        return [101] * 4

    def decode(self, ids):
        return " ".join(map(str, ids))


def kernel_wrappers():
    """{name: wrapper} of every counted kernel wrapper
    (``ops.kernels.COUNTED``, each kernel module imported first, named as
    its module names it); each wrapper's ``launches`` is its count. K6
    has two entries: decode_attention_slab and its single-layer wrapper
    decode_attention. Counters a caller registered (lm_head_counter's)
    are not kernels and not listed."""
    import importlib
    import pkgutil

    from qwen3_asr_rs_tpu_torch.ops import kernels

    found = {}
    for m in pkgutil.iter_modules(kernels.__path__):
        mod = importlib.import_module(f"{kernels.__name__}.{m.name}")
        ids = {id(w) for w in kernels.COUNTED}
        found.update((n, w) for n, w in vars(mod).items() if id(w) in ids)
    return found


# (label, quantize, environment, clips) of the main paths; the
# environment is set while the engine is built and while it runs
MAIN_PATHS = (
    ("bf16", None, {}, (4, 30, 300)),
    ("int8", "int8", {}, (4, 30, 300)),
    ("int4", "int4", {}, (4, 30)),
    ("lm8", "lm8", {}, (4,)),
    ("int8 lm4", "int8", {"ASR_LM_BITS": "4"}, (4,)),
    ("int4 lm8", "int4", {"ASR_LM_BITS": "8"}, (4,)),
    ("int4g", "int4g", {}, (4, 30, 300)),
    ("int4g lm4", "int4g", {"ASR_LM_BITS": "4"}, (4,)),
    ("int4g g64", "int4g", {"ASR_INT4_GROUP": "64"}, (4,)),
    ("bf16 fold", None, {"ASR_FOLD_LM": "1"}, (4,)),
    ("int8 fold", "int8", {"ASR_FOLD_LM": "1"}, (4,)),
)


class Env:
    """Set environment variables for a ``with`` block, then restore."""

    def __init__(self, env):
        self.env, self.old = env, {}

    def __enter__(self):
        for k, v in self.env.items():
            self.old[k] = os.environ.get(k)
            os.environ[k] = v

    def __exit__(self, *exc):
        for k, v in self.old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def prefill_flash(config) -> int:
    """K3 launches of one audio-tower call and one decoder prefill of a
    bf16 engine: one a layer of each, since ``auto_attention_impl`` sends
    every bf16 attention on the card to K3."""
    return config.audio.encoder_layers + config.text.num_hidden_layers


def admission_flash(config, stats) -> int:
    """K3 launches of a bf16 pool's admissions, from its ``stats`` over
    the same window: one a layer of the audio tower per encoder call and
    of the decoder per one-pass prefill (a chunked prefill's chunks
    attend without K3)."""
    return (config.audio.encoder_layers * stats["encodes"]
            + config.text.num_hidden_layers * stats["prefills"])


def expected_launches(quantize, env, layers: int, steps: int, flash: int):
    """Launches each kernel must show for one greedy clip, and the lm_head
    products outside K1: K1 once per decode step, K2 once per layer and
    step (counted by K1's C entry), K3 ``flash`` times (the prefill's:
    ``prefill_flash``); int8 layers:
    K5 for the 4 merged prefill linears of each layer; an int8 lm_head:
    K5 at the last prompt token and each step; an int4 lm_head: K4
    likewise. Folded (ASR_FOLD_LM=1, not with an int4 lm_head), the steps
    take the lm_head inside K1: only the prefill's lm_head runs outside
    it. K6 has no main-path caller; greedy decoding draws nothing. None:
    must be above 0."""
    lm = int(env.get("ASR_LM_BITS", 0)) or {
        "int8": 8, "int4": 4, "int4g": 8, "lm8": 8}.get(quantize, 0)
    per_step = 0 if env.get("ASR_FOLD_LM") == "1" and lm != 4 else steps
    return {
        "decode_layers_fused": steps,
        "decode_attention_dma": layers * steps,
        "flash_attention": flash,
        "quant_matmul": (4 * layers if quantize == "int8" else 0)
        + (per_step + 1 if lm == 8 else 0),
        "quant_matvec_int4": per_step + 1 if lm == 4 else 0,
        "decode_attention_slab": 0,
        "decode_attention": 0,
        "gumbel_argmax": 0,
        "threefry_noise": 0,
        "lm_head_products": per_step + 1,
    }


@contextlib.contextmanager
def lm_head_counter(engine):
    """The counter of the decoder's lm_head products (``TextDecoder.logits``,
    the cuBLAS, K5 or K4 product after the final norm) while the block
    runs: a wrapper whose ``launches`` counts its calls, registered with
    the decode loop's graph captures (``ops.kernels.COUNTED``) so that
    replays add the products they hold, as for the kernel wrappers. Held
    over every run of an engine, whose graphs keep their counter; on exit
    the decoder gets its method back and ``COUNTED`` drops the counter."""
    from qwen3_asr_rs_tpu_torch.ops.kernels import COUNTED

    dec = engine.decoder
    logits = dec.logits

    def counted(*args, **kwargs):
        counted.launches += 1
        return logits(*args, **kwargs)

    counted.launches = 0
    dec.logits = counted
    COUNTED.append(counted)
    try:
        yield counted
    finally:
        COUNTED.remove(counted)
        del dec.logits


def check_launches(what, got, want):
    for n, w in want.items():
        if (got[n] <= 0) if w is None else (got[n] != w):
            raise AssertionError(f"{what}: {n} launched {got[n]} times, "
                                 f"expected {'> 0' if w is None else w}")


def run_path(torch, engine, lm, clips, label, quantize, env, card):
    """Phase 4 for one engine (``lm``: its lm_head_counter): a warm-up,
    then the counters set to 0 and the clips transcribed, each checked
    against expected_launches. Returns ({kernel: launches in this path's
    run}, {clip seconds: {kernel: launches}})."""
    fns = kernel_wrappers()
    layers = engine.config.text.num_hidden_layers
    engine.transcribe(clips[4])  # warm-up: CUDA context, cuBLAS, kernels
    for fn in fns.values():
        fn.launches = 0
    per_clip = {}
    for seconds, path in clips.items():
        before = {n: fn.launches for n, fn in fns.items()}
        lm_before = lm.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = engine.transcribe(path)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = engine.last_stats
        steps = st["decode_steps"]
        got = {n: fn.launches - before[n] for n, fn in fns.items()}
        got["lm_head_products"] = lm.launches - lm_before
        per_clip[seconds] = got
        row = {"phase": "main", "path": label, "quantize": quantize,
               "env": env, "clip_seconds": seconds,
               "language": r.language, "text_chars": len(r.text),
               "tokens": len(r.raw_output.split()), "decode_steps": steps,
               "replays": st["replays"], "slab_lens": st["slab_lens"],
               "segments": len(r.segments or []),
               "k1_launches": got["decode_layers_fused"],
               "k2_launches": got["decode_attention_dma"],
               "k3_launches": got["flash_attention"],
               "k4_launches": got["quant_matvec_int4"],
               "k5_launches": got["quant_matmul"],
               "lm_head_products": got["lm_head_products"],
               "wall_s": wall, "xRT": seconds / wall,
               "prefill_s": st["prefill_seconds"],
               "decode_ms_per_token": (1e3 * st["decode_seconds"] / steps
                                       if steps else None),
               "decode_gpu_ms_per_step": (
                   1e3 * st["decode_gpu_seconds"] / steps
                   if steps else None),
               "card": card}
        emit(row)
        if not isinstance(r.language, str) or not isinstance(r.text, str):
            raise AssertionError("transcription gave no language/text")
        check_launches(f"{label} {seconds} s", got,
                       expected_launches(quantize, env, layers, steps,
                                         prefill_flash(engine.config)))
    return {n: fn.launches for n, fn in fns.items()}, per_clip


# phase 5: (label, clip seconds, kv_dtype, quantize, environment at run
# time); a single clip takes the B = 1 path. Clips of one length share
# one WAV.
FIVE_CLIPS = (4, 8, 15, 22, 30)
BATCH_RUNS = (("5 clips", FIVE_CLIPS, None, None, {}),
              ("32 x 4 s", (4,) * 32, None, None, {}),
              ("5 clips", FIVE_CLIPS, "int8", None, {}),
              ("8 x 300 s", (300,) * 8, "int8", None, {}),
              ("B=1 4 s", (4,), "int8", None, {}),
              ("5 clips", FIVE_CLIPS, "int8", "int8", {}),
              ("5 clips", FIVE_CLIPS, None, "int4", {}),
              ("5 clips", FIVE_CLIPS, None, "int4g", {}),
              ("5 clips", FIVE_CLIPS, None, "int4g", {"ASR_FOLD_LM": "1"}))


def run_batch(torch, engine, lm, samples, label, seconds, kv_dtype, quantize,
              env, card):
    """Phase 5 for one batch (``lm``: the engine's lm_head_counter): a
    warm-up of the same batch, then the
    counters set to 0 and the batch transcribed once more; checks the
    launch counts (K1 once per step, K2 once per layer and step, K3 a
    layer of the encoder and of the decoder prefill, K4/K5 and the lm_head products as
    ``expected_launches`` says for the weights) and that pad rows emit
    nothing."""
    from qwen3_asr_rs_tpu_torch.features.mel import num_mel_frames

    fns = kernel_wrappers()
    layers = engine.config.text.num_hidden_layers
    with Env(env):
        engine.transcribe_batch(samples)
        for fn in fns.values():
            fn.launches = 0
        lm.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = engine.transcribe_batch(samples)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    got = {n: fn.launches for n, fn in fns.items()}
    got["lm_head_products"] = lm.launches
    st = engine.last_stats
    steps, n_gen = st["decode_steps"], st["n_gen"]
    b, live = len(n_gen), len(samples)
    row = {"phase": "batch", "run": label, "kv": kv_dtype or "bf16",
           "quantize": quantize, "env": env, "B": b, "live_rows": live,
           "bucket_chunks": engine._pick_bucket(
               max(num_mel_frames(len(x)) for x in samples)),
           "audio_s": sum(seconds), "wall_s": wall,
           "xRT": sum(seconds) / wall, "tokens": sum(n_gen),
           "tokens_per_s": sum(n_gen) / wall,
           "decode_tokens_per_s": (sum(n_gen) / st["decode_seconds"]
                                   if st["decode_seconds"] else None),
           "prefill_s": st["prefill_seconds"], "decode_steps": steps,
           "replays": st["replays"],
           "decode_ms_per_step": (1e3 * st["decode_seconds"] / steps
                                  if steps else None),
           "decode_gpu_ms_per_step": (
               1e3 * st["decode_gpu_seconds"] / steps if steps else None),
           "n_gen": n_gen,
           "k1_launches": got["decode_layers_fused"],
           "k2_launches": got["decode_attention_dma"],
           "k3_launches": got["flash_attention"],
           "k4_launches": got["quant_matvec_int4"],
           "k5_launches": got["quant_matmul"],
           "lm_head_products": got["lm_head_products"], "card": card}
    emit(row)
    if len(results) != live or not all(isinstance(r.text, str)
                                       for r in results):
        raise AssertionError(f"batch {label}: {len(results)} results")
    if any(n_gen[live:]) or not all(n_gen[:live]):
        raise AssertionError(f"batch {label}: tokens per row {n_gen}")
    want = expected_launches(quantize, env, layers, steps,
                             prefill_flash(engine.config))
    check_launches(f"batch {label}", got, want)
    return got


def batch_parity(torch, engine32, samples, kv_dtype):
    """Phase 6, batched: the kernel path's greedy tokens of a 3-row
    right-aligned batch teacher-force both paths; each step runs the
    kernel path and the plain per-layer path (dense attention) from the
    same slab state, and every row's logits are compared."""
    import numpy as np

    teacher = engine32.generate_batch(samples, [None] * len(samples),
                                      np.ones(len(samples), bool))
    _, cache, kv_start, p = engine32.prefill_batch(samples,
                                                   [None] * len(samples))
    dec = engine32.decoder
    k1 = kernel_wrappers()["decode_layers_fused"]
    k1_before = k1.launches
    n_steps = min(len(t) for t in teacher) - 1
    worst, agree = 0.0, 0
    with torch.inference_mode():
        for i in range(n_steps):
            ids = torch.tensor([t[i] for t in teacher], device=kv_start.device)
            state = type(cache)(*(None if t is None else t.clone() for t in (
                cache.k, cache.v, cache.k_scale, cache.v_scale)))
            os.environ["ASR_DECODE_IMPL"] = "fused"
            lk, _ = dec.decode_step_aligned(engine32.dec_params, ids, p + i,
                                            kv_start, cache)
            os.environ["ASR_DECODE_IMPL"] = "scan"
            os.environ["ASR_DECODE_ATTN"] = "dense"
            lp, _ = dec.decode_step_aligned(engine32.dec_params, ids, p + i,
                                            kv_start, state)
            del os.environ["ASR_DECODE_IMPL"], os.environ["ASR_DECODE_ATTN"]
            worst = max(worst, max_err(torch, lk, lp))
            agree += int((torch.argmax(lk, -1) == torch.argmax(lp, -1)).all())
    k1_launches = k1.launches - k1_before
    emit({"phase": "parity", "dtype": "float32", "batch": len(samples),
          "kv": kv_dtype or "bf16", "kv_start": kv_start.tolist(),
          "steps": n_steps, "k1_launches": k1_launches,
          "max_abs_logit_err": worst, "tol": PARITY_LOGITS_ATOL,
          "greedy_agreement": agree / max(n_steps, 1)})
    if not worst <= PARITY_LOGITS_ATOL:
        raise AssertionError(f"batch parity ({kv_dtype}) logits error {worst}")
    if k1_launches != n_steps:
        raise AssertionError(f"batch parity ({kv_dtype}): the kernel path "
                             f"launched K1 {k1_launches} times")


def parity(torch, engine32, clip, quantize):
    """Phase 6 for one float32 engine: its decode-kernel path's greedy
    tokens teacher-force both paths; per-step logits compared. int4g (its
    int8 lm_head): a third slab copy also runs the folded token step
    (ASR_FOLD_LM=1), whose token must be the plain logits' argmax."""
    import numpy as np

    from qwen3_asr_rs_tpu_torch.runtime.engine import load_audio

    samples = load_audio(clip, 16000)
    teacher = engine32.generate(samples)  # kernel path's greedy tokens
    logits0, cache_k, true_len = engine32.prefill(samples)
    cache_p = type(cache_k)(k=cache_k.k.clone(), v=cache_k.v.clone())
    fold = quantize == "int4g"
    cache_f = type(cache_k)(k=cache_k.k.clone(), v=cache_k.v.clone())
    dec = engine32.decoder
    k1 = kernel_wrappers()["decode_layers_fused"]
    k1_before = k1.launches
    worst, agree, fold_agree = 0.0, 0, 0
    with torch.inference_mode():
        for i, tok in enumerate(teacher[:-1]):
            ids = torch.tensor([tok], device="cuda")
            os.environ["ASR_DECODE_IMPL"] = "fused"
            lk, _ = dec.decode_step(engine32.dec_params, ids, true_len + i,
                                    cache_k)
            os.environ["ASR_DECODE_IMPL"] = "scan"
            os.environ["ASR_DECODE_ATTN"] = "dense"
            lp, _ = dec.decode_step(engine32.dec_params, ids, true_len + i,
                                    cache_p)
            del os.environ["ASR_DECODE_IMPL"], os.environ["ASR_DECODE_ATTN"]
            worst = max(worst, max_err(torch, lk, lp))
            agree += int(torch.argmax(lk) == torch.argmax(lp))
            if fold:
                with Env({"ASR_DECODE_IMPL": "fused", "ASR_FOLD_LM": "1"}):
                    tf, _ = dec.decode_step_token(
                        engine32.dec_params, ids, true_len + i, cache_f)
                fold_agree += int(int(tf[0]) == int(torch.argmax(lp)))
    n_steps = max(len(teacher) - 1, 1)
    k1_launches = k1.launches - k1_before
    emit({"phase": "parity", "dtype": "float32", "quantize": quantize,
          "steps": len(teacher) - 1, "k1_launches": k1_launches,
          "max_abs_logit_err": worst,
          "tol": PARITY_LOGITS_ATOL, "greedy_agreement": agree / n_steps,
          **({"fold_token_agreement": fold_agree / n_steps} if fold else {}),
          "logit_scale": float(np.abs(logits0.cpu().numpy()).max())})
    if not worst <= PARITY_LOGITS_ATOL:
        raise AssertionError(f"parity ({quantize}) logits error {worst}")
    if k1_launches != (2 if fold else 1) * (len(teacher) - 1):
        raise AssertionError(f"parity ({quantize}): the kernel path launched "
                             f"K1 {k1_launches} times")
    if fold and fold_agree != len(teacher) - 1:
        raise AssertionError(f"parity ({quantize}): the folded step's token "
                             f"was the plain argmax at {fold_agree} of "
                             f"{len(teacher) - 1} steps")


# phase 7: (label, quantize, kv_dtype, environment, B); B = 1 and 8 at
# bf16 also run the sampled variant
GRAPH_CASES = (("bf16 B=1", None, None, {}, 1),
               ("bf16 B=8", None, None, {}, 8),
               ("bf16 B=32", None, None, {}, 32),
               ("int8 int8-KV B=8", "int8", "int8", {}, 8),
               ("bf16 fold B=1", None, None, {"ASR_FOLD_LM": "1"}, 1))
SAMPLED = dict(temperature=0.7, top_k=50, top_p=0.9)


def loop_events(torch, run):
    """run() (one decode through the engine) under torch.profiler, device
    activity only (host events cost seconds per run to record and parse):
    (its result, the device events of the decode loop). The loop's
    events start at its first K1 kernel (qk_norm_rope, K1's own; the
    first step's q/k/v GEMVs before it, about 0.03 ms in all, fall
    outside); the prefill runs no K1. Empty if the profile holds none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = run()
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    first = min((e.time_range.start for e in device
                 if "qk_norm_rope" in e.name), default=None)
    if first is None:
        return out, []
    return out, [e for e in device if e.time_range.start >= first]


def decode_run(torch, engine, lm, samples, graphs=True, sampling=None,
               profiled=False):
    """One decode through the engine (``generate`` at B = 1, else
    ``generate_batch`` with every row live), the launch counters (and
    ``lm``, the engine's lm_head_counter) set to 0 just before it and read
    just after. Returns (tokens per row, last_stats, {kernel: launches,
    "lm_head_products": n}); ``profiled``: under torch.profiler, with
    last_stats' "busy_ms_per_step" (the union of the loop's device
    events' intervals per step, busy_us) and "device_events"."""
    import numpy as np

    fns = kernel_wrappers()
    engine.cuda_graphs = graphs
    for fn in list(fns.values()) + [lm]:
        fn.launches = 0

    def run():
        if len(samples) == 1:
            return [engine.generate(samples[0], sampling=sampling)]
        return engine.generate_batch(samples, [None] * len(samples),
                                     np.ones(len(samples), bool),
                                     sampling=sampling)

    if profiled:
        toks, events = loop_events(torch, run)
    else:
        toks = run()
    got = {n: fn.launches for n, fn in fns.items()}
    got["lm_head_products"] = lm.launches
    engine.cuda_graphs = True
    st = dict(engine.last_stats)
    if profiled:
        st["busy_ms_per_step"] = (busy_us(events) / 1e3 / st["decode_steps"]
                                  if events else None)
        st["device_events"] = len(events)
    return toks, st, got


def busy_pair(torch, engine, lm, samples, eager=True):
    """Profiled decode_run stats of the graph loop and (``eager``) of the
    same loop run eagerly. Both run the same kernels, so their device
    events must be equal in number; the profiler loses events (PERF.md),
    so the run with fewer is taken once more. Each keeps its count
    ("device_events"), and the other's ("events_expected"). A profile
    of an eager loop costs seconds at large B: the phase profiles eager
    loops at B = 1 and 8 only."""
    def run(graphs):
        return decode_run(torch, engine, lm, samples, graphs=graphs,
                          profiled=True)[1]

    g = run(True)
    if not eager:
        return g, None
    e = run(False)
    if g["device_events"] < e["device_events"]:
        g = run(True)
    elif e["device_events"] < g["device_events"]:
        e = run(False)
    g["events_expected"] = e["device_events"]
    e["events_expected"] = g["device_events"]
    return g, e


def step_times(st, busy=None) -> dict:
    """Per decode step of one run: wall (host clock, synchronized), GPU
    elapsed (CUDA events around the loop: busy time plus any time the
    host left the card idle) and, from ``busy`` (a profiled run of the
    same loop, decode_run), busy ms (the union of the loop's kernel
    intervals) and the loop's device events."""
    n = st["decode_steps"]
    out = {"steps": n, "wall_ms_per_step": 1e3 * st["decode_seconds"] / n,
           "gpu_ms_per_step": 1e3 * st["decode_gpu_seconds"] / n}
    if busy is not None:
        for k in ("busy_ms_per_step", "device_events", "events_expected"):
            if k in busy:
                out[k] = busy[k]
    return out


def top_k1_ties(torch, engine, samples, greedy, top_k1, temperature):
    """Where the top-k 1 tokens leave the greedy ones, the logits there:
    each row's first differing token is teacher-forced eagerly on the
    greedy prefix (the logits variant, which the sampled step runs).
    JAX's top-k filter keeps every logit tied with the largest, so top-k
    1 may draw another token only at a tie of the logits divided by the
    temperature. Returns ([{row, token, greedy, top_k1, logits, scaled,
    tie}], every divergence at a tie)."""
    rows = {r: next(i for i, (g, t) in enumerate(zip(gr, tr)) if g != t)
            for r, (gr, tr) in enumerate(zip(greedy, top_k1)) if gr != tr}
    if not rows:
        return [], True
    dec, params = engine.decoder, engine.dec_params
    b = len(samples)
    with torch.inference_mode():
        if b == 1:
            logits, cache, base = engine.prefill(samples[0])
        else:
            logits, cache, kv_start, base = engine.prefill_batch(
                samples, [None] * b)
        at = {0: logits}
        for i in range(max(rows.values())):
            ids = torch.tensor([g[i] for g in greedy], device="cuda")
            if b == 1:
                logits, _ = dec.decode_step(params, ids, base + i, cache)
            else:
                logits, _ = dec.decode_step_aligned(params, ids, base + i,
                                                    kv_start, cache)
            at[i + 1] = logits
    out = []
    for r, i in rows.items():
        row = at[i][r].float()
        scaled = row / temperature
        g, t = greedy[r][i], top_k1[r][i]
        top = float(scaled.max())
        out.append({"row": r, "token": i, "greedy": g, "top_k1": t,
                    "logits": [float(row[g]), float(row[t])],
                    "scaled": [float(scaled[g]), float(scaled[t])],
                    "tie": float(scaled[g]) == float(scaled[t]) == top})
    return out, all(x["tie"] for x in out)


def graph_phase(torch, config, enc32, dec32, audio, tmp, card) -> dict:
    """Phase 7 (see the module docstring). Returns {run: {kernel:
    launches}} of the counted graph runs."""
    from qwen3_asr_rs_tpu_torch.runtime.engine import AsrEngine
    from qwen3_asr_rs_tpu_torch.ops import prng
    from qwen3_asr_rs_tpu_torch.ops.kernels.gumbel_argmax import (
        threefry_noise, threefry_noise_plain)
    from qwen3_asr_rs_tpu_torch.runtime.sampling import SamplingParams

    layers = config.text.num_hidden_layers
    launches = {}

    def engine_for(quantize=None, kv=None, max_new=128):
        return AsrEngine(None, dtype=torch.bfloat16, max_new_tokens=max_new,
                         config=config, params=(enc32, dec32),
                         tokenizer=StubTokenizer(), device="cuda",
                         quantize=quantize, kv_dtype=kv)

    def counted(engine, lm, label, quantize, env, samples, sampling=None):
        """A capture run, then the counted run, checked: a one-stage run
        replays the kept graph of the first; a run that leaves the first
        stage freed it, so the next captures every stage's graph (one
        eager step each) and replays it."""
        decode_run(torch, engine, lm, samples, sampling=sampling)
        toks, st, got = decode_run(torch, engine, lm, samples,
                                   sampling=sampling)
        stages = len(st["slab_lens"])
        captures = stages if stages > 1 else 0
        if (st["captures"] != captures or not st["replays"]
                or st["replays"] + captures != st["decode_steps"]):
            raise AssertionError(
                f"graphs {label}: {st['replays']} replays and "
                f"{st['captures']} captures in {st['decode_steps']} steps "
                f"over {len(st['slab_lens'])} stages")
        want = expected_launches(quantize, env, layers, st["decode_steps"],
                                 prefill_flash(config))
        if sampling is not None:  # the logits variant, never the fold;
            # one draw at the prefill and one per step
            want["lm_head_products"] = st["decode_steps"] + 1
            want["gumbel_argmax"] = st["decode_steps"] + 1
        check_launches(f"graphs {label}", got, want)
        launches[f"graphs {label}"] = got
        return toks, st

    for label, quantize, kv, env, b in GRAPH_CASES:
        with Env(env):
            engine = engine_for(quantize, kv)
            samples = [audio[4]] * b
            with lm_head_counter(engine) as lm:
                toks_g, st_g = counted(engine, lm, label, quantize, env,
                                       samples)
                toks_e, st_e, _ = decode_run(torch, engine, lm, samples,
                                             graphs=False)
                busy_g, busy_e = busy_pair(
                    torch, engine, lm, samples,
                    eager=quantize is None and not env and b <= 8)
                row = {"phase": "graphs", "case": label, "B": b,
                       "tokens_equal": toks_g == toks_e,
                       "tokens_per_row": [len(t) for t in toks_g[:2]],
                       "graph": step_times(st_g, busy_g),
                       "eager": step_times(st_e, busy_e),
                       "steps_past_done": st_g["steps_past_done"],
                       "slab_lens": st_g["slab_lens"], "card": card}
                if toks_g != toks_e:
                    emit(row)
                    raise AssertionError(f"graphs {label}: graph tokens "
                                         "differ from the eager step's")
                if quantize is None and kv is None and b in (1, 8) and not env:
                    sp = SamplingParams(seed=0, **SAMPLED)
                    s1, st_s = counted(engine, lm, f"{label} sampled", None,
                                       env, samples, sp)
                    _, busy_s, _ = decode_run(torch, engine, lm, samples,
                                              sampling=sp, profiled=True)
                    s2, _, _ = decode_run(torch, engine, lm, samples,
                                          sampling=sp)
                    s_e, _, _ = decode_run(torch, engine, lm, samples,
                                           graphs=False, sampling=sp)
                    s_o, _, _ = decode_run(torch, engine, lm, samples,
                                           sampling=SamplingParams(
                                               seed=1, **SAMPLED))
                    k1_sp = SamplingParams(temperature=0.7, top_k=1, seed=0)
                    k1, _, _ = decode_run(torch, engine, lm, samples,
                                          sampling=k1_sp)
                    ties, at_ties = top_k1_ties(torch, engine, samples,
                                                toks_g, k1,
                                                k1_sp.temperature)
                    row["sampled"] = {
                        "same_seed_equal": s1 == s2,
                        "graph_equals_eager": s1 == s_e,
                        "other_seed_differs": s1 != s_o,
                        "top_k1_rows_equal_greedy": sum(
                            a == g for a, g in zip(k1, toks_g)),
                        "top_k1_divergences": ties,
                        "graph": step_times(st_s, busy_s)}
                    if not (s1 == s2 == s_e and s1 != s_o and at_ties):
                        emit(row)
                        raise AssertionError(f"graphs {label}: sampling "
                                             f"checks {row['sampled']}")
            emit(row)
            del engine
            torch.cuda.empty_cache()

    # the draw's bits on the card (the kernel) against the CPU's (the
    # plain version), bit for bit, at the engine's keys
    grid = [(seed, step) for seed in (0, 1, 2**33 + 5) for step in (0, 1, 299)]
    v = config.text.vocab_size
    same = all(torch.equal(
        threefry_noise(prng.KeyChain(prng.prng_key(seed, "cuda"), (step,)),
                       (4, v), "bits").cpu(),
        threefry_noise_plain(prng.KeyChain(prng.prng_key(seed), (step,)),
                             (4, v), "bits"))
        for seed, step in grid)
    emit({"phase": "graphs", "case": "draw bits, card vs CPU",
          "grid": len(grid), "rows": 4, "cols": v, "equal": same})
    if not same:
        raise AssertionError("the draw's bits differ between card and CPU")

    # the segmented slab: 300 tokens, default segment -> caps [256, 300];
    # a call that leaves the first stage frees its slab and graphs
    engine = engine_for(max_new=300)
    with lm_head_counter(engine) as lm:
        for b in (1, 8):
            samples = [audio[4]] * b
            toks, st = counted(engine, lm, f"segments B={b}", None, {},
                               samples)
            released = b not in engine._arenas
            allocated = torch.cuda.memory_allocated()
            toks2, _, _ = decode_run(torch, engine, lm, samples)
            retained = torch.cuda.memory_allocated() - allocated
            with Env({"ASR_DECODE_SEGMENT": "512"}):
                one, st1, _ = decode_run(torch, engine, lm, samples)
            row = {"phase": "graphs", "case": f"segments B={b}",
                   "caps": engine._segment_caps(),
                   "slab_lens": st["slab_lens"],
                   "one_segment_slab_lens": st1["slab_lens"],
                   "tokens_equal": toks == one == toks2,
                   "captures": st["captures"],
                   "first_stage_released": released,
                   "bytes_retained_by_a_call": retained,
                   "graph": step_times(st), "card": card}
            emit(row)
            if len(st["slab_lens"]) != 2 or len(st1["slab_lens"]) != 1 or (
                    not row["tokens_equal"] or not released
                    or engine._segment_caps() != [256, 300]):
                raise AssertionError(f"segments B={b}: {row}")
    del engine
    torch.cuda.empty_cache()

    # long form: 400 s -> decode segments at 0 and 358 s in one B = 2 batch
    long_wav = tmp / "clip_400s.wav"
    write_wav(long_wav, 400, 7)
    engine = engine_for(max_new=16)
    batches = []
    orig = engine.transcribe_batch

    def spy(samples_list, languages=None, **kw):
        batches.append(len(samples_list))
        return orig(samples_list, languages, **kw)

    engine.transcribe_batch = spy
    t0 = time.perf_counter()
    r = engine.transcribe(long_wav)
    wall = time.perf_counter() - t0
    segs = r.segments or []
    ends_ok = all(a.end <= b.start for a, b in zip(segs, segs[1:]))
    row = {"phase": "graphs", "case": "long form 400 s", "batches": batches,
           "decode_segments": r.raw_output.count("\n") + 1,
           "segments": [(s.start, s.end, len(s.text)) for s in segs],
           "text_is_concat": "".join(s.text for s in segs) == r.text,
           "ends_non_overlapping": ends_ok, "wall_s": wall, "card": card}
    emit(row)
    if batches != [2] or row["decode_segments"] != 2 or not segs or (
            not ends_ok or not row["text_is_concat"]):
        raise AssertionError(f"long form: {row}")
    del engine
    torch.cuda.empty_cache()
    return launches


# the kernels whose launches per serving decode step the kernels line
# gives, measured in each counted run (K5: per int8 step where the run
# had any)
SERVING_KERNELS = ("decode_attention_dma", "quant_matmul",
                   "decode_layers_fused")
# phase 8: the mixed burst's clips (seconds; 30 s and 120 s prompts are
# chunked, 120 s also encoded in window groups), the sampled request
# submitted mid-flight, the slot-scaling pools, the float32 pool, and the
# float32 auto pool (two requests: every segment int8)
SERVING_BURST = (4, 8, 15, 30, 4, 8, 120)
SERVING_SAMPLED = dict(temperature=0.7, top_p=0.9)
SERVING_SCALING = (16, 32)
SERVING_F32 = (4, 8, 15)
SERVING_F32_AUTO = (4, 15)
# the greedy tokens of a float32 pool and the offline engine may differ
# only where the two best logits lie closer than this (a tie that the
# two paths' summation orders can flip)
SERVING_TIE = 1e-4
# scheduler steps (one segment each) timed, then profiled, in a steady
# window of a pool
SERVING_STEADY_STEPS = 4
SERVING_PROFILE_STEPS = 3


class SegmentClock:
    """The GPU elapsed time of a batcher's decode segments: CUDA events
    recorded around each enqueued segment (no host wait), and the
    precision each segment ran; admissions likewise, per kind."""

    def __init__(self, torch, batcher):
        self.torch, self.b = torch, batcher
        self.segments, self.precisions = [], []
        self.admissions = {}  # kind -> [(event, event)]
        self._wrap("_dispatch_segment", self.segments, self._segment_kind)
        self._wrap("_admit_rows", None,
                   lambda rows: ("monolithic" if len({r[0] for r in rows})
                                 == 1 else f"batched {len(rows)}"))
        for name in ("_start_chunked", "_advance_encode", "_advance_prefill"):
            self._wrap(name, None, lambda *a, _n=name: f"chunked{_n}")

    def _segment_kind(self, *args):
        self.precisions.append(self.b._segment_params()[0])
        return None

    def _wrap(self, name, store, kind):
        orig = getattr(self.b, name)
        torch = self.torch

        def timed(*args, **kw):
            k = kind(*args)
            a = torch.cuda.Event(enable_timing=True)
            a.record()
            out = orig(*args, **kw)
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            (store if store is not None
             else self.admissions.setdefault(k, [])).append((a, e))
            return out

        setattr(self.b, name, timed)

    def reset(self):
        self.segments.clear()
        self.precisions.clear()
        self.admissions.clear()

    def report(self) -> dict:
        self.torch.cuda.synchronize()
        steps = self.b.segment_steps * len(self.segments)
        gpu = sum(a.elapsed_time(e) for a, e in self.segments)
        return {"segments": len(self.segments),
                "gpu_ms_per_step": gpu / steps if steps else None,
                "admission_gpu_ms": {
                    k: statistics.mean(a.elapsed_time(e) for a, e in v)
                    for k, v in sorted(self.admissions.items())},
                "admission_calls": {k: len(v) for k, v in
                                    sorted(self.admissions.items())}}


def serving_burst(torch, batcher, clock, reqs, mid=None, after_steps=2):
    """Submit ``reqs`` at once (and ``mid`` after ``after_steps``
    scheduler steps), drive the batcher until all finish, with the launch
    counters set to 0 just before and read just after. Returns (wall s,
    {kernel: launches}, requests)."""
    fns = kernel_wrappers()
    torch.cuda.synchronize()
    for fn in fns.values():
        fn.launches = 0
    clock.reset()
    for k in batcher.stats:
        batcher.stats[k] = 0
    t0 = time.perf_counter()
    for r in reqs:
        batcher.submit(r)
    allr = list(reqs)
    n = 0
    while not all(r.event.is_set() for r in allr):
        batcher.step(block_timeout=0.001)
        n += 1
        if mid is not None and n == after_steps:
            batcher.submit(mid)
            allr.append(mid)
        if n > 20000:
            raise AssertionError("serving: the batcher did not converge")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for r in allr:
        if r.error is not None:
            raise AssertionError(f"serving: a request failed: {r.error!r}")
    return wall, {k: fn.launches for k, fn in kernel_wrappers().items()}, allr


def serving_steady(torch, batcher, clock, clips, sampling=None) -> dict:
    """A pool's decode step with every slot decoding and nothing to
    admit: a burst of ``clips`` admitted, two segments enqueued, then
    SERVING_STEADY_STEPS scheduler steps timed (wall on the host clock:
    each step waits for the previous segment; GPU elapsed from the
    clock's events), then, with nothing in flight, SERVING_PROFILE_STEPS
    more under torch.profiler (device activity only), which give GPU
    elapsed and busy over the same segments: the clock's events around
    the segments enqueued in the window, and the union of the window's
    device intervals (every one from those segments), each per decode
    step (busy counts its steps by K2's kernels, 28 per step, since the
    profiler may lose events); the rest driven to the end."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from qwen3_asr_rs_tpu_torch.runtime.serving import Request

    reqs = [Request(c, **(sampling or {})) for c in clips]
    for r in reqs:
        batcher.submit(r)
    batcher.step(block_timeout=0.001)
    batcher.step(block_timeout=0.001)
    clock.reset()
    t0 = time.perf_counter()
    for _ in range(SERVING_STEADY_STEPS):
        batcher.step(block_timeout=0.001)
    wall = time.perf_counter() - t0
    gpu = clock.report()["gpu_ms_per_step"]
    torch.cuda.synchronize()
    clock.reset()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(SERVING_PROFILE_STEPS):
            batcher.step(block_timeout=0.001)
        torch.cuda.synchronize()
    window = clock.report()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    while not all(r.event.is_set() for r in reqs):
        batcher.step(block_timeout=0.001)
    steps = sum("attn_kernel" in e.name for e in events) / L
    busy = busy_us(events) / 1e3 / steps if steps else None
    gpu_w = window["gpu_ms_per_step"]
    return {"wall_ms_per_step": 1e3 * wall / (SERVING_STEADY_STEPS
                                              * batcher.segment_steps),
            "gpu_ms_per_step": gpu,
            "profiled_gpu_ms_per_step": gpu_w, "busy_ms_per_step": busy,
            "busy_share": busy / gpu_w if busy else None,
            "profiled_steps": steps,
            "profiled_segment_steps": window["segments"]
            * batcher.segment_steps,
            "device_events": len(events)}


def serving_admission(torch, batcher, samples) -> dict:
    """One monolithic admission of ``samples`` into slot 0 of an idle
    pool, repeated: host wall (synchronized, the median of 3), and in a
    profiled one its device kernels and busy ms; the slot is freed after
    each."""
    from qwen3_asr_rs_tpu_torch.runtime.serving import Request

    req = Request(samples)
    prep = batcher._prepare(req)

    def admit():
        batcher._admit_rows([(0, req, prep)])
        batcher.slots[0].request = None
        batcher._set_slot_state(0, 0, 0, True)

    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        admit()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    events, _ = device_events(torch, admit, 1)
    return {"host_wall_ms": statistics.median(walls),
            "device_kernels": len(events),
            "busy_ms": busy_us(events) / 1e3}


def served_tokens(r) -> list:
    """A served request's token ids (StubTokenizer's text)."""
    return [int(t) for t in r.result.raw_output.split()]


def serving_gap(torch, engine, samples, want, got, params=None) -> dict:
    """Where a float32 pool's tokens ``got`` first leave the offline
    engine's ``want``: both paths teacher-forced on the offline prefix
    from one prefill (the engine's), decoding over ``params`` (default
    the engine's; the offline step with a shared position, the serving
    step with a per-row one), the top-2 logits of each there and the
    largest gap between the two tokens' logits."""
    from qwen3_asr_rs_tpu_torch.models.text_decoder import KVCache

    dec = engine.decoder
    params = engine.dec_params if params is None else params
    t = next(i for i, (a, b) in enumerate(zip(want, got)) if a != b)
    logits, cache_o, base = engine.prefill(samples)
    cache_s = KVCache(k=cache_o.k.clone(), v=cache_o.v.clone())
    lo = ls = logits
    for i in range(t):
        ids = torch.tensor([want[i]], device="cuda")
        lo, _ = dec.decode_step(params, ids, base + i, cache_o)
        ls, _ = dec.decode_step(params, ids,
                                torch.tensor([base + i], device="cuda"),
                                cache_s)
    pair = [want[t], got[t]]
    out = {"step": t, "tokens": pair}
    gap = 0.0
    for name, lg in (("offline", lo), ("serving", ls)):
        top = torch.topk(lg[0].float(), 2)
        out[name] = {"top2_ids": top.indices.tolist(),
                     "top2_logits": top.values.tolist()}
        gap = max(gap, abs(float(lg[0, pair[0]] - lg[0, pair[1]])))
    out["gap"] = gap
    return out


def offline_tokens(torch, engine, params, samples) -> list:
    """Greedy token ids (EOS excluded) of one utterance as a pool decodes
    it over ``params``: the engine's prefill and first token (admission
    runs the engine's own weights), then offline decode steps at a shared
    position over ``params``, to an EOS or the engine's
    max_new_tokens."""
    from qwen3_asr_rs_tpu_torch.runtime.engine import EOS_TOKEN_IDS

    logits, cache, base = engine.prefill(samples)
    toks = []
    tok = int(logits[0].argmax())
    while tok not in EOS_TOKEN_IDS:
        toks.append(tok)
        if len(toks) == engine.max_new_tokens:
            break
        logits, _ = engine.decoder.decode_step(
            params, torch.tensor([tok], device="cuda"),
            base + len(toks) - 1, cache)
        tok = int(logits[0].argmax())
    return toks


def pool_memory(torch, batcher, base: int, peak: int) -> dict:
    """A pool's slab GiB, and the device memory it keeps and peaked at
    above ``base`` (allocated before it was built)."""
    c = batcher.cache
    slab = nbytes(c.k, c.v, c.k_scale, c.v_scale)
    return {"slab_gib": slab / 2**30,
            "kept_gib": (torch.cuda.memory_allocated() - base) / 2**30,
            "peak_gib": (peak - base) / 2**30}


def serving_phase(torch, config, enc32, dec32, audio, tmp, card) -> dict:
    """Phase 8 (see the module docstring). Returns ({run: {kernel:
    launches}} of the counted serving runs, {kernel: {run: launches per
    decode step}}, K5's per int8 step where the run had any)."""
    from qwen3_asr_rs_tpu_torch.runtime.engine import AsrEngine, load_audio
    from qwen3_asr_rs_tpu_torch.runtime.serving import (
        ContinuousBatcher, Request)

    launches = {}
    per_step = {k: {} for k in SERVING_KERNELS}
    clips = dict(audio)
    write_wav(tmp / "clip_120s.wav", 120, 8)
    clips[120] = load_audio(tmp / "clip_120s.wav", 16000)

    def check(label, got, steps, stats, k5_steps=0, draws=0, f32=False):
        """``stats``: the pool's over the same window, whose admission
        work gives K3's launches in a bf16 pool (``admission_flash``);
        ``f32``: a float32 pool, whose prompts stay dense (none)."""
        flash = 0 if f32 else admission_flash(config, stats)
        want = {"decode_layers_fused": 0, "decode_attention_dma": L * steps,
                "flash_attention": flash, "quant_matvec_int4": 0,
                "quant_matmul": (4 * L + 1) * k5_steps,
                "decode_attention_slab": 0, "decode_attention": 0,
                "gumbel_argmax": draws, "threefry_noise": 0}
        check_launches(f"serving {label}", got, want)
        launches[f"serving {label}"] = got
        for k in SERVING_KERNELS:
            n = k5_steps if k == "quant_matmul" and k5_steps else steps
            per_step[k][label] = got[k] / n

    def pool(engine, **kw):
        gc.collect()  # a pool's wrapped methods form a cycle
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        b = ContinuousBatcher(engine, **kw)
        return b, SegmentClock(torch, b), base

    def row_of(label, b, clock, wall, got, reqs, base, extra=None):
        audio_s = sum(len(r.samples) / 16000 for r in reqs)
        toks = sum(len(r.result.raw_output.split()) for r in reqs)
        lat = sorted(r.finish_time - r.submit_time for r in reqs)
        steps = b.stats["steps"]
        row = {"phase": "serving", "case": label, "slots": b.n_slots,
               "requests": len(reqs), "audio_s": audio_s, "tokens": toks,
               "wall_s": wall, "xRT": audio_s / wall,
               "tokens_per_s": toks / wall,
               "latency_s": {"p50": lat[len(lat) // 2],
                             "p95": lat[min(len(lat) - 1,
                                            int(0.95 * len(lat)))],
                             "all": lat},
               "decode_steps": steps, "replays": b.stats["replays"],
               "captures": b.stats["captures"],
               "k1_launches": got["decode_layers_fused"],
               "k2_launches": got["decode_attention_dma"],
               "k5_launches": got["quant_matmul"],
               "k2_per_step": got["decode_attention_dma"] / steps
               if steps else None,
               **clock.report(),
               **pool_memory(torch, b, base,
                             torch.cuda.max_memory_allocated()),
               "card": card}
        row.update(extra or {})
        emit(row)
        return row

    # 1. float32, 4 slots: tokens equal to the offline float32 engine's
    engine32 = AsrEngine(None, dtype=torch.float32, max_new_tokens=128,
                         config=config, params=(enc32, dec32),
                         tokenizer=StubTokenizer(), device="cuda")
    f32 = [clips[c] for c in SERVING_F32]
    want = [engine32.generate(c) for c in f32]
    b, clock, base = pool(engine32, n_slots=4)
    wall, got, reqs = serving_burst(torch, b, clock,
                                    [Request(c) for c in f32])
    check("f32 4 slots", got, b.stats["steps"], b.stats, f32=True)
    gaps = [serving_gap(torch, engine32, c, w, served_tokens(r))
            for c, w, r in zip(f32, want, reqs) if served_tokens(r) != w]
    row_of("f32 4 slots", b, clock, wall, got, reqs, base,
           {"tokens_equal": [served_tokens(r) == w
                             for r, w in zip(reqs, want)],
            "divergences": gaps})
    if any(g["gap"] >= SERVING_TIE for g in gaps):
        raise AssertionError(f"serving f32: tokens differ from the offline "
                             f"engine's without a tie: {gaps}")
    del b, clock, reqs
    torch.cuda.empty_cache()

    # 1b. float32, serving_precision="auto" with two requests (at most
    # ASR_SERVING_INT8_MAX_OCC live slots: every segment int8, K5 on the
    # four linears at the live rows and the lm_head), tokens equal to the
    # offline steps over the pool's own int8 tree (offline_tokens), with
    # the same tie rule
    b, clock, base = pool(engine32, n_slots=4, serving_precision="auto")
    params8 = b._params_by_precision["int8"]
    f32_auto = [clips[c] for c in SERVING_F32_AUTO]
    want = [offline_tokens(torch, engine32, params8, c) for c in f32_auto]
    wall, got, reqs = serving_burst(torch, b, clock,
                                    [Request(c) for c in f32_auto])
    precisions = list(clock.precisions)
    check("f32 auto precision", got, b.stats["steps"], b.stats,
          b.segment_steps * precisions.count("int8"), f32=True)
    gaps = [serving_gap(torch, engine32, c, w, served_tokens(r), params8)
            for c, w, r in zip(f32_auto, want, reqs)
            if served_tokens(r) != w]
    row_of("f32 auto precision", b, clock, wall, got, reqs, base,
           {"precisions": precisions,
            "tokens_equal": [served_tokens(r) == w
                             for r, w in zip(reqs, want)],
            "divergences": gaps})
    if set(precisions) != {"int8"}:
        raise AssertionError(f"serving f32 auto: segment precisions "
                             f"{precisions}")
    if any(g["gap"] >= SERVING_TIE for g in gaps):
        raise AssertionError(f"serving f32 auto: int8 tokens differ from "
                             f"the offline int8 steps' without a tie: "
                             f"{gaps}")
    del b, clock, engine32, params8, reqs
    torch.cuda.empty_cache()

    # 2. bf16, 8 slots: warmup, then the mixed burst with a sampled
    # request mid-flight
    engine = AsrEngine(None, dtype=torch.bfloat16, max_new_tokens=128,
                       config=config, params=(enc32, dec32),
                       tokenizer=StubTokenizer(), device="cuda")
    b, clock, base = pool(engine, n_slots=8)
    t0 = time.perf_counter()
    b.warmup(buckets=sorted({engine._pick_bucket(-(-len(clips[c]) // 160))
                             for c in SERVING_BURST}))
    warm = {"warmup_s": time.perf_counter() - t0,
            "graphs": sorted(map(list, b._graphs))}
    burst = [Request(clips[c]) for c in SERVING_BURST]
    sampled = Request(clips[4], **SERVING_SAMPLED)
    wall, got, reqs = serving_burst(torch, b, clock, burst, mid=sampled)
    # a draw per step of the sampled segments, and the sampled request's
    # admission draw
    check("bf16 8 slots burst", got, b.stats["steps"], b.stats,
          draws=b.stats["sampled_steps"] + 1)
    row = row_of("bf16 8 slots burst", b, clock, wall, got, reqs, base,
                 {**warm, "clip_seconds": list(SERVING_BURST) + [4],
                  "sampled": SERVING_SAMPLED,
                  "latency_by_clip_s": [r.finish_time - r.submit_time
                                        for r in reqs]})
    if row["captures"]:
        raise AssertionError("serving: a live burst captured a graph that "
                             "warmup left out")
    # the greedy requests' tokens beside the offline engine's: reported,
    # not gated (in bf16, cuBLAS picks other kernels for other row counts,
    # so the two paths round differently)
    offline = [engine.generate(r.samples) for r in reqs[:-1]]
    emit({"phase": "serving", "case": "bf16 8 slots burst against offline",
          "tokens_equal": [served_tokens(r) == o
                           for r, o in zip(reqs, offline)],
          "first_difference": [
              next((i for i, (x, y) in enumerate(zip(served_tokens(r), o))
                    if x != y), None) for r, o in zip(reqs, offline)],
          "card": card})
    emit({"phase": "serving", "case": "bf16 8 slots steady",
          **serving_steady(torch, b, clock, [clips[4]] * 8),
          "admission_4s": serving_admission(torch, b, clips[4]),
          "card": card})
    emit({"phase": "serving", "case": "bf16 8 slots sampled steady",
          "sampled": SERVING_SAMPLED,
          **serving_steady(torch, b, clock, [clips[4]] * 8,
                           SERVING_SAMPLED),
          "card": card})

    # 3. the HTTP server on this pool's engine: healthz, /transcribe and
    # the OpenAI route against the same request submitted directly
    serving_http(torch, engine, tmp, clips, card)
    del b, clock
    torch.cuda.empty_cache()

    # 4. slot scaling: 16 and 32 slots of 4 s requests
    for n in SERVING_SCALING:
        b, clock, base = pool(engine, n_slots=n)
        b.warmup(buckets=[engine._pick_bucket(-(-len(clips[4]) // 160))])
        wall, got, reqs = serving_burst(
            torch, b, clock, [Request(clips[4]) for _ in range(n)])
        check(f"bf16 {n} slots", got, b.stats["steps"], b.stats)
        row_of(f"bf16 {n} slots", b, clock, wall, got, reqs, base)
        emit({"phase": "serving", "case": f"bf16 {n} slots steady",
              **serving_steady(torch, b, clock, [clips[4]] * n),
              "card": card})
        del b, clock
        torch.cuda.empty_cache()

    # 5. the int8 KV pool, and serving_precision="auto" (int8 segments at
    # low occupancy: K5 for the four int8 linears and the lm_head)
    b, clock, base = pool(engine, n_slots=8, kv_dtype="int8")
    b.warmup(buckets=[engine._pick_bucket(-(-len(clips[4]) // 160))])
    wall, got, reqs = serving_burst(torch, b, clock,
                                    [Request(clips[4]) for _ in range(8)])
    check("bf16 weights int8 KV 8 slots", got, b.stats["steps"], b.stats)
    row_of("bf16 weights int8 KV 8 slots", b, clock, wall, got, reqs, base)
    emit({"phase": "serving", "case": "bf16 weights int8 KV 8 slots steady",
          **serving_steady(torch, b, clock, [clips[4]] * 8), "card": card})
    del b, clock
    torch.cuda.empty_cache()
    b, clock, base = pool(engine, n_slots=8, serving_precision="auto")
    b.warmup(buckets=[engine._pick_bucket(-(-len(clips[4]) // 160))])
    # one request: int8 segments; eight, six of them capped at 16 tokens:
    # bf16 segments, then int8 ones once two slots are left
    for n in (1, 8):
        wall, got, reqs = serving_burst(
            torch, b, clock, [Request(clips[4], max_new_tokens=(
                16 if i >= 2 else None)) for i in range(n)])
        precisions = list(clock.precisions)
        k5_steps = b.segment_steps * precisions.count("int8")
        check(f"auto precision {n}", got, b.stats["steps"], b.stats,
              k5_steps)
        row_of(f"auto precision {n}", b, clock, wall, got, reqs, base,
               {"precisions": precisions})
        if set(precisions) != ({"int8"} if n == 1 else {"int8", "bf16"}):
            raise AssertionError(f"serving auto, {n} requests: segment "
                                 f"precisions {precisions}")
    del b, clock, engine
    torch.cuda.empty_cache()
    return launches, per_step


def serving_http(torch, engine, tmp, clips, card) -> None:
    """An in-process server on 127.0.0.1 over a 4-slot worker on
    ``engine``: /healthz, then the 4 s WAV through /transcribe and
    /v1/audio/transcriptions, each text equal to the same Request
    submitted to the worker directly."""
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer

    from qwen3_asr_rs_tpu_torch.runtime.server import (
        BatchingWorker, make_handler)
    from qwen3_asr_rs_tpu_torch.runtime.serving import Request

    worker = BatchingWorker(engine, max_batch=4)
    worker.batcher.warmup(buckets=[engine._pick_bucket(
        -(-len(clips[4]) // 160))])
    worker.start()
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(worker))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        with urllib.request.urlopen(f"{url}/healthz", timeout=60) as r:
            health = json.loads(r.read())
        body = (tmp / "clip_4s.wav").read_bytes()
        t0 = time.perf_counter()
        with urllib.request.urlopen(urllib.request.Request(
                f"{url}/transcribe", data=body, method="POST"),
                timeout=300) as r:
            plain = json.loads(r.read())
        plain_s = time.perf_counter() - t0
        boundary = "smokeboundary"
        form = (f"--{boundary}\r\nContent-Disposition: form-data; "
                f'name="file"; filename="a.wav"\r\n'
                f"Content-Type: audio/wav\r\n\r\n").encode() + body + (
                    f"\r\n--{boundary}--\r\n").encode()
        with urllib.request.urlopen(urllib.request.Request(
                f"{url}/v1/audio/transcriptions", data=form, method="POST",
                headers={"Content-Type":
                         f"multipart/form-data; boundary={boundary}"}),
                timeout=300) as r:
            oai = json.loads(r.read())
        direct = Request(clips[4])
        worker.submit(direct)
        want = direct.wait(timeout=300)
    finally:
        httpd.shutdown()
        worker.stop()
        worker.join(timeout=60)
    row = {"phase": "serving", "case": "http", "healthz": health,
           "transcribe_text_equal": plain["text"] == want.text,
           "openai_text_equal": oai["text"] == want.text,
           "transcribe_s": plain_s, "text_chars": len(want.text),
           "worker_stopped": not worker.is_alive(), "card": card}
    emit(row)
    if health != {"status": "ok"} or not (
            row["transcribe_text_equal"] and row["openai_text_equal"]
            and row["worker_stopped"]):
        raise AssertionError(f"serving http: {row}")


# ---- phase 9: streaming ---------------------------------------------------

# the 30 s clip fed in 1 s updates; a 40 s feed (the 300 s clip's first 40
# s) in 1 s updates through sessions of STREAM_ROLL_SESSION seconds (at
# least one rollover); a float32 session over 11 s of the 15 s clip in 2 s
# increments against the float32 offline engine (JAX's
# test_streaming_session_matches_offline_engine at full width)
STREAM_FEED_S = 30
STREAM_ROLL_S = 40
STREAM_ROLL_SESSION = 16.0
STREAM_F32 = (11, 2)


def pct(values, q: float) -> float:
    """The q-quantile of ``values`` (linear interpolation)."""
    import numpy as np

    return float(np.percentile(np.asarray(values, float), q))


def stream_feed(torch, engine, samples, seconds: int, **kw):
    """``seconds`` of ``samples`` fed in 1 s chunks through a
    StreamingTranscriber(**kw) (an update per chunk). Returns (the
    transcriber, a row per update: wall seconds (synchronized), whether it
    rolled over, the committed text, the update's committed delta, the
    rolled text (the stitched final hypotheses of the finished sessions),
    the session's update stats, and the decode graphs' captures and
    replays after it)."""
    from qwen3_asr_rs_tpu_torch.runtime.streaming import StreamingTranscriber

    stream = StreamingTranscriber(engine, update_interval_s=1.0, **kw)
    rows = []
    for s in range(seconds):
        session = stream.session
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        up = stream.feed(samples[s * 16000:(s + 1) * 16000])
        torch.cuda.synchronize()
        g = stream.session.graphs
        rows.append({"wall_s": time.perf_counter() - t0,
                     "rolled": stream.session is not session,
                     "updated": up is not None,
                     "committed": stream.committed_text,
                     "delta": up.committed if up is not None else "",
                     "rolled_text": stream._rolled,
                     **stream.session.last_update_stats,
                     "captures": g.captures, "replays": g.replays})
    return stream, rows


def commit_invariant(rows) -> dict:
    """JAX's commit rule along stream_feed's rows: each update's delta is
    the committed text past the old committed length (empty where it did
    not grow); between rollovers the committed text changes only to a
    longer agreed prefix; at a rollover it is the stitched final
    hypothesis. Where the new text extends the old, the deltas add up;
    the updates that rewrote it (the old text not a prefix of the new)
    are counted, at rollovers and between them."""
    deltas, grows, at_roll = True, True, True
    rewrote = {"at_rollovers": 0, "between_rollovers": 0}
    prev = ""
    for r in rows:
        now = r["committed"]
        deltas &= r["delta"] == (now[len(prev):] if len(now) > len(prev)
                                 else "")
        if r["rolled"]:
            at_roll &= now == r["rolled_text"]
        else:
            grows &= now == prev or len(now) > len(prev)
        if not now.startswith(prev):
            rewrote["at_rollovers" if r["rolled"]
                    else "between_rollovers"] += 1
        prev = now
    return {"deltas_as_jax_forms_them": deltas,
            "commits_longer_prefixes_between_rollovers": grows,
            "rollovers_commit_final_hypothesis": at_roll,
            "updates_rewriting_committed": rewrote}


def update_summary(rows) -> dict:
    walls = [1e3 * r["wall_s"] for r in rows]
    return {"updates": len(rows), "wall_ms_p50": pct(walls, 50),
            "wall_ms_p95": pct(walls, 95), "wall_ms_max": max(walls),
            "first_update_ms": walls[0],
            "decoded_tokens_mean": statistics.mean(
                r["decoded_tokens"] for r in rows),
            "windows_encoded": [r["windows_encoded"] for r in rows],
            "chunk_positions_max": max(r["chunk_positions"] for r in rows)}


def teacher_forced(torch, dec, params, cache, feed, pos0: int):
    """Logits after feeding the tokens ``feed`` at positions pos0, pos0 +
    1, ... through decode steps over ``cache`` (the last step's)."""
    logits = None
    for i, tok in enumerate(feed):
        logits, _ = dec.decode_step(params, torch.tensor([tok],
                                                         device="cuda"),
                                    pos0 + i, cache)
    return logits


def tie_gap(torch, paths, want, got, tol: float = SERVING_TIE) -> dict:
    """Where ``got`` first leaves ``want``: each path's top-2 logits there
    and the largest gap between the two tokens' logits over the paths
    (``paths``: {name: function of the step t -> that path's logits (1,
    V) for token t, teacher-forced on want[:t]}); a tie where the gap is
    at most ``tol``."""
    t = next(i for i, (a, b) in enumerate(zip(want, got)) if a != b)
    pair = [want[t], got[t]]
    out = {"step": t, "tokens": pair}
    gap = 0.0
    with torch.inference_mode():
        for name, fn in paths.items():
            lg = fn(t)[0].float()
            top = torch.topk(lg, 2)
            out[name] = {"top2_ids": top.indices.tolist(),
                         "top2_logits": top.values.tolist()}
            gap = max(gap, abs(float(lg[pair[0]] - lg[pair[1]])))
    out["gap"] = gap
    out["tol"] = tol
    out["tie"] = gap <= tol
    return out


def stream_gap(torch, engine, session, samples, want, got) -> dict:
    """tie_gap of a session's final hypothesis against the offline
    engine's: the offline path is the engine's prefill and decode steps;
    the session's, its own slab after the update (the prompt's K/V at
    [0, base)) with the prompt's last token fed again at base - 1."""
    from qwen3_asr_rs_tpu_torch.runtime.prompt import build_prompt

    last = build_prompt(0, None, engine.tokenizer)[-1]
    slab = session._slab
    base = int(slab.state.base)

    def offline(t):
        logits, cache, b = engine.prefill(samples)
        return logits if t == 0 else teacher_forced(
            torch, engine.decoder, engine.dec_params, cache, want[:t], b)

    def streamed(t):
        return teacher_forced(torch, session.graphs.decoder,
                              engine.dec_params, slab.cache,
                              [last] + want[:t], base - 1)

    return tie_gap(torch, {"offline": offline, "session": streamed}, want,
                   got)


def stream_breakdown(torch, engine, session, feed, card) -> None:
    """Where a stream update's time goes, after the 30 s feed: one window
    encode and one 128-position prefill-only chunk (eager, as an update
    runs them) and one replay of the lease's decode step, each the median
    of 10 CUDA-event timings on the session's own slab (its contents no
    longer matter; the decode state is reset first, so that the replays
    stay inside the token buffer); the re-decode is the replay times the
    decoded tokens less one, the rest what the update's p50 wall leaves
    (``feed``: the feed's row)."""
    import numpy as np

    from qwen3_asr_rs_tpu_torch.runtime.sampling import SamplingParams

    g = session.graphs
    st = session._slab.state
    st.start(np.ones(1, bool), int(st.base), SamplingParams())
    wave, n_frames = session._cached_wave(0, len(session.buffer))
    src = torch.zeros((2 * session.window_tokens,
                       engine.config.audio.output_dim), dtype=engine.dtype,
                      device="cuda")
    ids = torch.zeros(128, dtype=torch.long, device="cuda")
    chunk = g.chunk_step(False, 128)
    with torch.inference_mode():
        encode = cuda_ms(torch, lambda: g.window_encode(wave, n_frames,
                                                        session.session_max))
        prefill = cuda_ms(torch, lambda: chunk(session._slab, src, ids, 0, 0,
                                               128, session.kv_len))
        step = cuda_ms(torch, session._slab.graph.replay)
    redecode = step * (feed["decoded_tokens_mean"] - 1)
    windows = statistics.mean(feed["windows_encoded"])
    emit({"phase": "streaming", "case": "update breakdown",
          "window_encode_ms": encode, "windows_per_update": windows,
          "chunk_128_ms": prefill, "decode_step_ms": step,
          "redecode_ms": redecode,
          "update_wall_ms_p50": feed["wall_ms_p50"],
          "rest_ms": feed["wall_ms_p50"] - redecode - prefill
          - windows * encode, "card": card})


def streaming_phase(torch, config, enc32, dec32, audio, card) -> dict:
    """Phase 9 (see the module docstring). Returns ({run: {kernel:
    launches}}, {kernel: {run: launches per stream update}})."""
    from qwen3_asr_rs_tpu_torch.runtime.engine import AsrEngine
    from qwen3_asr_rs_tpu_torch.runtime.streaming import StreamingSession

    fns = kernel_wrappers()
    layers = config.text.num_hidden_layers
    engine = AsrEngine(None, dtype=torch.bfloat16, max_new_tokens=128,
                       config=config, params=(enc32, dec32),
                       tokenizer=StubTokenizer(), device="cuda")
    engine.transcribe_samples(audio[4])  # warm-up: context, cuBLAS
    for fn in fns.values():
        fn.launches = 0
    stream, rows = stream_feed(torch, engine, audio[30], STREAM_FEED_S)
    got = {n: fn.launches for n, fn in fns.items()}
    g = stream.session.graphs
    final = stream.finalize()
    offline = engine.transcribe_samples(stream.session.buffer)
    steps = g.replays + g.captures  # each capture ran one eager step
    want = {n: 0 for n in fns}
    # the audio tower's attention of each window encode takes K3
    want.update(decode_layers_fused=steps, decode_attention_dma=layers * steps,
                gemv_wgmma=4 * layers * steps,
                flash_attention=config.audio.encoder_layers * sum(
                    r["windows_encoded"] for r in rows))
    row = {"phase": "streaming", "case": f"{STREAM_FEED_S} s in 1 s updates",
           **update_summary(rows),
           "windows_after_first_max": max(r["windows_encoded"]
                                          for r in rows[1:]),
           "finalize_equals_offline": final.raw_output == offline.raw_output,
           "captures": g.captures,
           "captures_after_first_update": rows[0]["captures"],
           "replays": g.replays, "leases": g.leases,
           "launches": got, "card": card}
    emit(row)
    check_launches("streaming 30 s", got, want)
    if (row["windows_after_first_max"] > 2
            or not row["finalize_equals_offline"]
            or g.captures != rows[0]["captures"] or g.captures != 1):
        raise AssertionError(f"streaming 30 s: {row}")
    launches = {f"stream {STREAM_FEED_S} s": got}
    per_update = {n: {f"stream {STREAM_FEED_S} s": got[n] / len(rows)}
                  for n in fns}
    stream_breakdown(torch, engine, stream.session, row, card)
    stream.session.close()

    # a rollover: sessions of STREAM_ROLL_SESSION s over a 40 s feed
    for fn in fns.values():
        fn.launches = 0
    stream, rows = stream_feed(torch, engine, audio[300], STREAM_ROLL_S,
                               max_stream_seconds=STREAM_ROLL_SESSION)
    got = {n: fn.launches for n, fn in fns.items()}
    g = stream.session.graphs
    rolled = [i for i, r in enumerate(rows) if r["rolled"]]
    row = {"phase": "streaming",
           "case": f"{STREAM_ROLL_S} s, {STREAM_ROLL_SESSION:g} s sessions",
           **update_summary(rows), "rollover_updates": rolled,
           "rollover_update_ms": [1e3 * rows[i]["wall_s"] for i in rolled],
           **commit_invariant(rows),
           "committed_chars": len(stream.committed_text),
           "captures": g.captures, "leases": g.leases, "replays": g.replays,
           "launches": got, "card": card}
    emit(row)
    if (not rolled or not row["deltas_as_jax_forms_them"]
            or not row["commits_longer_prefixes_between_rollovers"]
            or not row["rollovers_commit_final_hypothesis"]
            or g.captures != 1 or g.leases != 1):
        raise AssertionError(f"streaming rollover: {row}")
    launches[f"stream {STREAM_ROLL_S} s rollover"] = got
    for n in fns:
        per_update[n][f"stream {STREAM_ROLL_S} s rollover"] = (
            got[n] / len(rows))
    stream.session.close()
    del engine, stream
    torch.cuda.empty_cache()

    # float32: the session's final hypothesis against the offline engine's
    engine32 = AsrEngine(None, dtype=torch.float32, max_new_tokens=128,
                         config=config, params=(enc32, dec32),
                         tokenizer=StubTokenizer(), device="cuda")
    seconds, inc = STREAM_F32
    samples = audio[15][:seconds * 16000]
    session = StreamingSession(engine32, max_new_tokens=128)
    walls = []
    for end in range(inc * 16000, len(samples) + inc * 16000, inc * 16000):
        session.buffer = samples[:end]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = session.update()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    offline = engine32.transcribe_samples(samples)
    want = [int(t) for t in offline.raw_output.split()]
    got_toks = [int(t) for t in result.raw_output.split()]
    row = {"phase": "streaming", "case": "float32 session vs offline",
           "seconds": seconds, "increment_s": inc, "update_ms": walls,
           "tokens": len(got_toks), "tokens_equal": got_toks == want,
           "card": card}
    if got_toks != want:
        row["divergence"] = stream_gap(torch, engine32, session, samples,
                                       want, got_toks)
    emit(row)
    if got_toks != want and not row["divergence"]["tie"]:
        raise AssertionError(f"streaming float32: {row}")
    session.close()
    del engine32, session
    torch.cuda.empty_cache()
    return launches, per_update


# ---- phase 10: speculative decoding -----------------------------------------

SPEC_K = 4
SPEC_DRAFTS = ("bf16", "int8", "int4", "int4g")
# A speculative run's tokens equal the plain loop's, or every token is
# held against the plain K1 step teacher-forced on that run's tokens: it
# must be the step's argmax, or lie within a tie of it (spec_agreement).
# float32: SERVING_TIE. bf16: the verify's plain ops and K1 round at other
# places, so their logits for one token differ; SPEC_BF16_SPREAD bounds
# that difference (|verify - K1| at the step's two best tokens and the
# emitted one, at every position of the plain tokens of each target and
# clip, and of every run that leaves them: checked, and its distribution
# shown), and a flip between two tokens is a tie within twice the bound.
# Each bound is the power of two above the largest difference measured on
# an H100 at that target width (hidden size) over every position of phase
# 10's bf16 runs (PERF.md §6): 0.6B 0.0254, 1.7B 0.0717.
SPEC_BF16_SPREAD = {1024: 2 ** -5, 2048: 2 ** -3}
SPEC_CLIPS = (4, 30)
SPEC_SAMPLED = dict(temperature=0.7, top_p=0.9)
# the float32 self-draft's token cap: a multiple of k + 1, so that a
# stream whose every draft is accepted ends on an iteration's boundary
SPEC_F32_MAX_NEW = 25 * (SPEC_K + 1)


def spec_flash(torch, engine) -> int:
    """K3 launches of one speculative transcription's prefills: in a bf16
    engine one a layer of the target's audio tower and decoder
    (``prefill_flash``), of the draft's decoder and, for a DraftBundle,
    of its own audio tower; none in float32 (the JAX rule keeps its
    prompts dense)."""
    if engine.dtype != torch.bfloat16:
        return 0
    d_dec, _ = engine._spec_draft()
    bundle = engine.draft_bundle
    return (prefill_flash(engine.config) + d_dec.cfg.num_hidden_layers
            + (bundle.config.audio.encoder_layers if bundle else 0))


def spec_expected(target_quant, draft, lt: int, ld: int, k: int,
                  wgmma: bool, flash: int):
    """Launches of one speculative transcription: (the two prefills', each
    iteration's), for every counted kernel wrapper. An iteration runs K1
    once per draft step (k + 1), K2 in each of the draft's layers per step
    and, where the draft's GEMVs take the wgmma route (``wgmma``: bf16
    weights in a bf16 model), the wgmma GEMV 4 times in each of those
    layers per step, K5 for an int8 draft lm_head
    (int8, int4g, lm8 drafts) per step and, with an int8 target, for the
    verify's 4 merged linears per layer and its lm_head at k + 1 rows; K4
    for an int4 draft lm_head per step. The prefills: an int8 model's 4
    linears per layer and the lm_head at the last prompt token (K5), an
    int4 draft's lm_head there (K4), an int8 lm_head alone (K5), and K3
    ``flash`` times (``spec_flash``)."""
    names = tuple(kernel_wrappers())
    pre, per = dict.fromkeys(names, 0), dict.fromkeys(names, 0)
    pre["flash_attention"] = flash
    per["decode_layers_fused"] = k + 1
    per["decode_attention_dma"] = ld * (k + 1)
    if wgmma:
        per["gemv_wgmma"] = 4 * ld * (k + 1)
    if draft in ("int8", "int4g", "lm8"):
        per["quant_matmul"] += k + 1
        pre["quant_matmul"] += 4 * ld + 1 if draft == "int8" else 1
    if draft == "int4":
        per["quant_matvec_int4"] += k + 1
        pre["quant_matvec_int4"] += 1
    if target_quant == "int8":
        per["quant_matmul"] += 4 * lt + 1
        pre["quant_matmul"] += 4 * lt + 1
    return pre, per


def spec_run(torch, engine, samples, graphs=True, sampling=None):
    """One transcription's decode through the engine (speculative at B =
    1), the launch counters set to 0 just before it and read just after,
    the peak device memory above what was allocated before it. Returns
    (tokens, last_stats with last_spec_stats and peak_gib, launches)."""
    fns = kernel_wrappers()
    engine.cuda_graphs = graphs
    for fn in fns.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    toks = engine.generate(samples, sampling=sampling)
    got = {n: fn.launches for n, fn in fns.items()}
    engine.cuda_graphs = True
    st = dict(engine.last_stats)
    if engine.last_spec_stats is not None:
        st.update(engine.last_spec_stats)
    st["peak_gib"] = (torch.cuda.max_memory_allocated() - base) / 2**30
    return toks, st, got


def slab_gib(text_cfg, n: int, int8: bool) -> float:
    """GiB of one K and one V slab of n slots (int8: with float32 scales)."""
    per_slot = text_cfg.num_hidden_layers * text_cfg.num_key_value_heads
    per_slot *= text_cfg.head_dim + 4 if int8 else 2 * text_cfg.head_dim
    return 2 * per_slot * n / 2**30


def spec_logits(torch, engine, samples, toks) -> tuple:
    """Logits (len(toks) + 1, V) float32 teacher-forced on ``toks``: row
    t predicts token t (the last row, what follows the run). The plain
    path: the target's prefill, then a decode step per token, as the plain
    loop computes them. The verify: the prefill's row, then
    ``score_chunk`` of every token in one block."""
    dec, params = engine.decoder, engine.dec_params
    ids = torch.tensor([toks], dtype=torch.long, device=engine.device)
    with torch.inference_mode():
        logits, cache, b = engine.prefill(samples)
        plain = [logits.float()]
        for i in range(len(toks)):
            lg, _ = dec.decode_step(params, ids[:, i], b + i, cache)
            plain.append(lg.float())
        logits, cache, b = engine.prefill(samples)
        rows = dec.score_chunk(params, ids, b, cache, return_logits=True)[0]
        verify = torch.cat([logits.float(), rows[0].float()])
    return torch.cat(plain), verify


def spec_agreement(torch, engine, samples, want, got) -> dict:
    """Every token of a speculative run ``got`` against the plain K1 step
    teacher-forced on ``got`` (spec_logits): at each position the plain
    argmax, or a tie, where the two tokens' plain logits lie within
    ``tol`` (float32: SERVING_TIE; bf16: twice the target width's
    SPEC_BF16_SPREAD); and the run's end, where it stopped before
    max_new, an EOS token or a tie with one. bf16 also holds the spread,
    |verify - plain| at the plain step's two best tokens and the emitted
    one, within that bound at every position. ``want``: the plain loop's tokens, whose first
    difference is shown. Returns the row's ``agreement`` (``ok``)."""
    from qwen3_asr_rs_tpu_torch.runtime.engine import EOS_TOKEN_IDS

    plain, verify = spec_logits(torch, engine, samples, got)
    n = len(got)
    bound = (SPEC_BF16_SPREAD[engine.config.text.hidden_size]
             if engine.dtype != torch.float32 else None)
    tol = SERVING_TIE if bound is None else 2 * bound
    best, arg = plain.max(-1)
    rows = torch.arange(n, device=plain.device)
    emitted = torch.tensor(got, dtype=torch.long, device=plain.device)
    gap = (best[:n] - plain[rows, emitted]).tolist()
    if n < engine.max_new_tokens:  # it stopped at an EOS
        gap.append(float(best[n] - plain[n, list(EOS_TOKEN_IDS)].max()))
    top = plain.topk(2, dim=-1).indices
    cand = torch.cat([top[:n], emitted[:, None]], 1)
    spread = (verify[:n].gather(1, cand) - plain[:n].gather(1, cand)).abs()
    spread = spread.amax(1).tolist()
    flips = [{"step": t, "emitted": got[t] if t < n else "EOS",
              "plain": int(arg[t]), "gap": g,
              "spread": spread[t] if t < n else None,
              "top2_logits": plain[t].topk(2).values.tolist()}
             for t, g in enumerate(gap) if g > 0]
    first = next((t for t, (a, b) in enumerate(zip(want, got)) if a != b),
                 None if len(want) == n else min(len(want), n))
    out = {"tokens_checked": n, "ends_checked": n < engine.max_new_tokens,
           "first_difference_from_plain": first, "flips": flips[:8],
           "n_flips": len(flips), "gap_max": max(gap), "tol": tol,
           "spread_max": max(spread), "spread_p50": pct(spread, 50),
           "spread_p99": pct(spread, 99), "spread_bound": bound}
    if engine.kv_quant:
        # JAX's verify on an int8 slab attends its block's own K/V as
        # stored, a decode step its own unquantized: a departure must sit
        # at a near-tie of the plain step. The verify picks the emitted
        # token over the step's best only where its errors at the two
        # sum to at least their gap, so each departure's gap must lie
        # within twice the run's largest |verify - step| (spread_max);
        # bf16 also holds spread_max to the width's bound
        near = [float(top2[0] - top2[1])
                for top2 in plain.topk(2, dim=-1).values[:n + 1]]
        for f in flips:
            f["top2_gap"] = near[f["step"]]
        out.update(rule="near-tie: gap <= 2 x spread_max",
                   departures=len(flips), tol=2 * out["spread_max"],
                   top2_gap_max=max((near[t] for t, g in enumerate(gap)
                                     if g > 0), default=0.0))
    out["ok"] = out["gap_max"] <= out["tol"] and (
        bound is None or out["spread_max"] <= bound)
    return out


def held_to_plain(torch, engine, samples, want, got) -> dict:
    """A speculative run's tokens ``got`` against the plain loop's
    ``want``: equal, or spec_agreement's check of every token (on an
    int8 slab always: its departures and spread are reported)."""
    if got == want and not engine.kv_quant:
        return {"equal_to_plain": True, "ok": True}
    return {"equal_to_plain": got == want,
            **spec_agreement(torch, engine, samples, want, got)}


def plain_run(torch, engine, samples, profiled=False) -> tuple:
    """Plain greedy tokens of one clip and per step of the loop: wall, GPU
    elapsed and (``profiled``: a second run under torch.profiler) busy ms
    (busy_us over the loop's kernels)."""
    toks = engine.generate(samples)
    st = dict(engine.last_stats)
    times = {"tokens": len(toks), "steps": st["decode_steps"],
             "wall_ms_per_step": 1e3 * st["decode_seconds"]
             / max(st["decode_steps"], 1),
             "gpu_ms_per_step": 1e3 * st["decode_gpu_seconds"]
             / max(st["decode_steps"], 1),
             "wall_ms_per_token": 1e3 * st["decode_seconds"] / len(toks),
             "gpu_ms_per_token": 1e3 * st["decode_gpu_seconds"] / len(toks)}
    if profiled:
        _, events = loop_events(torch, lambda: engine.generate(samples))
        times["busy_ms_per_step"] = (busy_us(events) / 1e3
                                     / engine.last_stats["decode_steps"]
                                     if events else None)
        times["device_events"] = len(events)
    return toks, times


def spec_row(label, st, got, pre, per, plain_times, want, toks, engine,
             card) -> dict:
    """One speculative run's row: counts, times per iteration and per
    emitted token against the plain loop's, launches per iteration (the
    prefills' taken off), slabs, peak memory, tokens against plain."""
    runs = st["iterations_run"]
    dec_launch = {n: (got[n] - pre[n]) / runs for n in got}
    n_slab = st["slab_lens"][-1]
    d_text = (engine.draft_bundle.config.text if engine.draft_bundle
              else engine.config.text)
    return {"phase": "speculative", "run": label, "k": engine.spec_k,
            "iterations": st["iterations"], "tokens": st["tokens"],
            "mean_accepted": st["mean_accepted"],
            "drafts_accepted": st["drafts_accepted"],
            "iterations_run": runs, "replays": st["replays"],
            "captures": st["captures"], "slab_lens": st["slab_lens"],
            "ms_per_iteration": {
                "wall": 1e3 * st["decode_seconds"] / runs,
                "gpu": 1e3 * st["decode_gpu_seconds"] / runs},
            "ms_per_token": {
                "wall": 1e3 * st["decode_seconds"] / max(st["tokens"], 1),
                "gpu": 1e3 * st["decode_gpu_seconds"] / max(st["tokens"], 1)},
            "plain_ms_per_token": {"wall": plain_times["wall_ms_per_token"],
                                   "gpu": plain_times["gpu_ms_per_token"]},
            "launches_per_iteration": dec_launch,
            "launches_expected_per_iteration": per,
            "slab_gib": {"target": slab_gib(engine.config.text, n_slab,
                                            engine.kv_quant),
                         "draft": slab_gib(d_text, n_slab, engine.kv_quant)},
            "peak_gib": st["peak_gib"],
            "tokens_equal_plain": toks == want, "card": card}


def spec_check(torch, engine, samples, label, want, toks, st, got, pre, per,
               row) -> None:
    """Raise unless the launches are the prefills' plus per-iteration
    counts times the iterations run, and the tokens are held to plain
    greedy's (``row`` gains held_to_plain's ``agreement``)."""
    runs = st["iterations_run"]
    bad = {n: got[n] for n in got if got[n] != pre[n] + per[n] * runs}
    row["agreement"] = held_to_plain(torch, engine, samples, want, toks)
    emit(row)
    if bad:
        raise AssertionError(f"speculative {label}: launches {bad}, "
                             f"expected {pre} + {per} x {runs}")
    if not row["agreement"]["ok"]:
        raise AssertionError(f"speculative {label}: tokens leave the plain "
                             f"step's: {row['agreement']}")


def spec_breakdown(torch, engine, samples, card) -> None:
    """Where a speculative iteration's time goes, after a run on
    ``samples``: one replay of the kept first-stage iteration graph, and
    the verify (``score_chunk`` of k + 1 tokens) and one draft step (K1)
    each captured as a graph of its own and replayed (and the verify run
    eagerly, as a host-bound caller would), each the median of 10
    CUDA-event timings on the arenas of that run (their contents no
    longer matter)."""
    k = engine.spec_k
    p = engine._prompt_bucket(engine._chunk_bucket([samples]))
    n = engine._spec_slab_len(p, engine._segment_caps()[0])
    graph = next(g for key, g in engine._graphs.items()
                 if key[0] == "spec" and key[1] == n)
    d_dec, d_params = engine._spec_draft()
    cache = engine._slab0(1, n, ("spec", "target"))
    dcache = engine._slab0(1, n, ("spec", "draft"), d_dec)
    at = torch.tensor(p, device="cuda")
    block = torch.zeros((1, k + 1), dtype=torch.long, device="cuda")
    def verify():
        engine.decoder.score_chunk(engine.dec_params, block, at, cache)

    def draft_step():
        d_dec.decode_step_token(d_params, block[:, 0], at, dcache)

    with torch.inference_mode():
        iteration = cuda_ms(torch, graph.replay)
        verify_ms = cuda_ms(torch, engine._capture(verify).replay)
        step_ms = cuda_ms(torch, engine._capture(draft_step).replay)
        verify_eager = cuda_ms(torch, verify)
    emit({"phase": "speculative", "run": "iteration breakdown",
          "target": "0.6B bf16", "draft": "bf16 (self)", "slab": n,
          "iteration_ms": iteration, "verify_ms": verify_ms,
          "draft_step_ms": step_ms, "draft_steps_ms": (k + 1) * step_ms,
          "verify_share": verify_ms / iteration,
          "verify_eager_ms": verify_eager, "card": card})


def speculative_phase(torch, config, enc32, dec32, audio, card) -> dict:
    """Phase 10 (see the module docstring). Returns ({run: {kernel:
    launches}}, {kernel: {run: launches per iteration}})."""
    from qwen3_asr_rs_tpu_torch.config import synthetic_17b_config
    from qwen3_asr_rs_tpu_torch.runtime.engine import AsrEngine
    from qwen3_asr_rs_tpu_torch.runtime.sampling import SamplingParams
    from qwen3_asr_rs_tpu_torch.weights.convert import (
        init_decoder_params_np, init_encoder_params_np, to_torch)

    ld = config.text.num_hidden_layers  # the 0.6B draft's layers
    launches, per_iter = {}, {n: {} for n in kernel_wrappers()}

    def engine_for(cfg=config, params=(enc32, dec32), dtype=torch.bfloat16,
                   max_new=128, **kw):
        return AsrEngine(None, dtype=dtype, max_new_tokens=max_new,
                         config=cfg, params=params,
                         tokenizer=StubTokenizer(), device="cuda", **kw)

    def counted(engine, label, samples, want, plain_times, draft):
        """A capture run, then the counted run, which replays the kept
        first-stage graph: it captures nothing and replays every
        iteration it runs."""
        spec_run(torch, engine, samples)
        toks, st, got = spec_run(torch, engine, samples)
        if (len(st["slab_lens"]) != 1 or st["captures"]
                or st["replays"] != st["iterations_run"]):
            raise AssertionError(
                f"speculative {label}: {st['captures']} captures, "
                f"{st['replays']} replays of {st['iterations_run']} "
                f"iterations over {len(st['slab_lens'])} stages")
        pre, per = spec_expected(engine.quantize, draft,
                                 engine.config.text.num_hidden_layers, ld,
                                 engine.spec_k, draft == "bf16"
                                 and engine.dtype == torch.bfloat16,
                                 spec_flash(torch, engine))
        row = spec_row(label, st, got, pre, per, plain_times, want, toks,
                       engine, card)
        spec_check(torch, engine, samples, label, want, toks, st, got, pre,
                   per, row)
        launches[f"spec {label}"] = got
        for n in got:
            per_iter[n][label] = row["launches_per_iteration"][n]
        return toks, st

    def reference(engine, clips, label, profiled=False, **extra):
        """Plain greedy tokens and times per clip (plain_run), each row
        with the spread of the verify against the plain step along the
        plain tokens (spec_agreement), which must lie within its bound."""
        plain_run(torch, engine, audio[clips[0]])  # warm-up
        ref = {}
        for c in clips:
            toks, times = plain_run(torch, engine, audio[c], profiled)
            agree = spec_agreement(torch, engine, audio[c], toks, toks)
            emit({"phase": "speculative", "run": f"{label} plain {c} s",
                  **extra, **times,
                  **{k: agree[k] for k in agree if k.startswith("spread")},
                  "card": card})
            if not agree["ok"]:
                raise AssertionError(f"speculative {label} plain {c} s: "
                                     f"{agree}")
            ref[c] = toks, times
        return ref

    # plain greedy on the 0.6B target: the reference tokens and times
    plain = engine_for()
    ref = reference(plain, SPEC_CLIPS, "0.6B bf16")
    del plain
    torch.cuda.empty_cache()

    # same-checkpoint drafts at k = 4 on the 4 s and 30 s clips
    self_draft = {}  # clip -> the bf16 self-draft's (tokens, stats)
    for draft in SPEC_DRAFTS:
        engine = engine_for(speculative=draft, spec_k=SPEC_K)
        for c in SPEC_CLIPS:
            toks, st = counted(engine, f"0.6B {draft} draft {c} s", audio[c],
                               ref[c][0], ref[c][1], draft)
            if draft == "bf16":
                self_draft[c] = (toks, st)
                toks_e, st_e, _ = spec_run(torch, engine, audio[c],
                                           graphs=False)
                row = {"phase": "speculative",
                       "run": f"0.6B bf16 draft {c} s eager",
                       "graph_equals_eager": toks_e == toks,
                       "iterations_run": st_e["iterations_run"],
                       "ms_per_iteration": {
                           "wall": 1e3 * st_e["decode_seconds"]
                           / st_e["iterations_run"],
                           "gpu": 1e3 * st_e["decode_gpu_seconds"]
                           / st_e["iterations_run"]},
                       "card": card}
                emit(row)
                if toks_e != toks:
                    raise AssertionError(f"speculative bf16 {c} s: graph "
                                         "tokens differ from eager")
        if draft == "bf16":
            spec_breakdown(torch, engine, audio[SPEC_CLIPS[-1]], card)
            # speculative sampling on the self-draft
            sp = SamplingParams(seed=0, **SPEC_SAMPLED)
            s1, st1, got1 = spec_run(torch, engine, audio[4], sampling=sp)
            # draws: the prefill's, then per iteration k + 1 draft steps
            # and the accept's replacement (the draw kernel) and its
            # acceptance uniforms (threefry_noise)
            runs = st1["iterations_run"]
            draws = {"gumbel_argmax": 1 + runs * (SPEC_K + 2),
                     "threefry_noise": runs}
            if {n: got1[n] for n in draws} != draws:
                raise AssertionError(f"speculative sampling: draws "
                                     f"{got1}, expected {draws}")
            launches["spec 0.6B bf16 draft sampled"] = got1
            s2, _, _ = spec_run(torch, engine, audio[4], sampling=sp)
            s_e, _, _ = spec_run(torch, engine, audio[4], graphs=False,
                                 sampling=sp)
            s_o, _, _ = spec_run(torch, engine, audio[4],
                                 sampling=SamplingParams(seed=1,
                                                         **SPEC_SAMPLED))
            k1, _, _ = spec_run(torch, engine, audio[4],
                                sampling=SamplingParams(temperature=0.7,
                                                        top_k=1, seed=0))
            row = {"phase": "speculative", "run": "0.6B bf16 draft sampled",
                   "same_seed_equal": s1 == s2, "graph_equals_eager": s1 == s_e,
                   "other_seed_differs": s1 != s_o,
                   "top_k1_equals_greedy": k1 == ref[4][0],
                   "top_k1_agreement": held_to_plain(torch, engine, audio[4],
                                                     ref[4][0], k1),
                   "iterations": st1["iterations"], "tokens": st1["tokens"],
                   "mean_accepted": st1["mean_accepted"],
                   "ms_per_token": {
                       "wall": 1e3 * st1["decode_seconds"] / st1["tokens"],
                       "gpu": 1e3 * st1["decode_gpu_seconds"]
                       / st1["tokens"]},
                   "card": card}
            emit(row)
            if not (s1 == s2 == s_e and s1 != s_o
                    and row["top_k1_agreement"]["ok"]):
                raise AssertionError(f"speculative sampling: {row}")
        del engine
        torch.cuda.empty_cache()

    # the cross-model path with its drafts accepted, at full width: a
    # DraftBundle of the target's own 0.6B weights (its own encoder,
    # embeddings and slab) computes what the self-draft computes, so that
    # its tokens, iterations and accepted drafts must equal the
    # self-draft's; then its two slabs grow together through two stages
    # (ASR_DECODE_SEGMENT=32), with a multi-token window write per
    # iteration across the growth
    engine = engine_for(spec_k=SPEC_K, draft_model=(config, (enc32, dec32)))
    for c in SPEC_CLIPS:
        label = f"0.6B target 0.6B bundle draft {c} s"
        toks, st = counted(engine, label, audio[c], ref[c][0], ref[c][1],
                           "bf16")
        same = (toks, st["iterations"], st["drafts_accepted"]) == (
            self_draft[c][0], self_draft[c][1]["iterations"],
            self_draft[c][1]["drafts_accepted"])
        emit({"phase": "speculative", "run": label,
              "equals_self_draft": same, "card": card})
        if not same:
            raise AssertionError(f"speculative {label}: tokens or counts "
                                 "differ from the bf16 self-draft's")
    label = f"0.6B target 0.6B bundle draft {SPEC_CLIPS[-1]} s, 2 stages"
    with Env({"ASR_DECODE_SEGMENT": "32"}):
        toks, st, got = spec_run(torch, engine, audio[SPEC_CLIPS[-1]])
    pre, per = spec_expected(None, "bf16", ld, ld, SPEC_K, True,
                             spec_flash(torch, engine))
    row = spec_row(label, st, got, pre, per, ref[SPEC_CLIPS[-1]][1],
                   ref[SPEC_CLIPS[-1]][0], toks, engine, card)
    spec_check(torch, engine, audio[SPEC_CLIPS[-1]], label,
               ref[SPEC_CLIPS[-1]][0], toks, st, got, pre, per, row)
    if len(st["slab_lens"]) != 2 or st["drafts_accepted"] < st["iterations"]:
        raise AssertionError(f"speculative {label}: {len(st['slab_lens'])} "
                             f"stages, {st['drafts_accepted']} drafts "
                             f"accepted in {st['iterations']} iterations")
    launches[f"spec {label}"] = got
    for n in got:
        per_iter[n][label] = row["launches_per_iteration"][n]
    del engine
    torch.cuda.empty_cache()

    # an int8 target with the int8 KV slab and an int8 draft against its
    # own plain greedy, in bf16 and in float32: the verify attends its
    # block's own K/V as stored (JAX's), so a token may depart from plain
    # greedy at a near-tie (spec_agreement's int8-slab rule)
    for dtype in (torch.bfloat16, torch.float32):
        name = "bf16" if dtype == torch.bfloat16 else "f32"
        plain8 = engine_for(dtype=dtype, quantize="int8", kv_dtype="int8")
        ref8 = reference(plain8, (4,), f"0.6B {name} int8 target int8-KV")
        del plain8
        engine = engine_for(dtype=dtype, quantize="int8", kv_dtype="int8",
                            speculative="int8", spec_k=SPEC_K)
        counted(engine, f"0.6B {name} int8 target int8-KV int8 draft 4 s",
                audio[4], ref8[4][0], ref8[4][1], "int8")
        del engine
        torch.cuda.empty_cache()

    # float32, held to SERVING_TIE: an int8 draft under the float32 target;
    # and the self-draft, whose q equals p up to summation order, so that
    # speculative sampling accepts every draft
    plain32 = engine_for(dtype=torch.float32)
    ref32 = reference(plain32, (4,), "0.6B f32")
    del plain32
    engine = engine_for(dtype=torch.float32, speculative="int8",
                        spec_k=SPEC_K)
    counted(engine, "0.6B f32 int8 draft 4 s", audio[4], ref32[4][0],
            ref32[4][1], "int8")
    del engine
    engine = engine_for(dtype=torch.float32, max_new=SPEC_F32_MAX_NEW,
                        speculative="bf16", spec_k=SPEC_K)
    toks, st, _ = spec_run(torch, engine, audio[4],
                           sampling=SamplingParams(seed=0, **SPEC_SAMPLED))
    full = st["tokens"] == SPEC_F32_MAX_NEW
    row = {"phase": "speculative", "run": "0.6B f32 self-draft sampled",
           "iterations": st["iterations"], "tokens": st["tokens"],
           "mean_accepted": st["mean_accepted"],
           "drafts_accepted": st["drafts_accepted"],
           "every_draft_accepted":
               st["drafts_accepted"] == SPEC_K * st["iterations"],
           "card": card}
    emit(row)
    if not row["every_draft_accepted"] or (
            full and st["mean_accepted"] != SPEC_K):
        raise AssertionError(f"speculative float32 self-draft: {row}")
    del engine
    torch.cuda.empty_cache()

    # cross-model: a 1.7B target (synthetic_17b_config) with the 0.6B
    # model drafting, bf16 (bf16 and int8 drafts) and float32 (4 s)
    cfg17 = synthetic_17b_config()
    t0 = time.perf_counter()
    p17 = (to_torch(init_encoder_params_np(cfg17.audio), torch.float32,
                    "cuda"),
           to_torch(init_decoder_params_np(cfg17.text), torch.float32,
                    "cuda"))
    init_s = time.perf_counter() - t0
    for dtype, clips, drafts in ((torch.bfloat16, SPEC_CLIPS, (None, "int8")),
                                 (torch.float32, (4,), (None,))):
        name = "bf16" if dtype == torch.bfloat16 else "f32"
        plain17 = engine_for(cfg=cfg17, params=p17, dtype=dtype)
        # bf16: busy time too, from one profiled run more
        ref17 = reference(plain17, clips, f"1.7B {name}",
                          profiled=dtype == torch.bfloat16,
                          weights_init_s=init_s)
        del plain17
        torch.cuda.empty_cache()
        for draft in drafts:
            engine = engine_for(cfg=cfg17, params=p17, dtype=dtype,
                                speculative=draft, spec_k=SPEC_K,
                                draft_model=(config, (enc32, dec32)))
            for c in clips:
                counted(engine, f"1.7B {name} target 0.6B "
                        f"{draft or 'unquantized'} draft {c} s", audio[c],
                        ref17[c][0], ref17[c][1], draft or "bf16")
            del engine
            torch.cuda.empty_cache()
    del p17
    torch.cuda.empty_cache()
    return launches, per_iter


# phase 11: training at full 0.6B width (float32, AdamW, remat)
TRAIN_B = 8
TRAIN_STEPS = 6
TRAIN_LR = 1e-3
TRAIN_SECONDS = (27.0, 27.25, 27.5, 27.75, 28.0, 28.25, 28.5, 28.75)
# float32 outside the tensor cores, NVIDIA's H100 SXM data sheet (700 W)
FP32_PEAK_OPS_PER_S = 67e12
# card against CPU, float32: the loss rel 1e-5; each gradient leaf within
# 1e-4 of its largest magnitude (cuBLAS and the CPU's BLAS add in other
# orders), a leaf below 1e-9 everywhere excepted (the encoder's k_b: its
# exact gradient is 0, softmax ignores a shift shared by every key, so
# both sides hold rounding noise); parameters after one AdamW step atol
# 1e-6 / rtol 1e-5 plus, per element, the update that the leaf's
# measured gradient disagreement d can move: lr * min(2, 4 d / (|g| +
# eps)) (AdamW's first step is lr * g / (|g| + eps))
CARD_CPU_LOSS_RTOL = 1e-5
CARD_CPU_GRAD_REL = 1e-4
CARD_CPU_PARAM_TOL = (1e-6, 1e-5)
REMAT_RTOL = 1e-5
WORDS = ("the a of to and in is it that was for on are with as his they "
         "be at one have this from or had by word but what some we can out "
         "other were all there when up use your how said an each she which "
         "do their time if will way about many then them write would like "
         "so these her long make thing see him two has look more day "
         "could go come did number sound no most people my over know "
         "water than call first who may down side been now find").split()


class WordTokenizer:
    """One id per word (ids 200..5199), so that a transcript's length in
    tokens is its length in words."""

    def encode(self, text):
        return [200 + sum(map(ord, w)) % 5000 for w in text.split()]

    def decode(self, ids):
        return " ".join(map(str, ids))


def train_corpus(tmp: Path, seconds, seed: int) -> Path:
    """A manifest of synthetic WAVs with seeded word transcripts."""
    import numpy as np

    rng = np.random.default_rng(seed)
    rows = []
    for i, sec in enumerate(seconds):
        path = tmp / f"train_{seed}_{i}.wav"
        write_wav(path, sec, seed * 100 + i)
        text = " ".join(rng.choice(WORDS, size=int(3 * sec) // 2))
        rows.append({"audio": path.name, "text": text,
                     **({"language": "english"} if i % 2 else {})})
    manifest = tmp / f"train_{seed}.jsonl"
    manifest.write_text("".join(json.dumps(r) + "\n" for r in rows))
    return manifest


def train_step_flops(config, batch) -> float:
    """FLOPs of one remat train step from the shapes: the products and
    attention contractions of the forward (dense attention computes every
    score), times 3 (forward and backward) for the whole model and once
    more for the layers recomputed in the backward."""
    a, t = config.audio, config.text
    b, p = batch["token_ids"].shape
    chunks = batch["mel"].shape[-1] // a.chunk_frames
    tpc = a.tokens_per_chunk
    cpw = min(a.chunks_per_window, chunks)
    windows = -(-chunks // cpw)
    win = cpw * tpc
    d, ff = a.d_model, a.encoder_ffn_dim
    enc_tokens = b * windows * win
    enc_layers = a.encoder_layers * enc_tokens * (
        2 * (4 * d * d + 2 * d * ff) + 4 * win * d)
    # conv stem (3 convs, 3x3, stride 2) and conv_out, per chunk
    h, w, stem = a.num_mel_bins, a.chunk_frames, 0
    cin = 1
    for _ in range(3):
        h, w = (h - 1) // 2 + 1, (w - 1) // 2 + 1
        stem += 2 * cin * a.downsample_hidden_size * 9 * h * w
        cin = a.downsample_hidden_size
    stem = b * chunks * (stem + tpc * 2 * cin * h * d)
    enc_head = enc_tokens * 2 * (d * d + d * a.output_dim)
    hd, hq, hkv = t.head_dim, t.num_attention_heads, t.num_key_value_heads
    hs, inter = t.hidden_size, t.intermediate_size
    dec_layers = t.num_hidden_layers * b * p * (
        2 * (hs * hq * hd + 2 * hs * hkv * hd + hq * hd * hs
             + 3 * hs * inter) + 4 * p * hq * hd)
    lm_head = b * p * 2 * hs * t.vocab_size
    layers = enc_layers + dec_layers
    return float(4 * layers + 3 * (stem + enc_head + lm_head))


def flat_tree(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat_tree(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def grad_norms(torch, params) -> dict:
    return {k: float(v.grad.double().norm()) for k, v in
            flat_tree(params).items()}


def slice_layers(torch, tree, n: int, device):
    """The tree with its first n stacked layers, copied to ``device``."""
    out = {}
    for k, v in tree.items():
        if k == "layers":
            out[k] = {n_: t[:n].to(device, copy=True) for n_, t in v.items()}
        else:
            out[k] = v.to(device, copy=True)
    return out


def remat_check(torch, config, state, batch) -> dict:
    """Loss and gradient norms per leaf with and without remat, float32,
    the same parameters and the batch's first two rows."""
    from qwen3_asr_rs_tpu_torch.models.audio_encoder import AudioEncoder
    from qwen3_asr_rs_tpu_torch.models.text_decoder import TextDecoder
    from qwen3_asr_rs_tpu_torch.training import asr_loss

    small = {k: v[:2] for k, v in batch.items()}
    dec = TextDecoder(config.text, device="cuda")
    out = {}
    for remat in (False, True):
        state.optimizer.zero_grad(set_to_none=True)
        torch.cuda.reset_peak_memory_stats()
        enc = AudioEncoder(config.audio, device="cuda", remat=remat)
        loss = asr_loss(config, enc, dec, state.params, small, remat=remat)
        loss.backward()
        out[remat] = (loss.item(), grad_norms(torch, state.params),
                      torch.cuda.max_memory_allocated() / 2 ** 30)
    state.optimizer.zero_grad(set_to_none=True)
    (l0, g0, m0), (l1, g1, m1) = out[False], out[True]
    rel = max(abs(g1[k] - g0[k]) / max(g0[k], 1e-30) for k in g0)
    if abs(l1 - l0) > REMAT_RTOL * abs(l0) or rel > REMAT_RTOL:
        raise AssertionError(f"remat != no remat: loss {l1} vs {l0}, "
                             f"largest gradient-norm difference {rel}")
    return {"loss": l0, "loss_remat": l1, "grad_norm_max_rel_diff": rel,
            "leaves": len(g0), "peak_gib_no_remat": m0,
            "peak_gib_remat": m1, "rows": 2}


def cast_tree(tree, dtype, device=None):
    """Copies of a tree's tensors, cast to ``dtype`` and moved to
    ``device`` (None: where they are)."""
    if isinstance(tree, dict):
        return {k: cast_tree(v, dtype, device) for k, v in tree.items()}
    return tree.detach().to(device=device or tree.device, dtype=dtype,
                            copy=True)


def bf16_check(torch, config, state, batch) -> dict:
    """One bf16 SGD step of the full model (B = 2): a finite loss, and
    the lm_head gradient from matmul_f32's CUDA backward held against the
    float32 product of the same bf16 operands (rtol 2^-8: the gradient is
    rounded once to bf16)."""
    from qwen3_asr_rs_tpu_torch.ops import quant
    from qwen3_asr_rs_tpu_torch.training import (
        TrainState, make_train_step, sgd)

    bf = TrainState.create(cast_tree(state.params, torch.bfloat16),
                           sgd(TRAIN_LR))
    seen = []
    backward = quant._MatmulF32.backward

    def recording(ctx, g):
        seen.append((g.detach(), ctx.saved_tensors[0]))
        return backward(ctx, g)

    quant._MatmulF32.backward = staticmethod(recording)
    try:
        step = make_train_step(config, sgd(TRAIN_LR), device="cuda")
        bf, loss = step(bf, {k: v[:2] for k, v in batch.items()})
    finally:
        quant._MatmulF32.backward = backward
    if not torch.isfinite(loss):
        raise AssertionError(f"bf16 loss not finite: {loss}")
    if len(seen) != 1:
        raise AssertionError(f"matmul_f32's backward ran {len(seen)} times, "
                             "expected once (the lm_head)")
    g, h2 = seen[0]
    grad = bf.params["decoder"]["lm_head"].grad
    if grad.dtype != torch.bfloat16:
        raise AssertionError(f"lm_head gradient in {grad.dtype}")
    with torch.no_grad():
        ref = g.T @ h2.float()  # (V, H) d loss / d lm_head, float32
        err = (grad.float() - ref).abs()
    excess = float((err - (2 ** -8 * ref.abs() + 1e-12)).max())
    if excess > 0:
        raise AssertionError(f"bf16 lm_head gradient off its float32 "
                             f"product by {excess} beyond rtol 2^-8")
    return {"loss": float(loss), "rows": 2, "optimizer": "sgd",
            "lm_head_grad_max_rel_err": float(err.max() / ref.abs().max()),
            "tolerance": "rtol 2^-8"}


def card_cpu_check(torch, config, enc32, dec32, tmp) -> tuple:
    """One AdamW step of a 2 + 2 layer model at the real widths (B = 2,
    the 4-chunk bucket) on the card and on the CPU from the same tree;
    returns (row, the card's state, its batch, its step)."""
    from qwen3_asr_rs_tpu_torch.training import (
        AsrDataset, TrainState, adamw, make_train_step)

    small = dataclasses.replace(config, thinker_config=dataclasses.replace(
        config.thinker_config,
        audio_config=dataclasses.replace(config.audio, encoder_layers=2),
        text_config=dataclasses.replace(config.text, num_hidden_layers=2)))
    ds = AsrDataset(train_corpus(tmp, (3.5, 3.75), seed=12),
                    WordTokenizer(), config=small, chunk_buckets=(4,),
                    batch_size=2)
    batch = next(ds.batches())
    runs = {}
    for dev in ("cuda", "cpu"):
        tree = {"encoder": slice_layers(torch, enc32, 2, dev),
                "decoder": slice_layers(torch, dec32, 2, dev)}
        st = TrainState.create(tree, adamw(TRAIN_LR))
        step = make_train_step(small, adamw(TRAIN_LR), device=dev)
        t0 = time.perf_counter()
        st, loss = step(st, batch)
        runs[dev] = (st, float(loss), step, time.perf_counter() - t0)
    (gpu, lg, step_g, sg), (cpu, lc, _, sc) = runs["cuda"], runs["cpu"]
    if abs(lg - lc) > CARD_CPU_LOSS_RTOL * abs(lc):
        raise AssertionError(f"card loss {lg} != CPU loss {lc}")
    atol, rtol = CARD_CPU_PARAM_TOL
    worst_grad, worst_param, slack_used, noise_only = 0.0, 0.0, {}, {}
    fg, fc = flat_tree(gpu.params), flat_tree(cpu.params)
    for k in fc:
        gc = fc[k].grad
        gg = fg[k].grad.cpu()
        big = float(gc.abs().max())
        d = float((gg - gc).abs().max())
        if big > 1e-9:
            worst_grad = max(worst_grad, d / big)
            if d > CARD_CPU_GRAD_REL * big:
                raise AssertionError(f"{k}: card gradient off the CPU's by "
                                     f"{d / big} of its largest")
        else:
            noise_only[k] = big
        pc, pg = fc[k].detach(), fg[k].detach().cpu()
        diff = (pg - pc).abs()
        slack = TRAIN_LR * torch.clamp(4 * d / (gc.abs() + 1e-8), max=2.0)
        bound = atol + rtol * pc.abs()
        if bool((diff > bound + slack).any()):
            raise AssertionError(f"{k}: parameters after the step differ "
                                 f"by {float(diff.max())}")
        if bool((diff > bound).any()):
            slack_used[k] = int((diff > bound).sum())
        if k not in noise_only:
            worst_param = max(worst_param, float(diff.max()))
    n = sum(t.numel() for t in fc.values())
    del cpu
    row = {"loss_card": lg, "loss_cpu": lc,
           "loss_rel_diff": abs(lg - lc) / abs(lc),
           "grad_max_rel_diff": worst_grad,
           "noise_only_leaves": noise_only,
           "param_max_abs_diff": worst_param,
           "params_beyond_atol_rtol": slack_used, "params": n,
           "card_step_s": sg, "cpu_step_s": sc,
           "tokens": list(batch["token_ids"].shape),
           "tolerance": {"loss_rtol": CARD_CPU_LOSS_RTOL,
                         "grad_rel": CARD_CPU_GRAD_REL,
                         "param_atol_rtol": CARD_CPU_PARAM_TOL,
                         "param_slack": "lr * min(2, 4 d / (|g| + eps))"}}
    return row, gpu, batch, step_g


def checkpoint_check(torch, state, batch, step, tmp) -> dict:
    """save_train_state, a step (loss A), restore_train_state into the
    same tensors, the same step again (loss B): A must equal B."""
    from qwen3_asr_rs_tpu_torch.training import (
        restore_train_state, save_train_state)

    path = tmp / "train_ckpt"
    t0 = time.perf_counter()
    save_train_state(path, state)
    save_s = time.perf_counter() - t0
    at = state.step
    state, loss_a = step(state, batch)
    t0 = time.perf_counter()
    state = restore_train_state(path, state)
    restore_s = time.perf_counter() - t0
    if state.step != at:
        raise AssertionError(f"restored step {state.step}, saved {at}")
    state, loss_b = step(state, batch)
    if float(loss_a) != float(loss_b):
        raise AssertionError(f"loss after restore {float(loss_b)} != "
                             f"{float(loss_a)} without the round trip")
    size = sum(f.stat().st_size for f in path.iterdir())
    shutil.rmtree(path)
    return {"loss": float(loss_a), "loss_after_restore": float(loss_b),
            "bytes": size, "save_s": save_s, "restore_s": restore_s}


def export_check(torch, config, state, clip, tmp) -> dict:
    """save_checkpoint of the trained state, then AsrEngine(<dir>) on the
    card: its tensors equal the exported ones (a tied head is not
    written: the engine's lm_head is the trained embed), and it
    transcribes a clip."""
    from qwen3_asr_rs_tpu_torch.runtime.engine import AsrEngine
    from qwen3_asr_rs_tpu_torch.weights.export import save_checkpoint

    out = tmp / "export"
    t0 = time.perf_counter()
    save_checkpoint(out, state.params["encoder"], state.params["decoder"],
                    config)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine = AsrEngine(out, dtype=torch.float32, max_new_tokens=16,
                       tokenizer=StubTokenizer(), device="cuda")
    load_s = time.perf_counter() - t0
    want = {"encoder": state.params["encoder"],
            "decoder": dict(state.params["decoder"],
                            lm_head=state.params["decoder"]["embed"])}
    got = {"encoder": engine.enc_params, "decoder": engine.dec_params}
    fw, fg = flat_tree(want), flat_tree(got)
    if fw.keys() != fg.keys():
        raise AssertionError(f"engine tree {sorted(fg)} != {sorted(fw)}")
    bad = [k for k in fw if not torch.equal(fg[k], fw[k].detach())]
    if bad:
        raise AssertionError(f"loaded tensors differ from the export: {bad}")
    result = engine.transcribe(str(clip))
    size = sum(f.stat().st_size for f in out.iterdir())
    del engine
    shutil.rmtree(out)
    return {"bytes": size, "save_s": save_s, "engine_load_s": load_s,
            "tensors": len(fw), "text_chars": len(result.text)}


def forward_full_check(torch, config, dec32, fns) -> tuple:
    """forward_full on an int8 tree with an int4 lm_head (float32
    activations, B = 2, P = 208): the kernels (K5, K4) against the plain
    versions on the card; the launches counted exactly."""
    from qwen3_asr_rs_tpu_torch.models import text_decoder as ttd
    from qwen3_asr_rs_tpu_torch.ops.kernels.quant_matmul import (
        quant_matmul_plain)
    from qwen3_asr_rs_tpu_torch.ops.kernels.quant_matvec_int4 import (
        quant_matvec_int4_plain)
    from qwen3_asr_rs_tpu_torch.weights.quantize import (
        quantize_decoder_params)

    q = quantize_decoder_params(dec32, bits=8, lm_bits=4)
    dec = ttd.TextDecoder(config.text, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    ids = torch.randint(0, config.text.vocab_size, (2, 208), device="cuda",
                        generator=gen)
    pos = torch.arange(208, device="cuda")
    with torch.no_grad():
        hidden = dec.embed(q, ids)
        for fn in fns.values():
            fn.launches = 0
        got = dec.forward_full(q, hidden, pos)
        torch.cuda.synchronize()
        launches = {n: fn.launches for n, fn in fns.items()}
        kernels = ttd.quant_matmul, ttd.quant_matvec_int4
        ttd.quant_matmul, ttd.quant_matvec_int4 = (quant_matmul_plain,
                                                   quant_matvec_int4_plain)
        try:
            want = dec.forward_full(q, hidden, pos)
        finally:
            ttd.quant_matmul, ttd.quant_matvec_int4 = kernels
    per_layer = sum(n.endswith("_q") for n in q["layers"])
    expect = {"quant_matmul": config.text.num_hidden_layers * per_layer,
              "quant_matvec_int4": 1}
    for n, fn_launches in launches.items():
        if fn_launches != expect.get(n, 0):
            raise AssertionError(f"forward_full launched {n} "
                                 f"{fn_launches} times, expected "
                                 f"{expect.get(n, 0)}")
    err = max_err(torch, got, want)
    if err > PARITY_LOGITS_ATOL:
        raise AssertionError(f"forward_full int8/int4 logits off the plain "
                             f"versions by {err}")
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    return ({"max_abs_err": err, "tolerance": PARITY_LOGITS_ATOL,
             "argmax_agreement": agree, "launches": launches,
             "rows": 2 * 208}, launches)


def training_phase(torch, config, enc32, dec32, clip, tmp, card) -> dict:
    """Phase 11. Returns {path: {kernel: launches}}."""
    from qwen3_asr_rs_tpu_torch.training import (
        AsrDataset, TrainState, adamw, make_train_step, prefetch_to_device)

    fns = kernel_wrappers()
    t0 = time.perf_counter()
    ds = AsrDataset(train_corpus(tmp, TRAIN_SECONDS, seed=11),
                    WordTokenizer(), config=config, batch_size=TRAIN_B)
    batch = next(prefetch_to_device(ds.batches(), device="cuda"))
    data_s = time.perf_counter() - t0
    p_len = ds._seq_len(30)
    if tuple(batch["token_ids"].shape) != (TRAIN_B, p_len) or \
            batch["mel"].shape[-1] != 30 * config.audio.chunk_frames:
        raise AssertionError(f"training batch not in the 30-chunk bucket: "
                             f"{tuple(batch['token_ids'].shape)}, "
                             f"{tuple(batch['mel'].shape)}")

    state = TrainState.create({"encoder": enc32, "decoder": dec32},
                              adamw(TRAIN_LR))
    step = make_train_step(config, adamw(TRAIN_LR), remat=True,
                           device="cuda")
    for fn in fns.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    losses, ms = [], []
    for _ in range(TRAIN_STEPS):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        state, loss = step(state, batch)
        e1.record()
        torch.cuda.synchronize()
        losses.append(float(loss))
        ms.append(e0.elapsed_time(e1))
    step_launches = {n: fn.launches for n, fn in fns.items()}
    if any(step_launches.values()):
        raise AssertionError(f"a kernel ran in the train step: "
                             f"{step_launches}")
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        raise AssertionError(f"training losses {losses}")
    step_ms = sorted(ms[1:])[len(ms[1:]) // 2]
    flops = train_step_flops(config, batch)
    trained = sum(t.numel() for t in flat_tree(state.params).values())
    emit({"phase": "training", "case": "full width, float32, AdamW(1e-3), "
          "remat, B = 8, 30-chunk bucket", "nvidia_smi": card,
          "params_trained": trained, "tokens_per_step": TRAIN_B * p_len,
          "losses": losses, "step_ms": ms,
          "step_ms_median_2_6": step_ms,
          "tokens_per_s": TRAIN_B * p_len / (step_ms / 1e3),
          "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "step_tflop": flops / 1e12,
          "fp32_peak_tflops": FP32_PEAK_OPS_PER_S / 1e12,
          "fp32_peak_share": flops / (step_ms / 1e3) / FP32_PEAK_OPS_PER_S,
          "data_s": data_s, "launches": step_launches})

    emit({"phase": "training", "case": "remat against no remat",
          **remat_check(torch, config, state, batch)})
    emit({"phase": "training", "case": "one bf16 step",
          **bf16_check(torch, config, state, batch)})
    state.optimizer = None  # free the moments before the engine loads
    torch.cuda.empty_cache()
    emit({"phase": "training", "case": "export, then serve",
          **export_check(torch, config, state, clip, tmp)})
    del state
    torch.cuda.empty_cache()
    row, launches = forward_full_check(torch, config, dec32, fns)
    emit({"phase": "training", "case": "forward_full, int8 tree, int4 "
          "lm_head, float32", **row})
    row, small_state, small_batch, small_step = card_cpu_check(
        torch, config, enc32, dec32, tmp)
    emit({"phase": "training", "case": "card against CPU, 2 + 2 layers, "
          "B = 2, 4-chunk bucket, one AdamW step", **row})
    emit({"phase": "training", "case": "checkpoint round trip on the card",
          **checkpoint_check(torch, small_state, small_batch, small_step,
                             tmp)})
    del small_state
    torch.cuda.empty_cache()
    return {"training step": step_launches,
            "forward_full int8 lm4": launches}


# ---- phase 12: parallel ---------------------------------------------------

# (b) runs two ranks sharing cuda:0 over gloo (NCCL refuses two ranks on
# one card), so their times are not scaling numbers
PARALLEL_RANKS = 2
PARALLEL_TIMEOUT_S = 420
# tokens of a tp run: its steps run eagerly, each with 57 gloo all-reduces
# through the host (~100 ms a step with two ranks on one card), so the tp
# runs decode 32 tokens where the others decode 128; the bf16 spread is
# taken over all of them
PARALLEL_TP_TOKENS = 32
# timings of the 1 x 1 mesh and of no mesh, interleaved
PARALLEL_REPEATS = 3
# bf16 mesh runs: phase 10's rule at the 0.6B width
PARALLEL_BF16_TOL = 2 * SPEC_BF16_SPREAD[1024]


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def train_batch(config, b: int, seed: int) -> dict:
    """A synthetic training batch (tests/test_training.py's make_batch):
    a random two-chunk mel, random token ids, 8 target positions a row."""
    import numpy as np

    from qwen3_asr_rs_tpu_torch.runtime.prompt import AUDIO_OFFSET

    rng = np.random.default_rng(seed)
    cf, tpc = config.audio.chunk_frames, config.audio.tokens_per_chunk
    p_len = AUDIO_OFFSET + 2 * tpc + 16
    mask = np.zeros((b, p_len), np.float32)
    mask[:, -9:-1] = 1.0
    return {"mel": rng.standard_normal((b, config.audio.num_mel_bins, 2 * cf))
            .astype(np.float32),
            "n_frames": np.full(b, 2 * cf, np.int32),
            "n_audio": np.full(b, 2 * tpc, np.int32),
            "token_ids": rng.integers(0, config.text.vocab_size, (b, p_len))
            .astype(np.int32),
            "loss_mask": mask}


def ids_of(r) -> list:
    """Token ids of a result (StubTokenizer's raw output)."""
    return [int(t) for t in r.raw_output.split()]


def forced_logits(torch, engine, samples, toks):
    """float32 logits (len(toks) + 1, V) of a B = 1 engine teacher-forced
    on ``toks``: the prefill's, then one decode step per token (one
    device: K1; a tp mesh: the per-layer path, every rank calling)."""
    logits, cache, base = engine.prefill(samples)
    out = [logits[0].float()]
    for i, tok in enumerate(toks):
        logits, _ = engine.decoder.decode_step(
            engine.dec_params, torch.tensor([tok], device=engine.device),
            base + i, cache)
        out.append(logits[0].float())
    return torch.stack(out)


def agreement(torch, ref, samples, got, tol) -> dict:
    """Phase 10's rule for a mesh run's tokens ``got``: the one-device
    engine ``ref``'s K1 step teacher-forced on them gives, at every
    position, ``got``'s token as its argmax or within ``tol`` of it; where
    the run stopped before max_new, an EOS (or a tie with one)."""
    from qwen3_asr_rs_tpu_torch.runtime.engine import EOS_TOKEN_IDS

    plain = forced_logits(torch, ref, samples, got)
    n = len(got)
    best = plain.max(-1).values
    rows = torch.arange(n, device=plain.device)
    gap = (best[:n] - plain[rows, torch.tensor(got, device=plain.device)]
           ).tolist()
    if n < ref.max_new_tokens:
        gap.append(float(best[n] - plain[n, list(EOS_TOKEN_IDS)].max()))
    flips = [t for t, g in enumerate(gap) if g > 0]
    return {"tokens_checked": n, "n_flips": len(flips),
            "first_flip": flips[0] if flips else None,
            "gap_max": max(gap), "tol": tol, "ok": max(gap) <= tol}


def zero_counts(fns) -> None:
    for fn in fns.values():
        fn.launches = 0


def counts_of(fns) -> dict:
    return {n: fn.launches for n, fn in fns.items()}


def timed(torch, fn):
    """(fn(), host seconds to a synchronize)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def mesh_1x1(torch, config, enc32, dec32, audio, clips, card) -> dict:
    """Phase 12 (a): a 1 x 1 mesh over NCCL in this process, the
    deployment form on one card, against no mesh: ``transcribe`` of the
    4 s and 30 s clips (bf16, tokens equal, K1 once per decode step; xRT
    of each, the median
    of PARALLEL_REPEATS runs taken in turns, no mesh, mesh, mesh, no
    mesh, ...), a ContinuousBatcher on 4 x 4 s (tokens equal), one
    float32 train step (loss equal). Returns {path: {kernel:
    launches}}."""
    import torch.distributed as dist

    from qwen3_asr_rs_tpu_torch.parallel import make_mesh
    from qwen3_asr_rs_tpu_torch.runtime.engine import AsrEngine
    from qwen3_asr_rs_tpu_torch.runtime.serving import (
        ContinuousBatcher, Request)
    from qwen3_asr_rs_tpu_torch.training import make_train_step, sgd

    fns = kernel_wrappers()
    dist.init_process_group("nccl", rank=0, world_size=1,
                            init_method=f"tcp://127.0.0.1:{free_port()}")
    try:
        mesh = make_mesh(device_type="cuda")
        if tuple(mesh.shape) != (1, 1):
            raise AssertionError(f"1 x 1 mesh: shape {tuple(mesh.shape)}")
        runs, launches = {}, {}
        engines = {label: AsrEngine(
            None, dtype=torch.bfloat16, max_new_tokens=128, config=config,
            params=(enc32, dec32), tokenizer=StubTokenizer(), device="cuda",
            mesh=m) for label, m in (("no mesh", None), ("1 x 1 mesh", mesh))}
        for eng in engines.values():
            eng.transcribe_samples(audio[4])  # warm-up: the graphs
        for seconds in (4, 30):
            walls = {label: [] for label in engines}
            order = list(engines)
            for i in range(PARALLEL_REPEATS):
                for label in order if i % 2 == 0 else order[::-1]:
                    eng = engines[label]
                    zero_counts(fns)
                    r, wall = timed(torch, lambda: eng.transcribe(
                        clips[seconds]))
                    walls[label].append(wall)
                    runs[label, seconds] = {
                        "tokens": ids_of(r),
                        "decode_steps": eng.last_stats["decode_steps"],
                        "k1_launches": fns["decode_layers_fused"].launches}
                    launches[f"parallel {label}"] = counts_of(fns)
            for label, w in walls.items():
                runs[label, seconds].update(
                    wall_s=statistics.median(w), walls_s=w,
                    xRT=seconds / statistics.median(w))
        for label, eng in engines.items():
            b = ContinuousBatcher(eng, n_slots=4)
            reqs = [Request(audio[4]) for _ in range(4)]
            _, wall = timed(torch, lambda: b.drive(reqs))
            runs[label, "batcher"] = {"tokens": [served_tokens(q)
                                                 for q in reqs],
                                      "wall_s": wall, "mesh": b.mesh}
            del b
        del engines, eng
        torch.cuda.empty_cache()
        for key in ((4,), (30,), ("batcher",)):
            plain, meshed = runs[("no mesh",) + key], runs[("1 x 1 mesh",)
                                                           + key]
            if meshed["tokens"] != plain["tokens"]:
                raise AssertionError(f"1 x 1 mesh {key}: tokens differ")
            if "k1_launches" in meshed and \
                    meshed["k1_launches"] != meshed["decode_steps"]:
                raise AssertionError(f"1 x 1 mesh {key}: K1 launched "
                                     f"{meshed['k1_launches']} times in "
                                     f"{meshed['decode_steps']} steps")
            emit({"phase": "parallel", "case": f"1 x 1 NCCL mesh {key[0]}",
                  "tokens_equal": True,
                  **{f"{k}_mesh": v for k, v in meshed.items()
                     if k not in ("tokens", "mesh")},
                  **{f"{k}_no_mesh": v for k, v in plain.items()
                     if k != "tokens"},
                  "n_tokens": sum(map(len, meshed["tokens"]))
                  if key == ("batcher",) else len(meshed["tokens"]),
                  "card": card})
        losses = []
        for m in (None, mesh):
            step = make_train_step(config, sgd(1e-3), device="cuda", mesh=m)
            state = step.init({"encoder": enc32, "decoder": dec32})
            _, loss = step(state, train_batch(config, 2, seed=21))
            losses.append(float(loss))
            del state
            torch.cuda.empty_cache()
        if losses[0] != losses[1]:
            raise AssertionError(f"1 x 1 mesh train step: loss {losses[1]} "
                                 f"against {losses[0]}")
        emit({"phase": "parallel", "case": "1 x 1 NCCL mesh, float32 train "
              "step, B = 2", "loss_no_mesh": losses[0],
              "loss_mesh": losses[1], "card": card})
        return launches
    finally:
        dist.destroy_process_group()


def parallel_rank(rank: int, port: int, results, clips: dict,
                  tmp: Path) -> None:
    """Phase 12 (b), one of two ranks on cuda:0 over gloo (a spawned
    process): ``parallel_runs``, its rows and launches put on
    ``results``, or its traceback."""
    try:
        sys.path.insert(0, str(REPO))
        import torch
        import torch.distributed as dist

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.set_device(0)
        dist.init_process_group(
            "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
            world_size=PARALLEL_RANKS)
        try:
            rows, launches = parallel_runs(torch, rank, clips, tmp)
        finally:
            dist.destroy_process_group()
        results.put((rank, "ok", rows, launches))
    except Exception:  # noqa: BLE001 — reported by the parent
        import traceback

        results.put((rank, "error", traceback.format_exc(), None))


def parallel_runs(torch, rank: int, clips: dict, tmp: Path) -> tuple:
    """Phase 12 (b) on one rank, every run at the full 0.6B width and
    depth: dp = 2 (the 5-clip batch, bf16 and int8 weights), tp = 2 (the
    4 s clip in float32, bf16, int8 and blocked int4, PARALLEL_TP_TOKENS
    tokens), a dp = 2 serving burst of 4 x 4 s, a tp = 2
    serving_precision="auto" burst of 2 x 4 s, float32 train steps on
    dp = 2 (B = 2 a rank, unequal masks) and tp = 2 against the
    one-process step, and checkpoint round trips at dp = 2 and tp = 2
    (phase 11's 2 + 2 layer model, under ``tmp``). Returns (rows, {path:
    {kernel: launches}})."""
    import numpy as np

    from qwen3_asr_rs_tpu_torch import AsrConfig
    from qwen3_asr_rs_tpu_torch.parallel import make_mesh
    from qwen3_asr_rs_tpu_torch.parallel.comm import COUNTS
    from qwen3_asr_rs_tpu_torch.runtime.engine import AsrEngine
    from qwen3_asr_rs_tpu_torch.weights.convert import (
        init_decoder_params_np, init_encoder_params_np, to_torch)

    config = AsrConfig()
    layers = config.text.num_hidden_layers
    t0 = time.perf_counter()
    enc32 = to_torch(init_encoder_params_np(config.audio), torch.float32,
                     "cuda")
    dec32 = to_torch(init_decoder_params_np(config.text), torch.float32,
                     "cuda")
    rows = [{"case": "rank start", "weights_s": time.perf_counter() - t0}]
    dp2 = make_mesh(dp=2, tp=1, device_type="cuda")
    tp2 = make_mesh(dp=1, tp=2, device_type="cuda")
    fns = kernel_wrappers()
    launches = {}

    def engine(mesh, dtype, env=None, max_new=128, **kw):
        with Env(env or {}):
            return AsrEngine(None, dtype=dtype, max_new_tokens=max_new,
                             config=config, params=(enc32, dec32),
                             tokenizer=StubTokenizer(), device="cuda",
                             mesh=mesh, **kw)

    five = [clips[c] for c in FIVE_CLIPS]
    # dp = 2: each rank's 4 rows through the one-device path
    for quantize in (None, "int8"):
        label = f"dp=2 5 clips bf16 {quantize or 'bf16'} weights"
        ref = engine(None, torch.bfloat16, quantize=quantize)
        ref.transcribe_batch(five)  # warm-up: the graphs
        want, ref_wall = timed(torch, lambda: ref.transcribe_batch(five))
        eng = engine(dp2, torch.bfloat16, quantize=quantize)
        eng.transcribe_batch(five)  # warm-up: this rank's graphs
        zero_counts(fns)
        COUNTS.clear()
        got, wall = timed(torch, lambda: eng.transcribe_batch(five))
        steps = eng.last_stats["decode_steps"]
        runs = counts_of(fns)
        want_k = expected_launches(quantize, {}, layers, steps,
                                   prefill_flash(config))
        del want_k["lm_head_products"]
        check_launches(f"{label} rank {rank}", runs, want_k)
        if COUNTS:
            raise AssertionError(f"{label}: a dp rank's decode issued "
                                 f"collectives {dict(COUNTS)}")
        agree = [agreement(torch, ref, s, ids_of(r), PARALLEL_BF16_TOL)
                 for s, r in zip(five, got)]
        rows.append({"case": label, "rows_per_rank": 4,
                     "tokens_equal": [ids_of(a) == ids_of(b)
                                      for a, b in zip(got, want)],
                     "agreement": agree, "decode_steps": steps,
                     "launches": runs, "wall_s": wall,
                     "xRT": sum(FIVE_CLIPS) / wall,
                     "one_device_wall_s": ref_wall,
                     "one_device_xRT": sum(FIVE_CLIPS) / ref_wall})
        if not all(a["ok"] for a in agree):
            raise AssertionError(f"{label}: tokens left the one-device "
                                 f"step: {agree}")
        launches[f"parallel {label} rank {rank}"] = runs
        del ref, eng
        torch.cuda.empty_cache()

    # tp = 2: the 4 s clip; K1 declined, K2 per layer on local heads
    for dtype, quantize in ((torch.float32, None), (torch.bfloat16, None),
                            (torch.bfloat16, "int8"),
                            (torch.bfloat16, "int4")):
        label = (f"tp=2 4 s {str(dtype)[6:]} "
                 f"{quantize + ' weights' if quantize else ''}").strip()
        env = {"ASR_LM_BITS": "8"} if quantize == "int4" else {}
        ref = engine(None, dtype, env, PARALLEL_TP_TOKENS, quantize=quantize)
        want = ids_of(ref.transcribe_samples(clips[4]))
        eng = engine(tp2, dtype, max_new=PARALLEL_TP_TOKENS,
                     quantize=quantize)
        zero_counts(fns)
        COUNTS.clear()
        r, wall = timed(torch, lambda: eng.transcribe_samples(clips[4]))
        got, steps = ids_of(r), eng.last_stats["decode_steps"]
        runs, collectives = counts_of(fns), dict(COUNTS)
        k5 = {"int8": 7 * layers * (steps + 1) + steps + 1,
              "int4": steps + 1}.get(quantize, 0)
        check_launches(f"{label} rank {rank}", runs, {
            "decode_layers_fused": 0, "decode_attention_dma": layers * steps,
            "flash_attention": (prefill_flash(config)
                                if dtype == torch.bfloat16 else 0),
            "quant_matmul": k5,
            "quant_matvec_int4": 0, "decode_attention_slab": 0,
            "decode_attention": 0})
        # one decode step's collectives
        logits, cache, base = eng.prefill(clips[4])
        COUNTS.clear()
        eng.decoder.decode_step(eng.dec_params, logits.argmax(-1), base,
                                cache)
        step_coll = dict(COUNTS)
        if step_coll != {"all_reduce": 2 * layers + 1, "all_gather": 1}:
            raise AssertionError(f"{label}: a tp decode step issued "
                                 f"{step_coll}")
        tol = SERVING_TIE if dtype == torch.float32 else PARALLEL_BF16_TOL
        agree = agreement(torch, ref, clips[4], got, tol)
        spread = (forced_logits(torch, eng, clips[4], got)
                  - forced_logits(torch, ref, clips[4], got)).abs()
        per_pos = spread.amax(-1).tolist()
        rows.append({"case": label, "tokens_equal": got == want,
                     "n_tokens": len(got), "agreement": agree,
                     "logit_spread_max": max(per_pos),
                     "logit_spread_p50": pct(per_pos, 50),
                     "spread_positions": len(per_pos),
                     "decode_steps": steps, "launches": runs,
                     "collectives": collectives,
                     "collectives_per_decode_step": step_coll,
                     "wall_s": wall, "xRT": 4 / wall,
                     "decode_ms_per_step": 1e3 * eng.last_stats[
                         "decode_seconds"] / max(steps, 1)})
        if not agree["ok"]:
            raise AssertionError(f"{label}: tokens left the one-device "
                                 f"step: {agree}")
        launches[f"parallel {label} rank {rank}"] = runs
        del ref, eng, cache
        torch.cuda.empty_cache()

    rows.append(parallel_serving(torch, engine, dp2, rank, clips, fns,
                                 launches, layers))
    rows.append(parallel_auto_serving(torch, engine, tp2, rank, clips, fns,
                                      launches, layers))
    rows.extend(parallel_training(torch, config, enc32, dec32, dp2, tp2,
                                  rank, fns))
    rows.extend(parallel_checkpoints(torch, config, enc32, dec32, dp2, tp2,
                                     tmp))
    return rows, launches


def parallel_serving(torch, engine, mesh, rank, clips, fns, launches,
                     layers) -> dict:
    """A dp = 2 ContinuousBatcher (2 slots a rank) on 4 x 4 s, bf16: a
    warm-up burst (the segment graphs), then a counted burst; the lead
    rank's tokens held to the one-device step (phase 10's rule)."""
    from qwen3_asr_rs_tpu_torch.parallel.comm import COUNTS
    from qwen3_asr_rs_tpu_torch.runtime.serving import (
        ContinuousBatcher, Request)

    b = ContinuousBatcher(engine(mesh, torch.bfloat16), n_slots=4)
    b.drive([Request(clips[4]) for _ in range(4)])  # warm-up
    stats0 = dict(b.stats)
    zero_counts(fns)
    COUNTS.clear()
    reqs = [Request(clips[4]) for _ in range(4)]
    _, wall = timed(torch, lambda: b.drive(reqs))
    stats = {k: n - stats0[k] for k, n in b.stats.items()}
    steps, segs = stats["steps"], stats["segments"]
    runs, collectives = counts_of(fns), dict(COUNTS)
    check_launches(f"dp=2 serving rank {rank}", runs, {
        "decode_layers_fused": 0, "decode_attention_dma": layers * steps,
        "flash_attention": admission_flash(b.engine.config, stats),
        "quant_matmul": 0, "quant_matvec_int4": 0})
    if collectives.get("all_gather") != segs:
        raise AssertionError(f"dp=2 serving: {collectives} for {segs} "
                             "segments (one all-gather each)")
    row = {"case": "dp=2 serving 4 x 4 s bf16", "n_slots": b.n_slots,
           "slots_per_rank": b.n_local, "segments": segs,
           "decode_steps": steps, "launches": runs,
           "collectives": collectives, "wall_s": wall, "xRT": 16 / wall}
    if b.lead:
        ref = engine(None, torch.bfloat16)
        agree = [agreement(torch, ref, clips[4], served_tokens(q),
                           PARALLEL_BF16_TOL) for q in reqs]
        row["agreement"] = agree
        row["n_tokens"] = [len(served_tokens(q)) for q in reqs]
        if not all(a["ok"] for a in agree):
            raise AssertionError(f"dp=2 serving: tokens left the one-device "
                                 f"step: {agree}")
        del ref
    launches[f"parallel dp=2 serving rank {rank}"] = runs
    del b
    torch.cuda.empty_cache()
    return row


def parallel_auto_serving(torch, engine, mesh, rank, clips, fns, launches,
                          layers) -> dict:
    """A tp = 2 ContinuousBatcher over a bf16 engine with
    serving_precision="auto" on 2 x 4 s (PARALLEL_TP_TOKENS tokens; two
    live slots, so every segment runs the int8 copy the batcher built from
    this rank's pieces): K5 counted exactly, 7 linears a layer and the
    lm_head per int8 decode step; the lead rank's tokens held to the
    one-device int8 engine's K1 step (phase 10's rule)."""
    from qwen3_asr_rs_tpu_torch.parallel.comm import COUNTS
    from qwen3_asr_rs_tpu_torch.runtime.serving import (
        ContinuousBatcher, Request)

    COUNTS.clear()
    t0 = time.perf_counter()
    b = ContinuousBatcher(engine(mesh, torch.bfloat16,
                                 max_new=PARALLEL_TP_TOKENS),
                          n_slots=2, serving_precision="auto")
    build_s, build_coll = time.perf_counter() - t0, dict(COUNTS)
    zero_counts(fns)
    COUNTS.clear()
    reqs = [Request(clips[4]) for _ in range(2)]
    _, wall = timed(torch, lambda: b.drive(reqs))
    steps, segs = b.stats["steps"], b.stats["segments"]
    runs = counts_of(fns)
    per_step = 7 * layers + 1
    check_launches(f"tp=2 auto serving rank {rank}", runs, {
        "decode_layers_fused": 0, "decode_attention_dma": layers * steps,
        "flash_attention": admission_flash(b.engine.config, b.stats),
        "quant_matmul": per_step * steps,
        "quant_matvec_int4": 0})
    if b.variants_run != {("greedy", "int8")}:
        raise AssertionError(f"tp=2 auto serving: segments ran "
                             f"{b.variants_run}, not int8 alone")
    row = {"case": "tp=2 serving auto 2 x 4 s bf16", "n_slots": b.n_slots,
           "segments": segs, "decode_steps": steps,
           "variants": sorted(b.variants_run), "launches": runs,
           "quant_matmul_per_int8_step": runs["quant_matmul"] / steps,
           "int8_copy_s": build_s, "int8_copy_collectives": build_coll,
           "collectives": dict(COUNTS), "wall_s": wall,
           "wall_ms_per_step": 1e3 * wall / steps, "xRT": 8 / wall}
    if b.lead:
        ref = engine(None, torch.bfloat16, max_new=PARALLEL_TP_TOKENS,
                     quantize="int8")
        agree = [agreement(torch, ref, clips[4], served_tokens(q),
                           PARALLEL_BF16_TOL) for q in reqs]
        row["agreement"] = agree
        row["n_tokens"] = [len(served_tokens(q)) for q in reqs]
        if not all(a["ok"] for a in agree):
            raise AssertionError(f"tp=2 auto serving: tokens left the "
                                 f"one-device int8 step: {agree}")
        del ref
    launches[f"parallel tp=2 auto serving rank {rank}"] = runs
    del b
    torch.cuda.empty_cache()
    return row


def parallel_checkpoints(torch, config, enc32, dec32, dp2, tp2,
                         tmp: Path) -> list:
    """Checkpoint round trips of an AdamW state on dp = 2 and tp = 2, on
    phase 11's 2 + 2 layer model at the real widths (a full-depth float32
    AdamW state is ~11.3 GB on disk): one step, save_train_state (every
    rank gathers, the lead writes; timed), a step (loss A), a restore
    into the same state (each rank cuts its pieces; timed), the same step
    (loss B): A must equal B. The lead checks that the file holds the
    whole tensors (their shapes, read lazily) and removes it once every
    rank has restored."""
    from qwen3_asr_rs_tpu_torch.parallel.comm import barrier, is_lead
    from qwen3_asr_rs_tpu_torch.training import (
        adamw, dp_rows, make_train_step, restore_train_state,
        save_train_state)

    small = dataclasses.replace(config, thinker_config=dataclasses.replace(
        config.thinker_config,
        audio_config=dataclasses.replace(config.audio, encoder_layers=2),
        text_config=dataclasses.replace(config.text, num_hidden_layers=2)))
    whole = {"encoder": slice_layers(torch, enc32, 2, "cuda"),
             "decoder": slice_layers(torch, dec32, 2, "cuda")}
    batch = train_batch(small, 4, seed=23)
    rows = []
    for label, mesh in (("dp=2", dp2), ("tp=2", tp2)):
        step = make_train_step(small, adamw(TRAIN_LR), device="cuda",
                               mesh=mesh)
        mine = dp_rows(batch, mesh)
        state, _ = step(step.init(whole), mine)
        path = tmp / f"parallel_ckpt_{label}"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_train_state(path, state)
        save_s = time.perf_counter() - t0
        state, loss_a = step(state, mine)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = restore_train_state(path, state)
        torch.cuda.synchronize()
        restore_s, at = time.perf_counter() - t0, state.step
        state, loss_b = step(state, mine)
        row = {"case": f"checkpoint round trip {label}, 2 + 2 layers, "
                       "AdamW, float32",
               "loss": float(loss_a), "loss_after_restore": float(loss_b),
               "save_s": save_s, "restore_s": restore_s,
               "restored_step": at}
        if is_lead(mesh):
            saved = torch.load(path / "state.pt", map_location="cpu",
                               weights_only=True, mmap=True)
            shapes = {k: tuple(v.shape) for k, v in
                      flat_tree(saved["params"]).items()}
            row["whole_tensors"] = shapes == {
                k: tuple(v.shape) for k, v in flat_tree(whole).items()}
            row["bytes"] = (path / "state.pt").stat().st_size
            del saved
        barrier(mesh)
        if is_lead(mesh):
            shutil.rmtree(path)
        rows.append(row)
        if float(loss_a) != float(loss_b) or row["restored_step"] != 1 or (
                row.get("whole_tensors") is False):
            raise AssertionError(f"checkpoint {label}: {row}")
        del state
        torch.cuda.empty_cache()
    return rows


def parallel_training(torch, config, enc32, dec32, dp2, tp2, rank,
                      fns) -> list:
    """float32 SGD steps on dp = 2 (B = 2 a rank; the ranks' loss masks
    differ) and tp = 2 (B = 4), against the one-process step on the same
    4 rows: the loss within CARD_CPU_LOSS_RTOL, every gradient leaf (tp:
    this rank's shard of it) within CARD_CPU_GRAD_REL of its largest
    one-process magnitude; no kernel launched."""
    from qwen3_asr_rs_tpu_torch.parallel import (
        decoder_param_specs, encoder_param_specs, match_specs)
    from qwen3_asr_rs_tpu_torch.training import dp_rows, make_train_step, sgd

    batch = train_batch(config, 4, seed=22)
    batch["loss_mask"][3, :] = 0.0       # rank 1 of dp = 2: 8 targets
    batch["loss_mask"][1, -9:-5] = 0.0   # rank 0: 12
    whole = {"encoder": enc32, "decoder": dec32}
    step = make_train_step(config, sgd(1e-3), device="cuda")
    state = step.init(whole)
    _, ref_loss = step(state, batch)
    ref = {k: v.grad for k, v in flat_tree(state.params).items()}
    del state
    rows = []
    for label, mesh in (("dp=2, B = 2 a rank, unequal masks", dp2),
                        ("tp=2, B = 4", tp2)):
        step = make_train_step(config, sgd(1e-3), device="cuda", mesh=mesh)
        state = step.init(whole)
        zero_counts(fns)
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        _, loss = step(state, dp_rows(batch, mesh))
        e1.record()
        torch.cuda.synchronize()
        if any(counts_of(fns).values()):
            raise AssertionError(f"{label}: a kernel ran in the train step")
        tp = mesh.size(1)
        specs = flat_tree(match_specs(whole, {
            "encoder": encoder_param_specs(
                config.audio.encoder_attention_heads, tp),
            "decoder": decoder_param_specs()}))
        worst = (0.0, None)
        for name, leaf in flat_tree(state.params).items():
            want = ref[name]
            scale = float(want.abs().max())
            if scale < 1e-9:  # an exact 0 (the encoder's k_b): noise
                continue
            spec = specs[name]
            if tp > 1 and "tp" in spec:
                d = spec.index("tp")
                n = want.shape[d] // tp
                want = want.narrow(d, mesh.get_local_rank("tp") * n, n)
            rel = float((leaf.grad - want).abs().max()) / scale
            worst = max(worst, (rel, name))
        loss_rel = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
        rows.append({"case": f"train step {label}, float32",
                     "loss": float(loss), "one_process_loss": float(ref_loss),
                     "loss_rel": loss_rel, "grad_rel_max": worst[0],
                     "grad_rel_max_leaf": worst[1],
                     "step_ms": e0.elapsed_time(e1)})
        if loss_rel > CARD_CPU_LOSS_RTOL or worst[0] > CARD_CPU_GRAD_REL:
            raise AssertionError(f"{label}: {rows[-1]}")
        del state
        torch.cuda.empty_cache()
    return rows


def parallel_phase(torch, config, enc32, dec32, audio, paths, tmp,
                   card) -> dict:
    """Phase 12. (a) the 1 x 1 NCCL mesh here; (b) two spawned ranks on
    cuda:0 over gloo (the parent has initialised CUDA, so fork is
    unsafe), this process's cached memory freed first. A rank's failure
    fails the phase. Returns {path: {kernel: launches}}."""
    import multiprocessing
    import queue

    launches = mesh_1x1(torch, config, enc32, dec32, audio, paths, card)
    gc.collect()
    torch.cuda.empty_cache()
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    clips = {c: audio[c] for c in FIVE_CLIPS}
    procs = [ctx.Process(target=parallel_rank,
                         args=(r, port, results, clips, tmp))
             for r in range(PARALLEL_RANKS)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    done, errors = {}, []
    try:
        while len(done) + len(errors) < PARALLEL_RANKS:
            if time.perf_counter() - t0 > PARALLEL_TIMEOUT_S:
                raise AssertionError("parallel: a rank did not finish in "
                                     f"{PARALLEL_TIMEOUT_S} s")
            try:
                rank, status, rows, runs = results.get(timeout=5)
            except queue.Empty:  # is every rank alive?
                dead = [p.exitcode for p in procs if p.exitcode not in
                        (None, 0)]
                if dead:
                    raise AssertionError(f"parallel: a rank exited with "
                                         f"{dead} and no report")
                continue
            if status != "ok":
                errors.append(f"rank {rank}:\n{rows}")
                continue
            done[rank] = rows
            launches.update(runs)
        if errors:
            raise AssertionError("parallel: " + "\n".join(errors))
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    for rank in sorted(done):
        for row in done[rank]:
            emit({"phase": "parallel", "rank": rank,
                  "ranks_share": "cuda:0 over gloo (times are not scaling "
                                 "numbers)", **row, "card": card})
    emit({"phase": "parallel", "case": "ranks", "seconds":
          time.perf_counter() - t0, "card": card})
    return launches


# Phase 13: the routed decoder (benchmark/configs/kimi-vl-a3b-asr.json).
# K7 and K8 against their plain versions at the offline cell's shapes, at
# the configuration's widths and weight scale: a decode step's 64 rows
# and a 64-clip prefill's 64 x 432, a third of whose rows are prompt (the
# rest padding, routed nowhere). Tolerances: the routes exactly, their
# weights to float32 rounding (the kernel's sigmoid against torch's,
# ROUTED_W_ATOL); an output both sides round to bf16, summed in another
# float32 order, within ROUTED_RTOL of its largest value (two bf16 units;
# at scale 0.05 the experts' outputs reach ~10, where one unit is 2^-5).
ROUTED_CONFIG = REPO / "benchmark" / "configs" / "kimi-vl-a3b-asr.json"
ROUTED_DECODE_ROWS = 64
ROUTED_PROMPT = 432
ROUTED_W_ATOL = 1e-6
ROUTED_RTOL = 2 ** -7
# layers of the transcribe_batch whose launches are counted: the dense
# layer and three MoE layers at the published widths
ROUTED_LAYERS = 4


def _routed_text(cfg: dict) -> dict:
    top = {k: v for k, v in cfg.items() if k != "thinker_config"}
    return {**top, **cfg["thinker_config"]["text_config"]}


def routed_kernel_checks(torch, cfg, card) -> list:
    """K7 (route, align, the expert products) and K8 (RMSNorm, the
    latent's prologue) against their plain versions; one JSON line each
    with the error, ms, plain ms, the bound and a library yardstick."""
    import numpy as np

    from qwen3_asr_rs_tpu_torch.ops.kernels.fused_elementwise import (
        latent_rope, latent_rope_plain, rms_norm)
    from qwen3_asr_rs_tpu_torch.ops.kernels.moe_experts import (
        align, align_plain, block_rows, moe_experts, moe_experts_plain,
        route, route_plain)
    from qwen3_asr_rs_tpu_torch.ops.norms import rms_norm as rms_norm_plain

    t = _routed_text(cfg)
    scale = cfg["weight_init"]["scale"]
    h, inter = t["hidden_size"], t["moe_intermediate_size"]
    e, k = t["n_routed_experts"], t["num_experts_per_tok"]
    g = torch.Generator(device="cuda").manual_seed(11)

    def w(*shape):
        return (torch.randn(*shape, generator=g, device="cuda")
                * scale).bfloat16()

    gu, dn, rw, bias = w(e, h, 2 * inter), w(e, inter, h), w(h, e), w(e)
    rows_out = []
    lengths = np.clip(np.random.default_rng(3).lognormal(
        np.log(145), 0.3, ROUTED_DECODE_ROWS).astype(int), 20, ROUTED_PROMPT)
    for case, n_tok in (("decode", ROUTED_DECODE_ROWS),
                        ("prefill", ROUTED_DECODE_ROWS * ROUTED_PROMPT)):
        x = torch.randn(n_tok, h, generator=g, device="cuda").bfloat16()
        if case == "decode":
            live = torch.ones(n_tok, dtype=torch.bool, device="cuda")
        else:
            slot = torch.arange(ROUTED_PROMPT, device="cuda")
            start = ROUTED_PROMPT - torch.tensor(lengths, device="cuda")
            live = (slot[None, :] >= start[:, None]).reshape(-1)
        args = (x, rw, bias, k, t["routed_scaling_factor"],
                t["norm_topk_prob"], live)
        got, want = route(*args), route_plain(*args)
        order, w_order = got.ids.argsort(-1), want.ids.argsort(-1)
        if not (got.ids.gather(1, order) == want.ids.gather(1, w_order)).all():
            raise AssertionError(f"moe route {case}: other experts chosen")
        w_err = max_err(torch, got.weights.gather(1, order),
                        want.weights.gather(1, w_order))
        if w_err > ROUTED_W_ATOL or not (got.counts.long()
                                         == want.counts).all():
            raise AssertionError(f"moe route {case}: weights off by {w_err}"
                                 " or counts differ")
        bm = block_rows(got.ids.numel(), e)
        s_got, b_got = align(got, bm)
        s_want, b_want = align_plain(got, bm)
        if not ((s_got == s_want).all() and (b_got == b_want).all()):
            raise AssertionError(f"moe align {case}: another grouping")
        y = moe_experts(x, got, gu, dn)
        y_plain = moe_experts_plain(x, got, gu, dn)
        err = max_err(torch, y, y_plain)
        top = float(y_plain.float().abs().max())
        if err > ROUTED_RTOL * top or (y[~live] != 0).any():
            raise AssertionError(f"moe_experts {case}: max|err| {err} over "
                                 f"{ROUTED_RTOL} x {top}")
        counts = got.counts.long()
        touched, n_routes = int((counts > 0).sum()), int(counts.sum())
        # each touched expert's weights once, each route's row in, its
        # activation out and in, its float32 row out; 2 ops per weight
        # and route
        work = bound_of(touched * 3 * h * inter * 2
                        + n_routes * (h * 2 + 2 * inter * 2 + 4 * h),
                        2.0 * n_routes * 3 * h * inter)
        # library yardstick: torch.bmm over every expert, rows padded to
        # the fullest expert's (the gather and padding untimed)
        m = int(counts.max())
        xb = torch.zeros(e, m, h, dtype=x.dtype, device="cuda")

        def library():
            a = torch.bmm(xb, gu)
            act = torch.nn.functional.silu(a[..., :inter]) * a[..., inter:]
            return torch.bmm(act, dn)

        row = {"phase": "routed", "kernel": "moe_experts", "case":
               f"{case}: {n_tok} rows, {n_routes} live routes on {touched}"
               f" of {e} experts, block {bm}", "max_abs_err": err,
               "max_abs_plain": top, "route_weight_err": w_err,
               "ms": cuda_ms(torch, lambda: moe_experts(x, got, gu, dn)),
               "route_ms": cuda_ms(torch, lambda: route(*args)),
               "align_ms": cuda_ms(torch, lambda: align(got, bm)),
               "plain_ms": cuda_ms(torch, lambda: moe_experts_plain(
                   x, got, gu, dn), reps=3, warmup=1),
               **work, "library_ms": cuda_ms(torch, library),
               "library": f"torch.bmm over all {e} experts at {m} rows"}
        emit(row)
        rows_out.append(row)

    rows_n = ROUTED_DECODE_ROWS * ROUTED_PROMPT
    x = torch.randn(rows_n, h, generator=g, device="cuda").bfloat16()
    gain = (1 + scale * torch.randn(h, generator=g, device="cuda")).bfloat16()
    eps = t["rms_norm_eps"]
    got, want = rms_norm(x, gain, eps), rms_norm_plain(x, gain, eps)
    err, top = max_err(torch, got, want), float(want.float().abs().max())
    if err > ROUTED_RTOL * top:
        raise AssertionError(f"rms_norm: max|err| {err}")
    row = {"phase": "routed", "kernel": "rms_norm",
           "case": f"{rows_n} rows of {h}", "max_abs_err": err,
           "ms": cuda_ms(torch, lambda: rms_norm(x, gain, eps)),
           "plain_ms": cuda_ms(torch, lambda: rms_norm_plain(x, gain, eps)),
           **bound_of(2 * x.numel() * 2 + h * 2, 0.0),
           "library_ms": cuda_ms(torch, lambda: torch.nn.functional.rms_norm(
               x, (h,), gain, eps)),
           "library": "torch.nn.functional.rms_norm"}
    emit(row)
    rows_out.append(row)
    nh, nope = t["num_attention_heads"], t["qk_nope_head_dim"]
    r, d = t["kv_lora_rank"], t["qk_rope_head_dim"]
    q = torch.randn(ROUTED_DECODE_ROWS, ROUTED_PROMPT, nh, nope + d,
                    generator=g, device="cuda").bfloat16()
    ckv = torch.randn(ROUTED_DECODE_ROWS, ROUTED_PROMPT, r + d, generator=g,
                      device="cuda").bfloat16()
    ang = torch.rand(ROUTED_DECODE_ROWS, ROUTED_PROMPT, d // 2, generator=g,
                     device="cuda") * 6.28
    cos = torch.cat([ang.cos(), ang.cos()], -1)
    sin = torch.cat([ang.sin(), ang.sin()], -1)
    lw = gain[:r].contiguous()
    got = latent_rope(q, ckv, cos, sin, lw, 1e-6, nope)
    want = latent_rope_plain(q, ckv, cos, sin, lw, 1e-6, nope)
    err = max(max_err(torch, a, b) for a, b in zip(got, want))
    top = max(float(b.float().abs().max()) for b in want)
    if err > ROUTED_RTOL * top:
        raise AssertionError(f"latent_rope: max|err| {err}")
    moved = (q[..., nope:].numel() * 2 + ckv.numel() * 2 * 2
             + cos.numel() * 4 * 2 + sum(nbytes(a) for a in got[:1]))
    row = {"phase": "routed", "kernel": "latent_rope",
           "case": f"{ROUTED_DECODE_ROWS} x {ROUTED_PROMPT} positions, "
                   f"{nh} heads", "max_abs_err": err,
           "ms": cuda_ms(torch, lambda: latent_rope(q, ckv, cos, sin, lw,
                                                     1e-6, nope)),
           "plain_ms": cuda_ms(torch, lambda: latent_rope_plain(
               q, ckv, cos, sin, lw, 1e-6, nope)),
           **bound_of(moved, 0.0), "library_ms": None,
           "library": "none: no single call norms the latent and turns "
                      "both rope parts"}
    emit(row)
    rows_out.append(row)
    return rows_out


def routed_launch_check(torch, cfg, card) -> dict:
    """A transcribe_batch of the routed decoder at the published widths
    (ROUTED_LAYERS layers, weights as the benchmark draws them), the
    launch counters set to 0 just before it: per forward (the prefill,
    then each decode step, replayed or not) K7 4 per MoE layer (route,
    align, gate-up, down), K8 2 RMSNorms per layer and the final one, 1
    latent prologue per layer."""
    import copy

    import numpy as np

    sys.path.insert(0, str(REPO / "benchmark"))
    from harness.weights import make_weights

    from qwen3_asr_rs_tpu_torch.config import AsrConfig
    from qwen3_asr_rs_tpu_torch.ops.kernels.fused_elementwise import (
        latent_rope, rms_norm)
    from qwen3_asr_rs_tpu_torch.ops.kernels.moe_experts import moe_experts
    from qwen3_asr_rs_tpu_torch.runtime.engine import AsrEngine

    cfg = copy.deepcopy(cfg)
    cfg["num_hidden_layers"] = ROUTED_LAYERS
    t = _routed_text(cfg)
    layers = t["num_hidden_layers"]
    moe_layers = layers - t["first_k_dense_replace"]
    enc, dec = make_weights(cfg, 2 ** 31 + 7, "cuda",
                            REPO / "benchmark")
    engine = AsrEngine(None, config=AsrConfig.from_dict(cfg),
                       params=(enc, dec), tokenizer=StubTokenizer(),
                       device="cuda", dtype=torch.bfloat16,
                       max_new_tokens=32, kv_dtype="bf16")
    engine.warmup(batch_sizes=(ROUTED_DECODE_ROWS,), buckets=(30,))
    rng = np.random.default_rng(5)
    clips = [(0.1 * rng.standard_normal(int(16000 * s))).astype(np.float32)
             for s in np.clip(rng.lognormal(np.log(10), 0.5,
                                            ROUTED_DECODE_ROWS), 2, 30)]
    wrappers = {"moe_experts": moe_experts, "rms_norm": rms_norm,
                "latent_rope": latent_rope}
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    engine.transcribe_batch(clips)
    wall = time.perf_counter() - t0
    got = {n: fn.launches for n, fn in wrappers.items()}
    forwards = 1 + engine.last_stats["decode_steps"]
    want = {"moe_experts": 4 * moe_layers * forwards,
            "rms_norm": (2 * layers + 1) * forwards,
            "latent_rope": layers * forwards}
    row = {"phase": "routed", "kernel": "launches",
           "case": f"transcribe_batch of {ROUTED_DECODE_ROWS} clips, "
                   f"{layers} layers at the published widths",
           "forwards": forwards, "launches": got, "want": want,
           "experts_touched": engine.last_stats["experts_touched"][:4],
           "wall_s": wall}
    emit(row)
    check_launches("routed transcribe_batch", got, want)
    del engine, enc, dec
    torch.cuda.empty_cache()
    return row


def routed_phase(torch, card) -> dict:
    """Phase 13: K7 and K8 against their plain versions at the offline
    cell's shapes, and their launches in a transcribe_batch."""
    cfg = json.loads(ROUTED_CONFIG.read_text())
    rows = routed_kernel_checks(torch, cfg, card)
    launches = routed_launch_check(torch, cfg, card)
    return {"kernels": rows, "launches": launches}


def gemv_phase(torch, card) -> dict:
    """``--only gemv``: K1's bf16 GEMVs alone, both tensor-core routes at
    every weight kind and shape (gemv_kernel_checks, gemv_wgmma_checks),
    the two routes' times (gemv_wgmma_timing), then the engine's wgmma
    counter and tokens over two runs of a 32-clip batch at full 0.6B
    width (wgmma_engine_check)."""
    from qwen3_asr_rs_tpu_torch import AsrConfig
    from qwen3_asr_rs_tpu_torch.runtime.engine import load_audio
    from qwen3_asr_rs_tpu_torch.weights.convert import (
        init_decoder_params_np, init_encoder_params_np, to_torch)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    results = []
    gemv_kernel_checks(torch, gen, results)
    gemv_wgmma_checks(torch, gen, results)
    timing = gemv_wgmma_timing(
        torch, torch.Generator(device="cuda").manual_seed(23), card)
    config = AsrConfig()
    enc32 = to_torch(init_encoder_params_np(config.audio), torch.float32,
                     "cuda")
    dec32 = to_torch(init_decoder_params_np(config.text), torch.float32,
                     "cuda")
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_gemv_"))
    audio = {}
    for seconds, seed in ((4, 1), (8, 4), (15, 5), (22, 6), (30, 2)):
        write_wav(tmp / f"clip_{seconds}s.wav", seconds, seed)
        audio[seconds] = load_audio(tmp / f"clip_{seconds}s.wav", 16000)
    engine = wgmma_engine_check(torch, config, enc32, dec32, audio, card)
    return {"checks": len(results), "timing": timing, "engine": engine}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (REPO / "qwen3_asr_rs_tpu_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(qwen3_asr_rs_tpu_torch/ not found)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    emit({"phase": "device", "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})

    # 2. build
    from qwen3_asr_rs_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    per_kernel = _build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "compiled": per_kernel,
          "tensor_core_sass": {n: tensor_core_sass(_build, n)
                               for n in TENSOR_CORE_LIBS},
          "spills": ptxas_spills(_build),
          "gemv_wgmma_sass": wgmma_sass(_build),
          "ptxas": {n: [ln.strip() for ln in
                        (_build.BUILD_DIR / f"{n}.log").read_text().splitlines()
                        if "registers" in ln or "spill" in ln][:12]
                    for n in _build.KERNEL_SOURCES
                    if (_build.BUILD_DIR / f"{n}.log").exists()}})

    if sys.argv[1:] == ["--only", "gemv"]:
        emit({"phase": "gemv", "summary": gemv_phase(torch, card)})
        print(card, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0

    if sys.argv[1:] == ["--only", "routed"]:
        emit({"phase": "routed", "summary": routed_phase(torch, card)})
        print(card, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0

    # weights: full 0.6B width, the JAX package's seeds and RNG order
    from qwen3_asr_rs_tpu_torch import AsrConfig
    from qwen3_asr_rs_tpu_torch.weights.convert import (
        init_decoder_params_np, init_encoder_params_np, to_torch)

    config = AsrConfig()  # Qwen3-ASR-0.6B dims
    t0 = time.perf_counter()
    enc_np = init_encoder_params_np(config.audio)
    dec_np = init_decoder_params_np(config.text)
    enc32 = to_torch(enc_np, torch.float32, "cuda")
    dec32 = to_torch(dec_np, torch.float32, "cuda")
    del enc_np, dec_np
    emit({"phase": "weights", "seconds": time.perf_counter() - t0})

    # the clips of phases 4-10
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    clips = {}
    for seconds, seed in ((4, 1), (30, 2), (300, 3), (8, 4), (15, 5),
                          (22, 6)):
        path = tmp / f"clip_{seconds}s.wav"
        write_wav(path, seconds, seed)
        clips[seconds] = path
    from qwen3_asr_rs_tpu_torch.runtime.engine import AsrEngine, load_audio

    audio = {c: load_audio(path, 16000) for c, path in clips.items()}
    launches = {}  # {path: {kernel: launches in that path's run}}
    per_30s = {}   # {path: {kernel: launches for its 30 s clip}}

    # 3. kernels
    kernel_rows = kernel_checks(torch, dec32)
    yardstick = gemv_yardstick(torch, dec32)
    emit({"phase": "kernel", "kernel": "gemv_yardstick",
          "case": "one 0.6B layer's 7 products as torch.mm, bf16",
          **yardstick})
    gemv_wgmma_timing(torch, torch.Generator(device="cuda").manual_seed(23),
                      card)
    fns = kernel_wrappers()
    k6_launches = {n: fns[n].launches
                   for n in ("decode_attention_slab", "decode_attention")}

    # 4. main path: bf16 weights, then int8 and int4 weights
    for label, quantize, env, seconds in MAIN_PATHS:
        with Env(env):  # read when the engine is built and at each step
            engine = AsrEngine(None, dtype=torch.bfloat16, max_new_tokens=128,
                               config=config, params=(enc32, dec32),
                               tokenizer=StubTokenizer(), device="cuda",
                               quantize=quantize)
            with lm_head_counter(engine) as lm:
                launches[label], per_clip = run_path(
                    torch, engine, lm, {c: clips[c] for c in seconds}, label,
                    quantize, env, card)
        if 30 in per_clip:
            per_30s[label] = per_clip[30]
        del engine
        torch.cuda.empty_cache()

    # 5. batch: bf16 and int8 KV with bf16 weights, then int8 weights with
    # int8 KV and int4 weights with bf16 KV
    for kv_dtype, quantize in dict.fromkeys(r[2:4] for r in BATCH_RUNS):
        engine = AsrEngine(None, dtype=torch.bfloat16, max_new_tokens=128,
                           config=config, params=(enc32, dec32),
                           tokenizer=StubTokenizer(), device="cuda",
                           kv_dtype=kv_dtype, quantize=quantize)
        with lm_head_counter(engine) as lm:
            for label, seconds, kv, quant, env in BATCH_RUNS:
                if (kv, quant) != (kv_dtype, quantize):
                    continue
                name = (f"batch {label}"
                        + (f" {quantize} weights" if quantize else "")
                        + (" int8 KV" if kv else "")
                        + (" fold" if env.get("ASR_FOLD_LM") else ""))
                launches[name] = run_batch(
                    torch, engine, lm, [audio[c] for c in seconds], label,
                    seconds, kv, quantize, env, card)
        del engine
        torch.cuda.empty_cache()

    wgmma_engine_check(torch, config, enc32, dec32, audio, card)

    # 6. parity: float32 teacher forcing, kernel path vs plain path
    for quantize in (None, "int8", "int4", "int4g"):
        parity(torch, AsrEngine(None, dtype=torch.float32, max_new_tokens=128,
                                config=config, params=(enc32, dec32),
                                tokenizer=StubTokenizer(), device="cuda",
                                quantize=quantize), clips[4], quantize)
        torch.cuda.empty_cache()
    for kv_dtype in (None, "int8"):
        batch_parity(torch, AsrEngine(None, dtype=torch.float32,
                                      max_new_tokens=128, config=config,
                                      params=(enc32, dec32),
                                      tokenizer=StubTokenizer(),
                                      device="cuda", kv_dtype=kv_dtype),
                     [audio[c] for c in (4, 8, 15)], kv_dtype)
        torch.cuda.empty_cache()

    # 7. graphs: the decode loop's CUDA graphs, sampling, segments, long form
    launches.update(graph_phase(torch, config, enc32, dec32, audio, tmp,
                                card))

    # 8. serving: the continuous batcher and the HTTP server
    serving_launches, serving_per_step = serving_phase(
        torch, config, enc32, dec32, audio, tmp, card)
    launches.update(serving_launches)

    # 9. streaming: sessions over the 30 s clip, a rollover, float32
    stream_launches, per_update = streaming_phase(torch, config, enc32,
                                                  dec32, audio, card)
    launches.update(stream_launches)

    # 10. speculative decoding: drafts on 0.6B, a 1.7B target
    spec_launches, per_iteration = speculative_phase(torch, config, enc32,
                                                     dec32, audio, card)
    launches.update(spec_launches)

    # 11. training: full-width steps, remat, card = CPU, bf16, checkpoint,
    # export then serve, forward_full on a quantized tree
    launches.update(training_phase(torch, config, enc32, dec32, clips[4],
                                   tmp, card))

    # 12. parallel: a 1 x 1 NCCL mesh here, then two ranks sharing the
    # card over gloo (dp = 2, tp = 2, mesh serving, sharded train steps)
    launches.update(parallel_phase(torch, config, enc32, dec32, audio,
                                   clips, tmp, card))

    # 13. routed: K7 and K8 at the offline MoE cell's shapes, and their
    # launches in a transcribe_batch of the routed decoder
    del enc32, dec32
    torch.cuda.empty_cache()
    routed = routed_phase(torch, card)

    summary = []
    for name in SOURCES:
        # K6's row covers its two entries, the draw kernel's its noise entry
        names = {"decode_attention_slab": (name, "decode_attention"),
                 "gumbel_argmax": (name, "threefry_noise")}.get(name, (name,))
        rows = [r for r in kernel_rows if r["kernel"] in names
                and (r["dtype"].startswith("bfloat16")
                     or name == "gumbel_argmax")]
        head = next((r for r in rows if r.get("headline")), rows[0])
        by_path = {p: sum(c[n] for n in names) for p, c in launches.items()
                   if any(c[n] for n in names)}
        row = {
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "launches_per_30s_clip": {p: sum(c[n] for n in names)
                                      for p, c in per_30s.items()},
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head.get("library_ms"),
            "library": LIBRARY[name],
            **({"device_ms": head["device_ms"],
                "library_device_ms": head.get("library_device_ms")}
               if "device_ms" in head else {}),
            "case": head["case"],
        }
        if name == "decode_layers_fused":
            row["covers"] = K1_COVERS
            row["gemv_yardstick_per_layer"] = yardstick
            row["kernels_per_call"] = {r["case"]: r["launches_per_call"]
                                       for r in kernel_rows
                                       if r["kernel"] == "k1_launches"}
        if name == "flash_attention":
            row["main_path"] = {
                r["case"]: {k: r.get(k) for k in (
                    "ms", "bound_ms", "bound_by", "device_ms", "library_ms",
                    "library_device_ms")}
                for r in rows if r["case"].startswith(K3_MAIN_PATH)}
        if name == "quant_matmul":
            row.update(k5_summary(rows))
        if name == "gumbel_argmax":  # float32 logits on every path
            row["launches_by_entry"] = {
                n: sum(c[n] for c in launches.values()) for n in names}
            row["ms_by_case"] = {r["case"]: {
                k: r[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms")}
                for r in rows}
        if name in serving_per_step:
            row["launches_per_serving_step"] = serving_per_step[name]
        row["launches_per_stream_update"] = {
            r: sum(per_update[n][r] for n in names) for r in per_update[name]}
        row["launches_per_spec_iteration"] = {
            r: sum(per_iteration[n][r] for n in names)
            for r in per_iteration[name]}
        if name == "decode_attention_slab":
            row["callers"] = K6_CALLERS
            row["launches"] = sum(k6_launches.values())
            row["launches_by_entry"] = k6_launches
            if by_path:
                raise AssertionError(f"K6 launched on a main path: {by_path}")
        elif not row["launches"] > 0:
            raise AssertionError(f"kernel {name} never launched on a main path")
        summary.append(row)
    emit({"phase": "profiler", "windows": PROFILER_WINDOWS})
    emit({"kernels": summary, "routed": routed})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
