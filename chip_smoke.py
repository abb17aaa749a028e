#!/usr/bin/env python3
"""Drives the PyTorch/CUDA package on one NVIDIA Hopper GPU, end to end.

Run from the repository root: ``python3 chip_smoke.py`` (no arguments, one
GPU, no network). It builds the CUDA kernels from ``csrc/`` with ``nvcc``,
holds each against its plain PyTorch version on the GPU, serves the
``tts-1b`` audio LM at its full width (seeded random weights) through the
``Orchestrator`` with more requests than slots, shows with the wrappers'
launch counts that the serving run went through both kernels, compares the
kernel path with the plain path inside the model, and makes one HTTP round
trip. Then it drives the TTS back end at its full width (S2A sampler, RVQ,
Vocos/ISTFT; seeded random weights) through ``TTSPipeline.s2a_vocoder_batch``
for 8 requests, served as ``int8_offline`` and as ``bfloat16``, checks the
launch counts of the four row kernels against what the code predicts, and
compares the kernel path with the plain path inside the denoiser and the
sampler. Last it drives the whole zero-shot pipeline at its full width (the
semantic tokenizer and codec encoder of the prompt, the LM, the S2A sampler,
the vocoder): ``TTSPipeline.synthesize`` for one request, whose fixed-length
sampler runs the S2A attention kernel, compares that kernel and the prompt
tokenizers (card against CPU) with their plain routes, and serves 8
concurrent ``POST /tts`` requests through ``make_server``. Then it trains:
the ``tts-1b`` recipe at full width (4 x 2048 tokens a step, bf16 weights,
``attention=flash``, remat ``save_attn_and_mlp``) for a few steps through
the training entry point, shows with the launch counts that every step ran
the flash-attention kernels K9-K11 as often as the code predicts, and holds
one 2-layer float32 step's loss and gradients through the kernels against the
plain route. Last it serves the ``tts-1b`` audio LM again with a PAGED KV
cache (``paged_attention=true``: 128-row pages, a 32,768-token context, a
97-page pool) through the ``Orchestrator``, whose page reservations hold
requests back, shows with the launch counts that every decode step ran the
paged kernel K4 once a layer (and K1, K2 never), that every page came back,
and holds K4 inside the model against its plain version and the paged
streams against the dense ones. Then weights go out and in at full width, in a
temporary directory removed at the end: ``lm_ckpt`` exports the served
``tts-1b`` with HF names, converts it back with the converter CLI and serves
the same 80 requests from ``Engine.load_params`` (the same greedy streams);
``audio_ckpt`` writes the pipeline's audio weights as the reference's files and
loads them into a pipeline built from another seed (the same prompt ids, codes
and waveform); ``audio_cli`` runs the audio CLI in subprocesses on those files;
``train_resume`` trains with asynchronous checkpoints, runs step 3 before the
write is waited for, and resumes a fresh state to the same step 3, bitwise.
Then the training data paths and the S2A trainer: ``train_packed`` trains the
``tts-1b`` recipe on packed ``emilia_audio`` rows and evaluates on the emilia
eval stream (K9-K11 on real segment ids, the iterator's host time, documents
a row), ``train_packed_parity`` holds one packed float32 step through the
kernels against the plain versions, ``train_c4`` trains on ``c4_mlperf`` over
a file this script writes, ``s2a_train`` trains the S2A at its published
widths (K5 through its autograd Function) on the materialised attention and
on the sequence-flash route (K9-K11 non-causal), ``s2a_train_parity`` holds a
2-layer float32 step of each route against the plain versions and the two
routes against each other, and ``s2a_seq_flash_serving`` holds an
``int8_offline`` denoiser forward on the sequence-flash route against the
materialised one and reads the device time of each. Last the flagship
(``tts-flagship``: 48 layers, E 3840, head dim 256, a 264,192-row tied
vocabulary, 11.77 B parameters in bfloat16): ``flagship_serve`` serves it
whole (8 slots of a 4096-token cache, 8 greedy requests of up to 1536 prompt
tokens through the ``Orchestrator``, then one ``synthesize`` with it as the
pipeline's LM), ``flagship_serve_parity`` holds one of its decode steps
against the plain route, ``train_flagship_vocab`` trains the repo's
flagship-vocab recipe (the tts-1b body at the 264,192-row vocabulary, the
vocabulary-fused chunked CE, then its int8 variant), ``train_flagship_vocab_
parity`` holds each fused CE variant against the materialised CE (loss,
gradients, peak memory), and ``train_flagship`` trains the flagship at full
width and 4 layers (K9-K11 at head dim 256). Training with MLP dropout:
``train_dropout`` trains the ``tts-1b`` recipe with ``dropout_rate=0.1``
(K9-K11 launches as predicted, step seconds against ``train``'s) and
``train_dropout_parity`` holds one 2-layer float32 step with one set of masks
on the kernel route against the plain route and under remat against none.
The codec trainers: ``codec_train`` trains the acoustic codec at its
published widths with quantizer dropout and one re-seed of dead codes,
``codec_train_repcodec`` the RepCodec, and ``codec_train_parity`` holds one
codec step and an EMA codebook's training calls on the card against the CPU.
The decode extras: ``serve`` and ``serve_paged`` decode through captured CUDA
graphs (one replay a dispatch, the wrappers' launch counts added once a
replay); ``serve_captured_parity`` holds captured against eager streams
(greedy, dense and paged; weighted sampling from one seed) and reads each
route's step with ``tools/profile_decode``; ``generate_stream_http`` holds
ndjson ``/generate_stream`` tokens against ``/generate``'s;
``serve_paged_short_pool`` makes admission control hold requests back on a
small pool; ``chunked_prefill`` holds a chunked prefill, the prefix cache and
decode recovery to the uninterrupted streams; ``spec_decode`` holds
speculative streams (K2 at span K+1 on the verify pass) to the target's
greedy streams; ``bucketed_decode`` holds bucketed decode attention to the
``dot_product`` route. ROADMAP item 5.6: ``serve_int8w`` serves ``tts-1b``
with ``int8w_serve`` weights (int8w_matmul on every captured decode step,
dense and paged; parameter bytes against the reckoning; the int8 streams
against the int8 forward, the bfloat16 streams and a quantized checkpoint
written by ``tools/quantize_checkpoint.py`` and read back),
``flagship_serve_int8w`` quantizes the served flagship's weights on the card
and times a captured dispatch, ``train_int8`` trains the flagship-vocab
recipe with its ``quantization=int8`` and the ``tts-1b`` recipe at int8 and
fp8 (the AQT matmuls), ``train_int8_parity`` holds an int8 step on the card
against the CPU, ``train_lora`` trains rank-16 adapters alone (every other
weight bitwise unchanged) and ``lora_merge`` holds a merged adapter's streams
against the unmerged adapter's. ROADMAP items 5.7, 5.9, 5.11 and 5.12 on the
serve engine: ``serve_scanned`` serves its weights written stacked and loaded
by a ``serve_unroll_layers=false`` engine, ``serve_disaggregated`` serves its
requests with a prefill thread beside interleaved mode (tokens/s, time to
first token), ``offline_engine``, ``loadgen_offline`` and ``loadgen_server``
drive the offline engine and the load generator's two scenarios,
``microbenchmark`` prints ``run_microbenchmark``'s document; after
``tts_http``, ``uniserver`` serves /tts, /generate and /generate_stream from
the single-threaded UniServer over the full-width pipeline; each stream
comparison is exact, against the serve engine's streams of the same
admission. ``train_int8_parity`` also counts the int8 codes that differ card
against CPU, layer by layer, and feeds the card's layer-0 output to the CPU
step. ``device`` reports whether ``grpc`` and ``google.protobuf`` import.
ROADMAP 5.10 and item 6's serving part: ``grpc`` streams 8 ``Decode`` calls
over the serve engine against ``/generate``, ``grpc_synthesize`` one
``Synthesize`` against ``synthesize``; last, ``moe_serve`` serves
``qwen3-30b-a3b`` whole through the grouped kernel (decode captured),
``moe_serve_parity`` holds its sparse route against the dense one,
``moe_serve_int8w`` serves it with int8 experts, then ``mixtral_serve``,
``mla_serve`` (``deepseek-v2-lite`` whole), ``gpt3_serve`` (``gpt3-6b``
whole) and ``llama4_serve`` (a float32 twin for its teacher-forced check). The
grouped backward kernels are persistent, TMA-fed ``wgmma`` kernels; float32
experts run the float32 grouped kernels, whose main path is
``moe_train_parity``'s float32 sparse step, held against the dense route; the
flash kernels are checked at GQA groups 5, 6 and 16 too. The bf16 grouped
forward runs the persistent ``wgmma`` kernel where the groups hold many rows
(its cases at ``moe_train``'s and ``deepseek_train``'s training shapes, which
are main paths of the forward too) and a weight stream split over a cluster
where they hold few; ``int8w_matmul`` is one launch with its split-K sum in a
cluster's shared memory; every grouped and ``int8w_matmul`` case launches
twice and wants the same bits. The int8 grouped kernel (``moe_serve_int8w``)
streams raw int8 weights, each lane transposing its own ``mma.sync`` s8
fragments: a weight stream split over a cluster at decode, a persistent
kernel of 64-row tiles at prefill; the float32 grouped kernels are
register-tiled GEMMs on the CUDA cores; ``moe_serve_int8w`` reports its
captured step's device-busy time beside ``moe_serve``'s. Last, parallelism
on ``torch.distributed`` with ranks spawned after the build that share the
card over gloo (``tools/parallel_phases.py``), each held to one rank on the
same data: ``parallel_fsdp_train`` (FSDP, 2 ranks, the ``tts-1b`` recipe),
``parallel_zero1``, ``ring_attention`` (ring, all-gather and Ulysses context
parallelism through K9-K11 at 16,384 tokens, the ring at cp 4 too, and a ring
training step), ``pipeline_train`` and ``elastic_train_resize`` (2 ranks to
1); then on one rank ``dpo_train``, ``grpo_train`` (completions through the
captured engine), ``distillation`` (its JSONL read by SFT) and
``elastic_train`` (a failure recovered from a snapshot). ROADMAP item 6b,
the splits inside the layers (``parallel/tensor.py``), ranks sharing the card
as above, each held to one rank: ``tp_serve`` and ``tp_serve_paged`` serve
``tts-1b`` whole over ``tensor`` 2 (K1 / K2 or K4 at a rank's 8 query / 4 kv
heads), ``tp_serve_int8w`` with ``int8w_serve`` weights (``int8w_matmul`` at
a rank's columns and rows), ``ar_context_serve`` over ``context_autoregressive`` 2 (each rank
half the cache's rows, K2 on the owner), ``ep_serve`` and ``ep_train``
``qwen3-30b-a3b`` at full width and 2 layers over ``expert`` 2 (the grouped
kernels at a rank's 64 experts, forward and backward), ``tp_train`` the
``tts-1b`` recipe at 4 layers over ``fsdp`` 2 x ``tensor`` 2 on four ranks
(K9-K11 at a rank's heads). The
kernels line lists, for each kernel, the case of every main path that ran it.
Every phase prints
one JSON object on a line; the last line is
``{"ok": true, "device": {...}}``. Any failed phase ends the run with a
non-zero exit code, and so does a machine without a GPU: nothing here falls
back to the CPU.
"""

from __future__ import annotations

import base64
import contextlib
import dataclasses
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
TTS_1B = os.path.join(REPO, "maxtext_indextts2_tpu_torch", "configs", "models", "tts-1b.yml")
SERVE_ARGS = [
    TTS_1B, "decode_attention=ragged", "serve_params_dtype=bfloat16",
    "decode_sampling_strategy=greedy", "max_prefill_predict_length=512",
    "per_device_batch_size=32", "scan_layers=false",
]
STEPS_PER_DISPATCH = 4
NUM_REQUESTS = 80
# Paged serving: the same model and traffic with a paged KV cache: 128-row
# pages, a 32,768-token context (a dense cache of it for 32 slots would not
# fit the card), 96 usable pages (fewer than 32 slots x 5 worst-case pages).
PAGED_ARGS = SERVE_ARGS + ["paged_attention=true", "pagedattn_tokens_per_page=128",
                           "max_target_length=32768", "pagedattn_num_pages=97"]

# File and line of the TPU kernel each CUDA kernel replaces (JAX package).
KERNELS = [
    dict(name="ragged_decode_attention", route="cuda",
         source="maxtext_indextts2_tpu_torch/csrc/ragged_decode_attention.cuh",
         replaces="maxtext_indextts2_tpu/ops/ragged_decode_attention.py:373"),
    dict(name="paged_decode_attention", route="cuda",
         source="maxtext_indextts2_tpu_torch/csrc/paged_decode_attention.cuh",
         replaces="maxtext_indextts2_tpu/ops/ragged_decode_attention.py:581"),
    dict(name="inplace_row_update", route="cuda",
         source="maxtext_indextts2_tpu_torch/csrc/inplace_update.cu",
         replaces="maxtext_indextts2_tpu/ops/inplace_update.py:30"),
    dict(name="ada_rmsnorm", route="cuda",
         source="maxtext_indextts2_tpu_torch/csrc/row_kernels.cuh",
         replaces="maxtext_indextts2_tpu/ops/ada_rmsnorm.py:57"),
    dict(name="row_quantize_int8", route="cuda",
         source="maxtext_indextts2_tpu_torch/csrc/row_kernels.cuh",
         replaces="maxtext_indextts2_tpu/ops/quant_kernels.py:52"),
    dict(name="ada_rmsnorm_quantize", route="cuda",
         source="maxtext_indextts2_tpu_torch/csrc/row_kernels.cuh",
         replaces="maxtext_indextts2_tpu/ops/quant_kernels.py:98"),
    dict(name="silu_mul_quantize", route="cuda",
         source="maxtext_indextts2_tpu_torch/csrc/row_kernels.cuh",
         replaces="maxtext_indextts2_tpu/ops/quant_kernels.py:140"),
    dict(name="s2a_attention", route="cuda",
         source="maxtext_indextts2_tpu_torch/csrc/s2a_attention.cu",
         replaces="maxtext_indextts2_tpu/ops/s2a_attention.py:81"),
    dict(name="flash_fwd", route="cuda",
         source="maxtext_indextts2_tpu_torch/csrc/flash_attention.cuh",
         replaces="maxtext_indextts2_tpu/ops/flash_attention.py:165"),
    dict(name="flash_bwd_dq", route="cuda",
         source="maxtext_indextts2_tpu_torch/csrc/flash_attention.cuh",
         replaces="maxtext_indextts2_tpu/ops/flash_attention.py:392"),
    dict(name="flash_bwd_dkv", route="cuda",
         source="maxtext_indextts2_tpu_torch/csrc/flash_attention.cuh",
         replaces="maxtext_indextts2_tpu/ops/flash_attention.py:426"),
    # no Pallas site: the dequantise-and-dot XLA fuses in DenseGeneral._serve_quantized
    dict(name="int8w_matmul", route="cuda",
         source="maxtext_indextts2_tpu_torch/csrc/int8w_matmul.cu",
         replaces="maxtext_indextts2_tpu/models/layers.py:168"),
    # no Pallas site: the ragged_dot calls XLA lowers in RoutedMoE._sparse_experts
    dict(name="grouped_matmul_bf16", route="cuda",
         source="maxtext_indextts2_tpu_torch/csrc/grouped_matmul.cu",
         replaces="maxtext_indextts2_tpu/models/moe.py:268"),
    dict(name="grouped_matmul_int8", route="cuda",
         source="maxtext_indextts2_tpu_torch/csrc/grouped_matmul.cu",
         replaces="maxtext_indextts2_tpu/models/moe.py:252"),
    # no Pallas site: the transpose of those ragged_dot calls, which XLA
    # derives for the MoE training step
    dict(name="grouped_matmul_dgrad", route="cuda",
         source="maxtext_indextts2_tpu_torch/csrc/grouped_wgmma.cuh",
         replaces="maxtext_indextts2_tpu/models/moe.py:268"),
    dict(name="grouped_matmul_wgrad", route="cuda",
         source="maxtext_indextts2_tpu_torch/csrc/grouped_matmul_bwd.cu",
         replaces="maxtext_indextts2_tpu/models/moe.py:268"),
    # no Pallas site: ragged_dot and its transpose on float32 experts
    dict(name="grouped_matmul_f32", route="cuda",
         source="maxtext_indextts2_tpu_torch/csrc/grouped_matmul_f32.cu",
         replaces="maxtext_indextts2_tpu/models/moe.py:268"),
    dict(name="grouped_matmul_f32_dgrad", route="cuda",
         source="maxtext_indextts2_tpu_torch/csrc/grouped_matmul_f32.cu",
         replaces="maxtext_indextts2_tpu/models/moe.py:268"),
    dict(name="grouped_matmul_f32_wgrad", route="cuda",
         source="maxtext_indextts2_tpu_torch/csrc/grouped_matmul_f32.cu",
         replaces="maxtext_indextts2_tpu/models/moe.py:268"),
]

# One decode step through the kernels against one through their plain
# versions, bfloat16 model, 20 layers: the attention outputs differ by at most
# one bfloat16 step (other summation order), which the layers above carry to
# logits of magnitude ~4 as a few bfloat16 steps (2**-6 each there).
TOL_PARITY_BF16_LOGITS = 0.125

# The TTS back end: 8 requests, prompts of 100-250 frames (padded to 256),
# targets of 200-500 frames (bucketed to 512), the config's sampler schedule.
BACKEND_REQUESTS = 8
BACKEND_SHAPE = (8, 256, 512)  # rows, prompt bucket, target bucket
# the bfloat16 serving mode runs float32 products: two steps per quantizer there
BF16_TIMESTEPS = (2,) * 12

# One full-width denoiser forward through the row kernels against one through
# their plain versions, same weights and inputs, outputs of magnitude ~4.
# int8_offline (bfloat16 residual stream): the kernels sum the squares in
# another order, which can move a row's bfloat16 rsqrt factor or an int8 code
# by one step; 16 layers may carry that to a few bfloat16 steps (2**-5 each
# at that magnitude: 4 steps at most, and 0.005 on average). bfloat16 mode
# (float32 stream, bfloat16 attention):
# float32 last-bit differences that the bfloat16 rounding of a logit can lift
# to 2**-8 of it.
TOL_BACKEND_INT8_MAX, TOL_BACKEND_INT8_MEAN = 0.125, 0.005
TOL_BACKEND_BF16_MODE = 2e-2
# AdaptiveRMSNorm alone, kernels against plain versions, |y| <= ~8: one
# bfloat16 step there where a row's rsqrt factor straddles a rounding boundary
# (float32 rows differ by a few float32 steps only).
TOL_NORM_MODULE = 2.0 ** -5
# The 2-layer float32 sampler, kernels against plain versions, the same
# injected noise: a float32 last-bit difference flips an argmax only when two
# candidates tie to ~1e-6, so nearly every code is equal; where all are, the
# waveforms agree to 1e-3 of the largest sample (both take the same vocoder path).
MIN_BACKEND_F32_CODE_AGREEMENT = 0.995
TOL_BACKEND_F32_WAV = 1e-3

# The whole pipeline: `synthesize` with a 3-s prompt and 256 target frames;
# /tts with 8 concurrent requests, prompts of 3-6 s, texts of 40-160 bytes,
# 200-500 frames each (force_frames), one batch.
SYNTH_PROMPT_SECONDS, SYNTH_FRAMES = 3.0, 256
HTTP_REQUESTS = 8
# K12 against its plain version inside one full-width conditional forward of
# the fixed-length sampler (`all_valid`, [1, P + T, 1024], 16 layers).
# (a) Every K12 call of the kernel route against the plain version on the
# same q, k, v (the model's own tensors): K12's case tolerances, one bfloat16
# step at |o| <= 2 and float32 summation order.
TOL_K12_IN_MODEL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
# (b) The forward's output, kernel route against plain route. float32: the
# layers carry K12's last-bit differences on, atol 1e-3 at |y| ~5.
# int8_offline (the served model): where the routes' attention outputs differ
# by one bfloat16 step, the next int8 product's row scale or codes can move by
# one step, and 16 layers of random weights spread that over every row: the
# routes then differ like two int8 roundings of one forward (measured on an
# H100: max 0.21, mean 0.034 at |y| ~5). Bound: max 0.5, mean 0.05; a wrong
# attention moves the mean by the outputs' own scale (~1).
TOL_SYNTH_INT8_MAX, TOL_SYNTH_INT8_MEAN = 0.5, 0.05
TOL_SYNTH_F32 = 1e-3
# The prompt's ids on the card against the same module on the CPU (float32,
# TF32 off on the card): a float32 last-bit difference flips an argmax only
# between near-equal candidates, and a flipped RVQ stage changes the stages
# after it at that frame: at least 0.9 of the ids equal.
MIN_FRONTEND_ID_AGREEMENT = 0.9

# Training: the JAX package's committed 1B recipe (configs/perf/v5e/tts_1b.sh)
# without its TPU tiling flash_block_sizes, through the training entry point.
TRAIN_STEPS = 5
TRAIN_ARGS = [
    TTS_1B, "dataset_type=synthetic", "per_device_batch_size=4",
    "remat_policy=save_attn_and_mlp", "attention=flash", "weight_dtype=bfloat16",
    "scan_layers=false", "cast_logits_to_fp32=false", f"steps={TRAIN_STEPS}",
]
# Launches a step, read from the code before the first run (PERF.md): every
# layer's attention region is recomputed in the backward (no remat anchor
# holds the flash kernel's residuals), so K9 runs twice a layer; K10 and K11
# once a layer.
TRAIN_LAUNCHES_PER_LAYER = {"flash_fwd": 2, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
TRAIN_MAX_PEAK_BYTES = 40e9
# One 2-layer float32 step at full width, kernel route against plain route, the
# same weights and batch (TF32 off). Both routes run the same float32
# arithmetic; only the attention's sums run in another order (~1e-6 relative
# of each row), which the softmax backward and two layers carry to ~1e-5 of a
# gradient: the loss within 1e-4 (values ~9), the global grad norm within
# 1e-4 relative, every gradient within 1e-3 of its own largest entry. A wrong
# mask, scale or group sum moves them by their own size.
TOL_TRAIN_LOSS, TOL_TRAIN_GRAD_NORM_REL, TOL_TRAIN_GRAD_REL = 1e-4, 1e-4, 1e-3

# Training on real data paths. train_packed: the train recipe on
# dataset_type=emilia_audio (synthetic text + audio documents, packed first-fit
# by PackedBatcher into 2048-token rows with restarted positions and a
# segment-0 tail), then the emilia eval iterator through run_eval. Launches a
# step as train's; the eval forwards run K9 once a layer a batch.
TRAIN_PACKED_ARGS = [a for a in TRAIN_ARGS if a != "dataset_type=synthetic"] + [
    "dataset_type=emilia_audio", "packing=true", "eval_interval=5", "eval_steps=2"]
HOST_BATCHES_TIMED = 10
# train_c4: c4_mlperf over a .jsonl this phase writes, byte tokenizer; the
# data path, not the kernels, is what it proves: depth cut to 2 layers.
TRAIN_C4_STEPS, TRAIN_C4_LAYERS = 2, 2
# s2a_train: the S2A at the published MaskGCT widths (config defaults: hidden
# 1024, 16 layers, 16 heads of 64, 12 quantizers, codebook 1024, condition
# codebook 8192), bfloat16 compute with float32 parameters and AdamW moments,
# clipping at 1.0, synthetic_s2a_batch at 8 x 512 frames, 5 steps; once on the
# materialised attention, once with MTT_S2A_SEQ_FLASH=1. Launches a forward:
# K5 33 (two norms a layer and the final one; its backward is plain PyTorch),
# on the flash route K9, K10 and K11 once a layer.
S2A_TRAIN_STEPS = 5
S2A_TRAIN_ARGS = ["dataset_type=synthetic", "dtype=bfloat16", "per_device_batch_size=8",
                  "max_target_length=512", f"steps={S2A_TRAIN_STEPS}",
                  "gradient_clipping_threshold=1.0"]
# the float32 model trained here; served as int8_offline it has 353,652,736
# (the 212,992 per-channel scales of its int8 products besides)
S2A_PARAMS = 353_439_744
S2A_MAX_PEAK_BYTES = 40e9
# s2a_train_parity: 2 float32 layers at full width, one batch (two rows with
# padding tails) and one set of draws, kernel route against plain route on
# both attention routes; the bounds of train_parity (the same float32
# arithmetic, sums in other orders), and the two routes' losses within the
# same 1e-4: they read valid rows only.
S2A_PARITY_PAD = (100, 37)
# s2a_seq_flash_serving: one int8_offline denoiser forward [8, 768, 1024] of
# the masked serving pass (prompts padded to 256, targets to 512), the
# materialised route against MTT_S2A_SEQ_FLASH=1. The routes round at other
# points: the materialised one stores the logits and probabilities in
# bfloat16, the flash one keeps the logits in float32; each layer's int8
# products re-quantize the difference and 16 layers of random weights spread
# it. On the CPU (plain versions, same weights and inputs) the valid rows
# differ by max 0.297, mean 0.0386 at mean |y| 0.80; the flash route with the
# pad mask ignored gives max 0.80, mean 0.109. Bound: max 0.6, mean 0.06.
TOL_SEQ_FLASH_SERVING_MAX, TOL_SEQ_FLASH_SERVING_MEAN = 0.6, 0.06

# Codec training. codec_train: codec_train.main with codec_target=acoustic and
# no device: AcousticCodec() at its published widths, float32, quantizer
# dropout 0.5 (the first 8 of 16 rows keep a drawn number of stages), 16 rows of
# 0.5 s at 24 kHz (12,000 samples, 25 frames) a step, 25 steps, dead codes
# re-seeded once, after step 20. Convolutions, FFTs and products run through
# cuDNN, cuFFT and cuBLAS: no kernel of the repository is on this path, every
# launch count 0. codec_train_repcodec: RepCodec(hidden 1024, codebook 8192, 4
# Vocos layers a side) as the JAX trainer builds it, 16 x 64 frames, 10 steps.
CODEC_TRAIN_STEPS = 25
CODEC_TRAIN_ARGS = ["per_device_batch_size=16", "codec_quantizer_dropout=0.5", "dtype=float32"]
CODEC_PARAMS = 107_745_346
REPCODEC_TRAIN_STEPS = 10
REPCODEC_TRAIN_PARAMS = 19_016_456
CODEC_MAX_PEAK_BYTES = 40e9
# codec_train_parity: one step of the codec at full width cut to 2 Vocos
# layers, 4 rows, float32, one set of weights, batch and quantizer-dropout
# draw, on the card and on the CPU (TF32 off: the same float32 arithmetic,
# cuDNN's and oneDNN's convolution algorithms and the FFTs summing in other
# orders, ~1e-6 relative a layer). The whole step from the waveform flipped 1
# of 1,200 RVQ indices (a near tie after the encoder's ~40 layers, measured on
# one H100), so the step is compared in stages, each stage fed the card's
# input: the encoder's latents within 1e-4 of their largest entry; the
# quantizer, decoder and loss on the card's latents (indices equal); the
# encoder's backward of the card's latent gradient. The loss (staged, and of the
# whole step) within 1e-4 relative, every gradient within 1e-3 of its own
# largest entry (train_parity's bound). Then an EMA VectorQuantize (K = 1024,
# D = 8, k-means init, then 3 training calls with expiry) on the card's encoder
# latents of 192 rows a call (4,800 latents, ~4.7 a code), the same draws on
# both sides: indices equal, every state leaf within 1e-4 of its largest entry
# (ten Lloyd steps and three EMA updates of one-hot sums).
CODEC_PARITY_ROWS, CODEC_PARITY_VOCOS_LAYERS = 4, 2
TOL_CODEC_LATENT_REL, TOL_CODEC_LOSS_REL, TOL_CODEC_GRAD_REL = 1e-4, 1e-4, 1e-3
EMA_VQ_ROWS, EMA_VQ_CALLS, EMA_VQ_SIZE, EMA_VQ_DIM = 192, 3, 1024, 8
TOL_EMA_VQ_REL = 1e-4
# train_dropout: the train recipe with MLP dropout (enable_dropout=true,
# dropout_rate=0.1), 3 steps through the training entry point; the masks are
# drawn outside the remat regions, so K9-K11 launch as in train (K9 twice a
# layer, K10 and K11 once).
TRAIN_DROPOUT_STEPS = 3
TRAIN_DROPOUT_ARGS = [a for a in TRAIN_ARGS if not a.startswith("steps=")] + [
    "enable_dropout=true", "dropout_rate=0.1", f"steps={TRAIN_DROPOUT_STEPS}"]

# The flagship (configs/models/tts-flagship.yml): 48 layers, E 3840, 16 q / 8
# kv heads of 256, MLP 15360, a 264,192-row vocabulary tied to the embedding;
# 11,773,284,096 parameters, drawn in bfloat16 on the card (a float32 draw
# would be a 47 GB transient). flagship_serve: 8 slots of a 4096-token cache
# (12.9 GB of K/V), 8 greedy requests of 16-1536 prompt tokens and 64 new
# ones, then one synthesize with it as the pipeline's LM.
FLAGSHIP_YML = os.path.join(REPO, "maxtext_indextts2_tpu_torch", "configs", "models",
                            "tts-flagship.yml")
FLAGSHIP_SERVE_ARGS = [
    FLAGSHIP_YML, "weight_dtype=bfloat16", "serve_params_dtype=bfloat16",
    "decode_attention=ragged", "decode_sampling_strategy=greedy", "per_device_batch_size=8",
    "max_target_length=4096", "max_prefill_predict_length=2048", "scan_layers=false",
]
FLAGSHIP_PARAMS = 11_773_284_096
FLAGSHIP_PROMPT_LENGTHS = (16, 1536, 200, 1024, 64, 700, 1280, 333)
FLAGSHIP_NEW_TOKENS = 64
FLAGSHIP_SYNTH_FRAMES = 128
# flagship_serve_parity: one decode step through the kernels against one
# through their plain versions (bfloat16, 48 layers). The attention outputs
# differ by a bfloat16 step here and there (other summation order); 48 layers
# of random weights carry that to the tied logits (|logit| ~ 1/sqrt(E) of the
# normed state's size) as a share of their own scale: within 2**-4 of the
# largest logit. A wrong mask or group moves them by their whole size.
FLAGSHIP_PARITY_PROMPT_LENGTHS = (16, 1100, 300, 64)
TOL_FLAGSHIP_PARITY_REL = 2.0 ** -4
# train_flagship_vocab: the repo's flagship-vocab recipe, benchmarks/
# mfu_flagship.py BEST at full size (the tts-1b body, vocab 264,192 tied,
# 4 x 2048 tokens, fused CE chunk 512, remat full, flash, bf16 weights;
# flash_block_sizes binds no tile in the port); 1,799,445,504 parameters.
# Then the same with the int8 fused CE and bfloat16 logit slices. The
# recipe's own quantization=int8 (configs/perf/v5e/tts_flagship.sh) is
# train_int8's first run.
TRAIN_FLAGSHIP_VOCAB_ARGS = [
    TTS_1B, "vocab_size=264192", "logits_via_embedding=true", "remat_policy=full",
    "attention=flash", "scan_layers=false", "weight_dtype=bfloat16", "per_device_batch_size=4",
    "fused_vocab_ce_chunk=512", "dataset_type=synthetic", f"steps={TRAIN_STEPS}",
]
FLAGSHIP_VOCAB_PARAMS = 1_799_445_504
# train_flagship_vocab_parity: one batch of 2 x 2048 at the same weights
# through each fused route and the materialised CE (whose float32 logits of
# 4.33 GB and their gradients fit beside the model). float routes (chunked,
# streaming): loss within 1e-3 relative, grad norm 1e-2, the embedding's and
# layer 10's gradients within 2**-4 of each leaf's largest entry (bfloat16
# weights: the chunked dW is summed in bfloat16 chunk by chunk, dy is rounded
# to bfloat16 from sums in another order). int8: the unembedding's int8 codes
# (1/254 of each column's largest entry) and the int8 codes of the softmax
# gradient move the loss by ~1e-2 and the gradients by a share of their own
# size: 2e-2, 5e-2 and 0.5. Each fused route must peak at least one float32
# copy of the [B*S, V] logits below the materialised route.
FLAGSHIP_VOCAB_PARITY_BATCH = 2
FLAGSHIP_PARITY_LAYER = "decoder.layers_10."
FLAGSHIP_PARITY_TILE = 8192
TOL_FLAGSHIP_VOCAB_PARITY = {"float": (1e-3, 1e-2, 2.0 ** -4), "int8": (2e-2, 5e-2, 0.5)}
# train_flagship: tts-flagship at full width, depth cut to 4 layers (1.91 B
# parameters: 4 x 224.1 M + the 1.01 B tied embedding), one 4096-token row a
# step, its own fused CE (chunk 512), remat full; attention autoselected (flash
# at S >= 1024 on the card): K9-K11 at D = 256.
TRAIN_FLAGSHIP_STEPS = 3
TRAIN_FLAGSHIP_ARGS = [
    FLAGSHIP_YML, "base_num_decoder_layers=4", "per_device_batch_size=1", "remat_policy=full",
    "weight_dtype=bfloat16", "scan_layers=false", "dataset_type=synthetic",
    f"steps={TRAIN_FLAGSHIP_STEPS}",
]
FLAGSHIP_TRAIN_PARAMS = 1_911_066_368

# ROADMAP item 5.6. serve_int8w: the serve recipe with int8w_serve weights
# (int8 kernels of the decoder's linears, float32 scales a column, quantized on
# the card from the seeded float weights), 32 slots, greedy, captured, dense
# and paged; 64 tokens a stream. Parameter bytes within 2 % of the reckoned
# int8 linears plus the bfloat16 embedding and unembedding. Self-consistency:
# each int8 stream's tokens against the argmax of one int8 prefill forward over
# the stream, a token counted as agreeing where it is the argmax or within a
# near tie of it (TOL_NEAR_TIE of the largest |logit|: the prefill and decode
# attention kernels sum in other orders).
SERVE_INT8W_ARGS = SERVE_ARGS + ["quantization=int8w_serve"]
PAGED_INT8W_ARGS = PAGED_ARGS + ["quantization=int8w_serve"]
INT8W_STEPS = 64
INT8W_SELF_STREAMS = 4
TOL_NEAR_TIE = 2.0 ** -6
TOL_INT8W_BYTES_REL = 0.02
# train_int8: the flagship-vocab recipe exactly as configs/perf/v5e/
# tts_flagship.sh has it, with quantization=int8; then the tts-1b recipe at
# int8 and at fp8. train_int8_parity: (a) AQT's int8 and fp8 products alone at
# the layer's full width ([512, 2048] x [2048, 2048] float32, one noise
# tensor): output and input gradient BITWISE equal on the card and the CPU
# (integer sums, the same elementwise roundings), the kernel gradient (a
# float32 product) within 1e-5 of its largest entry. (b) One step of 2 float32
# layers (one row of 512 tokens: the CPU side's time), card against CPU, one
# noise tensor a layer. Unquantized, the two agree to ~5e-6 of a gradient's
# largest entry (the same step's float route, reported beside); quantized, a
# last-bit difference moves a code at a rounding boundary by one step (1/127
# of its row's scale, a few per cent of that element), which moves the next
# layer's inputs and flips more codes there: on an H100 the loss moved 1.5e-3,
# a gradient by 2-4 % of its largest entry (median 2 %). The phase counts the
# codes that differ layer by layer and feeds the card's layer-0 output to the
# CPU step; on an H100 (700 W) layer 0's x codes differed in 6,107 of 10.5 M,
# layer 1's in 530,819, every kernel code in none, and the injection cut the
# loss gap from 1.5e-3 to 4.2e-5 and layer 1's gradients' from 2.5 % to 0.6 %:
# boundary flips explain the gap. Bounds: loss 5e-3, grad norm 2e-3 relative,
# every gradient 0.1 of its largest entry, median 0.05.
TRAIN_INT8_FLAGSHIP_VOCAB_ARGS = TRAIN_FLAGSHIP_VOCAB_ARGS + ["quantization=int8"]
TRAIN_INT8_ARGS = TRAIN_ARGS + ["quantization=int8"]
TRAIN_FP8_ARGS = TRAIN_ARGS + ["quantization=fp8"]
INT8_PARITY_ARGS = TRAIN_INT8_ARGS + ["base_num_decoder_layers=2", "weight_dtype=float32",
                                      "dtype=float32", "per_device_batch_size=1",
                                      "max_target_length=512"]
TOL_INT8_PARITY = dict(loss=5e-3, grad_norm_rel=2e-3, grad_rel=0.1, grad_rel_median=0.05,
                       aqt_dw_rel=1e-5)
AQT_PARITY_SHAPE = (512, 2048, 2048)
# train_lora: the tts-1b recipe with rank-16 adapters on query and value and
# LoRA-only training; lora_merge: a nonzero adapter merged into the base
# weights against the same adapter served unmerged, float32 weights (a merge
# rounds W + a b once; the unmerged forward adds x a b): greedy streams equal up
# to the first near tie (TOL_NEAR_TIE of the largest |logit|).
TRAIN_LORA_ARGS = TRAIN_ARGS + ["lora_rank=16", "lora_only_training=true"]
LORA_SERVE_ARGS = SERVE_ARGS + ["dtype=float32", "serve_params_dtype=float32"]
LORA_STREAMS, LORA_TOKENS = 8, 32
# ROADMAP item 5 (5.7, 5.9, 5.11, 5.12), on the serve phase's engine, weights
# and 80 requests. Every stream comparison is exact (greedy, bfloat16): each
# side admits the same way, because a packed prefill couples the prompts it
# packs (their rows' sums run in other orders). serve_scanned admits fused, as
# serve does; serve_disaggregated, offline_engine and the UniServer's /generate
# admit one request at a time, held to the serve engine's per-request streams.
OFFLINE_NEW_TOKENS = 128  # every serve budget fits: a serve stream is a prefix
LOADGEN_NEW_TOKENS = 64
LOADGEN_SERVER_RATE = 0.5  # of the Offline scenario's completed samples a second
LOADGEN_MIN_SECONDS = 5.0
LOADGEN_LATENCY_BOUND_S = 60.0
# the UniServer: tts_http's 8 bodies, 4 /generate and 1 /generate_stream of
# UNI_GENERATE_TOKENS on prompts of the serve phase's distribution
UNI_GENERATE = 5
UNI_GENERATE_TOKENS = 32

# Weights in and out. lm_ckpt: the served tts-1b weights exported with HF names
# and converted back by the converter CLI, as the qwen3 family (the same
# qk-norm llama layout as the tts block). train_resume: the train recipe with
# asynchronous checkpoints every 2 steps, keeping 1; step 3 runs before the
# write is waited for. Everything that crosses a file must come back BITWISE:
# the same bits reach the same kernels (greedy streams, losses, weights, ids,
# codes and waveforms all equal).
LM_CKPT_CONVERT_ARGS = ["--model_name", "tts-1b", "decoder_block=qwen3"]
TRAIN_RESUME_ARGS = TRAIN_ARGS + [
    "enable_checkpointing=true", "async_checkpointing=true", "checkpoint_period=2",
    "checkpoint_max_to_keep=1", "save_final_checkpoint=false", "steps=3"]
RESUME_DECODE_TOKENS = 16
# audio_ckpt: a second full-width pipeline from another seed loads the first's
# weights from reference-named files (the ISTFT head carried across);
# audio_cli: the CLI in a subprocess on those files, CLI_FRAMES frames.
AUDIO_CKPT_SEED, CLI_FRAMES = 1, 64
# the config of the pipeline that the CLI must rebuild (what no checkpoint tells)
CLI_CONFIG_KEYS = (
    "decoder_block", "base_emb_dim", "base_num_query_heads", "base_num_kv_heads", "base_mlp_dim",
    "base_num_decoder_layers", "head_dim", "vocab_size", "audio_codebook_size",
    "semantic_codebook_size", "max_target_length", "max_prefill_predict_length", "dtype",
    "serve_params_dtype", "decode_attention", "decode_sampling_strategy", "s2a_num_heads",
    "s2a_timesteps", "s2a_cfg_scale", "s2a_cfg_until", "s2a_serving_dtype")


def emit(phase: str, t0: float, **fields):
    print(json.dumps({"phase": phase, "seconds": round(time.perf_counter() - t0, 3), **fields}),
          flush=True)


def check(ok: bool, what: str):
    if not ok:
        print(json.dumps({"ok": False, "failed": what}), flush=True)
        raise SystemExit(f"chip_smoke: {what}")


def phase_device():
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stdout.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    emit("device", t0, name=torch.cuda.get_device_name(0),
         capability=list(torch.cuda.get_device_capability(0)), torch=torch.__version__,
         cuda=torch.version.cuda, name_and_power_limit=card, imports=_optional_imports())
    return card


def _optional_imports() -> dict:
    """Whether the packages a gRPC front end needs import here (ROADMAP 5.10)."""
    import importlib

    out = {}
    for name in ("grpc", "google.protobuf"):
        try:
            mod = importlib.import_module(name)
            out[name] = getattr(mod, "__version__", "imported")
        except Exception as e:  # noqa: BLE001 - the answer is the finding
            out[name] = f"not importable: {type(e).__name__}"
    return out


def phase_build():
    from maxtext_indextts2_tpu_torch.ops import _build
    from maxtext_indextts2_tpu_torch.ops.smoke import FLASH_KERNEL_NAMES

    t0 = time.perf_counter()
    _build.load_library(verbose=False)
    # K1 / K3 / K4's, K5 / K7's and every K9-K11 instantiation (`-Xptxas -v`):
    # none may spill
    reports = {kernel: [[r["kernel"].replace("(anonymous namespace)::", "").split("(")[0],
                         r.get("registers"), r.get("spill_stores"), r.get("spill_loads")]
                        for r in _build.ptxas_report(kernel)]
               for kernel in ("ragged_decode_kernel", "norm_rows_kernel", FLASH_KERNEL_NAMES,
                              "int8w_matmul", "grouped_matmul", "gmm_wg", "gmm_bwd", "gmm_f32")}
    decode, norm = reports["ragged_decode_kernel"], reports["norm_rows_kernel"]
    flash, int8w = reports[FLASH_KERNEL_NAMES], reports["int8w_matmul"]
    gmm, gmm_bwd, gmm_f32 = reports["grouped_matmul"], reports["gmm_bwd"], reports["gmm_f32"]
    gmm_wg = reports["gmm_wg"]
    emit("build", t0, build_seconds=_build.build_seconds, sources=sorted(
        os.path.relpath(s, REPO) for s in _build._sources()),
        decode_attention_registers_spill_stores_loads=decode,
        norm_rows_registers_spill_stores_loads=norm,
        flash_registers_spill_stores_loads=flash,
        int8w_matmul_registers_spill_stores_loads=int8w,
        grouped_matmul_registers_spill_stores_loads=gmm,
        grouped_wgmma_registers_spill_stores_loads=gmm_wg,
        grouped_matmul_bwd_registers_spill_stores_loads=gmm_bwd,
        grouped_matmul_f32_registers_spill_stores_loads=gmm_f32)
    check(decode and all(r[2] == 0 and r[3] == 0 for r in decode),
          f"a decode-attention instantiation spills: {decode}")
    check(norm and all(r[2] == 0 and r[3] == 0 for r in norm),
          f"a norm_rows_kernel instantiation spills: {norm}")
    check(len(flash) == 18 and all(r[2] == 0 and r[3] == 0 for r in flash),
          f"a flash-attention (K9-K11) instantiation spills, or one is missing: {flash}")
    # (the file's anonymous namespace carries its name): the bf16 tensor-core
    # kernel at 16, 32 and 64 rows a block x (16-byte copies, element loads),
    # the float32 one at 8 and 16 rows
    check(len(int8w) == 8 and all(r[2] == 0 and r[3] == 0 for r in int8w),
          f"an int8w_matmul instantiation spills, or one is missing: {int8w}")
    # the few-rows kernels' rings (bf16: 3, 4, 6 stages; int8: 3, 4) and the
    # persistent int8 kernel
    check(len(gmm) == 6 and all(r[2] == 0 and r[3] == 0 for r in gmm),
          f"a grouped_matmul instantiation spills, or one is missing: {gmm}")
    # the persistent wgmma kernels (the consumers' 232 registers after
    # setmaxnreg; ptxas reports the launch's 168): grouped_wgmma.cuh's
    # rows_kernel for the bf16 forward (many rows) and dgrad, and wgrad
    check(len(gmm_wg) == 2 and all(r[2] == 0 and r[3] == 0 for r in gmm_wg),
          f"a grouped wgmma rows_kernel instantiation spills, or one is missing: {gmm_wg}")
    check(len(gmm_bwd) == 1 and all(r[2] == 0 and r[3] == 0 for r in gmm_bwd),
          f"the grouped_matmul wgrad kernel spills, or is missing: {gmm_bwd}")
    # float32: the forward and dgrad row-tile kernels at 64 and 128 rows, and wgrad
    check(len(gmm_f32) == 5 and all(r[2] == 0 and r[3] == 0 for r in gmm_f32),
          f"a float32 grouped_matmul instantiation spills, or one is missing: {gmm_f32}")


def phase_kernels():
    from maxtext_indextts2_tpu_torch.ops import smoke

    t0 = time.perf_counter()
    results = smoke.run_all("cuda", timing=True, full_size=True)
    for r in results:
        print(json.dumps({"phase": "kernel_case", **r}), flush=True)
    bad = [r["name"] for r in results if not r["ok"]]
    emit("kernel_checks", t0, cases=len(results), failed=bad)
    check(not bad, f"kernels disagree with their plain versions: {bad}")
    return {r["name"]: r for r in results}


def make_requests(rng, vocab):
    prompts = [rng.integers(1, vocab, size=int(n)).astype(np.int32)
               for n in rng.integers(8, 401, size=NUM_REQUESTS)]
    budgets = [int(n) for n in rng.integers(16, 129, size=NUM_REQUESTS)]
    return prompts, budgets


def phase_serve():
    """The main path: ``tts-1b`` at full width behind the Orchestrator."""
    from maxtext_indextts2_tpu_torch.config import load_config
    from maxtext_indextts2_tpu_torch.infer.engine import Engine
    from maxtext_indextts2_tpu_torch.infer.server import Orchestrator
    from maxtext_indextts2_tpu_torch.ops import inplace_update, ragged_decode_attention

    t0 = time.perf_counter()
    cfg = load_config(SERVE_ARGS)
    engine = Engine(cfg)  # no device given: the GPU, or an error
    engine.load_params()
    n_params = sum(p.numel() for p in engine.model.parameters())
    torch.cuda.synchronize()
    emit("load", t0, params=n_params, layers=cfg.num_decoder_layers, emb_dim=cfg.emb_dim,
         slots=engine.num_slots, device=str(engine.device))

    prompts, budgets = make_requests(np.random.default_rng(0), cfg.vocab_size)
    orch = Orchestrator(engine, steps_per_dispatch=STEPS_PER_DISPATCH)
    orch.start()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    # every count to 0 just before the main path, read just after
    ragged_decode_attention.launch_count = 0
    inplace_update.launch_count = 0
    t1 = time.perf_counter()
    reqs = [orch.submit(p, n) for p, n in zip(prompts, budgets)]
    finished = all(r.done.wait(timeout=600) for r in reqs)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t1
    orch.stop()
    launches = {"ragged_decode_attention": ragged_decode_attention.launch_count,
                "inplace_row_update": inplace_update.launch_count}

    check(finished, "serve: a request did not finish in 600 s")
    errors = [r.error for r in reqs if r.error]
    check(not errors, f"serve: {len(errors)} requests failed, first: {errors[:1]}")
    check(all(len(r.tokens) == n for r, n in zip(reqs, budgets)),
          "serve: a request did not get exactly its token budget")
    check(all(0 <= t < cfg.vocab_size for r in reqs for t in r.tokens),
          "serve: a token outside [0, vocab)")
    steps = orch.stats["decode_steps_total"]
    layers = cfg.num_decoder_layers
    want = {"ragged_decode_attention": layers * steps, "inplace_row_update": 2 * layers * steps}
    check(steps > 0 and launches == want,
          f"serve: kernel launches {launches} != expected {want} ({steps} decode steps)")
    check(orch.stats["admission_dispatches_total"] < NUM_REQUESTS, "serve: admission never fused")
    tokens = sum(len(r.tokens) for r in reqs)
    emit("serve", t0, requests=len(reqs), tokens=tokens, serve_seconds=seconds,
         tokens_per_s=tokens / seconds, decode_steps=steps,
         admission_dispatches=orch.stats["admission_dispatches_total"],
         launches=launches, distinct_tokens=len({t for r in reqs for t in r.tokens}),
         peak_memory_bytes=torch.cuda.max_memory_allocated())
    return engine, launches


def _clone_state(state):
    out = {"cache": [[c.clone() for c in unit] for unit in state["cache"]],
           "tokens": state["tokens"].clone(), "pos": state["pos"].clone(),
           "active": state["active"].clone()}
    if "page_state" in state:
        out["page_state"] = type(state["page_state"])(*(t.clone() for t in state["page_state"]))
    return out


def _parity_admissions(engine, state, prompts):
    """Two packed admissions of four prompts each into the even slots 0-14,
    then three decode steps: the populated state of both parity phases."""
    for i in (0, 4):
        state, _ = engine.prefill_insert_many(
            state, prompts[i:i + 4], [2 * j for j in range(i, i + 4)])
    state, _ = engine.generate_n(state, 3)
    return state


PARITY_PROMPT_LENGTHS = (5, 64, 130, 17, 250, 33, 120, 96)


def phase_serve_parity(engine):
    """The kernels inside the model against their plain versions."""
    from maxtext_indextts2_tpu_torch.config import load_config
    from maxtext_indextts2_tpu_torch.infer.engine import Engine

    t0 = time.perf_counter()
    rng = np.random.default_rng(1)
    vocab = engine.cfg.vocab_size
    # (a) the bfloat16 20-layer model: one step from one populated state
    prompts = [rng.integers(1, vocab, size=int(n)).astype(np.int32)
               for n in PARITY_PROMPT_LENGTHS]
    state = _parity_admissions(engine, engine.init_decode_state(), prompts)
    twin = _clone_state(state)
    _, logits_kernel = engine._generate_step(state)
    _, logits_plain = engine._generate_step(twin, impl="plain")
    torch.cuda.synchronize()
    active = state["active"]
    err = float((logits_kernel[active] - logits_plain[active]).abs().max().item())
    finite = bool(torch.isfinite(logits_kernel).all().item())
    scale = float(logits_plain[active].abs().max().item())
    check(finite and err <= TOL_PARITY_BF16_LOGITS,
          f"serve_parity: bfloat16 logits differ by {err} > {TOL_PARITY_BF16_LOGITS}")
    del state, twin

    # (b) full width, 4 layers, float32: greedy streams must be identical
    cfg4 = load_config([TTS_1B, "decode_attention=ragged", "dtype=float32",
                        "base_num_decoder_layers=4", "per_device_batch_size=8",
                        "max_prefill_predict_length=1024", "scan_layers=false"])
    eng4 = Engine(cfg4)
    eng4.load_params()
    streams = []
    for impl in (None, "plain"):
        st = eng4.init_decode_state()
        st, first = eng4.prefill_insert_many(st, prompts[:4], [0, 1, 2, 3])
        st, second = eng4.prefill_insert_many(st, prompts[4:], [4, 5, 6, 7])
        st, toks = eng4.generate_n(st, 31, impl=impl)
        streams.append(torch.cat([torch.cat([first, second])[None], toks]).cpu().numpy())
        del st
    same = bool((streams[0] == streams[1]).all())
    check(streams[0].shape == (32, 8) and same,
          "serve_parity: float32 greedy streams of the kernel path and the plain path differ")
    emit("serve_parity", t0, bf16_logits_max_abs_err=err, tol=TOL_PARITY_BF16_LOGITS,
         bf16_logits_max_abs=scale, f32_streams_identical=same, f32_tokens_compared=int(streams[0].size),
         f32_distinct_tokens=int(len(np.unique(streams[0]))))


def phase_http(engine):
    from maxtext_indextts2_tpu_torch.infer.server import make_server

    t0 = time.perf_counter()
    server, orch, _ = make_server(engine.cfg, port=0, engine=engine, host="127.0.0.1")
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        body = json.dumps({"prompt": list(range(1, 13)), "max_new_tokens": 8}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{port}/generate", data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as resp:
            tokens = json.loads(resp.read())["tokens"]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=30) as resp:
            metrics = resp.read().decode()
    finally:
        server.shutdown()
        server.server_close()
        orch.stop()
        thread.join(timeout=30)
    check(len(tokens) == 8 and all(0 <= t < engine.cfg.vocab_size for t in tokens),
          f"http: bad /generate answer {tokens}")
    check("serving_requests_completed 1" in metrics, "http: /metrics does not count the request")
    emit("http", t0, tokens=tokens)


def phase_serve_paged():
    """The main path of this slice: ``tts-1b`` at full width behind the
    Orchestrator with a paged KV cache, the serve phase's 80 requests."""
    from maxtext_indextts2_tpu_torch.config import load_config
    from maxtext_indextts2_tpu_torch.infer.engine import Engine
    from maxtext_indextts2_tpu_torch.infer.server import Orchestrator

    t0 = time.perf_counter()
    cfg = load_config(PAGED_ARGS)
    engine = Engine(cfg)  # no device given: the GPU, or an error
    engine.load_params()
    prompts, budgets = make_requests(np.random.default_rng(0), cfg.vocab_size)
    orch = Orchestrator(engine, steps_per_dispatch=STEPS_PER_DISPATCH)
    held_back = set()  # requests the page reservations kept waiting at the head of the line
    can_admit = orch._can_admit

    def counted_can_admit(req):
        ok = can_admit(req)
        if not ok:
            held_back.add(id(req))
        return ok

    orch._can_admit = counted_can_admit
    orch.start()
    pools = [c for unit in orch.decode_state["cache"] for c in unit]
    pool_bytes = sum(p.key_pages.nbytes + p.value_pages.nbytes for p in pools)
    # what a dense cache of this configuration would hold (not allocated)
    dense_bytes = (engine.num_slots * cfg.max_target_length * cfg.num_decoder_layers
                   * cfg.num_kv_heads * cfg.head_dim * 2 * pools[0].key_pages.element_size())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_all_counts()  # every count to 0 just before the main path, read just after
    t1 = time.perf_counter()
    reqs = [orch.submit(p, n) for p, n in zip(prompts, budgets)]
    most_active, deadline = 0, time.monotonic() + 600
    while not all(r.done.is_set() for r in reqs) and time.monotonic() < deadline:
        most_active = max(most_active, orch.active_slots())
        time.sleep(0.005)
    finished = all(r.done.is_set() for r in reqs)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t1
    orch.stop()
    launches = _all_counts()

    check(finished, "serve_paged: a request did not finish in 600 s")
    errors = [r.error for r in reqs if r.error]
    check(not errors, f"serve_paged: {len(errors)} requests failed, first: {errors[:1]}")
    check(all(len(r.tokens) == n for r, n in zip(reqs, budgets)),
          "serve_paged: a request did not get exactly its token budget")
    check(all(0 <= t < cfg.vocab_size for r in reqs for t in r.tokens),
          "serve_paged: a token outside [0, vocab)")
    steps = orch.stats["decode_steps_total"]
    layers = cfg.num_decoder_layers
    want = {k: 0 for k in launches}
    want["paged_decode_attention"] = layers * steps
    check(steps > 0 and launches == want,
          f"serve_paged: kernel launches {launches} != expected {want} ({steps} decode steps)")
    ps = orch.decode_state["page_state"]
    free = int((ps.page_status == 0).sum().item())
    check(int(orch._pages_reserved.sum()) == 0 and free == cfg.pagedattn_num_pages - 1
          and int(ps.seq_lens.abs().sum().item()) == 0,
          f"serve_paged: pages not all back ({int(orch._pages_reserved.sum())} reserved, "
          f"{free} of {cfg.pagedattn_num_pages - 1} free)")
    worst = max(orch._pages_needed(r) for r in reqs)
    tokens = sum(len(r.tokens) for r in reqs)
    emit("serve_paged", t0, requests=len(reqs), tokens=tokens, serve_seconds=seconds,
         tokens_per_s=tokens / seconds, decode_steps=steps,
         admission_dispatches=orch.stats["admission_dispatches_total"],
         most_active_slots_seen=most_active, requests_held_back_for_pages=len(held_back),
         slots=engine.num_slots,
         usable_pages=cfg.pagedattn_num_pages - 1, worst_request_pages=worst,
         tokens_per_page=cfg.pagedattn_tokens_per_page, context=cfg.max_target_length,
         launches=launches, distinct_tokens=len({t for r in reqs for t in r.tokens}),
         pool_bytes=pool_bytes, dense_cache_bytes_not_allocated=dense_bytes,
         peak_memory_bytes=torch.cuda.max_memory_allocated())
    return engine, launches["paged_decode_attention"]


def phase_serve_paged_parity(engine):
    """K4 inside the model against its plain version; paged streams against
    the dense ones."""
    from maxtext_indextts2_tpu_torch.config import load_config
    from maxtext_indextts2_tpu_torch.infer.engine import Engine
    from maxtext_indextts2_tpu_torch.ops import ragged_decode_attention as rda

    t0 = time.perf_counter()
    rng = np.random.default_rng(1)
    vocab = engine.cfg.vocab_size
    prompts = [rng.integers(1, vocab, size=int(n)).astype(np.int32)
               for n in PARITY_PROMPT_LENGTHS]
    # (a) the bfloat16 20-layer paged model: one step from one populated state
    state = _parity_admissions(engine, engine.init_decode_state(), prompts)
    twin = _clone_state(state)
    _reset_all_counts()
    _, logits_kernel = engine._generate_step(state)
    torch.cuda.synchronize()
    k4_step = rda.paged_launch_count
    _, logits_plain = engine._generate_step(twin, impl="plain")
    torch.cuda.synchronize()
    check(k4_step == engine.cfg.num_decoder_layers and rda.paged_launch_count == k4_step,
          f"serve_paged_parity: K4 ran {k4_step} times in the kernel step, "
          f"{rda.paged_launch_count - k4_step} in the plain step")
    active = state["active"]
    err = float((logits_kernel[active] - logits_plain[active]).abs().max().item())
    finite = bool(torch.isfinite(logits_kernel).all().item())
    scale = float(logits_plain[active].abs().max().item())
    check(finite and err <= TOL_PARITY_BF16_LOGITS,
          f"serve_paged_parity: bfloat16 logits differ by {err} > {TOL_PARITY_BF16_LOGITS}")
    del state, twin

    # (b) full width, 4 layers, float32: paged-K4, paged-plain and dense-K1
    # give identical greedy streams
    common = [TTS_1B, "dtype=float32", "base_num_decoder_layers=4", "per_device_batch_size=8",
              "max_prefill_predict_length=1024", "scan_layers=false"]
    paged = Engine(load_config(common + ["paged_attention=true", "pagedattn_tokens_per_page=16",
                                         "pagedattn_num_pages=400"]))
    paged.load_params()
    dense = Engine(load_config(common + ["decode_attention=ragged"]))
    dense.set_params(paged.params)
    streams, counts = {}, {}
    for name, eng, impl in (("paged_k4", paged, None), ("paged_plain", paged, "plain"),
                            ("dense_k1", dense, None)):
        st = eng.init_decode_state()
        st, first = eng.prefill_insert_many(st, prompts[:4], [0, 1, 2, 3])
        st, second = eng.prefill_insert_many(st, prompts[4:], [4, 5, 6, 7])
        _reset_all_counts()
        st, toks = eng.generate_n(st, 31, impl=impl)
        torch.cuda.synchronize()
        counts[name] = {k: v for k, v in _all_counts().items() if v}
        streams[name] = torch.cat([torch.cat([first, second])[None], toks]).cpu().numpy()
        del st
    same = all(bool((streams[n] == streams["dense_k1"]).all()) for n in streams)
    check(streams["paged_k4"].shape == (32, 8) and same,
          "serve_paged_parity: float32 greedy streams of paged-K4, paged-plain and dense-K1 differ")
    check(counts["paged_k4"] == {"paged_decode_attention": 4 * 31} and not counts["paged_plain"],
          f"serve_paged_parity: launches {counts}")
    emit("serve_paged_parity", t0, bf16_logits_max_abs_err=err, tol=TOL_PARITY_BF16_LOGITS,
         bf16_logits_max_abs=scale, f32_streams_identical=same,
         f32_tokens_compared=int(streams["paged_k4"].size),
         f32_distinct_tokens=int(len(np.unique(streams["paged_k4"]))), launches=counts)


# The decode extras at full width (tts-1b: E 2048, 20 layers, 16q / 8kv, d 128,
# a 2048-token context). Where token streams of two routes are compared they
# run in float32 (TF32 off): bfloat16 rounds the routes' different summation
# orders apart and a random model's near-ties then flip a greedy token.
F32_ARGS = [TTS_1B, "decode_attention=ragged", "dtype=float32", "scan_layers=false",
            "decode_sampling_strategy=greedy"]
CAPTURED_STEPS = 64  # tokens each stream decodes after its first in serve_captured_parity
CHUNKED_PROMPT = 1900
PREFILL_CHUNK = 512
SHARED_PREFIX = 1024
SPEC_K = 4
SPEC_STREAMS = 8
SPEC_TOKENS = 64
SHORT_POOL_ARGS = ["dtype=float32", "base_num_decoder_layers=4", "per_device_batch_size=8",
                   "max_prefill_predict_length=512", "scan_layers=false",
                   "decode_sampling_strategy=greedy"]
SHORT_POOL_PAGES = 61  # 60 usable 16-row pages: 2-4 of the 16 requests at a time
HTTP_STREAMS = 8


def _populate(engine, prompts):
    """A fresh decode state with ``prompts`` in slots 0.. (packed admissions of
    at most 8, under the prefill limit). Returns (state, first tokens [k])."""
    state, firsts, i = engine.init_decode_state(), [], 0
    limit = engine.cfg.max_prefill_predict_length
    while i < len(prompts):
        group, total = [], 0
        while i < len(prompts) and len(group) < 8 and total + len(prompts[i]) <= limit:
            group.append(prompts[i])
            total += len(prompts[i])
            i += 1
        state, first = engine.prefill_insert_many(state, group, list(range(i - len(group), i)))
        firsts.append(first)
    return state, torch.cat(firsts)


def _decode_streams(engine, prompts, steps, eager=False, n=STEPS_PER_DISPATCH):
    """[len(prompts), 1 + steps] greedy (or sampled) streams: admissions, then
    ``steps`` tokens in dispatches of ``n``, captured or ``eager``."""
    state, first = _populate(engine, prompts)
    toks = [first[None]]
    for _ in range(steps // n):
        state, t = engine.generate_n(state, n, _eager=eager)
        toks.append(t[:, :len(prompts)])
    return torch.cat(toks).t().cpu().numpy()


def phase_serve_captured_parity(engine, route, prompts, card):
    """The captured decode dispatch against the eager one (the same kernels
    launched one by one): equal greedy streams, equal weighted-sampling
    streams from one seed (each replay draws fresh noise from the engine's
    generator), and the step's host ms, device-busy ms, idle share and
    launches a step on each route (``tools/profile_decode.measure``)."""
    from maxtext_indextts2_tpu_torch.infer.engine import Engine
    from maxtext_indextts2_tpu_torch.tools import profile_decode

    t0 = time.perf_counter()
    captures0, replays0 = engine.graphs.captures, engine.graphs.replays
    greedy = [_decode_streams(engine, prompts, CAPTURED_STEPS, eager=e) for e in (False, True)]
    same = bool(np.array_equal(greedy[0], greedy[1]))
    check(same, f"serve_captured_parity ({route}): captured and eager greedy streams differ")
    replays = engine.graphs.replays - replays0
    check(engine.graphs.captures > captures0 and replays >= CAPTURED_STEPS // STEPS_PER_DISPATCH - 1,
          f"serve_captured_parity ({route}): {replays} replays")
    sampled = None
    if route == "dense":
        weighted = Engine(dataclasses.replace(engine.cfg, decode_sampling_strategy="weighted",
                                              decode_sampling_temperature=1.0),
                          model=engine.model)
        weighted.params = engine.params
        runs = []
        for eager in (False, True):
            weighted.generator.manual_seed(5)
            runs.append(_decode_streams(weighted, prompts, CAPTURED_STEPS, eager=eager))
        sampled = bool(np.array_equal(runs[0], runs[1]))
        distinct = int(len(np.unique(runs[0])))
        check(sampled and distinct > len(prompts),
              "serve_captured_parity: weighted sampling gives other streams captured and "
              f"eager from one seed ({distinct} distinct tokens)")
        del weighted
    profiles = {}
    for eager in (False, True):
        state, _ = _populate(engine, prompts[:engine.num_slots])
        step, prof = profile_decode.measure(engine, state, steps=8, eager=eager)
        profiles[step["route"]] = {**step, **{k: prof[k] for k in (
            "graph_replays", "device_busy_ms_per_step", "device_idle_share",
            "device_kernels_per_step", "host_launch_calls_per_step",
            "own_kernel_launches_per_step")}}
        del state
    emit("serve_captured_parity", t0, card=card, route=route, slots=engine.num_slots,
         streams=len(prompts), tokens_compared=int(greedy[0].size), greedy_streams_equal=same,
         weighted_streams_equal=sampled, graph_captures=engine.graphs.captures,
         graph_replays=engine.graphs.replays, profile=profiles)


def phase_generate_stream_http(engine):
    """8 concurrent ``POST /generate_stream`` requests: ndjson lines, one a
    token, equal to ``POST /generate``'s tokens for the same prompts
    (per-request admission, so that no packing couples two prompts)."""
    from maxtext_indextts2_tpu_torch.infer.server import make_server

    t0 = time.perf_counter()
    cfg = dataclasses.replace(engine.cfg, serving_admission_fusion_max=1)
    server, orch, _ = make_server(cfg, port=0, engine=engine, host="127.0.0.1")
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(n)).tolist()
               for n in rng.integers(8, 300, size=HTTP_STREAMS)]
    out = {"stream": {}, "generate": {}}

    def post(kind, i):
        body = json.dumps({"prompt": prompts[i], "max_new_tokens": 24}).encode()
        path = "generate_stream" if kind == "stream" else "generate"
        req = urllib.request.Request(f"http://127.0.0.1:{port}/{path}", data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as resp:
            raw = resp.read().decode()
        out[kind][i] = ([json.loads(line)["token"] for line in raw.splitlines()]
                        if kind == "stream" else json.loads(raw)["tokens"])

    try:
        for kind in ("stream", "generate"):
            threads = [threading.Thread(target=post, args=(kind, i)) for i in range(HTTP_STREAMS)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
    finally:
        server.shutdown()
        server.server_close()
        orch.stop()
        thread.join(timeout=30)
    same = all(out["stream"].get(i) == out["generate"].get(i) and len(out["stream"][i]) == 24
               for i in range(HTTP_STREAMS))
    check(same, "generate_stream_http: /generate_stream's ndjson tokens differ from /generate's")
    emit("generate_stream_http", t0, requests=HTTP_STREAMS, tokens_each=24, streams_equal=same)


def _serve_one_by_one(engine, prompts, budgets, hook=None):
    """The requests queued before the loop starts, admitted one at a time
    (prefill + insert). Returns (orchestrator, requests)."""
    from maxtext_indextts2_tpu_torch.infer.server import Orchestrator

    orch = Orchestrator(engine, steps_per_dispatch=STEPS_PER_DISPATCH, admission_fusion_max=1)
    if hook is not None:
        hook(orch)
    reqs = [orch.submit(p, n) for p, n in zip(prompts, budgets)]
    orch.start()
    finished = all(r.done.wait(timeout=600) for r in reqs)
    torch.cuda.synchronize()
    orch.stop()
    check(finished and not any(r.error for r in reqs),
          f"a one-by-one serve did not finish cleanly: {[r.error for r in reqs if r.error][:1]}")
    return orch, reqs


def phase_serve_paged_short_pool():
    """Admission control on the card: 16 requests whose page reservations far
    exceed a 60-page pool (16-row pages), 8 slots, full width at 4 layers in
    float32. The head of the line waits for pages, every page comes back, and
    the paged streams (K4) equal the dense ones (K1) of the same weights."""
    from maxtext_indextts2_tpu_torch.config import load_config
    from maxtext_indextts2_tpu_torch.infer.engine import Engine

    t0 = time.perf_counter()
    paged = Engine(load_config([TTS_1B] + SHORT_POOL_ARGS + [
        "paged_attention=true", "pagedattn_tokens_per_page=16",
        f"pagedattn_num_pages={SHORT_POOL_PAGES}"]))
    paged.load_params()
    dense = Engine(load_config([TTS_1B, "decode_attention=ragged"] + SHORT_POOL_ARGS))
    dense.set_params(paged.params)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(1, paged.cfg.vocab_size, size=int(n)).astype(np.int32)
               for n in rng.integers(100, 301, size=16)]
    budgets = [int(n) for n in rng.integers(32, 65, size=16)]
    held_back, most_active = set(), [0]

    def count(orch):
        can_admit = orch._can_admit

        def counted(req):
            ok = can_admit(req)
            if not ok:
                held_back.add(id(req))
            most_active[0] = max(most_active[0], orch.active_slots())
            return ok

        orch._can_admit = counted

    _reset_all_counts()
    orch, reqs = _serve_one_by_one(paged, prompts, budgets, hook=count)
    launches = _all_counts()
    steps = orch.stats["decode_steps_total"]
    want = {k: 0 for k in launches}
    want["paged_decode_attention"] = paged.cfg.num_decoder_layers * steps
    check(launches == want, f"serve_paged_short_pool: launches {launches} != {want}")
    ps = orch.decode_state["page_state"]
    free = int((ps.page_status == 0).sum().item())
    check(held_back and int(orch._pages_reserved.sum()) == 0
          and free == SHORT_POOL_PAGES - 1 and int(ps.seq_lens.abs().sum().item()) == 0,
          f"serve_paged_short_pool: {len(held_back)} held back, {free} of "
          f"{SHORT_POOL_PAGES - 1} pages free at the end")
    worst = max(orch._pages_needed(r) for r in reqs)
    _, dreqs = _serve_one_by_one(dense, prompts, budgets)
    same = [r.tokens for r in reqs] == [r.tokens for r in dreqs]
    check(same and all(len(r.tokens) == n for r, n in zip(reqs, budgets)),
          "serve_paged_short_pool: the paged streams differ from the dense ones")
    emit("serve_paged_short_pool", t0, requests=len(reqs), slots=paged.num_slots,
         usable_pages=SHORT_POOL_PAGES - 1, worst_request_pages=worst,
         sum_request_pages=sum(orch._pages_needed(r) for r in reqs),
         requests_held_back_for_pages=len(held_back), most_active_slots_seen=most_active[0],
         decode_steps=steps, launches=launches, streams_equal_dense=same,
         tokens_compared=sum(len(r.tokens) for r in reqs))
    return launches["paged_decode_attention"]


class _FailOnce:
    """An engine whose ``generate_n`` raises a recoverable (non-sticky) error
    on its ``fail_at``-th call; counts the chunked prefills of the resume."""

    def __init__(self, inner, fail_at=3):
        self._inner, self.fail_at, self.calls, self.chunked = inner, fail_at, 0, 0

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def generate_n(self, state, n):
        self.calls += 1
        if self.calls == self.fail_at:
            raise RuntimeError("injected: CUDA out of memory (a recoverable failure)")
        return self._inner.generate_n(state, n)

    def prefill_chunked(self, *args):
        self.chunked += 1
        return self._inner.prefill_chunked(*args)


def phase_chunked_prefill():
    """Chunked prefill, the prefix cache and decode recovery at full width
    (float32, 8 slots): a 1,900-token prompt in 512-token chunks gives the
    full prefill's first token and 64 greedy tokens; 8 prompts that share a
    1,024-token prefix hit the prefix cache 7 times and decode as uncached;
    one injected decode failure, and every stream resumes (through chunked
    prefills past the 512-token prefill limit) to the uninterrupted tokens."""
    from maxtext_indextts2_tpu_torch.config import load_config
    from maxtext_indextts2_tpu_torch.infer.engine import Engine
    from maxtext_indextts2_tpu_torch.infer.prefix_cache import PrefixCache

    t0 = time.perf_counter()
    # the prefill limit at the long prompt (a limit at the context is halved)
    engine = Engine(load_config(F32_ARGS + ["per_device_batch_size=8",
                                            f"max_prefill_predict_length={CHUNKED_PROMPT}"]))
    engine.load_params()
    vocab = engine.cfg.vocab_size
    rng = np.random.default_rng(7)

    def stream(prefix, first, steps=SPEC_TOKENS):
        state = engine.insert(prefix, engine.init_decode_state(), 0)
        toks = [first[:1]]
        for _ in range(steps // STEPS_PER_DISPATCH):
            state, t = engine.generate_n(state, STEPS_PER_DISPATCH)
            toks.append(t[:, 0])
        return torch.cat(toks).cpu().tolist()

    _reset_all_counts()
    long_prompt = rng.integers(1, vocab, size=CHUNKED_PROMPT).astype(np.int32)
    t1 = time.perf_counter()
    chunked, cfirst = engine.prefill_chunked(long_prompt, CHUNKED_PROMPT, PREFILL_CHUNK)
    torch.cuda.synchronize()
    chunked_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    full, ffirst = engine.prefill(long_prompt, CHUNKED_PROMPT)
    torch.cuda.synchronize()
    full_s = time.perf_counter() - t1
    logits_err = float((chunked["logits"] - full["logits"]).abs().max().item())
    got, want = stream(chunked, cfirst), stream(full, ffirst)
    del chunked, full
    check(got == want, "chunked_prefill: the chunked prefill's stream differs from the full one")

    shared = rng.integers(1, vocab, size=SHARED_PREFIX).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(1, vocab, size=int(n)).astype(np.int32)])
               for n in rng.integers(50, 200, size=8)]
    cache = PrefixCache(PREFILL_CHUNK)
    streams = {"cached": [], "uncached": []}
    t1 = time.perf_counter()
    for p in prompts:
        streams["cached"].append(stream(*engine.prefill_cached(p, len(p), cache), steps=32))
    cached_s = time.perf_counter() - t1
    for p in prompts:
        streams["uncached"].append(stream(*engine.prefill(p, len(p)), steps=32))
    stats = cache.stats()
    check(stats["hits"] == 7 and stats["misses"] == 1 and streams["cached"] == streams["uncached"],
          f"chunked_prefill: prefix cache {stats}, streams equal "
          f"{streams['cached'] == streams['uncached']}")
    snapshot_bytes = sum(t.nbytes for unit in cache.lookup(prompts[0], len(prompts[0]))[1]
                         for c in unit for t in c.leaves().values())

    # decode recovery at the serving prefill limit (512): resumes are chunked
    engine.cfg = dataclasses.replace(engine.cfg, max_prefill_predict_length=PREFILL_CHUNK)
    # the 10th dispatch fails: 37 tokens a stream so far, so every resume
    # (prompt + tokens) is past the 512-token limit
    reqs_prompts = [rng.integers(1, vocab, size=int(n)).astype(np.int32)
                    for n in rng.integers(480, 505, size=8)]
    budgets = [48] * 8
    _, plain = _serve_one_by_one(engine, reqs_prompts, budgets)
    failing = _FailOnce(engine, fail_at=10)
    orch, resumed = _serve_one_by_one(failing, reqs_prompts, budgets)
    same = [r.tokens for r in resumed] == [r.tokens for r in plain]
    check(same and orch.stats.get("decode_recoveries") == 1 and failing.chunked == 8,
          f"chunked_prefill: recovery {orch.stats.get('decode_recoveries')}, chunked resumes "
          f"{failing.chunked}, streams equal {same}")
    launches = _all_counts()
    emit("chunked_prefill", t0, prompt=CHUNKED_PROMPT, chunk=PREFILL_CHUNK,
         last_logits_max_abs_err_f32=logits_err, first_and_64_tokens_equal=True,
         chunked_prefill_seconds=chunked_s, full_prefill_seconds=full_s,
         prefix_cache=stats, shared_prefix=SHARED_PREFIX, cached_prefills_seconds=cached_s,
         prefix_streams_equal=True, snapshot_bytes_1024_rows=snapshot_bytes,
         recovered_streams_equal=same, chunked_resumes=failing.chunked,
         decode_recoveries=orch.stats["decode_recoveries"],
         launches={k: v for k, v in launches.items() if v})
    return {k: v for k, v in launches.items() if v}


def phase_spec_decode():
    """Speculative decoding at full width (float32, 32 slots): the target is
    tts-1b, the draft the same widths at 2 layers (another seed), K = 4.
    8 greedy streams equal the target's plain greedy streams; a round is one
    graph replay; the verify span's rows go through K2 at span 5; a target
    used as its own draft commits K+1 tokens in every round."""
    from maxtext_indextts2_tpu_torch.config import load_config
    from maxtext_indextts2_tpu_torch.infer.speculative import SpeculativeEngine
    from maxtext_indextts2_tpu_torch.ops import inplace_update, ragged_decode_attention

    t0 = time.perf_counter()
    tcfg = load_config(F32_ARGS + ["per_device_batch_size=32", "max_prefill_predict_length=512"])
    dcfg = load_config(F32_ARGS + ["per_device_batch_size=32", "max_prefill_predict_length=512",
                                   "base_num_decoder_layers=2", "init_weights_seed=7"])
    rng = np.random.default_rng(8)
    prompts = [rng.integers(1, tcfg.vocab_size, size=int(n)).astype(np.int32)
               for n in rng.integers(50, 401, size=SPEC_STREAMS)]

    def spec_streams(spec):
        state = spec.init_decode_state()
        out = []
        for slot, p in enumerate(prompts):
            prefix, first = spec.prefill(p, len(p))
            state = spec.insert(prefix, state, slot)
            out.append([int(first.cpu()[0])])
        rounds, commits = 0, []
        while min(len(o) for o in out) < SPEC_TOKENS + 1:
            state, toks, n_new = spec.generate(state)
            toks, n_new = toks.cpu().numpy(), n_new.cpu().numpy()
            rounds += 1
            commits.append(n_new[:SPEC_STREAMS].tolist())
            for s in range(SPEC_STREAMS):
                out[s].extend(int(t) for t in toks[s, :n_new[s]])
        torch.cuda.synchronize()
        return [o[:SPEC_TOKENS + 1] for o in out], rounds, commits

    spec = SpeculativeEngine(tcfg, dcfg, num_draft_tokens=SPEC_K)
    spec.load_params()
    target = spec.target
    state, firsts = target.init_decode_state(), []
    for slot, p in enumerate(prompts):  # the target alone, captured decode
        prefix, first = target.prefill(p, len(p))
        state = target.insert(prefix, state, slot)
        firsts.append(first)
    toks = [torch.cat(firsts)[None]]
    for _ in range(SPEC_TOKENS // STEPS_PER_DISPATCH):
        state, t = target.generate_n(state, STEPS_PER_DISPATCH)
        toks.append(t[:, :SPEC_STREAMS])
    plain = torch.cat(toks).t().cpu().tolist()
    del state
    _reset_all_counts()
    inplace_update.span_launch_counts.clear()
    t1 = time.perf_counter()
    got, rounds, commits = spec_streams(spec)
    spec_s = time.perf_counter() - t1
    k1, spans = ragged_decode_attention.launch_count, dict(inplace_update.span_launch_counts)
    same = got == plain
    check(same, "spec_decode: the speculative streams differ from the target's greedy streams")
    dl, tl = dcfg.num_decoder_layers, tcfg.num_decoder_layers
    want = {"k1": rounds * (SPEC_K + 1) * dl, "span1": rounds * (SPEC_K + 1) * dl * 2,
            "span5": rounds * tl * 2}
    check(k1 == want["k1"] and spans == {1: want["span1"], SPEC_K + 1: want["span5"]},
          f"spec_decode: K1 {k1}, K2 by span {spans} != {want} ({rounds} rounds)")
    check(spec.graphs.captures == 1 and spec.graphs.replays == rounds - 1,
          f"spec_decode: {spec.graphs.captures} captures, {spec.graphs.replays} replays "
          f"for {rounds} rounds")
    committed = sum(sum(c) for c in commits)
    del spec, target

    # the target as its own draft: every round commits K+1 tokens a stream
    same_cfg = dataclasses.replace(tcfg)
    perfect = SpeculativeEngine(tcfg, same_cfg, num_draft_tokens=SPEC_K)
    perfect.target.load_params()
    perfect.draft.set_params(perfect.target.params)
    pgot, prounds, pcommits = spec_streams(perfect)
    all_k1 = all(c == SPEC_K + 1 for cs in pcommits for c in cs)
    check(pgot == plain and all_k1,
          f"spec_decode: target as draft commits {pcommits[:4]}..., streams equal "
          f"{pgot == plain}")
    del perfect
    emit("spec_decode", t0, streams=SPEC_STREAMS, tokens_each=SPEC_TOKENS, k=SPEC_K,
         draft_layers=dl, target_layers=tl, rounds=rounds, spec_seconds=spec_s,
         tokens_per_round_per_stream=committed / (rounds * SPEC_STREAMS),
         streams_equal_plain_greedy=same, target_as_draft_rounds=prounds,
         target_as_draft_tokens_per_round_per_stream=SPEC_K + 1 if all_k1 else None,
         k1_launches=k1, k2_launches_by_span={str(k): v for k, v in spans.items()},
         graph_replays=rounds - 1)
    return {"spec_decode": {"ragged_decode_attention": k1,
                            "inplace_row_update": spans.get(SPEC_K + 1, 0)},
            "spec_decode_draft": {"inplace_row_update": spans.get(1, 0)}}


def phase_bucketed_decode():
    """``decode_attention=bucketed`` at full width (float32, 8 slots): greedy
    streams equal the ``dot_product`` route's; the dispatches' widths grow
    with the streams (one captured graph each)."""
    from maxtext_indextts2_tpu_torch.config import load_config
    from maxtext_indextts2_tpu_torch.infer.engine import Engine

    t0 = time.perf_counter()
    args = [a for a in F32_ARGS if a != "decode_attention=ragged"] + [
        "per_device_batch_size=8", "max_prefill_predict_length=512"]
    cfgs = {route: load_config(args + [f"decode_attention={route}"])
            for route in ("bucketed", "dot_product")}
    rng = np.random.default_rng(9)
    # prompts of at most 250 rows: the first dispatches read 256 rows, the later 512
    prompts = [rng.integers(1, cfgs["bucketed"].vocab_size, size=int(n)).astype(np.int32)
               for n in rng.integers(200, 251, size=8)]
    streams, widths = {}, None
    _reset_all_counts()
    for route, cfg in cfgs.items():
        engine = Engine(cfg)
        engine.load_params()
        streams[route] = _decode_streams(engine, prompts, SPEC_TOKENS)
        if route == "bucketed":
            widths = sorted({k[0][2] for k in engine.graphs._entries})
            launches = _all_counts()
        del engine
    same = bool(np.array_equal(streams["bucketed"], streams["dot_product"]))
    check(same and widths == [256, 512],
          f"bucketed_decode: streams equal {same}, widths {widths}")
    emit("bucketed_decode", t0, streams=len(prompts), tokens_compared=int(streams["bucketed"].size),
         streams_equal_dot_product=same, widths=widths,
         launches={k: v for k, v in launches.items() if v})
    return {k: v for k, v in launches.items() if v}


def _reset_row_kernel_counts():
    from maxtext_indextts2_tpu_torch.ops import ada_rmsnorm, quant_kernels

    ada_rmsnorm.launch_count = 0
    for name in quant_kernels.launch_counts:
        quant_kernels.launch_counts[name] = 0


def _row_kernel_counts() -> dict:
    from maxtext_indextts2_tpu_torch.ops import ada_rmsnorm, quant_kernels

    return {"ada_rmsnorm": ada_rmsnorm.launch_count, **quant_kernels.launch_counts}


def _denoiser_forwards(pipe) -> int:
    """Denoiser forwards of one sampler pass over prompted rows: one per
    step, two while classifier-free guidance is on."""
    cfg = pipe.cfg
    q = pipe.s2a.cfg.num_quantizers
    total = 0
    for steps in tuple(cfg.s2a_timesteps)[:q]:
        with_cfg = 0
        if cfg.s2a_cfg_scale > 0:
            with_cfg = min(steps, int(np.ceil(cfg.s2a_cfg_until * steps)))
        total += steps + with_cfg
    return total


def _serve_backend(pipe, phase, t0, want_per_forward):
    """One ``s2a_vocoder_batch`` call for 8 seeded requests, with the row
    kernels' launch counts set to 0 just before and read just after. The call
    returns waveforms only, so the acoustic codes are checked on a second
    sampling of the same batch from the same seed, after the counts are read."""
    from maxtext_indextts2_tpu_torch.audio.pipeline import backend_requests

    c = pipe.s2a.cfg
    requests, sems, acs, gens = backend_requests(
        0, BACKEND_REQUESTS, c.cond_codebook_size, c.codebook_size, c.num_quantizers)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_row_kernel_counts()
    t1 = time.perf_counter()
    out = pipe.s2a_vocoder_batch(requests, sems, acs, gens, pad_to_batch=BACKEND_SHAPE[0],
                                 length_bucket=64)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t1
    launches = _row_kernel_counts()

    hop = int(np.prod(pipe.codec.strides))
    codes = pipe._sample_codes(sems, acs, gens, None, 64, BACKEND_SHAPE[0], None, None)
    codes = codes[:BACKEND_REQUESTS]
    rewav = pipe.codec.detokenize(codes.permute(2, 0, 1)).float().cpu().numpy()
    peak = max(float(np.abs(w).max()) for w, _ in out)
    resampled_err = max(float(np.abs(w - rewav[i, :len(w)]).max()) for i, (w, _) in enumerate(out))
    check(len(out) == BACKEND_REQUESTS, f"{phase}: {len(out)} waveforms for 8 requests")
    check(tuple(codes.shape) == (BACKEND_REQUESTS, BACKEND_SHAPE[2], c.num_quantizers),
          f"{phase}: acoustic codes of shape {tuple(codes.shape)}")
    check(0 <= int(codes.min()) and int(codes.max()) < c.codebook_size,
          f"{phase}: an acoustic code outside [0, {c.codebook_size})")
    for (wav, info), gen in zip(out, gens):
        check(wav.shape == (len(gen) * hop,) and info["semantic_tokens"] == len(gen),
              f"{phase}: a waveform of {wav.shape} for {len(gen)} frames")
        check(bool(np.isfinite(wav).all()) and float(wav.std()) > 0,
              f"{phase}: a waveform that is not finite or is constant")
    forwards = _denoiser_forwards(pipe)
    want = {k: n * forwards for k, n in want_per_forward.items()}
    check(launches == want, f"{phase}: kernel launches {launches} != expected {want} "
                            f"({forwards} denoiser forwards)")
    audio = sum(info["audio_seconds"] for _, info in out)
    emit(phase, t0, requests=len(out), serving_dtype=pipe.cfg.s2a_serving_dtype,
         timesteps=list(pipe.cfg.s2a_timesteps), denoiser_forwards=forwards,
         denoiser_shape=[BACKEND_SHAPE[0], BACKEND_SHAPE[1] + BACKEND_SHAPE[2], c.hidden_size],
         call_seconds=seconds, sampler_seconds=out[0][1]["t_s2a"],
         vocoder_seconds=out[0][1]["t_vocoder"], audio_seconds=audio,
         gpu_seconds_per_audio_second=seconds / audio, launches=launches,
         distinct_codes=int(codes.unique().numel()),
         resampled_wav_max_err_of_peak=resampled_err / peak,
         peak_memory_bytes=torch.cuda.max_memory_allocated())
    return launches


def phase_tts_backend():
    """The second main path: the TTS back end at full width, ``int8_offline``."""
    from maxtext_indextts2_tpu_torch.audio.pipeline import build_backend

    t0 = time.perf_counter()
    pipe = build_backend("int8_offline")  # no device given: the GPU, or an error
    layers = pipe.s2a.cfg.num_layers
    emit("tts_backend_load", t0, s2a_params=sum(p.numel() for p in pipe.s2a.parameters()),
         codec_params=sum(p.numel() for p in pipe.codec.parameters()), s2a_layers=layers,
         hidden=pipe.s2a.cfg.hidden_size, device=str(pipe.device))
    per_forward = {"ada_rmsnorm": 1, "row_quantize_int8": layers,
                   "ada_rmsnorm_quantize": 2 * layers, "silu_mul_quantize": layers}
    return pipe, _serve_backend(pipe, "tts_backend", t0, per_forward)


def phase_tts_backend_bf16():
    """The same batch served as ``bfloat16``: every norm is ``ada_rmsnorm``."""
    from maxtext_indextts2_tpu_torch.audio.pipeline import build_backend

    t0 = time.perf_counter()
    pipe = build_backend("bfloat16", timesteps=BF16_TIMESTEPS)
    per_forward = {"ada_rmsnorm": 2 * pipe.s2a.cfg.num_layers + 1, "row_quantize_int8": 0,
                   "ada_rmsnorm_quantize": 0, "silu_mul_quantize": 0}
    _serve_backend(pipe, "tts_backend_bf16", t0, per_forward)
    return pipe


def _denoiser_parity(pipe, seed):
    """One full-width conditional forward at the main path's shape: kernels
    against plain versions. Returns (max, mean) absolute difference and the
    largest output magnitude."""
    c = pipe.s2a.cfg
    b, s = BACKEND_SHAPE[0], BACKEND_SHAPE[1] + BACKEND_SHAPE[2]
    g = torch.Generator(device=pipe.device).manual_seed(seed)
    x = torch.randn((b, s, c.hidden_size), generator=g, device=pipe.device).to(c.dtype)
    cond = torch.randn((b, s, c.hidden_size), generator=g, device=pipe.device).to(c.dtype)
    t = torch.rand((b,), generator=g, device=pipe.device)
    pad = torch.ones((b, s), dtype=torch.int32, device=pipe.device)
    pad[1, 600:] = 0
    pad[7, 1:] = 0  # a dummy row
    _reset_row_kernel_counts()
    with torch.no_grad():
        got = pipe.s2a.denoiser(x, t, cond, pad).float()
        launched = _row_kernel_counts()
        want = pipe.s2a.denoiser(x, t, cond, pad, impl="plain").float()
    torch.cuda.synchronize()
    check(sum(launched.values()) > 0 and _row_kernel_counts() == launched,
          f"tts_backend_parity: the plain route launched a kernel, or the kernel route none "
          f"({launched} -> {_row_kernel_counts()})")
    valid = pad.bool()
    diff = (got - want).abs()[valid]
    check(bool(torch.isfinite(got[valid]).all().item()), "tts_backend_parity: output not finite")
    return float(diff.max().item()), float(diff.mean().item()), float(want[valid].abs().max().item())


def _norm_module_shapes(pipe):
    """``AdaptiveRMSNorm`` on the shapes the denoiser never gives it (x [B,D];
    a condition per position): the kernels again, never the plain versions."""
    norm = pipe.s2a.denoiser.final_norm
    h = pipe.s2a.cfg.hidden_size
    g = torch.Generator(device=pipe.device).manual_seed(14)
    kind = norm.to_weight.kernel.dtype
    worst = 0.0
    for x_shape, cond_shape in (((48, h), (48, h)), ((4, 37, h), (4, 37, h))):
        x = torch.randn(x_shape, generator=g, device=pipe.device).to(kind)
        cond = torch.randn(cond_shape, generator=g, device=pipe.device).to(kind)
        _reset_row_kernel_counts()
        with torch.no_grad():
            y, (q, sc) = norm(x, cond), norm(x, cond, quantize_out=True)
            launched = _row_kernel_counts()
            y_p, (q_p, sc_p) = norm(x, cond, impl="plain"), norm(x, cond, True, impl="plain")
        torch.cuda.synchronize()
        check(launched["ada_rmsnorm"] == 1 and launched["ada_rmsnorm_quantize"] == 1
              and _row_kernel_counts() == launched,
              f"tts_backend_parity: AdaptiveRMSNorm on x {x_shape} launched {launched}")
        err = float((y.float() - y_p.float()).abs().max().item())
        steps = int((q.int() - q_p.int()).abs().max().item())
        check(y.shape == x.shape and q.shape == x.shape and sc.shape == x.shape[:-1]
              and err <= TOL_NORM_MODULE and steps <= 1
              and torch.allclose(sc, sc_p, rtol=2.0 ** -7),
              f"tts_backend_parity: AdaptiveRMSNorm on x {x_shape} differs by {err}, {steps} steps")
        worst = max(worst, err)
    return worst


def phase_tts_backend_parity(pipe_int8, pipe_bf16):
    """The row kernels inside the denoiser and the sampler against their
    plain versions."""
    from maxtext_indextts2_tpu_torch.audio.pipeline import backend_requests, build_backend

    t0 = time.perf_counter()
    i8_max, i8_mean, i8_scale = _denoiser_parity(pipe_int8, 11)
    check(i8_max <= TOL_BACKEND_INT8_MAX and i8_mean <= TOL_BACKEND_INT8_MEAN,
          f"tts_backend_parity: int8_offline forward differs by max {i8_max}, mean {i8_mean}")
    bf_max, bf_mean, bf_scale = _denoiser_parity(pipe_bf16, 12)
    check(bf_max <= TOL_BACKEND_BF16_MODE,
          f"tts_backend_parity: bfloat16-mode forward differs by {bf_max}")

    norm_err = max(_norm_module_shapes(pipe_int8), _norm_module_shapes(pipe_bf16))

    # the dynamic int8 mode (float kernels quantized on every call), 2 layers
    dyn_max, dyn_mean, _ = _denoiser_parity(build_backend("int8", layers=2), 13)
    check(dyn_max <= TOL_BACKEND_INT8_MAX and dyn_mean <= TOL_BACKEND_INT8_MEAN,
          f"tts_backend_parity: int8 (dynamic) forward differs by max {dyn_max}, mean {dyn_mean}")

    # 2 layers, float32, full width: the whole call with the same injected noise
    pipe = build_backend("float32", layers=2, timesteps=(3,) + (2,) * 11)
    c = pipe.s2a.cfg
    requests, sems, acs, gens = backend_requests(
        3, 4, c.cond_codebook_size, c.codebook_size, c.num_quantizers, prompt=(40, 90),
        target=(60, 120))

    def noise(layer, step, draw, shape):
        g = torch.Generator(device=pipe.device).manual_seed(layer * 1000 + step * 10 + draw)
        return torch.rand(shape, generator=g, device=pipe.device) * (1.0 - 1e-9) + 1e-9

    runs = []
    for impl in (None, "plain"):
        out = pipe.s2a_vocoder_batch(requests, sems, acs, gens, length_bucket=64, noise=noise,
                                     impl=impl)
        codes = pipe._sample_codes(sems, acs, gens, None, 64, len(requests), noise, impl)
        runs.append((codes.cpu().numpy(), [w for w, _ in out]))
    valid = np.arange(runs[0][0].shape[1])[None, :] < np.array([len(g) for g in gens])[:, None]
    agree = float((runs[0][0] == runs[1][0])[valid].mean())
    check(agree >= MIN_BACKEND_F32_CODE_AGREEMENT,
          f"tts_backend_parity: float32 codes of the two routes agree only to {agree}")
    wav_err = None
    if agree == 1.0:
        peak = max(float(np.abs(w).max()) for w in runs[1][1])
        wav_err = max(float(np.abs(a - b).max()) for a, b in zip(*[r[1] for r in runs])) / peak
        check(wav_err <= TOL_BACKEND_F32_WAV,
              f"tts_backend_parity: float32 waveforms differ by {wav_err} of the peak")
    emit("tts_backend_parity", t0, int8_offline_max_abs_err=i8_max,
         int8_offline_mean_abs_err=i8_mean, int8_offline_max_abs=i8_scale,
         tol_int8_offline=[TOL_BACKEND_INT8_MAX, TOL_BACKEND_INT8_MEAN],
         int8_dynamic_2_layers_max_abs_err=dyn_max, int8_dynamic_2_layers_mean_abs_err=dyn_mean,
         bf16_mode_max_abs_err=bf_max, bf16_mode_mean_abs_err=bf_mean, bf16_mode_max_abs=bf_scale,
         tol_bf16_mode=TOL_BACKEND_BF16_MODE, norm_module_other_shapes_max_abs_err=norm_err,
         tol_norm_module=TOL_NORM_MODULE, f32_code_agreement=agree,
         f32_codes_compared=int(valid.sum()) * c.num_quantizers,
         tol_f32_code_agreement=MIN_BACKEND_F32_CODE_AGREEMENT,
         f32_wav_max_err_of_peak=wav_err, tol_f32_wav=TOL_BACKEND_F32_WAV)


def _k12_count() -> int:
    from maxtext_indextts2_tpu_torch.ops import s2a_attention

    return s2a_attention.launch_count


def _reset_all_counts():
    from maxtext_indextts2_tpu_torch.ops import (
        flash_attention, grouped_matmul, inplace_update, int8w_matmul, ragged_decode_attention,
        s2a_attention,
    )

    _reset_row_kernel_counts()
    for name in grouped_matmul.launch_counts:
        grouped_matmul.launch_counts[name] = 0
    int8w_matmul.launch_count = 0
    ragged_decode_attention.launch_count = inplace_update.launch_count = 0
    inplace_update.span_launch_counts.clear()
    ragged_decode_attention.paged_launch_count = 0
    s2a_attention.launch_count = 0
    for name in flash_attention.launch_counts:
        flash_attention.launch_counts[name] = 0


def _all_counts() -> dict:
    from maxtext_indextts2_tpu_torch.ops import (
        flash_attention, grouped_matmul, inplace_update, int8w_matmul, ragged_decode_attention,
    )

    return {"ragged_decode_attention": ragged_decode_attention.launch_count,
            "paged_decode_attention": ragged_decode_attention.paged_launch_count,
            "inplace_row_update": inplace_update.launch_count, **_row_kernel_counts(),
            "s2a_attention": _k12_count(), **flash_attention.launch_counts,
            "int8w_matmul": int8w_matmul.launch_count,
            "grouped_matmul_bf16": grouped_matmul.launch_counts["grouped_matmul"],
            "grouped_matmul_int8": grouped_matmul.launch_counts["grouped_matmul_int8"],
            "grouped_matmul_dgrad": grouped_matmul.launch_counts["grouped_matmul_dgrad"],
            "grouped_matmul_wgrad": grouped_matmul.launch_counts["grouped_matmul_wgrad"],
            **{k: grouped_matmul.launch_counts[k] for k in F32_GMM}}


# the float32 grouped kernels' counts
F32_GMM = ("grouped_matmul_f32", "grouped_matmul_f32_dgrad", "grouped_matmul_f32_wgrad")
NO_FLASH = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
NO_PAGED = {"paged_decode_attention": 0}
NO_INT8W = {"int8w_matmul": 0}
NO_GMM = {"grouped_matmul_bf16": 0, "grouped_matmul_int8": 0, "grouped_matmul_dgrad": 0,
          "grouped_matmul_wgrad": 0, **dict.fromkeys(F32_GMM, 0)}


def _audio_only_lm(pipe):
    """Zero the LM's output columns of every id that is not an audio token,
    so that greedy decoding with random weights emits audio tokens only. A
    tied unembedding has no columns of its own: its embedding rows are
    zeroed (their logits are 0 and their lookups too, which a random model
    does not mind)."""
    e2a = pipe.mapping.embedding_to_audio_array(pipe.cfg.vocab_size)
    not_audio = torch.from_numpy((e2a < 0) | (e2a >= pipe.mapping.codebook_size))
    model = pipe.engine.model
    with torch.no_grad():
        if model.logits_dense is None:
            model.token_embedder.embedding[not_audio.to(pipe.device)] = 0
        else:
            model.logits_dense.kernel[:, not_audio.to(pipe.device)] = 0


def phase_pipeline_load():
    from maxtext_indextts2_tpu_torch.audio.pipeline import build_pipeline

    t0 = time.perf_counter()
    pipe = build_pipeline("int8_offline")  # no device given: the GPU, or an error
    _audio_only_lm(pipe)
    torch.cuda.synchronize()
    enc = pipe.semantic_tokenizer.encoder_cfg
    emit("pipeline_load", t0, lm_params=sum(p.numel() for p in pipe.engine.model.parameters()),
         semantic_tokenizer_params=sum(p.numel() for p in pipe.semantic_tokenizer.parameters()),
         s2a_params=sum(p.numel() for p in pipe.s2a.parameters()),
         codec_params=sum(p.numel() for p in pipe.codec.parameters()),
         conformer=[enc.hidden_size, enc.num_heads, enc.intermediate_size, enc.conv_kernel_size,
                    enc.output_layer], slots=pipe.engine.num_slots,
         tf32={"cudnn": torch.backends.cudnn.allow_tf32,
               "matmul": torch.backends.cuda.matmul.allow_tf32})
    return pipe


def phase_tts_synthesize(pipe):
    """The main path of this slice: one request through ``synthesize``; its
    fixed-length sampler runs every denoiser attention through K12."""
    from maxtext_indextts2_tpu_torch.audio.pipeline import prompt_signal

    t0 = time.perf_counter()
    w16 = prompt_signal(40, SYNTH_PROMPT_SECONDS, 16_000)
    w24 = prompt_signal(40, SYNTH_PROMPT_SECONDS, 24_000)
    text = "A zero-shot voice reads this sentence aloud on the card."
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_all_counts()
    t1 = time.perf_counter()
    wav, info = pipe.synthesize(text, w16, w24, max_new_tokens=SYNTH_FRAMES)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t1
    launches = _all_counts()

    c = pipe.s2a.cfg
    forwards = _denoiser_forwards(pipe)
    hop = int(np.prod(pipe.codec.strides))
    check(info["semantic_tokens"] == SYNTH_FRAMES,
          f"tts_synthesize: {info['semantic_tokens']} frames for max_new_tokens={SYNTH_FRAMES}")
    check(wav.shape == (SYNTH_FRAMES * hop,) and bool(np.isfinite(wav).all())
          and float(wav.std()) > 0, f"tts_synthesize: a waveform of {wav.shape}, not finite "
                                    "or constant")
    want_k12 = c.num_layers * forwards
    check(launches["s2a_attention"] == want_k12,
          f"tts_synthesize: s2a_attention launched {launches['s2a_attention']} times, predicted "
          f"{want_k12} ({c.num_layers} layers x {forwards} denoiser forwards)")
    layers = pipe.engine.cfg.num_decoder_layers
    want = {"ragged_decode_attention": layers * (SYNTH_FRAMES - 1),
            "inplace_row_update": 2 * layers * (SYNTH_FRAMES - 1),
            "ada_rmsnorm": forwards, "row_quantize_int8": c.num_layers * forwards,
            "ada_rmsnorm_quantize": 2 * c.num_layers * forwards,
            "silu_mul_quantize": c.num_layers * forwards, "s2a_attention": want_k12,
            **NO_FLASH, **NO_PAGED, **NO_INT8W, **NO_GMM}
    check(launches == want, f"tts_synthesize: launches {launches} != predicted {want}")
    emit("tts_synthesize", t0, call_seconds=seconds, info=info, denoiser_forwards=forwards,
         prompt_seconds=SYNTH_PROMPT_SECONDS, launches=launches,
         peak_memory_bytes=torch.cuda.max_memory_allocated())
    return launches


def _k12_forward_parity(s2a, seed):
    """One conditional denoiser forward at the ``synthesize`` shape with every
    key valid, the kernel route against the plain route; in the kernel route
    each K12 output is also held against the plain version on the same
    q, k, v. Returns the forward's (max, mean) absolute difference, its
    largest output, the largest in-model K12 difference and K12's launches in
    the kernel route (the plain route must launch none)."""
    from maxtext_indextts2_tpu_torch.audio import s2a as s2a_mod
    from maxtext_indextts2_tpu_torch.ops.s2a_attention import s2a_attention_plain

    c = s2a.cfg
    s = 149 + SYNTH_FRAMES  # P + T of the synthesize phase
    device = s2a.mask_emb.device
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((1, s, c.hidden_size), generator=g, device=device).to(c.dtype)
    cond = torch.randn((1, s, c.hidden_size), generator=g, device=device).to(c.dtype)
    t = torch.rand((1,), generator=g, device=device)
    ones = torch.ones((1, s), dtype=torch.int32, device=device)
    kernel, in_model = s2a_mod.s2a_attention, []

    def compared(q, k, v, impl=None):
        o = kernel(q, k, v, impl=impl)
        if impl is None:
            err = (o.float() - s2a_attention_plain(q, k, v).float()).abs().max()
            in_model.append((float(err.item()), TOL_K12_IN_MODEL[q.dtype]))
        return o

    _reset_all_counts()
    s2a_mod.s2a_attention = compared
    try:
        with torch.no_grad():
            got = s2a.denoiser(x, t, cond, ones, all_valid=True).float()
            launched = _k12_count()
            want = s2a.denoiser(x, t, cond, ones, impl="plain", all_valid=True).float()
    finally:
        s2a_mod.s2a_attention = kernel
    torch.cuda.synchronize()
    check(launched == c.num_layers and _k12_count() == launched,
          f"tts_synthesize_parity: K12 launched {launched} times in the kernel route "
          f"(want {c.num_layers}), {_k12_count() - launched} in the plain route")
    check(len(in_model) == c.num_layers and all(e <= tol for e, tol in in_model),
          f"tts_synthesize_parity: K12 inside the model against its plain version: {in_model}")
    check(bool(torch.isfinite(got).all().item()), "tts_synthesize_parity: output not finite")
    diff = (got - want).abs()
    return (float(diff.max().item()), float(diff.mean().item()), float(want.abs().max().item()),
            max(e for e, _ in in_model), launched)


def phase_tts_synthesize_parity(pipe):
    """K12 inside full-width conditional denoiser forwards against the plain
    route, and the prompt tokenizers on the card against the CPU."""
    from maxtext_indextts2_tpu_torch.audio.pipeline import build_serving_s2a, s2a_config_from

    t0 = time.perf_counter()
    c = pipe.s2a.cfg
    err, mean, scale, k12_err, k12_kernel = _k12_forward_parity(pipe.s2a, 15)
    check(err <= TOL_SYNTH_INT8_MAX and mean <= TOL_SYNTH_INT8_MEAN,
          f"tts_synthesize_parity: int8_offline all_valid forward differs by max {err}, "
          f"mean {mean}")
    f32 = build_serving_s2a(s2a_config_from(pipe.cfg), "float32", device=pipe.device,
                            generator=torch.Generator(device=pipe.device).manual_seed(16))
    f32_err, f32_mean, f32_scale, f32_k12_err, _ = _k12_forward_parity(f32, 16)
    check(f32_err <= TOL_SYNTH_F32,
          f"tts_synthesize_parity: float32 all_valid forward differs by {f32_err}")
    del f32
    torch.cuda.empty_cache()

    # the prompt tokenizers: the same modules and wav on the card and the CPU
    import copy

    from maxtext_indextts2_tpu_torch.audio.pipeline import prompt_signal

    w16 = prompt_signal(41, SYNTH_PROMPT_SECONDS, 16_000)
    w24 = prompt_signal(41, SYNTH_PROMPT_SECONDS, 24_000)
    sem_gpu, _ = pipe.semantic_tokenizer.tokenize(w16[None])
    ac_gpu = pipe.codec.tokenize(torch.from_numpy(w24[None]).to(pipe.device))
    tok_cpu = copy.deepcopy(pipe.semantic_tokenizer).to("cpu")
    enc_cpu = copy.deepcopy(pipe.codec.encoder).to("cpu")
    quant_cpu = copy.deepcopy(pipe.codec.decoder.quantizer).to("cpu")
    with torch.no_grad():
        sem_cpu, _ = tok_cpu.tokenize(w16[None])
        _, ac_cpu = quant_cpu.quantize(enc_cpu(torch.from_numpy(w24[None])))
    check(sem_gpu.shape == sem_cpu.shape and ac_gpu.shape == ac_cpu.shape,
          "tts_synthesize_parity: frontend ids of different shapes on the card and the CPU")
    sem_share = float((sem_gpu.cpu() == sem_cpu).float().mean().item())
    ac_share = float((ac_gpu.cpu() == ac_cpu).float().mean().item())
    check(min(sem_share, ac_share) >= MIN_FRONTEND_ID_AGREEMENT,
          f"tts_synthesize_parity: frontend ids agree only {sem_share} / {ac_share}")
    emit("tts_synthesize_parity", t0, denoiser_shape=[1, 149 + SYNTH_FRAMES, c.hidden_size],
         int8_offline_max_abs_err=err, int8_offline_mean_abs_err=mean, int8_offline_max_abs=scale,
         tol_int8_offline=[TOL_SYNTH_INT8_MAX, TOL_SYNTH_INT8_MEAN],
         int8_offline_k12_in_model_max_abs_err=k12_err,
         f32_max_abs_err=f32_err, f32_mean_abs_err=f32_mean, f32_max_abs=f32_scale,
         tol_f32=TOL_SYNTH_F32, f32_k12_in_model_max_abs_err=f32_k12_err,
         tol_k12_in_model={str(k): v for k, v in TOL_K12_IN_MODEL.items()},
         k12_launches_kernel_route=k12_kernel,
         semantic_ids=int(sem_cpu.numel()), semantic_ids_equal_share=sem_share,
         acoustic_ids=int(ac_cpu.numel()), acoustic_ids_equal_share=ac_share,
         min_id_agreement=MIN_FRONTEND_ID_AGREEMENT,
         tf32_in_force={"cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
                        "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32})


def _tts_bodies(seed: int):
    """``tts_requests`` as JSON bodies: the first with float32 base64 both
    ways, the others with JSON lists."""
    from maxtext_indextts2_tpu_torch.audio.pipeline import tts_requests

    bodies, seconds = [], []
    for i, r in enumerate(tts_requests(seed, HTTP_REQUESTS)):
        w16, w24 = r.pop("prompt_wav_16k"), r.pop("prompt_wav_24k")
        seconds.append(len(w16) / 16_000.0)
        if i == 0:
            r.update(prompt_wav_16k_b64=base64.b64encode(w16.astype("<f4").tobytes()).decode(),
                     prompt_wav_24k_b64=base64.b64encode(w24.astype("<f4").tobytes()).decode(),
                     wav_encoding="b64")
        else:
            r.update(prompt_wav_16k=w16.tolist(), prompt_wav_24k=w24.tolist())
        bodies.append(r)
    return bodies, [r["max_new_tokens"] for r in bodies], seconds


def phase_tts_http(pipe):
    """8 concurrent ``POST /tts`` at full width through ``make_server``: the
    batched path (masked sampler), so K12 must not launch."""
    from maxtext_indextts2_tpu_torch.infer.server import make_server

    t0 = time.perf_counter()
    cfg = dataclasses.replace(pipe.cfg, tts_allow_force_frames=True,
                              tts_batch_max=HTTP_REQUESTS, tts_batch_window_ms=2000)
    bodies, frames, prompt_seconds = _tts_bodies(60)
    payloads = [json.dumps(b).encode() for b in bodies]
    server, orch, batcher = make_server(cfg, port=0, tts_pipeline=pipe, host="127.0.0.1")
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    answers = [None] * HTTP_REQUESTS

    def post(i):
        req = urllib.request.Request(f"http://127.0.0.1:{port}/tts", data=payloads[i],
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=900) as resp:
            answers[i] = json.loads(resp.read())

    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_all_counts()
        t1 = time.perf_counter()
        posts = [threading.Thread(target=post, args=(i,)) for i in range(HTTP_REQUESTS)]
        for p in posts:
            p.start()
        for p in posts:
            p.join(timeout=900)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t1
        launches = _all_counts()
        steps = orch.stats["decode_steps_total"]
    finally:
        server.shutdown()
        server.server_close()
        batcher.stop()
        orch.stop()
        thread.join(timeout=30)

    check(all(a is not None and "error" not in a for a in answers),
          f"tts_http: failed answers {[a for a in answers if a is None or 'error' in a][:1]}")
    hop = int(np.prod(pipe.codec.strides))
    for i, (a, n) in enumerate(zip(answers, frames)):
        wav = (np.frombuffer(base64.b64decode(a["wav_b64"]), "<f4") if i == 0
               else np.asarray(a["wav"], np.float32))
        check(a["info"]["semantic_tokens"] == n and wav.shape == (n * hop,),
              f"tts_http: request {i} got {wav.shape} samples for {n} frames")
        check(bool(np.isfinite(wav).all()) and float(wav.std()) > 0,
              f"tts_http: request {i}'s waveform is not finite or is constant")
    info = answers[0]["info"]
    forwards = _denoiser_forwards(pipe) * batcher.batches
    c, layers = pipe.s2a.cfg, pipe.engine.cfg.num_decoder_layers
    want = {"ragged_decode_attention": layers * steps, "inplace_row_update": 2 * layers * steps,
            "ada_rmsnorm": forwards, "row_quantize_int8": c.num_layers * forwards,
            "ada_rmsnorm_quantize": 2 * c.num_layers * forwards,
            "silu_mul_quantize": c.num_layers * forwards, "s2a_attention": 0, **NO_FLASH,
            **NO_PAGED, **NO_INT8W, **NO_GMM}
    check(launches == want, f"tts_http: launches {launches} != predicted {want} "
                            f"({steps} decode steps, {batcher.batches} batches)")
    audio = sum(n * hop for n in frames) / 24_000.0
    emit("tts_http", t0, requests=HTTP_REQUESTS, batches=batcher.batches, frames=frames,
         prompt_seconds=prompt_seconds, text_bytes=[len(b["text"]) for b in bodies],
         http_seconds=seconds, audio_seconds=audio, t_frontend=info["t_frontend"],
         t_lm=info["t_lm"], t_s2a=info["t_s2a"], t_vocoder=info["t_vocoder"],
         t_total=info["t_total"], batch_rtf=info["batch_rtf"], decode_steps=steps,
         launches=launches, peak_memory_bytes=torch.cuda.max_memory_allocated())


def phase_train():
    """The main path of this slice: the tts-1b recipe at full width through
    the training entry point; K9-K11 launch counts a step, losses, memory."""
    from maxtext_indextts2_tpu_torch.config import load_config
    from maxtext_indextts2_tpu_torch.models import Transformer
    from maxtext_indextts2_tpu_torch.train import train
    from maxtext_indextts2_tpu_torch.utils import flops

    t0 = time.perf_counter()
    cfg = load_config(TRAIN_ARGS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_all_counts()
    out = train.main(list(TRAIN_ARGS))  # no device given: the GPU, or an error
    torch.cuda.synchronize()
    launches = _all_counts()
    peak = torch.cuda.max_memory_allocated()
    hist = out["history"]
    losses = [h["loss"] for h in hist]
    check(len(hist) == TRAIN_STEPS and all(np.isfinite(losses)),
          f"train: losses {losses} over {len(hist)} of {TRAIN_STEPS} steps")
    check(losses[-1] < losses[0], f"train: the loss did not fall: {losses}")
    check(all(np.isfinite(h["grad_norm"]) for h in hist), "train: a grad norm is not finite")
    layers = cfg.num_decoder_layers
    want = {k: 0 for k in _all_counts()}
    want.update({k: n * layers * TRAIN_STEPS for k, n in TRAIN_LAUNCHES_PER_LAYER.items()})
    check(launches == want, f"train: launches {launches} != predicted {want} "
                            f"({TRAIN_STEPS} steps x {layers} layers)")
    check(peak < TRAIN_MAX_PEAK_BYTES, f"train: peak memory {peak / 1e9:.1f} GB")
    steady = hist[1:]  # the first step pays for the allocator's warm-up
    step_s = float(np.median([h["step_time_s"] for h in steady]))
    tflops = flops.training_tflops_per_step(cfg)
    emit("train", t0, steps=TRAIN_STEPS, losses=losses,
         grad_norms=[h["grad_norm"] for h in hist], param_norm=hist[-1]["param_norm"],
         step_seconds=[h["step_time_s"] for h in hist], median_step_seconds=step_s,
         tokens_per_step=cfg.global_batch_size_to_train_on * cfg.max_target_length,
         tokens_per_s=cfg.global_batch_size_to_train_on * cfg.max_target_length / step_s,
         tflops_per_step=tflops, mfu_at_989_tflops=flops.mfu(tflops, step_s),
         launches=launches, launches_per_step={k: v / TRAIN_STEPS for k, v in launches.items()},
         params=sum(p.numel() for p in Transformer(cfg, device="meta").parameters()),
         peak_memory_bytes=peak)
    fields = dict(median_step_seconds=step_s, mfu_at_989_tflops=flops.mfu(tflops, step_s),
                  peak_memory_bytes=peak)
    return {k: launches[k] for k in TRAIN_LAUNCHES_PER_LAYER}, fields


def phase_train_parity():
    """One 2-layer float32 step at full width: the kernel route against the
    plain route (the materialised flash-attention versions) from one set of
    seeded weights and one batch: loss, grad norm, every gradient. Returns
    the kernel route's loss."""
    return _lm_parity("train_parity", TRAIN_ARGS, time.perf_counter())


def _median_step_seconds(hist) -> float:
    steady = hist[1:] or hist  # the first step pays for the allocator's warm-up
    return float(np.median([h["step_time_s"] for h in steady]))


def _train_launches_want(layers: int, steps: int, eval_forwards: int = 0) -> dict:
    want = {k: 0 for k in _all_counts()}
    want.update({k: n * layers * steps for k, n in TRAIN_LAUNCHES_PER_LAYER.items()})
    want["flash_fwd"] += layers * eval_forwards
    return want


def phase_train_packed(tmp):
    """The train recipe on packed emilia_audio rows through the training
    entry point, then the emilia eval iterator; K9-K11 counts against the
    code's prediction, the iterator's host ms a batch, documents a row."""
    from maxtext_indextts2_tpu_torch.config import load_config
    from maxtext_indextts2_tpu_torch.train import train
    from maxtext_indextts2_tpu_torch.utils import flops

    t0 = time.perf_counter()
    metrics_file = os.path.join(tmp, "train_packed.jsonl")
    args = TRAIN_PACKED_ARGS + [f"metrics_file={metrics_file}"]
    cfg = load_config(args)
    # the host side alone: the iterator's ms a batch, documents and real tokens a row
    host = train.make_host_iterator(cfg)
    times, docs, real = [], [], []
    for _ in range(HOST_BATCHES_TIMED):
        t_b = time.perf_counter()
        b = next(host)
        times.append((time.perf_counter() - t_b) * 1e3)
        docs += [int(r.max()) for r in b["inputs_segmentation"]]
        real.append(float((b["inputs_segmentation"] > 0).mean()))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_all_counts()
    out = train.main(list(args))  # no device given: the GPU, or an error
    torch.cuda.synchronize()
    launches = _all_counts()
    peak = torch.cuda.max_memory_allocated()
    hist = out["history"]
    losses = [h["loss"] for h in hist]
    with open(metrics_file) as fh:
        evals = [r["eval_loss"] for r in map(json.loads, fh) if "eval_loss" in r]
    check(len(hist) == TRAIN_STEPS and all(np.isfinite(losses)),
          f"train_packed: losses {losses} over {len(hist)} of {TRAIN_STEPS} steps")
    check(len(evals) == 1 and np.isfinite(evals[0]), f"train_packed: eval losses {evals}")
    want = _train_launches_want(cfg.num_decoder_layers, TRAIN_STEPS, cfg.eval_steps)
    check(launches == want, f"train_packed: launches {launches} != predicted {want}")
    check(peak < TRAIN_MAX_PEAK_BYTES, f"train_packed: peak memory {peak / 1e9:.1f} GB")
    step_s = _median_step_seconds(hist)
    tokens = cfg.global_batch_size_to_train_on * cfg.max_target_length
    tflops = flops.training_tflops_per_step(cfg)
    emit("train_packed", t0, steps=TRAIN_STEPS, losses=losses, eval_loss=evals[0],
         eval_batches=cfg.eval_steps, grad_norms=[h["grad_norm"] for h in hist],
         step_seconds=[h["step_time_s"] for h in hist], median_step_seconds=step_s,
         tokens_per_step=tokens, tokens_per_s=tokens / step_s,
         real_token_share=float(np.mean(real)),
         real_tokens_per_s=float(np.mean(real)) * tokens / step_s, tflops_per_step=tflops,
         mfu_at_989_tflops=flops.mfu(tflops, step_s),
         host_ms_a_batch_median=float(np.median(times)), host_ms_a_batch=times,
         documents_a_row_mean=float(np.mean(docs)), documents_a_row=sorted(set(docs)),
         launches=launches, launches_predicted=want, peak_memory_bytes=peak)
    return {k: launches[k] for k in TRAIN_LAUNCHES_PER_LAYER}


def _lm_parity(phase, extra_args, t0):
    """One 2-layer float32 step at full width, kernel route against plain
    route, from one set of seeded weights and one batch of the config's data."""
    from maxtext_indextts2_tpu_torch.config import load_config
    from maxtext_indextts2_tpu_torch.train import train

    cfg = load_config(extra_args + ["base_num_decoder_layers=2", "weight_dtype=float32",
                                    "dtype=float32"])
    state = train.setup_train_state(cfg)
    batch = next(train.create_data_iterator(cfg, state.device))
    names, leaves = list(state.params), list(state.params.values())
    out = {}
    for impl in (None, "plain"):
        _reset_all_counts()
        loss, _ = train.loss_fn(state.model, cfg, batch, impl=impl)
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        out[impl] = (float(loss.detach()), grads, float(train._global_norm(grads)),
                     dict(_all_counts()))
    (loss_k, g_k, norm_k, n_k), (loss_p, g_p, norm_p, n_p) = out[None], out["plain"]
    want = {"flash_fwd": 2 * cfg.num_decoder_layers, "flash_bwd_dq": cfg.num_decoder_layers,
            "flash_bwd_dkv": cfg.num_decoder_layers}
    check({k: n_k[k] for k in want} == want and not any(n_p[k] for k in want),
          f"{phase}: kernel route launched {n_k}, plain route {n_p}")
    rel = {name: float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
           for name, a, b in zip(names, g_k, g_p)}
    worst = max(rel, key=rel.get)
    check(all(np.isfinite([loss_k, norm_k])), f"{phase}: loss or grad norm not finite")
    check(abs(loss_k - loss_p) <= TOL_TRAIN_LOSS,
          f"{phase}: loss {loss_k} (kernels) vs {loss_p} (plain)")
    check(abs(norm_k - norm_p) <= TOL_TRAIN_GRAD_NORM_REL * norm_p,
          f"{phase}: grad norm {norm_k} (kernels) vs {norm_p} (plain)")
    check(rel[worst] <= TOL_TRAIN_GRAD_REL,
          f"{phase}: gradient {worst} differs by {rel[worst]:.3g} of its largest entry")
    seg = batch["inputs_segmentation"]
    emit(phase, t0, layers=cfg.num_decoder_layers, loss_kernels=loss_k,
         loss_plain=loss_p, grad_norm_kernels=norm_k, grad_norm_plain=norm_p,
         worst_grad=worst, worst_grad_rel_err=rel[worst], tol_grad_rel=TOL_TRAIN_GRAD_REL,
         grads_compared=len(rel), launches_kernel_route={k: n_k[k] for k in want},
         documents_a_row=[int(r.max()) for r in seg], padding_tokens=int((seg == 0).sum()))
    return loss_k


def phase_train_packed_parity():
    """train_parity on one packed emilia_audio batch: segment ids and
    restarted positions through K9-K11 against the plain versions."""
    _lm_parity("train_packed_parity", TRAIN_PACKED_ARGS, time.perf_counter())


def phase_train_c4(tmp):
    """c4_mlperf over a .jsonl written here (byte tokenizer), through the
    training entry point; depth cut to TRAIN_C4_LAYERS layers."""
    from maxtext_indextts2_tpu_torch.config import load_config
    from maxtext_indextts2_tpu_torch.ops.smoke import C4_DOCUMENTS, write_c4_documents
    from maxtext_indextts2_tpu_torch.train import train

    t0 = time.perf_counter()
    path = os.path.join(tmp, "c4.jsonl")
    write_c4_documents(path)  # the documents of the flash_bf16_c4_mlperf cases
    args = [a for a in TRAIN_ARGS if not a.startswith(("dataset_type=", "steps="))] + [
        "dataset_type=c4_mlperf", f"dataset_path={path}", f"steps={TRAIN_C4_STEPS}",
        f"base_num_decoder_layers={TRAIN_C4_LAYERS}"]
    cfg = load_config(args)
    first = next(train.make_host_iterator(cfg))
    _reset_all_counts()
    out = train.main(list(args))
    torch.cuda.synchronize()
    launches = _all_counts()
    losses = [h["loss"] for h in out["history"]]
    check(len(losses) == TRAIN_C4_STEPS and all(np.isfinite(losses)),
          f"train_c4: losses {losses}")
    want = _train_launches_want(TRAIN_C4_LAYERS, TRAIN_C4_STEPS)
    check(launches == want, f"train_c4: launches {launches} != predicted {want}")
    check(bool((first["inputs"][:, :-1] > 0).all()), "train_c4: a row is not a full segment")
    emit("train_c4", t0, steps=TRAIN_C4_STEPS, layers=TRAIN_C4_LAYERS, losses=losses,
         documents=C4_DOCUMENTS, file_bytes=os.path.getsize(path),
         loss_weight_share=float((first["targets_segmentation"] > 0).mean()),
         step_seconds=[h["step_time_s"] for h in out["history"]], launches=launches)
    return launches


def phase_s2a_train(route: str):
    """The S2A trainer at the published widths through its entry point, on
    the materialised attention or (``route="seq_flash"``) with
    MTT_S2A_SEQ_FLASH=1; K5 and K9-K11 counts against the prediction."""
    from maxtext_indextts2_tpu_torch.audio.s2a import S2AModel
    from maxtext_indextts2_tpu_torch.config import load_config
    from maxtext_indextts2_tpu_torch.train import s2a_train

    t0 = time.perf_counter()
    cfg = load_config(S2A_TRAIN_ARGS)
    scfg = s2a_train.s2a_config_from(cfg)
    params = sum(p.numel() for p in S2AModel(scfg, device="meta").parameters())
    check(params == S2A_PARAMS, f"s2a_train: {params} parameters, not {S2A_PARAMS}")
    flash = route == "seq_flash"
    if flash:
        os.environ["MTT_S2A_SEQ_FLASH"] = "1"
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_all_counts()
        out = s2a_train.main(list(S2A_TRAIN_ARGS))  # no device given: the GPU, or an error
        torch.cuda.synchronize()
    finally:
        os.environ.pop("MTT_S2A_SEQ_FLASH", None)
    launches = _all_counts()
    peak = torch.cuda.max_memory_allocated()
    hist = out["history"]
    losses = [h["loss"] for h in hist]
    check(len(hist) == S2A_TRAIN_STEPS and all(np.isfinite(losses)),
          f"s2a_train ({route}): losses {losses}")
    forward = scfg.num_layers * 2 + 1
    want = {k: 0 for k in launches}
    want["ada_rmsnorm"] = forward * S2A_TRAIN_STEPS
    if flash:
        for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            want[k] = scfg.num_layers * S2A_TRAIN_STEPS
    check(launches == want, f"s2a_train ({route}): launches {launches} != predicted {want}")
    check(peak < S2A_MAX_PEAK_BYTES, f"s2a_train: peak memory {peak / 1e9:.1f} GB")
    step_s = _median_step_seconds(hist)
    frames = cfg.global_batch_size_to_train_on * min(cfg.max_target_length, 512)
    emit("s2a_train", t0, route=route, steps=S2A_TRAIN_STEPS, params=params,
         batch=[cfg.global_batch_size_to_train_on, min(cfg.max_target_length, 512)],
         losses=losses, mask_layers=[int(h["mask_layer"]) for h in hist],
         step_seconds=[h["step_time_s"] for h in hist], median_step_seconds=step_s,
         frames_per_s=frames / step_s, launches=launches, launches_predicted=want,
         launches_per_step={k: v / S2A_TRAIN_STEPS for k, v in launches.items() if v},
         peak_memory_bytes=peak)
    return {k: launches[k] for k in ("ada_rmsnorm", "flash_fwd", "flash_bwd_dq",
                                     "flash_bwd_dkv")}


def phase_s2a_train_parity():
    """2 float32 layers of the S2A at full width, one batch and one set of
    draws: loss and every gradient through K5 (and on the flash route
    K9-K11) against the plain versions; the two routes' losses."""
    from maxtext_indextts2_tpu_torch.audio.s2a import draw_s2a_noise
    from maxtext_indextts2_tpu_torch.config import load_config
    from maxtext_indextts2_tpu_torch.train import s2a_train

    t0 = time.perf_counter()
    cfg = load_config(S2A_TRAIN_ARGS + ["dtype=float32", "s2a_num_layers=2"])
    state = s2a_train.setup_s2a_state(cfg)
    raw = s2a_train.synthetic_s2a_batch(cfg, 0)
    for row, pad in enumerate(S2A_PARITY_PAD):  # padding tails: segment 0 on the flash route
        raw["mask"][row, -pad:] = 0
    batch = s2a_train.batch_to_device(raw, state.device)
    b, tlen = raw["semantic"].shape
    noise = draw_s2a_noise(state.model.cfg, b, tlen, torch.Generator().manual_seed(11))
    layers = state.model.cfg.num_layers
    results, routes = {}, {}
    for flash in (False, True):
        out = {}
        for impl in (None, "plain"):
            _reset_all_counts()
            loss, _, grads = s2a_train.s2a_loss_and_grads(state, batch, noise, impl,
                                                          seq_flash=flash)
            torch.cuda.synchronize()
            out[impl] = (float(loss), grads, dict(_all_counts()))
        (loss_k, g_k, n_k), (loss_p, g_p, n_p) = out[None], out["plain"]
        route = "seq_flash" if flash else "materialised"
        want = {"ada_rmsnorm": 2 * layers + 1, "flash_fwd": layers * flash,
                "flash_bwd_dq": layers * flash, "flash_bwd_dkv": layers * flash}
        check({k: n_k[k] for k in want} == want and not any(n_p.values()),
              f"s2a_train_parity ({route}): kernel route launched {n_k}, plain route {n_p}")
        rel = {name: float((g_k[name] - g_p[name]).abs().max()
                           / g_p[name].abs().max().clamp(min=1e-30)) for name in g_p}
        worst = max(rel, key=rel.get)
        finite = all(bool(torch.isfinite(g).all()) for g in g_k.values())
        check(finite and np.isfinite(loss_k), f"s2a_train_parity ({route}): not finite")
        check(abs(loss_k - loss_p) <= TOL_TRAIN_LOSS,
              f"s2a_train_parity ({route}): loss {loss_k} (kernels) vs {loss_p} (plain)")
        check(rel[worst] <= TOL_TRAIN_GRAD_REL,
              f"s2a_train_parity ({route}): gradient {worst} off by {rel[worst]:.3g}")
        results[route] = loss_k
        routes[route] = dict(loss_kernels=loss_k, loss_plain=loss_p, worst_grad=worst,
                             worst_grad_rel_err=rel[worst], grads_compared=len(rel),
                             launches_kernel_route={k: n_k[k] for k in want})
    gap = abs(results["seq_flash"] - results["materialised"])
    check(gap <= TOL_TRAIN_LOSS, f"s2a_train_parity: routes' losses {results}")
    emit("s2a_train_parity", t0, layers=layers, mask_layer=noise.mask_layer,
         padding_tails=list(S2A_PARITY_PAD), routes=routes, routes_loss_gap=gap,
         tol_loss=TOL_TRAIN_LOSS, tol_grad_rel=TOL_TRAIN_GRAD_REL)


def phase_s2a_seq_flash_serving():
    """One int8_offline denoiser forward of the masked serving pass at full
    width, the materialised route against MTT_S2A_SEQ_FLASH=1: valid rows
    against each other, device time of each (torch.profiler), launches."""
    from maxtext_indextts2_tpu_torch.audio.pipeline import build_serving_s2a
    from maxtext_indextts2_tpu_torch.audio.s2a import S2AConfig
    from maxtext_indextts2_tpu_torch.infer.engine import resolve_device
    from maxtext_indextts2_tpu_torch.ops.smoke import serving_pad_mask
    from maxtext_indextts2_tpu_torch.tools.profile_s2a import profiled

    t0 = time.perf_counter()
    dev = resolve_device(None)  # the GPU, or an error
    model = build_serving_s2a(S2AConfig(), "int8_offline", device=dev,
                              generator=torch.Generator(device=dev).manual_seed(0))
    c = model.cfg
    rows, p_pad, t_pad = BACKEND_SHAPE
    mask = serving_pad_mask(rows, p_pad, t_pad, dev)  # the flash_bf16_s2a_serving cases' mask
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((rows, p_pad + t_pad, c.hidden_size), generator=g, device=dev).to(c.dtype)
    cond = torch.randn(x.shape, generator=g, device=dev).to(c.dtype)
    t = torch.full((rows,), 0.5, device=dev)
    outs, profiles, counts = {}, {}, {}
    for route in ("materialised", "seq_flash"):
        if route == "seq_flash":
            os.environ["MTT_S2A_SEQ_FLASH"] = "1"
        try:
            with torch.no_grad():
                _reset_all_counts()
                outs[route] = model.denoiser(x, t, cond, mask).float()
                torch.cuda.synchronize()
                counts[route] = {k: v for k, v in _all_counts().items() if v}
                prof = profiled(lambda: model.denoiser(x, t, cond, mask), route, "", repeats=3)
        finally:
            os.environ.pop("MTT_S2A_SEQ_FLASH", None)
        profiles[route] = {k: prof[k] for k in ("ms_host_clock", "device_busy_ms",
                                                "device_idle_share", "device_launches")}
    valid = mask > 0
    diff = (outs["seq_flash"] - outs["materialised"]).abs()[valid]
    err_max, err_mean = float(diff.max()), float(diff.mean())
    scale = float(outs["materialised"][valid].abs().mean())
    check(all(bool(torch.isfinite(o[valid]).all()) for o in outs.values()),
          "s2a_seq_flash_serving: a valid row is not finite")
    check(counts["seq_flash"].get("flash_fwd") == c.num_layers
          and not counts["materialised"].get("flash_fwd"),
          f"s2a_seq_flash_serving: launches {counts}")
    check(err_max <= TOL_SEQ_FLASH_SERVING_MAX and err_mean <= TOL_SEQ_FLASH_SERVING_MEAN,
          f"s2a_seq_flash_serving: valid rows differ by {err_max} (mean {err_mean})")
    emit("s2a_seq_flash_serving", t0, shape=list(x.shape), valid_share=float(valid.float().mean()),
         max_abs_err=err_max, mean_abs_err=err_mean, mean_abs_output=scale,
         tol=[TOL_SEQ_FLASH_SERVING_MAX, TOL_SEQ_FLASH_SERVING_MEAN], routes=profiles,
         launches=counts)
    return counts["seq_flash"]


def _codec_run(target: str, args: list[str]):
    """codec_train.main on the card (no device given: the GPU, or an error):
    (its output, the kernels' launches, the peak memory)."""
    from maxtext_indextts2_tpu_torch.train import codec_train

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_all_counts()
    out = codec_train.main([f"codec_target={target}", *args])
    torch.cuda.synchronize()
    return out, _all_counts(), torch.cuda.max_memory_allocated()


def _check_codec_run(phase, out, launches, peak, steps):
    losses = [h["loss"] for h in out["history"]]
    check(len(losses) == steps and all(np.isfinite(losses)), f"{phase}: losses {losses}")
    check(not any(launches.values()), f"{phase}: a kernel of the repository ran: {launches}")
    check(peak < CODEC_MAX_PEAK_BYTES, f"{phase}: peak memory {peak / 1e9:.1f} GB")
    return losses, _median_step_seconds(out["history"])


def phase_codec_train():
    """The acoustic codec trainer at its published widths through its entry
    point: finite losses, one re-seed of dead codes, distinct codes a layer
    before and after it, audio seconds trained a second, no repo kernel."""
    from maxtext_indextts2_tpu_torch.audio.acoustic import AcousticCodec
    from maxtext_indextts2_tpu_torch.config import load_config
    from maxtext_indextts2_tpu_torch.train import codec_train

    t0 = time.perf_counter()
    args = CODEC_TRAIN_ARGS + [f"steps={CODEC_TRAIN_STEPS}"]
    cfg = load_config(args)
    params = sum(p.numel() for p in AcousticCodec(device="meta").parameters())
    check(params == CODEC_PARAMS, f"codec_train: {params} parameters, not {CODEC_PARAMS}")
    out, launches, peak = _codec_run("acoustic", args)
    losses, step_s = _check_codec_run("codec_train", out, launches, peak, CODEC_TRAIN_STEPS)
    reseeds, distinct, period = out["reseeds"], out["distinct_codes"], codec_train.RESEED_PERIOD
    check([r["step"] for r in reseeds] == [period - 1],
          f"codec_train: re-seeds {reseeds}, one after step {period} expected")
    rows = cfg.global_batch_size_to_train_on
    samples = int(24000 * codec_train.SECONDS) // 480 * 480
    emit("codec_train", t0, steps=CODEC_TRAIN_STEPS, params=params, batch=[rows, samples],
         quantizer_dropout=cfg.codec_quantizer_dropout, losses=losses,
         mel_l1=[h["mel_l1"] for h in out["history"]],
         step_seconds=[h["step_time_s"] for h in out["history"]], median_step_seconds=step_s,
         audio_seconds_per_step=rows * samples / 24000,
         audio_seconds_per_s=rows * samples / 24000 / step_s, reseeds=reseeds,
         distinct_codes_before_reseed=distinct[period - 1],
         distinct_codes_after_reseed=distinct[period],
         distinct_codes_last=distinct[-1], launches=launches, peak_memory_bytes=peak)


def phase_codec_train_repcodec():
    """The RepCodec trainer through its entry point, as the JAX trainer builds
    the model: finite losses, frames trained a second, no repo kernel."""
    from maxtext_indextts2_tpu_torch.audio.repcodec import RepCodec
    from maxtext_indextts2_tpu_torch.config import load_config
    from maxtext_indextts2_tpu_torch.train import codec_train

    t0 = time.perf_counter()
    args = ["per_device_batch_size=16", f"steps={REPCODEC_TRAIN_STEPS}"]
    cfg = load_config(args)
    params = sum(p.numel() for p in RepCodec(
        hidden_size=cfg.s2a_hidden_size, codebook_size=cfg.semantic_codebook_size,
        vocos_num_layers=4, device="meta").parameters())
    check(params == REPCODEC_TRAIN_PARAMS,
          f"codec_train_repcodec: {params} parameters, not {REPCODEC_TRAIN_PARAMS}")
    out, launches, peak = _codec_run("repcodec", args)
    losses, step_s = _check_codec_run("codec_train_repcodec", out, launches, peak,
                                      REPCODEC_TRAIN_STEPS)
    frames = cfg.global_batch_size_to_train_on * codec_train.REPCODEC_FRAMES
    emit("codec_train_repcodec", t0, steps=REPCODEC_TRAIN_STEPS, params=params,
         batch=[cfg.global_batch_size_to_train_on, codec_train.REPCODEC_FRAMES,
                cfg.s2a_hidden_size], losses=losses,
         rec_mse=[h["rec_mse"] for h in out["history"]],
         step_seconds=[h["step_time_s"] for h in out["history"]], median_step_seconds=step_s,
         frames_per_s=frames / step_s, launches=launches, peak_memory_bytes=peak)


def _max_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.cpu(), want.cpu()
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))


def phase_codec_train_parity():
    """One codec step at full width (2 Vocos layers), the card against the
    CPU through the port: loss, every gradient, the RVQ indices; then an EMA
    VectorQuantize's k-means init and training calls on the card's latents."""
    from maxtext_indextts2_tpu_torch.audio.quantize_extended import (
        VectorQuantize, draw_sample_indices,
    )
    from maxtext_indextts2_tpu_torch.config import load_config
    from maxtext_indextts2_tpu_torch.infer.engine import resolve_device
    from maxtext_indextts2_tpu_torch.train import codec_train

    t0 = time.perf_counter()
    card = resolve_device(None)
    cfg = load_config(CODEC_TRAIN_ARGS + [f"per_device_batch_size={CODEC_PARITY_ROWS}"])
    kw = {"vocos_num_layers": CODEC_PARITY_VOCOS_LAYERS}
    codecs = {dev: codec_train.build_acoustic_codec(cfg, kw, device=d)
              for dev, d in (("cuda", card), ("cpu", "cpu"))}
    codecs["cpu"].load_state_dict(codecs["cuda"].state_dict())
    wav = torch.from_numpy(codec_train.acoustic_batch(cfg, 0, 480)["wav"])
    draw = codecs["cpu"].decoder.quantizer.draw_dropout(CODEC_PARITY_ROWS,
                                                        torch.Generator().manual_seed(5))
    # the step in stages, each fed the card's input, so that an argmax near a
    # tie cannot take another code on one side: the encoder; the quantizer,
    # decoder and loss on the card's latents; the encoder's backward of the
    # card's latent gradient. By the chain rule the stages are the step.
    res, lat_card, g_lat_card = {}, None, None
    for dev, codec in codecs.items():
        _reset_all_counts()
        device = next(codec.parameters()).device
        x, d = wav.to(device), draw.to(device)
        enc, dec = list(codec.encoder.parameters()), list(codec.decoder.parameters())
        lat = codec.encoder(x)
        lat_card = lat.detach() if lat_card is None else lat_card
        leaf = lat_card.to(device).requires_grad_(True)
        loss, aux = codec_train.acoustic_loss(codec, x, d, latents=leaf)
        *g_dec, g_lat = torch.autograd.grad(loss, dec + [leaf])
        g_lat_card = g_lat if g_lat_card is None else g_lat_card
        g_enc = torch.autograd.grad(lat, enc, grad_outputs=g_lat_card.to(device))
        with torch.no_grad():  # the whole step from the waveform, for its loss and codes
            whole, whole_aux = codec_train.acoustic_loss(codec, x, d)
        res[dev] = dict(loss=float(loss.detach()), lat=lat.detach(), grads=[*g_enc, *g_dec, g_lat],
                        idx=aux["_indices"].cpu(), whole=float(whole),
                        whole_idx=whole_aux["_indices"].cpu(), launches=dict(_all_counts()))
    c, p = res["cuda"], res["cpu"]
    names = ([f"encoder.{n}" for n, _ in codecs["cpu"].encoder.named_parameters()]
             + [f"decoder.{n}" for n, _ in codecs["cpu"].decoder.named_parameters()]
             + ["latents"])
    rel = {n: _max_rel(a, b) for n, a, b in zip(names, c["grads"], p["grads"])}
    worst = max(rel, key=rel.get)
    lat_rel = _max_rel(c["lat"], p["lat"])
    flipped = int((c["idx"] != p["idx"]).sum())
    whole_flipped = int((c["whole_idx"] != p["whole_idx"]).sum())
    loss_rel = abs(c["loss"] - p["loss"]) / abs(p["loss"])
    whole_rel = abs(c["whole"] - p["whole"]) / abs(p["whole"])
    check(np.isfinite(c["loss"]) and not any(c["launches"].values()),
          f"codec_train_parity: loss {c['loss']}, launches {c['launches']}")
    check(lat_rel <= TOL_CODEC_LATENT_REL,
          f"codec_train_parity: encoder latents off by {lat_rel:.3g} of their largest entry")
    check(loss_rel <= TOL_CODEC_LOSS_REL and whole_rel <= TOL_CODEC_LOSS_REL,
          f"codec_train_parity: loss {c['loss']} / {c['whole']} (card) vs "
          f"{p['loss']} / {p['whole']} (CPU)")
    check(rel[worst] <= TOL_CODEC_GRAD_REL,
          f"codec_train_parity: gradient {worst} off by {rel[worst]:.3g} of its largest entry")
    check(flipped == 0, f"codec_train_parity: {flipped} of {p['idx'].numel()} RVQ indices differ")

    # EMA VectorQuantize on the card's encoder latents, the same draws both sides
    vq = {"cuda": VectorQuantize(codecs["cuda"].latent_dim, EMA_VQ_SIZE, EMA_VQ_DIM,
                                 kmeans_init=True, device=card,
                                 generator=torch.Generator(card).manual_seed(3))}
    vq["cpu"] = VectorQuantize(codecs["cuda"].latent_dim, EMA_VQ_SIZE, EMA_VQ_DIM,
                               kmeans_init=True, device="cpu")
    vq["cpu"].load_state_dict(vq["cuda"].state_dict())
    big = load_config(CODEC_TRAIN_ARGS + [f"per_device_batch_size={EMA_VQ_ROWS}"])
    vq_flips, vq_rel, expired = [], [], []
    for call in range(EMA_VQ_CALLS):
        with torch.no_grad():
            lat = codecs["cuda"].encoder(torch.from_numpy(
                codec_train.acoustic_batch(big, call, 480)["wav"]).to(card))
        n = lat.shape[0] * lat.shape[1]
        gen = torch.Generator().manual_seed(100 + call)
        draws = dict(init_idx=draw_sample_indices(n, EMA_VQ_SIZE, gen),
                     expire_idx=draw_sample_indices(n, EMA_VQ_SIZE, gen))
        out = {dev: m(lat.to(m.codebook.embed.device), train=True, **draws)
               for dev, m in vq.items()}
        vq_flips.append(int((out["cuda"].indices.cpu() != out["cpu"].indices).sum()))
        state = {dev: dict(m.codebook.named_buffers()) for dev, m in vq.items()}
        vq_rel.append({k: _max_rel(state["cuda"][k].float(), state["cpu"][k].float())
                       for k in ("cluster_size", "embed", "embed_avg")})
        expired.append(int((state["cpu"]["cluster_size"] < 2.0).sum()))
        check(int(state["cuda"]["step"]) == call + 1 and bool(state["cuda"]["initted"]),
              f"codec_train_parity: EMA codebook step {int(state['cuda']['step'])}")
    worst_vq = max(max(r.values()) for r in vq_rel)
    check(not any(vq_flips), f"codec_train_parity: EMA VQ indices differ: {vq_flips}")
    check(worst_vq <= TOL_EMA_VQ_REL, f"codec_train_parity: EMA VQ state off by {vq_rel}")
    emit("codec_train_parity", t0, rows=CODEC_PARITY_ROWS, vocos_layers=CODEC_PARITY_VOCOS_LAYERS,
         dropout_draw=draw.tolist(), latents_rel_err=lat_rel, tol_latents_rel=TOL_CODEC_LATENT_REL,
         loss_card=c["loss"], loss_cpu=p["loss"], loss_rel_err=loss_rel,
         whole_step_loss_card=c["whole"], whole_step_loss_cpu=p["whole"],
         whole_step_loss_rel_err=whole_rel, tol_loss_rel=TOL_CODEC_LOSS_REL,
         whole_step_rvq_indices_differing=whole_flipped,
         worst_grad=worst, worst_grad_rel_err=rel[worst], tol_grad_rel=TOL_CODEC_GRAD_REL,
         grads_compared=len(rel), rvq_indices_compared=p["idx"].numel(),
         rvq_indices_differing=flipped,
         ema_vq=dict(codebook=[EMA_VQ_SIZE, EMA_VQ_DIM], rows_a_call=EMA_VQ_ROWS * 25,
                     calls=EMA_VQ_CALLS, indices_differing=vq_flips, state_rel_err=vq_rel,
                     expired_codes=expired, tol_rel=TOL_EMA_VQ_REL))


def phase_train_dropout(train_step_s: float):
    """The train recipe with MLP dropout through the training entry point:
    K9-K11 launches against the prediction, step seconds against train's."""
    from maxtext_indextts2_tpu_torch.config import load_config
    from maxtext_indextts2_tpu_torch.train import train
    from maxtext_indextts2_tpu_torch.utils import flops

    t0 = time.perf_counter()
    cfg = load_config(TRAIN_DROPOUT_ARGS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_all_counts()
    out = train.main(list(TRAIN_DROPOUT_ARGS))  # no device given: the GPU, or an error
    torch.cuda.synchronize()
    launches = _all_counts()
    peak = torch.cuda.max_memory_allocated()
    hist = out["history"]
    losses = [h["loss"] for h in hist]
    check(len(hist) == TRAIN_DROPOUT_STEPS and all(np.isfinite(losses)),
          f"train_dropout: losses {losses}")
    want = _train_launches_want(cfg.num_decoder_layers, TRAIN_DROPOUT_STEPS)
    check(launches == want, f"train_dropout: launches {launches} != predicted {want}")
    check(peak < TRAIN_MAX_PEAK_BYTES, f"train_dropout: peak memory {peak / 1e9:.1f} GB")
    step_s = _median_step_seconds(hist)
    tokens = cfg.global_batch_size_to_train_on * cfg.max_target_length
    tflops = flops.training_tflops_per_step(cfg)
    emit("train_dropout", t0, steps=TRAIN_DROPOUT_STEPS, dropout_rate=cfg.dropout_rate,
         losses=losses, step_seconds=[h["step_time_s"] for h in hist],
         median_step_seconds=step_s, train_median_step_seconds=train_step_s,
         step_seconds_over_train=step_s / train_step_s, tokens_per_s=tokens / step_s,
         mfu_at_989_tflops=flops.mfu(tflops, step_s), launches=launches,
         launches_predicted=want, peak_memory_bytes=peak)
    return {k: launches[k] for k in TRAIN_LAUNCHES_PER_LAYER}


def phase_train_dropout_parity(train_parity_loss: float):
    """2 float32 layers with one set of dropout masks: the kernel route
    against the plain route, remat save_attn_and_mlp against no remat (the
    masks are not drawn again on recomputation), and dropout_rate=0 against
    train_parity's loss, bitwise."""
    from maxtext_indextts2_tpu_torch.config import load_config
    from maxtext_indextts2_tpu_torch.models.layers import MlpDropout
    from maxtext_indextts2_tpu_torch.train import train

    t0 = time.perf_counter()
    small = ["base_num_decoder_layers=2", "weight_dtype=float32", "dtype=float32"]
    cfg = load_config(TRAIN_DROPOUT_ARGS + small)
    state = train.setup_train_state(cfg)
    batch = next(train.create_data_iterator(cfg, state.device))
    shape = (*batch["inputs"].shape, cfg.mlp_dim)
    drawn = train.step_dropout(cfg, 0, state.device)
    masks = MlpDropout(cfg.dropout_rate,
                       masks=[drawn.keep_mask(i, shape, state.device)
                              for i in range(cfg.num_decoder_layers)])
    names, leaves = list(state.params), list(state.params.values())
    runs = {}
    for name, impl, remat in (("kernels", None, cfg.remat_policy),
                              ("plain", "plain", cfg.remat_policy),
                              ("kernels_no_remat", None, "none")):
        state.model.decoder.remat_policy = remat
        _reset_all_counts()
        loss, _ = train.loss_fn(state.model, cfg, batch, impl=impl, dropout=masks)
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        runs[name] = (float(loss.detach()), grads, dict(_all_counts()))
    state.model.decoder.remat_policy = cfg.remat_policy
    (loss_k, g_k, n_k), (loss_p, g_p, n_p), (loss_n, g_n, n_n) = (
        runs["kernels"], runs["plain"], runs["kernels_no_remat"])
    layers = cfg.num_decoder_layers
    want = {"flash_fwd": 2 * layers, "flash_bwd_dq": layers, "flash_bwd_dkv": layers}
    check({k: n_k[k] for k in want} == want and not any(n_p[k] for k in want)
          and n_n["flash_fwd"] == layers,
          f"train_dropout_parity: launches {n_k} (kernels), {n_p} (plain), {n_n} (no remat)")
    rel = {n: _max_rel(a, b) for n, a, b in zip(names, g_k, g_p)}
    rel_remat = {n: _max_rel(a, b) for n, a, b in zip(names, g_k, g_n)}
    worst, worst_remat = max(rel, key=rel.get), max(rel_remat, key=rel_remat.get)
    check(abs(loss_k - loss_p) <= TOL_TRAIN_LOSS,
          f"train_dropout_parity: loss {loss_k} (kernels) vs {loss_p} (plain)")
    check(rel[worst] <= TOL_TRAIN_GRAD_REL,
          f"train_dropout_parity: gradient {worst} off by {rel[worst]:.3g} (plain)")
    check(loss_k == loss_n and rel_remat[worst_remat] <= TOL_TRAIN_GRAD_REL,
          f"train_dropout_parity: remat against none: loss {loss_k} vs {loss_n}, "
          f"gradient {worst_remat} off by {rel_remat[worst_remat]:.3g}")
    del state, runs, g_k, g_p, g_n
    # dropout_rate=0 is no dropout: train_parity's loss, bitwise
    cfg0 = load_config(TRAIN_ARGS + ["enable_dropout=true", "dropout_rate=0"] + small)
    state0 = train.setup_train_state(cfg0)
    batch0 = next(train.create_data_iterator(cfg0, state0.device))
    # with gradients recorded, as train_parity's forward (the same remat regions)
    loss0, _ = train.loss_fn(state0.model, cfg0, batch0,
                             dropout=train.step_dropout(cfg0, 0, state0.device))
    loss0 = float(loss0.detach())
    check(loss0 == train_parity_loss,
          f"train_dropout_parity: rate 0 loss {loss0!r} != train_parity's {train_parity_loss!r}")
    emit("train_dropout_parity", t0, layers=layers, dropout_rate=cfg.dropout_rate,
         keep_share=[float(m.float().mean()) for m in masks.masks], loss_kernels=loss_k,
         loss_plain=loss_p, loss_no_remat=loss_n, worst_grad=worst, worst_grad_rel_err=rel[worst],
         worst_grad_remat=worst_remat, worst_grad_remat_rel_err=rel_remat[worst_remat],
         tol_loss=TOL_TRAIN_LOSS, tol_grad_rel=TOL_TRAIN_GRAD_REL, loss_rate_0=loss0,
         train_parity_loss=train_parity_loss,
         launches_kernel_route={k: n_k[k] for k in want})


def _timed(fn, seconds: dict, key: str):
    """``fn`` whose calls add their synchronised host seconds to ``seconds[key]``."""
    def wrapped(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        seconds[key] = seconds.get(key, 0.0) + time.perf_counter() - t0
        return out

    return wrapped


def phase_flagship_serve(card):
    """tts-flagship served whole: 48 layers, E 3840, 16 q / 8 kv heads of
    256, a 264,192-row tied vocabulary, bf16 weights made on the card, 8
    slots of a 4096-token cache; 8 greedy requests through the Orchestrator,
    then one ``synthesize`` with it as the pipeline's LM."""
    from maxtext_indextts2_tpu_torch.audio.conformer import ConformerConfig
    from maxtext_indextts2_tpu_torch.audio.pipeline import build_tiny_pipeline, prompt_signal
    from maxtext_indextts2_tpu_torch.config import load_config
    from maxtext_indextts2_tpu_torch.infer.engine import Engine
    from maxtext_indextts2_tpu_torch.infer.server import Orchestrator

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = load_config(FLAGSHIP_SERVE_ARGS)
    engine = Engine(cfg)  # no device given: the GPU, or an error
    engine.load_params()  # drawn in bfloat16 on the card (weight_dtype)
    torch.cuda.synchronize()
    params = sum(p.numel() for p in engine.model.parameters())
    param_bytes = sum(p.numel() * p.element_size() for p in engine.model.parameters())
    load_s, load_peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated()
    check(params == FLAGSHIP_PARAMS and all(
        p.dtype == torch.bfloat16 for n, p in engine.model.named_parameters() if "scale" not in n),
        f"flagship_serve: {params} parameters (want {FLAGSHIP_PARAMS}), all bfloat16")

    rng = np.random.default_rng(30)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32)
               for n in FLAGSHIP_PROMPT_LENGTHS]
    seconds: dict[str, float] = {}
    engine.prefill_insert_many = _timed(engine.prefill_insert_many, seconds, "prefill")
    engine.generate_n = _timed(engine.generate_n, seconds, "decode")
    orch = Orchestrator(engine, steps_per_dispatch=STEPS_PER_DISPATCH)
    orch.start()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_all_counts()  # every count to 0 just before the main path, read just after
    t1 = time.perf_counter()
    reqs = [orch.submit(p, FLAGSHIP_NEW_TOKENS) for p in prompts]
    finished = all(r.done.wait(timeout=600) for r in reqs)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t1
    orch.stop()
    launches = _all_counts()
    del engine.prefill_insert_many, engine.generate_n  # the instance's own methods again
    serve_peak = torch.cuda.max_memory_allocated()
    check(finished, "flagship_serve: a request did not finish in 600 s")
    errors = [r.error for r in reqs if r.error]
    check(not errors, f"flagship_serve: {len(errors)} requests failed, first: {errors[:1]}")
    check(all(len(r.tokens) == FLAGSHIP_NEW_TOKENS for r in reqs),
          "flagship_serve: a request did not get exactly its token budget")
    check(all(0 <= t < cfg.vocab_size for r in reqs for t in r.tokens),
          "flagship_serve: a token outside [0, vocab)")
    steps, layers = orch.stats["decode_steps_total"], cfg.num_decoder_layers
    want = {k: 0 for k in launches}
    want.update(ragged_decode_attention=layers * steps, inplace_row_update=2 * layers * steps)
    check(steps > 0 and launches == want, f"flagship_serve: launches {launches} != {want}")
    tokens = sum(len(r.tokens) for r in reqs)
    # K and V of every layer, slot and row in the activation dtype
    cache_bytes = (2 * layers * cfg.num_kv_heads * cfg.head_dim * engine.num_slots
                   * cfg.max_target_length * torch.finfo(torch.bfloat16).bits // 8)

    # one synthesize with the flagship as the pipeline's LM (the S2A back end
    # and the tokenizers at their published widths, int8_offline)
    t2 = time.perf_counter()
    pcfg = dataclasses.replace(cfg, s2a_serving_dtype="int8_offline")
    pipe = build_tiny_pipeline(pcfg, seed=0, codec_kwargs={}, device=engine.device,
                               engine=engine, semantic_encoder_cfg=ConformerConfig(),
                               semantic_repcodec_kwargs={})
    _audio_only_lm(pipe)
    w16 = prompt_signal(42, SYNTH_PROMPT_SECONDS, 16_000)
    w24 = prompt_signal(42, SYNTH_PROMPT_SECONDS, 24_000)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    wav, info = pipe.synthesize("The flagship model reads this sentence on one card.", w16, w24,
                                max_new_tokens=FLAGSHIP_SYNTH_FRAMES)
    torch.cuda.synchronize()
    synth_s = time.perf_counter() - t3
    hop = int(np.prod(pipe.codec.strides))
    check(info["semantic_tokens"] == FLAGSHIP_SYNTH_FRAMES
          and wav.shape == (FLAGSHIP_SYNTH_FRAMES * hop,) and bool(np.isfinite(wav).all())
          and float(wav.std()) > 0,
          f"flagship_serve: synthesize gave {info['semantic_tokens']} frames, {wav.shape}")
    emit("flagship_serve", t0, card=card, params=params, param_bytes=param_bytes,
         layers=layers, emb_dim=cfg.emb_dim, head_dim=cfg.head_dim,
         heads=[cfg.num_query_heads, cfg.num_kv_heads], vocab=cfg.vocab_size,
         slots=engine.num_slots, max_target_length=cfg.max_target_length,
         kv_cache_bytes=cache_bytes,
         load_seconds=load_s, load_peak_memory_bytes=load_peak,
         prompt_lengths=list(FLAGSHIP_PROMPT_LENGTHS), new_tokens=FLAGSHIP_NEW_TOKENS,
         serve_seconds=serve_s, prefill_seconds=seconds.get("prefill"),
         decode_seconds=seconds.get("decode"), decode_steps=steps,
         admission_dispatches=orch.stats["admission_dispatches_total"],
         prompt_tokens_per_prefill_s=sum(FLAGSHIP_PROMPT_LENGTHS) / seconds["prefill"],
         tokens=tokens, tokens_per_s=tokens / serve_s,
         decode_tokens_per_s=tokens / seconds["decode"],
         decode_ms_a_step=1e3 * seconds["decode"] / steps, launches=launches,
         serve_peak_memory_bytes=serve_peak,
         synthesize_seconds=synth_s, synthesize_info=info,
         pipeline_build_seconds=t3 - t2, peak_memory_bytes=torch.cuda.max_memory_allocated())
    del pipe
    return engine, {k: launches[k] for k in ("ragged_decode_attention", "inplace_row_update")}


def phase_flagship_serve_parity(engine, card):
    """One decode step of the whole flagship from one populated state (a
    prompt of 1024 or more among those admitted), the kernel route against
    the plain route (impl="plain") on the card."""
    t0 = time.perf_counter()
    gc.collect()  # the serving run's orchestrator and decode state
    torch.cuda.empty_cache()
    rng = np.random.default_rng(31)
    vocab = engine.cfg.vocab_size
    prompts = [rng.integers(1, vocab, size=n).astype(np.int32)
               for n in FLAGSHIP_PARITY_PROMPT_LENGTHS]
    state = engine.init_decode_state()
    for i in (0, 2):
        state, _ = engine.prefill_insert_many(state, prompts[i:i + 2], [2 * i, 2 * i + 1])
    state, _ = engine.generate_n(state, 3)
    twin = _clone_state(state)
    _reset_all_counts()
    _, logits_kernel = engine._generate_step(state)
    launched = _all_counts()["ragged_decode_attention"]
    _, logits_plain = engine._generate_step(twin, impl="plain")
    torch.cuda.synchronize()
    active = state["active"]
    err = float((logits_kernel[active] - logits_plain[active]).abs().max().item())
    scale = float(logits_plain[active].abs().max().item())
    finite = bool(torch.isfinite(logits_kernel).all().item())
    same_argmax = bool((logits_kernel[active].argmax(-1) == logits_plain[active].argmax(-1))
                       .all().item())
    check(launched == engine.cfg.num_decoder_layers
          and _all_counts()["ragged_decode_attention"] == launched,
          f"flagship_serve_parity: K1 launched {launched} in the kernel route")
    check(finite and err <= TOL_FLAGSHIP_PARITY_REL * scale,
          f"flagship_serve_parity: logits differ by {err} (max |logit| {scale})")
    del state, twin
    emit("flagship_serve_parity", t0, card=card, prompt_lengths=list(FLAGSHIP_PARITY_PROMPT_LENGTHS),
         logits_max_abs_err=err, logits_max_abs=scale, tol_rel=TOL_FLAGSHIP_PARITY_REL,
         greedy_tokens_equal=same_argmax, k1_launches_kernel_route=launched)


def _flash_and_ce_device_ms(cfg, card) -> dict:
    """Device time of one training step's K9-K11 (a profiled step of
    ``cfg``'s recipe) and of its fused CE alone (forward and backward on the
    step's prelogits shape, profiled), beside the card's name."""
    from maxtext_indextts2_tpu_torch.tools.profile_s2a import profiled
    from maxtext_indextts2_tpu_torch.tools.profile_train import kernel_category, own_kernel_name
    from maxtext_indextts2_tpu_torch.train import train

    gc.collect()
    torch.cuda.empty_cache()
    state = train.setup_train_state(cfg)
    batch = next(train.create_data_iterator(cfg, state.device))
    step = profiled(lambda: train.train_step(cfg, state, batch), "step", card, repeats=1,
                    own_kernel_name=own_kernel_name, category=kernel_category)
    flash = step["device_ms_by_category"].get("flash_attention (K9-K11)", {})
    b, s = cfg.global_batch_size_to_train_on, cfg.max_target_length
    g = torch.Generator(device=state.device).manual_seed(5)
    y = torch.randn((b, s, cfg.emb_dim), generator=g, device=state.device).to(
        getattr(torch, cfg.dtype)).requires_grad_(True)
    targets = torch.randint(0, cfg.vocab_size, (b, s), generator=g, device=state.device)
    weights = torch.ones((b, s), device=state.device)

    def ce():
        loss, _ = train.fused_ce(state.model, cfg, y, targets, weights)
        torch.autograd.grad(loss, [y, state.model.token_embedder.embedding])

    ce_prof = profiled(ce, "fused_ce", card, repeats=1)
    del state
    return dict(step_device_busy_ms=step["device_busy_ms"], step_ms_host_clock=step["ms_host_clock"],
                step_device_idle_share=step["device_idle_share"],
                k9_k11_device_ms=flash.get("device_ms"), k9_k11_launches=flash.get("launches"),
                fused_ce_device_ms=ce_prof["device_busy_ms"],
                fused_ce_ms_host_clock=ce_prof["ms_host_clock"],
                device_ms_by_category=step["device_ms_by_category"])


def _train_recipe(phase, args, card, steps):
    """``steps`` steps of ``args`` through the training entry point: losses,
    step seconds, tokens/s, MFU at 989 TFLOP/s (unembedding counted), peak
    memory and K9-K11 launches against the code's prediction."""
    from maxtext_indextts2_tpu_torch.config import load_config
    from maxtext_indextts2_tpu_torch.models import Transformer
    from maxtext_indextts2_tpu_torch.train import train
    from maxtext_indextts2_tpu_torch.utils import flops

    cfg = load_config(args)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_all_counts()  # every count to 0 just before the main path, read just after
    out = train.main(list(args))  # no device given: the GPU, or an error
    torch.cuda.synchronize()
    launches = _all_counts()
    peak = torch.cuda.max_memory_allocated()
    hist = out["history"]
    losses = [h["loss"] for h in hist]
    check(len(hist) == steps and all(np.isfinite(losses))
          and all(np.isfinite(h["grad_norm"]) for h in hist),
          f"{phase}: losses {losses} over {len(hist)} of {steps} steps")
    check(losses[-1] < losses[0], f"{phase}: the loss did not fall: {losses}")
    want = _train_launches_want(cfg.num_decoder_layers, steps)
    check(launches == want, f"{phase}: launches {launches} != predicted {want}")
    step_s = _median_step_seconds(hist)
    tokens = cfg.global_batch_size_to_train_on * cfg.max_target_length
    tflops = flops.training_tflops_per_step(cfg)
    fields = dict(card=card, steps=steps, losses=losses, grad_norms=[h["grad_norm"] for h in hist],
                  step_seconds=[h["step_time_s"] for h in hist], median_step_seconds=step_s,
                  tokens_per_step=tokens, tokens_per_s=tokens / step_s, tflops_per_step=tflops,
                  mfu_at_989_tflops=flops.mfu(tflops, step_s), launches=launches,
                  params=sum(p.numel() for p in Transformer(cfg, device="meta").parameters()),
                  peak_memory_bytes=peak)
    return cfg, fields, {k: launches[k] for k in TRAIN_LAUNCHES_PER_LAYER}


def phase_train_flagship_vocab(card):
    """The flagship-vocab recipe (``benchmarks/mfu_flagship.py`` BEST) at
    full size: the tts-1b body, a 264,192-row tied vocabulary, 4 x 2048
    tokens, the chunked fused CE; then the same with the int8 fused CE and
    bfloat16 logit slices. Device ms of the fused CE against K9-K11."""
    t0 = time.perf_counter()
    runs, launches = {}, {}
    for name, extra in (("chunked_bf16", []),
                        ("int8_bf16_logits", ["fused_ce_int8=true",
                                              "fused_ce_logits_dtype=bfloat16"])):
        cfg, fields, counts = _train_recipe(f"train_flagship_vocab ({name})",
                                            TRAIN_FLAGSHIP_VOCAB_ARGS + extra, card,
                                            TRAIN_STEPS)
        fields["device"] = _flash_and_ce_device_ms(cfg, card)
        runs[name] = fields
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        gc.collect()
        torch.cuda.empty_cache()
    check(all(r["params"] == FLAGSHIP_VOCAB_PARAMS for r in runs.values()),
          f"train_flagship_vocab: {[r['params'] for r in runs.values()]} parameters")
    emit("train_flagship_vocab", t0, card=card, recipe="benchmarks/mfu_flagship.py BEST",
         runs=runs, launches=launches)
    return launches, runs["chunked_bf16"]


def phase_train_flagship(card):
    """tts-flagship at full width and reduced depth (the reduction: 4 of 48
    layers): one 4096-token row a step, the chunked fused CE, remat full,
    bf16 weights; K9-K11 at D = 256 on the training path."""
    t0 = time.perf_counter()
    cfg, fields, launches = _train_recipe("train_flagship", TRAIN_FLAGSHIP_ARGS, card,
                                          TRAIN_FLAGSHIP_STEPS)
    check(fields["params"] == FLAGSHIP_TRAIN_PARAMS,
          f"train_flagship: {fields['params']} parameters")
    fields["device"] = _flash_and_ce_device_ms(cfg, card)
    emit("train_flagship", t0, reduced=f"base_num_decoder_layers={cfg.num_decoder_layers} "
         "(of 48)", head_dim=cfg.head_dim, emb_dim=cfg.emb_dim, **fields)
    return launches


def phase_train_flagship_vocab_parity(card):
    """One batch of the flagship-vocab recipe at the same weights through
    each fused CE variant and the materialised ``masked_cross_entropy``: the
    loss, the gradient norm, the embedding's and one layer's gradients, and
    each route's peak memory (the materialised route holds the [B*S, V]
    float32 logits; a fused one never does)."""
    from maxtext_indextts2_tpu_torch.config import load_config
    from maxtext_indextts2_tpu_torch.train import train

    t0 = time.perf_counter()
    base = load_config(TRAIN_FLAGSHIP_VOCAB_ARGS + [
        f"per_device_batch_size={FLAGSHIP_VOCAB_PARITY_BATCH}"])
    state = train.setup_train_state(base)
    batch = next(train.create_data_iterator(base, state.device))
    names, leaves = list(state.params), list(state.params.values())
    layer = [i for i, n in enumerate(names) if n.startswith(FLAGSHIP_PARITY_LAYER)]
    emb = names.index("token_embedder.embedding")
    routes = {"materialised": dict(fused_vocab_ce_chunk=0),
              "chunked": {}, "streaming": dict(fused_vocab_ce_chunk=0,
                                               fused_vocab_ce_tile=FLAGSHIP_PARITY_TILE),
              "int8": dict(fused_ce_int8=True)}
    res = {}
    for route, over in routes.items():
        cfg = dataclasses.replace(base, **over)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        loss, _ = train.loss_fn(state.model, cfg, batch)
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        res[route] = dict(loss=float(loss.detach()), grad_norm=float(train._global_norm(grads)),
                          emb=grads[emb].float(), layer=[grads[i].float() for i in layer],
                          peak_over_resident_bytes=torch.cuda.max_memory_allocated() - resident)
        del loss, grads
    ref = res["materialised"]
    logits_bytes = FLAGSHIP_VOCAB_PARITY_BATCH * base.max_target_length * base.vocab_size * 4
    out = {}
    for route, r in res.items():
        rel = lambda a, b: float((a - b).abs().max() / b.abs().max())  # noqa: E731
        out[route] = dict(loss=r["loss"], grad_norm=r["grad_norm"],
                          peak_over_resident_bytes=r["peak_over_resident_bytes"])
        if route != "materialised":
            out[route].update(
                loss_rel_diff=abs(r["loss"] - ref["loss"]) / abs(ref["loss"]),
                grad_norm_rel_diff=abs(r["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"],
                embedding_grad_max_rel_diff=rel(r["emb"], ref["emb"]),
                layer_grad_max_rel_diff=max(rel(a, b) for a, b in zip(r["layer"], ref["layer"])))
    del res, state
    tol = TOL_FLAGSHIP_VOCAB_PARITY
    for route, o in out.items():
        if route == "materialised":
            continue
        t = tol["int8" if route == "int8" else "float"]
        check(all(np.isfinite([o["loss"], o["grad_norm"]])) and o["loss_rel_diff"] <= t[0]
              and o["grad_norm_rel_diff"] <= t[1] and o["embedding_grad_max_rel_diff"] <= t[2]
              and o["layer_grad_max_rel_diff"] <= t[2],
              f"train_flagship_vocab_parity: {route} against materialised: {o}")
        saved = out["materialised"]["peak_over_resident_bytes"] - o["peak_over_resident_bytes"]
        check(saved >= logits_bytes,
              f"train_flagship_vocab_parity: {route} peaked {o['peak_over_resident_bytes']} bytes"
              f" over the resident state, only {saved} below the materialised route (the "
              f"[B*S, V] float32 logits are {logits_bytes})")
    emit("train_flagship_vocab_parity", t0, card=card, batch=FLAGSHIP_VOCAB_PARITY_BATCH,
         layer=FLAGSHIP_PARITY_LAYER, logits_float32_bytes=logits_bytes, tol=tol, routes=out)


def _param_bytes(engine) -> int:
    return sum(t.numel() * t.element_size() for t in engine.params.values())


def _reckoned_int8w_bytes(engine) -> int:
    """The decoder's linears at one byte a weight, plus the embedding and the
    unembedding in bfloat16 (the scales and norms left out)."""
    total = 0
    for name, t in engine.params.items():
        if name.startswith("decoder") and name.endswith(".kernel"):
            total += t.numel()
        elif name.startswith(("token_embedder", "logits_dense")):
            total += 2 * t.numel()
    return total


def _near_tie_agreement(engine, prompts, streams, router_gaps=None, vision=None):
    """For each stream, the tokens that its own engine's prefill forward over
    prompt + stream gives as argmax, or within a near tie of it
    (``TOL_NEAR_TIE`` of the largest |logit|): (agreeing, compared, exact).
    Given a list ``router_gaps``, a MoE model's forward also records, at each
    compared token, the smallest router gap over its MoE layers (the k-th
    selection score less the (k+1)-th), and the list gets one entry a token
    that does not agree: its gap and the share of compared tokens whose gap
    is no larger. ``vision``: each prompt's image soft tokens ``[1, T, E]``,
    fused by the forward as by the prefill."""
    from maxtext_indextts2_tpu_torch.models import MODE_PREFILL

    agree = compared = exact = 0
    dev = engine.device
    gaps, missed = [], []
    for i, (prompt, stream) in enumerate(zip(prompts, streams)):
        full = np.concatenate([prompt, np.asarray(stream[:-1], np.int32)])
        toks = torch.as_tensor(full, device=dev)[None, :]
        pos = torch.arange(len(full), dtype=torch.int32, device=dev)[None, :]
        layer_gaps = []
        with torch.no_grad(), _recording_router_gaps(
                layer_gaps if router_gaps is not None else None):
            logits = engine.model(toks, pos, torch.ones_like(toks), mode=MODE_PREFILL,
                                  cache=engine.model.init_cache(1, len(full), dev),
                                  vision_embeddings=None if vision is None else vision[i]
                                  )[0].float()
        rows = logits[len(prompt) - 1:]
        want = torch.as_tensor(np.asarray(stream), device=dev).long()
        top = rows.max(-1).values
        got = rows.gather(-1, want[:, None])[:, 0]
        tie = TOL_NEAR_TIE * rows.abs().max(-1).values
        ok = (top - got) <= tie
        agree += int(ok.sum())
        exact += int((rows.argmax(-1) == want).sum())
        compared += len(stream)
        if layer_gaps:
            gap = torch.stack(layer_gaps).min(0).values[len(prompt) - 1:]
            gaps.append(gap)
            missed.append(gap[~ok])
    if router_gaps is not None and gaps:
        every = torch.cat(gaps)
        router_gaps.extend(dict(gap=float(g), share_no_larger=float((every <= g).float().mean()))
                           for g in torch.cat(missed).tolist())
    return agree, compared, exact


@contextlib.contextmanager
def _recording_router_gaps(gaps):
    """While active, every routing of a MoE layer appends to ``gaps`` its gap
    at each position: the k-th selection score less the (k+1)-th (the scores
    with ``gate_bias``, before group limits). ``gaps=None``: records nothing."""
    from maxtext_indextts2_tpu_torch.models.moe import RoutedMoE

    original = RoutedMoE.route

    def route(module, inputs):
        out = original(module, inputs)
        k = module.cfg.num_experts_per_tok
        select = out[2] if module.gate_bias is None else out[2] + module.gate_bias.float()
        top = torch.topk(select, k + 1, dim=-1).values
        gaps.append((top[..., k - 1] - top[..., k]).reshape(-1))
        return out

    if gaps is not None:
        RoutedMoE.route = route
    try:
        yield
    finally:
        RoutedMoE.route = original


def _leading_agreement(a, b) -> list[int]:
    """For each pair of streams, how many leading tokens are equal."""
    out = []
    for x, y in zip(a, b):
        diff = np.nonzero(np.asarray(x) != np.asarray(y))[0]
        out.append(int(diff[0]) if len(diff) else len(x))
    return out


def phase_serve_int8w(bf16_engine, tmp, card):
    """ROADMAP item 5.6, serving: tts-1b with ``quantization=int8w_serve``
    (weights quantized on the card from the seeded float ones), 32 slots,
    greedy, decode captured, dense and paged; parameter bytes and peak memory
    against the bfloat16 engine, the step's host and device ms and
    int8w_matmul launches a step (``tools/profile_decode.measure``), the
    streams' self-consistency with the int8 forward, their leading agreement
    with the bfloat16 streams, and a ``tools/quantize_checkpoint.py`` round
    trip (``checkpoint_is_quantized=true``: the same streams)."""
    from maxtext_indextts2_tpu_torch.config import load_config
    from maxtext_indextts2_tpu_torch.infer.engine import Engine
    from maxtext_indextts2_tpu_torch.tools import profile_decode, quantize_checkpoint

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    engine = Engine(load_config(SERVE_INT8W_ARGS))  # no device given: the GPU, or an error
    engine.load_params()
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    cfg = engine.cfg
    q_bytes, bf16_bytes = _param_bytes(engine), _param_bytes(bf16_engine)
    reckoned = _reckoned_int8w_bytes(engine)
    int8_kernels = [n for n, t in engine.params.items() if t.dtype == torch.int8]
    check(len(int8_kernels) == 7 * cfg.num_decoder_layers
          and abs(q_bytes - reckoned) <= TOL_INT8W_BYTES_REL * reckoned,
          f"serve_int8w: {len(int8_kernels)} int8 kernels, {q_bytes} parameter bytes against "
          f"{reckoned} reckoned")
    prompts, _ = make_requests(np.random.default_rng(0), cfg.vocab_size)
    prompts = prompts[:engine.num_slots]

    # the main path: captured decode of every slot, counts from 0 around it
    state, first = _populate(engine, prompts)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_all_counts()
    toks, t1 = [first[None]], time.perf_counter()
    for _ in range(INT8W_STEPS // STEPS_PER_DISPATCH):
        state, t = engine.generate_n(state, STEPS_PER_DISPATCH)
        toks.append(t)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t1
    launches = _all_counts()
    serve_peak = torch.cuda.max_memory_allocated()
    streams = torch.cat(toks).t().cpu().numpy()
    want = {k: 0 for k in launches}
    want.update(int8w_matmul=7 * cfg.num_decoder_layers * INT8W_STEPS,
                ragged_decode_attention=cfg.num_decoder_layers * INT8W_STEPS,
                inplace_row_update=2 * cfg.num_decoder_layers * INT8W_STEPS)
    check(launches == want, f"serve_int8w: launches {launches} != {want}")
    check(bool(((streams >= 0) & (streams < cfg.vocab_size)).all()),
          "serve_int8w: a token outside [0, vocab)")
    del state
    bf16_streams = _decode_streams(bf16_engine, prompts, INT8W_STEPS)
    leading = _leading_agreement(streams, bf16_streams)
    agree, compared, exact = _near_tie_agreement(engine, prompts[:INT8W_SELF_STREAMS],
                                                 streams[:INT8W_SELF_STREAMS])
    check(agree == compared, f"serve_int8w: {compared - agree} of {compared} tokens are not the "
                             "int8 forward's argmax nor within a near tie of it")
    profiles = {}
    for eng, label in ((engine, "int8w_serve"), (bf16_engine, "bfloat16")):
        state, _ = _populate(eng, prompts)
        step, prof = profile_decode.measure(eng, state, steps=8)
        profiles[label] = {**step, **{k: prof[k] for k in (
            "device_busy_ms_per_step", "device_idle_share", "device_kernels_per_step",
            "own_kernel_launches_per_step", "own_kernels", "top_kernels")}}
        del state
    check(profiles["int8w_serve"]["own_kernel_launches_per_step"].get(
        "int8w_matmul.launch_count") == 7 * cfg.num_decoder_layers,
          f"serve_int8w: int8w_matmul launches a profiled step: "
          f"{profiles['int8w_serve']['own_kernel_launches_per_step']}")

    # paged: the same int8 weights (no second quantization) behind page pools
    paged = Engine(load_config(PAGED_INT8W_ARGS))
    paged.set_params(engine.params)
    state, first = _populate(paged, [p[:180] for p in prompts])
    _reset_all_counts()
    ptoks = [first[None]]
    for _ in range(INT8W_STEPS // STEPS_PER_DISPATCH):
        state, t = paged.generate_n(state, STEPS_PER_DISPATCH)
        ptoks.append(t)
    torch.cuda.synchronize()
    paged_launches = _all_counts()
    paged_streams = torch.cat(ptoks).t().cpu().numpy()
    want = {k: 0 for k in paged_launches}
    want.update(int8w_matmul=7 * cfg.num_decoder_layers * INT8W_STEPS,
                paged_decode_attention=cfg.num_decoder_layers * INT8W_STEPS)
    check(paged_launches == want, f"serve_int8w (paged): launches {paged_launches} != {want}")
    dense_short = _decode_streams(engine, [p[:180] for p in prompts], INT8W_STEPS)
    paged_leading = _leading_agreement(paged_streams, dense_short)
    del state, paged
    gc.collect()
    torch.cuda.empty_cache()

    # the offline quantizer's checkpoint, read as it is
    path = os.path.join(tmp, "int8w_ckpt")
    qinfo = quantize_checkpoint.run(SERVE_ARGS + [f"save_path={path}"])
    gc.collect()
    torch.cuda.empty_cache()
    read = Engine(load_config(SERVE_INT8W_ARGS + ["checkpoint_is_quantized=true",
                                                  f"load_parameters_path={path}"]))
    read.load_params()
    same_weights = _same_tensors(read.params, engine.params)
    check(not same_weights, f"serve_int8w: the checkpoint's weights differ: {same_weights[:3]}")
    read_streams = _decode_streams(read, prompts, INT8W_STEPS)
    check(bool(np.array_equal(read_streams, streams)),
          "serve_int8w: the quantized checkpoint's streams differ from the converted ones")
    ckpt_bytes = _bytes(path)
    del read
    shutil.rmtree(path, ignore_errors=True)
    emit("serve_int8w", t0, card=card, slots=engine.num_slots, steps=INT8W_STEPS,
         load_seconds=load_s, param_bytes=q_bytes, param_bytes_bfloat16=bf16_bytes,
         param_bytes_reckoned=reckoned, param_bytes_over_bfloat16=q_bytes / bf16_bytes,
         int8_kernels=len(int8_kernels), decode_seconds=decode_s,
         tokens_per_s=engine.num_slots * INT8W_STEPS / decode_s,
         serve_peak_memory_bytes=serve_peak, launches=launches, profile=profiles,
         leading_tokens_equal_bfloat16=leading,
         self_consistent_tokens=agree, self_consistent_exact=exact,
         self_consistent_compared=compared, tol_near_tie=TOL_NEAR_TIE,
         paged_launches=paged_launches, paged_leading_tokens_equal_dense=paged_leading,
         quantized_checkpoint=qinfo, quantized_checkpoint_bytes=ckpt_bytes,
         quantized_checkpoint_streams_equal=True)
    del engine
    return {"int8w_matmul": launches["int8w_matmul"] + paged_launches["int8w_matmul"]}


def phase_flagship_serve_int8w(bf16_engine, card):
    """The flagship's bfloat16 weights quantized into an ``int8w_serve``
    engine on the card: weight bytes and serving peak memory against
    bfloat16, and one captured dispatch of 4 steps over 8 slots."""
    from maxtext_indextts2_tpu_torch.config import load_config
    from maxtext_indextts2_tpu_torch.infer.engine import Engine
    from maxtext_indextts2_tpu_torch.tools import profile_decode

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    bf16_bytes = _param_bytes(bf16_engine)
    engine = Engine(load_config(FLAGSHIP_SERVE_ARGS + ["quantization=int8w_serve"]))
    engine.set_params(bf16_engine.params)  # quantized here
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    q_bytes, reckoned = _param_bytes(engine), _reckoned_int8w_bytes(engine)
    check(abs(q_bytes - reckoned) <= TOL_INT8W_BYTES_REL * reckoned,
          f"flagship_serve_int8w: {q_bytes} parameter bytes against {reckoned} reckoned")
    rng = np.random.default_rng(32)
    prompts = [rng.integers(1, engine.cfg.vocab_size, size=n).astype(np.int32)
               for n in FLAGSHIP_PARITY_PROMPT_LENGTHS * 2]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state, _ = _populate(engine, prompts[:engine.num_slots])
    _reset_all_counts()
    step, prof = profile_decode.measure(engine, state, steps=STEPS_PER_DISPATCH)
    launches = _all_counts()
    peak = torch.cuda.max_memory_allocated()
    layers = engine.cfg.num_decoder_layers
    # measure runs 9 dispatches: 8 through the captured graph and one capture
    check(prof["own_kernel_launches_per_step"].get("int8w_matmul.launch_count") == 7 * layers
          and launches["int8w_matmul"] > 0,
          f"flagship_serve_int8w: int8w_matmul launches {launches['int8w_matmul']}, a step "
          f"{prof['own_kernel_launches_per_step']}")
    del state
    emit("flagship_serve_int8w", t0, card=card, quantize_seconds=quantize_s,
         param_bytes=q_bytes, param_bytes_bfloat16=bf16_bytes, param_bytes_reckoned=reckoned,
         param_bytes_over_bfloat16=q_bytes / bf16_bytes, serve_peak_memory_bytes=peak,
         dispatch_steps=STEPS_PER_DISPATCH,
         captured_dispatch_ms_host_clock=step["step_ms_host_clock"] * STEPS_PER_DISPATCH,
         step=step, device_busy_ms_per_step=prof["device_busy_ms_per_step"],
         device_idle_share=prof["device_idle_share"],
         own_kernel_launches_per_step=prof["own_kernel_launches_per_step"],
         own_kernels=prof["own_kernels"], top_kernels=prof["top_kernels"], launches=launches)
    del engine
    return {"int8w_matmul": launches["int8w_matmul"]}


def phase_train_int8(card, flagship_vocab_bf16, train_fields):
    """ROADMAP item 5.6, training: the flagship-vocab recipe exactly as
    ``configs/perf/v5e/tts_flagship.sh`` has it (quantization=int8), then the
    tts-1b recipe at int8 and at fp8; step seconds, tokens/s and MFU beside
    the same recipes in bfloat16 from this run."""
    t0 = time.perf_counter()
    runs, launches = {}, {}
    for name, args, base in (("flagship_vocab_int8", TRAIN_INT8_FLAGSHIP_VOCAB_ARGS,
                              flagship_vocab_bf16),
                             ("tts_1b_int8", TRAIN_INT8_ARGS, train_fields),
                             ("tts_1b_fp8", TRAIN_FP8_ARGS, train_fields)):
        cfg, fields, counts = _train_recipe(f"train_int8 ({name})", args, card, TRAIN_STEPS)
        fields.update(bfloat16_median_step_seconds=base["median_step_seconds"],
                      bfloat16_mfu_at_989_tflops=base["mfu_at_989_tflops"],
                      step_seconds_over_bfloat16=fields["median_step_seconds"]
                      / base["median_step_seconds"])
        runs[name] = fields
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        gc.collect()
        torch.cuda.empty_cache()
    check(runs["flagship_vocab_int8"]["params"] == FLAGSHIP_VOCAB_PARAMS,
          f"train_int8: {runs['flagship_vocab_int8']['params']} parameters")
    emit("train_int8", t0, card=card, recipe="configs/perf/v5e/tts_flagship.sh (quantization=int8)",
         runs=runs, launches=launches)
    return launches


def phase_train_int8_parity(card):
    """One step of 2 float32 layers of the tts-1b recipe at quantization=int8
    on the card against the same step on the CPU: one set of weights, one
    batch, one noise tensor a layer; loss, grad norm, every gradient (and the
    same step unquantized beside). Then AQT's int8 and fp8 products alone at
    the layer's width, card against CPU, bitwise."""
    from maxtext_indextts2_tpu_torch.config import load_config
    from maxtext_indextts2_tpu_torch.ops.quantization import aqt_dot, draw_noise
    from maxtext_indextts2_tpu_torch.train import train

    t0 = time.perf_counter()
    cfg = load_config(INT8_PARITY_ARGS)
    card_state = train.setup_train_state(cfg)
    cpu_state = train.setup_train_state(
        cfg, device="cpu", params={k: v.detach().cpu() for k, v in card_state.params.items()})
    batch = next(train.create_data_iterator(cfg, card_state.device))
    g = torch.Generator().manual_seed(7)
    rows = cfg.global_batch_size_to_train_on * cfg.max_target_length
    noise = {name: draw_noise("int8", (rows, math.prod(m.features)), torch.float32, "cpu", g)
             for name, m in cpu_state.model.named_modules()
             if getattr(m, "quantization", "") == "int8"}
    runs, logs = {}, {}
    # the same step unquantized: how far the card and the CPU drift apart without AQT
    for quant in ("", "int8"):
        qcfg = dataclasses.replace(cfg, quantization=quant)
        out = {}
        for label, state, dev in (("card", card_state, card_state.device),
                                  ("cpu", cpu_state, "cpu")):
            for name, m in state.model.named_modules():
                if name in noise:  # the config's quantized layers
                    m.quantization = quant
            capture = {} if quant and label == "card" else None
            out[label] = _int8_step(state, qcfg, batch, noise, dev, capture=capture)
            if capture is not None:
                layer0_out = capture["out"]
        torch.cuda.synchronize()
        runs[quant or "float"] = _step_gap(out["card"], out["cpu"])
        if quant:
            logs = {label: out[label][2] for label in out}
            # the CPU step again with the card's layer-0 output in place of its own
            injected = _int8_step(cpu_state, qcfg, batch, noise, "cpu", inject=layer0_out)
            card_out = out["card"]
    flips = _code_flips(logs["card"], logs["cpu"])
    gap, closed = runs["int8"], _step_gap(card_out, injected)
    localisation = dict(
        code_flips_by_layer=flips, injected_layer0_output=dict(
            loss_gap=closed["loss_card"] - closed["loss_cpu"],
            loss_gap_before=gap["loss_card"] - gap["loss_cpu"],
            worst_grad_rel_err=closed["worst_grad_rel_err"], worst_grad=closed["worst_grad"],
            median_grad_rel_err=closed["median_grad_rel_err"],
            grad_rel_err_by_layer=closed["grad_rel_err_by_layer"],
            grad_rel_err_by_layer_before=gap["grad_rel_err_by_layer"],
            code_flips_by_layer=_code_flips(logs["card"], injected[2])),
        dw_codes="none: the weight gradient is a float product (x^T g) in AQT's int8 mode")
    r = runs["int8"]
    loss_c, loss_h, norm_c, norm_h = r["loss_card"], r["loss_cpu"], r["grad_norm_card"], \
        r["grad_norm_cpu"]
    tol = TOL_INT8_PARITY
    check(np.isfinite(loss_c) and abs(loss_c - loss_h) <= tol["loss"],
          f"train_int8_parity: loss {loss_c} (card) vs {loss_h} (CPU)")
    check(abs(norm_c - norm_h) <= tol["grad_norm_rel"] * norm_h,
          f"train_int8_parity: grad norm {norm_c} (card) vs {norm_h} (CPU)")
    check(r["worst_grad_rel_err"] <= tol["grad_rel"]
          and r["median_grad_rel_err"] <= tol["grad_rel_median"],
          f"train_int8_parity: gradient {r['worst_grad']} differs by "
          f"{r['worst_grad_rel_err']:.3g} of its largest entry (median "
          f"{r['median_grad_rel_err']:.3g})")
    # (a) the quantized products alone, card against CPU
    aqt = {}
    m, k, n = AQT_PARITY_SHAPE
    for mode, codes in (("int8", "int8"), ("fp8", "e5m2")):
        x = torch.randn((m, k), generator=g)
        w = torch.randn((k, n), generator=g) / math.sqrt(k)
        ct = torch.randn((m, n), generator=g)
        nz = draw_noise(codes, (m, n), torch.float32, "cpu", g)
        got = {}
        for dev in (card_state.device, "cpu"):
            xx, ww = x.to(dev).requires_grad_(True), w.to(dev).requires_grad_(True)
            y = aqt_dot(xx, ww, mode, nz.to(dev))
            (y * ct.to(dev)).sum().backward()
            got[str(dev)] = [t.detach().cpu() for t in (y, xx.grad, ww.grad)]
        (yc, dxc, dwc), (yh, dxh, dwh) = got[str(card_state.device)], got["cpu"]
        rel = lambda a, b: float((a - b).abs().max() / b.abs().max())  # noqa: E731
        aqt[mode] = dict(y_equal=bool(torch.equal(yc, yh)), dx_equal=bool(torch.equal(dxc, dxh)),
                         y_rel_err=rel(yc, yh), dx_rel_err=rel(dxc, dxh), dw_rel_err=rel(dwc, dwh))
    # int8: integer sums, bitwise; fp8: exact products of decoded codes summed in float32
    check(aqt["int8"]["y_equal"] and aqt["int8"]["dx_equal"]
          and all(a["y_rel_err"] <= tol["aqt_dw_rel"] and a["dx_rel_err"] <= tol["aqt_dw_rel"]
                  and a["dw_rel_err"] <= tol["aqt_dw_rel"] for a in aqt.values()),
          f"train_int8_parity: AQT's products on the card against the CPU: {aqt}")
    emit("train_int8_parity", t0, card=card, layers=cfg.num_decoder_layers,
         tokens=rows, quantized_layers=len(noise), runs=runs, aqt_products=aqt,
         aqt_product_shape=list(AQT_PARITY_SHAPE), tol=tol, localisation=localisation)
    del card_state, cpu_state


def _int8_step(state, cfg, batch, noise, dev, capture=None, inject=None):
    """One loss and gradient of ``state``'s model on ``dev`` with one noise
    tensor a quantized layer: (loss, gradients on the host, the int8 codes of
    every AQT quantization in call order, each labelled (layer, pass, side):
    the forward's x ("lhs") and kernel ("rhs") codes, the input gradient's g
    ("lhs") and transposed-kernel ("rhs") codes). ``capture``: a dict that
    gets decoder layer 0's output; ``inject``: a tensor put in place of that
    output (the gradient still flows through the layer)."""
    from maxtext_indextts2_tpu_torch.ops import quantization
    from maxtext_indextts2_tpu_torch.train import train

    real = quantization.aqt_quantize
    where = {"name": None, "stage": "fwd"}
    log = []

    class Noise(dict):  # the backward asks a layer's noise just before its product
        def __getitem__(self, name):
            where.update(name=name, stage="bwd")
            return dict.__getitem__(self, name)

    def quantize(x, dim, codes, noise_=None):
        q, sc = real(x, dim, codes, noise_)
        log.append(((where["name"], where["stage"], "lhs" if dim == 1 else "rhs"),
                    q.detach().cpu()))
        return q, sc

    hooks = [m.register_forward_pre_hook(
        lambda mod, args, n=name: where.update(name=n, stage="fwd"))
        for name, m in state.model.named_modules() if name in noise]
    layer0 = state.model.decoder.layers_0
    if capture is not None:
        def keep(mod, args, out):  # returns None: the output stays the layer's
            capture.setdefault("out", out.detach().cpu())

        hooks.append(layer0.register_forward_hook(keep))
    if inject is not None:
        hooks.append(layer0.register_forward_hook(
            lambda mod, args, out: out + (inject.to(out.device, out.dtype) - out).detach()))
    quantization.aqt_quantize = quantize
    try:
        b = {k: v.to(dev) for k, v in batch.items()}
        aqt = quantization.AqtNoise(tensors=Noise({k: v.to(dev) for k, v in noise.items()}))
        loss, _ = train.loss_fn(state.model, cfg, b, aqt_noise=aqt)
        names = list(state.params)
        grads = torch.autograd.grad(loss, [state.params[n] for n in names])
    finally:
        quantization.aqt_quantize = real
        for h in hooks:
            h.remove()
    return float(loss.detach()), {n: g.detach().float().cpu() for n, g in zip(names, grads)}, log


def _layer_of(name: str) -> str:
    parts = name.split(".")
    return parts[1] if len(parts) > 1 and parts[0] == "decoder" else parts[0]


def _step_gap(card, cpu) -> dict:
    """Loss, grad norm and gradient differences of two ``_int8_step`` results
    (each gradient relative to its largest entry; by layer, the worst)."""
    (loss_c, g_c, _), (loss_h, g_h, _) = card, cpu
    rel = {n: float((g_c[n] - g_h[n]).abs().max() / g_h[n].abs().max().clamp(min=1e-30))
           for n in g_h}
    by_layer: dict = {}
    for n, v in rel.items():
        by_layer[_layer_of(n)] = max(by_layer.get(_layer_of(n), 0.0), v)
    return dict(loss_card=loss_c, loss_cpu=loss_h,
                grad_norm_card=float(torch.sqrt(sum((t * t).sum() for t in g_c.values()))),
                grad_norm_cpu=float(torch.sqrt(sum((t * t).sum() for t in g_h.values()))),
                worst_grad=max(rel, key=rel.get), worst_grad_rel_err=max(rel.values()),
                median_grad_rel_err=float(np.median(list(rel.values()))),
                grad_rel_err_by_layer=by_layer)


def _code_flips(log_a, log_b) -> dict:
    """For each layer and code kind, [codes that differ, codes] between two
    runs' AQT logs (the first quantization of each label: a remat region's
    recomputed forward repeats its codes)."""
    check([k for k, _ in log_a] == [k for k, _ in log_b],
          "train_int8_parity: the two runs quantized in different orders")
    kinds = {("fwd", "lhs"): "x", ("fwd", "rhs"): "kernel", ("bwd", "lhs"): "dlhs_g",
             ("bwd", "rhs"): "dlhs_kernel"}
    seen, out = set(), {}
    for (label, qa), (_, qb) in zip(log_a, log_b):
        if label in seen:
            continue
        seen.add(label)
        name, stage, side = label
        cell = out.setdefault(_layer_of(name), {}).setdefault(kinds[(stage, side)], [0, 0])
        cell[0] += int((qa != qb).sum())
        cell[1] += qa.numel()
    return out


def phase_train_lora(card, train_fields):
    """The tts-1b recipe with rank-16 adapters on query and value, LoRA-only
    training, through ``train_step``: only ``lora_*`` tensors change
    (every other weight bitwise as it was), step seconds and peak memory
    against ``train``'s."""
    from maxtext_indextts2_tpu_torch.config import load_config
    from maxtext_indextts2_tpu_torch.train import train

    t0 = time.perf_counter()
    cfg = load_config(TRAIN_LORA_ARGS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = train.setup_train_state(cfg)
    before = {n: p.detach().clone() for n, p in state.params.items()}
    data = train.create_data_iterator(cfg, state.device)
    _reset_all_counts()
    losses, times = [], []
    for _ in range(TRAIN_STEPS):
        batch = train._take(next(data), cfg.global_batch_size_to_train_on)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        m = train.train_step(cfg, state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
        losses.append(float(m["loss"]))
    launches = _all_counts()
    peak = torch.cuda.max_memory_allocated()
    changed = sorted(n for n, p in state.params.items() if not torch.equal(p, before[n]))
    adapters = sorted(n for n in state.params if "lora_" in n)
    check(changed and all("lora_" in n for n in changed),
          f"train_lora: non-adapter weights changed: {[n for n in changed if 'lora_' not in n][:4]}")
    check(set(changed) == set(adapters), f"train_lora: {len(adapters) - len(changed)} adapters "
                                         "did not train")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0], f"train_lora: losses {losses}")
    want = _train_launches_want(cfg.num_decoder_layers, TRAIN_STEPS)
    check(launches == want, f"train_lora: launches {launches} != predicted {want}")
    step_s = float(np.median(times[1:]))
    emit("train_lora", t0, card=card, lora_rank=cfg.lora_rank, steps=TRAIN_STEPS, losses=losses,
         step_seconds=times, median_step_seconds=step_s,
         train_median_step_seconds=train_fields["median_step_seconds"],
         step_seconds_over_train=step_s / train_fields["median_step_seconds"],
         peak_memory_bytes=peak, train_peak_memory_bytes=train_fields["peak_memory_bytes"],
         adapter_tensors=len(adapters),
         adapter_params=sum(state.params[n].numel() for n in adapters),
         optimizer_moments=len(state.opt_state["mu"]), launches=launches)
    del state, before
    return {k: launches[k] for k in TRAIN_LAUNCHES_PER_LAYER}


def phase_lora_merge(card):
    """A nonzero rank-16 adapter on every query and value: served unmerged by
    a ``lora_rank=16`` engine, and merged into the base weights by
    ``Engine.load_lora_adapter``; greedy streams equal up to the first near
    tie (float32 weights)."""
    from maxtext_indextts2_tpu_torch.config import load_config
    from maxtext_indextts2_tpu_torch.infer.engine import Engine

    t0 = time.perf_counter()
    lora_cfg = load_config(LORA_SERVE_ARGS + ["lora_rank=16"])
    unmerged = Engine(lora_cfg)
    unmerged.load_params()
    g = torch.Generator(device=unmerged.device).manual_seed(9)
    adapter = {}
    with torch.no_grad():
        for name, p in unmerged.model.named_parameters():
            if name.endswith("lora_b"):  # zero at init: an adapter that changes nothing
                p.normal_(0.0, 0.02, generator=g)
            if "lora_" in name:
                adapter[name] = p.detach().clone()
    unmerged.params = unmerged.model.state_dict()
    merged = Engine(load_config(LORA_SERVE_ARGS))
    merged.set_params({k: v for k, v in unmerged.params.items() if "lora_" not in k})
    base_streams = None
    prompts, _ = make_requests(np.random.default_rng(3), lora_cfg.vocab_size)
    prompts = prompts[:LORA_STREAMS]
    base_streams = _decode_streams(merged, prompts, LORA_TOKENS)
    merged.load_lora_adapter(adapter, alpha=lora_cfg.lora_alpha)
    a = _decode_streams(unmerged, prompts, LORA_TOKENS)
    b = _decode_streams(merged, prompts, LORA_TOKENS)
    leading = _leading_agreement(a, b)
    # each first difference must be a near tie of the unmerged engine's logits
    ties = [(p, sb[:n + 1]) for p, sb, n in zip(prompts, b, leading) if n < len(sb)]
    agree, compared, _ = _near_tie_agreement(unmerged, [p for p, _ in ties],
                                             [s for _, s in ties]) if ties else (0, 0, 0)
    check(agree == compared, f"lora_merge: a stream left the unmerged one at a token that is "
                             f"not a near tie ({compared - agree} of {len(ties)})")
    changed_by_adapter = int(sum(n < len(s) for s, n in zip(
        a, _leading_agreement(a, base_streams))))
    check(changed_by_adapter > 0, "lora_merge: the adapter changed no stream")
    emit("lora_merge", t0, card=card, lora_rank=lora_cfg.lora_rank, streams=LORA_STREAMS,
         tokens=LORA_TOKENS + 1, leading_tokens_equal=leading,
         streams_equal=int(sum(n == LORA_TOKENS + 1 for n in leading)),
         first_differences_near_ties=len(ties), tol_near_tie=TOL_NEAR_TIE,
         streams_the_adapter_changed=changed_by_adapter)
    del unmerged, merged


def _decode_launches(layers: int, steps: int) -> dict:
    """K1 and K2 of ``steps`` dense decode steps (the serve phase's formula)."""
    return {"ragged_decode_attention": layers * steps, "inplace_row_update": 2 * layers * steps}


def _lm_counts() -> dict:
    c = _all_counts()
    return {k: c[k] for k in ("ragged_decode_attention", "inplace_row_update")}


def _others_idle(counts: dict, phase: str):
    c = {k: v for k, v in _all_counts().items()
         if k not in ("ragged_decode_attention", "inplace_row_update") and v}
    check(not c, f"{phase}: kernels off the decode path launched: {c}")


def phase_serve_scanned(engine, tmp, card, want_fused):
    """ROADMAP 5.7: ``scan_layers=true serve_unroll_layers=false``. The serve
    engine's weights are written stacked (``decoder.layers.*``, a leading
    layer axis) by the checkpoint writer and loaded back by a scanned-config
    engine, which serves the 80 requests queued (fused admission) through its
    captured decode graph: the serve engine's streams, K1 and K2 once a layer
    a step."""
    from maxtext_indextts2_tpu_torch.config import load_config
    from maxtext_indextts2_tpu_torch.infer.engine import Engine
    from maxtext_indextts2_tpu_torch.train import checkpointing

    t0 = time.perf_counter()
    path = os.path.join(tmp, "scanned_params")
    checkpointing.save_params_only(path, checkpointing.stack_unrolled_params(engine.params))
    stacked = checkpointing.params_checkpoint_is_scanned(path)
    check(stacked is True, f"serve_scanned: the checkpoint is not stacked ({stacked})")
    t1 = time.perf_counter()
    scanned = Engine(load_config(SERVE_ARGS + ["scan_layers=true", "serve_unroll_layers=false",
                                               f"load_parameters_path={path}"]))
    scanned.load_params()
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t1
    check(scanned.scanned_layout and not scanned.cfg.scan_layers,
          "serve_scanned: the engine does not keep the stacked layout")
    differ = _same_tensors(scanned.params, engine.params)
    check(not differ, f"serve_scanned: loaded weights differ: {differ[:5]}")
    prompts, budgets = make_requests(np.random.default_rng(0), engine.cfg.vocab_size)
    _reset_all_counts()
    t1 = time.perf_counter()
    got, steps = _serve_queued(scanned, prompts, budgets)
    serve_s = time.perf_counter() - t1
    launches = _lm_counts()
    _others_idle(launches, "serve_scanned")
    layers = engine.cfg.num_decoder_layers
    check(launches == _decode_launches(layers, steps),
          f"serve_scanned: launches {launches} != predicted ({steps} steps)")
    check(scanned.graphs.captures >= 1 and scanned.graphs.replays > 0,
          f"serve_scanned: no captured decode graph ({scanned.graphs.captures} captures, "
          f"{scanned.graphs.replays} replays)")
    same = got == want_fused
    check(same, "serve_scanned: the scanned engine's streams differ from the serve engine's")
    tokens = sum(len(t) for t in got)
    emit("serve_scanned", t0, card=card, params_ckpt_bytes=_bytes(path), load_seconds=load_s,
         serve_seconds=serve_s, tokens=tokens, tokens_per_s=tokens / serve_s, decode_steps=steps,
         captures=scanned.graphs.captures, replays=scanned.graphs.replays,
         streams_equal=same, launches=launches)
    del scanned
    shutil.rmtree(path)
    return launches


def _serve_timed(engine, prompts, budgets, mode: str):
    """The serve phase's traffic (every request submitted once the loop
    runs) in ``mode``: seconds, tokens/s, each request's time to its first
    token (polled every millisecond), launches. Returns (fields, streams)."""
    from maxtext_indextts2_tpu_torch.infer.server import Orchestrator

    orch = Orchestrator(engine, steps_per_dispatch=STEPS_PER_DISPATCH, mode=mode)
    orch.start()
    torch.cuda.synchronize()
    _reset_all_counts()
    t1 = time.perf_counter()
    reqs = [orch.submit(p, n) for p, n in zip(prompts, budgets)]
    first = [None] * len(reqs)
    while any(f is None for f in first) and time.perf_counter() - t1 < 600:
        now = time.perf_counter() - t1
        for i, r in enumerate(reqs):
            if first[i] is None and (r.tokens or r.done.is_set()):
                first[i] = now
        time.sleep(0.001)
    finished = all(r.done.wait(timeout=600) for r in reqs)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t1
    launches = _lm_counts()
    orch.stop()
    check(finished and not any(r.error for r in reqs),
          f"serve_disaggregated ({mode}): {[r.error for r in reqs if r.error][:1]}")
    check(not orch._thread.is_alive() and (orch._prefill_thread is None
                                          or not orch._prefill_thread.is_alive()),
          f"serve_disaggregated ({mode}): stop() left a thread running")
    tokens = sum(len(r.tokens) for r in reqs)
    ttft = np.asarray([f for f in first if f is not None])
    return dict(mode=mode, seconds=seconds, tokens=tokens, tokens_per_s=tokens / seconds,
                ttft_p50_s=float(np.percentile(ttft, 50)),
                ttft_p99_s=float(np.percentile(ttft, 99)), ttft_max_s=float(ttft.max()),
                decode_steps=orch.stats["decode_steps_total"],
                prefills=orch.stats["prefills_total"],
                admission_dispatches=orch.stats["admission_dispatches_total"],
                launches=launches), [list(r.tokens) for r in reqs]


def phase_serve_disaggregated(engine, card, want_single, want_fused):
    """ROADMAP 5.9: the serve phase's 80 requests in disaggregated mode (a
    prefill thread on its own CUDA stream, the decode loop inserting and
    replaying its captured graph), beside interleaved mode on the same
    traffic: tokens/s and time to first token. Disaggregated admission is one
    prefill a request, so its streams are the serve engine's per-request
    streams; K1 and K2 once a layer a decode step."""
    t0 = time.perf_counter()
    prompts, budgets = make_requests(np.random.default_rng(0), engine.cfg.vocab_size)
    inter, _ = _serve_timed(engine, prompts, budgets, "interleaved")
    dis, streams = _serve_timed(engine, prompts, budgets, "disaggregated")
    layers = engine.cfg.num_decoder_layers
    check(dis["launches"] == _decode_launches(layers, dis["decode_steps"]),
          f"serve_disaggregated: launches {dis['launches']} != predicted "
          f"({dis['decode_steps']} steps)")
    check(dis["prefills"] == NUM_REQUESTS and dis["admission_dispatches"] == NUM_REQUESTS,
          f"serve_disaggregated: {dis['prefills']} prefills, {dis['admission_dispatches']} inserts")
    same = streams == want_single
    check(same, "serve_disaggregated: streams differ from the per-request interleaved ones")
    emit("serve_disaggregated", t0, card=card, requests=NUM_REQUESTS, disaggregated=dis,
         interleaved=inter, streams_equal=same,
         tokens_compared=sum(len(t) for t in streams),
         streams_equal_to_fused_admission=sum(a == b for a, b in zip(streams, want_fused)))
    return dis["launches"]


def _counting_generate(engine):
    """``engine.generate`` wrapped to count its calls (one decode step each)."""
    calls = [0]
    real = engine.generate

    def generate(state, *a, **k):
        calls[0] += 1
        return real(state, *a, **k)

    engine.generate = generate
    return calls


def phase_offline_loadgen(engine, card, want_single) -> dict:
    """ROADMAP 5.12 on the serve engine. ``offline_engine``: the 80 prompts
    through ``OfflineEngine.generate_batch`` (one prefill a prompt, one
    captured step a dispatch): each serve stream is a prefix of its offline
    stream. ``loadgen_offline``: the Offline scenario over the same prompts
    (VALID, samples/s). ``loadgen_server``: the Server scenario through the
    ``Orchestrator``, Poisson arrivals at LOADGEN_SERVER_RATE of the Offline
    rate (VALID, completed qps, latency percentiles). K1 and K2 once a layer
    a decode step in each."""
    from maxtext_indextts2_tpu_torch.infer.loadgen import (
        OFFLINE, SERVER, OfflineEngineSUT, OrchestratorSUT, QuerySampleLibrary, TestSettings,
        run_test,
    )
    from maxtext_indextts2_tpu_torch.infer.offline_engine import OfflineEngine
    from maxtext_indextts2_tpu_torch.infer.server import Orchestrator

    layers = engine.cfg.num_decoder_layers
    prompts, budgets = make_requests(np.random.default_rng(0), engine.cfg.vocab_size)
    offline = OfflineEngine(engine.cfg, engine=engine)
    out = {}
    calls = _counting_generate(engine)
    try:
        t0 = time.perf_counter()
        _reset_all_counts()
        outs = offline.generate_batch(prompts, OFFLINE_NEW_TOKENS)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = _lm_counts()
        check(launches == _decode_launches(layers, calls[0]),
              f"offline_engine: launches {launches} != predicted ({calls[0]} steps)")
        same = all(o[:len(w)] == w for o, w in zip(outs, want_single))
        check(same and all(len(o) == OFFLINE_NEW_TOKENS for o in outs),
              "offline_engine: a stream differs from the serve engine's")
        tokens = sum(len(o) for o in outs)
        emit("offline_engine", t0, card=card, prompts=len(prompts), tokens=tokens,
             seconds=seconds, tokens_per_s=tokens / seconds, decode_steps=calls[0],
             captures=engine.graphs.captures, streams_equal=same,
             tokens_compared=sum(len(w) for w in want_single), launches=launches)
        out["offline_engine"] = launches

        qsl = QuerySampleLibrary(prompts)
        t0 = time.perf_counter()
        calls[0] = 0
        _reset_all_counts()
        res = run_test(OfflineEngineSUT(offline, LOADGEN_NEW_TOKENS).bind(qsl), qsl,
                       TestSettings(scenario=OFFLINE, min_query_count=len(prompts)))
        launches = _lm_counts()
        check(res.valid and res.completed == len(prompts),
              f"loadgen_offline: {res.summary()}")
        check(launches == _decode_launches(layers, calls[0]),
              f"loadgen_offline: launches {launches} != predicted ({calls[0]} steps)")
        emit("loadgen_offline", t0, card=card, valid=res.valid, issued=res.issued,
             completed=res.completed, samples_per_s=res.completed_qps,
             new_tokens=LOADGEN_NEW_TOKENS, decode_steps=calls[0], launches=launches,
             summary=res.summary())
        out["loadgen_offline"] = launches
    finally:
        del engine.generate
    offline_rate = res.completed_qps

    t0 = time.perf_counter()
    orch = Orchestrator(engine, steps_per_dispatch=STEPS_PER_DISPATCH)
    orch.start()
    _reset_all_counts()
    target = LOADGEN_SERVER_RATE * offline_rate
    try:
        res = run_test(OrchestratorSUT(orch, LOADGEN_NEW_TOKENS).bind(qsl), qsl, TestSettings(
            scenario=SERVER, target_qps=target, min_duration_s=LOADGEN_MIN_SECONDS,
            min_query_count=len(prompts), server_target_latency_s=LOADGEN_LATENCY_BOUND_S))
    finally:
        orch.stop()
    launches = _lm_counts()
    steps = orch.stats["decode_steps_total"]
    check(res.valid and res.completed == res.issued, f"loadgen_server: {res.summary()}")
    check(launches == _decode_launches(layers, steps),
          f"loadgen_server: launches {launches} != predicted ({steps} steps)")
    emit("loadgen_server", t0, card=card, valid=res.valid, target_qps=target,
         scheduled_qps=res.scheduled_qps, completed_qps=res.completed_qps, issued=res.issued,
         completed=res.completed, latency_s=res.percentiles,
         latency_bound_s=LOADGEN_LATENCY_BOUND_S, decode_steps=steps, launches=launches,
         summary=res.summary())
    out["loadgen_server"] = launches
    return out


def phase_microbenchmark(engine, card):
    """ROADMAP 5.12: ``run_microbenchmark`` on the serve engine at the
    config's ``inference_microbenchmark_prefill_lengths`` (those within the
    prefill limit); its JSON document on a line of its own."""
    from maxtext_indextts2_tpu_torch.infer.microbenchmark import run_microbenchmark

    t0 = time.perf_counter()
    _reset_all_counts()
    doc = run_microbenchmark(engine.cfg, engine=engine)
    launches = _lm_counts()
    print(json.dumps({"phase": "microbenchmark_document", "card": card, **doc}), flush=True)
    want = [n for n in engine.cfg.inference_microbenchmark_prefill_lengths
            if n <= engine.cfg.max_prefill_predict_length]
    check(sorted(int(k) for k in doc["prefill_ms"]) == sorted(want)
          and doc["decode"]["slots"] == engine.num_slots and doc["decode"]["step_ms"] > 0,
          f"microbenchmark: {doc}")
    # 4 + 4 + 20 + 20 decode steps with every slot full (prefills launch neither)
    layers = engine.cfg.num_decoder_layers
    check(launches["ragged_decode_attention"] >= layers * 48
          and launches["inplace_row_update"] >= 2 * layers * 48,
          f"microbenchmark: launches {launches}")
    emit("microbenchmark", t0, card=card, prefill_lengths=want, launches=launches)
    return launches


def phase_uniserver(pipe, card):
    """ROADMAP 5.11: the single-threaded UniServer over the full-width
    pipeline (one request an admission: the /generate streams are then the
    threaded server's per-request ones): 8 concurrent ``POST /tts`` (the
    tts_http bodies), 4 ``/generate``, 1 ``/generate_stream``, ``/health``
    and ``/metrics`` at once. /tts answers finite and of tts_http's lengths,
    K1 / K2 once a layer a decode step, K5-K8 as the sampler predicts, K12
    never; the stage clock."""
    from maxtext_indextts2_tpu_torch.infer.uniserver import UniServer

    t0 = time.perf_counter()
    cfg = dataclasses.replace(pipe.cfg, tts_allow_force_frames=True,
                              tts_batch_max=HTTP_REQUESTS, tts_batch_window_ms=2000,
                              serving_admission_fusion_max=1)
    bodies, frames, _ = _tts_bodies(60)
    payloads = [json.dumps(b).encode() for b in bodies]
    rng = np.random.default_rng(11)
    lm_prompts = [rng.integers(1, cfg.vocab_size, size=int(n)).astype(np.int32)
                  for n in rng.integers(8, 401, size=UNI_GENERATE)]
    want, _ = _serve_queued(pipe.engine, lm_prompts, [UNI_GENERATE_TOKENS] * UNI_GENERATE,
                            fusion=1)
    srv = UniServer(cfg, pipe, port=0, host="127.0.0.1")
    srv.start()
    t1 = time.perf_counter()
    srv.warm()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t1
    captures = pipe.engine.graphs.captures
    url = f"http://127.0.0.1:{srv.port}"
    answers: dict = {}

    def call(key, path, payload=None):
        req = urllib.request.Request(url + path, data=payload,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=900) as resp:
            raw = resp.read().decode()
        answers[key] = raw

    jobs = [(("tts", i), "/tts", payloads[i]) for i in range(HTTP_REQUESTS)]
    for i, p in enumerate(lm_prompts):
        path = "/generate_stream" if i == UNI_GENERATE - 1 else "/generate"
        body = {"prompt": p.tolist(), "max_new_tokens": UNI_GENERATE_TOKENS}
        jobs.append((("lm", i), path, json.dumps(body).encode()))
    jobs += [(("health", 0), "/health", None), (("metrics", 0), "/metrics", None)]
    stage_before = dict(srv.stage_s)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_all_counts()
        t1 = time.perf_counter()
        posts = [threading.Thread(target=call, args=j) for j in jobs]
        for p in posts:
            p.start()
        for p in posts:
            p.join(timeout=900)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t1
        launches = _all_counts()
        with urllib.request.urlopen(url + "/metrics", timeout=60) as resp:
            metrics = resp.read().decode()
    finally:
        srv.stop()
        thread.join(timeout=60)
        srv.close()
    check(not thread.is_alive(), "uniserver: the event loop did not stop")
    check(len(answers) == len(jobs), f"uniserver: {len(jobs) - len(answers)} requests unanswered")
    hop = int(np.prod(pipe.codec.strides))
    for i, n in enumerate(frames):
        a = json.loads(answers[("tts", i)])
        check("wav_b64" in a, f"uniserver: /tts {i} failed: {a.get('error')}")
        wav = np.frombuffer(base64.b64decode(a["wav_b64"]), np.float32)
        check(a["info"]["semantic_tokens"] == n and wav.shape == (n * hop,),
              f"uniserver: /tts {i} got {wav.shape} samples for {n} frames")
        check(bool(np.isfinite(wav).all()) and float(wav.std()) > 0,
              f"uniserver: /tts {i}'s waveform is not finite or is constant")
    got = []
    for i in range(UNI_GENERATE):
        raw = answers[("lm", i)]
        if i == UNI_GENERATE - 1:
            lines = [json.loads(line) for line in raw.splitlines() if line.strip()]
            check(all("token" in line for line in lines), f"uniserver: stream {lines[-1:]}")
            got.append([line["token"] for line in lines])
        else:
            got.append(json.loads(raw).get("tokens"))
    same = got == want
    check(same, "uniserver: /generate streams differ from the threaded server's")
    health = json.loads(answers[("health", 0)])
    check(health.get("ok") is True, f"uniserver: /health {health}")
    check("serving_stage_decode_seconds" in answers[("metrics", 0)]
          and f"serving_requests_completed {HTTP_REQUESTS + UNI_GENERATE}" in metrics,
          "uniserver: /metrics lacks the stage clock or the completed requests")
    dispatches = srv.stats["decode_dispatches"]
    forwards = _denoiser_forwards(pipe) * srv.stats["s2a_batches"]
    c, layers = pipe.s2a.cfg, pipe.engine.cfg.num_decoder_layers
    want_launches = {**_decode_launches(layers, dispatches * srv.spd),
                     "ada_rmsnorm": forwards, "row_quantize_int8": c.num_layers * forwards,
                     "ada_rmsnorm_quantize": 2 * c.num_layers * forwards,
                     "silu_mul_quantize": c.num_layers * forwards, "s2a_attention": 0,
                     **NO_FLASH, **NO_PAGED, **NO_INT8W, **NO_GMM}
    check(launches == want_launches, f"uniserver: launches {launches} != predicted "
                                     f"{want_launches} ({dispatches} dispatches)")
    check(pipe.engine.graphs.captures == captures,
          "uniserver: a decode graph was captured while serving (warm() missed one)")
    audio = sum(n * hop for n in frames) / 24_000.0
    stage = {k: v - stage_before[k] for k, v in srv.stage_s.items()}
    emit("uniserver", t0, card=card, requests=len(jobs), warm_seconds=warm_s,
         http_seconds=seconds, audio_seconds=audio, s2a_batches=srv.stats["s2a_batches"],
         decode_dispatches=dispatches, steps_per_dispatch=srv.spd, generate_streams_equal=same,
         generate_tokens_compared=sum(len(t) for t in got), stage_seconds=stage,
         stage_max_seconds=srv.stage_max, device_memory=srv._dev_mem(), launches=launches,
         peak_memory_bytes=torch.cuda.max_memory_allocated())
    return launches


def _bytes(path: str) -> int:
    if os.path.isfile(path):
        return os.path.getsize(path)
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def _same_tensors(got: dict, want: dict) -> list[str]:
    """Names whose tensors differ (or are missing) between two state dicts."""
    bad = sorted(set(got) ^ set(want))
    for k in set(got) & set(want):
        a, b = got[k], want[k]
        if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(
                a.to(b.device), b):
            bad.append(k)
    return bad


def _serve_queued(engine, prompts, budgets, fusion: int = 8):
    """Every request queued before the Orchestrator's loop starts, so that its
    admission groups do not depend on timing: the same engine weights give
    the same streams, token for token (``fusion=1``: one request an
    admission). Returns (streams, decode steps)."""
    from maxtext_indextts2_tpu_torch.infer.server import Orchestrator

    orch = Orchestrator(engine, steps_per_dispatch=STEPS_PER_DISPATCH,
                        admission_fusion_max=fusion)
    reqs = [orch.submit(p, n) for p, n in zip(prompts, budgets)]
    orch.start()
    finished = all(r.done.wait(timeout=600) for r in reqs)
    torch.cuda.synchronize()
    orch.stop()
    check(finished and not any(r.error for r in reqs), "a queued serve did not finish cleanly")
    return [list(r.tokens) for r in reqs], orch.stats["decode_steps_total"]


def phase_lm_ckpt(engine, tmp):
    """tts-1b's served weights (bf16) out with HF names (``pytorch_model.bin``)
    and back through the converter CLI to a params-only checkpoint, loaded by
    a fresh ``Engine.load_params``; both engines serve the serve phase's 80
    requests (32 slots, greedy): K1 and K2 on loaded weights, the same streams."""
    from maxtext_indextts2_tpu_torch.config import load_config
    from maxtext_indextts2_tpu_torch.infer.engine import Engine
    from maxtext_indextts2_tpu_torch.ops import inplace_update, ragged_decode_attention
    from maxtext_indextts2_tpu_torch.utils import ckpt_conversion

    t0 = time.perf_counter()
    hf_dir, ckpt = os.path.join(tmp, "lm_hf"), os.path.join(tmp, "lm_params")
    os.makedirs(hf_dir)
    t1 = time.perf_counter()
    hf = ckpt_conversion.convert_framework_to_hf_llama(engine.params, engine.cfg)
    torch.save(hf, os.path.join(hf_dir, "pytorch_model.bin"))
    export_s, hf_tensors = time.perf_counter() - t1, len(hf)
    del hf
    t1 = time.perf_counter()
    ckpt_conversion.main(["--hf_path", hf_dir, "--out_path", ckpt, *LM_CKPT_CONVERT_ARGS])
    convert_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    loaded = Engine(load_config(SERVE_ARGS))
    loaded.load_params(ckpt)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t1
    differ = _same_tensors(loaded.params, engine.params)
    check(not differ, f"lm_ckpt: loaded weights differ from the exported ones: {differ[:5]}")

    prompts, budgets = make_requests(np.random.default_rng(0), engine.cfg.vocab_size)
    want, _ = _serve_queued(engine, prompts, budgets)
    ragged_decode_attention.launch_count = inplace_update.launch_count = 0
    t1 = time.perf_counter()
    got, steps = _serve_queued(loaded, prompts, budgets)
    serve_s = time.perf_counter() - t1
    launches = {"ragged_decode_attention": ragged_decode_attention.launch_count,
                "inplace_row_update": inplace_update.launch_count}
    layers = engine.cfg.num_decoder_layers
    predicted = {"ragged_decode_attention": layers * steps,
                 "inplace_row_update": 2 * layers * steps}
    check(launches == predicted, f"lm_ckpt: launches {launches} != predicted {predicted}")
    same = got == want
    check(same, "lm_ckpt: the loaded engine's greedy streams differ from the exported engine's")
    check(all(len(t) == n for t, n in zip(got, budgets)), "lm_ckpt: a stream is short")
    emit("lm_ckpt", t0, hf_bin_bytes=_bytes(os.path.join(hf_dir, "pytorch_model.bin")),
         hf_tensors=hf_tensors, params_ckpt_bytes=_bytes(ckpt), export_seconds=export_s,
         convert_seconds=convert_s, load_seconds=load_s, serve_seconds=serve_s,
         requests=len(got), tokens_compared=sum(len(t) for t in got), streams_equal=same,
         decode_steps=steps, launches=launches)
    del loaded
    shutil.rmtree(hf_dir)
    shutil.rmtree(ckpt)


def phase_train_resume(tmp):
    """The train recipe at full width with asynchronous checkpoints: 2 steps,
    a save, step 3 BEFORE the write is waited for (the parameters and Adam
    moments update in place), then the files against the state of step 2; a
    fresh state restored through the training entry point runs step 3 again
    and must give its loss and weights bitwise; the checkpoint's params then
    serve one request through ``Engine.load_params`` and K1."""
    from maxtext_indextts2_tpu_torch.config import load_config
    from maxtext_indextts2_tpu_torch.infer.engine import Engine
    from maxtext_indextts2_tpu_torch.ops import ragged_decode_attention
    from maxtext_indextts2_tpu_torch.train import checkpointing, train

    t0 = time.perf_counter()
    ckpt_dir = os.path.join(tmp, "train_ckpt")
    cfg = load_config(TRAIN_RESUME_ARGS + [f"checkpoint_dir={ckpt_dir}"])
    state = train.setup_train_state(cfg)  # no device given: the GPU, or an error
    batches = train.create_data_iterator(cfg, state.device)
    manager, period = train.make_checkpointer(cfg)
    _reset_all_counts()
    losses = [float(train.train_step(cfg, state, next(batches))["loss"]) for _ in range(2)]
    torch.cuda.synchronize()
    step2 = {"params": {k: v.detach().clone() for k, v in state.params.items()},
             **{m: {k: v.clone() for k, v in state.opt_state[m].items()} for m in ("mu", "nu")}}
    t1 = time.perf_counter()
    manager.save(period - 1, state)
    save_return_s = time.perf_counter() - t1
    losses.append(float(train.train_step(cfg, state, next(batches))["loss"]))  # step 3
    torch.cuda.synchronize()
    step3_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    manager.wait()
    wait_s = time.perf_counter() - t1
    launches = _all_counts()
    step3_params = {k: v.detach().clone() for k, v in state.params.items()}
    # the live tensors that step 3 moved: the files must still hold step 2's
    moved = {"params": _same_tensors(step3_params, step2["params"]),
             **{m: _same_tensors(state.opt_state[m], step2[m]) for m in ("mu", "nu")}}
    check(all(moved.values()), f"train_resume: step 3 moved no tensor of "
                               f"{[m for m, v in moved.items() if not v]}")
    path = manager.step_path(period - 1)
    t1 = time.perf_counter()
    on_disk = {"params": dict(checkpointing.load_params_only(path)),
               **{m: v for m, v in torch.load(os.path.join(path, checkpointing.OPT_FILE),
                                              weights_only=True, mmap=True).items()
                  if m in ("mu", "nu")}}
    differ = {m: _same_tensors(on_disk[m], step2[m]) for m in step2}
    read_s = time.perf_counter() - t1
    check(not any(differ.values()), f"train_resume: the async save is not step 2's state: "
                                    f"{ {m: d[:3] for m, d in differ.items()} }")
    ckpt_bytes = _bytes(path)
    del state, step2, on_disk, batches, manager
    gc.collect()
    torch.cuda.empty_cache()

    t1 = time.perf_counter()
    resumed = train.train_loop(load_config(TRAIN_RESUME_ARGS + [
        f"checkpoint_dir={ckpt_dir}", "save_final_checkpoint=true"]), quiet=True)
    resume_s = time.perf_counter() - t1
    resumed_losses = [h["loss"] for h in resumed["history"]]
    check(resumed_losses == losses[2:], f"train_resume: resumed step 3 loss {resumed_losses} "
                                        f"!= uninterrupted {losses[2:]}")
    final = dict(checkpointing.load_params_only(ckpt_dir))
    differ = _same_tensors(final, step3_params)
    check(not differ, f"train_resume: resumed step 3 weights differ: {differ[:5]}")
    kept = sorted(os.listdir(ckpt_dir))
    check(kept == [str(cfg.steps - 1)], f"train_resume: max_to_keep=1 left {kept}")
    del final, step3_params
    gc.collect()
    torch.cuda.empty_cache()

    t1 = time.perf_counter()
    engine = Engine(load_config(SERVE_ARGS + ["per_device_batch_size=1",
                                              f"load_parameters_path={ckpt_dir}"]))
    engine.load_params()
    load_s = time.perf_counter() - t1
    ragged_decode_attention.launch_count = 0
    tokens = engine.generate_stream(np.arange(1, 33, dtype=np.int32), RESUME_DECODE_TOKENS)
    k1 = ragged_decode_attention.launch_count
    layers = cfg.num_decoder_layers
    check(len(tokens) == RESUME_DECODE_TOKENS and all(0 <= t < cfg.vocab_size for t in tokens),
          f"train_resume: decode from the checkpoint gave {tokens}")
    check(k1 == layers * (RESUME_DECODE_TOKENS - 1),
          f"train_resume: K1 launched {k1} times, predicted {layers * (RESUME_DECODE_TOKENS - 1)}")
    want = {k: 0 for k in launches}
    want.update({k: n * layers * 3 for k, n in TRAIN_LAUNCHES_PER_LAYER.items()})
    check(launches == want, f"train_resume: launches of 3 steps {launches} != {want}")
    emit("train_resume", t0, losses=losses, resumed_step3_loss=resumed_losses[0],
         loss_bitwise_equal=True, weights_bitwise_equal=True, snapshot_untouched_by_step3=True,
         tensors_moved_by_step3={m: len(v) for m, v in moved.items()},
         checkpoint_bytes=ckpt_bytes, save_return_seconds=save_return_s,
         step3_seconds_after_save=step3_s, wait_seconds=wait_s, read_back_seconds=read_s,
         resume_run_seconds=resume_s, engine_load_seconds=load_s, decode_tokens=tokens,
         k1_launches_decode=k1, launches_3_steps=launches)


def _record_codes(pipe):
    """Wraps ``pipe.s2a.reverse_diffusion`` to keep its codes; returns the list."""
    codes, sample = [], pipe.s2a.reverse_diffusion

    def recorded(*args, **kwargs):
        codes.append(sample(*args, **kwargs))
        return codes[-1]

    pipe.s2a.reverse_diffusion = recorded
    return codes


def phase_audio_ckpt(pipe, tmp):
    """The full-width pipeline's audio weights (its S2A rebuilt natively from
    seeded float weights, non-trivial tap statistics) written as the
    reference's files; a second pipeline from another seed loads them with
    ``load_torch_audio_weights`` and ``SemanticTokenizer.load_torch_weights``,
    the ISTFT head carried across; ``synthesize`` on the same prompt and
    sampler seed through both: prompt ids, codes and waveform equal, K5-K8
    and K12 launched as predicted."""
    from maxtext_indextts2_tpu_torch.audio import torch_ckpt as tc
    from maxtext_indextts2_tpu_torch.audio.conformer import config_from_hf_state_dict
    from maxtext_indextts2_tpu_torch.audio.pipeline import (
        build_serving_s2a, build_tiny_pipeline, prompt_signal, s2a_config_from,
    )
    from maxtext_indextts2_tpu_torch.audio.s2a import S2AModel
    from maxtext_indextts2_tpu_torch.tools import reference_state_dicts as rsd

    t0 = time.perf_counter()
    device = pipe.device
    gen = torch.Generator(device=device).manual_seed(AUDIO_CKPT_SEED + 100)
    float_s2a = S2AModel(s2a_config_from(pipe.cfg), device=device, generator=gen).state_dict()
    pipe.s2a = build_serving_s2a(s2a_config_from(pipe.cfg), pipe.cfg.s2a_serving_dtype,
                                 float_s2a, device=device)
    enc = pipe.semantic_tokenizer.encoder
    with torch.no_grad():
        enc.stat_mean.normal_(0.0, 0.1, generator=gen)
        enc.stat_std.uniform_(0.5, 2.0, generator=gen)
    t1 = time.perf_counter()
    out_dir = os.path.join(tmp, "audio")
    os.makedirs(out_dir)
    artifacts = {
        "s2a": rsd.s2a_state_dict(float_s2a),
        "codec_encoder": rsd.codec_encoder_state_dict(pipe.codec.encoder),
        "codec_decoder": rsd.codec_decoder_state_dict(pipe.codec.decoder),
        "w2vbert": rsd.hf_w2vbert_state_dict(enc),
        "repcodec": rsd.repcodec_state_dict(pipe.semantic_tokenizer.repcodec),
        "stats": rsd.semantic_stats(enc),
    }
    files = {}
    for name, sd in artifacts.items():
        files[name] = os.path.join(out_dir, f"{name}.pt")
        torch.save(sd, files[name])
    del artifacts, float_s2a
    export_s = time.perf_counter() - t1

    t1 = time.perf_counter()
    sds = {k: torch.load(f, map_location="cpu", weights_only=True) for k, f in files.items()}
    read_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    # the second pipeline is sized from the files, as the CLI sizes it
    ek = tc.codec_encoder_kwargs_from_torch(sds["codec_encoder"])
    dk = tc.codec_decoder_kwargs_from_torch(sds["codec_decoder"])
    codec_kwargs = dict(d_model=ek["d_model"], strides=ek["strides"], latent_dim=ek["out_channels"],
                        **{k: dk[k] for k in ("num_quantizers", "codebook_size", "codebook_dim",
                                              "vocos_dim", "vocos_intermediate_dim",
                                              "vocos_num_layers")})
    rep_kwargs = tc.repcodec_kwargs_from_torch(sds["repcodec"])
    rep_kwargs.pop("hidden_size")
    other = build_tiny_pipeline(
        pipe.cfg, seed=AUDIO_CKPT_SEED, codec_kwargs=codec_kwargs, device=device,
        engine=pipe.engine, semantic_encoder_cfg=config_from_hf_state_dict(sds["w2vbert"]),
        semantic_repcodec_kwargs=rep_kwargs)
    build_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    other.load_torch_audio_weights(s2a_state_dict=sds["s2a"],
                                   codec_encoder_state_dict=sds["codec_encoder"],
                                   codec_decoder_state_dict=sds["codec_decoder"])
    other.semantic_tokenizer.load_torch_weights(sds["w2vbert"], sds["repcodec"], sds["stats"])
    other.codec.decoder.head.load_state_dict(pipe.codec.decoder.head.state_dict())
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t1
    del sds
    for part in ("s2a", "codec", "semantic_tokenizer"):
        differ = _same_tensors(getattr(other, part).state_dict(), getattr(pipe, part).state_dict())
        check(not differ, f"audio_ckpt: loaded {part} differs: {differ[:5]}")

    w16 = prompt_signal(42, SYNTH_PROMPT_SECONDS, 16_000)
    w24 = prompt_signal(42, SYNTH_PROMPT_SECONDS, 24_000)
    text = "Weights written as the reference's files read back on the card."
    ids = [p._prompt_tokens(w16[None], [len(w16)], w24[None]) for p in (pipe, other)]
    same_ids = all(np.array_equal(a, b) for a, b in zip(*ids))
    check(same_ids, "audio_ckpt: prompt ids differ between the source and the loaded pipeline")
    out = {}
    for name, p in (("source", pipe), ("loaded", other)):
        codes = _record_codes(p)
        torch.cuda.synchronize()
        _reset_all_counts()
        t1 = time.perf_counter()
        try:
            wav, info = p.synthesize(text, w16, w24, max_new_tokens=SYNTH_FRAMES,
                                     generator=torch.Generator(device=device).manual_seed(5))
        finally:
            del p.s2a.reverse_diffusion
        torch.cuda.synchronize()
        out[name] = (wav, info, codes[0], _all_counts(), time.perf_counter() - t1)
    (wav_a, info_a, codes_a, _, _), (wav_b, info_b, codes_b, launches, synth_s) = \
        out["source"], out["loaded"]
    c, layers = other.s2a.cfg, other.engine.cfg.num_decoder_layers
    forwards = _denoiser_forwards(other)
    want = {"ragged_decode_attention": layers * (SYNTH_FRAMES - 1),
            "inplace_row_update": 2 * layers * (SYNTH_FRAMES - 1),
            "ada_rmsnorm": forwards, "row_quantize_int8": c.num_layers * forwards,
            "ada_rmsnorm_quantize": 2 * c.num_layers * forwards,
            "silu_mul_quantize": c.num_layers * forwards,
            "s2a_attention": c.num_layers * forwards, **NO_FLASH, **NO_PAGED, **NO_INT8W, **NO_GMM}
    check(launches == want, f"audio_ckpt: launches {launches} != predicted {want}")
    check(info_b["semantic_tokens"] == info_a["semantic_tokens"] == SYNTH_FRAMES,
          f"audio_ckpt: {info_b['semantic_tokens']} frames")
    same_codes = bool(torch.equal(codes_a, codes_b))
    check(same_codes, "audio_ckpt: acoustic codes differ")
    wav_err = float(np.abs(wav_a - wav_b).max())
    check(wav_a.shape == wav_b.shape and wav_err == 0.0,
          f"audio_ckpt: waveforms differ by {wav_err}")
    check(bool(np.isfinite(wav_b).all()) and float(wav_b.std()) > 0,
          "audio_ckpt: a waveform that is not finite or is constant")
    emit("audio_ckpt", t0, file_bytes={k: _bytes(f) for k, f in files.items()},
         export_seconds=export_s, read_seconds=read_s, build_other_seed_seconds=build_s,
         load_seconds=load_s,
         semantic_encoder_layers=other.semantic_tokenizer.encoder_cfg.num_layers,
         synthesize_seconds=synth_s, prompt_ids_equal=same_ids, codes_equal=same_codes,
         codes_shape=list(codes_b.shape), wav_max_abs_err=wav_err, wav_samples=len(wav_b),
         denoiser_forwards=forwards, launches=launches)
    semantic = ids[0][0][0, : int(ids[0][1][0])]
    del other
    gc.collect()
    torch.cuda.empty_cache()
    return files, (w16, w24), semantic


def _build_state() -> dict:
    from maxtext_indextts2_tpu_torch.ops import _build

    return {f: os.path.getmtime(os.path.join(_build.BUILD_DIR, f))
            for f in sorted(os.listdir(_build.BUILD_DIR))}


def _cli_value(v) -> str:
    if isinstance(v, (tuple, list)):
        return "[" + ",".join(str(x) for x in v) + "]"
    return str(v)


def phase_audio_cli(pipe, tmp, files, prompt, semantic):
    """``python -m maxtext_indextts2_tpu_torch.audio.cli`` in subprocesses on
    the card: ``tokenize`` of a scipy-written WAV with audio_ckpt's files (its
    ids equal audio_ckpt's prompt ids), then ``synthesize`` with every stage
    from files (the LM from a params-only checkpoint of the pipeline's
    audio-only engine): exit 0 and a finite, non-constant WAV. The
    subprocesses reuse the kernel library this run built."""
    from scipy.io import wavfile

    from maxtext_indextts2_tpu_torch.train.checkpointing import save_params_only

    t0 = time.perf_counter()
    w16, w24 = prompt
    wav16, wav24 = os.path.join(tmp, "prompt16.wav"), os.path.join(tmp, "prompt24.wav")
    wavfile.write(wav16, 16_000, w16)  # float32 WAVs: read back exactly
    wavfile.write(wav24, 24_000, w24)
    lm = os.path.join(tmp, "lm_audio_only")
    save_params_only(lm, pipe.engine.params)
    built = _build_state()
    audio_args = [f"{k}={f}" for k, f in files.items()]
    ids_path, out_wav = os.path.join(tmp, "ids.npy"), os.path.join(tmp, "cli_out.wav")
    commands = {
        "tokenize": ["tokenize", f"input={wav16}", f"out={ids_path}",
                     *(a for a in audio_args if a.split("=")[0] in ("w2vbert", "repcodec",
                                                                   "stats"))],
        "synthesize": ["synthesize", "text=The command line reads the same files.",
                       f"prompt={wav16}", f"prompt24k={wav24}", f"out={out_wav}",
                       f"max_new_tokens={CLI_FRAMES}", *audio_args,
                       f"load_parameters_path={lm}",
                       *(f"{k}={_cli_value(getattr(pipe.cfg, k))}" for k in CLI_CONFIG_KEYS)],
    }
    seconds, printed = {}, {}
    for name, args in commands.items():
        t1 = time.perf_counter()
        run = subprocess.run([sys.executable, "-m", "maxtext_indextts2_tpu_torch.audio.cli",
                              *args], cwd=REPO, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True, timeout=600)
        seconds[name] = time.perf_counter() - t1
        check(run.returncode == 0, f"audio_cli {name}: exit {run.returncode}: "
                                   f"{run.stdout[-2000:]}")
        printed[name] = json.loads(run.stdout.strip().splitlines()[-1])
    ids = np.load(ids_path)
    same_ids = bool(np.array_equal(ids, semantic))
    check(same_ids, f"audio_cli: tokenize ids ({len(ids)}) differ from audio_ckpt's "
                    f"({len(semantic)})")
    sr, data = wavfile.read(out_wav)
    hop = int(np.prod(pipe.codec.strides))
    check(sr == 24_000 and data.shape == (CLI_FRAMES * hop,),
          f"audio_cli: a WAV of {data.shape} at {sr} Hz for {CLI_FRAMES} frames")
    check(bool(np.isfinite(data).all()) and float(data.std()) > 0,
          "audio_cli: the WAV is not finite or is constant")
    rebuilt = _build_state() != built
    check(not rebuilt, "audio_cli: a subprocess rebuilt the kernel library")
    check(all(p.get("device", "").startswith("cuda") for p in printed.values()),
          f"audio_cli: a subprocess did not run on the card: {printed}")
    emit("audio_cli", t0, tokenize_seconds=seconds["tokenize"],
         synthesize_seconds=seconds["synthesize"], lm_ckpt_bytes=_bytes(lm),
         wav_bytes=_bytes(out_wav), ids=len(ids), ids_equal=same_ids, frames=CLI_FRAMES,
         wav_std=float(data.std()), kernel_library_rebuilt=rebuilt,
         tokenize=printed["tokenize"], synthesize=printed["synthesize"])


# ROADMAP 5.10, the gRPC front end: 8 streamed Decode calls over the serve
# engine, their greedy tokens against /generate's for the same prompts; one
# Synthesize over the full-width pipeline, its chunks against synthesize's
# waveform (chunks of a third of it, so that it arrives in three).
GRPC_STREAMS = 8
GRPC_NEW_TOKENS = 32

# ROADMAP item 6, serving: the other model families at full width, weights
# drawn in bfloat16 on the card (weight_dtype=bfloat16), 8 slots of a
# 2048-token cache, 8 greedy requests of 16-1024 prompt tokens and 64 new
# ones through the Orchestrator, decode captured (4 steps a dispatch). Each
# phase frees its engine before the next. Cuts of depth, listed: mixtral-8x7b
# 8 of its 32 layers (a whole one is 93 GB), llama4-scout 4 of its 48 (216 GB)
# with a 256-token attention chunk (its 8192 would need prompts of 8192 to
# cross one).
FAMILY_PROMPT_LENGTHS = (16, 512, 200, 1024, 64, 700, 300, 333)
FAMILY_NEW_TOKENS = 64
FAMILY_ARGS = ["weight_dtype=bfloat16", "serve_params_dtype=bfloat16", "dtype=bfloat16",
               "decode_attention=ragged", "decode_sampling_strategy=greedy",
               "per_device_batch_size=8", "max_target_length=2048",
               "max_prefill_predict_length=1024", "scan_layers=false"]
MOE_ARGS = ["model_name=qwen3-30b-a3b"] + FAMILY_ARGS
MOE_PARAMS = 30_532_122_624
MIXTRAL_LAYERS = 8
MIXTRAL_ARGS = ["model_name=mixtral-8x7b", f"base_num_decoder_layers={MIXTRAL_LAYERS}"] \
    + FAMILY_ARGS
MIXTRAL_PARAMS = 11_872_309_248
MLA_ARGS = ["model_name=deepseek-v2-lite"] + FAMILY_ARGS
MLA_PARAMS = 15_706_484_224
GPT3_ARGS = ["model_name=gpt3-6b"] + FAMILY_ARGS
GPT3_PARAMS = 5_544_695_808
LLAMA4_LAYERS = 4
LLAMA4_CHUNK = 256
LLAMA4_ARGS = ["model_name=llama4-scout-17b-16e", f"base_num_decoder_layers={LLAMA4_LAYERS}",
               f"chunk_attn_window_size={LLAMA4_CHUNK}"] + FAMILY_ARGS
LLAMA4_PARAMS = 10_877_383_680
# cached greedy against the teacher-forced argmax: 16 tokens of 4 streams,
# each the argmax of a prefill forward over prompt + stream or within a near
# tie of it (TOL_NEAR_TIE of the largest |logit|: the prefill and the cached
# decode sum in other orders in bfloat16)
TEACHER_FORCED_STREAMS = 4
TEACHER_FORCED_TOKENS = 16
# moe_serve_parity: one decode step on the sparse route (the grouped kernels)
# against the dense einsum route, both on the card in bfloat16 from one
# populated state: the experts' outputs differ by a bfloat16 step here and
# there (other summation order), which 48 layers carry to the logits as a
# share of their scale (the flagship parity's bound, 2**-4 of the largest
# logit); the argmax equal, or within a near tie.
TOL_MOE_PARITY_REL = 2.0 ** -4
# every MoE family phase: one eager decode step with each MoE layer run on
# both routes from the same inputs and routing, max |sparse - dense| over the
# layer's largest |dense output|. bf16: the routes round the same bfloat16
# intermediates and differ in summation order only, a step or two of
# bfloat16 (2**-8) near the largest output. int8w_serve: the sparse route
# also rounds each row of activations to 127 steps of its largest |value|
# (q_rows), where the dense route multiplies the dequantized experts by the
# bfloat16 activations: about 1 % of the output's scale, 2**-4 leaves room
# for the tail.
TOL_ROUTES_BF16 = 2.0 ** -6
TOL_ROUTES_INT8 = 2.0 ** -4


def phase_grpc(engine, card):
    """ROADMAP 5.10: 8 streamed ``Decode`` calls over the serve engine on
    localhost, one after another as the 8 ``/generate`` calls they are held
    against (each admitted alone: a packed admission rounds its bfloat16
    prefill in another order), their greedy tokens equal; then the same 8 at
    once (every stream its full budget); ``HealthCheck``."""
    from maxtext_indextts2_tpu_torch.infer import grpc_server as gs
    from maxtext_indextts2_tpu_torch.infer.proto import orchestrator_pb2 as pb
    from maxtext_indextts2_tpu_torch.infer.server import Orchestrator, make_server
    import grpc

    t0 = time.perf_counter()
    rng = np.random.default_rng(40)
    prompts = [rng.integers(1, engine.cfg.vocab_size, size=int(n)).astype(np.int32)
               for n in rng.integers(8, 401, size=GRPC_STREAMS)]
    httpd, horch, _ = make_server(engine.cfg, port=0, engine=engine, host="127.0.0.1")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    want = []
    try:
        for p in prompts:
            body = json.dumps({"prompt": p.tolist(), "max_new_tokens": GRPC_NEW_TOKENS}).encode()
            req = urllib.request.Request(f"http://127.0.0.1:{httpd.server_address[1]}/generate",
                                         data=body, headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=300) as resp:
                want.append(json.loads(resp.read())["tokens"])
    finally:
        httpd.shutdown()
        httpd.server_close()
        horch.stop()
        thread.join(timeout=30)

    orch = Orchestrator(engine, steps_per_dispatch=STEPS_PER_DISPATCH)
    orch.start()
    server = gs.create_server(orch, port=0, host="127.0.0.1")
    server.start()
    msgs = [None] * GRPC_STREAMS
    try:
        chan = grpc.insecure_channel(f"127.0.0.1:{server._mtt_port}")
        stub = gs.OrchestratorStub(chan)

        def call(i, out):
            out[i] = list(stub.Decode(pb.DecodeRequest(token_ids=prompts[i].tolist(),
                                                       max_tokens=GRPC_NEW_TOKENS), timeout=300))

        for i in range(GRPC_STREAMS):
            call(i, msgs)
        together = [None] * GRPC_STREAMS
        t1 = time.perf_counter()
        calls = [threading.Thread(target=call, args=(i, together)) for i in range(GRPC_STREAMS)]
        for c in calls:
            c.start()
        for c in calls:
            c.join(timeout=300)
        seconds = time.perf_counter() - t1
        health = stub.HealthCheck(pb.HealthCheckRequest(), timeout=30)
        chan.close()
    finally:
        server.stop(grace=1)
        orch.stop()
    check(all(m is not None and m[-1].done and not m[-1].error for m in msgs + together),
          "grpc: a Decode stream failed or did not end")
    got = [[t for m in ms for t in m.token_ids] for ms in msgs]
    check(got == want, "grpc: the streamed tokens differ from /generate's")
    got_together = [[t for m in ms for t in m.token_ids] for ms in together]
    check(all(len(g) == GRPC_NEW_TOKENS for g in got_together),
          "grpc: a concurrent stream did not get its budget")
    check(health.ok, "grpc: HealthCheck did not answer ok")
    emit("grpc", t0, card=card, streams=GRPC_STREAMS, new_tokens=GRPC_NEW_TOKENS,
         messages=[len(m) for m in msgs], messages_concurrent=[len(m) for m in together],
         concurrent_seconds=seconds,
         concurrent_tokens_per_s=sum(len(g) for g in got_together) / seconds,
         equal_to_generate=True,
         concurrent_equal_to_generate=sum(a == b for a, b in zip(got_together, want)))


def phase_grpc_synthesize(pipe, card):
    """One gRPC ``Synthesize`` over the full-width pipeline: its chunks, put
    together, against ``synthesize``'s waveform for the same request."""
    from maxtext_indextts2_tpu_torch.audio.pipeline import prompt_signal
    from maxtext_indextts2_tpu_torch.infer import grpc_server as gs
    from maxtext_indextts2_tpu_torch.infer.proto import orchestrator_pb2 as pb
    from maxtext_indextts2_tpu_torch.infer.server import Orchestrator
    import grpc

    t0 = time.perf_counter()
    w16 = prompt_signal(43, SYNTH_PROMPT_SECONDS, 16_000)
    w24 = prompt_signal(43, SYNTH_PROMPT_SECONDS, 24_000)
    text = "The same sentence over gRPC and in process."
    want, info = pipe.synthesize(text, w16, w24, max_new_tokens=SYNTH_FRAMES)
    chunk = len(want) // 3 + 1
    orch = Orchestrator(pipe.engine, steps_per_dispatch=STEPS_PER_DISPATCH)
    orch.start()
    server = gs.create_server(orch, tts_pipeline=pipe, port=0, host="127.0.0.1")
    server.start()
    old, gs._WAV_CHUNK_SAMPLES = gs._WAV_CHUNK_SAMPLES, chunk
    try:
        chan = grpc.insecure_channel(f"127.0.0.1:{server._mtt_port}")
        t1 = time.perf_counter()
        msgs = list(gs.OrchestratorStub(chan).Synthesize(pb.SynthesizeRequest(
            text=text, prompt_wav_16k=w16.tolist(), prompt_wav_24k=w24.tolist(),
            max_new_tokens=SYNTH_FRAMES), timeout=600))
        seconds = time.perf_counter() - t1
        chan.close()
    finally:
        gs._WAV_CHUNK_SAMPLES = old
        server.stop(grace=1)
        orch.stop()
    check(len(msgs) == 3 and msgs[-1].done and not msgs[-1].error,
          f"grpc_synthesize: {len(msgs)} messages, last {msgs[-1].error if msgs else None}")
    wav = np.concatenate([np.frombuffer(m.wav_f32le, "<f4") for m in msgs])
    same = bool(np.array_equal(wav, np.asarray(want, np.float32).ravel()))
    check(same, "grpc_synthesize: the chunks differ from synthesize's waveform")
    emit("grpc_synthesize", t0, card=card, messages=len(msgs), samples=int(wav.size),
         semantic_tokens=info["semantic_tokens"], synthesize_seconds=seconds,
         equal_to_synthesize=same)


def _load_family(phase, args, want_params):
    """A family's engine on the card, weights drawn there in bfloat16."""
    from maxtext_indextts2_tpu_torch.config import load_config
    from maxtext_indextts2_tpu_torch.infer.engine import Engine

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = Engine(load_config(args))
    engine.load_params()
    torch.cuda.synchronize()
    params = sum(p.numel() for p in engine.model.parameters())
    check(params == want_params and all(
        p.dtype == torch.bfloat16 for n, p in engine.model.named_parameters() if "scale" not in n),
        f"{phase}: {params} parameters (want {want_params}), all bfloat16")
    return engine, dict(params=params, param_bytes=_param_bytes(engine),
                        load_seconds=time.perf_counter() - t0,
                        load_peak_memory_bytes=torch.cuda.max_memory_allocated())


def _moe_layers(engine) -> int:
    from maxtext_indextts2_tpu_torch.models.moe import RoutedMoE

    return sum(isinstance(m, RoutedMoE) for m in engine.model.modules())


def _moe_step_audit(engine, state):
    """One eager decode step on a copy of ``state`` with every MoE layer run
    on both routes from the same inputs and routing: the sparse route (the
    grouped kernels; its output goes on to the next layer) and the dense
    einsum route (int8 experts dequantized), shared experts included in both.
    Returns, layer by layer, the experts the step routes to and max |sparse -
    dense| over max |dense|, and the grouped kernels' launches in the step
    (three a layer: the dense route launches none)."""
    from maxtext_indextts2_tpu_torch.models.moe import RoutedMoE

    touched, rel = [], []
    original = RoutedMoE.forward

    def forward(self, inputs, impl=None, aux_loss=True):
        touched.append(torch.unique(self.route(inputs)[0]).numel())
        sparse, loss = original(self, inputs, impl, aux_loss)
        cfg = self.cfg
        self.cfg = dataclasses.replace(cfg, sparse_matmul=False)
        try:
            dense, _ = original(self, inputs, impl, aux_loss)
        finally:
            self.cfg = cfg
        rel.append((sparse.float() - dense.float()).abs().max() / dense.float().abs().max())
        return sparse, loss

    RoutedMoE.forward = forward
    _reset_all_counts()
    try:
        engine._generate_step(_clone_state(state))
        torch.cuda.synchronize()
    finally:
        RoutedMoE.forward = original
    counts = _all_counts()
    launches = counts["grouped_matmul_bf16"] + counts["grouped_matmul_int8"]
    return [int(t) for t in touched], [float(r) for r in rel], launches


def _serve_family(phase, engine, card, load_fields, grouped="grouped_matmul_bf16",
                  extra=None, teacher_forced=True):
    """8 greedy requests through the Orchestrator (decode captured), the
    grouped kernel's launches, tokens/s, peak memory and the captured step's
    time and trace (``tools/profile_decode.measure``), cached greedy against
    the teacher-forced argmax (required where ``teacher_forced``; else
    reported with the router gap at each token that does not agree), and for
    a MoE model each layer's sparse route against its dense route
    (``_moe_step_audit``, required)."""
    from maxtext_indextts2_tpu_torch.infer.server import Orchestrator
    from maxtext_indextts2_tpu_torch.tools import profile_decode

    t0 = time.perf_counter()
    cfg = engine.cfg
    rng = np.random.default_rng(50)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32)
               for n in FAMILY_PROMPT_LENGTHS]
    seconds: dict[str, float] = {}
    engine.prefill_insert_many = _timed(engine.prefill_insert_many, seconds, "prefill")
    engine.generate_n = _timed(engine.generate_n, seconds, "decode")
    captures0, replays0 = engine.graphs.captures, engine.graphs.replays
    orch = Orchestrator(engine, steps_per_dispatch=STEPS_PER_DISPATCH)
    orch.start()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_all_counts()  # every count to 0 just before the main path, read just after
    t1 = time.perf_counter()
    reqs = [orch.submit(p, FAMILY_NEW_TOKENS) for p in prompts]
    finished = all(r.done.wait(timeout=600) for r in reqs)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t1
    orch.stop()
    launches = _all_counts()
    del engine.prefill_insert_many, engine.generate_n
    serve_peak = torch.cuda.max_memory_allocated()
    check(finished, f"{phase}: a request did not finish in 600 s")
    errors = [r.error for r in reqs if r.error]
    check(not errors, f"{phase}: {len(errors)} requests failed, first: {errors[:1]}")
    check(all(len(r.tokens) == FAMILY_NEW_TOKENS for r in reqs),
          f"{phase}: a request did not get exactly its token budget")
    check(all(0 <= t < cfg.vocab_size for r in reqs for t in r.tokens),
          f"{phase}: a token outside [0, vocab)")
    steps = orch.stats["decode_steps_total"]
    captures, replays = engine.graphs.captures - captures0, engine.graphs.replays - replays0
    check(steps > 0 and replays > 0, f"{phase}: decode not captured ({captures} captures, "
                                     f"{replays} replays)")
    moe_layers = _moe_layers(engine)
    if moe_layers:  # wi_0, wi_1 and wo of every MoE layer, every decode step at least
        check(launches[grouped] >= 3 * moe_layers * steps,
              f"{phase}: {grouped} launched {launches[grouped]} times, want at least "
              f"{3 * moe_layers * steps} ({moe_layers} MoE layers, {steps} steps)")
    streams = [list(r.tokens) for r in reqs]
    fields = dict(card=card, **load_fields, layers=cfg.num_decoder_layers, emb_dim=cfg.emb_dim,
                  heads=[cfg.num_query_heads, cfg.num_kv_heads], vocab=cfg.vocab_size,
                  experts=[cfg.num_experts, cfg.num_experts_per_tok] if moe_layers else None,
                  moe_layers=moe_layers, slots=engine.num_slots,
                  max_target_length=cfg.max_target_length,
                  prompt_lengths=list(FAMILY_PROMPT_LENGTHS), new_tokens=FAMILY_NEW_TOKENS,
                  serve_seconds=serve_s, prefill_seconds=seconds.get("prefill"),
                  decode_seconds=seconds.get("decode"), decode_steps=steps,
                  captures=captures, replays=replays,
                  tokens_per_s=sum(map(len, streams)) / serve_s,
                  decode_tokens_per_s=sum(map(len, streams)) / seconds["decode"],
                  decode_ms_a_step=1e3 * seconds["decode"] / steps,
                  admission_dispatches=orch.stats["admission_dispatches_total"],
                  grouped_matmul_launches=launches[grouped], launches=launches,
                  serve_peak_memory_bytes=serve_peak)
    gaps = None if teacher_forced or not moe_layers else []
    agree, compared, exact = _near_tie_agreement(
        engine, prompts[:TEACHER_FORCED_STREAMS],
        [s[:TEACHER_FORCED_TOKENS] for s in streams[:TEACHER_FORCED_STREAMS]], gaps)
    if teacher_forced:
        check(agree == compared, f"{phase}: cached greedy differs from the teacher-forced "
                                 f"argmax in {compared - agree} of {compared} tokens")
    fields.update(teacher_forced_agree=agree, teacher_forced_compared=compared,
                  teacher_forced_exact=exact, **(extra or {}))
    if gaps is not None:
        fields.update(router_gaps_where_not_agreeing=gaps)
    state, _ = _populate(engine, prompts)
    if moe_layers:
        # the sparse route against the dense one, layer by layer, on the
        # step's own inputs and routing (no routing near a tie can flip)
        touched, rel, audit_launches = _moe_step_audit(engine, state)
        tol = TOL_ROUTES_INT8 if engine.cfg.quantization == "int8w_serve" else TOL_ROUTES_BF16
        check(len(rel) == moe_layers and audit_launches == 3 * moe_layers,
              f"{phase}: the route audit ran {len(rel)} MoE layers with {audit_launches} "
              f"grouped launches (want {moe_layers} and {3 * moe_layers})")
        check(max(rel) <= tol,
              f"{phase}: the sparse route differs from the dense one by {max(rel)} of the "
              f"largest |output| in a MoE layer (tolerance {tol})")
        fields.update(experts_touched_a_step=dict(min=min(touched), max=max(touched),
                                                  mean=float(np.mean(touched))),
                      routes_rel_err_max=max(rel), routes_rel_err_mean=float(np.mean(rel)),
                      routes_tol_rel=tol)
    # the captured step at the populated state, timed and traced
    step, prof = profile_decode.measure(engine, state, steps=STEPS_PER_DISPATCH)
    del state
    fields.update(captured_step_ms=step["step_ms_host_clock"],
                  captured_step_ms_repeats=step["step_ms_host_clock_repeats"],
                  device_busy_ms_per_step=prof["device_busy_ms_per_step"],
                  device_idle_share=prof["device_idle_share"],
                  device_kernels_per_step=prof["device_kernels_per_step"],
                  own_kernels=prof["own_kernels"], top_kernels=prof["top_kernels"][:6])
    emit(phase, t0, **fields)
    return streams, fields, {k: v for k, v in launches.items() if v}


def phase_moe_serve(card):
    """qwen3-30b-a3b whole: 48 layers, E 2048, 32 q / 4 kv heads of 128, 128
    experts of 768 (top 8) in every layer, a 151,936-row vocabulary, bf16."""
    engine, load = _load_family("moe_serve", MOE_ARGS, MOE_PARAMS)
    streams, fields, launches = _serve_family("moe_serve", engine, card, load)
    return engine, streams, fields, launches


def phase_moe_serve_parity(engine, card):
    """One decode step's logits, sparse route (the grouped kernels) against
    the dense einsum route, on the card from one populated state."""
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    rng = np.random.default_rng(51)
    prompts = [rng.integers(1, engine.cfg.vocab_size, size=n).astype(np.int32)
               for n in FAMILY_PROMPT_LENGTHS]
    state, _ = _populate(engine, prompts)
    state, _ = engine.generate_n(state, 3)
    twin = _clone_state(state)
    _reset_all_counts()
    _, sparse = engine._generate_step(state)
    sparse_launches = _all_counts()["grouped_matmul_bf16"]
    moes = [m for m in engine.model.modules() if hasattr(m, "sparse_experts")]
    for m in moes:
        m.cfg = dataclasses.replace(m.cfg, sparse_matmul=False)
    try:
        _, dense = engine._generate_step(twin)
    finally:
        for m in moes:
            m.cfg = dataclasses.replace(m.cfg, sparse_matmul=True)
    torch.cuda.synchronize()
    dense_launches = _all_counts()["grouped_matmul_bf16"] - sparse_launches
    a, b = sparse.float(), dense.float()
    err = float((a - b).abs().max().item())
    scale = float(b.abs().max().item())
    top = b.max(-1).values
    got = b.gather(-1, a.argmax(-1, keepdim=True))[:, 0]
    near = bool(((top - got) <= TOL_NEAR_TIE * b.abs().max(-1).values).all().item())
    same = bool((a.argmax(-1) == b.argmax(-1)).all().item())
    check(sparse_launches == 3 * len(moes) and dense_launches == 0,
          f"moe_serve_parity: grouped launches {sparse_launches} (sparse), {dense_launches} "
          "(dense)")
    check(bool(torch.isfinite(a).all()) and err <= TOL_MOE_PARITY_REL * scale and near,
          f"moe_serve_parity: logits differ by {err} (max |logit| {scale}), argmax equal "
          f"{same}, within a near tie {near}")
    del state, twin
    emit("moe_serve_parity", t0, card=card, logits_max_abs_err=err, logits_max_abs=scale,
         tol_rel=TOL_MOE_PARITY_REL, same_argmax=same, argmax_within_near_tie=near,
         grouped_launches_sparse_step=sparse_launches)


def _engine_in_place(engine, cfg):
    """An engine of config ``cfg`` made from ``engine``'s weights tensor by
    tensor, each freed in ``engine`` as soon as it is converted: a weight with
    an int8 twin (``quantization=int8w_serve``) quantized (one scale an output
    channel, for experts an (expert, output channel)), a weight of another
    dtype widened, the rest shared. ``engine`` is consumed; peak memory stays
    near the larger of the two models."""
    from torch import nn

    from maxtext_indextts2_tpu_torch.infer.engine import Engine
    from maxtext_indextts2_tpu_torch.models import Transformer
    from maxtext_indextts2_tpu_torch.ops.quantization import quantize_weight_for_serving

    engine.graphs.clear()
    engine.params = None  # its tensors would keep every old weight alive
    model = Transformer(cfg, device="meta")
    src = dict(engine.model.named_parameters())
    want = dict(model.named_parameters())

    def put(name, tensor, buffer=False):
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner)
        if buffer:
            mod._buffers[leaf] = tensor
        else:
            mod._parameters[leaf] = nn.Parameter(tensor, requires_grad=False)

    with torch.no_grad():
        for name, ref in want.items():
            base = want.get(name[:-6]) if name.endswith("_scale") else None
            if base is not None and base.dtype == torch.int8:
                continue  # made with its weight
            w = src[name]
            if ref.dtype == torch.int8:
                scale_shape = want[f"{name}_scale"].shape
                q, sc = quantize_weight_for_serving(
                    w.data, tuple(i for i, d in enumerate(scale_shape) if d == 1))
                w.data = torch.empty(0, dtype=w.dtype, device=w.device)
                put(name, q)
                put(f"{name}_scale", sc)
            elif ref.dtype != w.dtype:
                wide = w.data.to(ref.dtype)
                w.data = torch.empty(0, dtype=w.dtype, device=w.device)
                put(name, wide)
            else:
                put(name, w.data)
        for name, b in engine.model.named_buffers():
            put(name, b, buffer=True)
    out = Engine(cfg, model=model)
    out.params = model.state_dict()
    return out


def phase_moe_serve_int8w(bf16_engine, card, bf16_fields):
    """qwen3-30b-a3b under ``int8w_serve``, quantized from the bf16 engine on
    the card tensor by tensor: the int8 grouped kernel on the experts and
    int8w_matmul on attention; step ms against bf16's."""
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    engine = _engine_in_place(
        bf16_engine, dataclasses.replace(bf16_engine.cfg, quantization="int8w_serve"))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    load = dict(params=sum(p.numel() for p in engine.model.parameters()),
                param_bytes=_param_bytes(engine), load_seconds=time.perf_counter() - t0,
                load_peak_memory_bytes=torch.cuda.max_memory_allocated(),
                param_bytes_bfloat16=bf16_fields["param_bytes"])
    check(load["load_peak_memory_bytes"] < 80e9,
          f"moe_serve_int8w: quantizing peaked at {load['load_peak_memory_bytes']} bytes")
    # the captured step beside bf16's (moe_serve, the same call and card)
    _, fields, launches = _serve_family(
        "moe_serve_int8w", engine, card, load, grouped="grouped_matmul_int8",
        extra=dict(decode_ms_a_step_bfloat16=bf16_fields["decode_ms_a_step"],
                   device_busy_ms_per_step_bfloat16=bf16_fields["device_busy_ms_per_step"]))
    check(launches.get("int8w_matmul", 0) > 0 and not launches.get("grouped_matmul_bf16"),
          f"moe_serve_int8w: launches {launches}")
    return engine, launches


def phase_mixtral_serve(card):
    """mixtral-8x7b at full widths (E 4096, 8 experts of 14336, top 2,
    normalised weights), 8 of its 32 layers: few large experts."""
    engine, load = _load_family("mixtral_serve", MIXTRAL_ARGS, MIXTRAL_PARAMS)
    # the bfloat16 teacher-forced agreement is reported with the router gap
    # at each token that does not agree; the sparse route is held to the
    # dense one layer by layer (required)
    _, _, launches = _serve_family("mixtral_serve", engine, card, load, teacher_forced=False)
    del engine
    return launches


def phase_mla_serve(card):
    """deepseek-v2-lite whole: 27 layers (the first dense), MLA with a
    512-row latent, 64 routed experts (top 6) and 2 shared; the latent
    cache's bytes against the expanded K/V's."""
    engine, load = _load_family("mla_serve", MLA_ARGS, MLA_PARAMS)
    cfg = engine.cfg
    latent = sum(c.nbytes() for unit in engine.model.init_cache(1, cfg.max_target_length)
                 for c in unit) * engine.num_slots
    expanded = (cfg.num_decoder_layers * engine.num_slots * cfg.max_target_length
                * cfg.num_query_heads * (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
                                         + cfg.v_head_dim) * 2)
    _, _, launches = _serve_family(
        "mla_serve", engine, card, load,
        extra=dict(latent_cache_bytes=latent, expanded_kv_bytes=expanded,
                   latent_over_expanded=latent / expanded))
    del engine
    return launches


def phase_gpt3_serve(card):
    """gpt3-6b whole: 48 layers, E 3072, 12 heads of 256 (K1 at D 256),
    LayerNorm, learned positions, biases, gelu, bf16."""
    engine, load = _load_family("gpt3_serve", GPT3_ARGS, GPT3_PARAMS)
    _, _, launches = _serve_family("gpt3_serve", engine, card, load)
    del engine
    check(launches.get("ragged_decode_attention", 0) > 0, f"gpt3_serve: launches {launches}")
    return launches


def _teacher_forced_float32(phase, engine, prompts) -> dict:
    """Cached greedy against the teacher-forced argmax on a float32 twin of
    ``engine`` (its bfloat16 weights widened exactly, tensor by tensor:
    ``engine`` is consumed), decode captured: in float32 the prefill and the
    cached decode round alike, so a router score near a tie picks the same
    expert on both; each token must be the argmax, or within a near tie."""
    # the grouped kernels take bfloat16 and int8: float32 experts take the dense route
    twin = _engine_in_place(engine, dataclasses.replace(
        engine.cfg, dtype="float32", weight_dtype="float32", serve_params_dtype="",
        sparse_matmul=False))
    streams = _decode_streams(twin, prompts, TEACHER_FORCED_TOKENS)[:, :TEACHER_FORCED_TOKENS]
    agree, compared, exact = _near_tie_agreement(twin, prompts, [list(s) for s in streams])
    check(agree == compared, f"{phase}: float32 cached greedy differs from the teacher-forced "
                             f"argmax in {compared - agree} of {compared} tokens")
    twin.graphs.clear()
    del twin
    return dict(teacher_forced_float32_agree=agree, teacher_forced_float32_compared=compared,
                teacher_forced_float32_exact=exact)


def phase_llama4_serve(card):
    """llama4-scout at full widths, 4 of its 48 layers (3 chunked rope layers
    and the NoPE global one), every layer 16 experts of 8192 (top 1) and a
    shared expert; requests cross a 256-token chunk boundary. The sparse
    route is held to the dense one layer by layer on the bfloat16 engine; the
    teacher-forced check is required on a float32 twin (43.5 GB: the
    bfloat16 engine's weights widened in place) and reported on the bfloat16
    streams with the router gap at each token that does not agree."""
    t0 = time.perf_counter()
    engine, load = _load_family("llama4_serve", LLAMA4_ARGS, LLAMA4_PARAMS)
    _, _, launches = _serve_family("llama4_serve", engine, card, load,
                                   extra=dict(chunk_attn_window_size=LLAMA4_CHUNK),
                                   teacher_forced=False)
    rng = np.random.default_rng(52)
    prompts = [rng.integers(1, engine.cfg.vocab_size, size=n).astype(np.int32)
               for n in FAMILY_PROMPT_LENGTHS[:TEACHER_FORCED_STREAMS]]
    gc.collect()
    torch.cuda.empty_cache()
    fields = _teacher_forced_float32("llama4_serve", engine, prompts)
    del engine
    gc.collect()
    emit("llama4_serve_float32", t0, card=card, prompt_lengths=[len(p) for p in prompts],
         tokens=TEACHER_FORCED_TOKENS, peak_memory_bytes=torch.cuda.max_memory_allocated(),
         **fields)
    return launches



# ROADMAP item 6, training: MoE and MTP at full width, float32 weights and two
# Adam moments (16 bytes a parameter, the JAX recipe's weight_dtype), bf16
# compute, cut in depth where the optimizer state forces it.
MOE_TRAIN_STEPS = 5
TRAIN_FAMILY_ARGS = ["dataset_type=synthetic", "weight_dtype=float32", "dtype=bfloat16",
                     "scan_layers=false", "remat_policy=full", "max_target_length=1024",
                     "max_prefill_predict_length=1024"]
# qwen3-30b-a3b, 2 of its 48 layers: 4 x 1024 tokens a step, top 8 of 128
# experts: 32,768 rows through each grouped product
# through K9-K11 at GQA group 8 (32 query / 4 kv heads, the autoselected
# route at 1024 tokens) and the grouped products
MOE_TRAIN_ARGS = ["model_name=qwen3-30b-a3b", "base_num_decoder_layers=2",
                  "per_device_batch_size=4", f"steps={MOE_TRAIN_STEPS}"] + TRAIN_FAMILY_ARGS
# moe_train_parity: one step of 1 x 1024 tokens, the sparse route against the
# dense einsum route on the card, on each of 3 (weights seed, batch) pairs, on
# one routing a pair (the first pass's selection, pinned). Both round the same
# bf16 products at the same points (h0, h1, the expert output); they sum the
# experts' rows back in another order and the sparse route rounds the weighted
# rows once more. Held with the MoE sub-layers in bf16 and the rest of the step
# in float32: the loss and every gradient within 2**-6 of the tensor's largest
# |entry| (a scalar: of its |value|). With the whole step in bf16 every later
# bf16 rounding may move with the routes' last bits: there two computations of
# the same step that sum in another order (the kernels against the plain
# grouped products on one route, as well as the two routes) differ by 1.0-1.6 %
# and each is 2.1-2.9 % from a float32 step (``tools/moe_route_noise.py``), so
# that comparison is reported beside the float32 witness and not held to 2**-6.
TOL_MOE_TRAIN_ROUTES = 2.0 ** -6
MOE_PARITY_BATCHES = 3
# the same step in float32 throughout, sparse route (the float32 grouped
# kernels) against the dense einsum route, on the first pair's pinned
# routing: the same float32 arithmetic in another summation order (TF32 off),
# so the loss, moe_lb_loss and every gradient within 1e-5 of the tensor's
# largest |entry| (a scalar: of its |value|)
TOL_MOE_TRAIN_F32 = 1e-5
# deepseek-v2-lite at its published widths, its leading dense layer and one
# MoE layer (64 experts of 1408, top 6, 2 shared experts), with DeepSeek-V3's
# router (sigmoid scores, a selection bias, 8 groups of which 4 are kept,
# normalised top-k weights) so that a training step runs it too
DEEPSEEK_TRAIN_STEPS = 3
DEEPSEEK_TRAIN_ARGS = ["model_name=deepseek-v2-lite", "base_num_decoder_layers=2",
                       "per_device_batch_size=4", "routed_score_func=sigmoid",
                       "routed_bias=true", "n_routing_groups=8", "topk_routing_group=4",
                       "normalize_topk_weights=true",
                       f"steps={DEEPSEEK_TRAIN_STEPS}"] + TRAIN_FAMILY_ARGS
# deepseek-v3: its trunk cut to one dense layer, its MTP depth whole, 1 x 1024
MTP_TRAIN_STEPS = 3
MTP_TRAIN_ARGS = ["model_name=deepseek-v3", "base_num_decoder_layers=1",
                  "first_num_dense_layers=1", "mtp_num_layers=1", "per_device_batch_size=1",
                  f"steps={MTP_TRAIN_STEPS}"] + TRAIN_FAMILY_ARGS
# mtp_train's CPU check: deepseek-v3's blocks at a width the CPU takes, one
# float32 step on the card and on the CPU from one set of weights and one
# batch; only the summation order differs (TF32 off): 1e-4 of the largest
# |entry| of each gradient, 1e-5 of each loss
MTP_PARITY_ARGS = ["model_name=deepseek-v3", "base_num_decoder_layers=1",
                   "first_num_dense_layers=1", "mtp_num_layers=2", "base_emb_dim=256",
                   "base_num_query_heads=4", "base_num_kv_heads=4", "q_lora_rank=64",
                   "kv_lora_rank=32", "qk_nope_head_dim=32", "qk_rope_head_dim=16",
                   "v_head_dim=32", "base_mlp_dim=512", "vocab_size=1024",
                   "max_target_length=64", "per_device_batch_size=2", "dtype=float32",
                   "weight_dtype=float32", "dataset_type=synthetic", "scan_layers=false"]
TOL_MTP_PARITY_GRAD, TOL_MTP_PARITY_LOSS = 1e-4, 1e-5
SFT_TRAIN_STEPS = 5

# ROADMAP item 6, vision: gemma3-4b whole with the SigLIP tower of
# google/gemma-3-4b-it's vision_config (896-pixel images, 14-pixel patches,
# 4,096 patches pooled to 256 soft tokens), llama4-scout cut as llama4_serve
# with the vision tower of its vision_config (336-pixel tiles, 14-pixel
# patches, pixel shuffle 0.5: 144 soft tokens a tile), bf16, seeded weights
VISION_IMAGES = 8
VISION_NEW_TOKENS = 64
GEMMA3_IMAGE_TOKEN = 262144  # <image_soft_token>
GEMMA3_VISION_ARGS = ["model_name=gemma3-4b", f"image_token_id={GEMMA3_IMAGE_TOKEN}"] \
    + FAMILY_ARGS
GEMMA3_SIGLIP = dict(image_size=896, patch_size=14, hidden_size=1152, num_layers=27,
                     num_heads=16, mlp_dim=4304)
LLAMA4_IMAGE_TOKEN = 200092  # <|patch|>
LLAMA4_VISION_ARGS = LLAMA4_ARGS + [f"image_token_id={LLAMA4_IMAGE_TOKEN}"]
LLAMA4_VISION = dict(image_size=336, patch_size=14, hidden_size=1408, num_layers=34,
                     num_heads=16, intermediate_size=5632, projector_input_dim=4096,
                     projector_output_dim=4096, pixel_shuffle_ratio=0.5)
VISION_TOWER_BATCH = 2  # images a tower call: the attention's float32 scores stay ~2 GB


def _gmm_train_want(cfg, moe_layers: int, steps: int) -> dict:
    """The grouped kernels' launches a training run makes: three products a
    MoE sub-layer forward, once more where a remat policy recomputes the
    forward in the backward, and a dgrad and a wgrad for each product."""
    from maxtext_indextts2_tpu_torch.models.decoder import _remat_policy

    fwd = 2 if _remat_policy(cfg.remat_policy) else 1
    return {"grouped_matmul_bf16": 3 * moe_layers * steps * fwd,
            "grouped_matmul_dgrad": 3 * moe_layers * steps,
            "grouped_matmul_wgrad": 3 * moe_layers * steps}


def _flash_train_want(cfg, attention_layers: int, steps: int) -> dict:
    """K9-K11's launches a training run of 1024-token rows makes (the
    autoselected route): a forward an attention layer, once more where a
    remat policy recomputes it, and a dq and a dkv."""
    from maxtext_indextts2_tpu_torch.models.decoder import _remat_policy

    fwd = 2 if _remat_policy(cfg.remat_policy) else 1
    return {"flash_fwd": fwd * attention_layers * steps,
            "flash_bwd_dq": attention_layers * steps,
            "flash_bwd_dkv": attention_layers * steps}


def _model_counts(cfg):
    """(parameters, MoE sub-layers, attention sub-layers of the flash route:
    MLA attends through its own einsum)."""
    from maxtext_indextts2_tpu_torch.models import Transformer
    from maxtext_indextts2_tpu_torch.models.attention import Attention
    from maxtext_indextts2_tpu_torch.models.moe import RoutedMoE

    meta = Transformer(cfg, device="meta")
    return (sum(p.numel() for p in meta.parameters()),
            sum(isinstance(m, RoutedMoE) for m in meta.modules()),
            sum(isinstance(m, Attention) for m in meta.modules()))


def _train_family(phase, args, card, steps):
    """A family's training through the training entry point (``train.main``,
    the card): losses, the auxiliary losses, step seconds, tokens/s, MFU,
    peak memory, and the grouped kernels' launches against the prediction."""
    from maxtext_indextts2_tpu_torch.config import load_config
    from maxtext_indextts2_tpu_torch.train import train
    from maxtext_indextts2_tpu_torch.utils import flops

    t0 = time.perf_counter()
    cfg = load_config(args)
    params, moe_layers, attention_layers = _model_counts(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_all_counts()  # every count to 0 just before the main path, read just after
    out = train.main(list(args))
    torch.cuda.synchronize()
    launches = _all_counts()
    peak = torch.cuda.max_memory_allocated()
    hist = out["history"]
    losses = [h["loss"] for h in hist]
    check(len(hist) == steps and all(np.isfinite(losses)),
          f"{phase}: losses {losses} over {len(hist)} of {steps} steps")
    aux = {k: [h[k] for h in hist] for k in ("moe_lb_loss", "mtp_loss") if k in hist[0]}
    check(all(np.isfinite(v).all() for v in aux.values()), f"{phase}: {aux}")
    if moe_layers:
        check("moe_lb_loss" in aux, f"{phase}: no moe_lb_loss metric")
    want = {**_gmm_train_want(cfg, moe_layers, steps),
            **_flash_train_want(cfg, attention_layers, steps)}
    got = {k: launches[k] for k in want}
    check(got == want, f"{phase}: grouped and flash launches {got} != predicted {want} "
                       f"({moe_layers} MoE layers, {attention_layers} flash attention layers, "
                       f"{steps} steps, remat {cfg.remat_policy})")
    step_s = _median_step_seconds(hist)
    tokens = cfg.global_batch_size_to_train_on * cfg.max_target_length
    tflops = flops.training_tflops_per_step(cfg)
    fields = dict(card=card, params=params, layers=cfg.num_decoder_layers, emb_dim=cfg.emb_dim,
                  moe_layers=moe_layers,
                  experts=[cfg.num_experts, cfg.num_experts_per_tok] if moe_layers else None,
                  remat_policy=cfg.remat_policy, steps=steps, losses=losses, **aux,
                  step_seconds=[h["step_time_s"] for h in hist], median_step_seconds=step_s,
                  tokens_per_step=tokens, tokens_per_s=tokens / step_s,
                  tflops_per_step=tflops, mfu_at_989_tflops=flops.mfu(tflops, step_s),
                  peak_memory_bytes=peak, kernel_launches=got, kernel_launches_predicted=want,
                  launches={k: v for k, v in launches.items() if v})
    emit(phase, t0, **fields)
    return {k: v for k, v in launches.items() if v}, fields


def phase_moe_train(card):
    """qwen3-30b-a3b at full width, 2 layers, 4 x 1024 tokens, 5 steps: the
    sparse route through the grouped products and their backward kernels."""
    return _train_family("moe_train", MOE_TRAIN_ARGS, card, MOE_TRAIN_STEPS)


def phase_moe_train_parity(card):
    """One step's loss, moe_lb_loss and every gradient, sparse route (the
    grouped kernels, forward and backward) against the dense einsum route,
    on each of MOE_PARITY_BATCHES (weights seed, synthetic batch) pairs on
    the card, every layer's expert selection pinned to the first pass's
    (``tools/moe_route_noise.pinned_routing``). Required within TOL_MOE_TRAIN_ROUTES: the two
    routes with the MoE sub-layers in bf16 (both routes' grouped or einsum
    products, as in training) and the rest of the step in float32, so that
    what differs is the routes' arithmetic and not bf16 re-rounding
    downstream of it. Reported beside it: the same two routes with the whole
    step in bf16 (the training recipe), and how far each is from a float32
    step of the dense route (the witness). On the first pair, the whole step
    in float32 on the sparse route (the float32 grouped kernels) against that
    witness, required within TOL_MOE_TRAIN_F32. Returns the float32 sparse
    step's launches (its own main path)."""
    from maxtext_indextts2_tpu_torch.config import load_config
    from maxtext_indextts2_tpu_torch.models.moe import RoutedMoE
    from maxtext_indextts2_tpu_torch.tools.moe_route_noise import (
        pinned_routing, rel_gaps, shared_model,
    )
    from maxtext_indextts2_tpu_torch.train import train
    from maxtext_indextts2_tpu_torch.train.data.synthetic import make_batch

    t0 = time.perf_counter()
    cfg = load_config(MOE_TRAIN_ARGS + ["per_device_batch_size=1"])
    _, moe_layers, attention_layers = _model_counts(cfg)
    model = shared_model(cfg)
    names = [n for n, _ in model.named_parameters()]
    cfg32 = load_config(MOE_TRAIN_ARGS + ["per_device_batch_size=1", "dtype=float32"])
    model32 = shared_model(cfg32, model.state_dict())
    device = model.token_embedder.embedding.device
    want = {**_gmm_train_want(cfg, moe_layers, 1), **_flash_train_want(cfg, attention_layers, 1)}
    bf16, f32 = torch.bfloat16, torch.float32
    # (pass, model, config, sparse route, the MoE sub-layers' dtype)
    passes = (("bf16_sparse", model, cfg, True, bf16), ("bf16_dense", model, cfg, False, bf16),
              ("moe_bf16_sparse", model32, cfg32, True, bf16),
              ("moe_bf16_dense", model32, cfg32, False, bf16),
              ("float32_dense", model32, cfg32, False, f32))
    want_f32 = {"grouped_matmul_f32": want["grouped_matmul_bf16"],
                "grouped_matmul_f32_dgrad": want["grouped_matmul_dgrad"],
                "grouped_matmul_f32_wgrad": want["grouped_matmul_wgrad"]}
    per_batch, failures, f32_step = [], [], {}
    for i in range(MOE_PARITY_BATCHES):
        # weights of seed init_weights_seed + i (drawn in place: the float32
        # model shares them) and synthetic batch i
        if i:
            model.init_params(cfg.init_weights_seed + i)
        check(all(a.data_ptr() == b.data_ptr()
                  for a, b in zip(model.parameters(), model32.parameters())),
              "moe_train_parity: the float32 model does not share the weights")
        batch = {k: torch.from_numpy(np.array(v)).to(device)
                 for k, v in make_batch(cfg, i).items()}
        out, selection, flips = {}, {}, []
        with pinned_routing((model, model32), selection, flips):
            for name, m, c, sparse, moe_dtype in passes:
                for moe in m.modules():
                    if isinstance(moe, RoutedMoE):
                        moe.cfg = dataclasses.replace(c, sparse_matmul=sparse)
                        moe.dtype = moe_dtype
                _reset_all_counts()
                loss, aux = train.loss_fn(m, c, batch)
                grads = train._grads(loss, list(m.parameters()))
                torch.cuda.synchronize()
                out[name] = dict(loss=float(loss.detach()),
                                 moe_lb_loss=float(aux["moe_lb_loss"].detach()), grads=grads,
                                 counts={k: v for k, v in _all_counts().items() if v})
                del loss, aux
            if i == 0:  # float32 throughout, sparse route, on the same pinned routing
                for moe in model32.modules():
                    if isinstance(moe, RoutedMoE):
                        moe.cfg = dataclasses.replace(cfg32, sparse_matmul=True)
                        moe.dtype = f32
                _reset_all_counts()
                loss, aux = train.loss_fn(model32, cfg32, batch)
                grads = train._grads(loss, list(model32.parameters()))
                torch.cuda.synchronize()
                counts = {k: v for k, v in _all_counts().items() if v}
                ref = out["float32_dense"]
                rel = dict(zip(names, rel_gaps(grads, ref["grads"])))
                scalars = {"loss": abs(float(loss.detach()) - ref["loss"])
                           / max(abs(ref["loss"]), 1e-30),
                           "moe_lb_loss": abs(float(aux["moe_lb_loss"].detach())
                                              - ref["moe_lb_loss"])
                           / max(abs(ref["moe_lb_loss"]), 1e-30)}
                top = sorted(rel.items(), key=lambda kv: -kv[1])[:4]
                f32_step = dict(scalar_rel_err=scalars, grad_rel_err_top=top,
                                grad_rel_err_mean=float(np.mean(list(rel.values()))),
                                counts=counts, tol_rel=TOL_MOE_TRAIN_F32)
                bf16_gmm = [k for k in want if "grouped" in k]
                got = {k: counts.get(k, 0) for k in (*want_f32, *bf16_gmm)}
                if got != {**want_f32, **dict.fromkeys(bf16_gmm, 0)}:
                    failures.append(f"float32 sparse step: grouped launches {got}, "
                                    f"want {want_f32}")
                if max(max(scalars.values()), top[0][1]) > TOL_MOE_TRAIN_F32:
                    failures.append(f"float32 sparse against dense: {scalars}, "
                                    f"worst gradients {top}")
                del loss, aux, grads
        for name, _, _, sparse, _ in passes:
            grouped = {k: out[name]["counts"].get(k, 0) for k in want if "grouped" in k}
            flash = {k: out[name]["counts"].get(k, 0) for k in want if "flash" in k}
            f32_counts = {k: out[name]["counts"].get(k, 0) for k in F32_GMM}
            if flash != {k: v for k, v in want.items() if "flash" in k} or grouped != (
                    {k: v for k, v in want.items() if "grouped" in k} if sparse
                    else dict.fromkeys(grouped, 0)) or any(f32_counts.values()):
                failures.append(f"batch {i} {name}: launches {out[name]['counts']}, want {want} "
                                "(grouped on the sparse route only)")

        def compare(a, b):
            rel = dict(zip(names, rel_gaps(out[a]["grads"], out[b]["grads"])))
            top = sorted(rel.items(), key=lambda kv: -kv[1])[:4]
            scalars = {k: abs(out[a][k] - out[b][k]) / max(abs(out[b][k]), 1e-30)
                       for k in ("loss", "moe_lb_loss")}
            return dict(scalar_rel_err=scalars, grad_rel_err_top=top,
                        grad_rel_err_mean=float(np.mean(list(rel.values()))))

        gated = compare("moe_bf16_sparse", "moe_bf16_dense")
        whole = compare("bf16_sparse", "bf16_dense")
        leaf = whole["grad_rel_err_top"][0][0]
        j = names.index(leaf)
        to32 = rel_gaps([out["bf16_sparse"]["grads"][j], out["bf16_dense"]["grads"][j]],
                         [out["float32_dense"]["grads"][j]] * 2)
        per_batch.append(dict(
            batch=i, weights_seed=cfg.init_weights_seed + i,
            routing_flips_of_the_later_passes=flips,
            loss={k: out[k]["loss"] for k in out},
            moe_lb_loss={k: out[k]["moe_lb_loss"] for k in out},
            moe_bf16_sparse_vs_dense=gated, bf16_sparse_vs_dense=whole,
            bf16_worst_leaf_vs_float32={"leaf": leaf, "sparse": to32[0], "dense": to32[1]}))
        worst = max(max(gated["scalar_rel_err"].values()), gated["grad_rel_err_top"][0][1])
        if worst > TOL_MOE_TRAIN_ROUTES:
            failures.append(f"batch {i}: sparse against dense, MoE sub-layers in bf16: "
                            f"{gated['scalar_rel_err']}, worst gradients "
                            f"{gated['grad_rel_err_top']}")
        del out
        torch.cuda.empty_cache()
    emit("moe_train_parity", t0, card=card,
         tokens=cfg.global_batch_size_to_train_on * cfg.max_target_length,
         moe_layers=moe_layers, grads=len(names), tol_rel=TOL_MOE_TRAIN_ROUTES,
         grad_rel_err_max=max(b["moe_bf16_sparse_vs_dense"]["grad_rel_err_top"][0][1]
                              for b in per_batch),
         bf16_step_grad_rel_err_max=max(b["bf16_sparse_vs_dense"]["grad_rel_err_top"][0][1]
                                        for b in per_batch),
         kernel_launches_per_pass=want, batches=per_batch,
         float32_sparse_vs_dense=f32_step)
    check(not failures, f"moe_train_parity (tolerance {TOL_MOE_TRAIN_ROUTES}): {failures}")
    del model, model32
    return {k: f32_step["counts"].get(k, 0) for k in F32_GMM}


def phase_deepseek_train(card):
    """deepseek-v2-lite at full width, its dense layer and one MoE layer:
    MLA's backward, the shared experts and the sigmoid, group-limited router
    with its bias in a training step."""
    return _train_family("deepseek_train", DEEPSEEK_TRAIN_ARGS, card, DEEPSEEK_TRAIN_STEPS)


def _mtp_parity(card):
    """One float32 step of a deepseek-v3-shaped model at CPU size (two MTP
    depths), card against CPU from one set of weights and one batch."""
    from maxtext_indextts2_tpu_torch.config import load_config
    from maxtext_indextts2_tpu_torch.train import train

    cfg = load_config(MTP_PARITY_ARGS)
    cpu = train.setup_train_state(cfg, device="cpu")
    weights = {k: v.detach().clone() for k, v in cpu.params.items()}
    gpu = train.setup_train_state(cfg, params={k: v.cuda() for k, v in weights.items()})
    batch = next(train.create_data_iterator(cfg, torch.device("cpu")))
    res = {}
    for name, state in (("cpu", cpu), ("card", gpu)):
        b = {k: v.to(state.device) for k, v in batch.items()}
        loss, aux = train.loss_fn(state.model, cfg, b)
        grads = train._grads(loss, list(state.params.values()))
        res[name] = (float(loss.detach()), float(aux["mtp_loss"].detach()),
                     [g.detach().cpu() for g in grads])
    loss_rel = max(abs(res["card"][i] - res["cpu"][i]) / abs(res["cpu"][i]) for i in (0, 1))
    rel = {n: float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
           for n, a, b in zip(cpu.params, res["card"][2], res["cpu"][2])}
    worst = max(rel, key=rel.get)
    check(loss_rel <= TOL_MTP_PARITY_LOSS and rel[worst] <= TOL_MTP_PARITY_GRAD,
          f"mtp_train: card against CPU, loss / mtp_loss {loss_rel}, worst gradient {worst} "
          f"{rel[worst]}")
    return dict(cpu_parity_loss=[res["card"][0], res["cpu"][0]],
                cpu_parity_mtp_loss=[res["card"][1], res["cpu"][1]],
                cpu_parity_loss_rel_err=loss_rel, cpu_parity_grad_rel_err_max=rel[worst],
                cpu_parity_grad_worst=worst, cpu_parity_tol=[TOL_MTP_PARITY_LOSS,
                                                             TOL_MTP_PARITY_GRAD])


def phase_mtp_train(card):
    """deepseek-v3 at full width, the trunk cut to one dense layer, its MTP
    depth whole, 1 x 1024 tokens: mtp_loss finite, every mtp_1 weight with a
    gradient (Adam's first moment after step 1), steps timed; then one step
    card against CPU at a CPU-sized width."""
    from maxtext_indextts2_tpu_torch.config import load_config
    from maxtext_indextts2_tpu_torch.train import train
    from maxtext_indextts2_tpu_torch.utils import flops

    t0 = time.perf_counter()
    cfg = load_config(MTP_TRAIN_ARGS)
    params, _, _ = _model_counts(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = train.setup_train_state(cfg)
    batch = next(train.create_data_iterator(cfg, state.device))
    mtp_params = sum(p.numel() for n, p in state.params.items() if n.startswith("mtp_1."))
    hist, no_grad = [], None
    for step in range(MTP_TRAIN_STEPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        m = train.train_step(cfg, state, batch)
        torch.cuda.synchronize()
        hist.append({**{k: float(v) for k, v in m.items()},
                     "step_time_s": time.perf_counter() - t1})
        if step == 0:
            mu = state.opt_state["mu"]
            no_grad = [n for n in state.params if n.startswith("mtp_1.")
                       and float(mu[n].abs().max()) == 0.0]
    peak = torch.cuda.max_memory_allocated()
    losses, mtp = [h["loss"] for h in hist], [h["mtp_loss"] for h in hist]
    check(all(np.isfinite(losses)) and all(np.isfinite(mtp)), f"mtp_train: {losses} {mtp}")
    check(not no_grad, f"mtp_train: mtp_1 weights with no gradient: {no_grad}")
    del state, batch
    gc.collect()
    torch.cuda.empty_cache()
    step_s = _median_step_seconds(hist)
    tokens = cfg.global_batch_size_to_train_on * cfg.max_target_length
    tflops = flops.training_tflops_per_step(cfg)
    emit("mtp_train", t0, card=card, params=params, mtp_params=mtp_params,
         layers=cfg.num_decoder_layers, mtp_layers=cfg.mtp_num_layers, emb_dim=cfg.emb_dim,
         vocab=cfg.vocab_size, steps=MTP_TRAIN_STEPS, losses=losses, mtp_loss=mtp,
         step_seconds=[h["step_time_s"] for h in hist], median_step_seconds=step_s,
         tokens_per_step=tokens, tokens_per_s=tokens / step_s,
         mfu_at_989_tflops_trunk_only=flops.mfu(tflops, step_s), peak_memory_bytes=peak,
         mtp_weights_with_gradient=True, **_mtp_parity(card))


def phase_sft_train(card):
    """train_sft (``train/sft.py``'s entry point) on tts-1b at full width:
    synthetic prompt / completion pairs, the prompt's targets weighing
    nothing; K9-K11 launches as the train recipe's. A functional check, not
    a throughput figure: the JAX package's synthetic pairs are 8-47 tokens in
    2,048-token rows (about 1 % of each row real), so no step time is
    reported."""
    from maxtext_indextts2_tpu_torch.config import load_config
    from maxtext_indextts2_tpu_torch.train import sft

    t0 = time.perf_counter()
    args = [a for a in TRAIN_ARGS if not a.startswith("steps=")] + [f"steps={SFT_TRAIN_STEPS}"]
    cfg = load_config(args)
    rows = next(sft.SFTDataIterator(cfg))
    weighted = float((rows["targets_segmentation"] != 0).mean())
    real = float((rows["inputs_segmentation"] != 0).mean())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_all_counts()
    out = sft.main(args)
    torch.cuda.synchronize()
    launches = _all_counts()
    hist = out["history"]
    losses = [h["loss"] for h in hist]
    check(len(hist) == SFT_TRAIN_STEPS and all(np.isfinite(losses)), f"sft_train: {losses}")
    want = _train_launches_want(cfg.num_decoder_layers, SFT_TRAIN_STEPS)
    check(launches == want, f"sft_train: launches {launches} != predicted {want}")
    check(0 < weighted < real, f"sft_train: weighted targets {weighted}, real tokens {real}")
    emit("sft_train", t0, card=card, steps=SFT_TRAIN_STEPS, losses=losses,
         rows=cfg.global_batch_size_to_train_on, max_target_length=cfg.max_target_length,
         real_token_share=real, weighted_target_share=weighted,
         peak_memory_bytes=torch.cuda.max_memory_allocated(),
         launches={k: v for k, v in launches.items() if v})
    return {k: v for k, v in launches.items() if v}


def _vision_prompts(rng, vocab, image_token, image_tokens, n):
    """n prompts of text, one image's placeholders, text (under 1024 tokens)."""
    out = []
    for _ in range(n):
        a, b = int(rng.integers(8, 300)), int(rng.integers(8, 200))
        out.append(np.concatenate([rng.integers(1, image_token - 1, size=a),
                                   np.full(image_tokens, image_token),
                                   rng.integers(1, image_token - 1, size=b)]).astype(np.int32))
    return out


def _serve_vision(phase, engine, card, load, tower, prompts, teacher_forced, extra):
    """The image soft tokens of ``tower`` (a callable: pixels -> [n, T, E],
    timed), one ``Engine.prefill(vision_embeddings=)`` a prompt into its slot,
    greedy decode through the captured step, and the teacher-forced check of
    the cached streams (the forward fusing the same soft tokens)."""
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    soft = tower()
    torch.cuda.synchronize()
    tower_s = time.perf_counter() - t1
    check(bool(torch.isfinite(soft.float()).all()) and soft.shape[0] == len(prompts),
          f"{phase}: soft tokens {tuple(soft.shape)} not finite or not one an image")
    captures0, replays0 = engine.graphs.captures, engine.graphs.replays
    _reset_all_counts()
    state, firsts = engine.init_decode_state(), []
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for i, p in enumerate(prompts):
        prefix, first = engine.prefill(p, len(p), vision_embeddings=soft[i:i + 1])
        state = engine.insert(prefix, state, i)
        firsts.append(first)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t1
    toks = []
    t1 = time.perf_counter()
    for _ in range((VISION_NEW_TOKENS - 1) // STEPS_PER_DISPATCH):
        state, t = engine.generate_n(state, STEPS_PER_DISPATCH)
        toks.append(t)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t1
    launches = _all_counts()
    steps = len(toks) * STEPS_PER_DISPATCH
    gen = torch.cat(toks).cpu().numpy()
    first = torch.cat(firsts).cpu().numpy()
    streams = [[int(first[i])] + gen[:, i].tolist() for i in range(len(prompts))]
    check(all(0 <= t < engine.cfg.vocab_size for s in streams for t in s),
          f"{phase}: a token outside [0, vocab)")
    replays = engine.graphs.replays - replays0
    check(replays >= len(toks) - 1, f"{phase}: decode not captured ({replays} replays)")
    n_tf = TEACHER_FORCED_STREAMS
    gaps = None if teacher_forced else []
    agree, compared, exact = _near_tie_agreement(
        engine, prompts[:n_tf], [s[:TEACHER_FORCED_TOKENS] for s in streams[:n_tf]], gaps,
        vision=[soft[i:i + 1] for i in range(n_tf)])
    if teacher_forced:
        check(agree == compared, f"{phase}: cached greedy differs from the teacher-forced "
                                 f"argmax in {compared - agree} of {compared} tokens")
    fields = dict(card=card, **load, images=len(prompts), soft_tokens_an_image=soft.shape[1],
                  prompt_lengths=[len(p) for p in prompts], new_tokens=steps + 1,
                  tower_seconds=tower_s, tower_ms_an_image=1e3 * tower_s / len(prompts),
                  prefill_ms_a_prompt=1e3 * prefill_s / len(prompts),
                  decode_ms_a_step=1e3 * decode_s / steps, decode_steps=steps,
                  captures=engine.graphs.captures - captures0, replays=replays,
                  teacher_forced_agree=agree, teacher_forced_compared=compared,
                  teacher_forced_exact=exact, teacher_forced_required=teacher_forced,
                  launches={k: v for k, v in launches.items() if v}, **extra)
    if gaps is not None:
        fields["router_gaps_where_not_agreeing"] = gaps
    emit(phase, t0, **fields)
    return {k: v for k, v in launches.items() if v}


def phase_vision_serve(card):
    """gemma3-4b whole (bf16) with the SigLIP tower and the Gemma 3 projector:
    8 image prompts of seeded pixels (preprocessed to 896 x 896), 256 soft
    tokens each, prefilled one by one, 63 greedy steps captured; the
    teacher-forced check is required."""
    from maxtext_indextts2_tpu_torch.config import load_config
    from maxtext_indextts2_tpu_torch.infer.engine import Engine
    from maxtext_indextts2_tpu_torch.models import vision
    from maxtext_indextts2_tpu_torch.utils import multimodal

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = Engine(load_config(GEMMA3_VISION_ARGS))
    engine.load_params()
    enc = vision.VisionEncoder(vision.VisionConfig(**GEMMA3_SIGLIP, output_dim=0, pool_stride=1,
                                                   dtype=torch.bfloat16), device="cuda")
    enc.init_params(seed=7)
    patches = GEMMA3_SIGLIP["image_size"] // GEMMA3_SIGLIP["patch_size"]
    proj = vision.Gemma3MultiModalProjector(GEMMA3_SIGLIP["hidden_size"], engine.cfg.emb_dim,
                                            patches, 16, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(8)
    with torch.no_grad():
        proj.mm_soft_emb_norm.scale.zero_()
        proj.mm_input_projection.copy_(torch.randn(proj.mm_input_projection.shape, generator=gen,
                                                   device="cuda")
                                       / math.sqrt(GEMMA3_SIGLIP["hidden_size"]))
    torch.cuda.synchronize()
    load = dict(params=sum(p.numel() for p in engine.model.parameters()),
                tower_params=sum(p.numel() for p in enc.parameters()),
                projector_params=sum(p.numel() for p in proj.parameters()),
                load_seconds=time.perf_counter() - t0)
    rng = np.random.default_rng(61)
    images = [rng.integers(0, 256, (int(rng.integers(300, 900)), int(rng.integers(300, 900)), 3),
                           np.uint8) for _ in range(VISION_IMAGES)]
    t1 = time.perf_counter()
    pixels = np.concatenate([multimodal.preprocess_image_gemma3(im) for im in images])
    preprocess_s = time.perf_counter() - t1

    def tower():
        with torch.no_grad():
            x = torch.from_numpy(pixels).cuda()
            return torch.cat([proj(enc(x[i:i + VISION_TOWER_BATCH])).to(torch.bfloat16)
                              for i in range(0, len(x), VISION_TOWER_BATCH)])

    prompts = _vision_prompts(rng, engine.cfg.vocab_size, GEMMA3_IMAGE_TOKEN, 256, VISION_IMAGES)
    launches = _serve_vision("vision_serve", engine, card, load, tower, prompts, True,
                             dict(siglip=GEMMA3_SIGLIP, preprocess_seconds=preprocess_s,
                                  peak_memory_bytes=torch.cuda.max_memory_allocated()))
    del engine, enc, proj
    return launches


def phase_llama4_vision_serve(card):
    """llama4-scout cut as llama4_serve (4 of 48 layers) with Llama 4's
    vision tower at its published widths and the projector: 8 image prompts
    of one 336-pixel tile, 144 soft tokens each; the teacher-forced check is
    reported with the router gap at each token that does not agree (a bf16
    MoE's router near a tie, as llama4_serve)."""
    from maxtext_indextts2_tpu_torch.config import load_config
    from maxtext_indextts2_tpu_torch.infer.engine import Engine
    from maxtext_indextts2_tpu_torch.models import vision
    from maxtext_indextts2_tpu_torch.utils import multimodal

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = Engine(load_config(LLAMA4_VISION_ARGS))
    engine.load_params()
    enc = vision.Llama4VisionEncoder(**LLAMA4_VISION, dtype=torch.bfloat16, device="cuda")
    enc.init_params(seed=9)
    gen = torch.Generator(device="cuda").manual_seed(10)
    out_dim = LLAMA4_VISION["projector_output_dim"]
    kernel = (torch.randn((out_dim, engine.cfg.emb_dim), generator=gen, device="cuda")
              / math.sqrt(out_dim)).to(torch.bfloat16)
    torch.cuda.synchronize()
    load = dict(params=sum(p.numel() for p in engine.model.parameters()),
                tower_params=sum(p.numel() for p in enc.parameters()),
                projector_params=kernel.numel(), load_seconds=time.perf_counter() - t0)
    rng = np.random.default_rng(62)
    images = [rng.integers(0, 256, (int(rng.integers(200, 336)), int(rng.integers(200, 336)), 3),
                           np.uint8) for _ in range(VISION_IMAGES)]
    tiles = [multimodal.preprocess_image_llama4(im) for im in images]
    check(all(grid == (1, 1) for _, grid in tiles), "llama4_vision_serve: an image took tiles")
    pixels = np.concatenate([t for t, _ in tiles])

    def tower():
        with torch.no_grad():
            x = torch.from_numpy(pixels).cuda()
            return torch.cat([(enc(x[i:i + VISION_TOWER_BATCH]).to(torch.bfloat16) @ kernel)
                              for i in range(0, len(x), VISION_TOWER_BATCH)])

    per_tile = (LLAMA4_VISION["image_size"] // LLAMA4_VISION["patch_size"]) ** 2 // 4
    prompts = _vision_prompts(rng, engine.cfg.vocab_size, LLAMA4_IMAGE_TOKEN, per_tile,
                              VISION_IMAGES)
    launches = _serve_vision("llama4_vision_serve", engine, card, load, tower, prompts, False,
                             dict(tower=LLAMA4_VISION, layers=engine.cfg.num_decoder_layers,
                                  peak_memory_bytes=torch.cuda.max_memory_allocated()))
    del engine, enc
    return launches


# ROADMAP item 6, parallelism on torch.distributed: several ranks share the
# card (gloo; NCCL refuses a second rank on one device), spawned by
# tools/parallel_phases.py after the build. Each multi-rank run is held to the
# one-rank run on the same data. Tolerances (the recipe's bfloat16 weights and
# activations; the ranks' products run on fewer rows, so cuBLAS may pick other
# kernels, and gradients are summed in another order): loss 2e-3 relative,
# global gradient norm 2e-2 relative, parameter norm 1e-4 relative, a probe
# weight's gradient within 2**-5 of its largest entry, every parameter within
# 2 learning rates a step plus 2**-7 of its value (a bfloat16 rounding;
# tools/parallel_phases.UPDATES_PER_STEP, PARAM_ROUNDING).
# Context-parallel attention against one-rank K9-K11 on the whole tensors:
# within 2**-5 of max(1, the reference's largest entry), output and q / k / v
# gradients.
TOL_PAR_LOSS_REL, TOL_PAR_GRAD_NORM_REL, TOL_PAR_PARAM_NORM_REL = 2e-3, 2e-2, 1e-4
TOL_PAR_PROBE, TOL_PAR_ATTENTION = 2.0 ** -5, 2.0 ** -5
# Zero-1 held as FSDP is; and at 4 layers, one step with it against the same
# step without it: the same loss, the grad norm within 1e-3 (the same
# bfloat16 gradients, summed over the microbatches before or after their
# reduction)
TOL_ZERO1_GRAD_NORM_REL = 1e-3
# GRPO: 2 iterations of G = 4 completions of 64 tokens for 4 prompts of 32;
# distillation: 16 prompts; both on one engine shape (16 slots, 128 rows),
# then SFT on distillation's JSONL at 16 rows of 128
POSTTRAIN_ARGS = ["max_target_length=128", "max_prefill_predict_length=64",
                  "per_device_batch_size=16", "decode_attention=ragged",
                  "serve_params_dtype=bfloat16"]
GRPO_PROMPTS, GRPO_GROUP, GRPO_NEW_TOKENS, GRPO_ITERATIONS = 4, 4, 64, 2
DISTILL_PROMPTS, PROMPT_TOKENS = 16, 32
DPO_STEPS = 3
ELASTIC_STEPS, ELASTIC_FAIL_AT = 6, 3


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-12)


def _check_history(phase, got, want, steps):
    """Each step's loss, grad norm and parameter norm against the one-rank run."""
    for i in range(steps):
        g, w = got[i], want[i]
        check(_rel(g["loss"], w["loss"]) <= TOL_PAR_LOSS_REL,
              f"{phase}: step {i} loss {g['loss']} against one rank's {w['loss']}")
        check(_rel(g["grad_norm"], w["grad_norm"]) <= TOL_PAR_GRAD_NORM_REL,
              f"{phase}: step {i} grad norm {g['grad_norm']} against {w['grad_norm']}")
        check(_rel(g["param_norm"], w["param_norm"]) <= TOL_PAR_PARAM_NORM_REL,
              f"{phase}: step {i} param norm {g['param_norm']} against {w['param_norm']}")


def _gathers(run) -> tuple:
    return run["fsdp"]["gathers"], run["fsdp"]["reductions"]


def _sum_launches(*runs) -> dict:
    out = dict(NO_FLASH)
    for run in runs:
        for k, n in run["launches"].items():
            out[k] += n
    return out


def _rank_fields(runs) -> list:
    keys = ("seconds", "peak_bytes", "start_bytes", "fsdp", "collective_calls",
            "collective_bytes", "host_staged_bytes", "launches", "kernel_launches")
    return [{k: r[k] for k in keys if k in r} for r in runs]


def phase_parallel(tmp, card) -> tuple[dict, tuple]:
    """The multi-rank phases: parallel_fsdp_train, parallel_zero1,
    ring_attention (with all-gather and Ulysses, at cp 2 and the ring at cp 4,
    and a training step at 1 x 16,384), pipeline_train and the two-rank part
    of elastic_train. The same two spawns run the splits' runs, after their
    one-rank references (:func:`phase_parallel_splits` reports them).
    Returns each main path's K9-K11 launches, and the splits' references,
    runs and common fields."""
    from maxtext_indextts2_tpu_torch.config import load_config
    from maxtext_indextts2_tpu_torch.models import Transformer
    from maxtext_indextts2_tpu_torch.tools import parallel_phases as pp

    from maxtext_indextts2_tpu_torch.infer.engine import resolve_device

    t0 = time.perf_counter()
    dev = resolve_device(None)  # the card, or an error
    pp.attention_reference(tmp, dev)
    fsdp_ref = pp.train_reference(tmp, dev, [f"per_device_batch_size={pp.ONE_RANK_ROWS}"],
                                  pp.FSDP_STEPS, "fsdp", True)
    ctx_ref = pp.train_reference(tmp, dev, ["per_device_batch_size=1",
                                            f"max_target_length={pp.CONTEXT_TOKENS}"], 1,
                                 "context", False)
    split_refs = pp.split_references(tmp, dev)
    gc.collect()
    torch.cuda.empty_cache()
    t_ref = time.perf_counter() - t0
    two = pp.run_ranks(2, "two_ranks", tmp)
    t_two = time.perf_counter() - t0 - t_ref
    four = pp.run_ranks(4, "four_ranks", tmp)
    t_four = time.perf_counter() - t0 - t_ref - t_two
    elastic_ref = pp.elastic_reference(dev)
    gc.collect()
    torch.cuda.empty_cache()
    cfg = load_config(pp.TRAIN_ARGS + [f"per_device_batch_size={pp.ONE_RANK_ROWS}"])
    n_params = sum(p.numel() for p in Transformer(cfg, device="meta").parameters())
    one_rank_state = n_params * 2 * 3  # bfloat16 parameters and two moments
    lr = fsdp_ref["lr_max"]
    common = dict(card=card, ranks_share_one_card=True, backend="gloo",
                  spawn_seconds={"references": t_ref, "two_ranks": t_two, "four_ranks": t_four})

    # parallel_fsdp_train
    runs = [r["fsdp"] for r in two]
    for r in runs:
        _check_history("parallel_fsdp_train", r["history"], fsdp_ref["history"], pp.FSDP_STEPS)
        check(r["param_diff_in_tolerance_units"] <= 1.0,
              f"parallel_fsdp_train: a parameter is {r['param_max_abs_diff']} from one rank's "
              f"({r['param_diff_in_tolerance_units']} of its tolerance)")
        for n, (_, rel) in r["probe_errors"].items():
            check(rel <= TOL_PAR_PROBE, f"parallel_fsdp_train: gradient of {n} off by {rel}")
        check(_gathers(r) == (pp.FSDP_STEPS, pp.FSDP_STEPS),
              f"parallel_fsdp_train: gathers {r['fsdp']}")
        check(0.49 * one_rank_state <= r["state_bytes"] <= 0.52 * one_rank_state,
              f"parallel_fsdp_train: a rank holds {r['state_bytes']} of {one_rank_state} bytes")
    emit("parallel_fsdp_train", t0, **common, rows=runs[0]["rows"], steps=pp.FSDP_STEPS,
         losses=[[h["loss"] for h in r["history"]] for r in runs],
         one_rank_losses=[h["loss"] for h in fsdp_ref["history"]],
         grad_norms=[h["grad_norm"] for h in runs[0]["history"]],
         one_rank_grad_norms=[h["grad_norm"] for h in fsdp_ref["history"]],
         param_max_abs_diff=[r["param_max_abs_diff"] for r in runs], learning_rate=lr,
         param_diff_in_tolerance_units=[r["param_diff_in_tolerance_units"] for r in runs],
         probe_errors=[r["probe_errors"] for r in runs], state_bytes_per_rank=[
             r["state_bytes"] for r in runs], one_rank_state_bytes=one_rank_state,
         ranks=_rank_fields(runs),
         tolerances=dict(loss_rel=TOL_PAR_LOSS_REL, grad_norm_rel=TOL_PAR_GRAD_NORM_REL,
                         param_norm_rel=TOL_PAR_PARAM_NORM_REL, probe=TOL_PAR_PROBE,
                         updates_per_step=pp.UPDATES_PER_STEP, param_rounding=pp.PARAM_ROUNDING))
    paths = {"parallel_fsdp_train": _sum_launches(*runs)}

    # parallel_zero1: one gather a step against one a microbatch
    zero1, without = [r["zero1"] for r in two], [r["zero1_without"] for r in two]
    small = [r["zero1_small"] for r in two]
    for z, zs, w in zip(zero1, small, without):
        _check_history("parallel_zero1", z["history"], fsdp_ref["history"], pp.FSDP_STEPS)
        check(z["param_diff_in_tolerance_units"] <= 1.0,
              f"parallel_zero1: a parameter is {z['param_max_abs_diff']} from one rank's "
              f"({z['param_diff_in_tolerance_units']} of its tolerance)")
        for n, (_, rel) in z["probe_errors"].items():
            check(rel <= TOL_PAR_PROBE, f"parallel_zero1: gradient of {n} off by {rel}")
        check(_gathers(z) == (pp.FSDP_STEPS, pp.FSDP_STEPS) and _gathers(zs) == (1, 1)
              and _gathers(w) == (2, 2),
              f"parallel_zero1: gathers {z['fsdp']} and {zs['fsdp']} with Zero-1, "
              f"{w['fsdp']} without")
        # the same step: the same loss, the gradients summed in another order
        check(zs["history"][0]["loss"] == w["history"][0]["loss"]
              and _rel(zs["history"][0]["grad_norm"], w["history"][0]["grad_norm"])
              <= TOL_ZERO1_GRAD_NORM_REL,
              f"parallel_zero1: step {zs['history'][0]} against {w['history'][0]} without")
    emit("parallel_zero1", t0, **common, rows=zero1[0]["rows"], microbatches=2,
         steps=pp.FSDP_STEPS, losses=[h["loss"] for h in zero1[0]["history"]],
         one_rank_losses=[h["loss"] for h in fsdp_ref["history"]],
         grad_norms=[h["grad_norm"] for h in zero1[0]["history"]],
         param_max_abs_diff=[z["param_max_abs_diff"] for z in zero1],
         param_diff_in_tolerance_units=[z["param_diff_in_tolerance_units"] for z in zero1],
         probe_errors=[z["probe_errors"] for z in zero1],
         four_layers_one_step=dict(zero1=small[0]["history"][0], without=without[0]["history"][0],
                                   gathers_zero1=small[0]["fsdp"], gathers_without=without[0]["fsdp"]),
         gathers_zero1=zero1[0]["fsdp"],
         ranks=_rank_fields(zero1), ranks_without=_rank_fields(without),
         tolerances=dict(loss_rel=TOL_PAR_LOSS_REL, grad_norm_rel=TOL_PAR_GRAD_NORM_REL,
                         param_norm_rel=TOL_PAR_PARAM_NORM_REL, probe=TOL_PAR_PROBE,
                         updates_per_step=pp.UPDATES_PER_STEP, param_rounding=pp.PARAM_ROUNDING,
                         without_grad_norm_rel=TOL_ZERO1_GRAD_NORM_REL))
    paths["parallel_zero1"] = _sum_launches(*zero1, *small, *without)

    # ring_attention: the op at cp 2 (three algorithms) and 4, then a step
    att = {alg: [r["attention_cp2"][alg] for r in two] for alg in ("ring", "allgather", "ulysses")}
    att["ring_cp4"] = [r["attention_cp4"]["ring"] for r in four]
    for name, runs_ in att.items():
        for r in runs_:
            for t, (_, rel) in r["errors"].items():
                check(rel <= TOL_PAR_ATTENTION, f"ring_attention: {name} {t} off by {rel}")
    ctx = [r["context_train"] for r in two]
    for r in ctx:
        _check_history("ring_attention (training step)", r["history"], ctx_ref["history"], 1)
        for n, (_, rel) in r["probe_errors"].items():
            check(rel <= TOL_PAR_PROBE, f"ring_attention: step gradient of {n} off by {rel}")
    ring_mem = max(r["attention_peak_bytes"] for r in att["ring"])
    gather_mem = max(r["attention_peak_bytes"] for r in att["allgather"])
    # the K/V a rank holds at once (from the shapes): the ring's block in hand
    # and the one arriving, all-gather's whole sequence
    kv_token = 2 * pp.ATTENTION["hkv"] * pp.ATTENTION["d"] * 2  # k and v, bfloat16
    kv_bytes = {"ring_cp2": 2 * kv_token * pp.CONTEXT_TOKENS // 2,
                "ring_cp4": 2 * kv_token * pp.CONTEXT_TOKENS // 4,
                "allgather_cp2": kv_token * pp.CONTEXT_TOKENS}
    emit("ring_attention", t0, **common, tokens=pp.CONTEXT_TOKENS, shape=pp.ATTENTION,
         errors={k: [r["errors"] for r in v] for k, v in att.items()},
         attention_peak_bytes={k: [r["attention_peak_bytes"] for r in v]
                               for k, v in att.items()},
         ring_over_allgather_peak=ring_mem / max(gather_mem, 1), kv_bytes_held=kv_bytes,
         collectives={k: [{"calls": r["collective_calls"], "bytes": r["collective_bytes"],
                           "host_staged_bytes": r["host_staged_bytes"]} for r in v]
                      for k, v in att.items()},
         seconds={k: [r["seconds"] for r in v] for k, v in att.items()},
         train_step=dict(loss=[r["history"][0]["loss"] for r in ctx],
                         one_rank_loss=ctx_ref["history"][0]["loss"],
                         grad_norm=[r["history"][0]["grad_norm"] for r in ctx],
                         one_rank_grad_norm=ctx_ref["history"][0]["grad_norm"],
                         probe_errors=[r["probe_errors"] for r in ctx],
                         ranks=_rank_fields(ctx)),
         tolerance=TOL_PAR_ATTENTION)
    paths["ring_attention"] = _sum_launches(*att["ring"], *ctx)
    paths["allgather_attention"] = _sum_launches(*att["allgather"])
    paths["ulysses_attention"] = _sum_launches(*att["ulysses"])
    paths["ring_attention_cp4"] = _sum_launches(*att["ring_cp4"])

    # pipeline_train: both schedules against the unpipelined one-rank steps
    pipe = {name: [r[name] for r in two] for name in ("pipeline", "pipeline_delayed")}
    for name, runs_ in pipe.items():
        for stage, r in enumerate(runs_):
            _check_history(f"pipeline_train ({name})", r["history"], fsdp_ref["history"],
                           pp.PIPELINE_STEPS)
            check(all(int(u.rsplit("_", 1)[1]) % 2 == stage for u in r["units"])
                  and len(r["units"]) == cfg.num_decoder_layers // 2,
                  f"pipeline_train: stage {stage} holds {r['units']}")
            for n, (_, rel) in r["probe_errors"].items():
                check(rel <= TOL_PAR_PROBE, f"pipeline_train: gradient of {n} off by {rel}")
    probes = {n for r in pipe["pipeline"] for n in r["probe_errors"]}
    check(probes == set(pp.probe_names(cfg)), f"pipeline_train: probes held {sorted(probes)}")
    emit("pipeline_train", t0, **common, stages=2, repeats=cfg.num_decoder_layers // 2,
         microbatches=2, steps=pp.PIPELINE_STEPS,
         losses={k: [h["loss"] for h in v[0]["history"]] for k, v in pipe.items()},
         one_rank_losses=[h["loss"] for h in fsdp_ref["history"][:pp.PIPELINE_STEPS]],
         grad_norms={k: [h["grad_norm"] for h in v[0]["history"]] for k, v in pipe.items()},
         probe_errors={k: [r["probe_errors"] for r in v] for k, v in pipe.items()},
         ranks={k: _rank_fields(v) for k, v in pipe.items()})
    paths["pipeline_train"] = _sum_launches(*pipe["pipeline"], *pipe["pipeline_delayed"])

    # elastic_train, two ranks -> one
    left, kept = two[1]["elastic"]["result"], two[0]["elastic"]["result"]
    check(left == {"left_at": pp.ELASTIC_FAIL_AT, "recoveries": 1},
          f"elastic_train: rank 1 returned {left}")
    check(kept["recoveries"] == 1 and (kept["final_step"], kept["final_num_devices"],
           kept["final_global_batch"]) == (5, 1, 2), f"elastic_train: rank 0 {kept}")
    check(_rel(kept["loss"], elastic_ref["loss"]) <= TOL_PAR_LOSS_REL,
          f"elastic_train: loss {kept['loss']} against {elastic_ref['loss']}")
    emit("elastic_train_resize", t0, **common, result=kept, one_process=elastic_ref,
         ranks=_rank_fields([r["elastic"] for r in two]), tolerance_loss_rel=TOL_PAR_LOSS_REL)
    paths["elastic_train"] = _sum_launches(*[r["elastic"] for r in two])
    return paths, (split_refs, two, four, common)


# ROADMAP item 6b, the splits inside the layers: each multi-rank run against
# the one-rank run of the same config and seed. Serving: the logits behind
# the tokens a rank's streams share with one rank's (the prefill's last row
# and each decode step's, up to and with a stream's first parting) and the
# teacher-forced logits of one rank's first two streams lie within
# TOL_SPLIT_LOGITS of the largest |logit| (bfloat16 weights and activations:
# the partial products are summed over the ranks in float32 and rounded once,
# where one rank rounds each product once, so every layer may differ by a
# bfloat16 step, which the layers carry to the logits; int8w_serve's row split
# sums int8w_matmul's partials, each rounded to bfloat16 by the kernel;
# context_autoregressive merges the ranks' partial softmaxes in float32 where
# one rank rounds the probabilities to bfloat16 before the PV product).
# TOL_SPLIT_LOGITS is 2.1x the largest reading before it was set (tp_serve's
# teacher-forced 0.0703 of logits up to 4.72: 1.49 %; tp_serve_int8w's 1.33 %;
# 0 over context_autoregressive and expert). The streams are equal on every rank, and
# equal to one rank's or parting only where one rank's two best logits lie
# within twice the largest logit difference the run measured (two logits that
# each move by at most that much can swap only there; the gap is printed).
# A rank that holds a split of the weights (tp_serve, ep_serve) peaks below
# the one-rank engine. Training: the FSDP runs' tolerances (TOL_PAR_*,
# tools/parallel_phases.UPDATES_PER_STEP, PARAM_ROUNDING).
TOL_SPLIT_LOGITS = 2.0 ** -5
SPLIT_WEIGHT_PHASES = ("tp_serve", "ep_serve")


def phase_parallel_splits(refs, two, four, common) -> dict:
    """The splits' runs that :func:`phase_parallel`'s spawns made: tp_serve,
    tp_serve_paged, tp_serve_int8w, ar_context_serve, ep_serve, ep_train (two
    ranks) and tp_train (four), each against its one-rank reference. Returns
    each main path's kernel launches."""
    from maxtext_indextts2_tpu_torch.tools import parallel_phases as pp

    t0 = time.perf_counter()
    paths = {}

    def launches(runs):
        out = {}
        for r in runs:
            for k, n in r["kernel_launches"].items():
                out[k] = out.get(k, 0) + n
        return {k: n for k, n in out.items() if n}

    checks = []  # every serving line first, so that a failed check leaves all readings
    for phase in ("tp_serve", "tp_serve_paged", "tp_serve_int8w", "ar_context_serve",
                  "ep_serve"):
        ref, runs = refs[phase], [r[phase] for r in two]
        tie = 2.0 * min(r["logit_max_abs_err"] for r in runs)
        leading = _leading_agreement(runs[0]["streams"], ref["streams"])
        partings = [dict(stream=i, step=j, one_rank_gap=ref["gaps"][i][j], near_tie=tie)
                    for i, j in enumerate(leading) if j < len(ref["streams"][i])]
        peak = [r["peak_bytes"] - r["start_bytes"] for r in runs]
        counts = launches(runs)
        emit(phase, t0, **common, slots=pp.SPLIT_SLOTS, steps=pp.SPLIT_STEPS,
             equal_streams=sum(j == pp.SPLIT_STEPS for j in leading),
             partings=partings, logit_max_abs_err=[r["logit_max_abs_err"] for r in runs],
             decode_logit_max_abs_err=[r["decode_logit_max_abs_err"] for r in runs],
             forced_logit_max_abs_err=[r["forced_logit_max_abs_err"] for r in runs],
             logit_max_abs=runs[0]["logit_max_abs"],
             tolerance_logits_of_largest=TOL_SPLIT_LOGITS,
             decode_seconds=[r["decode_seconds"] for r in runs],
             one_rank_decode_seconds=ref["decode_seconds"],
             param_bytes_per_rank=[r["param_bytes"] for r in runs],
             one_rank_param_bytes=ref["param_bytes"], peak_bytes_per_rank=peak,
             one_rank_peak_bytes=ref["peak_bytes"], launches=counts, ranks=_rank_fields(runs))
        for rank, r in enumerate(runs):
            checks += [(r["streams"] == runs[0]["streams"],
                        f"{phase}: rank {rank} sampled other tokens than rank 0"),
                       (r["captures"] == 0, f"{phase}: {r['captures']} captures on a gloo mesh"),
                       (r["logit_max_abs_err"] <= TOL_SPLIT_LOGITS * r["logit_max_abs"],
                        f"{phase}: logits {r['logit_max_abs_err']} from one rank's "
                        f"(largest {r['logit_max_abs']})")]
        checks += [(p["one_rank_gap"] <= tie,
                    f"{phase}: stream {p['stream']} parts at step {p['step']}, where one "
                    f"rank's two best logits are {p['one_rank_gap']} apart (a near tie is {tie})")
                   for p in partings]
        if phase in SPLIT_WEIGHT_PHASES:
            checks.append((max(peak) < ref["peak_bytes"],
                           f"{phase}: a rank peaks at {max(peak)} bytes, one rank at "
                           f"{ref['peak_bytes']}"))
        paths[phase] = counts
    for ok, what in checks:
        check(ok, what)

    for phase, ranks, steps in (("ep_train", two, pp.EP_TRAIN_STEPS),
                                ("tp_train", four, pp.FSDP_STEPS)):
        ref, runs = refs[phase], [r[phase] for r in ranks]
        for r in runs:
            _check_history(phase, r["history"], ref["history"], steps)
            check(r["param_diff_in_tolerance_units"] <= 1.0,
                  f"{phase}: a parameter is {r['param_max_abs_diff']} from one rank's "
                  f"({r['param_diff_in_tolerance_units']} of its tolerance)")
            for n, (_, rel) in r["probe_errors"].items():
                check(rel <= TOL_PAR_PROBE, f"{phase}: gradient of {n} off by {rel}")
        counts = launches(runs)
        emit(phase, t0, **common, ranks_n=len(runs), rows=runs[0]["rows"], steps=steps,
             losses=[[h["loss"] for h in r["history"]] for r in runs],
             one_rank_losses=[h["loss"] for h in ref["history"]],
             grad_norms=[h["grad_norm"] for h in runs[0]["history"]],
             one_rank_grad_norms=[h["grad_norm"] for h in ref["history"]],
             step_seconds=[h["seconds"] for h in runs[0]["history"]],
             param_max_abs_diff=[r["param_max_abs_diff"] for r in runs],
             param_diff_in_tolerance_units=[r["param_diff_in_tolerance_units"] for r in runs],
             probe_errors=[r["probe_errors"] for r in runs], launches=counts,
             ranks=_rank_fields(runs),
             tolerances=dict(loss_rel=TOL_PAR_LOSS_REL, grad_norm_rel=TOL_PAR_GRAD_NORM_REL,
                             param_norm_rel=TOL_PAR_PARAM_NORM_REL, probe=TOL_PAR_PROBE,
                             updates_per_step=pp.UPDATES_PER_STEP,
                             param_rounding=pp.PARAM_ROUNDING))
        paths[phase] = counts
    return paths


def _posttrain_cfg(extra=()):
    from maxtext_indextts2_tpu_torch.config import load_config
    from maxtext_indextts2_tpu_torch.tools import parallel_phases as pp

    return load_config(pp.TRAIN_ARGS + POSTTRAIN_ARGS + list(extra))


def _prompts(seed, n, vocab):
    rng = np.random.default_rng(seed)
    return [rng.integers(3, vocab, size=PROMPT_TOKENS).astype(np.int32) for _ in range(n)]


def phase_dpo_train(card) -> dict:
    """train_dpo at tts-1b's full width: 3 steps against the frozen initial
    policy (the first step's loss is log 2 exactly: policy = reference)."""
    from maxtext_indextts2_tpu_torch.config import load_config
    from maxtext_indextts2_tpu_torch.tools import parallel_phases as pp
    from maxtext_indextts2_tpu_torch.train import dpo

    t0 = time.perf_counter()
    cfg = load_config(pp.TRAIN_ARGS + ["per_device_batch_size=4", f"steps={DPO_STEPS}"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_all_counts()
    out = dpo.train_dpo(cfg, quiet=True)
    torch.cuda.synchronize()
    launches = {k: v for k, v in _all_counts().items() if v}
    hist = out["history"]
    check(len(hist) == DPO_STEPS and all(np.isfinite(h["loss"]) for h in hist),
          f"dpo_train: {hist}")
    check(abs(hist[0]["loss"] - math.log(2)) < 1e-6 and hist[0]["chosen_reward"] == 0.0,
          f"dpo_train: the first step is not at the reference: {hist[0]}")
    check(set(launches) == set(NO_FLASH), f"dpo_train: launches {launches}")
    emit("dpo_train", t0, card=card, steps=DPO_STEPS, rows=cfg.global_batch_size_to_train_on,
         max_target_length=cfg.max_target_length, history=hist, launches=launches,
         peak_memory_bytes=torch.cuda.max_memory_allocated())
    return launches


def phase_grpo_train(card) -> dict:
    """grpo_train_loop at tts-1b's full width: 2 iterations of G = 4 sampled
    completions of 64 tokens for 4 prompts through the captured engine (K1,
    K2), the trained weights moved into the engine each iteration, and the
    update through K9-K11."""
    from maxtext_indextts2_tpu_torch.infer.engine import Engine
    from maxtext_indextts2_tpu_torch.train import grpo

    t0 = time.perf_counter()
    cfg = _posttrain_cfg(["decode_sampling_strategy=weighted", "steps=2"])
    engine = Engine(cfg)
    prompts = _prompts(1, GRPO_PROMPTS, cfg.vocab_size)
    seen = []

    def reward(completion):
        seen.append(len(completion))
        return len(set(completion)) / len(completion)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_all_counts()
    state, metrics = grpo.grpo_train_loop(cfg, reward, num_iterations=GRPO_ITERATIONS,
                                          group_size=GRPO_GROUP, prompts=prompts,
                                          max_new_tokens=GRPO_NEW_TOKENS, engine=engine)
    torch.cuda.synchronize()
    launches = {k: v for k, v in _all_counts().items() if v}
    check(state.step == GRPO_ITERATIONS and all(np.isfinite(v) for v in metrics.values()),
          f"grpo_train: step {state.step}, {metrics}")
    check(seen == [GRPO_NEW_TOKENS] * (GRPO_ITERATIONS * GRPO_PROMPTS * GRPO_GROUP),
          f"grpo_train: completions of {sorted(set(seen))} tokens")
    check(engine.graphs.replays > 0, "grpo_train: no decode step replayed a captured graph")
    for k in ("ragged_decode_attention", "inplace_row_update", *NO_FLASH):
        check(launches.get(k, 0) > 0, f"grpo_train: {k} never launched: {launches}")
    emit("grpo_train", t0, card=card, iterations=GRPO_ITERATIONS, prompts=GRPO_PROMPTS,
         group=GRPO_GROUP, new_tokens=GRPO_NEW_TOKENS, metrics=metrics,
         graph_replays=engine.graphs.replays, graph_captures=engine.graphs.captures,
         launches=launches, peak_memory_bytes=torch.cuda.max_memory_allocated())
    return launches


def phase_distillation(tmp, card) -> dict:
    """generate_distillation_data at tts-1b's full width: 16 greedy
    completions of 64 tokens through the offline engine into JSONL (the LM's
    output columns past the byte tokenizer's 259 ids zeroed, so that the
    completions decode as text), then one SFT step reading that file."""
    from maxtext_indextts2_tpu_torch.config import load_config
    from maxtext_indextts2_tpu_torch.infer.engine import Engine
    from maxtext_indextts2_tpu_torch.models import Transformer
    from maxtext_indextts2_tpu_torch.tools import parallel_phases as pp
    from maxtext_indextts2_tpu_torch.train import distillation, sft

    t0 = time.perf_counter()
    cfg = _posttrain_cfg()
    engine = Engine(cfg)
    model = Transformer(cfg, device=engine.device).init_params(cfg.init_weights_seed)
    weights = {n: t.detach() for n, t in model.state_dict().items()}
    del model
    weights["logits_dense.kernel"][:, 259:] = 0.0
    engine.set_params(weights)
    del weights
    prompts = _prompts(2, DISTILL_PROMPTS, 259)
    path = os.path.join(tmp, "distillation.jsonl")
    torch.cuda.synchronize()
    _reset_all_counts()
    n = distillation.generate_distillation_data(cfg, prompts, path, GRPO_NEW_TOKENS,
                                                engine=engine)
    torch.cuda.synchronize()
    launches = _all_counts()
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    with open(path) as fh:
        lines = [json.loads(x) for x in fh]
    check(n == DISTILL_PROMPTS == len(lines)
          and all(len(x["completion_ids"]) == GRPO_NEW_TOKENS for x in lines),
          f"distillation: {n} lines")
    sft_cfg = load_config(pp.TRAIN_ARGS + POSTTRAIN_ARGS + ["steps=1", f"dataset_path={path}"])
    out = sft.train_sft(sft_cfg, quiet=True)
    torch.cuda.synchronize()
    after = _all_counts()
    launches = {k: after[k] for k in after if after[k]}
    check(np.isfinite(out["loss"]), f"distillation: the SFT step's loss {out['loss']}")
    for k in ("ragged_decode_attention", "inplace_row_update", *NO_FLASH):
        check(launches.get(k, 0) > 0, f"distillation: {k} never launched: {launches}")
    emit("distillation", t0, card=card, prompts=n, new_tokens=GRPO_NEW_TOKENS,
         first_completion=lines[0]["completion"][:40], sft_loss=out["loss"], launches=launches)
    return launches


def phase_elastic_train(card) -> dict:
    """elastic_train_loop on one rank at tts-1b's full width: snapshots every
    2 steps, a failure injected at step 3, recovered from the step-2 snapshot
    and continued to step 6."""
    from maxtext_indextts2_tpu_torch.config import load_config
    from maxtext_indextts2_tpu_torch.tools import parallel_phases as pp
    from maxtext_indextts2_tpu_torch.train import elastic

    t0 = time.perf_counter()
    cfg = load_config(pp.TRAIN_ARGS + ["per_device_batch_size=2", f"steps={ELASTIC_STEPS}"])
    fired = []

    def inject(step):
        if step == ELASTIC_FAIL_AT and not fired:
            fired.append(step)
            raise RuntimeError(f"injected failure at step {step}")

    torch.cuda.synchronize()
    _reset_all_counts()
    out = elastic.elastic_train_loop(cfg, snapshot_period=2, failure_injector=inject)
    torch.cuda.synchronize()
    launches = {k: v for k, v in _all_counts().items() if v}
    check((out["recoveries"], out["final_step"]) == (1, ELASTIC_STEPS)
          and np.isfinite(out["loss"]), f"elastic_train: {out}")
    emit("elastic_train", t0, card=card, result=out, launches=launches)
    return launches



def kernels_line(cases, paths):
    """The summary of every kernel on a main path: error, tolerance and times
    of the case at the shapes the first main path's run gives the kernel (the
    error in the case's ``unit``), the launches of all its main paths, each
    path's own case beside them, and the kernel's case that came closest to
    its own tolerance. ``paths``: kernel -> {phase: launches}."""
    from maxtext_indextts2_tpu_torch.ops.smoke import MAIN_PATH_CASES

    def err(c):  # the error in the case's unit: ``max_err`` where that is not output values
        return c.get("max_err", c["max_abs_err"])

    def closeness(c):
        return err(c) / c["tol"] if c["tol"] else err(c)

    def timing(c):
        return dict(ms=c["kernel_ms"], device_ms=c["device_ms"], plain_ms=c["plain_ms"],
                    bound_ms=c["bound_ms"], bound_by=c["bound_by"],
                    library_ms=c["library_ms"], library_device_ms=c.get("library_device_ms"),
                    library_call=c.get("library_call"), bytes_moved=c["bytes_moved"])

    out = []
    for k in KERNELS:
        main_paths = MAIN_PATH_CASES[k["name"]]
        main = cases[next(iter(main_paths.values()))]
        own = [c for c in cases.values() if c["kernel"] == k["name"]]
        worst = max(own, key=closeness)
        accuracy = {key: main[key] for key in ("mismatch_share", "scale_max_rel_err",
                                                "tol_scale_rel") if key in main}
        launched = paths.get(k["name"], {})
        out.append(dict(
            k, launches=sum(launched.values()),
            max_abs_err=main["max_abs_err"], max_err=err(main), tol=main["tol"],
            unit=main.get("unit", "output values"), **accuracy,
            worst_case=dict(name=worst["name"], max_abs_err=worst["max_abs_err"],
                            max_err=err(worst), tol=worst["tol"],
                            unit=worst.get("unit", "output values")),
            **timing(main), shape=main["shape"], cases=len(own),
            paths=[dict(phase=phase, launches=launched.get(phase, 0), case=name,
                        max_abs_err=cases[name]["max_abs_err"], max_err=err(cases[name]),
                        tol=cases[name]["tol"], shape=cases[name]["shape"],
                        **timing(cases[name]))
                   for phase, name in main_paths.items()]))
    return {"kernels": out}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    import maxtext_indextts2_tpu_torch  # noqa: F401  (fails here, before any output, if absent)
    from maxtext_indextts2_tpu_torch.ops.smoke import MAIN_PATH_CASES

    t_all = time.perf_counter()
    card = phase_device()
    phase_build()
    cases = phase_kernels()
    # checkpoints, exported weights and data files of the later phases
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        paths = _phases(tmp, card)
    missing = {(kernel, phase) for kernel, by_phase in MAIN_PATH_CASES.items()
               for phase in by_phase if not paths.get(kernel, {}).get(phase)}
    check(not missing, f"a kernel of a main path never ran there: {sorted(missing)}")
    emit("total", t_all)
    print(json.dumps(kernels_line(cases, paths)), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def _phases(tmp, card) -> dict:
    """Every main path after the kernel checks; returns each kernel's launches
    by the main path (phase) that ran it, for the kernels line."""
    paths: dict[str, dict[str, int]] = {}

    def record(phase, counts):
        for kernel, n in counts.items():
            if n:
                paths.setdefault(kernel, {})[phase] = paths.get(kernel, {}).get(phase, 0) + n

    def release():
        # a phase may leave what it built in reference cycles (serve_paged's
        # counting hook is a closure over its orchestrator): collect them, so
        # that each phase's peak memory is its own
        gc.collect()
        torch.cuda.empty_cache()

    engine, launches = phase_serve()
    record("serve", launches)
    phase_serve_parity(engine)
    prompts, _ = make_requests(np.random.default_rng(0), engine.cfg.vocab_size)
    phase_serve_captured_parity(engine, "dense", prompts[:engine.num_slots], card)
    phase_http(engine)
    phase_grpc(engine, card)  # ROADMAP 5.10
    phase_generate_stream_http(engine)
    phase_lm_ckpt(engine, tmp)
    record("serve_int8w", phase_serve_int8w(engine, tmp, card))
    # ROADMAP item 5 (5.7, 5.9, 5.12) on the serve engine: the fused and the
    # per-request streams of its 80 requests are the references
    prompts, budgets = make_requests(np.random.default_rng(0), engine.cfg.vocab_size)
    want_fused, _ = _serve_queued(engine, prompts, budgets)
    want_single, _ = _serve_queued(engine, prompts, budgets, fusion=1)
    record("serve_scanned", phase_serve_scanned(engine, tmp, card, want_fused))
    release()
    record("serve_disaggregated", phase_serve_disaggregated(engine, card, want_single,
                                                           want_fused))
    for phase, counts in phase_offline_loadgen(engine, card, want_single).items():
        record(phase, counts)
    record("microbenchmark", phase_microbenchmark(engine, card))
    del engine
    release()
    engine, paged = phase_serve_paged()
    record("serve_paged", {"paged_decode_attention": paged})
    phase_serve_paged_parity(engine)
    # 2 pages of 128 rows a stream: prompt, 64 tokens and the profile's steps
    short = [p[:180] for p in prompts[:engine.num_slots]]
    phase_serve_captured_parity(engine, "paged", short, card)
    del engine
    release()
    record("serve_paged_short_pool", {"paged_decode_attention": phase_serve_paged_short_pool()})
    release()
    record("chunked_prefill", phase_chunked_prefill())
    release()
    for phase, counts in phase_spec_decode().items():
        record(phase, counts)
    release()
    record("bucketed_decode", phase_bucketed_decode())
    release()
    pipe_int8, backend_launches = phase_tts_backend()
    record("tts_backend", backend_launches)
    pipe_bf16 = phase_tts_backend_bf16()
    phase_tts_backend_parity(pipe_int8, pipe_bf16)
    del pipe_int8, pipe_bf16
    release()
    pipe = phase_pipeline_load()
    record("tts_synthesize", {"s2a_attention": phase_tts_synthesize(pipe)["s2a_attention"]})
    phase_tts_synthesize_parity(pipe)
    phase_tts_http(pipe)
    phase_grpc_synthesize(pipe, card)  # ROADMAP 5.10
    record("uniserver", phase_uniserver(pipe, card))  # ROADMAP 5.11
    release()
    files, prompt, semantic = phase_audio_ckpt(pipe, tmp)
    phase_audio_cli(pipe, tmp, files, prompt, semantic)
    del pipe
    release()
    launches, train_fields = phase_train()
    train_step_s = train_fields["median_step_seconds"]
    record("train", launches)
    train_loss = phase_train_parity()
    release()
    record("train_dropout", phase_train_dropout(train_step_s))
    release()
    phase_train_dropout_parity(train_loss)
    release()
    phase_train_resume(tmp)
    release()
    record("train_packed", phase_train_packed(tmp))
    phase_train_packed_parity()
    release()
    record("train_c4", phase_train_c4(tmp))
    release()
    for route in ("materialised", "seq_flash"):
        record("s2a_train", phase_s2a_train(route))
        release()
    phase_s2a_train_parity()
    release()
    record("s2a_seq_flash_serving", phase_s2a_seq_flash_serving())
    release()
    # the codec trainers: no kernel of the repository on their paths
    phase_codec_train()
    release()
    phase_codec_train_repcodec()
    release()
    phase_codec_train_parity()
    release()
    # the flagship: served whole, then trained at its vocabulary and width
    engine, launches = phase_flagship_serve(card)
    record("flagship_serve", launches)
    phase_flagship_serve_parity(engine, card)
    record("flagship_serve_int8w", phase_flagship_serve_int8w(engine, card))
    del engine
    release()
    launches, flagship_vocab_bf16 = phase_train_flagship_vocab(card)
    record("train_flagship_vocab", launches)
    release()
    phase_train_flagship_vocab_parity(card)
    release()
    record("train_flagship", phase_train_flagship(card))
    release()
    # ROADMAP item 5.6 in training: the AQT matmuls and LoRA
    record("train_int8", phase_train_int8(card, flagship_vocab_bf16, train_fields))
    release()
    phase_train_int8_parity(card)
    release()
    record("train_lora", phase_train_lora(card, train_fields))
    release()
    phase_lora_merge(card)
    release()
    # ROADMAP item 6, serving: the other model families at full width
    engine, _, moe_fields, launches = phase_moe_serve(card)
    record("moe_serve", launches)
    phase_moe_serve_parity(engine, card)
    engine, launches = phase_moe_serve_int8w(engine, card, moe_fields)
    record("moe_serve_int8w", launches)
    del engine
    release()
    record("mixtral_serve", phase_mixtral_serve(card))
    release()
    record("mla_serve", phase_mla_serve(card))
    release()
    record("gpt3_serve", phase_gpt3_serve(card))
    release()
    record("llama4_serve", phase_llama4_serve(card))
    release()
    # ROADMAP item 6, training and vision
    launches, _ = phase_moe_train(card)
    record("moe_train", launches)
    release()
    # its float32 sparse step: the float32 grouped kernels' main path
    record("moe_train_parity", phase_moe_train_parity(card))
    release()
    launches, _ = phase_deepseek_train(card)
    record("deepseek_train", launches)
    release()
    phase_mtp_train(card)
    release()
    record("vision_serve", phase_vision_serve(card))
    release()
    record("llama4_vision_serve", phase_llama4_vision_serve(card))
    release()
    record("sft_train", phase_sft_train(card))
    release()
    # ROADMAP item 6, parallelism and post-training: ranks sharing the card,
    # then DPO, GRPO, distillation and elastic training on one rank
    paths_parallel, splits = phase_parallel(tmp, card)
    for phase, counts in paths_parallel.items():
        record(phase, counts)
    # ROADMAP item 6b: the splits inside the layers, run by the same spawns
    for phase, counts in phase_parallel_splits(*splits).items():
        record(phase, counts)
    release()
    record("dpo_train", phase_dpo_train(card))
    release()
    record("grpo_train", phase_grpo_train(card))
    release()
    record("distillation", phase_distillation(tmp, card))
    release()
    record("elastic_train", phase_elastic_train(card))
    release()
    return paths


if __name__ == "__main__":
    sys.exit(main())
