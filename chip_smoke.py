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
``dot_product`` route. The kernels line lists, for each kernel, the case of
every main path that ran it.
Every phase prints
one JSON object on a line; the last line is
``{"ok": true, "device": {...}}``. Any failed phase ends the run with a
non-zero exit code, and so does a machine without a GPU: nothing here falls
back to the CPU.
"""

from __future__ import annotations

import base64
import dataclasses
import gc
import json
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
# Then the same with the int8 fused CE and bfloat16 logit slices
# (quantization=int8, the AQT matmuls, is not ported: left out).
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
         cuda=torch.version.cuda, name_and_power_limit=card)
    return card


def phase_build():
    from maxtext_indextts2_tpu_torch.ops import _build
    from maxtext_indextts2_tpu_torch.ops.smoke import FLASH_KERNEL_NAMES

    t0 = time.perf_counter()
    _build.load_library(verbose=False)
    # K1 / K3 / K4's, K5 / K7's and every K9-K11 instantiation (`-Xptxas -v`):
    # none may spill
    reports = {kernel: [[r["kernel"].split("(")[0], r.get("registers"), r.get("spill_stores"),
                         r.get("spill_loads")] for r in _build.ptxas_report(kernel)]
               for kernel in ("ragged_decode_kernel", "norm_rows_kernel", FLASH_KERNEL_NAMES)}
    decode, norm = reports["ragged_decode_kernel"], reports["norm_rows_kernel"]
    flash = reports[FLASH_KERNEL_NAMES]
    emit("build", t0, build_seconds=_build.build_seconds, sources=sorted(
        os.path.relpath(s, REPO) for s in _build._sources()),
        decode_attention_registers_spill_stores_loads=decode,
        norm_rows_registers_spill_stores_loads=norm,
        flash_registers_spill_stores_loads=flash)
    check(decode and all(r[2] == 0 and r[3] == 0 for r in decode),
          f"a decode-attention instantiation spills: {decode}")
    check(norm and all(r[2] == 0 and r[3] == 0 for r in norm),
          f"a norm_rows_kernel instantiation spills: {norm}")
    check(len(flash) == 18 and all(r[2] == 0 and r[3] == 0 for r in flash),
          f"a flash-attention (K9-K11) instantiation spills, or one is missing: {flash}")


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
        flash_attention, inplace_update, ragged_decode_attention, s2a_attention,
    )

    _reset_row_kernel_counts()
    ragged_decode_attention.launch_count = inplace_update.launch_count = 0
    inplace_update.span_launch_counts.clear()
    ragged_decode_attention.paged_launch_count = 0
    s2a_attention.launch_count = 0
    for name in flash_attention.launch_counts:
        flash_attention.launch_counts[name] = 0


def _all_counts() -> dict:
    from maxtext_indextts2_tpu_torch.ops import (
        flash_attention, inplace_update, ragged_decode_attention,
    )

    return {"ragged_decode_attention": ragged_decode_attention.launch_count,
            "paged_decode_attention": ragged_decode_attention.paged_launch_count,
            "inplace_row_update": inplace_update.launch_count, **_row_kernel_counts(),
            "s2a_attention": _k12_count(), **flash_attention.launch_counts}


NO_FLASH = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
NO_PAGED = {"paged_decode_attention": 0}


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
            **NO_FLASH, **NO_PAGED}
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
            **NO_PAGED}
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
    return {k: launches[k] for k in TRAIN_LAUNCHES_PER_LAYER}, step_s


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
    return launches


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


def _serve_queued(engine, prompts, budgets):
    """Every request queued before the Orchestrator's loop starts, so that its
    admission groups do not depend on timing: the same engine weights give
    the same streams, token for token. Returns (streams, decode steps)."""
    from maxtext_indextts2_tpu_torch.infer.server import Orchestrator

    orch = Orchestrator(engine, steps_per_dispatch=STEPS_PER_DISPATCH)
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
            "s2a_attention": c.num_layers * forwards, **NO_FLASH, **NO_PAGED}
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
    phase_generate_stream_http(engine)
    phase_lm_ckpt(engine, tmp)
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
    files, prompt, semantic = phase_audio_ckpt(pipe, tmp)
    phase_audio_cli(pipe, tmp, files, prompt, semantic)
    del pipe
    release()
    launches, train_step_s = phase_train()
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
    del engine
    release()
    record("train_flagship_vocab", phase_train_flagship_vocab(card))
    release()
    phase_train_flagship_vocab_parity(card)
    release()
    record("train_flagship", phase_train_flagship(card))
    return paths


if __name__ == "__main__":
    sys.exit(main())
