"""Drives the PyTorch port's paths on one CUDA card and checks them.

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero and prints no
result):
  1. device       the card's name, count, and nvidia-smi name / power limit;
  2. build        nvcc builds videoprism_tpu_torch/csrc for sm_90a, one
                  process per source, all at once; build time, each
                  kernel's registers, shared memory and spills (none
                  allowed in K5's and K7's kernels up to H = 96, nor in
                  the int8 GEMM), and the
                  longest sequence K1's attention core takes per head dim
                  (it streams K and V: no limit below the route's 1024);
     host         a K6 call's host time by part (use_kernel,
                  check_tensors, empty_like, launch, the whole call), 1000
                  calls each without a synchronize; a K11 call's at the
                  text tower's [2, 65, 768] (the checks, the scratch
                  allocations, the launch and the C call alone; one
                  tensor-map encode and one cudaFuncSetAttribute where the
                  library has the probe); the device kernels one K11 call
                  (the paths' three shapes and (2, 2)), one K12b and one
                  K12a call (8192 rows) and one K10 and one K9 call (the
                  encoder's B=2 shapes) launch, by the profiler, with the
                  idle time between them (``--host``: this phase alone,
                  which runs on an older tree too);
     gemm         the wgmma + TMA GEMM of K1, K2, K8a and K8b alone at the
                  base encoder's four products (QKV, output projection,
                  W1, W2) with their epilogues, at B = 8 and B = 1 clips
                  (M = 32768, 4096): its time (CUDA events) and TFLOP/s,
                  its max error against the fp32 product with the same
                  epilogue, and torch.matmul's time on the same operands
                  (a yardstick the port never calls);
     gemm-i8      the s8 wgmma + TMA GEMM of K9-K12b alone at the int8
                  encoder's products (K-major weights): the int32 mode
                  torch.equal to torch._int_mm, each epilogue against its
                  fp32 formula, TOP/s beside torch._int_mm's (B row-major
                  and TN) and the bf16 GEMM's on the same shape;
  3. kernels      every kernel against its plain twin at the shapes of the
                  encoder, CLIP, classifier and int8 paths for two requests
                  (K5 also at giant's H = 88; K9 and K10 also at 2 chunks,
                  K11 at (2, 2)) and of the int8 giant encoder for one (K10
                  and K9 at 2 chunks), K7 at the lvt base train step's for
                  two clips (no ctx at the auxiliary shape, given K5's row
                  statistics; ctx at the spatial, temporal and causal text
                  shapes, fully masked rows, cap 0) and with ctx at vc
                  giant's spatial shape (H = 88), and K1 at the route's
                  longest T = 1024 at H = 64 and 88 (ops/kernels/cases.py
                  tolerances; K8a, K8b and chunked K9/K10 also against
                  their one-chunk twins); the capped weight that K1's core,
                  K5 and K7 share swept against fp64; K7 given K5's
                  statistics bitwise equal to K7 computing its own; each
                  kernel's time per call (CUDA events) and on the device
                  (profiler) beside its twin's, its bound and a library
                  call's (K6: F.layer_norm, by events and by the
                  profiler; int8 kernels: torch._int_mm over their int8
                  products; K7: SDPA's uncapped forward + backward, a
                  yardstick); the int8 blocks torch.equal to their
                  composition from the primitives in separate launches
                  (the quantizer, the int8 GEMM with the fp32 chunk sum
                  through a buffer, K1's core): K11 at the paths' three
                  shapes and (2, 2), K12b and K12a at 8192 rows and at
                  giant's width, K10 and K9 over two chunks, with the
                  device kernels of one call counted by the profiler (K11
                  6, K12a and K12b 1);
  4. gate         layers at T = 1024 run through K1's attention core on
                  the route the reference's chunk rule picks (the base
                  width: K8a over 4 head groups; giant's width, H = 88:
                  K1); past the fused route, at giant's H = 88, the float
                  layer takes K6 + K5 at T = 1032 and 1152, and the int8
                  layer at T = 1032 takes K12a + K5 + K12b;
                  each agrees with the plain path; a giant-width attention
                  block's backward (K8a, K7 at H = 88 with ctx) agrees with
                  the plain path's gradient by the [train] rule; then a
                  layer of 32 heads of 36 (a head dim off a multiple of 8,
                  padded to 40): float through K1 (T = 1024) and K6 + K5
                  (T = 1032), int8 through K10 over 2 head groups, and a
                  K8a block's backward through K7, likewise;
  5. model        get_model('videoprism_public_v1_base') in bf16 with seeded
                  random weights answers three requests (1, 2 and 8 clips of
                  16x288x288x3) through the kernels: [B, 4096, 768], finite,
                  16/16/1/1 launches of K1/K2/K3/K4 per forward; the 2-clip
                  output against impl='reference' in bf16 and in fp32;
  6. golden       the tiny config of tests/data/torch_port_golden.npz through
                  the kernels in bf16 against the JAX package's fp32 output;
  7. clip         get_model('videoprism_lvt_public_v1_base') in bf16 answers
                  video (B=1), video + text (B=2) and text (B=8) requests:
                  [B, 768] embeddings, finite, the launches of K1-K6 each
                  request's path makes; the B=2 embeddings against
                  impl='reference' in bf16 and in fp32;
  8. clip-golden  the tiny CLIP config of tests/data/torch_port_clip_golden.npz
                  through the kernels in bf16 against the JAX package's fp32
                  embeddings;
  9. vc           videoprism_vc_v1_large(400) in bf16 answers 1, 2 and 8
                  clips of 8x288x288x3: [B, 400] logits, finite, 28/28/1/1/1
                  launches of K1/K8b/K3/K4/K6 per forward, peak device
                  memory; the B=2 global embeddings against
                  impl='reference' in bf16 and in fp32;
 10. vc-giant     videoprism_vc_v1_giant(400) likewise at 1 and 2 clips,
                  44/44/1/1/1 launches of K8a/K8b/K3/K4/K6;
 11. vc-golden    the tiny classifier of
                  tests/data/torch_port_classifier_golden.npz through the
                  kernels in bf16 against the JAX package's fp32 logits;
 12. int8         load_video_encoder('videoprism_public_v1_base', <seeded
                  fp32 npz>, quantize='int8', fprop_dtype=bfloat16) answers
                  1, 2 and 8 clips: [B, 4096, 768], finite, the launches and
                  K9/K10 chunk counts that the copied route rule
                  (ops/transformer.py int8_plan) gives (K11 per layer at
                  B <= 2, K10 + K9 at B = 8); the B=2 output against the
                  int8 plain path (impl='reference': least per-token
                  cosine >= 0.999) and no farther than 2x the bf16 plain
                  path from the fp32-activation int8 plain path, and its
                  cosine to the bf16 float kernel path (recorded, not
                  gated);
 13. int8-clip    load_model('videoprism_lvt_public_v1_base', ...,
                  quantize='int8') answers video + text at 1, 2 and 8 with
                  the planned launches (the auxiliary encoder's K12a + K5 +
                  K12b and K9, the text tower's K11); the B=2 embeddings
                  likewise;
 14. int8-giant   the giant encoder (40 + 4 layers, D 1408, 16 x 88, F
                  6144) with quantize_for_serving on phase 10's seeded fp32
                  encoder subtree answers 1 and 2 clips of 8x288x288x3 with
                  the planned launches (K10 over 2 head groups and K9 over 2
                  F-slices in the spatial stack, K10 in one group and K9 over
                  2 in the temporal one), peak device memory; the B=2 output
                  likewise, its cosine to the int8 plain path gated over
                  the whole output (per token it sits at the bf16 floor
                  that the fp32 comparison shows);
 15. int8-golden  the tiny int8 configs of tests/data/torch_port_int8_golden.npz
                  through the kernels in bf16 against the JAX package's fp32
                  int8-kernel outputs (3x the bf16 twin's CPU error);
 16. train        lvt base training with seeded fp32 master weights: the B=2
                  loss and gradient of the kernel path (bf16 activations)
                  against the plain path in fp32 (impl='reference', autograd
                  through the twins; the bf16 plain path printed beside
                  it), the launches of one step (the CLIP request's forward
                  and K7 30 times, 28 with the context and 2 given K5's
                  row statistics), then 3 steps of
                  make_train_step (AdamW, 1 warmup step) at B=8: params
                  unchanged after step 1 (lr(0) = 0), moved after step 3,
                  ms per step and peak memory;
 17. train-golden the tiny CLIP config's loss and gradient through the
                  kernels in bf16 against the JAX package's fp32 values of
                  tests/data/torch_port_train_golden.npz (3x the bf16 CPU
                  path's error per leaf group);
 18. times        the encoder forward, the video + text CLIP request and the
                  large classifier's forward at 1 and 8, and the giant
                  classifier's at 1, kernel path and impl='reference', with
                  CUDA events after warm-up; the int8 encoder and int8 CLIP
                  request at 1 and 8 and the int8 giant encoder at 1 (kernel
                  path).
The seeded npz files of phases 12 and 13 are written to a temporary
directory under build/ and removed.  Counts of kernel launches are set to 0
before each path's phase (5, 7, 9, 10, 12, 13, 14 and 16) and read after
it.
The line before the last is the per-kernel JSON record (K7 twice: computing
its own row statistics, its record since it was ported, and with
"variant": "stats from K5", the train step's route); the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import tempfile
import re
import subprocess
import sys
import time
import types

import numpy as np
import torch

from videoprism_tpu_torch import quantization
from videoprism_tpu_torch.io.checkpoints import (
    params_from_numpy,
    prepare_for_kernels,
    save_checkpoint,
)
from videoprism_tpu_torch.models import classifier as vc_lib
from videoprism_tpu_torch.models import clip as clip_lib
from videoprism_tpu_torch.models import factorized_encoder as fe
from videoprism_tpu_torch.models import init as init_lib
from videoprism_tpu_torch.models import registry
from videoprism_tpu_torch.ops import masks as mask_lib
from videoprism_tpu_torch.ops import transformer as transformer_lib
from videoprism_tpu_torch.ops.kernels import _lib
from videoprism_tpu_torch.ops.kernels import cases as cases_lib
from videoprism_tpu_torch.ops.kernels import flash_attention as flash_lib
from videoprism_tpu_torch.ops.kernels import int8_blocks as i8
from videoprism_tpu_torch.ops.kernels import transformer_block as tb
from videoprism_tpu_torch.train import objectives
from videoprism_tpu_torch.train import train_step as train_lib

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, 'tests', 'data', 'torch_port_golden.npz')
CLIP_GOLDEN = os.path.join(ROOT, 'tests', 'data',
                           'torch_port_clip_golden.npz')
VC_GOLDEN = os.path.join(ROOT, 'tests', 'data',
                         'torch_port_classifier_golden.npz')
INT8_GOLDEN = os.path.join(ROOT, 'tests', 'data',
                           'torch_port_int8_golden.npz')
TRAIN_GOLDEN = os.path.join(ROOT, 'tests', 'data',
                            'torch_port_train_golden.npz')
# Per-token (per-embedding) cosine to the reference that every model-level
# check demands.
MIN_COSINE = 0.999
# Golden, bf16 kernels vs the JAX fp32 output: the outputs are post-LN with
# |max| ~4.3, where one bf16 ulp is 0.03; four layers of bf16 rounding put
# the bf16 twin at 0.033 max error on the CPU.  0.1 leaves 3x margin.
GOLDEN_ATOL = 0.1
# CLIP golden: l2-normalised embeddings with |max| 0.42, where one bf16
# ulp is 0.002; the bf16 twin is at 0.0029 max error on the CPU.  0.01
# leaves 3x margin.
CLIP_GOLDEN_ATOL = 0.01
# Classifier golden: logits with |max| 2.6 and global embeddings (post-LN)
# with |max| 3.8, where one bf16 ulp is 0.016; the bf16 twin is at 0.017 and
# 0.026 max error on the CPU.  0.08 leaves 3x margin over the larger.
VC_GOLDEN_ATOL = 0.08
# int8 golden: 3x the bf16 twin's max error on the CPU, per output; the
# train golden likewise per leaf group.
INT8_GOLDEN_RATIO = 3.0
# [train] at B=2, the kernel path (bf16 activations) against the plain path
# with fp32 activations: the loss, and the cosine of the whole gradient and
# each per-leaf cosine over leaves of at least TRAIN_MIN_LEAF elements, at
# these floors or, where the bf16 plain path falls below them (it does:
# with seeded weights the InfoNCE loss sits at ln 2 and its gradient is
# small beside bf16 rounding), within FP32_ERR_RATIO of that path's
# distance.
TRAIN_LOSS_ATOL = 1e-2
TRAIN_MIN_COSINE = 0.999
TRAIN_MIN_LEAF_COSINE = 0.99
TRAIN_MIN_LEAF = 1024
FRAMES, SIZE = 16, 288
VC_FRAMES = 8
TEXT_LEN = 64
CLIP_MODEL = 'videoprism_lvt_public_v1_base'

KERNELS = {  # wrapper -> (hand-written source, TPU kernel it replaces)
    'fused_attention_block': (
        'videoprism_tpu_torch/csrc/transformer_block.cu',
        'videoprism_tpu/ops/pallas/transformer_block.py:222'),
    'fused_ffn_block': (
        'videoprism_tpu_torch/csrc/transformer_block.cu',
        'videoprism_tpu/ops/pallas/transformer_block.py:859'),
    'spatial_to_temporal': (
        'videoprism_tpu_torch/csrc/ln_rows.cu',
        'videoprism_tpu/ops/pallas/boundary.py:81'),
    'temporal_to_output': (
        'videoprism_tpu_torch/csrc/ln_rows.cu',
        'videoprism_tpu/ops/pallas/boundary.py:121'),
    'fused_attention': (
        'videoprism_tpu_torch/csrc/flash_attention.cu',
        'videoprism_tpu/ops/pallas/flash_attention.py:109'),
    'fused_layer_norm_2d': (
        'videoprism_tpu_torch/csrc/ln_rows.cu',
        'videoprism_tpu/ops/pallas/layer_norm.py:46'),
    'fused_attention_block_chunked': (
        'videoprism_tpu_torch/csrc/transformer_block.cu',
        'videoprism_tpu/ops/pallas/transformer_block.py:364'),
    'fused_ffn_block_chunked': (
        'videoprism_tpu_torch/csrc/transformer_block.cu',
        'videoprism_tpu/ops/pallas/transformer_block.py:500'),
    'int8_ffn_block_chunked': (
        'videoprism_tpu_torch/csrc/int8_blocks.cu',
        'videoprism_tpu/ops/pallas/int8_blocks.py:119'),
    'int8_attention_block_chunked': (
        'videoprism_tpu_torch/csrc/int8_blocks.cu',
        'videoprism_tpu/ops/pallas/int8_blocks.py:288'),
    'int8_layer_block': (
        'videoprism_tpu_torch/csrc/int8_blocks.cu',
        'videoprism_tpu/ops/pallas/int8_blocks.py:524'),
    'int8_qkv_projection': (
        'videoprism_tpu_torch/csrc/int8_blocks.cu',
        'videoprism_tpu/ops/pallas/int8_blocks.py:681'),
    'int8_out_projection': (
        'videoprism_tpu_torch/csrc/int8_blocks.cu',
        'videoprism_tpu/ops/pallas/int8_blocks.py:726'),
    'fused_attention_bwd': (
        'videoprism_tpu_torch/csrc/flash_attention_bwd.cu',
        'videoprism_tpu/ops/pallas/flash_attention.py:291'),
}
# The second record of K7 in the kernels line: K7 given K5's row
# statistics, the train step's route for K5's backward.
K7_STATS = 'stats from K5'
# K5's and K7's kernels, none of which may spill registers at H <= 96.
FLASH_KERNELS = ('flash_attention_kernel', 'flash_bwd_query_kernel',
                 'flash_bwd_key_kernel')
# The capped weight of every attention kernel (csrc/mma_sync.cuh) against
# fp64 over l in [-4 cap, 4 cap]: relative error of exp(cap tanh(l / cap))
# and absolute error of 1 - tanh^2.
WEIGHT_RTOL = 2e-5
TANH_GRAD_ATOL = 2e-5
DEVICE_KERNELS = ('ln_rows_kernel', 'ln_rows_stream_kernel',
                  'gemm_bf16_kernel', 'capped_attention_kernel',
                  'flash_attention_kernel', 'quant_rows_kernel',
                  'quant_rows_f32_kernel', 'quant_rows_stream_kernel',
                  'gemm_i8_kernel', 'flash_bwd_query_kernel',
                  'flash_bwd_key_kernel')
_ENCODER = {'fused_attention_block': 16, 'fused_ffn_block': 16,
            'spatial_to_temporal': 1, 'temporal_to_output': 1}
PER_FORWARD = {k: _ENCODER.get(k, 0) for k in KERNELS}
# Launches per CLIP request of lvt base.  Video: the encoder, then 2
# auxiliary layers over 4096 tokens (K6 LN + K5 attention + K2 each) and
# the pooler's output LN (K6).  Text: 12 layers over 65 tokens (K1 + K2)
# and unimodal_ln (K6).
_VIDEO = dict(_ENCODER, fused_ffn_block=18, fused_attention=2,
              fused_layer_norm_2d=3)
_TEXT = {'fused_attention_block': 12, 'fused_ffn_block': 12,
         'fused_layer_norm_2d': 1}
PER_CLIP_REQUEST = {
    'video': {k: _VIDEO.get(k, 0) for k in KERNELS},
    'text': {k: _TEXT.get(k, 0) for k in KERNELS},
    'video+text': {k: _VIDEO.get(k, 0) + _TEXT.get(k, 0) for k in KERNELS},
}
# Launches per train step of lvt base (video + text, forward and
# backward): the forward's are the CLIP request's, and every attention
# backward is one K7 call, with the context under K1 (12 spatial, 4
# temporal and 12 text layers) and without it under K5 (the 2 auxiliary
# layers).  The backward launches no forward kernel.
PER_TRAIN_STEP = dict(PER_CLIP_REQUEST['video+text'], fused_attention_bwd=30)
TRAIN_K7_WITH_CTX = 28
# The K7 launches of a step given K5's row statistics: the auxiliary
# encoder's two, without ctx.
TRAIN_K7_WITH_STATS = 2
# Launches per classifier forward: 24 + 4 layers of K1 and K8b (2 F-slices)
# at large, 40 + 4 of K8a (2 head groups) and K8b (4 F-slices) at giant;
# the boundaries; the pooler's output LN (K6).
_VC_TAIL = {'spatial_to_temporal': 1, 'temporal_to_output': 1,
            'fused_layer_norm_2d': 1}
PER_VC_FORWARD = {
    'videoprism_vc_v1_large': {k: dict(
        _VC_TAIL, fused_attention_block=28,
        fused_ffn_block_chunked=28).get(k, 0) for k in KERNELS},
    'videoprism_vc_v1_giant': {k: dict(
        _VC_TAIL, fused_attention_block_chunked=44,
        fused_ffn_block_chunked=44).get(k, 0) for k in KERNELS},
}


class SmokeFailure(Exception):
  pass


def check(cond: bool, msg: str) -> None:
  if not cond:
    raise SmokeFailure(msg)


def near(cos: float, cos16: float, floor: float) -> bool:
  """The [train] rule for a gradient cosine against the fp32 plain path: it
  passes at its floor or, where the bf16 plain path itself falls below it,
  when the kernels are no farther from the fp32 path (1 - cosine) than
  FP32_ERR_RATIO times the bf16 plain path (``cos16``)."""
  return cos >= floor or 1.0 - cos <= cases_lib.FP32_ERR_RATIO * (1.0 - cos16)


def cuda_ms(fn, *, warmup: int, iters: int) -> float:
  """Mean device time of ``fn()`` in ms, by CUDA events around ``iters``."""
  for _ in range(warmup):
    fn()
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(iters):
    fn()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / iters


def kernel_records(fn) -> list:
  """The device kernels ``fn()`` launches, by torch.profiler, in launch
  order.  The session opens with a warm-up step (eight fills of a marker
  tensor and one ``fn()``) whose records the profiler drops: a session's
  first kernel records can go missing, the more so after many sessions in
  one process, and the warm-up step takes that loss.  The steps' own
  device-side ranges (``ProfilerStep#``) are not kernels and are left
  out."""
  marker = torch.empty(1, device='cuda')
  activities = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
  schedule = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
  with torch.profiler.profile(activities=activities,
                              schedule=schedule) as prof:
    for _ in range(8):
      marker.fill_(0.0)
    fn()
    torch.cuda.synchronize()
    prof.step()
    fn()
    torch.cuda.synchronize()
    prof.step()
  return sorted((e for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and not getattr(e, 'is_user_annotation', False)
                 and not e.name.startswith('ProfilerStep')),
                key=lambda e: e.time_range.start)


def device_ms(fn, *, iters: int) -> float:
  """Device time per call of ``fn()`` in ms: the summed durations of the
  kernels it launches over ``iters`` calls (:func:`kernel_records`).
  Unlike :func:`cuda_ms` it leaves out the host's time between launches,
  which bounds short kernels called from Python."""
  def calls():
    for _ in range(iters):
      fn()
  total_us = sum(e.time_range.elapsed_us() for e in kernel_records(calls))
  check(total_us > 0, 'the profiler saw no device time')
  return total_us / 1000.0 / iters


def cosine_per_token(a: torch.Tensor, b: torch.Tensor) -> float:
  return torch.nn.functional.cosine_similarity(
      a.float(), b.float(), dim=-1).min().item()


def launches_since(before: dict) -> dict:
  return {k: _lib.LAUNCHES[k] - before.get(k, 0) for k in KERNELS}


def phase_device() -> tuple[str, str]:
  check(torch.cuda.is_available(), 'torch.cuda.is_available() is False')
  name = torch.cuda.get_device_name(0)
  smi = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit',
       '--format=csv,noheader'], capture_output=True, text=True, check=True,
      timeout=60).stdout.strip().splitlines()[0]
  print(f'[device] {name} x{torch.cuda.device_count()}; torch '
        f'{torch.__version__} cuda {torch.version.cuda}; nvidia-smi: {smi}')
  # fp32 products and convolutions in full fp32 (both default to TF32 in
  # places): the fp32 reference below must be fp32.
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  return name, smi


def phase_build() -> None:
  start = time.perf_counter()
  build = _lib.build()
  _lib.library()
  print(f'[build] {build.path.name}: nvcc {build.seconds:.1f} s '
        f'(load {time.perf_counter() - start:.1f} s)')
  kernel, spills, spilled = None, '', []
  for line in build.log.splitlines():
    if 'Performance Loss' in line:   # ptxas: e.g. wgmma serialized
      print(f'[build] {line.strip()}')
    if 'Compiling entry function' in line:
      kernel = next((k for k in DEVICE_KERNELS if k in line), None)
      template = re.search(r'I((?:Li\d+E)+)(?:Lb([01])E)?', line)
      ints = re.findall(r'Li(\d+)E', template.group(1)) if template else []
      ht = int(ints[0]) if kernel and ints else 0
      if kernel and ints:
        kernel += f'<{", ".join(ints)}' + (
            '' if template.group(2) is None
            else ', capped' if template.group(2) == '1' else ', no cap') + '>'
      elif kernel == 'quant_rows_stream_kernel':
        kernel += ('<bf16>' if '__nv_bfloat16' in line else '<float>')
      spills = ''
    m = re.search(r'(\d+) bytes stack frame, (\d+) bytes spill stores, '
                  r'(\d+) bytes spill loads', line)
    if m and kernel:
      spills = (f'stack frame {m.group(1)} B, spills {m.group(2)}/'
                f'{m.group(3)} B')
      if ((kernel.startswith(FLASH_KERNELS) and ht <= 6)
          or kernel.startswith('gemm_i8_kernel')) and (
              int(m.group(2)) or int(m.group(3))):
        spilled.append(kernel)
    m = re.search(r'Used (\d+) registers.*?(?:(\d+) bytes smem)?$', line)
    if m and kernel:
      print(f'[build] {kernel}: {m.group(1)} registers, static smem '
            f'{m.group(2) or 0} B, {spills}')
      kernel = None
  check(not spilled, 'K5 / K7 (at H <= 96) or the int8 GEMM (beside its '
        f'in-flight products) spill registers: {spilled}')
  for h in (64, 88):
    cap = _lib.max_attention_t(h)
    check(cap >= transformer_lib.MAX_FUSED_ATTENTION_T,
          f'K1 attention core takes T <= {cap} at H={h}')
    print(f'[build] K1 attention core at H={h}: streams K and V, takes every '
          f'T up to the route\'s {transformer_lib.MAX_FUSED_ATTENTION_T} '
          f'(reports {cap})')


# The base encoder's four products per layer: (name, N, K, epilogue).
GEMM_PRODUCTS = (('QKV', 2304, 768, 'qkv'), ('out', 768, 768, 'residual'),
                 ('W1', 3072, 768, 'act_keep'), ('W2', 768, 3072, 'residual'))


def phase_gemm(device) -> None:
  """The product stage of K1/K2/K8a/K8b alone at the base encoder's
  products, with their epilogues, against the fp32 product and beside
  torch.matmul (a yardstick, not called by the port)."""
  gen = torch.Generator(device=device).manual_seed(0)
  for b in (8, 1):
    m = b * 4096
    for name, n, k, epilogue in GEMM_PRODUCTS:
      a = torch.randn((m, k), generator=gen, device=device).bfloat16()
      w = (torch.randn((k, n), generator=gen, device=device)
           / k ** 0.5).bfloat16()
      bias = (0.1 * torch.randn((n,), generator=gen, device=device)).bfloat16()
      pads = (torch.rand((m, 1), generator=gen, device=device)
              < 0.1).bfloat16()
      res = torch.randn((m, n), generator=gen, device=device).bfloat16()
      kw = {'qkv': dict(bias=bias, col_scale=0.125, scaled_cols=n // 3),
            'residual': dict(bias=bias, pads=pads, residual=res),
            'act_keep': dict(bias=bias, pads=pads, activation='gelu')}[
                epilogue]
      got = tb.gemm_bf16(a, w, epilogue=epilogue, **kw).float()
      want = a.float() @ w.float() + bias.float()
      keep = 1.0 - pads.float()
      if epilogue == 'qkv':
        want[:, :n // 3] *= 0.125
      elif epilogue == 'residual':
        want = want * keep + res.float()
      else:
        want = torch.nn.functional.gelu(want) * keep
      err = (got - want).abs().max().item()
      ok = bool(torch.allclose(got, want, atol=cases_lib.ATOL,
                               rtol=cases_lib.RTOL))
      ms = cuda_ms(lambda: tb.gemm_bf16(a, w, epilogue=epilogue, **kw),
                   warmup=3, iters=20)
      mm_ms = cuda_ms(lambda: torch.matmul(a, w), warmup=3, iters=20)
      flops = 2.0 * m * n * k
      print(f'[gemm] B={b} {name} [{m}, {k}] @ [{k}, {n}] ({epilogue}): '
            f'{ms:.4f} ms, {flops / ms / 1e9:.1f} TFLOP/s; max err vs fp32 '
            f'{err:.3g} {"ok" if ok else "FAIL"}; torch.matmul {mm_ms:.4f} '
            f'ms, {flops / mm_ms / 1e9:.1f} TFLOP/s')
      check(ok, f'GEMM {name} at B={b} disagrees with the fp32 product')
      del a, w, res, got, want


def phase_gemm_i8(device) -> None:
  """The int8 GEMM of K9-K12b alone (s8 wgmma on TMA tiles, K-major
  weights) at the int8 base encoder's four products (q|k|v as one), B = 8
  and B = 1: the int32 mode torch.equal to torch._int_mm, each epilogue
  against its fp32 formula; TOP/s beside torch._int_mm's (B row-major and
  the transposed view of a K-major B, the TN layout) and beside the bf16
  GEMM's on the same [M, K, N] (yardsticks, not called by the port)."""
  gen = torch.Generator(device=device).manual_seed(1)
  i8r = lambda *s: torch.randint(-127, 128, s, generator=gen,
                                 dtype=torch.int8, device=device)
  for b in (8, 1):
    m = b * 4096
    for name, n, k, epilogue in GEMM_PRODUCTS:
      a, w = i8r(m, k), i8r(n, k)   # w K-major [N, K]
      a_scale = torch.rand((m,), generator=gen, device=device) * 1e-2 + 1e-3
      b_scale = torch.rand((n,), generator=gen, device=device) * 1e-2 + 1e-3
      bias = (0.1 * torch.randn((n,), generator=gen, device=device)).bfloat16()
      pads = (torch.rand((m, 1), generator=gen, device=device)
              < 0.1).bfloat16()
      res = torch.randn((m, n), generator=gen, device=device).bfloat16()
      kw = dict(a_scale=a_scale, b_scale=b_scale, bias=bias, **{
          'qkv': dict(col_scale=0.125, scaled_cols=n // 3),
          'residual': dict(pads=pads, residual=res),
          'act_keep': dict(pads=pads, activation='gelu')}[epilogue])
      exact = torch._int_mm(a, w.t())
      raw = i8.gemm_i8(a, w)
      same = torch.equal(raw, exact)
      got = i8.gemm_i8(a, w, epilogue=epilogue, **kw).float()
      want = exact.float() * a_scale[:, None] * b_scale + bias.float()
      keep = 1.0 - pads.float()
      if epilogue == 'qkv':
        want[:, :n // 3] *= 0.125
      elif epilogue == 'residual':
        want = want * keep + res.float()
      else:
        want = torch.nn.functional.gelu(want) * keep
      err = (got - want).abs().max().item()
      ok = bool(torch.allclose(got, want, atol=cases_lib.ATOL,
                               rtol=cases_lib.RTOL))
      ms = cuda_ms(lambda: i8.gemm_i8(a, w, epilogue=epilogue, **kw),
                   warmup=3, iters=20)
      raw_ms = cuda_ms(lambda: i8.gemm_i8(a, w), warmup=3, iters=20)
      w_kn = w.t().contiguous()
      mm_ms = cuda_ms(lambda: torch._int_mm(a, w_kn), warmup=3, iters=20)
      tn_ms = cuda_ms(lambda: torch._int_mm(a, w.t()), warmup=3, iters=20)
      a16, w16 = a.bfloat16(), w_kn.bfloat16()
      bf16_kw = {'qkv': dict(bias=bias, col_scale=0.125, scaled_cols=n // 3),
                 'residual': dict(bias=bias, pads=pads, residual=res),
                 'act_keep': dict(bias=bias, pads=pads, activation='gelu')}[
                     epilogue]
      bf16_ms = cuda_ms(lambda: tb.gemm_bf16(a16, w16, epilogue=epilogue,
                                             **bf16_kw), warmup=3, iters=20)
      ops = 2.0 * m * n * k
      rate = lambda t: f'{ops / t / 1e9:.1f}'
      print(f'[gemm-i8] B={b} {name} [{m}, {k}] @ [{n}, {k}]^T ({epilogue}):'
            f' {ms:.4f} ms, {rate(ms)} TOP/s (int32 mode {raw_ms:.4f} ms, '
            f'{rate(raw_ms)}); int32 torch.equal to torch._int_mm '
            f'{"yes" if same else "NO"}; {epilogue} max err vs fp32 '
            f'{err:.3g} {"ok" if ok else "FAIL"}; torch._int_mm row-major B '
            f'{mm_ms:.4f} ms ({rate(mm_ms)}), TN {tn_ms:.4f} ms '
            f'({rate(tn_ms)}); bf16 GEMM same epilogue {bf16_ms:.4f} ms '
            f'({rate(bf16_ms)} TFLOP/s), int8 / bf16 rate '
            f'{bf16_ms / ms:.2f}x')
      check(same, f'int8 GEMM {name} at B={b}: int32 sums differ from '
            'torch._int_mm')
      check(ok, f'int8 GEMM {name} at B={b} ({epilogue}) disagrees with the '
            'fp32 formula')
      del a, w, w_kn, a16, w16, res, got, want, exact, raw


def host_breakdown(device) -> None:
  """A K6 call's host time by part: 1000 calls of each part, no
  synchronize (the launches queue), time.perf_counter_ns per call.  The
  parts are what the wrapper runs: use_kernel, check_tensors, empty_like,
  launch, then the whole fused_layer_norm_2d.  Runs on any tree whose
  _lib has these entry points (``--host`` runs this phase alone)."""
  case = cases_lib.layer_norm_case(130, 768, direct_scale=False,
                                   device=device)
  x, scale, bias = case.args
  out = torch.empty_like(x)
  rows, d = x.shape
  dev = x.device
  parts = {
      'use_kernel': lambda: _lib.use_kernel('auto', x),
      'check_tensors': lambda: _lib.check_tensors(dev, x=x, scale=scale,
                                                  bias=bias),
      'empty_like': lambda: torch.empty_like(x),
      'launch': lambda: _lib.launch('vp_layer_norm', dev, x, scale, bias, out,
                                    rows, d, 0, 1e-6),
      'whole call': lambda: case.fn(*case.args, **case.kwargs),
  }
  if hasattr(_lib, '_entry'):   # the launch's own parts
    c_fn = _lib._entry('vp_layer_norm')[0]
    current, raw_stream = _lib._device_queries()
    ptrs = [t.data_ptr() for t in (x, scale, bias, out)]
    parts.update({
        'launch: current device': current,
        'launch: raw stream': lambda: raw_stream(0),
        'launch: the C call alone': lambda: c_fn(*ptrs, rows, d, 0, 1e-6,
                                                 raw_stream(0)),
    })
  us = {name: _host_us(fn, calls=1000) for name, fn in parts.items()}
  print('[host] K6 [130, 768] host time per call (1000 calls, no '
        'synchronize): ' + ', '.join(f'{k} {v:.2f} us' for k, v in us.items()))
  _int8_host_breakdown(device)


def _host_us(fn, *, calls: int, batch: int = 1000) -> float:
  """Host µs per call of ``fn()``: ``calls`` calls in batches of ``batch``
  after 20 warm-ups, no synchronize inside a batch (a synchronize between
  batches, not timed, keeps the launch queue from filling)."""
  for _ in range(20):
    fn()
  total = 0
  for _ in range(0, calls, batch):
    torch.cuda.synchronize()
    start = time.perf_counter_ns()
    for _ in range(batch):
      fn()
    total += time.perf_counter_ns() - start
  torch.cuda.synchronize()
  return total / calls / 1000.0


class _Timed:
  """Replaces ``owner.attr`` by a shim that adds the time spent in it to
  ``self.ns`` (and counts the calls) while the context is open."""

  def __init__(self, owner, attr: str):
    self.owner, self.attr = owner, attr
    self.ns = self.calls = 0

  def __enter__(self):
    real = self.real = getattr(self.owner, self.attr)

    def shim(*args, **kwargs):
      start = time.perf_counter_ns()
      try:
        return real(*args, **kwargs)
      finally:
        self.ns += time.perf_counter_ns() - start
        self.calls += 1
    setattr(self.owner, self.attr, shim)
    return self

  def __exit__(self, *exc):
    setattr(self.owner, self.attr, self.real)


def _int8_host_breakdown(device) -> None:
  """K11's host time per call at the text tower's [2, 65, 768] (1, 1) by
  part, 400 calls in batches of 10 (the launch queue never fills, so the
  device's time does not show): the whole call; the time inside
  ``_lib.launch`` and inside the scratch allocations (``torch.empty`` /
  ``empty_like``, shims that time them, their own cost calibrated on a
  no-op and taken out); the checks and the rest (the whole call less
  those); the C call alone (the entry point called with the arguments one
  call gave it).  Inside the C call, where the library has the probe:
  one tensor-map encode and one cudaFuncSetAttribute, each timed over
  1000 calls.  Runs on any tree with ``cases.int8_layer_case``."""
  case = cases_lib.int8_layer_case(2, 65, 768, 12, 64, 3072, cap=50.0,
                                   padded=True, causal=True, chunks=(1, 1),
                                   device=device)
  call = lambda: case.fn(*case.args, **case.kwargs)
  calls = dict(calls=400, batch=10)
  whole = _host_us(call, **calls)
  noop = _Timed(types.SimpleNamespace(f=lambda: None), 'f')
  with noop:
    shim_us = _host_us(noop.owner.f, **calls) - _host_us(lambda: None,
                                                           **calls)
  timed = [_Timed(_lib, 'launch'), _Timed(torch, 'empty'),
           _Timed(torch, 'empty_like')]
  for t in timed:
    t.__enter__()
  try:
    _host_us(call, **calls)
  finally:
    for t in timed:
      t.__exit__()
  per_call = lambda t: (t.ns / 1000.0 - t.calls * shim_us) / (
      400 + 20)
  launch_us = per_call(timed[0])
  alloc_us = per_call(timed[1]) + per_call(timed[2])
  allocs = (timed[1].calls + timed[2].calls) / (400 + 20)
  recorded = {}
  real = _lib.launch
  _lib.launch = lambda name, dev, *args: recorded.update(name=name,
                                                         args=args)
  try:
    call()
  finally:
    _lib.launch = real
  fn = _lib._entry(recorded['name'])[0]
  raw = [a.data_ptr() if isinstance(a, torch.Tensor) else a
         for a in recorded['args']]
  stream = torch.cuda.current_stream(device).cuda_stream
  c_us = _host_us(lambda: fn(*raw, stream), **calls)
  line = (f'[host] K11 [2, 65, 768] (1, 1) host time per call (400 calls '
          f'in batches of 10): whole call {whole:.2f} us, checks and the '
          f'rest {whole - launch_us - alloc_us:.2f} us, scratch allocations '
          f'{alloc_us:.2f} us ({allocs:g} tensors), launch {launch_us:.2f} us '
          f'(the C call alone {c_us:.2f} us); shim {shim_us:.3f} us a call, '
          'taken out')
  if 'vp_host_probe' in getattr(_lib, '_SIGNATURES', {}):
    probe = _lib._entry('vp_host_probe')[0]
    buf = torch.empty(1 << 20, dtype=torch.int8, device=device)
    for what, label in ((0, 'tensor-map encode'),
                        (1, 'cudaFuncSetAttribute')):
      start = time.perf_counter_ns()
      check(probe(buf.data_ptr(), what, 1000, stream) == 0,
            f'host probe {label} failed')
      line += (f'; one {label} '
               f'{(time.perf_counter_ns() - start) / 1e6:.3f} us')
  print(line)


def device_parts(case: cases_lib.Case, *, calls: int = 8) -> tuple[list, float,
                                                                 float]:
  """The device kernels one call of ``case`` launches, by torch.profiler
  over ``calls`` calls, one profiler session each (:func:`kernel_records`):
  ([(kernel name, mean device µs)] in launch order, mean µs from the first
  kernel's start to the last one's end, mean idle µs inside that span).
  The count is the largest any session saw (a session can lose a kernel
  record, never gain one: nothing else launches inside it), and a session
  that lost one is left out of the means."""
  run = lambda: case.fn(*case.args, **case.kwargs, impl='kernel')
  sessions = [kernel_records(run) for _ in range(calls)]
  n = max(len(k) for k in sessions)
  sessions = [k for k in sessions if len(k) == n]
  check(n > 0, f'{case.label}: the profiler saw no device kernel')
  parts = []
  for i in range(n):
    name = re.sub(r'^void |vp::|\(anonymous namespace\)::|\(.*$', '',
                  sessions[0][i].name)
    parts.append((name, sum(k[i].time_range.elapsed_us() for k in sessions)
                  / len(sessions)))
  span = sum(k[-1].time_range.end - k[0].time_range.start
             for k in sessions) / len(sessions)
  return parts, span, span - sum(us for _, us in parts)


# The int8 blocks whose device kernels per call [host] lists and [kernels]
# counts: K11 at the paths' three shapes and (2, 2), K12b and K12a at the
# auxiliary encoder's rows, and the chains K10 and K9 at the encoder's B=2
# shapes (their first product quantizes with the standalone quantizer,
# K11's and K12a's in its prologue: the same product both ways).
def int8_part_cases(device) -> list[cases_lib.Case]:
  return [
      cases_lib.int8_layer_case(32, 256, 768, 12, 64, 3072, cap=50.0,
                                padded=False, chunks=(2, 1), device=device),
      cases_lib.int8_layer_case(512, 16, 768, 12, 64, 3072, cap=50.0,
                                padded=False, chunks=(1, 1), device=device),
      cases_lib.int8_layer_case(2, 65, 768, 12, 64, 3072, cap=50.0,
                                padded=True, causal=True, chunks=(1, 1),
                                device=device),
      cases_lib.int8_layer_case(512, 16, 768, 12, 64, 3072, cap=50.0,
                                padded=True, chunks=(2, 2), device=device),
      *cases_lib.int8_projection_cases(8192, 768, 768, device=device)[::-1],
      cases_lib.int8_attention_case(32, 256, 768, 12, 64, cap=50.0,
                                    padded=False, chunks=1, device=device),
      cases_lib.int8_ffn_case(8192, 768, 3072, activation='gelu',
                              padded=True, chunks=1, device=device),
  ]


# Device kernels per call of the fused int8 blocks (the profiler's count).
FUSED_KERNELS = {'int8_layer_block': 6, 'int8_out_projection': 1,
                 'int8_qkv_projection': 1}


def check_int8_fusion(device) -> None:
  """[kernels]: the int8 blocks whose products quantize their own rows
  and sum their chunks on chip, bitwise equal to their composition from
  the primitives in separate launches (``cases.int8_composed``): K11 at the
  paths' three shapes and (2, 2), K12b and K12a at the auxiliary encoder's
  8192 rows and at giant's width (D = NH = 1408, the [gate] layer's 1032
  rows), K10 and K9 over two chunks; and the device kernels one call
  launches, by the profiler: 6 for K11, 1 for K12a and K12b."""
  for case in (int8_part_cases(device)
               + cases_lib.int8_projection_cases(1032, 1408, 1408,
                                                 device=device)
               + [cases_lib.int8_attention_case(32, 256, 768, 12, 64,
                                                cap=50.0, padded=True,
                                                chunks=2, device=device),
                  cases_lib.int8_ffn_case(8192, 768, 3072, activation='gelu',
                                          padded=True, chunks=2,
                                          device=device)]):
    fused = cases_lib._joined(case.fn(*case.args, **case.kwargs))
    composed = cases_lib._joined(cases_lib.int8_composed(case))
    same = torch.equal(fused, composed)
    kernels = len(device_parts(case)[0])
    want = FUSED_KERNELS.get(case.kernel)
    print(f'[kernels] {case.kernel} {case.label}: '
          f'{"bitwise equal" if same else "DIFFERS"} to its composition from '
          f'the primitives (max |diff| {(fused - composed).abs().max():.3g}); '
          f'{kernels} device kernels per call'
          + ('' if want is None else f' (want {want})'))
    check(same, f'{case.kernel} {case.label} differs from its composition')
    check(want is None or kernels == want,
          f'{case.kernel} {case.label}: {kernels} device kernels per call, '
          f'want {want}')


def print_device_parts(device) -> None:
  """[host]: each int8 part case's device kernels per call."""
  for case in int8_part_cases(device):
    parts, span, idle = device_parts(case)
    print(f'[host] {case.kernel} {case.label}: {len(parts)} device kernels '
          f'per call, {span:.2f} us first start to last end, idle '
          f'{idle:.2f} us inside it; ' + ', '.join(
              f'{name} {us:.2f}' for name, us in parts))


def _library_layer_norm(case):
  """torch.nn.functional.layer_norm on the K6 case's inputs, its (scale +
  1) folded into the weight beforehand (not timed)."""
  x, scale, bias = case.args
  weight = scale if case.kwargs['direct_scale'] else scale + 1.0
  return lambda: torch.nn.functional.layer_norm(x, (x.shape[-1],), weight,
                                                bias, 1e-6)


def _check_weight_helper(device) -> None:
  """The capped weight every attention kernel computes per logit, over
  2^20 logits in [-4 cap, 4 cap] at the models' cap, against fp64."""
  cap = 50.0
  logits = torch.linspace(-4 * cap, 4 * cap, 1 << 20, device=device)
  w, dt = flash_lib._capped_weight(logits, cap)
  tanh = torch.tanh(logits.double() / cap)
  rel = ((w.double() - torch.exp(cap * tanh)).abs()
         / torch.exp(cap * tanh)).max().item()
  err = (dt.double() - (1.0 - tanh * tanh)).abs().max().item()
  print(f'[kernels] capped weight (csrc/mma_sync.cuh) at cap {cap:g} over '
        f'l in [{-4 * cap:g}, {4 * cap:g}] vs fp64: max relative error of '
        f'exp(cap tanh(l/cap)) {rel:.3g} (limit {WEIGHT_RTOL:g}), max '
        f'absolute error of 1 - tanh^2 {err:.3g} (limit {TANH_GRAD_ATOL:g})')
  check(rel <= WEIGHT_RTOL and err <= TANH_GRAD_ATOL,
        f'capped weight off: {rel} relative, 1 - tanh^2 {err} absolute')


def _check_bwd_statistics(device) -> None:
  """K7 given K5's row statistics gives the bits it gives computing them
  itself: at the auxiliary shape, at a keys-masked one without a cap, and
  at giant's head dim."""
  for case in (
      cases_lib.flash_bwd_case(2, 12, 4096, 4096, 64, cap=50.0, mask='none',
                               with_ctx=False, stats=True, device=device),
      cases_lib.flash_bwd_case(2, 12, 4096, 4096, 64, cap=0.0, mask='keys',
                               with_ctx=False, stats=True, device=device),
      cases_lib.flash_bwd_case(2, 16, 1032, 1032, 88, cap=50.0, mask='keys',
                               with_ctx=False, stats=True, device=device)):
    given = case.fn(*case.args, **case.kwargs)
    own = case.fn(*case.args, **dict(case.kwargs, stats=None))
    same = all(torch.equal(a, b) for a, b in zip(given, own))
    print(f'[kernels] fused_attention_bwd {case.label}: dq, dk, dv '
          f'{"bitwise equal" if same else "DIFFER"} to its own statistics')
    check(same, f'K7 with K5\'s statistics differs at {case.label}')


def variant(case: cases_lib.Case) -> str | None:
  """The record a case's numbers go to beside its kernel's: K7 given K5's
  row statistics (the train step's route) is kept apart from K7 computing
  its own (the record, as before)."""
  return K7_STATS if 'stats' in case.kwargs else None


def phase_kernels(device) -> dict[tuple[str, str | None], dict]:
  record = {(k, None): {'max_abs_err': 0.0} for k in KERNELS}
  record['fused_attention_bwd', K7_STATS] = {'max_abs_err': 0.0}
  for case in (cases_lib.main_path_cases(device, batch=2)
               + cases_lib.clip_path_cases(device, batch=2)
               + cases_lib.wide_path_cases(device, batch=2)
               + cases_lib.capacity_cases(device, batch=2)
               + cases_lib.int8_path_cases(device, batch=2)
               + cases_lib.int8_giant_cases(device, batch=1)
               + cases_lib.flash_bwd_path_cases(device, batch=2)):
    r = cases_lib.run_case(case)
    chunked = ''
    if 'differ_chunked' in r:
      chunked = (f', elements differing from the chunked twin '
                 f'{r["differ_chunked"]:.4%} / from the one-chunk twin '
                 f'{r["differ_one_chunk"]:.4%}'
                 + (f' / from the cast-once sum {r["differ_cast_once"]:.4%}'
                    if 'differ_cast_once' in r else '')
                 + f' (max|kernel-one-chunk| {r["err_vs_one_chunk"]:.3g})')
    print(f'[kernels] {r["kernel"]} {r["label"]}: max|kernel-twin| '
          f'{r["max_abs_err"]:.3g}, vs fp32 twin {r["err_vs_fp32"]:.3g} '
          f'(bf16 twin {r["twin_err_vs_fp32"]:.3g}){chunked} '
          f'{"ok" if r["ok"] else "FAIL"}')
    check(r['ok'], f'{r["kernel"]} {r["label"]} disagrees with its twin '
          f'(atol=rtol={cases_lib.ATOL}, fp32 ratio '
          f'{cases_lib.FP32_ERR_RATIO}, chunk share ratio '
          f'{cases_lib.CHUNK_SHARE_RATIO})')
    rec = record[case.kernel, variant(case)]
    rec['max_abs_err'] = max(rec['max_abs_err'], r['max_abs_err'])
  _check_weight_helper(device)
  _check_bwd_statistics(device)
  check_int8_fusion(device)
  # Times at the paths' shapes for two requests; the JSON record takes
  # each kernel's first shape (K1: the spatial stack's).
  timed = [
      cases_lib.attention_case(32, 256, 768, 12, 64, cap=50.0, padded=False,
                               device=device),
      cases_lib.attention_case(512, 16, 768, 12, 64, cap=50.0, padded=False,
                               device=device),
      cases_lib.attention_case(2, 65, 768, 12, 64, cap=50.0, padded=True,
                               causal=True, device=device),
      cases_lib.ffn_case(8192, 768, 3072, activation='gelu', padded=False,
                         device=device),
      *cases_lib.boundary_cases(2, 16, 256, 768, device=device),
      cases_lib.flash_case(2, 12, 4096, 4096, 64, cap=50.0, mask='none',
                           device=device),
      # K5 at giant's head dim, the giant-width layer past the fused route
      # ([gate]: T = 1152, one clip).
      cases_lib.flash_case(1, 16, 1152, 1152, 88, cap=50.0, mask='keys',
                           device=device),
      cases_lib.layer_norm_case(8192, 768, direct_scale=False,
                                device=device),
      cases_lib.layer_norm_case(130, 768, direct_scale=False, device=device),
      # The classifiers' shapes for two clips of 8 frames (K8a: giant's
      # spatial and temporal stacks; K8b: large's and giant's rows).
      cases_lib.attention_case(16, 256, 1408, 16, 88, cap=50.0, padded=False,
                               chunks=2, device=device),
      cases_lib.attention_case(512, 8, 1408, 16, 88, cap=50.0, padded=False,
                               chunks=2, device=device),
      cases_lib.ffn_case(4096, 1024, 4096, activation='gelu', padded=False,
                         chunks=2, device=device),
      cases_lib.ffn_case(4096, 1408, 6144, activation='gelu', padded=False,
                         chunks=4, device=device),
      # The int8 paths' shapes for two requests: K11 at the encoder's
      # spatial (2, 1) and temporal (1, 1) stacks and the text tower; K10
      # and K9 at the shapes B = 8 gives them, per two clips; K12a/K12b at
      # the auxiliary encoder's rows.
      cases_lib.int8_layer_case(32, 256, 768, 12, 64, 3072, cap=50.0,
                                padded=False, chunks=(2, 1), device=device),
      cases_lib.int8_layer_case(512, 16, 768, 12, 64, 3072, cap=50.0,
                                padded=False, chunks=(1, 1), device=device),
      cases_lib.int8_layer_case(2, 65, 768, 12, 64, 3072, cap=50.0,
                                padded=True, causal=True, chunks=(1, 1),
                                device=device),
      cases_lib.int8_attention_case(32, 256, 768, 12, 64, cap=50.0,
                                    padded=False, chunks=1, device=device),
      cases_lib.int8_attention_case(512, 16, 768, 12, 64, cap=50.0,
                                    padded=False, chunks=1, device=device),
      cases_lib.int8_ffn_case(8192, 768, 3072, activation='gelu',
                              padded=False, chunks=1, device=device),
      *cases_lib.int8_projection_cases(8192, 768, 768, device=device),
      # The int8 giant encoder's for one clip: K10 over 2 head groups of
      # 8 x 88 in the spatial stack, K9 over 2 F-slices.
      cases_lib.int8_attention_case(8, 256, 1408, 16, 88, cap=50.0,
                                    padded=False, chunks=2, device=device),
      cases_lib.int8_ffn_case(2048, 1408, 6144, activation='gelu',
                              padded=False, chunks=2, device=device),
      # K7's record: the auxiliary encoder's shape computing its own row
      # statistics (the route of K1's and K8a's backward); then the lvt
      # base train step's shapes for two clips, the auxiliary encoder's
      # given K5's statistics as the step gives them.
      cases_lib.flash_bwd_case(2, 12, 4096, 4096, 64, cap=50.0, mask='none',
                               with_ctx=False, device=device),
      *cases_lib.flash_bwd_path_cases(device, batch=2),
  ]
  for case in timed:
    run = lambda impl: case.fn(*case.args, **case.kwargs, impl=impl)
    ms = cuda_ms(lambda: run('kernel'), warmup=3, iters=20)
    dev_ms = device_ms(lambda: run('kernel'), iters=10)
    plain_ms = cuda_ms(lambda: run('reference'), warmup=2, iters=10)
    library_ms = library_dev_ms = None
    if case.kernel == 'fused_layer_norm_2d':
      library_ms = cuda_ms(_library_layer_norm(case), warmup=3, iters=20)
      library_dev_ms = device_ms(_library_layer_norm(case), iters=10)
    elif case.kernel.startswith('int8_'):
      # The faster of B row-major and B K-major (the TN layout).
      layouts = {layout: cuda_ms(cases_lib.int8_library(case, layout),
                                 warmup=3, iters=20)
                 for layout in cases_lib.INT8_LIBRARY_LAYOUTS}
      library_layout = min(layouts, key=layouts.get)
      library_ms = layouts[library_layout]
    bound_ms, bound_by = cases_lib.bound(case)
    library = 'none' if library_ms is None else f'{library_ms:.4f} ms'
    if library_dev_ms is not None:
      library += f' (device {library_dev_ms:.4f} ms)'
    if case.kernel.startswith('int8_'):
      library = (f'torch._int_mm over its products {library} ('
                 + ', '.join(f'{k} {v:.4f}' for k, v in layouts.items())
                 + ')')
    print(f'[kernels] time {case.kernel} {case.label}: kernel {ms:.4f} ms '
          f'(device {dev_ms:.4f} ms), plain twin {plain_ms:.4f} ms, library '
          f'{library}, bound {bound_ms:.4f} ms ({bound_by})')
    rec = record[case.kernel, variant(case)]
    for key, value in (('ms', ms), ('device_ms', dev_ms),
                       ('plain_ms', plain_ms),
                       ('library_ms', library_ms),
                       ('library_device_ms', library_dev_ms),
                       ('library_layout', library_layout
                        if case.kernel.startswith('int8_') else None),
                       ('bound_ms', bound_ms),
                       ('bound_by', bound_by)):
      rec.setdefault(key, value)
  # Yardstick only, not the same function: SDPA has no tanh cap, so it is
  # timed on K5's inputs without one, beside K5 without one.
  case = next(c for c in timed if c.kernel == 'fused_attention')
  q, k, v, _ = case.args
  sdpa_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
      q, k, v), warmup=3, iters=20)
  nocap_ms = cuda_ms(lambda: case.fn(*case.args, logit_cap=0.0,
                                     impl='kernel'), warmup=3, iters=20)
  print(f'[kernels] yardstick {case.label} without a cap: kernel '
        f'{nocap_ms:.4f} ms, scaled_dot_product_attention {sdpa_ms:.4f} ms')
  # K7's yardstick, likewise not the same function: SDPA's forward and
  # backward without a cap, on each K7 case's q, k, v and dO.
  for case in (c for c in timed if c.kernel == 'fused_attention_bwd'
               and 'stats' not in c.kwargs):
    q, k, v, _, do = (a.detach().requires_grad_(i < 3)
                      for i, a in enumerate(case.args))
    sdpa = lambda: torch.autograd.grad(
        torch.nn.functional.scaled_dot_product_attention(q, k, v),
        (q, k, v), do)
    print(f'[kernels] yardstick {case.label}: scaled_dot_product_attention '
          f'forward + backward without a cap '
          f'{cuda_ms(sdpa, warmup=3, iters=10):.4f} ms')
  return record


def _video(b: int, device, seed: int) -> torch.Tensor:
  gen = torch.Generator(device=device).manual_seed(seed)
  return torch.rand((b, FRAMES, SIZE, SIZE, 3), generator=gen, device=device)


def _text(b: int, device, seed: int) -> tuple[torch.Tensor, torch.Tensor]:
  """Seeded ids [b, 64] in the vocabulary and paddings with seeded real
  lengths (1..64, so some tokens are padded)."""
  gen = torch.Generator(device=device).manual_seed(seed)
  ids = torch.randint(0, registry.TEXT_VOCAB_SIZE, (b, TEXT_LEN),
                      generator=gen, device=device)
  lengths = torch.randint(1, TEXT_LEN + 1, (b, 1), generator=gen,
                          device=device)
  return ids, (torch.arange(TEXT_LEN, device=device) >= lengths).float()


def phase_model(device):
  model = registry.get_model('videoprism_public_v1_base',
                             fprop_dtype=torch.bfloat16)
  tree = init_lib.numpy_factorized_encoder(0, model.config, norm_bias_std=0.1)
  params = prepare_for_kernels(
      params_from_numpy(tree, device=device, dtype=torch.bfloat16))
  _lib.reset_launches()
  outputs = {}
  for b in (1, 2, 8):
    before = dict(_lib.LAUNCHES)
    out, _ = model.apply(params, _video(b, device, seed=b))
    torch.cuda.synchronize()
    check(tuple(out.shape) == (b, 4096, 768), f'output shape {out.shape}')
    check(bool(torch.isfinite(out).all()), f'non-finite output at B={b}')
    per = launches_since(before)
    check(per == PER_FORWARD, f'launches per forward {per} != {PER_FORWARD}')
    outputs[b] = out
    print(f'[model] B={b}: out {tuple(out.shape)} {out.dtype}, finite, '
          f'launches {per}')
  launches = dict(_lib.LAUNCHES)

  video = _video(2, device, seed=2)
  ref, _ = model.apply(params, video, impl='reference')
  model32 = model.replace_config(dtype=torch.float32)
  params32 = params_from_numpy(tree, device=device)
  ref32, _ = model32.apply(params32, video, impl='reference')
  del params32
  got = outputs[2]
  for label, want in (('bf16 reference', ref), ('fp32 reference', ref32)):
    cos = cosine_per_token(got, want)
    err = (got.float() - want.float()).abs().max().item()
    print(f'[model] B=2 kernels vs {label}: min per-token cosine {cos:.6f}, '
          f'max abs err {err:.4g}')
    check(cos >= MIN_COSINE, f'cosine {cos} < {MIN_COSINE} vs {label}')
  return model, params, launches


def phase_golden(device) -> None:
  g = np.load(GOLDEN)
  cfg_dict = json.loads(str(g['config']))
  cfg = fe.FactorizedEncoderConfig(
      **cfg_dict | {'pos_emb_shape': tuple(cfg_dict['pos_emb_shape'])},
      dtype=torch.bfloat16)
  params = prepare_for_kernels(init_lib.init_factorized_encoder(
      int(g['param_seed']), cfg, device=device, dtype=torch.bfloat16,
      norm_bias_std=float(g['norm_bias_std'])))
  video = np.random.default_rng(int(g['video_seed'])).standard_normal(
      tuple(g['video_shape'])).astype(np.float32)
  out, _ = fe.apply(params, torch.from_numpy(video).to(device), cfg,
                    impl='kernel')
  want = torch.from_numpy(g['output']).to(device)
  err = (out.float() - want).abs().max().item()
  cos = cosine_per_token(out, want)
  print(f'[golden] tiny config, bf16 kernels vs JAX fp32: max abs err '
        f'{err:.4g} (atol {GOLDEN_ATOL}), min per-token cosine {cos:.6f}')
  check(err <= GOLDEN_ATOL and cos >= MIN_COSINE, 'golden mismatch')


def phase_clip(device):
  model = registry.get_model(CLIP_MODEL, fprop_dtype=torch.bfloat16)
  tree = init_lib.numpy_video_clip(0, model.config, norm_bias_std=0.1)
  params = prepare_for_kernels(
      params_from_numpy(tree, device=device, dtype=torch.bfloat16))
  requests = (('video', 1), ('video+text', 2), ('text', 8))
  _lib.reset_launches()
  outputs = {}
  for kind, b in requests:
    video = _video(b, device, seed=20 + b) if 'video' in kind else None
    text = _text(b, device, seed=30 + b) if 'text' in kind else (None, None)
    before = dict(_lib.LAUNCHES)
    video_emb, text_emb, _ = model.apply(params, video, *text)
    torch.cuda.synchronize()
    per = launches_since(before)
    for label, emb in (('video', video_emb), ('text', text_emb)):
      check((emb is not None) == (label in kind),
            f'{kind} request: {label} embeddings {emb is not None}')
      if emb is not None:
        check(tuple(emb.shape) == (b, 768), f'{label} shape {emb.shape}')
        check(bool(torch.isfinite(emb).all()), f'non-finite {label} at B={b}')
    check(per == PER_CLIP_REQUEST[kind],
          f'{kind} launches {per} != {PER_CLIP_REQUEST[kind]}')
    outputs[kind] = (video_emb, text_emb, video, text)
    print(f'[clip] {kind} B={b}: embeddings [{b}, 768] bf16, finite, '
          f'launches {per}')
  launches = dict(_lib.LAUNCHES)

  got_v, got_t, video, text = outputs['video+text']
  ref_v, ref_t, _ = model.apply(params, video, *text, impl='reference')
  model32 = model.replace_config(dtype=torch.float32)
  params32 = params_from_numpy(tree, device=device)
  ref32_v, ref32_t, _ = model32.apply(params32, video, *text,
                                      impl='reference')
  del params32
  torch.cuda.empty_cache()
  for label, want_v, want_t in (('bf16 reference', ref_v, ref_t),
                                ('fp32 reference', ref32_v, ref32_t)):
    for tower, got, want in (('video', got_v, want_v),
                             ('text', got_t, want_t)):
      cos = cosine_per_token(got, want)
      err = (got.float() - want.float()).abs().max().item()
      print(f'[clip] B=2 {tower} kernels vs {label}: min per-embedding '
            f'cosine {cos:.6f}, max abs err {err:.4g}')
      check(cos >= MIN_COSINE, f'{tower} cosine {cos} < {MIN_COSINE} vs '
            f'{label}')
  return model, params, launches


def phase_clip_golden(device) -> None:
  g = np.load(CLIP_GOLDEN)
  cfg_dict = json.loads(str(g['config']))
  cfg = clip_lib.VideoCLIPConfig(
      **cfg_dict | {'pos_emb_shape': tuple(cfg_dict['pos_emb_shape'])},
      dtype=torch.bfloat16)
  params = prepare_for_kernels(init_lib.init_video_clip(
      int(g['param_seed']), cfg, device=device, dtype=torch.bfloat16,
      norm_bias_std=float(g['norm_bias_std'])))
  # The inputs, drawn as scripts/make_torch_clip_golden.py make_inputs does.
  rng = np.random.default_rng(int(g['input_seed']))
  video = rng.standard_normal(tuple(g['video_shape'])).astype(np.float32)
  lengths = np.asarray(g['text_lengths'])
  ids = rng.integers(0, cfg.vocabulary_size,
                     size=(len(lengths), lengths.max())).astype(np.int32)
  pads = (np.arange(lengths.max())[None, :]
          >= lengths[:, None]).astype(np.float32)
  _lib.reset_launches()
  video_emb, text_emb, outs = clip_lib.apply(
      params, torch.from_numpy(video).to(device),
      torch.from_numpy(ids).to(device), torch.from_numpy(pads).to(device),
      cfg, return_intermediate=('frame_embeddings',), impl='kernel')
  torch.cuda.synchronize()
  check(_lib.LAUNCHES['fused_attention'] > 0
        and _lib.LAUNCHES['fused_layer_norm_2d'] > 0,
        f'the tiny CLIP config did not run K5 and K6: {dict(_lib.LAUNCHES)}')
  for key, got in (('video_embeddings', video_emb),
                   ('text_embeddings', text_emb),
                   ('frame_embeddings', outs['frame_embeddings'])):
    want = torch.from_numpy(g[key]).to(device)
    err = (got.float() - want).abs().max().item()
    cos = cosine_per_token(got, want)
    print(f'[clip-golden] tiny config {key}, bf16 kernels vs JAX fp32: max '
          f'abs err {err:.4g} (atol {CLIP_GOLDEN_ATOL}), min cosine '
          f'{cos:.6f}')
    check(err <= CLIP_GOLDEN_ATOL and cos >= MIN_COSINE,
          f'CLIP golden mismatch in {key}')


def _gate_layer(label: str, params, cfg, b: int, t: int, d: int,
                want_routes: dict, gen, device) -> None:
  """One layer on the kernel path against the plain path (impl='reference')
  on the same seeded input, the last sequence padded from token 900: the
  launches it makes must be ``want_routes``, its min per-token cosine at
  least MIN_COSINE."""
  x = torch.randn((b, t, d), generator=gen, device=device,
                  dtype=torch.bfloat16)
  pads = torch.zeros((b, t), device=device)
  pads[-1, 900:] = 1.0
  mask = mask_lib.attention_mask_for_fprop(x, pads)
  _lib.reset_launches()
  got = transformer_lib.transformer_layer(params, x, pads, mask, cfg)
  torch.cuda.synchronize()
  routed = {k: v for k, v in _lib.LAUNCHES.items() if v}
  want = transformer_lib.transformer_layer(params, x, pads, mask, cfg,
                                           impl='reference')
  cos = cosine_per_token(got, want)
  print(f'[gate] {label} at [{b}, {t}, {d}]: launches {routed}, min '
        f'per-token cosine vs the plain path {cos:.6f}')
  check(routed == want_routes, f'{label} at T={t} routed to {routed}, not '
        f'{want_routes}')
  check(cos >= MIN_COSINE, f'{label} at T={t}: cosine {cos} < {MIN_COSINE}')


def _gate_block_backward(device, label: str, d: int, heads: int,
                         hd: int) -> None:
  """An attention block's backward (K8a over 2 head groups on 16
  sequences of 256 tokens, then K7 with the context) against the plain
  path's (autograd through the twin) in fp32, by [train]'s rule: the
  cosine of the whole gradient and of each operand's at TRAIN_MIN_COSINE /
  TRAIN_MIN_LEAF_COSINE, or within FP32_ERR_RATIO of the bf16 plain path's
  distance."""
  case = cases_lib.attention_case(16, 256, d, heads, hd, cap=50.0,
                                  padded=True, chunks=2, device=device)
  gen = torch.Generator(device=device).manual_seed(7)
  cot = torch.randn(case.args[0].shape, generator=gen, device=device)
  names = ('x', 'ln_scale', 'ln_bias', 'wqkv', 'bqkv', 'wo', 'bo')

  def grads(args, impl):
    leaves = [a.detach().clone().requires_grad_(i != 1)
              for i, a in enumerate(args)]
    out = case.fn(*leaves, **case.kwargs, impl=impl)
    (out.float() * cot).sum().backward()
    return [a.grad.double() for i, a in enumerate(leaves) if i != 1]

  _lib.reset_launches()
  got = grads(case.args, 'kernel')
  torch.cuda.synchronize()
  routed = {k: v for k, v in _lib.LAUNCHES.items() if v}
  ctx = _lib.CTX_LAUNCHES['fused_attention_bwd']
  want32 = grads(tuple(a.float() for a in case.args), 'reference')
  want16 = grads(case.args, 'reference')
  cos = lambda a, b: torch.nn.functional.cosine_similarity(
      a.flatten(), b.flatten(), dim=0).item()
  whole = cos(torch.cat([g.flatten() for g in got]),
              torch.cat([g.flatten() for g in want32]))
  whole16 = cos(torch.cat([g.flatten() for g in want16]),
                torch.cat([g.flatten() for g in want32]))
  leaves = {n: (cos(a, c), cos(b, c))
            for n, a, b, c in zip(names, got, want16, want32)}
  print(f'[gate] {label} attention block backward {case.label}: '
        f'launches {routed}, K7 with ctx {ctx}; gradient cosine vs the fp32 '
        f'plain path {whole:.6f} (bf16 plain path {whole16:.6f}); per '
        'operand (kernels, bf16 plain path): '
        + ', '.join(f'{n} {a:.6f}/{b:.6f}' for n, (a, b) in leaves.items()))
  check(routed == {'fused_attention_block_chunked': 1,
                   'fused_attention_bwd': 1} and ctx == 1,
        f'{label} block backward routed to {routed} (K7 with ctx {ctx})')
  check(near(whole, whole16, TRAIN_MIN_COSINE),
        f'{label} block gradient cosine {whole} (bf16 plain path {whole16})')
  bad = {n: v for n, v in leaves.items()
         if not near(*v, TRAIN_MIN_LEAF_COSINE)}
  check(not bad, f'{label} block operand gradients off: {bad}')


def phase_gate(device) -> None:
  """Sequences K1's core used to refuse (ROADMAP fault 3.1), and giant's
  head dim past the fused route (fault 3.2): at T = 1024 a base-width and a
  giant-width layer run through K1's core on the route the reference's
  chunk rule picks; past the fused route the giant-width float layer takes
  the composed half, K6 + K5 (at T = 1032 and 1152: on the card K5 takes
  lengths off 128 too) and the giant-width int8 layer at T = 1032 the
  reference's K12a + K5 + K12b, K5 at H = 88; each agrees with the plain
  path.  Then a giant-width attention
  block's backward runs K7 at H = 88."""
  init = init_lib._Init(0, 0.1)
  gen = torch.Generator(device=device).manual_seed(0)
  for b, d, heads, f in ((2, 768, 12, 3072), (1, 1408, 16, 6144)):
    cfg = transformer_lib.TransformerLayerConfig(
        num_layers=1, hidden_dim=f, num_heads=heads, activation='gelu',
        enable_per_dim_scale=False, logit_cap=50.0, dtype=torch.bfloat16)
    tree = {'layer': init.layer(d, cfg)}
    params = prepare_for_kernels(params_from_numpy(
        tree, device=device, dtype=torch.bfloat16))['layer']
    t = transformer_lib.MAX_FUSED_ATTENTION_T
    attn, ffn = transformer_lib.chunk_plan(b, t, d, heads, d // heads, f, 2,
                                           causal=False)
    want_routes = {('fused_attention_block_chunked' if attn
                    else 'fused_attention_block'): 1,
                   ('fused_ffn_block_chunked' if ffn
                    else 'fused_ffn_block'): 1}
    _gate_layer(f'layer, H={d // heads} (chunk plan {attn}, {ffn})', params,
                cfg, b, t, d, want_routes, gen, device)
  # Past the fused route at giant's head dim (88, padded to 96 inside K5).
  for t in (t + 8, t + 128):
    _, ffn = transformer_lib.chunk_plan(b, t, d, heads, d // heads, f, 2,
                                        causal=False)
    want_routes = {'fused_layer_norm_2d': 1, 'fused_attention': 1,
                   ('fused_ffn_block_chunked' if ffn
                    else 'fused_ffn_block'): 1}
    _gate_layer('giant-width layer past the fused route, H=88', params, cfg,
                b, t, d, want_routes, gen, device)
  t = transformer_lib.MAX_FUSED_ATTENTION_T + 8
  plan = transformer_lib.int8_plan(b, t, d, heads, d // heads, f, 2,
                                   causal=False)
  check(plan.projected and plan.ffn_chunks,
        f'int8 route at T={t}, H=88 is {plan}')
  params = prepare_for_kernels(params_from_numpy(
      quantization.quantize_for_serving(tree), device=device,
      dtype=torch.bfloat16))['layer']
  _gate_layer('int8 giant-width layer past the fused route, H=88', params,
              cfg, b, t, d, {'int8_qkv_projection': 1, 'fused_attention': 1,
                             'int8_out_projection': 1,
                             'int8_ffn_block_chunked': 1}, gen, device)
  _gate_block_backward(device, 'giant-width', *cases_lib.GIANT[:3])
  _gate_odd_head_dim(device, gen)


# A layer whose head dim is not a multiple of 8: 32 heads of 36 at D = 1152
# (a multiple of 128, so that the reference's int8 route exists).
ODD_HEADS = (1152, 32, 36, 4608)


def _gate_odd_head_dim(device, gen) -> None:
  """ROADMAP fault 3.2's last gap: a head dim that is not a multiple of 8
  (36, padded to 40 by prepare_for_kernels, exact zeros): the float layer
  through K1 at T = 1024 and through K6 + K5 past the fused route (T =
  1032), the int8 layer through K10 over the reference's 2 head groups
  (two clips of 256 tokens), each against the plain path; then a K8a
  block's backward through K7 at H = 36 (the wrappers pad)."""
  d, heads, hd, f = ODD_HEADS
  cfg = transformer_lib.TransformerLayerConfig(
      num_layers=1, hidden_dim=f, num_heads=heads, activation='gelu',
      enable_per_dim_scale=False, logit_cap=50.0, dtype=torch.bfloat16)
  tree = {'layer': init_lib._Init(0, 0.1).layer(d, cfg)}
  params = prepare_for_kernels(params_from_numpy(
      tree, device=device, dtype=torch.bfloat16))['layer']
  hp = tb.padded_head_dim(hd)
  check(params['self_attention']['fused']['wqkv'].shape[-1] == 3 * heads * hp,
        f'head dim {hd} not padded to {hp} in the fused weights')
  b = 1
  for t in (transformer_lib.MAX_FUSED_ATTENTION_T,
            transformer_lib.MAX_FUSED_ATTENTION_T + 8):
    attn, ffn = transformer_lib.chunk_plan(b, t, d, heads, hd, f, 2,
                                           causal=False)
    if t <= transformer_lib.MAX_FUSED_ATTENTION_T:
      want_routes = {('fused_attention_block_chunked' if attn
                      else 'fused_attention_block'): 1}
    else:
      want_routes = {'fused_layer_norm_2d': 1, 'fused_attention': 1}
    want_routes[('fused_ffn_block_chunked' if ffn
                 else 'fused_ffn_block')] = 1
    _gate_layer(f'layer, {heads} heads of {hd}', params, cfg, b, t, d,
                want_routes, gen, device)
  b, t = 2, 256
  plan = transformer_lib.int8_plan(b, t, d, heads, hd, f, 2, causal=False)
  check(plan.layer is None and plan.attn_chunks and plan.ffn_chunks,
        f'int8 route at [{b}, {t}], H={hd} is {plan}')
  params = prepare_for_kernels(params_from_numpy(
      quantization.quantize_for_serving(tree), device=device,
      dtype=torch.bfloat16))['layer']
  _lib.reset_launches()
  _gate_layer(f'int8 layer, {heads} heads of {hd}', params, cfg, b, t, d,
              {'int8_attention_block_chunked': 1,
               'int8_ffn_block_chunked': 1}, gen, device)
  check(_lib.CHUNK_LAUNCHES['int8_attention_block_chunked',
                            plan.attn_chunks] == 1,
        f'int8 layer at H={hd}: K10 not over {plan.attn_chunks} head groups')
  _gate_block_backward(device, f'{heads} heads of {hd}', d, heads, hd)


def _leaves(tree):
  for v in tree.values():
    if isinstance(v, dict):
      yield from _leaves(v)
    else:
      yield v


def _vc_video(b: int, device, seed: int) -> torch.Tensor:
  gen = torch.Generator(device=device).manual_seed(seed)
  return torch.rand((b, VC_FRAMES, SIZE, SIZE, 3), generator=gen,
                    device=device)


def phase_vc(device, name: str, batches: tuple[int, ...], tag: str):
  """A classifier at full width and depth in bf16 on seeded weights;
  returns the model, its params, the launches and the seeded fp32 numpy
  encoder subtree."""
  model = getattr(registry, name)(registry.K400_NUM_CLASSES,
                                  dtype=torch.bfloat16)
  start = time.perf_counter()
  tree = init_lib.numpy_video_classifier(0, model.config, norm_bias_std=0.1)
  params = prepare_for_kernels(
      params_from_numpy(tree, device=device, dtype=torch.bfloat16))
  torch.cuda.synchronize()
  params_gb = sum(t.numel() * t.element_size() for t in _leaves(params))
  print(f'[{tag}] {name}: seeded bf16 params in '
        f'{time.perf_counter() - start:.1f} s, {params_gb / 2**30:.3f} GiB '
        'with the fused attention weights')
  want_launches = PER_VC_FORWARD[name]
  _lib.reset_launches()
  outputs = {}
  for b in batches:
    video = _vc_video(b, device, seed=60 + b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held_gb = torch.cuda.memory_allocated() / 2**30
    before = dict(_lib.LAUNCHES)
    logits, outs = model.apply(params, video,
                               return_intermediate=('global_embeddings',))
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    per = launches_since(before)
    check(tuple(logits.shape) == (b, registry.K400_NUM_CLASSES),
          f'logits shape {logits.shape}')
    check(bool(torch.isfinite(logits).all()), f'non-finite logits at B={b}')
    check(per == want_launches, f'launches per forward {per} != '
          f'{want_launches}')
    outputs[b] = (video, outs['global_embeddings'])
    print(f'[{tag}] B={b}: logits {tuple(logits.shape)} {logits.dtype}, '
          f'finite, peak device memory {peak_gb:.3f} GiB ('
          f'{peak_gb - held_gb:.3f} GiB above the {held_gb:.3f} GiB held '
          f'before the forward), launches '
          f'{ {k: v for k, v in per.items() if v} }')
  launches = dict(_lib.LAUNCHES)

  video, got = outputs[2]
  _, ref = model.apply(params, video, impl='reference',
                       return_intermediate=('global_embeddings',))
  model32 = getattr(registry, name)(registry.K400_NUM_CLASSES)
  params32 = params_from_numpy(tree, device=device)
  _, ref32 = model32.apply(params32, video, impl='reference',
                           return_intermediate=('global_embeddings',))
  del params32
  torch.cuda.empty_cache()
  for label, want in (('bf16 reference', ref['global_embeddings']),
                      ('fp32 reference', ref32['global_embeddings'])):
    cos = cosine_per_token(got, want)
    err = (got.float() - want.float()).abs().max().item()
    print(f'[{tag}] B=2 global embeddings, kernels vs {label}: min cosine '
          f'{cos:.6f}, max abs err {err:.4g}')
    check(cos >= MIN_COSINE, f'{tag} cosine {cos} < {MIN_COSINE} vs {label}')
  return model, params, launches, tree['encoder']


def phase_vc_golden(device) -> None:
  g = np.load(VC_GOLDEN)
  cfg_dict = json.loads(str(g['config']))
  cfg = vc_lib.VideoClassifierConfig(fe.FactorizedEncoderConfig(
      **cfg_dict | {'pos_emb_shape': tuple(cfg_dict['pos_emb_shape'])},
      dtype=torch.bfloat16), int(g['num_classes']))
  params = prepare_for_kernels(init_lib.init_video_classifier(
      int(g['param_seed']), cfg, device=device, dtype=torch.bfloat16,
      norm_bias_std=float(g['norm_bias_std'])))
  video = np.random.default_rng(int(g['video_seed'])).standard_normal(
      tuple(g['video_shape'])).astype(np.float32)
  _lib.reset_launches()
  logits, outs = vc_lib.apply(params, torch.from_numpy(video).to(device), cfg,
                              return_intermediate=('global_embeddings',),
                              impl='kernel')
  torch.cuda.synchronize()
  check(_lib.LAUNCHES['fused_ffn_block_chunked'] > 0,
        f'the tiny classifier did not run K8b: {dict(_lib.LAUNCHES)}')
  for key, got in (('logits', logits),
                   ('global_embeddings', outs['global_embeddings'])):
    want = torch.from_numpy(g[key]).to(device)
    err = (got.float() - want).abs().max().item()
    cos = cosine_per_token(got, want)
    print(f'[vc-golden] tiny config {key}, bf16 kernels vs JAX fp32: max '
          f'abs err {err:.4g} (atol {VC_GOLDEN_ATOL}), min cosine {cos:.6f}')
    check(err <= VC_GOLDEN_ATOL and cos >= MIN_COSINE,
          f'classifier golden mismatch in {key}')


def _int8_launches(b: int, cfg, *, clip: bool = False) -> tuple[dict, dict]:
  """(launches per kernel, K9/K10 launches by chunk count) of one int8
  request of ``b`` clips, from the copied route rule
  (``ops/transformer.py`` ``int8_plan``): the encoder's spatial and
  temporal stacks and boundaries and, for a CLIP video + text request, the
  auxiliary encoder over 4096 tokens, the causal text tower over 65 and the
  pooler's and the text tower's LN (K6)."""
  d, n, f = cfg.model_dim, cfg.num_heads, cfg.mlp_dim
  frames = cfg.pos_emb_shape[0]
  tokens = cfg.pos_emb_shape[1] * cfg.pos_emb_shape[2]
  stacks = [(b * frames, tokens, cfg.num_spatial_layers, False),
            (b * tokens, frames, cfg.num_temporal_layers, False)]
  launches = {'spatial_to_temporal': 1, 'temporal_to_output': 1}
  if clip:
    stacks += [(b, frames * tokens, cfg.num_auxiliary_layers, False),
               (b, TEXT_LEN + 1, cfg.num_unimodal_layers, True)]
    launches['fused_layer_norm_2d'] = 2
  chunks = {}
  add = lambda table, key, count: table.__setitem__(
      key, table.get(key, 0) + count)
  for rows, t, layers, causal in stacks:
    plan = transformer_lib.int8_plan(rows, t, d, n, d // n, f, 2,
                                     causal=causal)
    check(plan is not None, f'no int8 route at [{rows}, {t}, {d}]')
    if plan.layer:
      add(launches, 'int8_layer_block', layers)
      continue
    if plan.attn_chunks:
      add(launches, 'int8_attention_block_chunked', layers)
      add(chunks, ('int8_attention_block_chunked', plan.attn_chunks), layers)
    else:
      check(plan.projected, f'the int8 attention half at [{rows}, {t}, {d}] '
            'would be dequantized')
      for k in ('int8_qkv_projection', 'fused_attention',
                'int8_out_projection'):
        add(launches, k, layers)
    check(plan.ffn_chunks is not None,
          f'the int8 FFN half at [{rows}, {t}, {d}] would be dequantized')
    add(launches, 'int8_ffn_block_chunked', layers)
    add(chunks, ('int8_ffn_block_chunked', plan.ffn_chunks), layers)
  return {k: launches.get(k, 0) for k in KERNELS}, chunks


def _int8_run(tag: str, call, b: int, cfg, *, clip: bool = False):
  """One int8 request with the launches it makes held to the route plan."""
  before = dict(_lib.LAUNCHES)
  before_chunks = dict(_lib.CHUNK_LAUNCHES)
  out = call()
  torch.cuda.synchronize()
  per = launches_since(before)
  per_chunks = {k: v - before_chunks.get(k, 0)
                for k, v in _lib.CHUNK_LAUNCHES.items()
                if v - before_chunks.get(k, 0)}
  want, want_chunks = _int8_launches(b, cfg, clip=clip)
  check(per == want, f'{tag} B={b}: launches {per} != the plan {want}')
  check(per_chunks == want_chunks,
        f'{tag} B={b}: chunk counts {per_chunks} != the plan {want_chunks}')
  chunked = ', '.join(f'{k} x{c}: {v}' for (k, c), v in
                      sorted(per_chunks.items())) or 'none'
  print(f'[{tag}] B={b}: launches { {k: v for k, v in per.items() if v} } '
        f'= the route plan; K9/K10 by chunk count: {chunked}')
  return out


def _int8_vs_plain(tag: str, label: str, got: torch.Tensor,
                   ref: torch.Tensor, ref32: torch.Tensor, *,
                   per_token: bool = True) -> None:
  """The B=2 output of the int8 kernels against the int8 plain path in
  bf16 (``ref``) and in fp32 activations (``ref32``, the same int8
  weights): the cosine to ``ref`` (the least per token, or over the whole
  output) is at least MIN_COSINE, and the kernels are no farther from
  ``ref32`` (1 - the least per-token cosine) than FP32_ERR_RATIO times the
  bf16 plain path is."""
  cos = cosine_per_token(got, ref)
  whole = torch.nn.functional.cosine_similarity(
      got.double().flatten(), ref.double().flatten(), dim=0).item()
  err = (got.float() - ref.float()).abs().max().item()
  kernel32, twin32 = cosine_per_token(got, ref32), cosine_per_token(ref, ref32)
  print(f'[{tag}] B=2 {label}kernels vs the int8 plain path: min '
        f'per-token cosine {cos:.6f}, over the output {whole:.6f}, max abs '
        f'err {err:.4g}; vs the fp32-activation int8 plain path: kernels '
        f'{kernel32:.6f}, bf16 plain path {twin32:.6f}')
  gated = cos if per_token else whole
  check(gated >= MIN_COSINE, f'{tag} {label}cosine {gated} < {MIN_COSINE} '
        'vs the int8 plain path')
  check(1.0 - kernel32 <= cases_lib.FP32_ERR_RATIO * (1.0 - twin32),
        f'{tag} {label}kernels farther from the fp32 int8 path ({kernel32}) '
        f'than {cases_lib.FP32_ERR_RATIO}x the bf16 plain path ({twin32})')


def phase_int8(device, tmp: str, float_model, float_params):
  """The base encoder through load_video_encoder(quantize='int8'): K11 per
  layer at B <= 2, K10 + K9 at B = 8 (the reference's route)."""
  name = 'videoprism_public_v1_base'
  cfg = registry.get_model(name).config
  start = time.perf_counter()
  path = os.path.join(tmp, f'{name}.npz')
  save_checkpoint(path, init_lib.numpy_factorized_encoder(
      0, cfg, norm_bias_std=0.1))
  bound = registry.load_video_encoder(name, path, fprop_dtype=torch.bfloat16,
                                      quantize='int8', device=device)
  print(f'[int8] {name}: load_video_encoder(quantize=\'int8\', '
        f'fprop_dtype=bfloat16) from a seeded fp32 npz in '
        f'{time.perf_counter() - start:.1f} s')
  _lib.reset_launches()
  outputs = {}
  for b in (1, 2, 8):
    video = _video(b, device, seed=b)
    out, _ = _int8_run('int8', lambda: bound(video), b, cfg)
    check(tuple(out.shape) == (b, math.prod(cfg.pos_emb_shape),
                               cfg.model_dim),
          f'int8 output shape {out.shape}')
    check(bool(torch.isfinite(out).all()), f'non-finite int8 output at B={b}')
    outputs[b] = (video, out)
  launches = dict(_lib.LAUNCHES)

  video, got = outputs[2]
  ref, _ = bound(video, impl='reference')
  bound32 = registry.load_video_encoder(name, path, quantize='int8',
                                        device=device)
  ref32, _ = bound32(video, impl='reference')
  del bound32
  _int8_vs_plain('int8', '', got, ref, ref32)
  float_out, _ = float_model.apply(float_params, video)
  whole = torch.nn.functional.cosine_similarity(
      got.float().flatten(), float_out.float().flatten(), dim=0).item()
  print(f'[int8] B=2 int8 vs the bf16 float kernel path (recorded, not '
        f'gated): cosine over the output {whole:.6f}, min per-token '
        f'{cosine_per_token(got, float_out):.6f}')
  return bound, launches


def phase_int8_clip(device, tmp: str, float_model, float_params):
  """lvt base through load_model(quantize='int8'): video + text requests."""
  cfg = registry.get_model(CLIP_MODEL).config
  start = time.perf_counter()
  path = os.path.join(tmp, f'{CLIP_MODEL}.npz')
  save_checkpoint(path, init_lib.numpy_video_clip(0, cfg, norm_bias_std=0.1))
  bound = registry.load_model(CLIP_MODEL, path, fprop_dtype=torch.bfloat16,
                              quantize='int8', device=device)
  print(f'[int8-clip] {CLIP_MODEL}: load_model(quantize=\'int8\', '
        f'fprop_dtype=bfloat16) from a seeded fp32 npz in '
        f'{time.perf_counter() - start:.1f} s')
  _lib.reset_launches()
  outputs = {}
  for b in (1, 2, 8):
    video, text = _video(b, device, seed=20 + b), _text(b, device, 30 + b)
    video_emb, text_emb, _ = _int8_run(
        'int8-clip', lambda: bound(video, *text), b, cfg, clip=True)
    for label, emb in (('video', video_emb), ('text', text_emb)):
      check(tuple(emb.shape) == (b, cfg.model_dim),
            f'int8 {label} shape {emb.shape}')
      check(bool(torch.isfinite(emb).all()),
            f'non-finite int8 {label} at B={b}')
    outputs[b] = (video_emb, text_emb, video, text)
  launches = dict(_lib.LAUNCHES)
  got_v, got_t, video, text = outputs[2]
  ref_v, ref_t, _ = bound(video, *text, impl='reference')
  bound32 = registry.load_model(CLIP_MODEL, path, quantize='int8',
                                device=device)
  ref32_v, ref32_t, _ = bound32(video, *text, impl='reference')
  del bound32
  os.remove(path)
  flt_v, flt_t, _ = float_model.apply(float_params, video, *text)
  for tower, got, want, want32, flt in (
      ('video', got_v, ref_v, ref32_v, flt_v),
      ('text', got_t, ref_t, ref32_t, flt_t)):
    _int8_vs_plain('int8-clip', f'{tower} ', got, want, want32)
    print(f'[int8-clip] B=2 {tower} int8 vs the bf16 float kernel path '
          f'(recorded, not gated): min per-embedding cosine '
          f'{cosine_per_token(got, flt):.6f}')
  torch.cuda.empty_cache()
  return bound, launches


def phase_int8_giant(device, encoder_tree, float_encoder_params):
  """The giant encoder with int8 weights (quantize_for_serving on the
  classifier's seeded fp32 encoder subtree): K10 over 2 head groups and K9
  over 2 F-slices in the spatial stack, K10 in one group and K9 over 2 in
  the temporal one."""
  model = registry.videoprism_v1_giant().replace_config(dtype=torch.bfloat16)
  cfg = model.config
  start = time.perf_counter()
  tree = quantization.quantize_for_serving(encoder_tree)
  params = prepare_for_kernels(params_from_numpy(tree, device=device,
                                                 dtype=torch.bfloat16))
  torch.cuda.synchronize()
  print(f'[int8-giant] videoprism_v1_giant: seeded fp32 encoder quantized '
        f'and loaded in {time.perf_counter() - start:.1f} s, '
        f'{sum(t.numel() * t.element_size() for t in _leaves(params)) / 2**30:.3f}'
        ' GiB')
  _lib.reset_launches()
  outputs = {}
  tokens = math.prod(cfg.pos_emb_shape)   # 8 frames of 16 x 16 patches
  for b in (1, 2):
    video = _vc_video(b, device, seed=80 + b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held_gb = torch.cuda.memory_allocated() / 2**30
    out, _ = _int8_run('int8-giant', lambda: model.apply(params, video), b,
                       cfg)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    check(tuple(out.shape) == (b, tokens, cfg.model_dim),
          f'int8 giant output shape {out.shape}')
    check(bool(torch.isfinite(out).all()),
          f'non-finite int8 giant output at B={b}')
    print(f'[int8-giant] B={b}: out {tuple(out.shape)} {out.dtype}, finite, '
          f'peak device memory {peak_gb:.3f} GiB ({peak_gb - held_gb:.3f} '
          f'GiB above the {held_gb:.3f} GiB held before the forward)')
    outputs[b] = (video, out)
  launches = dict(_lib.LAUNCHES)
  video, got = outputs[2]
  ref, _ = model.apply(params, video, impl='reference')
  params32 = params_from_numpy(tree, device=device)
  ref32, _ = model.replace_config(dtype=torch.float32).apply(
      params32, video, impl='reference')
  del params32, tree
  # Over 44 layers the bf16 rounding of two implementations drifts apart
  # (each int8 re-quantization turns an ulp into a code step) about as far
  # as the bf16 plain path drifts from the fp32-activation one, on every
  # token alike; the least per-token cosine sits at that floor, printed
  # beside it.  So the cosine over the whole output is gated here, and the
  # per-token one through the fp32 ratio.
  _int8_vs_plain('int8-giant', '', got, ref, ref32, per_token=False)
  float_out, _ = model.apply(float_encoder_params, video)
  print(f'[int8-giant] B=2 int8 vs the bf16 float kernel path (recorded, '
        f'not gated): min per-token cosine '
        f'{cosine_per_token(got, float_out):.6f}')
  del ref, ref32, float_out
  torch.cuda.empty_cache()
  return registry.BoundModel(model, params), launches


def phase_int8_golden(device) -> None:
  sys.path.insert(0, os.path.join(ROOT, 'scripts'))
  import make_torch_int8_golden as golden

  g = np.load(INT8_GOLDEN)
  clip_dict = json.loads(str(g['clip_config']))
  enc_dict = json.loads(str(g['encoder_config']))
  check(clip_dict == golden.CLIP_CONFIG and enc_dict == golden.ENCODER_CONFIG,
        'tests/data/torch_port_int8_golden.npz is not the script\'s config')
  clip_tree, enc_tree = golden.int8_trees(int(g['param_seed']),
                                          float(g['norm_bias_std']))
  video, ids, pads, enc_video, frame_pads, real = golden.make_inputs(
      int(g['input_seed']))
  load = lambda tree: prepare_for_kernels(params_from_numpy(
      tree, device=device, dtype=torch.bfloat16))
  on_card = lambda a: torch.from_numpy(a).to(device)
  _lib.reset_launches()
  video_emb, text_emb, _ = clip_lib.apply(
      load(clip_tree), on_card(video), on_card(ids), on_card(pads),
      clip_lib.VideoCLIPConfig(**clip_dict | {
          'pos_emb_shape': tuple(clip_dict['pos_emb_shape'])},
                               dtype=torch.bfloat16), impl='kernel')
  tokens, _ = fe.apply(
      load(enc_tree), on_card(enc_video), fe.FactorizedEncoderConfig(
          **enc_dict | {'pos_emb_shape': tuple(enc_dict['pos_emb_shape'])},
          dtype=torch.bfloat16),
      frame_paddings=on_card(frame_pads), impl='kernel')
  torch.cuda.synchronize()
  ran = {k: v for k, v in _lib.LAUNCHES.items() if k.startswith('int8_')}
  check(len(ran) == 5 and all(ran.values()),
        f'the tiny int8 configs did not run K9-K12b: {ran}')
  for key, got in (('video_embeddings', video_emb),
                   ('text_embeddings', text_emb),
                   ('encoder_tokens', tokens[on_card(real)])):
    want = torch.from_numpy(g[key]).to(device)
    atol = INT8_GOLDEN_RATIO * float(g[f'bf16_twin_err_{key}'])
    err = (got.float() - want).abs().max().item()
    cos = cosine_per_token(got, want)
    print(f'[int8-golden] tiny int8 config {key}, bf16 kernels vs JAX fp32 '
          f'int8 kernels: max abs err {err:.4g} (atol {atol:.4g}, 3x the '
          f'bf16 twin\'s), min cosine {cos:.6f}')
    check(err <= atol and cos >= MIN_COSINE, f'int8 golden mismatch in {key}')


def _named_leaves(tree, prefix=''):
  for k, v in tree.items():
    if isinstance(v, dict):
      yield from _named_leaves(v, f'{prefix}/{k}')
    else:
      yield f'{prefix}/{k}', v


def _grad_leaves(grads):
  params, log_temperature = grads
  return [*_named_leaves(params), ('/log_temperature', log_temperature)]


def _grad_cosines(got, want):
  """(cosine of the whole concatenated gradient, {leaf: cosine} over the
  leaves of at least TRAIN_MIN_LEAF elements), in float64."""
  dot = na = nb = 0.0
  leaves = {}
  for (name, a), (_, b) in zip(_grad_leaves(got), _grad_leaves(want)):
    a, b = a.double().flatten(), b.double().flatten()
    d, x, y = (a @ b).item(), (a @ a).item(), (b @ b).item()
    dot, na, nb = dot + d, na + x, nb + y
    if a.numel() >= TRAIN_MIN_LEAF:
      leaves[name] = d / max(math.sqrt(x * y), 1e-300)
  return dot / math.sqrt(na * nb), leaves


def _train_batch(b: int, device, seed: int) -> dict[str, torch.Tensor]:
  ids, pads = _text(b, device, seed + 1)
  return {'video': _video(b, device, seed), 'text_token_ids': ids,
          'text_paddings': pads}


def phase_train(device, smi: str):
  """lvt base contrastive training at full width: B=2 gradients of the
  kernel path against the plain path in fp32, the launches of a step, and
  3 steps of make_train_step at B=8 with AdamW; ms per step and peak
  memory."""
  model = registry.get_model(CLIP_MODEL, fprop_dtype=torch.bfloat16)
  cfg = model.config
  tree = init_lib.numpy_video_clip(0, cfg, norm_bias_std=0.1)
  params = params_from_numpy(tree, device=device)   # fp32 master weights
  trainable = (params, objectives.init_temperature_state('infonce',
                                                         device=device))
  vg = train_lib.value_and_grad(train_lib.clip_loss_fn)
  batch = _train_batch(2, device, seed=110)
  _lib.reset_launches()
  (loss, _), grads = vg(trainable, batch, cfg)
  torch.cuda.synchronize()
  per = launches_since({})
  ctx = _lib.CTX_LAUNCHES['fused_attention_bwd']
  given = _lib.STATS_LAUNCHES['fused_attention_bwd']
  print(f'[train] B=2 value_and_grad launches '
        f'{ {k: v for k, v in per.items() if v} }, K7 with ctx {ctx}, K7 '
        f"given K5's statistics {given}")
  check(per == PER_TRAIN_STEP and ctx == TRAIN_K7_WITH_CTX
        and given == TRAIN_K7_WITH_STATS,
        f'train step launches {per} (K7 with ctx {ctx}, given statistics '
        f'{given}) != {PER_TRAIN_STEP} ({TRAIN_K7_WITH_CTX} with ctx, '
        f'{TRAIN_K7_WITH_STATS} given statistics)')
  check(all(bool(torch.isfinite(g).all()) for _, g in _grad_leaves(grads)),
        'non-finite gradient on the kernel path')
  cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
  (loss32, _), grads32 = vg(trainable, batch, cfg32, impl='reference')
  torch.cuda.empty_cache()
  (loss16, _), grads16 = vg(trainable, batch, cfg, impl='reference')
  torch.cuda.empty_cache()
  cos, leaves = _grad_cosines(grads, grads32)
  cos16, leaves16 = _grad_cosines(grads16, grads32)
  cos_twin, _ = _grad_cosines(grads, grads16)
  # Softmax ignores a shift of a query's logits, so a key bias's exact
  # gradient is 0: both bf16 paths return rounding noise there, and those
  # leaves are printed but not gated.
  gated = [k for k in leaves if not k.endswith('/key/b')]
  worst = min(gated, key=leaves.get)
  worst16 = min(gated, key=leaves16.get)
  print(f'[train] B=2 loss: kernels {loss.item():.6f}, fp32 plain path '
        f'{loss32.item():.6f}, bf16 plain path {loss16.item():.6f}')
  print(f'[train] B=2 gradient vs the fp32 plain path: cosine over the '
        f'whole gradient {cos:.6f} (bf16 plain path {cos16:.6f}; kernels vs '
        f'the bf16 plain path {cos_twin:.6f}); least per-leaf cosine over '
        f'the leaves of >= {TRAIN_MIN_LEAF} elements but the key biases '
        f'{leaves[worst]:.6f} at {worst} (bf16 plain path '
        f'{leaves16[worst16]:.6f} at {worst16})')
  for name in sorted(leaves, key=leaves.get)[:10]:
    print(f'[train]   leaf {name}: kernels {leaves[name]:.6f}, bf16 plain '
          f'path {leaves16[name]:.6f}')
  check(abs(loss.item() - loss32.item()) <= TRAIN_LOSS_ATOL,
        f'loss {loss.item()} vs fp32 {loss32.item()}')
  check(near(cos, cos16, TRAIN_MIN_COSINE),
        f'gradient cosine {cos} < {TRAIN_MIN_COSINE} and farther than '
        f'{cases_lib.FP32_ERR_RATIO}x the bf16 plain path ({cos16})')
  bad = [k for k in gated
         if not near(leaves[k], leaves16[k], TRAIN_MIN_LEAF_COSINE)]
  check(not bad, f'leaf gradient cosines below {TRAIN_MIN_LEAF_COSINE} and '
        f'farther than {cases_lib.FP32_ERR_RATIO}x the bf16 plain path: '
        f'{ {k: (leaves[k], leaves16[k]) for k in bad} }')
  del grads, grads32, grads16
  torch.cuda.empty_cache()

  opt = train_lib.make_optimizer(learning_rate=1e-4, warmup_steps=1,
                                 total_steps=100)
  state = train_lib.create_train_state(0, cfg, opt, pretrained_params=params,
                                       device=device)
  step = train_lib.make_train_step(cfg, opt)
  batch = _train_batch(8, device, seed=120)
  start = [p.clone() for _, p in _named_leaves(state.params)]
  _lib.reset_launches()
  for i in range(3):
    torch.cuda.reset_peak_memory_stats()
    state, metrics = step(state, batch)
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    loss = metrics['loss'].item()
    check(math.isfinite(loss), f'non-finite loss at step {i + 1}')
    now = [p for _, p in _named_leaves(state.params)]
    moved = sum(not torch.equal(a, b) for a, b in zip(start, now))
    print(f'[train] B=8 step {i + 1}: loss {loss:.6f}, grad_norm '
          f'{metrics["grad_norm"].item():.6f}, lr '
          f'{opt.learning_rate(i):.3g}, leaves moved {moved} of '
          f'{len(now)}, peak device memory {peak_gb:.3f} GiB')
    if i == 0:
      check(moved == 0, f'{moved} leaves moved at lr(0) = 0')
  check(moved > 0, 'no leaf moved after 3 steps')
  launches = dict(_lib.LAUNCHES)
  given = _lib.STATS_LAUNCHES['fused_attention_bwd']
  check(launches_since({}) == {k: 3 * v for k, v in PER_TRAIN_STEP.items()}
        and given == 3 * TRAIN_K7_WITH_STATS,
        f'3 steps launched {launches}, K7 given statistics {given}')
  ms = cuda_ms(lambda: step(state, batch), warmup=2, iters=5)
  print(f'[train] B=8 step (make_train_step, AdamW): {ms:.3f} ms/step, '
        f'{8000.0 / ms:.2f} clips/s, peak device memory {peak_gb:.3f} GiB '
        f'({smi})')
  del state, start, now, params, trainable
  torch.cuda.empty_cache()
  return launches, given


def phase_train_golden(device) -> None:
  """The tiny CLIP config's loss and gradients through the kernels in bf16
  against the JAX package's fp32 values."""
  g = np.load(TRAIN_GOLDEN)
  cfg_dict = json.loads(str(g['config']))
  cfg = clip_lib.VideoCLIPConfig(
      **cfg_dict | {'pos_emb_shape': tuple(cfg_dict['pos_emb_shape'])},
      dtype=torch.bfloat16)
  params = init_lib.init_video_clip(int(g['param_seed']), cfg, device=device,
                                    norm_bias_std=float(g['norm_bias_std']))
  rng = np.random.default_rng(int(g['input_seed']))
  video = rng.standard_normal(tuple(g['video_shape'])).astype(np.float32)
  lengths = np.asarray(g['text_lengths'])
  ids = rng.integers(0, cfg.vocabulary_size,
                     size=(len(lengths), lengths.max())).astype(np.int32)
  pads = (np.arange(lengths.max())[None, :]
          >= lengths[:, None]).astype(np.float32)
  on_card = lambda a: torch.from_numpy(a).to(device)
  batch = {'video': on_card(video), 'text_token_ids': on_card(ids),
           'text_paddings': on_card(pads)}
  _lib.reset_launches()
  (loss, _), grads = train_lib.value_and_grad(train_lib.clip_loss_fn)(
      (params, objectives.init_temperature_state('infonce', device=device)),
      batch, cfg, impl='kernel')
  torch.cuda.synchronize()
  check(_lib.LAUNCHES['fused_attention_bwd'] > 0
        and _lib.CTX_LAUNCHES['fused_attention_bwd'] > 0
        and _lib.LAUNCHES['fused_attention'] > 0,
        f'the tiny CLIP step did not run K7 both ways: {dict(_lib.LAUNCHES)}')
  errs = {'loss': abs(loss.item() - float(g['loss']))}
  for name, grad in _grad_leaves(grads):
    group = name.strip('/').split('/')[0]
    err = (grad.float().cpu() - torch.from_numpy(g[f'grad{name}'])).abs()
    errs[group] = max(errs.get(group, 0.0), err.max().item())
  for group, err in errs.items():
    atol = INT8_GOLDEN_RATIO * float(g[f'bf16_twin_err_{group}'])
    print(f'[train-golden] tiny config {group}, bf16 kernels vs JAX fp32: '
          f'max abs err {err:.4g} (atol {atol:.4g}, 3x the bf16 twin\'s)')
    check(err <= atol, f'train golden mismatch in {group}')


def phase_times(device, model, params, clip_model, clip_params, vc_runs,
                int8_runs, smi: str) -> None:
  for b in (1, 8):
    video = _video(b, device, seed=10 + b)
    for impl in ('kernel', 'reference'):
      ms = cuda_ms(lambda: model.apply(params, video, impl=impl),
                   warmup=2, iters=10 if impl == 'kernel' else 3)
      print(f'[times] encoder B={b} {impl}: {ms:.3f} ms/forward, '
            f'{1000.0 * b / ms:.2f} clips/s ({smi})')
  for b in (1, 8):
    video, text = _video(b, device, seed=40 + b), _text(b, device, 50 + b)
    for impl in ('kernel', 'reference'):
      ms = cuda_ms(lambda: clip_model.apply(clip_params, video, *text,
                                            impl=impl),
                   warmup=2 if impl == 'kernel' else 1,
                   iters=10 if impl == 'kernel' else 2)
      print(f'[times] clip video+text B={b} {impl}: {ms:.3f} ms/request, '
            f'{1000.0 * b / ms:.2f} requests/s ({smi})')
    torch.cuda.empty_cache()
  for label, (vc_model, vc_params), batches in vc_runs:
    for b in batches:
      video = _vc_video(b, device, seed=70 + b)
      for impl in ('kernel', 'reference'):
        ms = cuda_ms(lambda: vc_model.apply(vc_params, video, impl=impl),
                     warmup=2 if impl == 'kernel' else 1,
                     iters=10 if impl == 'kernel' else 2)
        print(f'[times] {label} B={b} {impl}: {ms:.3f} ms/forward, '
              f'{1000.0 * b / ms:.2f} clips/s ({smi})')
      torch.cuda.empty_cache()
  # int8 (kernel path): the encoders per forward, CLIP per video + text
  # request.
  for label, run, batches, make_video in int8_runs:
    for b in batches:
      args = (make_video(b, device, seed=90 + b),)
      if 'clip' in label:
        args += _text(b, device, 95 + b)
      ms = cuda_ms(lambda: run(*args), warmup=2, iters=10)
      print(f'[times] {label} B={b} kernel: {ms:.3f} ms/request, '
            f'{1000.0 * b / ms:.2f} clips/s ({smi})')
      torch.cuda.empty_cache()


def main() -> int:
  name, smi = phase_device()
  device = torch.device('cuda', 0)
  phase_build()
  host_breakdown(device)
  print_device_parts(device)
  if sys.argv[1:] == ['--host']:
    return 0
  phase_gemm(device)
  phase_gemm_i8(device)
  record = phase_kernels(device)
  phase_gate(device)
  model, params, encoder_launches = phase_model(device)
  phase_golden(device)
  clip_model, clip_params, clip_launches = phase_clip(device)
  phase_clip_golden(device)
  *vc, vc_launches, _ = phase_vc(device, 'videoprism_vc_v1_large', (1, 2, 8),
                                 'vc')
  *giant, giant_launches, giant_tree = phase_vc(
      device, 'videoprism_vc_v1_giant', (1, 2), 'vc-giant')
  phase_vc_golden(device)
  os.makedirs(os.path.join(ROOT, 'build'), exist_ok=True)
  with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, 'build')) as tmp:
    int8, int8_launches = phase_int8(device, tmp, model, params)
    int8_clip, int8_clip_launches = phase_int8_clip(device, tmp, clip_model,
                                                    clip_params)
  int8_giant, int8_giant_launches = phase_int8_giant(
      device, giant_tree, giant[1]['encoder'])
  del giant_tree
  phase_int8_golden(device)
  train_launches, train_given_stats = phase_train(device, smi)
  phase_train_golden(device)
  phase_times(device, model, params, clip_model, clip_params,
              (('vc large', vc, (1, 8)), ('vc giant', giant, (1,))),
              (('int8 encoder', int8, (1, 8), _video),
               ('int8 clip video+text', int8_clip, (1, 8), _video),
               ('int8 giant encoder', int8_giant, (1,), _vc_video)), smi)
  kernels = []
  for (k, var), rec in record.items():
    source, replaces = KERNELS[k]
    if var is None:
      by_path = {'encoder': encoder_launches.get(k, 0),
                 'clip': clip_launches.get(k, 0),
                 'vc': vc_launches.get(k, 0),
                 'vc-giant': giant_launches.get(k, 0),
                 'int8-encoder': int8_launches.get(k, 0),
                 'int8-clip': int8_clip_launches.get(k, 0),
                 'int8-giant': int8_giant_launches.get(k, 0),
                 'train': train_launches.get(k, 0)}
    else:   # only the train step runs K7 given K5's statistics
      by_path = {'train': train_given_stats}
    launches = sum(by_path.values())
    check(launches > 0, f'{k} ({var or "the record"}) never launched on a '
          'path')
    kernels.append(dict(name=k, **({} if var is None else {'variant': var}),
                        route='cuda', source=source,
                        replaces=replaces, launches=launches,
                        launches_by_path=by_path,
                        max_abs_err=rec['max_abs_err'], ms=rec['ms'],
                        device_ms=rec['device_ms'],
                        plain_ms=rec['plain_ms'], bound_ms=rec['bound_ms'],
                        bound_by=rec['bound_by'],
                        library_ms=rec['library_ms'],
                        library_device_ms=rec['library_device_ms'],
                        library_layout=rec['library_layout']))
  print(smi)
  print(json.dumps({'kernels': kernels}))
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': name,
      'count': torch.cuda.device_count()}}))
  return 0


if __name__ == '__main__':
  try:
    sys.exit(main())
  except SmokeFailure as e:
    print(f'chip_smoke: FAILED: {e}', file=sys.stderr)
    sys.exit(1)
