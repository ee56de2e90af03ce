"""Drives the PyTorch port's paths on one CUDA card and checks them.

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero and prints no
result):
  1. device       the card's name, count, and nvidia-smi name / power limit;
  2. build        nvcc builds videoprism_tpu_torch/csrc for sm_90a, one
                  process per source, all at once; build time, each
                  kernel's registers, shared memory and spills, and the
                  longest sequence K1's attention core holds per head dim;
  3. kernels      every kernel against its plain twin at the shapes of the
                  encoder, CLIP and classifier paths for two requests, and
                  K1 at its capacity (ops/kernels/cases.py tolerances; K8a
                  and K8b also against their one-chunk twins); each
                  kernel's time per call (CUDA events) and on the device
                  (profiler) beside its twin's, its bound and a library
                  call's;
  4. gate         a layer at T = 1024 (past K1's capacity at H = 64) takes
                  K6 + K5 and agrees with the plain path; at giant's head
                  dim a sequence past K1's capacity raises ValueError;
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
 12. times        the encoder forward, the video + text CLIP request and the
                  large classifier's forward at 1 and 8, and the giant
                  classifier's at 1, kernel path and impl='reference', with
                  CUDA events after warm-up.
Counts of kernel launches are set to 0 before each path's phase (5, 7, 9
and 10) and read after it.  The line before the last is the per-kernel
JSON record; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

from videoprism_tpu_torch.io.checkpoints import (
    params_from_numpy,
    prepare_for_kernels,
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

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, 'tests', 'data', 'torch_port_golden.npz')
CLIP_GOLDEN = os.path.join(ROOT, 'tests', 'data',
                           'torch_port_clip_golden.npz')
VC_GOLDEN = os.path.join(ROOT, 'tests', 'data',
                         'torch_port_classifier_golden.npz')
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
}
DEVICE_KERNELS = ('ln_rows_kernel', 'gemm_bf16_kernel',
                  'capped_attention_kernel', 'flash_attention_kernel')
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


def device_ms(fn, *, iters: int) -> float:
  """Device time per call of ``fn()`` in ms: the summed durations of the
  kernels it launches, by torch.profiler, over ``iters`` calls after one
  warm-up.  Unlike :func:`cuda_ms` it leaves out the host's time between
  launches, which bounds short kernels called from Python."""
  fn()
  torch.cuda.synchronize()
  activities = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
  with torch.profiler.profile(activities=activities) as prof:
    for _ in range(iters):
      fn()
    torch.cuda.synchronize()
  total_us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
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
  kernel, spills = None, ''
  for line in build.log.splitlines():
    if 'Compiling entry function' in line:
      kernel = next((k for k in DEVICE_KERNELS if k in line), None)
      template = re.search(r'ILi(\d+)E', line)
      if kernel and template:
        kernel += f'<{template.group(1)}>'
      spills = ''
    m = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads', line)
    if m and kernel:
      spills = f'spills {m.group(1)}/{m.group(2)} B'
    m = re.search(r'Used (\d+) registers.*?(?:(\d+) bytes smem)?$', line)
    if m and kernel:
      print(f'[build] {kernel}: {m.group(1)} registers, static smem '
            f'{m.group(2) or 0} B, {spills}')
      kernel = None
  for h in (64, 88):
    print(f'[build] K1 attention core capacity at H={h}: T <= '
          f'{_lib.max_attention_t(h)}')


def _library_layer_norm(case):
  """torch.nn.functional.layer_norm on the K6 case's inputs, its (scale +
  1) folded into the weight beforehand (not timed)."""
  x, scale, bias = case.args
  weight = scale if case.kwargs['direct_scale'] else scale + 1.0
  return lambda: torch.nn.functional.layer_norm(x, (x.shape[-1],), weight,
                                                bias, 1e-6)


def phase_kernels(device) -> dict[str, dict]:
  record = {k: {'max_abs_err': 0.0} for k in KERNELS}
  for case in (cases_lib.main_path_cases(device, batch=2)
               + cases_lib.clip_path_cases(device, batch=2)
               + cases_lib.wide_path_cases(device, batch=2)
               + cases_lib.capacity_cases(device, batch=2)):
    r = cases_lib.run_case(case)
    chunked = ''
    if 'differ_chunked' in r:
      chunked = (f', elements differing from the chunked twin '
                 f'{r["differ_chunked"]:.4%} / from the one-chunk twin '
                 f'{r["differ_one_chunk"]:.4%} (max|kernel-one-chunk| '
                 f'{r["err_vs_one_chunk"]:.3g})')
    print(f'[kernels] {r["kernel"]} {r["label"]}: max|kernel-twin| '
          f'{r["max_abs_err"]:.3g}, vs fp32 twin {r["err_vs_fp32"]:.3g} '
          f'(bf16 twin {r["twin_err_vs_fp32"]:.3g}){chunked} '
          f'{"ok" if r["ok"] else "FAIL"}')
    check(r['ok'], f'{r["kernel"]} {r["label"]} disagrees with its twin '
          f'(atol=rtol={cases_lib.ATOL}, fp32 ratio '
          f'{cases_lib.FP32_ERR_RATIO}, chunk share ratio '
          f'{cases_lib.CHUNK_SHARE_RATIO})')
    rec = record[r['kernel']]
    rec['max_abs_err'] = max(rec['max_abs_err'], r['max_abs_err'])
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
  ]
  for case in timed:
    run = lambda impl: case.fn(*case.args, **case.kwargs, impl=impl)
    ms = cuda_ms(lambda: run('kernel'), warmup=3, iters=20)
    dev_ms = device_ms(lambda: run('kernel'), iters=10)
    plain_ms = cuda_ms(lambda: run('reference'), warmup=2, iters=10)
    library_ms = None
    if case.kernel == 'fused_layer_norm_2d':
      library_ms = cuda_ms(_library_layer_norm(case), warmup=3, iters=20)
    bound_ms, bound_by = cases_lib.bound(case)
    print(f'[kernels] time {case.kernel} {case.label}: kernel {ms:.4f} ms '
          f'(device {dev_ms:.4f} ms), plain twin {plain_ms:.4f} ms, library '
          f'{"none" if library_ms is None else f"{library_ms:.4f} ms"}, '
          f'bound {bound_ms:.4f} ms ({bound_by})')
    rec = record[case.kernel]
    for key, value in (('ms', ms), ('device_ms', dev_ms),
                       ('plain_ms', plain_ms),
                       ('library_ms', library_ms), ('bound_ms', bound_ms),
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


def phase_gate(device) -> None:
  """K1's capacity on the card (ROADMAP fault 3.1)."""
  cfg = transformer_lib.TransformerLayerConfig(
      num_layers=1, hidden_dim=3072, num_heads=12, activation='gelu',
      enable_per_dim_scale=False, logit_cap=50.0, dtype=torch.bfloat16)
  init = init_lib._Init(0, 0.1)
  params = prepare_for_kernels(params_from_numpy(
      {'layer': init.layer(768, cfg)}, device=device,
      dtype=torch.bfloat16))['layer']
  gen = torch.Generator(device=device).manual_seed(0)
  x = torch.randn((2, 1024, 768), generator=gen, device=device,
                  dtype=torch.bfloat16)
  pads = torch.zeros((2, 1024), device=device)
  pads[1, 900:] = 1.0
  mask = mask_lib.attention_mask_for_fprop(x, pads)
  _lib.reset_launches()
  got = transformer_lib.transformer_layer(params, x, pads, mask, cfg)
  torch.cuda.synchronize()
  routed = {k: v for k, v in _lib.LAUNCHES.items() if v}
  want = transformer_lib.transformer_layer(params, x, pads, mask, cfg,
                                           impl='reference')
  cos = cosine_per_token(got, want)
  print(f'[gate] layer at [2, 1024, 768], H=64 (K1 holds T <= '
        f'{_lib.max_attention_t(64)}): launches {routed}, min per-token '
        f'cosine vs the plain path {cos:.6f}')
  check(routed == {'fused_layer_norm_2d': 1, 'fused_attention': 1,
                   'fused_ffn_block': 1}, f'T=1024 routed to {routed}')
  check(cos >= MIN_COSINE, f'T=1024 layer cosine {cos} < {MIN_COSINE}')
  # Giant's head dim: past K1's capacity nothing takes the sequence.
  cfg = dataclasses.replace(cfg, hidden_dim=6144, num_heads=16)
  params = prepare_for_kernels(params_from_numpy(
      {'layer': init.layer(1408, cfg)}, device=device,
      dtype=torch.bfloat16))['layer']
  t = _lib.max_attention_t(88)
  x = torch.randn((1, t + 1, 1408), generator=gen, device=device,
                  dtype=torch.bfloat16)
  pads = torch.zeros((1, t + 1), device=device)
  mask = mask_lib.attention_mask_for_fprop(x, pads)
  try:
    transformer_lib.transformer_layer(params, x, pads, mask, cfg)
    raised = ''
  except ValueError as e:
    raised = str(e)
  print(f'[gate] giant-width layer at T={t + 1}, H=88: ValueError: {raised}')
  check(f'T <= {t}' in raised, 'no ValueError naming the limit past K1\'s '
        'capacity at H=88')
  out = transformer_lib.transformer_layer(params, x[:, :t], pads[:, :t],
                                          mask[..., :t], cfg)
  torch.cuda.synchronize()
  check(bool(torch.isfinite(out).all()), f'non-finite layer at T={t}, H=88')
  print(f'[gate] giant-width layer at T={t}: finite')


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
  """A classifier at full width and depth in bf16 on seeded weights."""
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
  del tree
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
  return model, params, launches


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


def phase_times(device, model, params, clip_model, clip_params, vc_runs,
                smi: str) -> None:
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


def main() -> int:
  name, smi = phase_device()
  device = torch.device('cuda', 0)
  phase_build()
  record = phase_kernels(device)
  phase_gate(device)
  model, params, encoder_launches = phase_model(device)
  phase_golden(device)
  clip_model, clip_params, clip_launches = phase_clip(device)
  phase_clip_golden(device)
  *vc, vc_launches = phase_vc(device, 'videoprism_vc_v1_large', (1, 2, 8),
                              'vc')
  *giant, giant_launches = phase_vc(device, 'videoprism_vc_v1_giant', (1, 2),
                                    'vc-giant')
  phase_vc_golden(device)
  phase_times(device, model, params, clip_model, clip_params,
              (('vc large', vc, (1, 8)), ('vc giant', giant, (1,))), smi)
  kernels = []
  for k, (source, replaces) in KERNELS.items():
    by_path = {'encoder': encoder_launches.get(k, 0),
               'clip': clip_launches.get(k, 0),
               'vc': vc_launches.get(k, 0),
               'vc-giant': giant_launches.get(k, 0)}
    launches = sum(by_path.values())
    check(launches > 0, f'{k} never launched on a path')
    rec = record[k]
    kernels.append(dict(name=k, route='cuda', source=source,
                        replaces=replaces, launches=launches,
                        launches_by_path=by_path,
                        max_abs_err=rec['max_abs_err'], ms=rec['ms'],
                        device_ms=rec['device_ms'],
                        plain_ms=rec['plain_ms'], bound_ms=rec['bound_ms'],
                        bound_by=rec['bound_by'],
                        library_ms=rec['library_ms']))
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
