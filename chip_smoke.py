"""Drives the PyTorch port's main path on one CUDA card and checks it.

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero and prints no
result):
  1. device   the card's name, count, and nvidia-smi name / power limit;
  2. build    nvcc builds videoprism_tpu_torch/csrc for sm_90a; build time
              and each kernel's registers, shared memory and spills;
  3. kernels  every kernel against its plain twin at the base encoder's
              shapes for two clips (ops/kernels/cases.py tolerances), and
              each kernel's time beside its twin's;
  4. model    get_model('videoprism_public_v1_base') in bf16 with seeded
              random weights answers three requests (1, 2 and 8 clips of
              16x288x288x3) through the kernels: [B, 4096, 768], finite,
              16/16/1/1 launches of K1/K2/K3/K4 per forward; the 2-clip
              output against impl='reference' in bf16 and in fp32;
  5. golden   the tiny config of tests/data/torch_port_golden.npz through
              the kernels in bf16 against the JAX package's fp32 output;
  6. times    the full forward, kernel path and impl='reference', at 1 and
              8 clips, with CUDA events after warm-up.
The line before the last is the per-kernel JSON record; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

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
from videoprism_tpu_torch.models import factorized_encoder as fe
from videoprism_tpu_torch.models import init as init_lib
from videoprism_tpu_torch.models import registry
from videoprism_tpu_torch.ops.kernels import _lib
from videoprism_tpu_torch.ops.kernels import cases as cases_lib

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, 'tests', 'data', 'torch_port_golden.npz')
# Per-token cosine to the reference that every model-level check demands.
MIN_COSINE = 0.999
# Golden, bf16 kernels vs the JAX fp32 output: the outputs are post-LN with
# |max| ~4.3, where one bf16 ulp is 0.03; four layers of bf16 rounding put
# the bf16 twin at 0.033 max error on the CPU.  0.1 leaves 3x margin.
GOLDEN_ATOL = 0.1
FRAMES, SIZE = 16, 288

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
}
DEVICE_KERNELS = ('ln_rows_kernel', 'gemm_bf16_kernel',
                  'capped_attention_kernel')
PER_FORWARD = {'fused_attention_block': 16, 'fused_ffn_block': 16,
               'spatial_to_temporal': 1, 'temporal_to_output': 1}


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


def cosine_per_token(a: torch.Tensor, b: torch.Tensor) -> float:
  return torch.nn.functional.cosine_similarity(
      a.float(), b.float(), dim=-1).min().item()


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
      kernel = next(k for k in DEVICE_KERNELS if k in line)
      spills = ''
    m = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads', line)
    if m and kernel:
      spills = f'spills {m.group(1)}/{m.group(2)} B'
    m = re.search(r'Used (\d+) registers.*?(?:(\d+) bytes smem)?$', line)
    if m and kernel:
      print(f'[build] {kernel}: {m.group(1)} registers, static smem '
            f'{m.group(2) or 0} B, {spills}')
      kernel = None
  for t in (256, 16):
    print(f'[build] capped_attention_kernel at T={t}, H=64: dynamic smem '
          f'{_lib.library().vp_attention_smem_bytes(t, 64)} B')


def phase_kernels(device) -> dict[str, dict]:
  record = {k: {'max_abs_err': 0.0} for k in KERNELS}
  for case in cases_lib.main_path_cases(device, batch=2):
    r = cases_lib.run_case(case)
    print(f'[kernels] {r["kernel"]} {r["label"]}: max|kernel-twin| '
          f'{r["max_abs_err"]:.3g}, vs fp32 twin {r["err_vs_fp32"]:.3g} '
          f'(bf16 twin {r["twin_err_vs_fp32"]:.3g}) '
          f'{"ok" if r["ok"] else "FAIL"}')
    check(r['ok'], f'{r["kernel"]} {r["label"]} disagrees with its twin '
          f'(atol=rtol={cases_lib.ATOL}, fp32 ratio '
          f'{cases_lib.FP32_ERR_RATIO})')
    rec = record[r['kernel']]
    rec['max_abs_err'] = max(rec['max_abs_err'], r['max_abs_err'])
  # Times at the main path's shapes for two clips; the JSON record takes
  # each kernel's first shape (K1: the spatial stack's).
  timed = [
      cases_lib.attention_case(32, 256, 768, 12, 64, cap=50.0, padded=False,
                               device=device),
      cases_lib.attention_case(512, 16, 768, 12, 64, cap=50.0, padded=False,
                               device=device),
      cases_lib.ffn_case(8192, 768, 3072, activation='gelu', padded=False,
                         device=device),
      *cases_lib.boundary_cases(2, 16, 256, 768, device=device),
  ]
  for case in timed:
    run = lambda impl: case.fn(*case.args, **case.kwargs, impl=impl)
    ms = cuda_ms(lambda: run('kernel'), warmup=3, iters=20)
    plain_ms = cuda_ms(lambda: run('reference'), warmup=2, iters=10)
    print(f'[kernels] time {case.kernel} {case.label}: kernel {ms:.4f} ms, '
          f'plain twin {plain_ms:.4f} ms')
    record[case.kernel].setdefault('ms', ms)
    record[case.kernel].setdefault('plain_ms', plain_ms)
  return record


def _video(b: int, device, seed: int) -> torch.Tensor:
  gen = torch.Generator(device=device).manual_seed(seed)
  return torch.rand((b, FRAMES, SIZE, SIZE, 3), generator=gen, device=device)


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
    per = {k: _lib.LAUNCHES[k] - before.get(k, 0) for k in PER_FORWARD}
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


def phase_times(device, model, params, smi: str) -> None:
  for b in (1, 8):
    video = _video(b, device, seed=10 + b)
    for impl in ('kernel', 'reference'):
      ms = cuda_ms(lambda: model.apply(params, video, impl=impl),
                   warmup=2, iters=10 if impl == 'kernel' else 3)
      print(f'[times] B={b} {impl}: {ms:.3f} ms/forward, '
            f'{1000.0 * b / ms:.2f} clips/s ({smi})')


def main() -> int:
  name, smi = phase_device()
  device = torch.device('cuda', 0)
  phase_build()
  record = phase_kernels(device)
  model, params, launches = phase_model(device)
  phase_golden(device)
  phase_times(device, model, params, smi)
  kernels = []
  for k, (source, replaces) in KERNELS.items():
    check(launches.get(k, 0) > 0, f'{k} never launched on the main path')
    kernels.append(dict(name=k, route='cuda', source=source,
                        replaces=replaces, launches=launches[k],
                        max_abs_err=record[k]['max_abs_err'],
                        ms=record[k]['ms'], plain_ms=record[k]['plain_ms']))
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
