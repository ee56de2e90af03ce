"""Where the time of one forward of the PyTorch port goes, on a CUDA card.

Builds ``videoprism_public_v1_base`` (or, with ``--model``, the CLIP model
``videoprism_lvt_public_v1_base``, answering video + text requests of 64
token ids, or the 400-way classifier ``videoprism_vc_v1_large`` /
``videoprism_vc_v1_giant`` on 8-frame clips) in bf16 with seeded random
weights, warms up, then traces
forwards with ``torch.profiler`` and prints the device time per kernel
name, the share of each, and the device's idle share (wall time of the
traced forwards minus the device time of their kernels, over the wall
time).  ``--quantize int8`` quantizes the seeded fp32 weights for the
W8A8 kernels (K9-K12b) first: every transformer layer's (a classifier's
pooler and head stay float).  ``--train`` traces train steps of the CLIP
model instead (``make_train_step``: forward, autograd backward through the
kernels' Functions and K7, AdamW on fp32 master weights) and also sums the
device time by kind: the hand-written kernels, library GEMMs (the
backwards' products) and the rest (elementwise, reductions, the
optimizer).

    python scripts/profile_torch_forward.py --batch 8 [--impl reference] \
        [--model videoprism_lvt_public_v1_base | videoprism_vc_v1_large] \
        [--quantize int8] [--train]
"""

from __future__ import annotations

import argparse
import collections
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from videoprism_tpu_torch import quantization  # noqa: E402
from videoprism_tpu_torch.io.checkpoints import (  # noqa: E402
    params_from_numpy,
    prepare_for_kernels,
)
from videoprism_tpu_torch.models import init as init_lib  # noqa: E402
from videoprism_tpu_torch.models import registry  # noqa: E402
from videoprism_tpu_torch.train import train_step as train_lib  # noqa: E402

# Device kernels of csrc/ (the rest are PyTorch's and its libraries').
HAND_WRITTEN = ('ln_rows_kernel', 'ln_rows_stream_kernel', 'gemm_bf16_kernel',
                'capped_attention_kernel', 'resident_attention_kernel',
                'flash_attention_kernel',
                'flash_bwd_query_kernel', 'flash_bwd_key_kernel',
                'quant_rows_kernel', 'quant_rows_f32_kernel',
                'quant_rows_stream_kernel', 'gemm_i8_kernel')


def _kind(name: str) -> str:
  if any(k in name for k in HAND_WRITTEN):
    return 'hand-written kernels'
  if any(k in name.lower() for k in ('gemm', 'xmma', 'cutlass', 'cublas',
                                     'nvjet')):
    return 'library GEMMs'
  return 'other (elementwise, reductions, copies)'


def main() -> None:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--model', default='videoprism_public_v1_base',
                      choices=('videoprism_public_v1_base',
                               'videoprism_lvt_public_v1_base',
                               'videoprism_vc_v1_large',
                               'videoprism_vc_v1_giant'))
  parser.add_argument('--batch', type=int, default=8)
  parser.add_argument('--impl', default='kernel',
                      choices=('kernel', 'reference'))
  parser.add_argument('--iters', type=int, default=3)
  parser.add_argument('--top', type=int, default=12)
  parser.add_argument('--quantize', choices=('int8',), default=None)
  parser.add_argument('--train', action='store_true',
                      help='trace train steps of the CLIP model')
  args = parser.parse_args()
  if args.train:
    args.model = 'videoprism_lvt_public_v1_base'

  if not torch.cuda.is_available():
    sys.exit('profile_torch_forward: needs a CUDA device')

  device = torch.device('cuda', 0)
  if args.model.startswith('videoprism_vc'):
    model = getattr(registry, args.model)(registry.K400_NUM_CLASSES,
                                          dtype=torch.bfloat16)
    frames = model.config.encoder.pos_emb_shape[0]
  else:
    model = registry.get_model(args.model, fprop_dtype=torch.bfloat16)
    frames = 16
  if args.train:
    params = model.init(0, device=device, norm_bias_std=0.1)['params']
  elif args.quantize:
    init = (init_lib.numpy_video_clip if model.is_clip else
            init_lib.numpy_video_classifier if model.is_classifier else
            init_lib.numpy_factorized_encoder)
    params = prepare_for_kernels(params_from_numpy(
        quantization.quantize_for_serving(
            init(0, model.config, norm_bias_std=0.1)),
        device=device, dtype=torch.bfloat16))
  else:
    params = prepare_for_kernels(
        model.init(0, device=device, norm_bias_std=0.1)['params'])
  gen = torch.Generator(device=device).manual_seed(0)
  video = torch.rand((args.batch, frames, 288, 288, 3), generator=gen,
                     device=device)
  text = ()
  if model.is_clip:
    ids = torch.randint(0, model.config.vocabulary_size, (args.batch, 64),
                        generator=gen, device=device)
    lengths = torch.randint(1, 65, (args.batch, 1), generator=gen,
                            device=device)
    text = (ids, (torch.arange(64, device=device) >= lengths).float())
  forward = lambda: model.apply(params, video, *text, impl=args.impl)
  if args.train:
    opt = train_lib.make_optimizer(learning_rate=1e-4, warmup_steps=1,
                                   total_steps=100)
    state = [train_lib.create_train_state(0, model.config, opt,
                                          pretrained_params=params,
                                          device=device)]
    step = train_lib.make_train_step(model.config, opt, impl=args.impl)
    batch = {'video': video, 'text_token_ids': text[0],
             'text_paddings': text[1]}
    del params

    def forward():
      state[0], _ = step(state[0], batch)
  for _ in range(2):
    forward()
  torch.cuda.synchronize()

  activities = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
  with torch.profiler.profile(activities=activities) as prof:
    start = time.perf_counter()
    for _ in range(args.iters):
      forward()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - start) * 1000.0 / args.iters

  per_kernel = collections.defaultdict(lambda: [0, 0.0])
  for evt in prof.events():
    if evt.device_type == torch.autograd.DeviceType.CUDA:
      per_kernel[evt.name][0] += 1
      per_kernel[evt.name][1] += evt.time_range.elapsed_us() / 1000.0
  device_ms = sum(ms for _, ms in per_kernel.values()) / args.iters
  smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                        '--format=csv,noheader'], capture_output=True,
                       text=True, check=False).stdout.strip()
  unit = 'train step' if args.train else 'forward'
  print(f'{smi}; {args.model}{" int8" if args.quantize else ""} '
        f'B={args.batch} impl={args.impl}: wall '
        f'{wall_ms:.3f} ms/{unit} (host clock, profiler on), device '
        f'{device_ms:.3f} ms, '
        f'idle share {max(0.0, 1.0 - device_ms / wall_ms):.3f}')
  if args.train:
    kinds = collections.Counter()
    for name, (_, ms) in per_kernel.items():
      kinds[_kind(name)] += ms / args.iters
    for kind, ms in kinds.most_common():
      print(f'  {ms:9.3f} ms  {100.0 * ms / device_ms:5.1f} %  {kind}')
  ranked = sorted(per_kernel.items(), key=lambda kv: -kv[1][1])
  for name, (calls, ms) in ranked[:args.top]:
    print(f'  {ms / args.iters:9.3f} ms  {100.0 * ms / args.iters / device_ms:5.1f} %'
          f'  {calls // args.iters:4d} calls  {name[:100]}')


if __name__ == '__main__':
  main()
