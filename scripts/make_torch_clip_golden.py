"""Writes tests/data/torch_port_clip_golden.npz: the JAX CLIP model's fp32
embeddings on a tiny config, for checking videoprism_tpu_torch without JAX.

The params are the port's seeded numpy init (``numpy_video_clip``, non-zero
LN scales and biases); the same numpy tree, clip and text go through the
JAX package's ``clip.apply`` ('xla', fp32, CPU).  The file keeps the seeds,
the config, the text lengths and the outputs, so a machine without JAX
rebuilds the params and inputs and compares (``chip_smoke.py``
[clip-golden]).  The clip has 8 frames of 12 x 12 patches, so the
auxiliary encoder sees 1152 tokens: more than K1 takes, a multiple of 128,
so on the card it runs K6 and K5 as lvt base's 4096 tokens do.

It also writes tests/data/torch_port_train_golden.npz: on the same params
and inputs, the JAX package's fp32 InfoNCE loss and its gradient
(``train_step.clip_loss_fn`` under ``jax.value_and_grad``, 'xla', CPU),
one array per leaf (``grad/<path>``, ``grad/log_temperature``), and the
largest error of the port's bf16 path on the CPU (the kernels' twins
forward, the hand-written backwards) per leaf group (the params' top-level
keys, ``log_temperature`` and the loss), which ``chip_smoke.py``
[train-golden] scales into its tolerance.

    JAX_PLATFORMS=cpu python scripts/make_torch_clip_golden.py
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

CONFIG = dict(patch_size=6, pos_emb_shape=[8, 12, 12], num_spatial_layers=1,
              num_temporal_layers=1, mlp_dim=128, num_auxiliary_layers=2,
              vocabulary_size=128, enable_causal_atten=True,
              num_unimodal_layers=2, model_dim=64, num_heads=2,
              atten_logit_cap=50.0)
PARAM_SEED, INPUT_SEED, NORM_BIAS_STD = 0, 1, 0.1
VIDEO_SHAPE = (2, 8, 72, 72, 3)
TEXT_LENGTHS = (16, 5)   # real tokens per row of the [2, 16] ids
OUT = os.path.join(_ROOT, 'tests', 'data', 'torch_port_clip_golden.npz')
TRAIN_OUT = os.path.join(_ROOT, 'tests', 'data', 'torch_port_train_golden.npz')


def make_inputs(input_seed: int = INPUT_SEED, video_shape=VIDEO_SHAPE,
                lengths=TEXT_LENGTHS, vocabulary_size: int = 128):
  """(video, ids, paddings) as numpy, drawn in this order from one
  generator (``chip_smoke.py`` draws them the same way)."""
  rng = np.random.default_rng(input_seed)
  video = rng.standard_normal(video_shape).astype(np.float32)
  text_len = max(lengths)
  ids = rng.integers(0, vocabulary_size,
                     size=(len(lengths), text_len)).astype(np.int32)
  pads = (np.arange(text_len)[None, :]
          >= np.asarray(lengths)[:, None]).astype(np.float32)
  return video, ids, pads


def make_golden() -> dict[str, np.ndarray]:
  import jax
  import jax.numpy as jnp

  from videoprism_tpu.models import clip as jclip
  from videoprism_tpu_torch.models import clip as tclip
  from videoprism_tpu_torch.models import init as tinit

  cfg = dict(CONFIG, pos_emb_shape=tuple(CONFIG['pos_emb_shape']))
  tree = tinit.numpy_video_clip(PARAM_SEED, tclip.VideoCLIPConfig(**cfg),
                                norm_bias_std=NORM_BIAS_STD)
  video, ids, pads = make_inputs(
      vocabulary_size=CONFIG['vocabulary_size'])
  video_emb, text_emb, outs = jclip.apply(
      jax.tree.map(jnp.asarray, tree), jnp.asarray(video), jnp.asarray(ids),
      jnp.asarray(pads), jclip.VideoCLIPConfig(**cfg),
      return_intermediate=('frame_embeddings',))
  return {
      'config': np.array(json.dumps(CONFIG)),
      'param_seed': np.array(PARAM_SEED),
      'input_seed': np.array(INPUT_SEED),
      'norm_bias_std': np.array(NORM_BIAS_STD),
      'video_shape': np.array(VIDEO_SHAPE),
      'text_lengths': np.array(TEXT_LENGTHS),
      'video_embeddings': np.asarray(video_emb, np.float32),
      'text_embeddings': np.asarray(text_emb, np.float32),
      'frame_embeddings': np.asarray(outs['frame_embeddings'], np.float32),
  }


def _leaves(tree, prefix=''):
  for k, v in tree.items():
    if isinstance(v, dict):
      yield from _leaves(v, f'{prefix}/{k}')
    else:
      yield f'{prefix}/{k}', v


def make_train_golden() -> dict[str, np.ndarray]:
  import jax
  import jax.numpy as jnp
  import torch

  from videoprism_tpu.models import clip as jclip
  from videoprism_tpu.train import train_step as jts
  from videoprism_tpu_torch.io.checkpoints import params_from_numpy
  from videoprism_tpu_torch.models import clip as tclip
  from videoprism_tpu_torch.models import init as tinit
  from videoprism_tpu_torch.train import objectives as tobj
  from videoprism_tpu_torch.train import train_step as tts

  cfg = dict(CONFIG, pos_emb_shape=tuple(CONFIG['pos_emb_shape']))
  tree = tinit.numpy_video_clip(PARAM_SEED, tclip.VideoCLIPConfig(**cfg),
                                norm_bias_std=NORM_BIAS_STD)
  video, ids, pads = make_inputs(vocabulary_size=CONFIG['vocabulary_size'])
  temp = tobj.init_temperature_state('infonce')
  (loss, _), (grads, dtemp) = jax.value_and_grad(
      jts.clip_loss_fn, has_aux=True)(
          (jax.tree.map(jnp.asarray, tree), jnp.asarray(temp.numpy())),
          {'video': jnp.asarray(video), 'text_token_ids': jnp.asarray(ids),
           'text_paddings': jnp.asarray(pads)},
          jclip.VideoCLIPConfig(**cfg), jax.random.PRNGKey(0), 'infonce')
  out = {
      'config': np.array(json.dumps(CONFIG)),
      'param_seed': np.array(PARAM_SEED),
      'input_seed': np.array(INPUT_SEED),
      'norm_bias_std': np.array(NORM_BIAS_STD),
      'video_shape': np.array(VIDEO_SHAPE),
      'text_lengths': np.array(TEXT_LENGTHS),
      'loss': np.asarray(loss, np.float32),
      'grad/log_temperature': np.asarray(dtemp, np.float32),
  }
  for name, g in _leaves(grads):
    out[f'grad{name}'] = np.asarray(g, np.float32)

  (tloss, _), (tgrads, tdtemp) = tts.value_and_grad(tts.clip_loss_fn)(
      (params_from_numpy(tree, device='cpu'), temp),
      {'video': torch.from_numpy(video), 'text_token_ids':
       torch.from_numpy(ids), 'text_paddings': torch.from_numpy(pads)},
      tclip.VideoCLIPConfig(**cfg, dtype=torch.bfloat16))
  errs = {'loss': abs(float(tloss) - float(loss)),
          'log_temperature': abs(float(tdtemp) - float(dtemp))}
  for name, g in _leaves(tgrads):
    group = name.split('/')[1]
    err = float(np.abs(g.float().numpy() - out[f'grad{name}']).max())
    errs[group] = max(errs.get(group, 0.0), err)
  for group, err in errs.items():
    out[f'bf16_twin_err_{group}'] = np.array(err, np.float32)
  return out


def main() -> None:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--out', default=OUT, help='npz path to write')
  parser.add_argument('--train-out', default=TRAIN_OUT,
                      help='npz path of the train golden')
  args = parser.parse_args()
  np.savez_compressed(args.out, **make_golden())
  print(f'wrote {args.out} ({os.path.getsize(args.out)} bytes)')
  np.savez_compressed(args.train_out, **make_train_golden())
  print(f'wrote {args.train_out} ({os.path.getsize(args.train_out)} bytes)')


if __name__ == '__main__':
  main()
