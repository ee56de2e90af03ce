"""Writes tests/data/torch_port_int8_golden.npz: the JAX package's fp32
outputs of two tiny int8 (W8A8) configs, for checking videoprism_tpu_torch's
int8 kernels without JAX.

The params are the port's seeded numpy init with non-zero LN scales and
biases, quantized by ``videoprism_tpu_torch.quantization`` (bit for bit the
JAX package's ``quantize_for_serving``).  The same int8 tree and inputs go
through the JAX package with ``attention_impl='flash'`` and its int8
kernels in interpret mode (fp32, CPU):

  clip     an lvt model of width 128 whose encoder and causal text tower
           take K11 and whose auxiliary encoder, over 1152 tokens, takes
           K12a + K5 + K12b and K9;
  encoder  a factorized encoder of width 128 with F = 192, which the
           reference's layer kernel refuses (F % 128), so both stacks take
           K10 + K9; one frame of the first clip is padded and only the real
           tokens are kept.

The file keeps the seeds, configs and outputs, and the max abs error of
the port's bf16 twins (CPU) against each output, from which
``chip_smoke.py`` [int8-golden] sets its tolerance (3x).

    JAX_PLATFORMS=cpu python scripts/make_torch_int8_golden.py
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

CLIP_CONFIG = dict(patch_size=6, pos_emb_shape=[8, 12, 12],
                   num_spatial_layers=1, num_temporal_layers=1, mlp_dim=256,
                   num_auxiliary_layers=1, vocabulary_size=128,
                   num_unimodal_layers=1, model_dim=128, num_heads=2,
                   atten_logit_cap=50.0)
ENCODER_CONFIG = dict(patch_size=6, pos_emb_shape=[4, 4, 4], model_dim=128,
                      num_spatial_layers=2, num_temporal_layers=1,
                      num_heads=2, mlp_dim=192, atten_logit_cap=50.0)
PARAM_SEED, INPUT_SEED, NORM_BIAS_STD = 0, 7, 0.1
CLIP_VIDEO_SHAPE = (2, 8, 72, 72, 3)
TEXT_LENGTHS = (16, 5)
ENCODER_VIDEO_SHAPE = (2, 4, 24, 24, 3)
FRAME_PADDINGS = ((0, 0, 0, 1), (0, 0, 0, 0))
OUT = os.path.join(_ROOT, 'tests', 'data', 'torch_port_int8_golden.npz')


def _config(cfg: dict) -> dict:
  return dict(cfg, pos_emb_shape=tuple(cfg['pos_emb_shape']))


def make_inputs(input_seed: int = INPUT_SEED):
  """(clip video, ids, text paddings, encoder video, frame paddings, real
  token mask [2, 64]) as numpy, drawn in this order from one generator."""
  rng = np.random.default_rng(input_seed)
  video = rng.standard_normal(CLIP_VIDEO_SHAPE).astype(np.float32)
  text_len = max(TEXT_LENGTHS)
  ids = rng.integers(0, CLIP_CONFIG['vocabulary_size'],
                     (len(TEXT_LENGTHS), text_len)).astype(np.int32)
  pads = (np.arange(text_len)[None, :]
          >= np.asarray(TEXT_LENGTHS)[:, None]).astype(np.float32)
  enc_video = rng.standard_normal(ENCODER_VIDEO_SHAPE).astype(np.float32)
  frame_pads = np.asarray(FRAME_PADDINGS, np.float32)
  tokens = (ENCODER_CONFIG['pos_emb_shape'][1]
            * ENCODER_CONFIG['pos_emb_shape'][2])
  real = np.repeat(1 - frame_pads, tokens, axis=1).astype(bool)
  return video, ids, pads, enc_video, frame_pads, real


def int8_trees(param_seed: int = PARAM_SEED,
               norm_bias_std: float = NORM_BIAS_STD):
  """The seeded numpy int8 trees of the CLIP and encoder configs."""
  from videoprism_tpu_torch import quantization
  from videoprism_tpu_torch.models import clip as tclip
  from videoprism_tpu_torch.models import factorized_encoder as tfe
  from videoprism_tpu_torch.models import init as tinit

  clip_tree = tinit.numpy_video_clip(
      param_seed, tclip.VideoCLIPConfig(**_config(CLIP_CONFIG)),
      norm_bias_std=norm_bias_std)
  enc_tree = tinit.numpy_factorized_encoder(
      param_seed, tfe.FactorizedEncoderConfig(**_config(ENCODER_CONFIG)),
      norm_bias_std=norm_bias_std)
  return (quantization.quantize_for_serving(clip_tree),
          quantization.quantize_for_serving(enc_tree))


def jax_outputs() -> dict[str, np.ndarray]:
  """The JAX package's fp32 outputs, int8 kernels in interpret mode."""
  import jax
  import jax.numpy as jnp

  from videoprism_tpu.models import clip as jclip
  from videoprism_tpu.models import factorized_encoder as jfe

  clip_tree, enc_tree = int8_trees()
  video, ids, pads, enc_video, frame_pads, real = make_inputs()
  tree = lambda t: jax.tree.map(jnp.asarray, t)
  kernels = dict(attention_impl='flash', kernel_interpret=True)
  video_emb, text_emb, _ = jclip.apply(
      tree(clip_tree), jnp.asarray(video), jnp.asarray(ids),
      jnp.asarray(pads),
      jclip.VideoCLIPConfig(**_config(CLIP_CONFIG), **kernels))
  tokens, _ = jfe.apply(
      tree(enc_tree), jnp.asarray(enc_video),
      jfe.FactorizedEncoderConfig(**_config(ENCODER_CONFIG), **kernels),
      frame_paddings=jnp.asarray(frame_pads))
  return {'video_embeddings': np.asarray(video_emb, np.float32),
          'text_embeddings': np.asarray(text_emb, np.float32),
          'encoder_tokens': np.asarray(tokens, np.float32)[real]}


def port_outputs(dtype) -> dict[str, np.ndarray]:
  """The port's outputs on the CPU (its plain twins) in ``dtype``."""
  import torch

  from videoprism_tpu_torch.io.checkpoints import (
      params_from_numpy,
      prepare_for_kernels,
  )
  from videoprism_tpu_torch.models import clip as tclip
  from videoprism_tpu_torch.models import factorized_encoder as tfe

  clip_tree, enc_tree = int8_trees()
  video, ids, pads, enc_video, frame_pads, real = make_inputs()
  params = lambda t: prepare_for_kernels(
      params_from_numpy(t, device='cpu', dtype=dtype))
  t = torch.from_numpy
  video_emb, text_emb, _ = tclip.apply(
      params(clip_tree), t(video), t(ids), t(pads),
      tclip.VideoCLIPConfig(**_config(CLIP_CONFIG), dtype=dtype))
  tokens, _ = tfe.apply(
      params(enc_tree), t(enc_video),
      tfe.FactorizedEncoderConfig(**_config(ENCODER_CONFIG), dtype=dtype),
      frame_paddings=t(frame_pads))
  return {'video_embeddings': video_emb.float().numpy(),
          'text_embeddings': text_emb.float().numpy(),
          'encoder_tokens': tokens.float().numpy()[real]}


def make_golden() -> dict[str, np.ndarray]:
  import torch

  want = jax_outputs()
  twin = port_outputs(torch.bfloat16)
  out = {
      'clip_config': np.array(json.dumps(CLIP_CONFIG)),
      'encoder_config': np.array(json.dumps(ENCODER_CONFIG)),
      'param_seed': np.array(PARAM_SEED),
      'input_seed': np.array(INPUT_SEED),
      'norm_bias_std': np.array(NORM_BIAS_STD),
  }
  for key, value in want.items():
    out[key] = value
    out[f'bf16_twin_err_{key}'] = np.array(
        np.abs(twin[key] - value).max(), np.float32)
  return out


def main() -> None:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--out', default=OUT, help='npz path to write')
  args = parser.parse_args()
  golden = make_golden()
  np.savez_compressed(args.out, **golden)
  print(f'wrote {args.out} ({os.path.getsize(args.out)} bytes); bf16 twin '
        'errors: ' + ', '.join(f'{k[14:]} {float(v):.4g}'
                               for k, v in golden.items()
                               if k.startswith('bf16_twin_err_')))


if __name__ == '__main__':
  main()
