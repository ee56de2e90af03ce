"""Writes tests/data/torch_port_classifier_golden.npz: the JAX video
classifier's fp32 logits and global embeddings on a tiny config, for
checking videoprism_tpu_torch without JAX.

The params are the port's seeded numpy init (``numpy_video_classifier``,
non-zero LN scales and biases); the same numpy tree and clip go through the
JAX package's ``classifier.apply`` ('xla', fp32, CPU).  The file keeps the
seeds, the config and the outputs, so a machine without JAX rebuilds the
params and the clip and compares (``chip_smoke.py`` [vc-golden]).  The
width is 64, which is not a multiple of 128, so the reference's plan
chains the FFN in 2 F-slices (K8b on the card), as at the large width.

    JAX_PLATFORMS=cpu python scripts/make_torch_classifier_golden.py
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

ENCODER = dict(patch_size=6, pos_emb_shape=[4, 4, 4], model_dim=64,
               num_spatial_layers=2, num_temporal_layers=2, num_heads=2,
               mlp_dim=128, atten_logit_cap=50.0)
NUM_CLASSES = 10
PARAM_SEED, VIDEO_SEED, NORM_BIAS_STD = 0, 1, 0.1
VIDEO_SHAPE = (2, 4, 24, 24, 3)
OUT = os.path.join(_ROOT, 'tests', 'data', 'torch_port_classifier_golden.npz')


def encoder_kwargs(config: dict) -> dict:
  """The stored encoder config as FactorizedEncoderConfig keywords."""
  return dict(config, pos_emb_shape=tuple(config['pos_emb_shape']))


def make_golden() -> dict[str, np.ndarray]:
  import jax
  import jax.numpy as jnp

  from videoprism_tpu.models import classifier as jvc
  from videoprism_tpu.models import factorized_encoder as jfe
  from videoprism_tpu_torch.models import classifier as tvc
  from videoprism_tpu_torch.models import factorized_encoder as tfe
  from videoprism_tpu_torch.models import init as tinit

  kw = encoder_kwargs(ENCODER)
  tree = tinit.numpy_video_classifier(
      PARAM_SEED, tvc.VideoClassifierConfig(tfe.FactorizedEncoderConfig(**kw),
                                            NUM_CLASSES),
      norm_bias_std=NORM_BIAS_STD)
  video = np.random.default_rng(VIDEO_SEED).standard_normal(
      VIDEO_SHAPE).astype(np.float32)
  logits, outs = jvc.apply(
      jax.tree.map(jnp.asarray, tree), jnp.asarray(video),
      jvc.VideoClassifierConfig(jfe.FactorizedEncoderConfig(**kw),
                                NUM_CLASSES),
      return_intermediate=('global_embeddings',))
  return {
      'config': np.array(json.dumps(ENCODER)),
      'num_classes': np.array(NUM_CLASSES),
      'param_seed': np.array(PARAM_SEED),
      'video_seed': np.array(VIDEO_SEED),
      'norm_bias_std': np.array(NORM_BIAS_STD),
      'video_shape': np.array(VIDEO_SHAPE),
      'logits': np.asarray(logits, np.float32),
      'global_embeddings': np.asarray(outs['global_embeddings'], np.float32),
  }


def main() -> None:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--out', default=OUT, help='npz path to write')
  args = parser.parse_args()
  np.savez_compressed(args.out, **make_golden())
  print(f'wrote {args.out} ({os.path.getsize(args.out)} bytes)')


if __name__ == '__main__':
  main()
