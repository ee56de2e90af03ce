"""Writes tests/data/torch_port_golden.npz: the JAX encoder's fp32 output on
a tiny config, for checking videoprism_tpu_torch without JAX.

The params are the port's seeded numpy init (``numpy_factorized_encoder``,
non-zero LN scales and biases); the same numpy tree goes through the JAX
package's ``factorized_encoder.apply`` ('xla', fp32, CPU).  The file keeps
the seeds, the config and the output, so a machine without JAX rebuilds the
params and the clip and compares (``chip_smoke.py`` phase 5).

    JAX_PLATFORMS=cpu python scripts/make_torch_port_golden.py
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

CONFIG = dict(patch_size=6, pos_emb_shape=[4, 4, 4], model_dim=128,
              num_spatial_layers=2, num_temporal_layers=2, num_heads=2,
              mlp_dim=256, atten_logit_cap=50.0)
PARAM_SEED, VIDEO_SEED, NORM_BIAS_STD = 0, 1, 0.1
VIDEO_SHAPE = (2, 4, 24, 24, 3)
OUT = os.path.join(_ROOT, 'tests', 'data', 'torch_port_golden.npz')


def make_golden() -> dict[str, np.ndarray]:
  import jax
  import jax.numpy as jnp

  from videoprism_tpu.models import factorized_encoder as jfe
  from videoprism_tpu_torch.models import factorized_encoder as tfe
  from videoprism_tpu_torch.models import init as tinit

  cfg = dict(CONFIG, pos_emb_shape=tuple(CONFIG['pos_emb_shape']))
  tree = tinit.numpy_factorized_encoder(
      PARAM_SEED, tfe.FactorizedEncoderConfig(**cfg),
      norm_bias_std=NORM_BIAS_STD)
  video = np.random.default_rng(VIDEO_SEED).standard_normal(
      VIDEO_SHAPE).astype(np.float32)
  out, _ = jfe.apply(jax.tree.map(jnp.asarray, tree), jnp.asarray(video),
                     jfe.FactorizedEncoderConfig(**cfg))
  return {
      'config': np.array(json.dumps(CONFIG)),
      'param_seed': np.array(PARAM_SEED),
      'video_seed': np.array(VIDEO_SEED),
      'norm_bias_std': np.array(NORM_BIAS_STD),
      'video_shape': np.array(VIDEO_SHAPE),
      'output': np.asarray(out, np.float32),
  }


def main() -> None:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--out', default=OUT, help='npz path to write')
  args = parser.parse_args()
  np.savez_compressed(args.out, **make_golden())
  print(f'wrote {args.out} ({os.path.getsize(args.out)} bytes)')


if __name__ == '__main__':
  main()
