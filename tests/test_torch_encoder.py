"""The whole factorized encoder of videoprism_tpu_torch against the JAX
package's ``factorized_encoder.apply`` at a tiny size, fp32 on the CPU.

The same numpy param tree (the port's seeded init, non-zero LN scales and
biases) drives both.  Tolerance: atol 2e-5, the JAX kernel tests' gate.
Both JAX paths are held: 'xla' (composed) and 'flash' with the Pallas
kernels in interpret mode.

Fully padded frames are compared only where they are real tokens: the JAX
package packs short sequences eight to a 128-row block with a
block-diagonal mask (ops/transformer.py stacked_transformer), so a fully
masked sequence there attends uniformly over the whole pack, where the
unpacked reference (and the port) attend uniformly over the sequence
itself.  Only the padded tokens' own values differ.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videoprism_tpu.models import factorized_encoder as jfe
from videoprism_tpu_torch.models import factorized_encoder as tfe
from videoprism_tpu_torch.models import init as tinit
from videoprism_tpu_torch.io.checkpoints import (
    params_from_numpy,
    prepare_for_kernels,
)
from videoprism_tpu_torch.ops.kernels import _lib

ATOL = 2e-5
TINY = dict(patch_size=6, pos_emb_shape=(4, 4, 4), model_dim=128,
            num_spatial_layers=2, num_temporal_layers=2, num_heads=2,
            mlp_dim=256, atten_logit_cap=50.0)
B, FRAMES, SIZE = 2, 4, 24


def _configs(**overrides):
  kw = {**TINY, **overrides}
  return jfe.FactorizedEncoderConfig(**kw), tfe.FactorizedEncoderConfig(**kw)


def _jax_cfg(jcfg, impl):
  if impl == 'flash':
    return dataclasses.replace(jcfg, attention_impl='flash',
                               kernel_interpret=True)
  return jcfg


@pytest.fixture(scope='module')
def tree():
  _, tcfg = _configs()
  return tinit.numpy_factorized_encoder(0, tcfg, norm_bias_std=0.1)


def _video(seed, frames=FRAMES, size=SIZE):
  rng = np.random.default_rng(seed)
  return rng.standard_normal((B, frames, size, size, 3)).astype(np.float32)


def _frame_paddings():
  pads = np.zeros((B, FRAMES), np.float32)
  pads[0, -1] = 1.0
  return pads


def _real(x, frame_paddings, frames=FRAMES):
  """The tokens of unpadded frames of a [B, T*N, D] or [B, T, N, D] output."""
  x = np.asarray(x).reshape(B, frames, -1, x.shape[-1])
  if frame_paddings is None:
    return x
  return x[frame_paddings == 0]


def _both(tree, video, jcfg, tcfg, frame_paddings=None, **kwargs):
  jp = jax.tree.map(jnp.asarray, tree)
  want, wouts = jfe.apply(
      jp, jnp.asarray(video), jcfg,
      frame_paddings=(None if frame_paddings is None
                      else jnp.asarray(frame_paddings)), **kwargs)
  got, gouts = tfe.apply(
      prepare_for_kernels(params_from_numpy(tree, device='cpu')),
      torch.from_numpy(video), tcfg,
      frame_paddings=(None if frame_paddings is None
                      else torch.from_numpy(frame_paddings)), **kwargs)
  return got, gouts, want, wouts


@pytest.mark.parametrize('impl', ['xla', 'flash'])
@pytest.mark.parametrize('padded', [False, True])
def test_apply_matches_jax(tree, impl, padded):
  jcfg, tcfg = _configs()
  _lib.reset_launches()
  pads = _frame_paddings() if padded else None
  got, _, want, _ = _both(tree, _video(1), _jax_cfg(jcfg, impl), tcfg,
                          frame_paddings=pads)
  assert tuple(got.shape) == want.shape == (B, FRAMES * 16, 128)
  assert bool(torch.isfinite(got).all())
  np.testing.assert_allclose(_real(got, pads), _real(want, pads), atol=ATOL,
                             rtol=0)
  assert sum(_lib.LAUNCHES.values()) == 0


@pytest.mark.parametrize('impl', ['xla', 'flash'])
def test_spatial_features_intermediate(tree, impl):
  jcfg, tcfg = _configs()
  pads = _frame_paddings()
  got, gouts, want, wouts = _both(
      tree, _video(2), _jax_cfg(jcfg, impl), tcfg, frame_paddings=pads,
      return_intermediate=('spatial_features',))
  np.testing.assert_allclose(_real(got, pads), _real(want, pads), atol=ATOL,
                             rtol=0)
  np.testing.assert_allclose(_real(gouts['spatial_features'], pads),
                             _real(wouts['spatial_features'], pads),
                             atol=ATOL, rtol=0)


@pytest.mark.parametrize('frames,size', [(2, 24), (4, 18), (6, 30)])
def test_resized_pos_emb(tree, frames, size):
  """Fewer or more frames, smaller or larger grids: pos-emb resize down/up."""
  jcfg, tcfg = _configs()
  got, _, want, _ = _both(tree, _video(3, frames, size), jcfg, tcfg)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_encode_spatial_then_temporal(tree):
  jcfg, tcfg = _configs()
  video, pads = _video(4), _frame_paddings()
  jp = jax.tree.map(jnp.asarray, tree)
  tp = params_from_numpy(tree, device='cpu')
  want_s = jfe.encode_spatial(jp, jnp.asarray(video), jcfg,
                              frame_paddings=jnp.asarray(pads))
  got_s = tfe.encode_spatial(tp, torch.from_numpy(video), tcfg,
                             frame_paddings=torch.from_numpy(pads))
  np.testing.assert_allclose(_real(got_s, pads), _real(want_s, pads),
                             atol=ATOL, rtol=0)
  want = jfe.encode_temporal(jp, want_s, jcfg,
                             frame_paddings=jnp.asarray(pads))
  got = tfe.encode_temporal(tp, got_s, tcfg,
                            frame_paddings=torch.from_numpy(pads))
  np.testing.assert_allclose(_real(got, pads), _real(want, pads), atol=ATOL,
                             rtol=0)


def test_encode_with_patches(tree):
  jcfg, tcfg = _configs()
  rng = np.random.default_rng(5)
  patches = rng.standard_normal((B * FRAMES, 16, 108)).astype(np.float32)
  want, _ = jfe.encode_with_patches(jax.tree.map(jnp.asarray, tree),
                                    jnp.asarray(patches), (FRAMES, 24, 24),
                                    jcfg)
  got, _ = tfe.encode_with_patches(params_from_numpy(tree, device='cpu'),
                                   torch.from_numpy(patches),
                                   (FRAMES, 24, 24), tcfg)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_unstacked_layers(tree):
  """scan=False: per-layer ``x_layers_{i}`` trees."""
  jcfg, tcfg = _configs(scan=False)
  unstacked = tinit.numpy_factorized_encoder(0, tcfg, norm_bias_std=0.1)
  stack = unstacked['spatial_encoder']['transformers_stack']
  assert sorted(stack) == ['x_layers_0', 'x_layers_1']
  got, _, want, _ = _both(unstacked, _video(6), jcfg, tcfg)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_bf16_twin_stays_near_fp32(tree):
  """The served dtype on the CPU twins: per-token cosine to fp32 >= 0.999."""
  _, tcfg = _configs()
  video = torch.from_numpy(_video(7))
  want, _ = tfe.apply(params_from_numpy(tree, device='cpu'), video, tcfg)
  got, _ = tfe.apply(
      params_from_numpy(tree, device='cpu', dtype=torch.bfloat16), video,
      dataclasses.replace(tcfg, dtype=torch.bfloat16))
  assert got.dtype == torch.bfloat16
  cos = torch.nn.functional.cosine_similarity(got.float(), want, dim=-1)
  assert cos.min().item() >= 0.999
