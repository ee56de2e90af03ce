"""K5's plain twin (videoprism_tpu_torch.ops.kernels.flash_attention) against
the JAX package's Pallas ``fused_attention`` in interpret mode and its
composed ``_dot_atten_head_major``, fp32 on the CPU (atol 1e-5, the ops
tolerance of ROADMAP.md); and ``multi_head_attention(impl='flash')``, which
routes through it, against the JAX package's.

The same seeded numpy inputs go to both.  Masks are [B|1, T|1, S] with
ragged key padding and fully masked rows, whose outputs are uniform over
all S keys on both sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videoprism_tpu.ops import attention as jattn
from videoprism_tpu.ops.pallas import flash_attention as jflash
from videoprism_tpu_torch.ops import attention as tattn
from videoprism_tpu_torch.ops.kernels import flash_attention as tflash
from videoprism_tpu_torch.ops.kernels import transformer_block as tb

ATOL = 1e-5
NEG = np.float32(tb.NEG_INF)


def _inputs(b, n, t, s, h, mask_kind, seed=0):
  rng = np.random.default_rng(seed)
  q = (rng.standard_normal((b, n, t, h)) * 3.0 / np.sqrt(h)).astype(
      np.float32)
  k = rng.standard_normal((b, n, s, h)).astype(np.float32)
  v = rng.standard_normal((b, n, s, h)).astype(np.float32)
  if mask_kind == 'keys':      # [B, 1, S]: ragged padding, one sequence all
    lengths = np.array([s - 37] + [0] * (b - 1))
    mask = (np.arange(s)[None, :] >= lengths[:, None])[:, None, :] * NEG
  else:                        # [B, T, S]: causal, a block of masked rows
    masked = np.broadcast_to(
        np.arange(s)[None, None, :] > np.arange(t)[None, :, None],
        (b, t, s)).copy()
    masked[-1, :20] = True
    mask = masked * NEG
  return q, k, v, mask.astype(np.float32)


@pytest.mark.parametrize('cap', [50.0, 0.0])
@pytest.mark.parametrize('mask_kind', ['keys', 'rows'])
def test_twin_matches_pallas_kernel(cap, mask_kind):
  q, k, v, mask = _inputs(2, 2, 128, 256, 32, mask_kind)
  want = jflash.fused_attention(
      jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
      logit_cap=cap, interpret=True)
  got = tflash.fused_attention(*map(torch.from_numpy, (q, k, v, mask)),
                               logit_cap=cap)
  assert got.dtype == torch.float32 and tuple(got.shape) == q.shape
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                             rtol=0)
  if mask_kind == 'keys':    # fully masked rows: uniform over all S keys
    np.testing.assert_allclose(got.numpy()[1], np.broadcast_to(
        v[1].mean(1, keepdims=True), got.shape[1:]), atol=ATOL, rtol=0)


@pytest.mark.parametrize('cap', [50.0, 0.0])
def test_twin_matches_composed_attention(cap):
  """Against the JAX package's composed head-major attention, which takes
  the 4-D mask [B|1, 1, T|1, S]."""
  q, k, v, mask = _inputs(3, 2, 40, 72, 16, 'rows', seed=1)
  want = jattn._dot_atten_head_major(
      jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
      jnp.asarray(mask[:, None]), logit_cap=cap)
  got = tflash.fused_attention(*map(torch.from_numpy, (q, k, v, mask)),
                               logit_cap=cap)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                             rtol=0)


def test_supports_is_the_jax_gate():
  for t, s in ((128, 128), (4096, 4096), (256, 128), (1, 4096), (128, 64),
               (16, 16), (65, 65), (128, 200), (0, 128)):
    assert tflash.supports(t, s) == jflash.supports(t, s), (t, s)


def _mha_params(d, n, h, seed):
  rng = np.random.default_rng(seed)
  w = lambda *shape: (rng.standard_normal(shape) / np.sqrt(shape[0])).astype(
      np.float32)
  b = lambda *shape: (0.1 * rng.standard_normal(shape)).astype(np.float32)
  return {'query': {'w': w(d, n, h), 'b': b(n, h)},
          'key': {'w': w(d, n, h), 'b': b(n, h)},
          'value': {'w': w(d, n, h), 'b': b(n, h)},
          'post': {'w': w(d, n, h), 'b': b(d)}}


def _tree(fn, tree):
  return {k: _tree(fn, v) if isinstance(v, dict) else fn(v)
          for k, v in tree.items()}


@pytest.mark.parametrize('t', [128, 72])
def test_multi_head_attention_flash_matches_jax(t):
  """impl='flash': K5 (its twin here) where the gate takes the shape
  (T = 128), the composed core elsewhere (T = 72), as the JAX package."""
  d, n, h = 48, 3, 16
  params = _mha_params(d, n, h, seed=2)
  x = np.random.default_rng(3).standard_normal((2, t, d)).astype(np.float32)
  pads = np.zeros((2, t), np.float32)
  pads[1, t // 2:] = 1.0
  mask = (pads * NEG)[:, None, None, :]
  kw = dict(hidden_dim=d, num_heads=n, logit_cap=50.0,
            enable_per_dim_scale=False)
  want = jattn.multi_head_attention(
      _tree(jnp.asarray, params), *(jnp.asarray(x),) * 3, jnp.asarray(mask),
      impl='flash', interpret=True, **kw)
  tx = torch.from_numpy(x)
  got = tattn.multi_head_attention(
      _tree(torch.from_numpy, params), tx, tx, tx, torch.from_numpy(mask),
      impl='flash', **kw)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                             rtol=0)
  xla = tattn.multi_head_attention(
      _tree(torch.from_numpy, params), tx, tx, tx, torch.from_numpy(mask),
      impl='xla', **kw)
  np.testing.assert_allclose(got.numpy(), xla.numpy(), atol=2e-5, rtol=0)


def test_dispatch_on_the_cpu():
  q, k, v, mask = map(torch.from_numpy, _inputs(1, 1, 8, 8, 16, 'rows'))
  auto = tflash.fused_attention(q, k, v, mask, logit_cap=50.0)
  ref = tflash.fused_attention(q, k, v, mask, logit_cap=50.0,
                               impl='reference')
  assert torch.equal(auto, ref)
  with pytest.raises(ValueError, match='CUDA'):
    tflash.fused_attention(q, k, v, mask, impl='kernel')
  # On the card K5 and K7 zero-pad a head dim off a multiple of 8 (12 ->
  # 16) and slice their outputs back: on the twins, the same function.
  q, k, v, mask = map(torch.from_numpy, _inputs(2, 2, 24, 24, 12, 'rows'))
  do = torch.from_numpy(np.random.default_rng(5).standard_normal(
      q.shape).astype(np.float32))
  pad = tflash._pad
  assert pad(q).shape[-1] == 16
  for got, want in (
      ((tflash.fused_attention(pad(q), pad(k), pad(v), mask,
                               logit_cap=50.0),),
       (tflash.fused_attention(q, k, v, mask, logit_cap=50.0),)),
      (tflash.fused_attention_bwd(pad(q), pad(k), pad(v), mask, pad(do),
                                  logit_cap=50.0, with_ctx=True),
       tflash.fused_attention_bwd(q, k, v, mask, do, logit_cap=50.0,
                                  with_ctx=True))):
    for g, w in zip(got, want):
      np.testing.assert_allclose(g[..., :12].numpy(), w.numpy(), atol=1e-6,
                                 rtol=0)
  with pytest.raises(ValueError, match="'xla' or 'flash'"):
    tattn.multi_head_attention({}, q, q, q, mask, hidden_dim=16,
                               num_heads=1, impl='pallas')
