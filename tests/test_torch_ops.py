"""videoprism_tpu_torch.ops (masks, basic, embeddings, attention) against
the JAX package's functions, fp32 on the CPU, atol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videoprism_tpu.ops import attention as jattn
from videoprism_tpu.ops import basic as jbasic
from videoprism_tpu.ops import embeddings as jemb
from videoprism_tpu.ops import masks as jmasks
from videoprism_tpu_torch.ops import attention as tattn
from videoprism_tpu_torch.ops import basic as tbasic
from videoprism_tpu_torch.ops import embeddings as temb
from videoprism_tpu_torch.ops import masks as tmasks

ATOL = 1e-5


def _rng(seed=0):
  return np.random.default_rng(seed)


def _np(x):
  return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor) else x)


def _close(got, want, atol=ATOL):
  np.testing.assert_allclose(_np(got), np.asarray(want), atol=atol, rtol=0)


def _paddings(rng, b, t):
  pads = np.zeros((b, t), np.float32)
  pads[0, t // 2:] = 1.0
  pads[-1] = 1.0
  return pads


class TestMasks:

  @pytest.mark.parametrize('tdtype,jdtype', [
      (torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16),
      (torch.int32, jnp.int32)])
  def test_large_negative_number(self, tdtype, jdtype):
    got = tmasks.get_large_negative_number(tdtype)
    want = jmasks.get_large_negative_number(jdtype)
    assert got.dtype == tdtype
    np.testing.assert_allclose(float(got), float(want), rtol=1e-7)

  def test_paddings_to_mask_and_apply(self):
    rng = _rng(1)
    pads = _paddings(rng, 3, 8)
    logits = rng.standard_normal((3, 2, 8, 8)).astype(np.float32)
    tm = tmasks.paddings_to_mask(torch.from_numpy(pads))
    jm = jmasks.paddings_to_mask(jnp.asarray(pads))
    assert tuple(tm.shape) == (3, 1, 1, 8)
    np.testing.assert_allclose(_np(tm), np.asarray(jm), rtol=1e-7)
    _close(tmasks.apply_mask_to_logits(torch.from_numpy(logits), tm),
           jmasks.apply_mask_to_logits(jnp.asarray(logits), jm))

  @pytest.mark.parametrize('causal', [False, True])
  def test_attention_mask_for_fprop(self, causal):
    rng = _rng(2)
    x = rng.standard_normal((3, 8, 4)).astype(np.float32)
    pads = _paddings(rng, 3, 8)
    got = tmasks.attention_mask_for_fprop(
        torch.from_numpy(x), torch.from_numpy(pads), causal_attention=causal)
    want = jmasks.attention_mask_for_fprop(
        jnp.asarray(x), jnp.asarray(pads), causal_attention=causal)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-7)

  def test_causal_mask_and_merge(self):
    np.testing.assert_allclose(_np(tmasks.causal_mask(6)),
                               np.asarray(jmasks.causal_mask(6)), rtol=1e-7)
    pads = _paddings(_rng(3), 2, 6)
    a = tmasks.paddings_to_mask(torch.from_numpy(pads))
    b = tmasks.causal_mask(6)
    want = jmasks.merge_masks(jmasks.paddings_to_mask(jnp.asarray(pads)),
                              jmasks.causal_mask(6))
    np.testing.assert_allclose(_np(tmasks.merge_masks(a, b)),
                               np.asarray(want), rtol=1e-7)


class TestBasic:

  @pytest.mark.parametrize('kwargs', [{}, {'direct_scale': True}])
  def test_layer_norm(self, kwargs):
    rng = _rng(4)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32) * 3 + 1
    params = {'scale': rng.standard_normal(32).astype(np.float32) * 0.1,
              'bias': rng.standard_normal(32).astype(np.float32) * 0.1}
    got = tbasic.layer_norm(
        {k: torch.from_numpy(v) for k, v in params.items()},
        torch.from_numpy(x), **kwargs)
    want = jbasic.layer_norm(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x),
        impl='xla', **kwargs)
    _close(got, want)

  @pytest.mark.parametrize('name', ['gelu', 'relu', 'identity'])
  def test_activations(self, name):
    x = np.linspace(-6, 6, 401, dtype=np.float32)
    _close(tbasic.ACTIVATIONS[name](torch.from_numpy(x)),
           jbasic.ACTIVATIONS[name](jnp.asarray(x)))

  @pytest.mark.parametrize('activation', ['gelu', 'relu', 'identity'])
  def test_dense_and_feed_forward(self, activation):
    rng = _rng(5)
    x = rng.standard_normal((2, 3, 16)).astype(np.float32)
    p = {'linear': {'kernel': rng.standard_normal((16, 24)).astype(np.float32),
                    'bias': rng.standard_normal(24).astype(np.float32)}}
    tp = {'linear': {k: torch.from_numpy(v) for k, v in p['linear'].items()}}
    jp = {'linear': {k: jnp.asarray(v) for k, v in p['linear'].items()}}
    _close(tbasic.dense(tp['linear'], torch.from_numpy(x)),
           jbasic.dense(jp['linear'], jnp.asarray(x)))
    _close(tbasic.feed_forward(tp, torch.from_numpy(x), activation=activation),
           jbasic.feed_forward(jp, jnp.asarray(x), activation=activation))

  def test_per_dim_scale_and_l2_normalize(self):
    rng = _rng(6)
    x = rng.standard_normal((2, 3, 4, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32)
    _close(tbasic.per_dim_scale({'per_dim_scale': torch.from_numpy(w)},
                                torch.from_numpy(x)),
           jbasic.per_dim_scale({'per_dim_scale': jnp.asarray(w)},
                                jnp.asarray(x)))
    _close(tbasic.l2_normalize(torch.from_numpy(x)),
           jbasic.l2_normalize(jnp.asarray(x)))

  def test_cast_floating(self):
    x = torch.zeros(3)
    assert tbasic.cast_floating(x, torch.bfloat16).dtype == torch.bfloat16
    ids = torch.zeros(3, dtype=torch.int32)
    assert tbasic.cast_floating(ids, torch.bfloat16) is ids
    assert tbasic.cast_floating(None, torch.float32) is None


class TestEmbeddings:

  @pytest.mark.parametrize('shape,patch', [((2, 12, 12, 3), 6),
                                           ((2, 3, 18, 18, 3), 6),
                                           ((1, 16, 8, 2), 4)])
  def test_image_to_patch(self, shape, patch):
    x = _rng(7).standard_normal(shape).astype(np.float32)
    got = temb.image_to_patch(torch.from_numpy(x), patch)
    want = jemb.image_to_patch(jnp.asarray(x), patch)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(_np(got), np.asarray(want))

  @pytest.mark.parametrize('src,dst', [(16, 8), (16, 5), (4, 16), (8, 11),
                                       (3, 1)])
  def test_interpolate_1d_up_and_down(self, src, dst):
    emb = _rng(8).standard_normal((1, src, 8)).astype(np.float32)
    _close(temb.interpolate_emb_1d(torch.from_numpy(emb), dst),
           jemb.interpolate_emb_1d(jnp.asarray(emb), dst))

  @pytest.mark.parametrize('src,dst', [((16, 16), (8, 8)), ((4, 4), (7, 5)),
                                       ((6, 6), (4, 9))])
  def test_interpolate_2d_up_and_down(self, src, dst):
    emb = _rng(9).standard_normal((1, src[0] * src[1], 8)).astype(np.float32)
    _close(temb.interpolate_emb_2d(torch.from_numpy(emb), src, dst),
           jemb.interpolate_emb_2d(jnp.asarray(emb), src, dst))

  @pytest.mark.parametrize('lookup_style', ['matmul', 'index'])
  def test_trainable_positional_embedding(self, lookup_style):
    emb = _rng(10).standard_normal((16, 8)).astype(np.float32)
    got = temb.trainable_positional_embedding(
        {'emb_var': torch.from_numpy(emb)}, 12)
    want = jemb.trainable_positional_embedding(
        {'emb_var': jnp.asarray(emb)}, 12, lookup_style=lookup_style)
    _close(got, want)


class TestAttention:

  @pytest.mark.parametrize('cap', [0.0, 50.0])
  @pytest.mark.parametrize('per_dim_scale', [False, True])
  def test_multi_head_attention(self, cap, per_dim_scale):
    rng = _rng(11)
    d, n, h, b, t = 32, 2, 16, 2, 8
    p = {name: {'w': rng.standard_normal((d, n, h)).astype(np.float32) * 0.3,
                'b': rng.standard_normal((n, h)).astype(np.float32) * 0.1}
         for name in ('query', 'key', 'value')}
    p['post'] = {'w': rng.standard_normal((d, n, h)).astype(np.float32) * 0.3,
                 'b': rng.standard_normal(d).astype(np.float32) * 0.1}
    p['per_dim_scale'] = {
        'per_dim_scale': rng.standard_normal(h).astype(np.float32)}
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    pads = _paddings(rng, b, t)
    kw = dict(hidden_dim=d, num_heads=n, logit_cap=cap,
              enable_per_dim_scale=per_dim_scale)
    tp = jax.tree.map(torch.from_numpy, p)
    tx = torch.from_numpy(x)
    got = tattn.multi_head_attention(
        tp, tx, tx, tx, tmasks.paddings_to_mask(torch.from_numpy(pads)), **kw)
    jx = jnp.asarray(x)
    want = jattn.multi_head_attention(
        jax.tree.map(jnp.asarray, p), jx, jx, jx,
        jmasks.paddings_to_mask(jnp.asarray(pads)), **kw)
    _close(got, want)

  def test_dot_atten_and_projection(self):
    rng = _rng(12)
    q, k, v = (rng.standard_normal((2, 6, 2, 8)).astype(np.float32)
               for _ in range(3))
    mask = np.zeros((2, 1, 1, 6), np.float32)
    mask[1, ..., 3:] = -0.7 * np.finfo(np.float32).max
    got, got_p = tattn.dot_atten(*map(torch.from_numpy, (q, k, v, mask)),
                                 logit_cap=5.0)
    want, want_p = jattn.dot_atten(*map(jnp.asarray, (q, k, v, mask)),
                                   logit_cap=5.0)
    _close(got, want)
    _close(got_p, want_p)
    w = {'w': rng.standard_normal((8, 2, 8)).astype(np.float32),
         'b': rng.standard_normal(8).astype(np.float32)}
    _close(tattn.attention_projection(
               jax.tree.map(torch.from_numpy, w), torch.from_numpy(q),
               is_output_projection=True),
           jattn.attention_projection(
               jax.tree.map(jnp.asarray, w), jnp.asarray(q),
               is_output_projection=True), atol=5e-5)
