"""K1/K2 twins of videoprism_tpu_torch against the JAX package's Pallas
kernels (interpret mode) and its composed path, on the CPU.

fp32: atol 2e-5, the gate of the JAX kernel tests (tests/test_fused_blocks.py).
bf16: both sides round to bf16 at the same points; they differ in summation
order and in the TPU kernel's polynomial erf, so they are compared in fp32
with atol = rtol = 2e-2, a few bf16 ulps at the outputs' magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videoprism_tpu.ops import attention as jattn
from videoprism_tpu.ops import basic as jbasic
from videoprism_tpu.ops import transformer as jtfm
from videoprism_tpu.ops.pallas import transformer_block as jtb
from videoprism_tpu_torch import quantization as tq
from videoprism_tpu_torch.io.checkpoints import (
    params_from_numpy,
    prepare_for_kernels,
)
from videoprism_tpu_torch.ops import transformer as ttfm
from videoprism_tpu_torch.ops.kernels import _lib
from videoprism_tpu_torch.ops.kernels import int8_blocks as ti8
from videoprism_tpu_torch.ops.kernels import transformer_block as ttb

D, N, H, F, T, B = 128, 2, 64, 256, 16, 4
NEG = -0.7 * float(np.finfo(np.float32).max)


def _layer(seed, D=D, N=N, H=H, F=F):
  """Numpy params of one 'pre' layer with non-zero LN scales and biases."""
  rng = np.random.default_rng(seed)
  w = lambda *s: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
  small = lambda *s: (0.1 * rng.standard_normal(s)).astype(np.float32)
  ln = lambda: {'scale': small(D), 'bias': small(D)}
  proj = lambda: {'w': w(D, N, H), 'b': small(N, H)}
  return {
      'layer_norm': ln(),
      'self_attention': {'query': proj(), 'key': proj(), 'value': proj(),
                         'post': {'w': w(D, N, H), 'b': small(D)}},
      'ff_layer': {'layer_norm': ln(),
                   'ffn_layer1': {'linear': {'kernel': w(D, F),
                                             'bias': small(F)}},
                   'ffn_layer2': {'linear': {'kernel': w(F, D),
                                             'bias': small(D)}}},
  }


def _paddings(rng, b, t, padded):
  pads = np.zeros((b, t), np.float32)
  if padded:
    pads[0, t - 5:] = 1.0
    pads[1, 3:] = 1.0
    pads[-1] = 1.0          # one fully masked sequence
  return pads


def _attention_args(p):
  """JAX kernel operands and the port's fused operands, both numpy."""
  a = p['self_attention']
  flat = lambda n: (a[n]['w'].reshape(D, N * H), a[n]['b'].reshape(N * H))
  (wq, bq), (wk, bk), (wv, bv) = flat('query'), flat('key'), flat('value')
  wo = np.transpose(a['post']['w'], (1, 2, 0)).reshape(N * H, D)
  jax_w = (wq, bq, wk, bk, wv, bv, wo, a['post']['b'])
  port_w = (np.concatenate([wq, wk, wv], 1), np.concatenate([bq, bk, bv]),
            wo, a['post']['b'])
  return jax_w, port_w


def _t(a, dtype=torch.float32):
  return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _j(a, dtype=jnp.float32):
  return jnp.asarray(a, jnp.float32).astype(dtype)


def _attention_both(seed, cap, padded, tdtype, jdtype):
  rng = np.random.default_rng(seed)
  p = _layer(seed)
  x = rng.standard_normal((B, T, D)).astype(np.float32)
  mask = _paddings(rng, B, T, padded)[:, None, :] * np.float32(NEG)
  ln = p['layer_norm']
  jax_w, port_w = _attention_args(p)
  kw = dict(num_heads=N, dim_per_head=H, logit_cap=cap, query_scale=H ** -0.5)
  got = ttb.fused_attention_block(
      _t(x, tdtype), _t(mask), _t(ln['scale'], tdtype), _t(ln['bias'], tdtype),
      *(_t(a, tdtype) for a in port_w), **kw)
  want = jtb.fused_attention_block(
      _j(x, jdtype), _j(mask), _j(ln['scale'], jdtype), _j(ln['bias'], jdtype),
      *(_j(a, jdtype) for a in jax_w), interpret=True, **kw)
  return got.float().numpy(), np.asarray(want.astype(jnp.float32)), p, x, mask


def _ffn_both(seed, activation, padded, tdtype, jdtype):
  rng = np.random.default_rng(seed)
  ff = _layer(seed)['ff_layer']
  x = rng.standard_normal((B * T, D)).astype(np.float32)
  pads = _paddings(rng, B, T, padded).reshape(B * T, 1)
  ops = (ff['layer_norm']['scale'], ff['layer_norm']['bias'],
         ff['ffn_layer1']['linear']['kernel'],
         ff['ffn_layer1']['linear']['bias'],
         ff['ffn_layer2']['linear']['kernel'],
         ff['ffn_layer2']['linear']['bias'])
  got = ttb.fused_ffn_block(_t(x, tdtype), _t(pads, tdtype),
                            *(_t(a, tdtype) for a in ops),
                            activation=activation)
  want = jtb.fused_ffn_block(_j(x, jdtype), _j(pads, jdtype),
                             *(_j(a, jdtype) for a in ops),
                             activation=activation, interpret=True)
  return got.float().numpy(), np.asarray(want.astype(jnp.float32))


class TestAttentionBlock:

  @pytest.mark.parametrize('cap', [50.0, 0.0])
  @pytest.mark.parametrize('padded', [False, True])
  def test_matches_pallas_kernel_fp32(self, cap, padded):
    got, want, *_ = _attention_both(0, cap, padded, torch.float32,
                                    jnp.float32)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)

  @pytest.mark.parametrize('cap', [50.0, 0.0])
  def test_matches_composed_jax_path_fp32(self, cap):
    got, _, p, x, mask = _attention_both(1, cap, True, torch.float32,
                                         jnp.float32)
    jp = jax.tree.map(jnp.asarray, p)
    h = jbasic.layer_norm(jp['layer_norm'], jnp.asarray(x), impl='xla')
    want = jattn.multi_head_attention(
        jp['self_attention'], h, h, h, jnp.asarray(mask)[:, None],
        hidden_dim=D, num_heads=N, logit_cap=cap, enable_per_dim_scale=False)
    want = np.asarray(want + jnp.asarray(x))
    # Fully masked sequences are uniform in both; compare all rows.
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)

  def test_matches_pallas_kernel_bf16(self):
    got, want, *_ = _attention_both(2, 50.0, True, torch.bfloat16,
                                    jnp.bfloat16)
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2)


class TestFfnBlock:

  @pytest.mark.parametrize('activation', ['gelu', 'relu'])
  @pytest.mark.parametrize('padded', [False, True])
  def test_matches_pallas_kernel_fp32(self, activation, padded):
    got, want = _ffn_both(3, activation, padded, torch.float32, jnp.float32)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)

  def test_matches_composed_jax_path_fp32(self):
    rng = np.random.default_rng(4)
    ff = _layer(4)['ff_layer']
    x = rng.standard_normal((B * T, D)).astype(np.float32)
    pads = _paddings(rng, B, T, True).reshape(B * T, 1)
    cfg = jtfm.TransformerLayerConfig(num_layers=1, hidden_dim=F,
                                      num_heads=N, activation='gelu')
    want = jtfm.transformer_ffn(jax.tree.map(jnp.asarray, ff),
                                jnp.asarray(x)[None],
                                jnp.asarray(pads).reshape(1, B * T), cfg)[0]
    ops = (ff['layer_norm']['scale'], ff['layer_norm']['bias'],
           ff['ffn_layer1']['linear']['kernel'],
           ff['ffn_layer1']['linear']['bias'],
           ff['ffn_layer2']['linear']['kernel'],
           ff['ffn_layer2']['linear']['bias'])
    got = ttb.fused_ffn_block(_t(x), _t(pads), *map(_t, ops))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)

  @pytest.mark.parametrize('activation', ['gelu', 'relu'])
  def test_matches_pallas_kernel_bf16(self, activation):
    got, want = _ffn_both(5, activation, True, torch.bfloat16, jnp.bfloat16)
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2)


class TestDispatch:

  def _attention_inputs(self):
    p = _layer(6)
    _, port_w = _attention_args(p)
    x = torch.zeros((1, T, D))
    mask = torch.zeros((1, 1, T))
    ln = p['layer_norm']
    return (x, mask, _t(ln['scale']), _t(ln['bias']),
            *map(_t, port_w)), dict(num_heads=N, dim_per_head=H)

  def test_kernel_impl_on_cpu_raises_and_counts_nothing(self):
    args, kw = self._attention_inputs()
    _lib.reset_launches()
    with pytest.raises(ValueError, match='CUDA'):
      ttb.fused_attention_block(*args, **kw, impl='kernel')
    with pytest.raises(ValueError, match='CUDA'):
      ttb.fused_ffn_block(torch.zeros(4, D), torch.zeros(4, 1),
                          *(torch.zeros(s) for s in
                            ((D,), (D,), (D, F), (F,), (F, D), (D,))),
                          impl='kernel')
    ttb.fused_attention_block(*args, **kw)
    ttb.fused_attention_block(*args, **kw, impl='reference')
    assert sum(_lib.LAUNCHES.values()) == 0

  def test_unknown_impl_and_partial_out_raise(self):
    args, kw = self._attention_inputs()
    with pytest.raises(ValueError, match='impl'):
      ttb.fused_attention_block(*args, **kw, impl='triton')
    with pytest.raises(NotImplementedError):
      ttb.fused_attention_block(*args, **kw, partial_out=True)


class TestTransformerLayer:

  @pytest.mark.parametrize('per_dim_scale', [False, True])
  def test_layer_matches_jax_xla_path(self, per_dim_scale):
    rng = np.random.default_rng(7)
    p = _layer(7)
    if per_dim_scale:
      p['self_attention']['per_dim_scale'] = {
          'per_dim_scale': (0.1 * rng.standard_normal(H)).astype(np.float32)}
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    pads = _paddings(rng, B, T, True)
    kw = dict(num_layers=1, hidden_dim=F, num_heads=N, activation='gelu',
              enable_per_dim_scale=per_dim_scale, logit_cap=50.0)
    jcfg = jtfm.TransformerLayerConfig(**kw)
    want = jtfm.transformer_layer(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), jnp.asarray(pads),
        jtfm.mask_lib.attention_mask_for_fprop(jnp.asarray(x),
                                               jnp.asarray(pads)), jcfg)
    tcfg = ttfm.TransformerLayerConfig(**kw)
    tx, tp = torch.from_numpy(x), torch.from_numpy(pads)
    got = ttfm.transformer_layer(
        jax.tree.map(torch.from_numpy, p), tx, tp,
        ttfm.mask_lib.attention_mask_for_fprop(tx, tp), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)
    if not per_dim_scale:
      _check_padded_head_dim()

  def test_other_norm_policies_raise(self):
    cfg = ttfm.TransformerLayerConfig(num_layers=1, hidden_dim=F, num_heads=N,
                                      norm_policy='primer_hybrid')
    x = torch.zeros((1, T, D))
    with pytest.raises(NotImplementedError, match='ROADMAP'):
      ttfm.transformer_layer({}, x, None, torch.zeros((1, 1, 1, T)), cfg)


def _check_padded_head_dim():
  """A layer of 4 heads of 36, a head dim off a multiple of 8:
  prepare_for_kernels pads each head to 40 with zeros.  The prepared layer
  (twins) matches the JAX package's xla path in fp32 to 2e-5; K1's twin
  and K10's on the padded layout give the unpadded one's outputs to 1e-6
  (K10's [K, N] weights against the padded K-major operands; measured
  bitwise equal, the zeros adding exact zeros)."""
  n, h, d, f = 4, 36, 144, 288
  hp = ttb.padded_head_dim(h)
  rng = np.random.default_rng(11)
  p = _layer(11, D=d, N=n, H=h, F=f)
  x = rng.standard_normal((B, T, d)).astype(np.float32)
  pads = _paddings(rng, B, T, True)
  kw = dict(num_layers=1, hidden_dim=f, num_heads=n, activation='gelu',
            enable_per_dim_scale=False, logit_cap=50.0)
  want = jtfm.transformer_layer(
      jax.tree.map(jnp.asarray, p), jnp.asarray(x), jnp.asarray(pads),
      jtfm.mask_lib.attention_mask_for_fprop(jnp.asarray(x),
                                             jnp.asarray(pads)),
      jtfm.TransformerLayerConfig(**kw))
  tx, tp = torch.from_numpy(x), torch.from_numpy(pads)
  mask = ttfm.mask_lib.attention_mask_for_fprop(tx, tp)
  params = prepare_for_kernels(params_from_numpy(p, device='cpu'))
  fused = params['self_attention']['fused']
  assert tuple(fused['wqkv'].shape) == (d, 3 * n * hp)
  assert tuple(fused['wo'].shape) == (n * hp, d)
  got = ttfm.transformer_layer(params, tx, tp, mask,
                               ttfm.TransformerLayerConfig(**kw))
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                             rtol=0)
  # K1's twin: the padded fused weights against the unpadded ones.
  a = p['self_attention']
  flat = lambda name: torch.from_numpy(a[name]['w'].reshape(d, n * h))
  ln = (torch.from_numpy(p['layer_norm']['scale']),
        torch.from_numpy(p['layer_norm']['bias']))
  mask3 = mask.squeeze(1).float()
  static = dict(num_heads=n, logit_cap=50.0, query_scale=h ** -0.5)
  unpadded = ttb.fused_attention_block(
      tx, mask3, *ln, torch.cat([flat(k) for k in ('query', 'key', 'value')],
                                -1),
      torch.cat([torch.from_numpy(a[k]['b'].reshape(n * h))
                 for k in ('query', 'key', 'value')]),
      flat('post').t().contiguous(), torch.from_numpy(a['post']['b']),
      dim_per_head=h, **static)
  padded = ttb.fused_attention_block(
      tx, mask3, *ln, fused['wqkv'], fused['bqkv'], fused['wo'],
      params['self_attention']['post']['b'], dim_per_head=hp, **static)
  np.testing.assert_allclose(padded.numpy(), unpadded.numpy(), atol=1e-6,
                             rtol=0)
  # K10's twin in int8: [K, N] weights against the padded K-major operands.
  q8 = params_from_numpy(tq.quantize_for_serving(p), device='cpu')
  prepared = prepare_for_kernels(q8)['self_attention']
  assert tuple(prepared['fused']['wqkv'].shape) == (3 * n * hp, d)
  assert tuple(prepared['fused']['wo'].shape) == (d, n * hp)
  a8 = q8['self_attention']
  kn = []
  for k in ('query', 'key', 'value'):
    kn += [a8[k]['w'].reshape(d, n * h), a8[k]['w_scale'].reshape(n * h),
           a8[k]['b'].reshape(n * h)]
  kn += [a8['post']['w'].flatten(-2).t(), a8['post']['w_scale'],
         a8['post']['b']]
  static = dict(static, dim_per_head=h, chunks=2)
  got_kn = ti8.int8_attention_block_chunked(tx, mask3, *ln, *kn, **static)
  got_k = ti8.int8_attention_block_chunked(
      tx, mask3, *ln, *kn, **static, kmajor=prepared['fused'])
  np.testing.assert_allclose(got_k.numpy(), got_kn.numpy(), atol=1e-6,
                             rtol=0)
