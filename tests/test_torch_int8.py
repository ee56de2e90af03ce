"""int8 (W8A8) serving of videoprism_tpu_torch against the JAX package, on
the CPU: the quantized tree, ``quant_rows``, the copied route rule and the
layer's route past the attention core's capacity, the twins of K9-K12b
against the JAX int8 kernels in interpret mode (K9 and K10 at 1 and 2
chunks), and tiny int8 encoders (K11; K10 + K9 in one chunk and in two)
and an lvt model against the JAX package's.

The quantized tree and ``quant_rows`` must be bitwise equal.  Kernels and
models:
  fp32: kernels: at least 99 % of the elements within 1e-5 and the max
        abs error at most 2e-3.  The twin and the JAX kernel differ by fp32
        ulps (the LN's reductions, exp/tanh/erf, the JAX flash kernel's
        summation order); rarely such an ulp sits on a rounding boundary
        and moves one int8 code of an activation row by one step, which
        moves every output of that row by one quantization step (measured
        9.5e-4, K12 at cap 0: one row of 256, 0.38 % of the elements).
        Models: such a step is carried on by the later layers (the
        attention spreads it over the token's sequence, the output LN
        scales it), so a model's tokens are held to 90 % of the elements
        within 1e-5 and a least per-token cosine >= 0.9999 (measured: two
        moved codes in frame 0 of the F = 192 encoder move the 8 tokens of
        two temporal sequences by up to 0.020, 5.3 % of the elements,
        cosine 0.99998), and pooled embeddings to the cosine.  The route
        each layer takes is asserted by name; a wrong chunk count (scales
        over other columns) moves most codes, far past both.
  bf16: kernels atol = rtol = 2e-2, as the bf16 kernel tests use, and
        cosine >= 0.9999; at 2 chunks also the bit-share test of
        tests/test_torch_chunked_blocks.py against the JAX chunked kernel
        (the tolerance cannot see a cast per chunk); models (several
        layers of bf16 rounding, and the reference's polynomial erf) a
        least per-token cosine >= 0.999.
Measured worst on the CPU (max abs error; fp32 share of elements off by
more than 1e-5; least cosine): fp32 K9 9.5e-7, K10 1.3e-6, K11 1.2e-6 (all
0 %), K12 9.5e-4 (0.38 %), encoder 2.0e-3 (0.87 %, 0.9999998, K11 route),
2.0e-2 (5.3 %, 0.99998, K10 + K9) and 9.5e-7 (0 %, 0.9999998, K10 + K9 at
2 chunks), lvt embeddings 5.0e-5 (0.9999999); bf16 K9 1.5e-5, K10 0
(bitwise), K11 3.9e-3, K12 1.6e-2, kernels' cosine 0.9999999, encoder
0.99996 (0.9999997 at 2 chunks), lvt 0.99997.

The cases of a family run as loops inside one test each: the suite's item
count is kept low on purpose (ROADMAP.md, "the item-count trap").
"""

import dataclasses
import itertools
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videoprism_tpu import quantization as jq
from videoprism_tpu.models import clip as jclip
from videoprism_tpu.models import factorized_encoder as jfe
from videoprism_tpu.ops.pallas import int8_blocks as ji8
from videoprism_tpu_torch import quantization as tq
from videoprism_tpu_torch.io.checkpoints import (
    params_from_numpy,
    prepare_for_kernels,
)
from videoprism_tpu_torch.models import clip as tclip
from videoprism_tpu_torch.models import factorized_encoder as tfe
from videoprism_tpu_torch.models import init as init_lib
from videoprism_tpu_torch.ops import transformer as ttfm
from videoprism_tpu_torch.ops.kernels import _lib
from videoprism_tpu_torch.ops.kernels import cases as cases_lib
from videoprism_tpu_torch.ops.kernels import int8_blocks as ti8

NEG = -0.7 * float(np.finfo(np.float32).max)
DTYPES = (('f32', torch.float32, jnp.float32),
          ('bf16', torch.bfloat16, jnp.bfloat16))


def _layer(seed, n, h, d=128, f=256):
  """Numpy params of one 'pre' layer with non-zero LN scales and biases."""
  rng = np.random.default_rng(seed)
  w = lambda *s: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
  small = lambda *s: (0.1 * rng.standard_normal(s)).astype(np.float32)
  ln = lambda: {'scale': small(d), 'bias': small(d)}
  proj = lambda: {'w': w(d, n, h), 'b': small(n, h)}
  return {
      'layer_norm': ln(),
      'self_attention': {'query': proj(), 'key': proj(), 'value': proj(),
                         'post': {'w': w(d, n, h), 'b': small(d)}},
      'ff_layer': {'layer_norm': ln(),
                   'ffn_layer1': {'linear': {'kernel': w(d, f),
                                             'bias': small(f)}},
                   'ffn_layer2': {'linear': {'kernel': w(f, d),
                                             'bias': small(d)}}},
  }


def _operands(seed, n, h, *, b=2, t=16, d=128, f=256, padded=True,
              causal=False):
  """Numpy operands of the int8 kernels in the reference's flat layout:
  weights 'w*' int8, scales 's*' and 'mask' fp32, the rest activations."""
  p = tq.quantize_for_serving({'l': _layer(seed, n, h, d, f)})['l']
  rng = np.random.default_rng(seed + 1)
  pads = np.zeros((b, t), np.float32)
  if padded:
    pads[0, t - 5:] = 1.0
    pads[-1] = 1.0          # one fully padded sequence
  if causal:
    masked = ((pads[:, :, None] + pads[:, None, :]) > 0) | (
        np.arange(t)[None, None, :] > np.arange(t)[None, :, None])
  else:
    masked = pads[:, None, :] > 0
  a, ff, nh = p['self_attention'], p['ff_layer'], n * h
  ops = {'x': rng.standard_normal((b, t, d)).astype(np.float32),
         'mask': masked.astype(np.float32) * np.float32(NEG),
         'pads': pads,
         'ln1_s': p['layer_norm']['scale'], 'ln1_b': p['layer_norm']['bias'],
         'ln2_s': ff['layer_norm']['scale'], 'ln2_b': ff['layer_norm']['bias']}
  for k, name in zip('qkv', ('query', 'key', 'value')):
    ops[f'w{k}'] = a[name]['w'].reshape(d, nh)
    ops[f's{k}'] = a[name]['w_scale'].reshape(nh)
    ops[f'b{k}'] = a[name]['b'].reshape(nh)
  ops['wo'] = a['post']['w'].transpose(1, 2, 0).reshape(nh, d)
  ops['so'], ops['bo'] = a['post']['w_scale'], a['post']['b']
  for i in (1, 2):
    lin = ff[f'ffn_layer{i}']['linear']
    ops[f'w{i}'], ops[f's{i}'], ops[f'b{i}'] = (
        lin['kernel'], lin['kernel_scale'], lin['bias'])
  return ops


def _sides(ops, tdtype, jdtype):
  """The operands as tensors and as jax arrays."""
  t, j = {}, {}
  for k, v in ops.items():
    if k[0] in 'ws' or k.startswith('mask'):
      t[k], j[k] = torch.from_numpy(v), jnp.asarray(v)
    else:
      t[k] = torch.from_numpy(v).to(tdtype)
      j[k] = jnp.asarray(v).astype(jdtype)
  return t, j


def _compare(got, want, label, *, kind='kernel'):
  """The tolerances of the module docstring for a ``kind`` of output:
  'kernel', or a model's 'tokens' or (pooled) 'embeddings'."""
  got = got.float().numpy()
  want = np.asarray(jnp.asarray(want).astype(jnp.float32))
  assert got.shape == want.shape, (label, got.shape, want.shape)
  diff = np.abs(got - want)
  if kind == 'kernel':
    cos = float(np.dot(got.ravel(), want.ravel())
                / (np.linalg.norm(got) * np.linalg.norm(want)))
  else:   # the least per-token (per-embedding) cosine
    cos = float(np.min(np.sum(got * want, -1) / (
        np.linalg.norm(got, axis=-1) * np.linalg.norm(want, axis=-1))))
  if label.startswith('f32') and kind == 'kernel':
    assert (diff <= 1e-5).mean() >= 0.99, (label, (diff > 1e-5).mean())
    assert diff.max() <= 2e-3, (label, diff.max())
  elif label.startswith('f32'):
    if kind == 'tokens':
      assert (diff <= 1e-5).mean() >= 0.9, (label, (diff > 1e-5).mean())
    assert cos >= 0.9999, (label, cos)
  elif kind == 'kernel':
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2,
                               err_msg=label)
    assert cos >= 0.9999, (label, cos)
  else:
    assert cos >= 0.999, (label, cos)


def _check_rounds_per_chunk(got, others, want):
  """The bit-share test of tests/test_torch_chunked_blocks.py: the chunked
  twin's bits differ from the JAX chunked kernel's in well under half as
  many elements as each of ``others`` does: the one-chunk twin (which
  quantizes over all columns) and the chunked products summed in fp32 and
  cast once (which drops only the cast per chunk)."""
  want = torch.from_numpy(np.array(want.astype(jnp.float32)))
  differ = (got.float() != want).float().mean().item()
  for other in others:
    differ_other = (other.float() != want).float().mean().item()
    assert differ < 0.5 * differ_other, (differ, differ_other)


QKV = ('wq', 'sq', 'bq', 'wk', 'sk', 'bk', 'wv', 'sv', 'bv')
OUT = ('wo', 'so', 'bo')
FFN = ('w1', 's1', 'b1', 'w2', 's2', 'b2')


def _args(side, names):
  return tuple(side[k] for k in names)


def _attention_kmajor(side, n, h):
  """The kernels' K-major q|k|v and Wo operands of ``side``'s [K, N]
  ones (prepare_for_kernels' layout)."""
  return dict(ti8.int8_qkv_kmajor(*_args(side, QKV), num_heads=n,
                                  dim_per_head=h),
              **ti8.int8_out_kmajor(side['wo'], num_heads=n, dim_per_head=h))


def _check_kmajor(fn, args, kw, kmajor, got):
  """The twin reading the K-major operands gives the [K, N] path's
  outputs bit for bit (the int8 products are exact either way)."""
  again = fn(*args, **kw, kmajor=kmajor)
  for g, a in zip(got if isinstance(got, tuple) else (got,),
                  again if isinstance(again, tuple) else (again,)):
    assert torch.equal(g, a)


def test_quantize_for_serving_matches_jax():
  """Codes and scales bitwise equal to the JAX package's host path (and
  its device path), for an unstacked and a stacked tree; dequantize and
  is_quantized agree; an int8 leaf is left as it is; params_from_numpy
  keeps int8 and fp32 scales under a bf16 cast and prepare_for_kernels
  adds the int8 kernels' K-major layout, sharing memory with the [K, N]
  leaves, which dequantize drops."""
  layer = _layer(0, 2, 64)
  stacked = jax.tree.map(lambda *a: np.stack(a),
                         *[_layer(s, 2, 64) for s in (1, 2, 3)])
  for tree in ({'x_layers_0': layer}, {'x_layers': stacked}):
    got = tq.quantize_for_serving(tree)
    for on_host in (True, False):
      want = jq.quantize_for_serving(tree, on_host=on_host)
      got_leaves, got_def = jax.tree.flatten(got)
      want_leaves, want_def = jax.tree.flatten(want)
      assert got_def == want_def
      for g, w in zip(got_leaves, want_leaves):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, np.asarray(w))
    again = tq.quantize_for_serving(got, on_host=True)
    for g, w in zip(jax.tree.leaves(again), jax.tree.leaves(got)):
      np.testing.assert_array_equal(g, w)
    got_t = params_from_numpy(got, device='cpu')
    deq = jax.tree.leaves(tq.dequantize(got_t, torch.float32))
    deq_want = jax.tree.leaves(jq.dequantize(want, jnp.float32))
    assert len(deq) == len(deq_want)
    for g, w in zip(deq, deq_want):
      np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    key = next(iter(tree))
    assert tq.is_quantized(got_t[key]) and jq.is_quantized(want[key])
    assert not tq.is_quantized(params_from_numpy(tree, device='cpu')[key])
  bf16 = params_from_numpy(got, device='cpu', dtype=torch.bfloat16)
  attn = bf16['x_layers']['self_attention']
  assert attn['query']['w'].dtype == torch.int8
  assert attn['query']['w_scale'].dtype == torch.float32
  assert attn['query']['b'].dtype == torch.bfloat16
  assert bf16['x_layers']['ff_layer']['ffn_layer1']['linear'][
      'kernel_scale'].dtype == torch.float32
  # prepare_for_kernels writes the int8 kernels' K-major operands: Wo [D,
  # N*H] (the post weights flattened), q|k|v [3*N*H, D], W1 [F, D] and W2
  # [D, F], each the transposed [K, N] weights; the [K, N] leaves become
  # views of those copies, so the weights are held once.
  layers = prepare_for_kernels(bf16)['x_layers']
  prepared, ff = layers['self_attention'], layers['ff_layer']
  src_attn = want['x_layers']['self_attention']
  kn = lambda name: np.asarray(src_attn[name]['w']).reshape(3, 128, 128)
  assert prepared['fused']['wo'].dtype == torch.int8
  np.testing.assert_array_equal(prepared['fused']['wo'].numpy(), kn('post'))
  np.testing.assert_array_equal(
      prepared['fused']['wqkv'].numpy(),
      np.concatenate([kn(n) for n in ('query', 'key', 'value')],
                     -1).transpose(0, 2, 1))
  np.testing.assert_array_equal(
      prepared['fused']['sqkv'].numpy(),
      np.concatenate([np.asarray(src_attn[n]['w_scale']).reshape(3, 128)
                      for n in ('query', 'key', 'value')], -1))
  for key, name in (('w1', 'ffn_layer1'), ('w2', 'ffn_layer2')):
    w = np.asarray(want['x_layers']['ff_layer'][name]['linear']['kernel'])
    np.testing.assert_array_equal(ff['fused'][key].numpy(),
                                  w.transpose(0, 2, 1))
    leaf = ff[name]['linear']['kernel']
    np.testing.assert_array_equal(leaf.numpy(), w)
    assert leaf.data_ptr() == ff['fused'][key].data_ptr()
  for name in ('query', 'key', 'value'):
    np.testing.assert_array_equal(prepared[name]['w'].numpy(),
                                  np.asarray(src_attn[name]['w']))
    assert (prepared['fused']['wqkv'].untyped_storage().data_ptr()
            == prepared[name]['w'].untyped_storage().data_ptr())
  assert not any('fused' in sub for sub in tq.dequantize(
      layers, torch.bfloat16).values())


def test_quant_rows_bitwise_equal():
  """Codes and scales of quant_rows equal the JAX package's bit for bit,
  including all-zero rows and exact .5 ties (max 127, so the scale is 1.0
  and h * (1/s) = h): rounding half to even, never half away."""
  rng = np.random.default_rng(0)
  h = (rng.standard_normal((64, 256)) * rng.uniform(1e-3, 30, (64, 1))
       ).astype(np.float32)
  h[3] = 0.0
  ties = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5, -126.5],
                  np.float32)
  h[5, :] = np.tile(ties, 32)
  got_q, got_s = ti8.quant_rows(torch.from_numpy(h))
  want_q, want_s = ji8.quant_rows(jnp.asarray(h))
  np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
  np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
  assert got_q.dtype == torch.int8 and got_s[5, 0].item() == 1.0
  assert got_q[5, :8].tolist() == [127, 0, 2, 2, 0, -2, 126, -126]
  assert got_q[3].abs().sum().item() == 0
  assert got_s[3, 0].item() == np.float32(1e-12)


# (D, heads, head dim, F, frames) of the base, large and giant encoders.
_BASE, _LARGE, _GIANT = ((768, 12, 64, 3072, 16), (1024, 16, 64, 4096, 8),
                         (1408, 16, 88, 6144, 8))


def _unpacked_route(mod, b, t, d, n, h, f):
  """The reference's choice for a [b, t, d] bf16 layer read at unpacked
  lengths through ``mod``'s rule: 'K11', or (K10 chunks, K12 route, K9
  chunks) as ``_try_fused_int8_layer`` takes them."""
  nh = n * h
  if b * t <= 16384 and mod.int8_layer_supported(t, d, nh, f, n, 2):
    return 'K11'
  attn = mod.attention_int8_chunks_for(t, d, n, h, 2)
  projected = attn is None and mod.attn_int8_projection_supported(
      b * t, d, nh, 2)
  return attn, projected, mod.ffn_int8_chunks_for(b * t, d, f, 2)


def test_int8_route_rule_matches_reference(monkeypatch):
  """The copied rule equals the reference's over a grid and on the
  encoders' stacks at unpacked lengths (giant: K10 over 2 head groups and
  K9 over 2 F-slices spatially, K9 over 2 temporally), and the port's plan,
  read at the reference's padded and packed lengths, gives the counts the
  paths assert; past the attention core's capacity the layer's route (see
  below)."""
  for t, d, n, h, f, itemsize in itertools.product(
      (8, 16, 72, 128, 256, 512, 1024, 1152), (128, 768, 1024, 1408),
      (2, 12, 16), (64, 88), (256, 3072, 4096, 6144), (2, 4)):
    nh = n * h
    assert (ti8.attention_int8_chunks_for(t, d, n, h, itemsize)
            == ji8.attention_int8_chunks_for(t, d, n, h, itemsize))
    assert (ti8._layer_int8_cfg(t, d, nh, f, n, itemsize)
            == ji8._layer_int8_cfg(t, d, nh, f, n, itemsize))
    assert (ti8.int8_layer_supported(t, d, nh, f, n, itemsize)
            == ji8.int8_layer_supported(t, d, nh, f, n, itemsize))
    for rows in (t, 16 * t, 8 * 4096):
      assert (ti8.ffn_int8_chunks_for(rows, d, f, itemsize)
              == ji8.ffn_int8_chunks_for(rows, d, f, itemsize))
      assert (ti8.attn_int8_projection_supported(rows, d, nh, itemsize)
              == ji8.attn_int8_projection_supported(rows, d, nh, itemsize))
  table = {   # (width, B): (spatial, temporal) at T = 256 and T = frames
      (_BASE, 1): ('K11', 'K11'),
      (_BASE, 8): ((1, False, 1), (1, False, 1)),
      (_LARGE, 1): ((1, False, 1), 'K11'),
      (_LARGE, 8): ((1, False, 1), 'K11'),
      (_GIANT, 1): ((2, False, 2), (1, False, 2)),
      (_GIANT, 8): ((2, False, 2), (1, False, 2)),
  }
  for ((d, n, h, f, frames), b), want in table.items():
    for (rows, t), route in zip(((b * frames, 256), (b * 256, frames)),
                                want):
      for mod in (ti8, ji8):
        assert _unpacked_route(mod, rows, t, d, n, h, f) == route, (
            mod.__name__, d, b, t)
  plan = lambda b, t, d=768, n=12, h=64, f=3072, causal=False: ttfm.int8_plan(
      b, t, d, n, h, f, 2, causal=causal)
  P = ttfm.Int8Plan
  for b in (1, 2):
    assert plan(16 * b, 256).layer == (2, 1)                 # spatial
    assert plan(256 * b, 16).layer == (1, 1)                 # temporal
    assert plan(b, 65, causal=True).layer == (1, 1)          # text tower
  assert plan(8, 65, causal=True).layer == (1, 1)
  assert plan(128, 256) == P(None, 1, False, 1)              # B=8 spatial
  assert plan(2048, 16) == P(None, 1, False, 1)              # B=8 temporal
  for b in (1, 2, 8):
    assert plan(b, 4096) == P(None, None, True, 1)           # lvt aux
  d, n, h, f, _ = _LARGE
  assert plan(8, 256, d, n, h, f) == P(None, 1, False, 1)
  assert plan(256, 8, d, n, h, f).layer == (2, 2)
  d, n, h, f, _ = _GIANT
  for b in (1, 2, 8):
    assert plan(8 * b, 256, d, n, h, f) == P(None, 2, False, 2)
    assert plan(256 * b, 8, d, n, h, f) == P(None, 1, False, 2)

  # On the card, with the attention core's capacity replaced by a stand-in
  # that holds T <= 784: at T = 800 the one-group layer takes K12a + K5 +
  # K12b and K9 in one chunk, at H = 32, at 24 (a multiple of 8 but not
  # of 16, as giant's 88) and at 20 (not a multiple of 8: padded to 24);
  # a chunked one, or a head dim K5 cannot take (20 with K5's maximum
  # replaced by 16), raises naming the limit.
  monkeypatch.setattr(_lib, 'use_kernel', lambda impl, x: True)
  monkeypatch.setattr(_lib, 'max_attention_t', lambda h: 784)
  called = []
  for name in _Routes.NAMES:
    monkeypatch.setattr(ti8, name, lambda x, *a, _name=name, **k: (
        called.append((_name, k.get('chunks'))) or x))
  x = torch.zeros((1, 800, 128))
  cfg = ttfm.TransformerLayerConfig(num_layers=1, hidden_dim=256,
                                    num_heads=4, activation='gelu',
                                    enable_per_dim_scale=False)
  layer = lambda h: params_from_numpy(
      tq.quantize_for_serving({'l': _layer(50, 4, h)})['l'], device='cpu')
  call = lambda h: ttfm.transformer_layer(layer(h), x, None,
                                          torch.zeros((1, 1, 1, 800)), cfg)
  for h in (32, 24, 20):
    called.clear()
    call(h)
    assert called == [('int8_projected_flash_attention', None),
                      ('int8_ffn_block_chunked', 1)], (h, called)
  with monkeypatch.context() as patch:
    patch.setattr(ttfm.flash, 'MAX_HEAD_DIM', 16)
    with pytest.raises(ValueError, match=r'T <= 784.*at most 16'):
      call(20)
  monkeypatch.setattr(ti8, 'attention_int8_chunks_for', lambda *a: 2)
  with pytest.raises(ValueError, match=r'T <= 784.*chunks this layer'):
    call(32)


def _run(fn, t_side, j_side, names, tkw, jkw):
  return (fn[0](*_args(t_side, names), **tkw),
          fn[1](*_args(j_side, names), **jkw, interpret=True))


def test_int8_ffn_block_matches_jax():
  """K9's twin against the JAX kernel: fp32 and bf16, with and without
  paddings, gelu and relu, chunks 1 and 2 (bf16 at 2 also the bit-share
  test against the one-chunk twin and the cast-once sum), and on the
  kernels' K-major operands bitwise its [K, N] outputs; partial_out
  (tensor
  parallelism) raises naming its ROADMAP item, and impl='kernel' on CPU
  tensors raises without counting a launch."""
  for (label, tdt, jdt), padded, act, chunks in itertools.product(
      DTYPES, (False, True), ('gelu', 'relu'), (1, 2)):
    ops = _operands(10, 2, 64, padded=padded)
    ops['x'] = ops['x'].reshape(-1, 128)
    ops['pads'] = ops['pads'].reshape(-1, 1)
    t, j = _sides(ops, tdt, jdt)
    names = ('x', 'pads', 'ln2_s', 'ln2_b', *FFN)
    kw = dict(chunks=chunks, activation=act)
    got, want = _run((ti8.int8_ffn_block_chunked, ji8.int8_ffn_block_chunked),
                     t, j, names, kw, kw)
    _compare(got, want, f'{label} K9 padded={padded} {act} chunks={chunks}')
    _check_kmajor(ti8.int8_ffn_block_chunked, _args(t, names), kw,
                  ti8.int8_ffn_kmajor(t['w1'], t['w2']), got)
    if label == 'bf16' and chunks == 2:
      _check_rounds_per_chunk(got, (
          ti8.int8_ffn_block_chunked(*_args(t, names), **dict(kw, chunks=1)),
          cases_lib._int8_cast_once(cases_lib.Case(
              'int8_ffn_block_chunked', '', None, _args(t, names), kw))),
                              want)
  args = _args(t, names)
  with pytest.raises(NotImplementedError, match='item.* 13'):
    ti8.int8_ffn_block_chunked(*args, chunks=1, partial_out=True)
  _lib.reset_launches()
  with pytest.raises(ValueError, match='CUDA'):
    ti8.int8_ffn_block_chunked(*args, chunks=1, impl='kernel')
  assert sum(_lib.LAUNCHES.values()) == 0


def test_int8_attention_block_matches_jax():
  """K10's twin against the JAX kernel: fp32 and bf16, with and without
  paddings, a causal mask, cap 0 and 50, chunks 1 and 2 (bf16 at 2 also
  the bit-share test against the one-chunk twin and the cast-once
  sum)."""
  for (label, tdt, jdt), (padded, causal), cap, chunks in itertools.product(
      DTYPES, ((False, False), (True, False), (True, True)), (0.0, 50.0),
      (1, 2)):
    t, j = _sides(_operands(20, 2, 64, padded=padded, causal=causal), tdt,
                  jdt)
    names = ('x', 'mask', 'ln1_s', 'ln1_b', *QKV, *OUT)
    kw = dict(num_heads=2, dim_per_head=64, chunks=chunks, logit_cap=cap,
              query_scale=64 ** -0.5)
    got, want = _run((ti8.int8_attention_block_chunked,
                      ji8.int8_attention_block_chunked), t, j, names, kw, kw)
    _compare(got, want, f'{label} K10 padded={padded} causal={causal} cap={cap} '
             f'chunks={chunks}')
    _check_kmajor(ti8.int8_attention_block_chunked, _args(t, names), kw,
                  _attention_kmajor(t, 2, 64), got)
    if label == 'bf16' and chunks == 2:
      args = _args(t, names)
      _check_rounds_per_chunk(got, (
          ti8.int8_attention_block_chunked(*args, **dict(kw, chunks=1)),
          cases_lib._int8_cast_once(cases_lib.Case(
              'int8_attention_block_chunked', '', None, args, kw))), want)


def test_int8_layer_block_matches_jax():
  """K11's twin against the JAX kernel at (1, 1), (2, 1) and (2, 2):
  fp32 and bf16, with and without paddings, cap 0 and 50; and in bf16 at
  (2, 2) it rounds as K11 does, not as K10 + K9."""
  for (label, tdt, jdt), padded, cap, chunks in itertools.product(
      DTYPES, (False, True), (0.0, 50.0), ((1, 1), (2, 1), (2, 2))):
    ops = _operands(30, 4, 32, padded=padded)
    ops['pads'] = ops['pads'][..., None]
    t, j = _sides(ops, tdt, jdt)
    names = ('x', 'mask', 'pads', 'ln1_s', 'ln1_b', *QKV, *OUT, 'ln2_s',
             'ln2_b', *FFN)
    kw = dict(num_heads=4, dim_per_head=32, logit_cap=cap,
              query_scale=32 ** -0.5, head_chunks=chunks[0],
              ffn_chunks=chunks[1])
    got, want = _run((ti8.int8_layer_block, ji8.int8_layer_block), t, j,
                     names, kw, kw)
    _compare(got, want, f'{label} K11 padded={padded} cap={cap} chunks={chunks}')
    _check_kmajor(ti8.int8_layer_block, _args(t, names), kw,
                  dict(_attention_kmajor(t, 4, 32),
                       **ti8.int8_ffn_kmajor(t['w1'], t['w2'])), got)
    if label == 'bf16' and chunks == (2, 2):
      # The fp32 sums round once: the JAX kernel's bits differ from the
      # twin's in well under half as many elements as from K10 + K9's.
      x1 = ti8.int8_attention_block_chunked(
          *_args(t, ('x', 'mask', 'ln1_s', 'ln1_b', *QKV, *OUT)),
          num_heads=4, dim_per_head=32, chunks=2, logit_cap=cap,
          query_scale=32 ** -0.5)
      chain = ti8.int8_ffn_block_chunked(
          x1.reshape(-1, 128), t['pads'].reshape(-1, 1),
          *_args(t, ('ln2_s', 'ln2_b', *FFN)), chunks=2).reshape(x1.shape)
      want = torch.from_numpy(np.array(want.astype(jnp.float32)))
      differ = (got.float() != want).float().mean().item()
      differ_chain = (chain.float() != want).float().mean().item()
      assert differ < 0.5 * differ_chain, (differ, differ_chain)


def test_int8_projections_match_jax():
  """K12a, K12b and int8_projected_flash_attention (K12a, K5, K12b; T =
  128 so the JAX package runs its flash kernel) against the JAX package:
  fp32 and bf16, with and without paddings, cap 0 and 50."""
  for (label, tdt, jdt), padded, cap in itertools.product(
      DTYPES, (False, True), (0.0, 50.0)):
    ops = _operands(40, 2, 64, t=128, padded=padded)
    ops['x2d'] = ops['x'].reshape(-1, 128)
    ops['mask4'] = ops['mask'][:, None]
    rng = np.random.default_rng(41)
    ops['ctx'] = rng.standard_normal((256, 128)).astype(np.float32)
    t, j = _sides(ops, tdt, jdt)
    tag = f'{label} K12 padded={padded} cap={cap}'
    kw = dict(query_scale=64 ** -0.5)
    got, want = _run((ti8.int8_qkv_projection, ji8.int8_qkv_projection), t, j,
                     ('x2d', 'ln1_s', 'ln1_b', *QKV), kw, kw)
    for g, w, name in zip(got, want, 'qkv'):
      _compare(g, w, f'{tag} K12a {name}')
    _check_kmajor(ti8.int8_qkv_projection, _args(t, ('x2d', 'ln1_s', 'ln1_b',
                                                     *QKV)), kw,
                  ti8.int8_qkv_kmajor(*_args(t, QKV), num_heads=1,
                                      dim_per_head=128), got)
    got, want = _run((ti8.int8_out_projection, ji8.int8_out_projection), t, j,
                     ('ctx', 'x2d', *OUT), {}, {})
    _compare(got, want, f'{tag} K12b')
    _check_kmajor(ti8.int8_out_projection, _args(t, ('ctx', 'x2d', *OUT)), {},
                  ti8.int8_out_kmajor(t['wo'], num_heads=1, dim_per_head=128),
                  got)
    kw = dict(num_heads=2, dim_per_head=64, logit_cap=cap,
              query_scale=64 ** -0.5)
    got, want = _run((ti8.int8_projected_flash_attention,
                      ji8.int8_projected_flash_attention), t, j,
                     ('x', 'mask4', 'ln1_s', 'ln1_b', *QKV, *OUT), kw, kw)
    _compare(got, want, f'{tag} projected')
    _check_kmajor(ti8.int8_projected_flash_attention,
                  _args(t, ('x', 'mask4', 'ln1_s', 'ln1_b', *QKV, *OUT)), kw,
                  _attention_kmajor(t, 2, 64), got)


class _Routes:
  """Records which JAX int8 kernels the reference's layers call and which
  of the port's int8 wrappers run, each with its ``chunks`` (K9, K10;
  None for the others: the reference's K11 picks its own counts)."""

  NAMES = ('int8_layer_block', 'int8_attention_block_chunked',
           'int8_ffn_block_chunked', 'int8_projected_flash_attention')

  def __init__(self, monkeypatch):
    self.jax, self.torch = set(), set()
    for name in self.NAMES:
      for module, seen in ((ji8, self.jax), (ti8, self.torch)):
        fn = getattr(module, name)
        monkeypatch.setattr(module, name, self._spy(fn, name, seen))

  @staticmethod
  def _spy(fn, name, seen):
    def call(*args, **kwargs):
      seen.add((name, kwargs.get('chunks')))
      return fn(*args, **kwargs)
    return call

  def check(self, want):
    """``want``: the (name, chunks) pairs both sides ran."""
    assert self.jax == self.torch == set(want), (self.jax, self.torch, want)
    self.jax.clear()
    self.torch.clear()


def _jax_tree(tree, jdtype):
  """The numpy int8 tree as jax arrays: int8 and the fp32 scales kept,
  the other floating leaves in ``jdtype`` (as params_from_numpy does)."""
  return jax.tree_util.tree_map_with_path(
      lambda p, a: jnp.asarray(a) if a.dtype == np.int8 else
      jnp.asarray(a).astype(jnp.float32 if p[-1].key in tq.SCALE_KEYS
                            else jdtype), tree)


def _golden():
  root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
  sys.path.insert(0, os.path.join(root, 'scripts'))
  import make_torch_int8_golden as golden

  stored = np.load(os.path.join(root, 'tests', 'data',
                                'torch_port_int8_golden.npz'))
  return golden, stored


def test_tiny_int8_encoder_matches_jax(monkeypatch):
  """A tiny int8 factorized encoder against the JAX package's (its int8
  kernels in interpret mode), with one padded frame, comparing real tokens:
  F = 256 takes K11 in both stacks and F = 192, which the reference's
  layer kernel refuses (F % 128), K10 + K9 in one chunk each (the encoder
  of tests/data/torch_port_int8_golden.npz, whose fp32 tokens regenerate);
  with the rule's chunk counts replaced by 2 on both sides (no tiny width
  chunks under the reference's budget), K10 over 2 head groups and K9 over
  2 F-slices, as the giant encoder runs them.  fp32 and bf16."""
  routes = _Routes(monkeypatch)
  golden, stored = _golden()
  assert json.loads(str(stored['encoder_config'])) == golden.ENCODER_CONFIG
  _, _, _, video, frame_pads, real = golden.make_inputs()
  k10, k9 = 'int8_attention_block_chunked', 'int8_ffn_block_chunked'
  for f, chunks, want_routes in (
      (256, None, {('int8_layer_block', None)}),
      (192, None, {(k10, 1), (k9, 1)}),
      (192, 2, {(k10, 2), (k9, 2)})):
    if chunks:
      for mod in (ti8, ji8):
        monkeypatch.setattr(mod, 'attention_int8_chunks_for',
                            lambda *a: chunks)
        monkeypatch.setattr(mod, 'ffn_int8_chunks_for', lambda *a: chunks)
    kw = dict(golden.ENCODER_CONFIG, mlp_dim=f,
              pos_emb_shape=tuple(golden.ENCODER_CONFIG['pos_emb_shape']))
    tcfg = tfe.FactorizedEncoderConfig(**kw)
    tree = tq.quantize_for_serving(
        init_lib.numpy_factorized_encoder(0, tcfg, norm_bias_std=0.1))
    for label, tdt, jdt in DTYPES:
      want, _ = jfe.apply(
          _jax_tree(tree, jdt), jnp.asarray(video),
          jfe.FactorizedEncoderConfig(**kw, dtype=jdt,
                                      attention_impl='flash',
                                      kernel_interpret=True),
          frame_paddings=jnp.asarray(frame_pads))
      params = prepare_for_kernels(params_from_numpy(tree, device='cpu',
                                                     dtype=tdt))
      got, _ = tfe.apply(params, torch.from_numpy(video),
                         dataclasses.replace(tcfg, dtype=tdt),
                         frame_paddings=torch.from_numpy(frame_pads))
      routes.check(want_routes)
      want = np.asarray(want.astype(jnp.float32))[real]
      if label == 'f32' and f == 192 and not chunks:
        np.testing.assert_allclose(want, stored['encoder_tokens'], atol=1e-6,
                                   rtol=0)
      _compare(got[torch.from_numpy(real)], want,
               f'{label} encoder F={f} chunks={chunks}', kind='tokens')


def test_tiny_int8_clip_matches_jax(monkeypatch):
  """A tiny int8 lvt model (tests/data/torch_port_int8_golden.npz's, whose
  fp32 embeddings regenerate) against the JAX package's quantized CLIP: the
  auxiliary encoder over 1152 tokens takes K12a + K5 + K12b and K9, the
  causal text tower and the encoder K11.  fp32 and bf16 embeddings."""
  routes = _Routes(monkeypatch)
  golden, stored = _golden()
  assert json.loads(str(stored['clip_config'])) == golden.CLIP_CONFIG
  kw = dict(golden.CLIP_CONFIG,
            pos_emb_shape=tuple(golden.CLIP_CONFIG['pos_emb_shape']))
  tcfg = tclip.VideoCLIPConfig(**kw)
  tree, _ = golden.int8_trees()
  video, ids, pads, *_ = golden.make_inputs()
  for label, tdt, jdt in DTYPES:
    want_v, want_t, _ = jclip.apply(
        _jax_tree(tree, jdt), jnp.asarray(video), jnp.asarray(ids),
        jnp.asarray(pads),
        cfg=jclip.VideoCLIPConfig(**kw, dtype=jdt, attention_impl='flash',
                                  kernel_interpret=True))
    params = prepare_for_kernels(params_from_numpy(tree, device='cpu',
                                                   dtype=tdt))
    got_v, got_t, _ = tclip.apply(
        params, torch.from_numpy(video), torch.from_numpy(ids),
        torch.from_numpy(pads), dataclasses.replace(tcfg, dtype=tdt))
    routes.check({('int8_layer_block', None),
                  ('int8_projected_flash_attention', None),
                  ('int8_ffn_block_chunked', 1)})
    for tower, g, w in (('video', got_v, want_v), ('text', got_t, want_t)):
      if label == 'f32':
        np.testing.assert_allclose(np.asarray(w),
                                   stored[f'{tower}_embeddings'], atol=1e-6,
                                   rtol=0)
      _compare(g, w, f'{label} lvt {tower}', kind='embeddings')
