"""K8a/K8b twins of videoprism_tpu_torch against the JAX package's chunked
Pallas kernels (interpret mode), the port's copy of the reference's chunk
plan, and the layer's route through them and through K1's capacity gate,
on the CPU.

fp32: atol 2e-5, the gate of the JAX kernel tests (tests/test_fused_blocks.py);
chunked against unchunked twins at 2e-6, as the JAX package holds its own
chunked kernels.  bf16: atol = rtol = 2e-2, as
tests/test_torch_transformer_block.py (both sides round to bf16 at the
same points; they differ in summation order and the TPU's polynomial erf).
That tolerance cannot see the one bf16 cast per extra chunk, so in bf16
the share of elements whose bits differ from the JAX kernel must also be
below half the one-chunk twin's share.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videoprism_tpu.ops import transformer as jtfm
from videoprism_tpu.ops.pallas import transformer_block as jtb
from videoprism_tpu_torch.ops import transformer as ttfm
from videoprism_tpu_torch.ops.kernels import _lib
from videoprism_tpu_torch.ops.kernels import transformer_block as ttb

B, T, D, F = 2, 16, 128, 256
NEG = -0.7 * float(np.finfo(np.float32).max)


def _layer(seed, n, h, d=D, f=F):
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


def _paddings(b, t):
  pads = np.zeros((b, t), np.float32)
  pads[0, t - 5:] = 1.0
  pads[-1] = 1.0          # one fully masked sequence
  return pads


def _t(a, dtype=torch.float32):
  return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _j(a, dtype=jnp.float32):
  return jnp.asarray(a, jnp.float32).astype(dtype)


def _check_rounds_per_chunk(got, one_chunk, want):
  """The chunked twin's bits differ from the JAX chunked kernel's in well
  under half as many elements as the one-chunk twin's do."""
  want = torch.from_numpy(np.array(want.astype(jnp.float32)))
  differ = (got.float() != want).float().mean().item()
  differ_one = (one_chunk.float() != want).float().mean().item()
  assert differ < 0.5 * differ_one, (differ, differ_one)


def _attention_operands(seed, n, h):
  """x, mask, LN and the JAX / port weight layouts of one layer."""
  p = _layer(seed, n, h)
  a = p['self_attention']
  flat = lambda k: (a[k]['w'].reshape(D, n * h), a[k]['b'].reshape(n * h))
  (wq, bq), (wk, bk), (wv, bv) = flat('query'), flat('key'), flat('value')
  wo = np.transpose(a['post']['w'], (1, 2, 0)).reshape(n * h, D)
  x = np.random.default_rng(seed + 100).standard_normal(
      (B, T, D)).astype(np.float32)
  mask = _paddings(B, T)[:, None, :] * np.float32(NEG)
  ln = (p['layer_norm']['scale'], p['layer_norm']['bias'])
  return (x, mask, ln, (wq, bq, wk, bk, wv, bv, wo, a['post']['b']),
          (np.concatenate([wq, wk, wv], 1), np.concatenate([bq, bk, bv]), wo,
           a['post']['b']))


def _ffn_operands(seed):
  ff = _layer(seed, 2, 64)['ff_layer']
  x = np.random.default_rng(seed + 100).standard_normal(
      (B * T, D)).astype(np.float32)
  pads = _paddings(B, T).reshape(B * T, 1)
  return x, pads, (ff['layer_norm']['scale'], ff['layer_norm']['bias'],
                   ff['ffn_layer1']['linear']['kernel'],
                   ff['ffn_layer1']['linear']['bias'],
                   ff['ffn_layer2']['linear']['kernel'],
                   ff['ffn_layer2']['linear']['bias'])


class TestChunkedAttention:

  @pytest.mark.parametrize('n,h,chunks', [(4, 32, 2), (4, 32, 4), (4, 24, 2)])
  @pytest.mark.parametrize('cap', [50.0, 0.0])
  def test_matches_pallas_kernel_fp32(self, n, h, chunks, cap):
    """Head dim 24 is a multiple of 8 but not of 16, as giant's 88."""
    x, mask, ln, jax_w, port_w = _attention_operands(0, n, h)
    kw = dict(num_heads=n, dim_per_head=h, chunks=chunks, logit_cap=cap,
              query_scale=h ** -0.5)
    got = ttb.fused_attention_block_chunked(
        _t(x), _t(mask), *map(_t, ln), *map(_t, port_w), **kw)
    want = jtb.fused_attention_block_chunked(
        _j(x), _j(mask), *map(_j, ln), *map(_j, jax_w), interpret=True, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)

  @pytest.mark.parametrize('chunks', [2, 4])
  def test_matches_pallas_kernel_bf16(self, chunks):
    x, mask, ln, jax_w, port_w = _attention_operands(1, 4, 32)
    kw = dict(num_heads=4, dim_per_head=32, chunks=chunks, logit_cap=50.0,
              query_scale=32 ** -0.5)
    bf = torch.bfloat16
    got = ttb.fused_attention_block_chunked(
        _t(x, bf), _t(mask), *(_t(a, bf) for a in ln),
        *(_t(a, bf) for a in port_w), **kw)
    want = jtb.fused_attention_block_chunked(
        _j(x, jnp.bfloat16), _j(mask), *(_j(a, jnp.bfloat16) for a in ln),
        *(_j(a, jnp.bfloat16) for a in jax_w), interpret=True, **kw)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=2e-2, rtol=2e-2)
    one = ttb.fused_attention_block_chunked(
        _t(x, bf), _t(mask), *(_t(a, bf) for a in ln),
        *(_t(a, bf) for a in port_w), **dict(kw, chunks=1))
    _check_rounds_per_chunk(got, one, want)

  @pytest.mark.parametrize('chunks', [2, 4])
  def test_matches_unchunked_twin_fp32(self, chunks):
    x, mask, ln, _, port_w = _attention_operands(2, 4, 32)
    kw = dict(num_heads=4, dim_per_head=32, logit_cap=50.0,
              query_scale=32 ** -0.5)
    args = (_t(x), _t(mask), *map(_t, ln), *map(_t, port_w))
    got = ttb.fused_attention_block_chunked(*args, chunks=chunks, **kw)
    want = ttb.fused_attention_block(*args, **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-6, rtol=0)
    one = ttb.fused_attention_block_chunked(*args, chunks=1, **kw)
    assert torch.equal(one, want)

  def test_refusals_on_the_cpu(self):
    x, mask, ln, _, port_w = _attention_operands(3, 4, 32)
    args = (_t(x), _t(mask), *map(_t, ln), *map(_t, port_w))
    kw = dict(num_heads=4, dim_per_head=32)
    with pytest.raises(ValueError, match='chunks'):
      ttb.fused_attention_block_chunked(*args, chunks=3, **kw)
    with pytest.raises(NotImplementedError):
      ttb.fused_attention_block_chunked(*args, chunks=2, partial_out=True,
                                        **kw)
    _lib.reset_launches()
    with pytest.raises(ValueError, match='CUDA'):
      ttb.fused_attention_block_chunked(*args, chunks=2, impl='kernel', **kw)
    assert sum(_lib.LAUNCHES.values()) == 0


class TestChunkedFfn:

  @pytest.mark.parametrize('chunks', [2, 4])
  @pytest.mark.parametrize('activation', ['gelu', 'relu'])
  def test_matches_pallas_kernel_fp32(self, chunks, activation):
    x, pads, ops = _ffn_operands(4)
    got = ttb.fused_ffn_block_chunked(_t(x), _t(pads), *map(_t, ops),
                                      chunks=chunks, activation=activation)
    want = jtb.fused_ffn_block_chunked(_j(x), _j(pads), *map(_j, ops),
                                       chunks=chunks, activation=activation,
                                       interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)

  @pytest.mark.parametrize('chunks', [2, 4])
  def test_matches_pallas_kernel_bf16(self, chunks):
    x, pads, ops = _ffn_operands(5)
    bf = torch.bfloat16
    args = (_t(x, bf), _t(pads, bf), *(_t(a, bf) for a in ops))
    got = ttb.fused_ffn_block_chunked(*args, chunks=chunks)
    want = jtb.fused_ffn_block_chunked(
        _j(x, jnp.bfloat16), _j(pads, jnp.bfloat16),
        *(_j(a, jnp.bfloat16) for a in ops), chunks=chunks, interpret=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=2e-2, rtol=2e-2)
    _check_rounds_per_chunk(
        got, ttb.fused_ffn_block_chunked(*args, chunks=1), want)

  @pytest.mark.parametrize('chunks', [2, 4])
  def test_matches_unchunked_twin_fp32(self, chunks):
    x, pads, ops = _ffn_operands(6)
    args = (_t(x), _t(pads), *map(_t, ops))
    got = ttb.fused_ffn_block_chunked(*args, chunks=chunks)
    want = ttb.fused_ffn_block(*args)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-6, rtol=0)
    assert torch.equal(ttb.fused_ffn_block_chunked(*args, chunks=1), want)
    with pytest.raises(ValueError, match='chunks'):
      ttb.fused_ffn_block_chunked(*args, chunks=3)


# The shapes of the Motivation's table and around it: (rows or B, T, D,
# heads, head dim, F) of base, large and giant at B = 1 and 8, spatial
# (T = 256) and temporal (T = 8, 16), the text tower (65 tokens), the
# auxiliary encoder (4096), and narrow widths.
_WIDTHS = [(768, 12, 64, 3072), (1024, 16, 64, 4096), (1408, 16, 88, 6144),
           (64, 2, 32, 128), (128, 2, 64, 256)]
_SEQS = [(1, 256), (8, 256), (256, 8), (2048, 8), (256, 16), (4096, 16),
         (1, 65), (8, 65), (2, 4096), (4, 24), (2, 1024)]


def test_chunk_plan_functions_match_jax():
  for (d, n, h, f), (b, t), itemsize in itertools.product(_WIDTHS, _SEQS,
                                                          (2, 4)):
    nh = n * h
    assert ttb.attention_block_supported(t, d, nh, itemsize) == \
        jtb.attention_block_supported(t, d, nh, itemsize), (d, t)
    assert ttb.attention_chunks_for(t, d, n, h, itemsize) == \
        jtb.attention_chunks_for(t, d, n, h, itemsize), (d, t)
    for rows in (b * t, b * t + (-t) % 8):
      assert ttb.ffn_block_supported(rows, d, f, itemsize) == \
          jtb.ffn_block_supported(rows, d, f, itemsize), (d, rows)
      assert ttb.ffn_chunks_for(rows, d, f, itemsize) == \
          jtb.ffn_chunks_for(rows, d, f, itemsize), (d, rows)


def test_chunk_plan_of_the_models():
  """The reference's choices in bf16 at 1 and 8 clips, for the spatial
  stack ([B*T, 256]) and the temporal one ([B*256, T]): base runs K1/K2,
  large chains its FFN in 2, giant its attention in 2 and its FFN in 4."""
  for (d, n, h, f), frames, want in ((_WIDTHS[0], 16, (None, None)),
                                     (_WIDTHS[1], 8, (None, 2)),
                                     (_WIDTHS[2], 8, (2, 4))):
    for clips in (1, 8):
      for b, t in ((clips * frames, 256), (clips * 256, frames)):
        assert ttfm.chunk_plan(b, t, d, n, h, f, 2, causal=False) == want


def test_chunk_plan_reads_the_reference_lengths():
  """The plan sees T padded to 8 and short sequences packed to 128, as the
  reference's stacked_transformer hands them to its kernels."""
  d, n, h, f = _WIDTHS[1]
  # lvt large's text tower at B=1: 65 tokens padded to 72 rows, which the
  # chunked FFN takes (65 rows would take no kernel).
  assert jtb.ffn_chunks_for(65, d, f, 2) is None
  assert ttfm.chunk_plan(1, 65, d, n, h, f, 2, causal=True) == (None, 2)
  # 8-token sequences at D = 1280: K1 fits at T = 8, not at the packed
  # T = 128; a causal stack is not packed.
  packed = jtb.attention_chunks_for(128, 1280, 10, 128, 2)
  assert packed is not None
  assert ttfm.chunk_plan(16, 8, 1280, 10, 128, 256, 2,
                         causal=False)[0] == packed
  assert ttfm.chunk_plan(16, 8, 1280, 10, 128, 256, 2,
                         causal=True)[0] is None


class TestLayerRoute:

  def _run(self, monkeypatch, plan, n=4, h=32):
    rng = np.random.default_rng(7)
    p = _layer(7, n, h)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    pads = _paddings(B, T)
    kw = dict(num_layers=1, hidden_dim=F, num_heads=n, activation='gelu',
              enable_per_dim_scale=False, logit_cap=50.0)
    called = []

    def spy(name):
      fn = getattr(ttb, name)

      def wrapped(*args, **kwargs):
        called.append((name, kwargs.get('chunks')))
        return fn(*args, **kwargs)
      monkeypatch.setattr(ttb, name, wrapped)

    for name in ('fused_attention_block', 'fused_attention_block_chunked',
                 'fused_ffn_block', 'fused_ffn_block_chunked'):
      spy(name)
    monkeypatch.setattr(ttfm, 'chunk_plan', lambda *a, **k: plan)
    tx, tp = torch.from_numpy(x), torch.from_numpy(pads)
    got = ttfm.transformer_layer(
        jax.tree.map(torch.from_numpy, p), tx, tp,
        ttfm.mask_lib.attention_mask_for_fprop(tx, tp),
        ttfm.TransformerLayerConfig(**kw))
    want = jtfm.transformer_layer(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), jnp.asarray(pads),
        jtfm.mask_lib.attention_mask_for_fprop(jnp.asarray(x),
                                               jnp.asarray(pads)),
        jtfm.TransformerLayerConfig(**kw))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)
    return called

  def test_takes_the_planned_blocks_and_matches_jax(self, monkeypatch):
    for plan in ((2, 4), (4, 2), (None, 2), (None, None)):
      with monkeypatch.context() as patch:
        called = self._run(patch, plan)
      attn, ffn = plan
      assert called == [
          ('fused_attention_block_chunked', attn) if attn
          else ('fused_attention_block', None),
          ('fused_ffn_block_chunked', ffn) if ffn
          else ('fused_ffn_block', None)], plan


class TestCapacityGate:
  """K1's capacity on the card (ROADMAP fault 3.1), with the shared-memory
  query replaced by a stand-in that holds T <= 784."""

  @pytest.fixture(autouse=True)
  def _capacity(self, monkeypatch):
    monkeypatch.setattr(_lib, 'max_attention_t', lambda h: 784)

  def test_gate(self):
    mask = torch.zeros((1, 1, 1, 1024))
    assert ttfm.fused_attention_supported(1024, mask)       # the CPU twins
    assert not ttfm.fused_attention_supported(1024, mask, 64)
    assert ttfm.fused_attention_supported(784, mask[..., :784], 64)
    assert not ttfm.fused_attention_supported(1040, mask[..., :1], 64)

  @pytest.mark.parametrize('h,routes', [(24, 'composed'), (20, 'raises')])
  def test_layer_past_capacity(self, monkeypatch, h, routes):
    """Past K1's capacity the kernel path takes the composed half (K6 +
    K5) where K5 takes the head dim (24, a multiple of 8 but not of 16, as
    giant's 88; and 20, padded to 24), and raises naming the limit where
    it does not (20 with K5's maximum replaced by 16)."""
    n, t = 4, 800
    p = _layer(8, n, h)
    composed = []
    monkeypatch.setattr(_lib, 'use_kernel', lambda impl, x: True)
    monkeypatch.setattr(ttfm.basic, 'layer_norm',
                        lambda *a, **k: composed.append(1) or a[1])
    monkeypatch.setattr(ttfm.attention_lib, 'multi_head_attention',
                        lambda *a, **k: torch.zeros_like(a[1]))
    monkeypatch.setattr(ttb, 'fused_ffn_block',
                        lambda x, *a, **k: x)
    monkeypatch.setattr(ttb, 'fused_ffn_block_chunked',
                        lambda x, *a, **k: x)
    x = torch.zeros((1, t, D))
    cfg = ttfm.TransformerLayerConfig(num_layers=1, hidden_dim=F, num_heads=n,
                                      activation='gelu',
                                      enable_per_dim_scale=False)
    call = lambda: ttfm.transformer_layer(
        jax.tree.map(torch.from_numpy, p), x, None,
        torch.zeros((1, 1, 1, t)), cfg)
    call()
    assert composed == [1]
    if routes == 'raises':
      monkeypatch.setattr(ttfm.flash, 'MAX_HEAD_DIM', 16)
      with pytest.raises(ValueError, match=r'T <= 784.*at most 16'):
        call()
