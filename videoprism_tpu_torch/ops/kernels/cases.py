"""Seeded inputs at the main path's shapes for each kernel, and the check
of a kernel against its plain twin on the card.

Used by ``chip_smoke.py`` and ``tests/test_torch_gpu.py``.  Every input is
drawn with ``numpy.random.default_rng(seed)``; LN scales and biases are
non-zero so that a dropped term shows.  :func:`bound` gives the least time
the card could take for a case's work (H100 SXM peaks); the chunked
kernels' bound is the unchunked function's (each input read once, each
output written once).

Tolerance: the kernel and the bf16 twin round to bf16 at the same points
and differ only in summation order, so they are compared in fp32 with
``atol = rtol = 2e-2`` (a few bf16 ulps at the outputs' magnitude).  Both
are also held against the fp32 twin on the same inputs: the kernel's max
error there may be at most twice the bf16 twin's.

The chunked kernels (K8a, K8b) differ from K1/K2 only by one bf16 cast of
the running output per extra chunk, which the tolerance above cannot see.
So a chunked case is also held against the one-chunk twin on the same
inputs: the share of output elements whose bits differ from the chunked
twin must be below ``CHUNK_SHARE_RATIO`` times the share that differ from
the one-chunk twin.  A wrapper that ignored ``chunks`` would show the
reverse.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable

import numpy as np
import torch

from videoprism_tpu_torch.ops.kernels import _lib
from videoprism_tpu_torch.ops.kernels import boundary
from videoprism_tpu_torch.ops.kernels import flash_attention as flash
from videoprism_tpu_torch.ops.kernels import layer_norm as ln_kernel
from videoprism_tpu_torch.ops.kernels import transformer_block as tb

ATOL = RTOL = 2e-2
FP32_ERR_RATIO = 2.0
CHUNK_SHARE_RATIO = 0.5
# One H100 SXM at 700 W (NVIDIA's data sheet, dense): bf16 tensor cores,
# fp32 outside them, and HBM3.
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# fp32 operations per element of a row LayerNorm (sum, centre, square,
# sum, scale, shift), counted against the fp32 peak.
LN_OPS_PER_ELEMENT = 8


@dataclasses.dataclass
class Case:
  kernel: str                 # wrapper name, the key of _lib.LAUNCHES
  label: str
  fn: Callable[..., torch.Tensor]
  args: tuple
  kwargs: dict


def _tensor(a: np.ndarray, device, dtype=torch.bfloat16) -> torch.Tensor:
  return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(
      device=device, dtype=dtype)


def _paddings(rng, b: int, t: int, padded: bool) -> np.ndarray:
  """[b, t] paddings: none, or ragged tails plus one fully padded row."""
  pads = np.zeros((b, t), np.float32)
  if padded:
    lengths = rng.integers(1, t + 1, size=b)
    pads[np.arange(t)[None, :] >= lengths[:, None]] = 1.0
    pads[-1] = 1.0
  return pads


def _self_mask(pads: np.ndarray, causal: bool) -> np.ndarray:
  """[b, 1, t] key mask, or with ``causal`` the [b, t, t] mask of the text
  tower: a padded query or key, or a key after the query, is masked (a
  padded query's row is fully masked)."""
  if not causal:
    return pads[:, None, :] * np.float32(tb.NEG_INF)
  t = pads.shape[1]
  masked = ((pads[:, :, None] + pads[:, None, :]) > 0) | (
      np.arange(t)[None, None, :] > np.arange(t)[None, :, None])
  return masked.astype(np.float32) * np.float32(tb.NEG_INF)


def attention_case(b: int, t: int, d: int, heads: int, head_dim: int, *,
                   cap: float, padded: bool, device, causal: bool = False,
                   chunks: int | None = None, seed: int = 0) -> Case:
  """K1, or K8a over ``chunks`` head groups."""
  rng = np.random.default_rng(seed)
  nh = heads * head_dim
  w = lambda *s: rng.standard_normal(s) / np.sqrt(s[0])
  small = lambda *s: 0.1 * rng.standard_normal(s)
  mask = _self_mask(_paddings(rng, b, t, padded), causal)
  args = (_tensor(rng.standard_normal((b, t, d)), device),
          _tensor(mask, device, torch.float32),
          _tensor(small(d), device), _tensor(small(d), device),
          _tensor(w(d, 3 * nh), device), _tensor(small(3 * nh), device),
          _tensor(w(nh, d), device), _tensor(small(d), device))
  kwargs = dict(num_heads=heads, dim_per_head=head_dim, logit_cap=cap,
                query_scale=head_dim ** -0.5)
  label = (f'[{b},{t},{d}] H={head_dim} cap={cap:g} padded={padded}'
           + (' causal' if causal else ''))
  if chunks is None:
    return Case('fused_attention_block', label, tb.fused_attention_block,
                args, kwargs)
  return Case('fused_attention_block_chunked', f'{label} chunks={chunks}',
              tb.fused_attention_block_chunked, args,
              dict(kwargs, chunks=chunks))


def flash_case(b: int, heads: int, t: int, s: int, head_dim: int, *,
               cap: float, mask: str, device, seed: int = 0) -> Case:
  """K5 on q [b, heads, t, head_dim] against s keys.  ``mask``: 'none'
  (zeros [b, 1, s], the auxiliary encoder's), 'keys' (ragged key padding
  [b, 1, s] and one fully padded sequence, whose rows are all masked) or
  'rows' ([b, t, s]: causal where t = s, plus fully masked rows)."""
  rng = np.random.default_rng(seed)
  qkv = [rng.standard_normal((b, heads, n, head_dim)) for n in (t, s, s)]
  qkv[0] = qkv[0] * (3.0 / np.sqrt(head_dim))   # logits of std ~3
  if mask == 'none':
    m = np.zeros((b, 1, s), np.float32)
  elif mask == 'keys':
    m = _paddings(rng, b, s, True)[:, None, :] * np.float32(tb.NEG_INF)
  else:
    masked = np.arange(s)[None, None, :] > np.arange(t)[None, :, None]
    masked = np.broadcast_to(masked, (b, t, s)).copy()
    masked[-1, : t // 3] = True
    m = masked.astype(np.float32) * np.float32(tb.NEG_INF)
  args = (*(_tensor(a, device) for a in qkv), _tensor(m, device, torch.float32))
  return Case('fused_attention',
              f'[{b},{heads},{t},{head_dim}] S={s} cap={cap:g} mask={mask}',
              flash.fused_attention, args, dict(logit_cap=cap))


def layer_norm_case(rows: int, d: int, *, direct_scale: bool, device,
                    seed: int = 0) -> Case:
  rng = np.random.default_rng(seed)
  scale = (1.0 + 0.1 * rng.standard_normal(d) if direct_scale
           else 0.1 * rng.standard_normal(d))
  args = (_tensor(2.0 * rng.standard_normal((rows, d)) + 0.5, device),
          _tensor(scale, device), _tensor(0.1 * rng.standard_normal(d), device))
  return Case('fused_layer_norm_2d',
              f'rows={rows} D={d} direct_scale={direct_scale}',
              ln_kernel.fused_layer_norm_2d, args,
              dict(direct_scale=direct_scale))


def ffn_case(rows: int, d: int, f: int, *, activation: str, padded: bool,
             device, chunks: int | None = None, seed: int = 0) -> Case:
  """K2, or K8b over ``chunks`` F-slices."""
  rng = np.random.default_rng(seed)
  w = lambda *s: rng.standard_normal(s) / np.sqrt(s[0])
  small = lambda *s: 0.1 * rng.standard_normal(s)
  pads = _paddings(rng, rows // 8, 8, padded).reshape(rows, 1)
  args = (_tensor(rng.standard_normal((rows, d)), device),
          _tensor(pads, device),
          _tensor(small(d), device), _tensor(small(d), device),
          _tensor(w(d, f), device), _tensor(small(f), device),
          _tensor(w(f, d), device), _tensor(small(d), device))
  label = f'rows={rows} D={d} F={f} {activation} padded={padded}'
  if chunks is None:
    return Case('fused_ffn_block', label, tb.fused_ffn_block, args,
                dict(activation=activation))
  return Case('fused_ffn_block_chunked', f'{label} chunks={chunks}',
              tb.fused_ffn_block_chunked, args,
              dict(activation=activation, chunks=chunks))


def boundary_cases(b: int, t: int, n: int, d: int, *, device,
                   seed: int = 0) -> list[Case]:
  rng = np.random.default_rng(seed)
  small = lambda *s: 0.1 * rng.standard_normal(s)
  st = (_tensor(rng.standard_normal((b * t, n, d)), device),
        _tensor(small(d), device), _tensor(small(d), device),
        _tensor(rng.standard_normal((t, d)), device))
  ts = (_tensor(rng.standard_normal((b * n, t, d)), device),
        _tensor(small(d), device), _tensor(small(d), device))
  return [
      Case('spatial_to_temporal', f'b={b} t={t} n={n} d={d}',
           boundary.spatial_to_temporal, st, dict(b=b, t=t)),
      Case('temporal_to_output', f'b={b} t={t} n={n} d={d}',
           boundary.temporal_to_output, ts, dict(b=b, n=n)),
  ]


def main_path_cases(device, *, batch: int = 2, d: int = 768,
                    heads: int = 12, f: int = 3072, frames: int = 16,
                    tokens: int = 256) -> list[Case]:
  """Every kernel at the base encoder's shapes for ``batch`` clips, with
  and without paddings (incl. a fully padded sequence), cap 50 and 0."""
  hd = d // heads
  cases = []
  for cap in (50.0, 0.0):
    for padded in (False, True):
      cases.append(attention_case(batch * frames, tokens, d, heads, hd,
                                  cap=cap, padded=padded, device=device))
      cases.append(attention_case(batch * tokens, frames, d, heads, hd,
                                  cap=cap, padded=padded, device=device))
  for activation in ('gelu', 'relu'):
    for padded in (False, True):
      cases.append(ffn_case(batch * frames * tokens, d, f,
                            activation=activation, padded=padded,
                            device=device))
  return cases + boundary_cases(batch, frames, tokens, d, device=device)


def clip_path_cases(device, *, batch: int = 2, d: int = 768,
                    heads: int = 12, tokens: int = 4096,
                    text_len: int = 65) -> list[Case]:
  """The kernels the CLIP model adds, at lvt base's shapes for ``batch``
  requests: K5 over the auxiliary encoder's tokens (cap 50 and 0, with
  fully masked rows), K6 at the aux pre-LN's rows and at an odd row count
  (both scale conventions), K1 with the text tower's causal + padding mask
  at its unpadded length."""
  hd = d // heads
  cases = []
  for cap in (50.0, 0.0):
    for mask in ('keys', 'rows'):
      cases.append(flash_case(batch, heads, tokens, tokens, hd, cap=cap,
                              mask=mask, device=device))
    cases.append(attention_case(batch, text_len, d, heads, hd, cap=cap,
                                padded=True, causal=True, device=device))
  for rows in (batch * tokens, 130):
    for direct_scale in (False, True):
      cases.append(layer_norm_case(rows, d, direct_scale=direct_scale,
                                   device=device))
  return cases


# (D, heads, head dim, F, frames) of the classifier's encoders.
LARGE = (1024, 16, 64, 4096, 8)
GIANT = (1408, 16, 88, 6144, 8)


def wide_path_cases(device, *, batch: int = 2,
                    tokens: int = 256) -> list[Case]:
  """Every kernel of the large and giant classifiers at their shapes for
  ``batch`` clips of 8 frames, with and without paddings: K1 at large's
  spatial and temporal stacks (16 heads of 64, cap 50 and 0), K8a at
  giant's (2 head groups of 8 x 88), K8b at large's (2 F-slices) and
  giant's (4 F-slices) rows, K3 and K4 at both widths, and K6 at the
  pooler's [batch, D] rows."""
  cases = []
  for (d, heads, hd, _, frames), chunks in ((LARGE, None), (GIANT, 2)):
    for cap in (50.0, 0.0):
      for padded in (False, True):
        cases.append(attention_case(batch * frames, tokens, d, heads, hd,
                                    cap=cap, padded=padded, chunks=chunks,
                                    device=device))
        cases.append(attention_case(batch * tokens, frames, d, heads, hd,
                                    cap=cap, padded=padded, chunks=chunks,
                                    device=device))
  for (d, _, _, f, frames), chunks in ((LARGE, 2), (GIANT, 4)):
    for padded in (False, True):
      cases.append(ffn_case(batch * frames * tokens, d, f, activation='gelu',
                            padded=padded, chunks=chunks, device=device))
    cases += boundary_cases(batch, frames, tokens, d, device=device)
    cases.append(layer_norm_case(batch, d, direct_scale=False,
                                 device=device))
  return cases


def capacity_cases(device, *, batch: int = 2) -> list[Case]:
  """K1 at the longest sequence its attention core holds, at the base and
  large head dim (64: T = 784) and at giant's (88: T = 544); one past it
  raises ValueError."""
  cases = []
  for d, heads, hd in ((768, 12, 64), (GIANT[0], GIANT[1], GIANT[2])):
    t = _lib.max_attention_t(hd)
    cases.append(attention_case(batch, t, d, heads, hd, cap=50.0, padded=True,
                                device=device))
  return cases


def bound(case: Case) -> tuple[float, str]:
  """(ms, 'bytes' | 'operations'): the least time the card could take for
  the case's work, the larger of its bytes (each input read once, each
  output written once) over HBM's rate and its operations over the peak
  for their type (matrix products at the bf16 tensor-core peak, LayerNorm
  arithmetic at the fp32 peak)."""
  args, kw = case.args, case.kwargs
  nbytes = sum(a.numel() * a.element_size() for a in args)
  if case.kernel in ('fused_attention_block',
                     'fused_attention_block_chunked'):
    x = args[0]
    b, t, d = x.shape
    nh = kw['num_heads'] * kw['dim_per_head']
    out_bytes = x.numel() * x.element_size()
    flops = (2 * b * t * d * 4 * nh
             + 4 * b * kw['num_heads'] * t * t * kw['dim_per_head'])
    ops_s = flops / PEAK_BF16_FLOPS
  elif case.kernel in ('fused_ffn_block', 'fused_ffn_block_chunked'):
    x, w1 = args[0], args[4]
    out_bytes = x.numel() * x.element_size()
    ops_s = 4 * x.shape[0] * w1.shape[0] * w1.shape[1] / PEAK_BF16_FLOPS
  elif case.kernel == 'fused_attention':
    q, k = args[0], args[1]
    b, n, t, h = q.shape
    out_bytes = q.numel() * q.element_size()
    ops_s = 4 * b * n * t * k.shape[2] * h / PEAK_BF16_FLOPS
  else:   # row LayerNorms: K3, K4, K6
    x = args[0]
    out_bytes = x.numel() * x.element_size()
    ops_s = LN_OPS_PER_ELEMENT * x.numel() / PEAK_FP32_FLOPS
  bytes_s = (nbytes + out_bytes) / PEAK_BYTES
  return 1e3 * max(bytes_s, ops_s), ('bytes' if bytes_s >= ops_s
                                     else 'operations')


def run_case(case: Case) -> dict:
  """Kernel vs bf16 twin vs fp32 twin (and, for a chunked case, vs the
  one-chunk bf16 twin); returns the errors and a verdict."""
  out = case.fn(*case.args, **case.kwargs, impl='kernel')
  ref = case.fn(*case.args, **case.kwargs, impl='reference')
  args32 = tuple(a.float() for a in case.args)
  ref32 = case.fn(*args32, **case.kwargs, impl='reference')
  out, ref = out.float(), ref.float()
  err = (out - ref).abs().max().item()
  err_kernel32 = (out - ref32).abs().max().item()
  err_twin32 = (ref - ref32).abs().max().item()
  ok = (bool(torch.isfinite(out).all())
        and torch.allclose(out, ref, atol=ATOL, rtol=RTOL)
        and err_kernel32 <= FP32_ERR_RATIO * err_twin32)
  result = dict(kernel=case.kernel, label=case.label, max_abs_err=err,
                err_vs_fp32=err_kernel32, twin_err_vs_fp32=err_twin32)
  if case.kwargs.get('chunks', 1) > 1:
    one = case.fn(*case.args, **dict(case.kwargs, chunks=1),
                  impl='reference').float()
    result.update(
        differ_chunked=(out != ref).float().mean().item(),
        differ_one_chunk=(out != one).float().mean().item(),
        err_vs_one_chunk=(out - one).abs().max().item())
    ok = ok and (result['differ_chunked']
                 < CHUNK_SHARE_RATIO * result['differ_one_chunk'])
  return dict(result, ok=ok)
