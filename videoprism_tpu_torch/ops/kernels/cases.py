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

The int8 kernels (K9-K12b) are held to the same tolerances against their
twins: both quantize the same fp32 values, and where an fp32 ulp of
difference moves an activation code by one step the output row moves by
one quantization step, ~1e-3 at the base width, far inside 2e-2.  K11
casts twice (the half-layer output x1, then the output), and an ulp of x1
reaches the output unchanged even where the FFN's sum cancels it to a
small value, so its ``rtol`` is taken of the row's largest output instead
of each element (measured on the card at the base width: kernel and twin
2 ulps apart at |x1| ~ 5, both 0.0677 from the fp32 twin).  K7 (the flash
backward) casts dl to bf16 before its dq and dk products, and dl reaches
~10 where dP = dO V^T does: where kernel and twin round one dl to
neighbouring bf16 values, dq or dk moves by that ulp times |k| or |q|
whatever its own value, so K7 takes the same row-scaled ``rtol`` on each
of its outputs (measured on the card at the temporal shape: an output
0.0625 from the twin, both 0.161 from the fp32 twin).  Their weights
are seeded floats quantized as ``quantization`` does.

The chunked kernels (K8a, K8b) differ from K1/K2 only by one bf16 cast of
the running output per extra chunk, which the tolerance above cannot see.
So a chunked case is also held against the one-chunk twin on the same
inputs: the share of output elements whose bits differ from the chunked
twin must be below ``CHUNK_SHARE_RATIO`` times the share that differ from
the one-chunk twin.  A wrapper that ignored ``chunks`` would show the
reverse.  A chunked int8 case (K9, K10) differs from its one-chunk twin
mostly by the scales taken per chunk, so it is also held, by the same
ratio, against its chunks' products summed in fp32 and cast once.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable

import numpy as np
import torch

from videoprism_tpu_torch import quantization
from videoprism_tpu_torch.ops import transformer as transformer_lib
from videoprism_tpu_torch.ops.kernels import boundary
from videoprism_tpu_torch.ops.kernels import flash_attention as flash
from videoprism_tpu_torch.ops.kernels import int8_blocks as i8
from videoprism_tpu_torch.ops.kernels import layer_norm as ln_kernel
from videoprism_tpu_torch.ops.kernels import transformer_block as tb

ATOL = RTOL = 2e-2
FP32_ERR_RATIO = 2.0
CHUNK_SHARE_RATIO = 0.5
# One H100 SXM at 700 W (NVIDIA's data sheet, dense): bf16 tensor cores,
# fp32 outside them, and HBM3.
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
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


def flash_bwd_case(b: int, heads: int, t: int, s: int, head_dim: int, *,
                   cap: float, mask: str, with_ctx: bool, device,
                   stats: bool = False, seed: int = 0) -> Case:
  """K7 on :func:`flash_case`'s inputs and masks, with a seeded output
  cotangent dO [b, heads, t, head_dim]; with ``stats`` (a CUDA device) it
  is given K5's row statistics of those inputs, as under autograd."""
  fwd = flash_case(b, heads, t, s, head_dim, cap=cap, mask=mask,
                   device=device, seed=seed)
  do = np.random.default_rng(seed + 1).standard_normal((b, heads, t, head_dim))
  label = fwd.label + (' with ctx' if with_ctx else '')
  kwargs = dict(logit_cap=cap, with_ctx=with_ctx)
  if stats:
    _, kwargs['stats'] = flash._fused_attention(*fwd.args, cap, 'kernel',
                                                with_stats=True)
    label += " given K5's statistics"
  return Case('fused_attention_bwd', label, flash.fused_attention_bwd,
              (*fwd.args, _tensor(do, device)), kwargs)


def flash_bwd_path_cases(device, *, batch: int = 2) -> list[Case]:
  """K7 at the lvt base train step's shapes for ``batch`` clips: the
  auxiliary encoder's (no ctx, cap 50, given K5's statistics as the step
  gives them), the spatial and temporal stacks' and the causal text
  tower's (with ctx); a fully masked query row (a fully padded sequence);
  no cap; and with ctx at vc giant's spatial shape (16 heads of 88, for
  ``batch`` clips of 8 frames)."""
  kw = dict(head_dim=64, device=device)
  return [
      flash_bwd_case(batch, 12, 4096, 4096, cap=50.0, mask='none',
                     with_ctx=False, stats=True, **kw),
      flash_bwd_case(16 * batch, 12, 256, 256, cap=50.0, mask='none',
                     with_ctx=True, **kw),
      flash_bwd_case(256 * batch, 12, 16, 16, cap=50.0, mask='none',
                     with_ctx=True, **kw),
      flash_bwd_case(batch, 12, 65, 65, cap=50.0, mask='rows',
                     with_ctx=True, **kw),
      flash_bwd_case(batch, 12, 256, 256, cap=50.0, mask='keys',
                     with_ctx=True, **kw),
      flash_bwd_case(16 * batch, 12, 256, 256, cap=0.0, mask='keys',
                     with_ctx=True, **kw),
      flash_bwd_case(8 * batch, GIANT[1], 256, 256, head_dim=GIANT[2],
                     cap=50.0, mask='none', with_ctx=True, device=device),
  ]


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
  pads = (_paddings(rng, rows // 8, 8, padded) if rows % 8 == 0
          else _paddings(rng, 1, rows, padded)).reshape(rows, 1)
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
  fully masked rows; at lvt base's head dim and at giant's 88, which K5
  pads to 96), K6 at the aux pre-LN's rows and at an odd row count (both
  scale conventions), K1 with the text tower's causal + padding mask at
  its unpadded length."""
  hd = d // heads
  cases = []
  for cap in (50.0, 0.0):
    for mask in ('keys', 'rows'):
      for head_dim in (hd, GIANT[2]):
        cases.append(flash_case(batch, heads, tokens, tokens, head_dim,
                                cap=cap, mask=mask, device=device))
    cases.append(attention_case(batch, text_len, d, heads, hd, cap=cap,
                                padded=True, causal=True, device=device))
  for rows in (batch * tokens, 130):
    for direct_scale in (False, True):
      cases.append(layer_norm_case(rows, d, direct_scale=direct_scale,
                                   device=device))
  return cases


def _int8(rng, k: int, n: int, device) -> tuple[torch.Tensor, torch.Tensor]:
  """A seeded float [k, n] weight quantized per output column -> (int8
  [k, n], fp32 scales [n])."""
  q, s = quantization._quantize_leaf(rng.standard_normal((k, n)) / np.sqrt(k),
                                     (0,))
  return (torch.from_numpy(q).to(device),
          _tensor(s, device, torch.float32))


def _int8_attention_operands(rng, d: int, nh: int, device) -> tuple:
  """LN scale and bias, then (w, s, b) of q, k, v and o."""
  small = lambda *s: _tensor(0.1 * rng.standard_normal(s), device)
  ops = [small(d), small(d)]
  for _ in range(3):
    ops += [*_int8(rng, d, nh, device), small(nh)]
  return (*ops, *_int8(rng, nh, d, device), small(d))


def _int8_ffn_operands(rng, d: int, f: int, device) -> tuple:
  small = lambda *s: _tensor(0.1 * rng.standard_normal(s), device)
  return (small(d), small(d), *_int8(rng, d, f, device), small(f),
          *_int8(rng, f, d, device), small(d))


def _attention_kmajor(ops, heads: int, head_dim: int) -> dict:
  """The kernels' K-major operands of ``_int8_attention_operands``' q, k,
  v and o (``prepare_for_kernels``' layout)."""
  geometry = dict(num_heads=heads, dim_per_head=head_dim)
  return dict(i8.int8_qkv_kmajor(*ops[2:11], **geometry),
              **i8.int8_out_kmajor(ops[11], **geometry))


def int8_ffn_case(rows: int, d: int, f: int, *, activation: str,
                  padded: bool, chunks: int, device, seed: int = 0) -> Case:
  """K9 over ``chunks`` F-chunks."""
  rng = np.random.default_rng(seed)
  pads = _paddings(rng, rows // 8, 8, padded).reshape(rows, 1)
  args = (_tensor(rng.standard_normal((rows, d)), device),
          _tensor(pads, device), *_int8_ffn_operands(rng, d, f, device))
  return Case('int8_ffn_block_chunked',
              f'rows={rows} D={d} F={f} {activation} padded={padded} '
              f'chunks={chunks}', i8.int8_ffn_block_chunked, args,
              dict(activation=activation, chunks=chunks,
                   kmajor=i8.int8_ffn_kmajor(args[4], args[7])))


def int8_attention_case(b: int, t: int, d: int, heads: int, head_dim: int, *,
                        cap: float, padded: bool, chunks: int, device,
                        causal: bool = False, seed: int = 0) -> Case:
  """K10 over ``chunks`` head groups."""
  rng = np.random.default_rng(seed)
  mask = _self_mask(_paddings(rng, b, t, padded), causal)
  ops = _int8_attention_operands(rng, d, heads * head_dim, device)
  args = (_tensor(rng.standard_normal((b, t, d)), device),
          _tensor(mask, device, torch.float32), *ops)
  return Case('int8_attention_block_chunked',
              f'[{b},{t},{d}] H={head_dim} cap={cap:g} padded={padded}'
              f'{" causal" if causal else ""} chunks={chunks}',
              i8.int8_attention_block_chunked, args,
              dict(num_heads=heads, dim_per_head=head_dim, chunks=chunks,
                   logit_cap=cap, query_scale=head_dim ** -0.5,
                   kmajor=_attention_kmajor(ops, heads, head_dim)))


def int8_layer_case(b: int, t: int, d: int, heads: int, head_dim: int,
                    f: int, *, cap: float, padded: bool,
                    chunks: tuple[int, int], device, causal: bool = False,
                    seed: int = 0) -> Case:
  """K11 with (head_chunks, ffn_chunks)."""
  rng = np.random.default_rng(seed)
  pads = _paddings(rng, b, t, padded)
  ops = _int8_attention_operands(rng, d, heads * head_dim, device)
  args = (_tensor(rng.standard_normal((b, t, d)), device),
          _tensor(_self_mask(pads, causal), device, torch.float32),
          _tensor(pads[..., None], device), *ops,
          *_int8_ffn_operands(rng, d, f, device))
  kmajor = dict(_attention_kmajor(ops, heads, head_dim),
                **i8.int8_ffn_kmajor(args[19], args[22]))
  return Case('int8_layer_block',
              f'[{b},{t},{d}] H={head_dim} F={f} cap={cap:g} padded={padded}'
              f'{" causal" if causal else ""} chunks={chunks}',
              i8.int8_layer_block, args,
              dict(num_heads=heads, dim_per_head=head_dim, logit_cap=cap,
                   query_scale=head_dim ** -0.5, head_chunks=chunks[0],
                   ffn_chunks=chunks[1], kmajor=kmajor))


def int8_projection_cases(rows: int, d: int, nh: int, *, device,
                          seed: int = 0) -> list[Case]:
  """K12a on x [rows, d] and K12b on ctx [rows, nh] (ctx of unit scale,
  as the attention core gives it)."""
  rng = np.random.default_rng(seed)
  ops = _int8_attention_operands(rng, d, nh, device)
  x = _tensor(rng.standard_normal((rows, d)), device)
  ctx = _tensor(0.5 * rng.standard_normal((rows, nh)), device)
  one_head = dict(num_heads=1, dim_per_head=nh)
  return [
      Case('int8_qkv_projection', f'rows={rows} D={d} NH={nh}',
           i8.int8_qkv_projection, (x, *ops[:11]),
           dict(query_scale=0.125,
                kmajor=i8.int8_qkv_kmajor(*ops[2:11], **one_head))),
      Case('int8_out_projection', f'rows={rows} NH={nh} D={d}',
           i8.int8_out_projection, (ctx, x, *ops[11:]),
           dict(kmajor=i8.int8_out_kmajor(ops[11], **one_head))),
  ]


def int8_path_cases(device, *, batch: int = 2, d: int = 768,
                    heads: int = 12, f: int = 3072, frames: int = 16,
                    tokens: int = 256, aux_tokens: int = 4096,
                    text_len: int = 65) -> list[Case]:
  """The int8 kernels at the base encoder's and lvt base's shapes for
  ``batch`` requests (K11 at the spatial (2, 1) and temporal (1, 1) stacks
  and the causal text tower; K10 and K9 at those shapes, which B = 8
  takes; K12a/K12b and K9 at the auxiliary encoder's rows), with and
  without paddings, cap 50 and 0, and one chunks = 2 case of K9 and K10
  and a (2, 2) case of K11."""
  hd = d // heads
  cases = []
  for cap, padded in ((50.0, False), (0.0, True)):
    cases += [
        int8_layer_case(batch * frames, tokens, d, heads, hd, f, cap=cap,
                        padded=padded, chunks=(2, 1), device=device),
        int8_layer_case(batch * tokens, frames, d, heads, hd, f, cap=cap,
                        padded=padded, chunks=(1, 1), device=device),
        int8_layer_case(batch, text_len, d, heads, hd, f, cap=cap,
                        padded=True, causal=True, chunks=(1, 1),
                        device=device),
        int8_attention_case(batch * frames, tokens, d, heads, hd, cap=cap,
                            padded=padded, chunks=1, device=device),
        int8_attention_case(batch * tokens, frames, d, heads, hd, cap=cap,
                            padded=padded, chunks=1, device=device),
    ]
  for activation, padded in (('gelu', False), ('relu', True)):
    cases.append(int8_ffn_case(batch * frames * tokens, d, f,
                               activation=activation, padded=padded,
                               chunks=1, device=device))
  cases += int8_projection_cases(batch * aux_tokens, d, d, device=device)
  cases += [
      int8_ffn_case(batch * aux_tokens, d, f, activation='gelu',
                    padded=True, chunks=2, device=device),
      int8_attention_case(batch * frames, tokens, d, heads, hd, cap=50.0,
                          padded=True, chunks=2, device=device),
      int8_layer_case(batch * tokens, frames, d, heads, hd, f, cap=50.0,
                      padded=True, chunks=(2, 2), device=device),
  ]
  return cases


INT8_LIBRARY_LAYOUTS = ('row-major B', 'TN')


def int8_library(case: Case, layout: str = 'row-major B'
                 ) -> Callable[[], object]:
  """``torch._int_mm`` over the int8 products of an int8 case (q|k|v as
  one product, as the kernels run it), on seeded int8 operands of their
  shapes: the library yardstick (no one PyTorch call computes a whole
  block).  ``layout``: B [K, N] row-major, or 'TN', B the transposed view
  of a K-major [N, K] tensor (column-major B, cuBLASLt's fastest int8
  layout)."""
  args, kw = case.args, case.kwargs
  gen = torch.Generator(device=args[0].device).manual_seed(0)
  i8r = lambda *s: torch.randint(-127, 128, s, generator=gen,
                                 dtype=torch.int8, device=args[0].device)
  rows = args[0].numel() // args[0].shape[-1]
  products = []
  if case.kernel in ('int8_attention_block_chunked', 'int8_layer_block',
                     'int8_qkv_projection'):
    d = args[0].shape[-1]
    nh = (kw['num_heads'] * kw['dim_per_head'] if 'num_heads' in kw
          else args[3].shape[1])
    products.append((rows, d, 3 * nh))
    if case.kernel != 'int8_qkv_projection':
      products.append((rows, nh, d))
  if case.kernel == 'int8_out_projection':
    products.append((rows, args[0].shape[1], args[2].shape[1]))
  if case.kernel in ('int8_ffn_block_chunked', 'int8_layer_block'):
    w1 = args[4] if case.kernel == 'int8_ffn_block_chunked' else args[19]
    d, f = w1.shape
    products += [(rows, d, f), (rows, f, d)]
  if layout == 'TN':
    operands = [(i8r(m, k), i8r(n, k).t()) for m, k, n in products]
  else:
    operands = [(i8r(m, k), i8r(k, n)) for m, k, n in products]
  return lambda: [torch._int_mm(a, b) for a, b in operands]


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


def int8_giant_cases(device, *, batch: int = 1,
                     tokens: int = 256) -> list[Case]:
  """The int8 kernels of the giant encoder at its shapes for ``batch``
  clips of 8 frames, with and without paddings: K10 at the spatial stack
  over 2 head groups of 8 x 88 (cap 50 and 0) and at the temporal stack in
  one, K9 over 2 F-slices of 3072 at the stacks' rows (the reference's
  counts, ``ops/transformer.py`` ``int8_plan``)."""
  d, heads, hd, f, frames = GIANT
  cases = []
  for cap in (50.0, 0.0):
    for padded in (False, True):
      cases.append(int8_attention_case(batch * frames, tokens, d, heads, hd,
                                       cap=cap, padded=padded, chunks=2,
                                       device=device))
  cases.append(int8_attention_case(batch * tokens, frames, d, heads, hd,
                                   cap=50.0, padded=True, chunks=1,
                                   device=device))
  for padded in (False, True):
    cases.append(int8_ffn_case(batch * frames * tokens, d, f,
                               activation='gelu', padded=padded, chunks=2,
                               device=device))
  return cases


def capacity_cases(device, *, batch: int = 2) -> list[Case]:
  """K1 at the longest sequence the fused route takes (T = 1024), at the
  base and large head dim (64) and at giant's (88, padded to 96 inside),
  with paddings."""
  t = transformer_lib.MAX_FUSED_ATTENTION_T
  return [attention_case(batch, t, d, heads, hd, cap=50.0, padded=True,
                         device=device)
          for d, heads, hd in ((768, 12, 64), GIANT[:3])]


def _int8_work(case: Case) -> tuple[int, float]:
  """(output bytes, seconds of operations) of an int8 case: its int8
  products at the int8 peak, the attention core's at the bf16 peak."""
  args, kw = case.args, case.kwargs
  x = args[0]
  rows, width = x.numel() // x.shape[-1], x.shape[-1]
  int8_ops = flops = 0
  out_bytes = x.numel() * x.element_size()
  if case.kernel in ('int8_attention_block_chunked', 'int8_layer_block'):
    b, t, d = x.shape
    n, hd = kw['num_heads'], kw['dim_per_head']
    int8_ops += 2 * rows * d * 4 * n * hd
    flops += 4 * b * n * t * t * hd
  if case.kernel == 'int8_qkv_projection':
    nh = args[3].shape[1]
    int8_ops += 2 * rows * width * 3 * nh
    out_bytes = 3 * rows * nh * x.element_size()
  if case.kernel == 'int8_out_projection':
    d = args[2].shape[1]
    int8_ops += 2 * rows * width * d
    out_bytes = rows * d * x.element_size()
  if case.kernel in ('int8_ffn_block_chunked', 'int8_layer_block'):
    w1 = args[4] if case.kernel == 'int8_ffn_block_chunked' else args[19]
    int8_ops += 4 * rows * w1.shape[0] * w1.shape[1]
  return out_bytes, int8_ops / PEAK_INT8_OPS + flops / PEAK_BF16_FLOPS


def bound(case: Case) -> tuple[float, str]:
  """(ms, 'bytes' | 'operations'): the least time the card could take for
  the case's work, the larger of its bytes (each input read once, each
  output written once) over HBM's rate and its operations over the peak
  for their type (matrix products at the bf16 tensor-core peak, int8
  products at the int8 peak, LayerNorm arithmetic at the fp32 peak)."""
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
  elif case.kernel == 'fused_attention_bwd':
    q, k = args[0], args[1]
    return flash_backward_bound(*q.shape[:3], k.shape[2], q.shape[3],
                                mask_rows=args[3].shape[1],
                                mask_batch=args[3].shape[0],
                                with_ctx=kw['with_ctx'])
  elif case.kernel.startswith('int8_'):
    out_bytes, ops_s = _int8_work(case)
  else:   # row LayerNorms: K3, K4, K6
    x = args[0]
    out_bytes = x.numel() * x.element_size()
    ops_s = LN_OPS_PER_ELEMENT * x.numel() / PEAK_FP32_FLOPS
  bytes_s = (nbytes + out_bytes) / PEAK_BYTES
  return 1e3 * max(bytes_s, ops_s), ('bytes' if bytes_s >= ops_s
                                     else 'operations')


def flash_backward_bound(b: int, n: int, t: int, s: int, h: int, *,
                         mask_rows: int = 1, mask_batch: int | None = None,
                         with_ctx: bool = False, itemsize: int = 2
                         ) -> tuple[float, str]:
  """(ms, 'bytes' | 'operations') of K7, the flash backward, by
  :func:`bound`'s rule from its shapes alone: the recomputed logits, dP =
  dO V^T, dq, dk and dv (and ctx with ``with_ctx``), products of
  2*b*n*t*s*h FLOPs each (the reference's own count, ``flash_attention.py``
  ``flops``) at the bf16 peak; q, k, v, dO and the fp32 mask [mask_batch,
  mask_rows, s] read and dq, dk, dv (and ctx) written once."""
  ops_s = (5 + with_ctx) * 2 * b * n * t * s * h / PEAK_BF16_FLOPS
  nbytes = ((4 + with_ctx) * b * n * t * h + 3 * b * n * s * h) * itemsize
  mask_bytes = 4 * (b if mask_batch is None else mask_batch) * mask_rows * s
  bytes_s = (nbytes + mask_bytes) / PEAK_BYTES
  return 1e3 * max(bytes_s, ops_s), ('bytes' if bytes_s >= ops_s
                                     else 'operations')


def _composed_last(a, chunks, w, ws, bias, pads, resid, *, summed):
  """The last product of an int8 block from the primitives in separate
  launches: ``a`` [rows, K] quantized per chunk (``i8.quantize_rows``),
  then ``i8.gemm_i8`` per chunk with the residual epilogue, the chunks'
  fp32 sum through a buffer (``summed``, K11 and K12b) or chained with a
  cast after each (K9, K10)."""
  rows, k = a.shape
  q, s = i8.quantize_rows(a, chunks=chunks)
  kc = k // chunks
  acc = (torch.empty((rows, w.shape[0]), dtype=torch.float32,
                     device=a.device) if summed and chunks > 1 else None)
  out = resid
  for c in range(chunks):
    cols = slice(c * kc, (c + 1) * kc)
    last = c == chunks - 1
    kw = dict(a_scale=s[:, c].contiguous(), b_scale=ws, epilogue='residual')
    a_c, w_c = q[:, cols].contiguous(), w[:, cols].contiguous()
    if summed and not last:
      i8.gemm_i8(a_c, w_c, acc_in=acc if c else None, acc_out=acc, **kw)
    elif summed:
      out = i8.gemm_i8(a_c, w_c, acc_in=acc if c else None, bias=bias,
                       pads=pads, residual=resid, **kw)
    else:
      out = i8.gemm_i8(a_c, w_c, bias=bias if c == 0 else None, pads=pads,
                       residual=out, **kw)
  return out


def int8_composed(case: Case):
  """An int8 case's output (K9-K12b) composed from the primitives in
  separate launches on the card: the quantizer (with the LN in front), the
  s8 GEMM with each block's epilogue, K1's attention core, the quantizer per
  chunk and the last product (``_composed_last``).  The blocks quantize in
  their products' prologues and sum their chunks on chip, in the same
  operations in the same order: their outputs are these bits."""
  a, kw = case.args, case.kwargs
  km = kw['kmajor']
  eps = kw.get('epsilon', 1e-6)
  if case.kernel == 'int8_out_projection':
    ctx, resid, _, so, bo = a
    return _composed_last(ctx, 1, km['wo'], so, bo, None, resid, summed=True)

  def qkv_of(x2, ln_s, ln_b, nh):
    h8, hs = i8.quantize_rows(x2, ln_scale=ln_s, ln_bias=ln_b, epsilon=eps)
    return i8.gemm_i8(h8, km['wqkv'], epilogue='qkv',
                      a_scale=hs.reshape(-1), b_scale=km['sqkv'],
                      bias=km['bqkv'], col_scale=kw.get('query_scale', 1.0),
                      scaled_cols=nh)

  def hidden(x2, pads, ln_s, ln_b, s1, b1):
    h8, hs = i8.quantize_rows(x2, ln_scale=ln_s, ln_bias=ln_b, epsilon=eps)
    return i8.gemm_i8(h8, km['w1'], epilogue='act_keep',
                      a_scale=hs.reshape(-1), b_scale=s1, bias=b1, pads=pads,
                      activation=kw.get('activation', 'gelu'))

  if case.kernel == 'int8_qkv_projection':
    nh = km['sqkv'].shape[0] // 3
    qkv = qkv_of(a[0], a[1], a[2], nh)
    return qkv[:, :nh], qkv[:, nh:2 * nh], qkv[:, 2 * nh:]
  if case.kernel == 'int8_ffn_block_chunked':
    x, pads = a[0], a[1]
    act = hidden(x, pads, a[2], a[3], a[5], a[6])
    return _composed_last(act, kw['chunks'], km['w2'], a[8], a[9], pads, x,
                          summed=False)
  x = a[0]
  b, t, d = x.shape
  heads, hp = kw['num_heads'], tb.padded_head_dim(kw['dim_per_head'])
  x2 = x.reshape(b * t, d)
  qkv = qkv_of(x2, a[2 + (case.kernel == 'int8_layer_block')],
               a[3 + (case.kernel == 'int8_layer_block')], heads * hp)
  ctx = i8.capped_core(qkv, a[1], batch=b, num_heads=heads, head_dim=hp,
                       logit_cap=kw['logit_cap'])
  if case.kernel == 'int8_attention_block_chunked':
    return _composed_last(ctx, kw['chunks'], km['wo'], a[14], a[15], None,
                          x2, summed=False).reshape(x.shape)
  pads = a[2].reshape(b * t, 1)
  x1 = _composed_last(ctx, kw['head_chunks'], km['wo'], a[15], a[16], None,
                      x2, summed=True)
  act = hidden(x1, pads, a[17], a[18], a[20], a[21])
  return _composed_last(act, kw['ffn_chunks'], km['w2'], a[23], a[24], pads,
                        x1, summed=True).reshape(x.shape)


def ffn_composed(case: Case) -> torch.Tensor:
  """K2's or K8b's output composed from the primitives in separate
  launches on the card: K6's row LayerNorm, then ``tb.gemm_bf16`` W1
  ('act_keep') and W2 ('residual') once per F-slice, each slice's output
  the next one's residual.  K8b's one chained W2 launch ('chain') makes
  the same operations in the same order: its output is these bits."""
  x, pads, ln_s, ln_b, w1, b1, w2, b2 = case.args
  h = ln_kernel.fused_layer_norm_2d(x, ln_s, ln_b, impl='kernel')
  a = tb.gemm_bf16(h, w1, epilogue='act_keep', bias=b1, pads=pads,
                   activation=case.kwargs['activation'])
  chunks = case.kwargs.get('chunks') or 1
  kc = a.shape[1] // chunks
  out = x
  for c in range(chunks):
    cols = slice(c * kc, (c + 1) * kc)
    out = tb.gemm_bf16(a[:, cols].contiguous(), w2[cols].contiguous(),
                       epilogue='residual', bias=b2 if c == 0 else None,
                       pads=pads, residual=out)
  return out


def _joined(out) -> torch.Tensor:
  """A kernel's output in fp32; K12a's q, k, v and K7's (ctx,) dq, dk, dv
  flattened end to end."""
  if isinstance(out, tuple):
    return torch.cat([o.float().flatten() for o in out])
  return out.float()


def _int8_cast_once(case: Case) -> torch.Tensor:
  """A chunked int8 case (K9, K10) with its chunks' products summed in
  fp32 and cast once, on the bf16 twin's path: it differs from the chunked
  twin only by the cast per chunk, which the one-chunk twin (whose scales
  are taken over all columns) cannot single out."""
  a, kw = case.args, case.kwargs
  if case.kernel == 'int8_ffn_block_chunked':
    keep = 1.0 - a[1].float()
    parts = i8._reference_hidden_parts(
        a[0], keep, *a[2:9], chunks=kw['chunks'],
        activation=kw['activation'], epsilon=1e-6)
    return i8._sum(parts, a[9], a[0], keep).float()
  ctx = i8._reference_ctx(
      *a[:13], num_heads=kw['num_heads'], dim_per_head=kw['dim_per_head'],
      logit_cap=kw['logit_cap'], epsilon=1e-6,
      query_scale=kw['query_scale'])
  return i8._sum(i8._parts(ctx, a[13], a[14], kw['chunks']), a[15],
                 a[0]).float()


def run_case(case: Case) -> dict:
  """Kernel vs bf16 twin vs fp32 twin (and, for a chunked case, vs the
  one-chunk bf16 twin); returns the errors and a verdict."""
  raw = lambda args, impl: case.fn(*args, **case.kwargs, impl=impl)
  run = lambda args, impl: _joined(raw(args, impl))
  outs, refs = raw(case.args, 'kernel'), raw(case.args, 'reference')
  out, ref = _joined(outs), _joined(refs)
  ref32 = run(tuple(a.float() if a.is_floating_point() else a
                    for a in case.args), 'reference')
  err = (out - ref).abs().max().item()
  err_kernel32 = (out - ref32).abs().max().item()
  err_twin32 = (ref - ref32).abs().max().item()
  if case.kernel in ('int8_layer_block', 'fused_attention_bwd'):
    # K11 casts twice (the half-layer output x1, then the output); K7 casts
    # dl to bf16 before dl @ K and dl^T @ Q, with |dl| up to ~10 at these
    # inputs.  An ulp of x1 or of dl reaches an output whatever that
    # output's own magnitude, so the tolerance scales with the row's
    # largest value, for each output.
    pairs = (zip(outs, refs) if isinstance(outs, tuple)
             else ((outs, refs),))
    close = all(bool(((o.float() - r.float()).abs() <= ATOL + RTOL * (
        r.float().abs().amax(-1, keepdim=True))).all()) for o, r in pairs)
  else:
    close = torch.allclose(out, ref, atol=ATOL, rtol=RTOL)
  ok = (bool(torch.isfinite(out).all()) and close
        and err_kernel32 <= FP32_ERR_RATIO * err_twin32)
  result = dict(kernel=case.kernel, label=case.label, max_abs_err=err,
                err_vs_fp32=err_kernel32, twin_err_vs_fp32=err_twin32)
  if case.kwargs.get('chunks', 1) > 1:
    one = _joined(case.fn(*case.args, **dict(case.kwargs, chunks=1),
                          impl='reference'))
    result.update(
        differ_chunked=(out != ref).float().mean().item(),
        differ_one_chunk=(out != one).float().mean().item(),
        err_vs_one_chunk=(out - one).abs().max().item())
    ok = ok and (result['differ_chunked']
                 < CHUNK_SHARE_RATIO * result['differ_one_chunk'])
    if case.kernel.startswith('int8_'):
      once = _int8_cast_once(case)
      result['differ_cast_once'] = (out != once).float().mean().item()
      ok = ok and (result['differ_chunked']
                   < CHUNK_SHARE_RATIO * result['differ_cast_once'])
  return dict(result, ok=ok)
