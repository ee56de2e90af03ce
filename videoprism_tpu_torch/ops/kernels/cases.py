"""Seeded inputs at the main path's shapes for each kernel, and the check
of a kernel against its plain twin on the card.

Used by ``chip_smoke.py`` and ``tests/test_torch_gpu.py``.  Every input is
drawn with ``numpy.random.default_rng(seed)``; LN scales and biases are
non-zero so that a dropped term shows.

Tolerance: the kernel and the bf16 twin round to bf16 at the same points
and differ only in summation order, so they are compared in fp32 with
``atol = rtol = 2e-2`` (a few bf16 ulps at the outputs' magnitude).  Both
are also held against the fp32 twin on the same inputs: the kernel's max
error there may be at most twice the bf16 twin's.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable

import numpy as np
import torch

from videoprism_tpu_torch.ops.kernels import boundary
from videoprism_tpu_torch.ops.kernels import transformer_block as tb

ATOL = RTOL = 2e-2
FP32_ERR_RATIO = 2.0


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


def attention_case(b: int, t: int, d: int, heads: int, head_dim: int, *,
                   cap: float, padded: bool, device, seed: int = 0) -> Case:
  rng = np.random.default_rng(seed)
  nh = heads * head_dim
  w = lambda *s: rng.standard_normal(s) / np.sqrt(s[0])
  small = lambda *s: 0.1 * rng.standard_normal(s)
  mask = _paddings(rng, b, t, padded)[:, None, :] * np.float32(tb.NEG_INF)
  args = (_tensor(rng.standard_normal((b, t, d)), device),
          _tensor(mask, device, torch.float32),
          _tensor(small(d), device), _tensor(small(d), device),
          _tensor(w(d, 3 * nh), device), _tensor(small(3 * nh), device),
          _tensor(w(nh, d), device), _tensor(small(d), device))
  return Case('fused_attention_block',
              f'[{b},{t},{d}] cap={cap:g} padded={padded}',
              tb.fused_attention_block, args,
              dict(num_heads=heads, dim_per_head=head_dim, logit_cap=cap,
                   query_scale=head_dim ** -0.5))


def ffn_case(rows: int, d: int, f: int, *, activation: str, padded: bool,
             device, seed: int = 0) -> Case:
  rng = np.random.default_rng(seed)
  w = lambda *s: rng.standard_normal(s) / np.sqrt(s[0])
  small = lambda *s: 0.1 * rng.standard_normal(s)
  pads = _paddings(rng, rows // 8, 8, padded).reshape(rows, 1)
  args = (_tensor(rng.standard_normal((rows, d)), device),
          _tensor(pads, device),
          _tensor(small(d), device), _tensor(small(d), device),
          _tensor(w(d, f), device), _tensor(small(f), device),
          _tensor(w(f, d), device), _tensor(small(d), device))
  return Case('fused_ffn_block',
              f'rows={rows} F={f} {activation} padded={padded}',
              tb.fused_ffn_block, args, dict(activation=activation))


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


def run_case(case: Case) -> dict:
  """Kernel vs bf16 twin vs fp32 twin; returns the errors and a verdict."""
  out = case.fn(*case.args, **case.kwargs, impl='kernel').float()
  ref = case.fn(*case.args, **case.kwargs, impl='reference').float()
  args32 = tuple(a.float() for a in case.args)
  ref32 = case.fn(*args32, **case.kwargs, impl='reference')
  err = (out - ref).abs().max().item()
  err_kernel32 = (out - ref32).abs().max().item()
  err_twin32 = (ref - ref32).abs().max().item()
  ok = (bool(torch.isfinite(out).all())
        and torch.allclose(out, ref, atol=ATOL, rtol=RTOL)
        and err_kernel32 <= FP32_ERR_RATIO * err_twin32)
  return dict(kernel=case.kernel, label=case.label, ok=ok, max_abs_err=err,
              err_vs_fp32=err_kernel32, twin_err_vs_fp32=err_twin32)
