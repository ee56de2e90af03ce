"""K5 and K7: head-major soft-capped softmax attention for long sequences,
and its backward.

Ports ``videoprism_tpu/ops/pallas/flash_attention.py`` ``fused_attention``
(K5, ``_attention_kernel``) and ``fused_attention_bwd`` (K7,
``_attention_bwd_kernel``): q [B, N, T, H], k and v [B, N, S, H] bf16, an
additive fp32 mask [B|1, T|1, S].  On a CUDA tensor K5 runs
``csrc/flash_attention.cu`` (K and V streamed in tiles, the TPU kernel's
exact-softmax op order kept by recomputing the logits) and K7
``csrc/flash_attention_bwd.cu`` (a query-major kernel for row_dot, ctx and
dq, a key-major one for dk and dv, probabilities recomputed with K5's
instructions); on a CPU tensor, or with ``impl='reference'``, the plain
twins (``transformer_block.attention_core`` and
:func:`_reference_attention_bwd`).  Every logit's weight is the one helper
of ``csrc/mma_sync.cuh`` (``logit_weight``: exp(cap * tanh(l / cap)) in
three special-function operations, within ~1.5e-5 relative of the precise
form; :func:`_capped_weight` evaluates it on the card), and probabilities are
the weight times a reciprocal of the row sum taken once per row, with one
correction step (the correctly rounded weight / sum of the reference).

Head dims: both kernels zero-pad the head dim to a multiple of 16 inside,
so K5 takes every multiple of 8 up to 128 and K7 every multiple of 8 up
to 96 (``BWD_MAX_HEAD_DIM``; the repo's configs use 64 and giant's 88).  A
head dim that is not a multiple of 8 (whose rows are not whole 16-byte
chunks) is zero-padded to one by the wrappers, a copy of q, k, v (and dO)
on this rare route, and the outputs are sliced back: zero columns add
exact zeros to the logits, so the result is the unpadded function's.  A
head dim past a kernel's maximum raises, naming it.

Under autograd :func:`fused_attention` runs through ``_FusedAttention``:
K5 forward, which then also writes each row's max and sum of weights (fp32
[2, B*N, T rounded up to ``BWD_TILE``]); K7 without ctx backward, given
those statistics so that it sweeps the keys twice instead of three or four
times (bitwise the outputs it gives computing them itself); a zero mask
cotangent, as the JAX package's ``_attention_vjp``.  On the CPU the twins
take no statistics.

:func:`supports` is the JAX package's dispatch gate (T and S multiples of
128, the TPU kernel's tiling): off the card ``multi_head_attention
(impl='flash')`` takes the twin for those shapes and the composed path for
others, as the JAX package does.  The kernels take any T and S, so on the
card it runs K5 at every length.  The packed small-sequence route of the
JAX package (``_packed_small_seq_attention``) and the backward's VMEM fit
(``_bwd_blocks`` / ``bwd_supported``) are TPU tiling and are not ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from videoprism_tpu_torch.ops.kernels import _lib
from videoprism_tpu_torch.ops.kernels.transformer_block import (
    MASK_THRESHOLD,
    NEG_INF,
    attention_core,
    padded_head_dim,
)

# Rows per block of K7's kernels; the row statistics (K5's and K7's) are
# kept for T rounded up to a multiple of this.
BWD_TILE = 64
# Head dims the kernels take: multiples of 8 up to these (K7's fp32 dk / dv,
# or dq / ctx, accumulators live in registers).
MAX_HEAD_DIM = 128
BWD_MAX_HEAD_DIM = 96


def supports(t: int, s: int) -> bool:
  """The JAX gate: whether ``impl='flash'`` runs the kernel at (T, S)."""
  return t % 128 == 0 and s % 128 == 0 and s >= 128


def _check_operands(q, k, v, mask, *, max_head_dim: int, kernel: str):
  b, n, t, h = q.shape
  s = k.shape[2]
  _lib.check(k.shape == (b, n, s, h) and v.shape == (b, n, s, h),
             f'k {tuple(k.shape)} / v {tuple(v.shape)} do not match q '
             f'{tuple(q.shape)}')
  _lib.check(mask.ndim == 3 and mask.shape[0] in (1, b)
             and mask.shape[1] in (1, t) and mask.shape[2] == s,
             f'mask {tuple(mask.shape)} does not fit q {tuple(q.shape)} and '
             f'S={s}')
  _lib.check(0 < h and padded_head_dim(h) <= max_head_dim,
             f'head dim {h}: {kernel} takes head dims of at most '
             f'{max_head_dim}')
  _lib.check(t > 0 and s > 0, 'empty query or key sequence')


def _pad(a: torch.Tensor) -> torch.Tensor:
  """[..., H] zero-padded to a head dim that is a multiple of 8 (whole
  16-byte rows): a copy, taken only for such a head dim."""
  return F.pad(a, (0, padded_head_dim(a.shape[-1]) - a.shape[-1]))


def _padded_rows(t: int) -> int:
  return -(-t // BWD_TILE) * BWD_TILE


def _fused_attention(q, k, v, mask, logit_cap, impl, *, with_stats=False):
  """K5 (or its twin) -> out, or with ``with_stats`` (out, stats): on the
  kernel path each row's max and sum of weights, None on the twin's."""
  if not _lib.use_kernel(impl, q):
    out = attention_core(q, k, v, mask, logit_cap=float(logit_cap),
                         dtype=q.dtype)
    return (out, None) if with_stats else out
  b, n, t, h = q.shape
  _lib.check_tensors(q.device, q=q, k=k, v=v, mask=mask)
  _check_operands(q, k, v, mask, max_head_dim=MAX_HEAD_DIM, kernel='K5')
  if h % 8:
    out = _fused_attention(_pad(q), _pad(k), _pad(v), mask, logit_cap, impl,
                           with_stats=with_stats)
    if with_stats:
      return out[0][..., :h].contiguous(), out[1]
    return out[..., :h].contiguous()
  out = torch.empty_like(q)
  stats = (torch.empty((2, b * n, _padded_rows(t)), dtype=torch.float32,
                       device=q.device) if with_stats else None)
  _lib.launch('vp_flash_attention', q.device, q, k, v, mask, out, stats, b,
              n, t, k.shape[2], h, mask.shape[0], mask.shape[1],
              float(logit_cap))
  _lib.LAUNCHES['fused_attention'] += 1
  return (out, stats) if with_stats else out


class _FusedAttention(torch.autograd.Function):
  """K5 forward, K7 backward (``_attention_vjp``); saves its inputs and
  K5's row statistics."""

  @staticmethod
  def forward(ctx, logit_cap, impl, q, k, v, mask):
    out, stats = _fused_attention(q, k, v, mask, logit_cap, impl,
                                  with_stats=True)
    ctx.save_for_backward(q, k, v, mask, stats)
    ctx.logit_cap, ctx.impl = logit_cap, impl
    return out

  @staticmethod
  def backward(ctx, g):
    q, k, v, mask, stats = ctx.saved_tensors
    dq, dk, dv = fused_attention_bwd(
        q, k, v, mask, g.to(q.dtype).contiguous(), logit_cap=ctx.logit_cap,
        stats=stats, impl=ctx.impl)
    return None, None, dq, dk, dv, None


def fused_attention(
    q: torch.Tensor,      # [B, N, T, H]
    k: torch.Tensor,      # [B, N, S, H]
    v: torch.Tensor,      # [B, N, S, H]
    mask: torch.Tensor,   # [B|1, T|1, S] additive (-0.7 * f32max = masked)
    *,
    logit_cap: float = 0.0,
    impl: str = 'auto',
) -> torch.Tensor:
  """Head-major capped attention -> [B, N, T, H] in q's dtype."""
  if _lib.needs_grad(impl, q, k, v):
    return _FusedAttention.apply(float(logit_cap), impl, q, k, v, mask)
  return _fused_attention(q, k, v, mask, logit_cap, impl)


def _reference_attention_bwd(q, k, v, mask, do, *, logit_cap, with_ctx):
  """Plain twin of K7: ``_attention_bwd_kernel``'s math over the whole
  [T, S] in fp32, with its casts to q's dtype."""
  dtype = q.dtype
  s = k.shape[2]
  qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
  logits = qf @ kf.transpose(-1, -2)                       # [B, N, T, S]
  ok = (mask >= MASK_THRESHOLD)[:, None]                   # [B|1, 1, T|1, S]
  if logit_cap > 0.0:
    tanh_t = torch.tanh(logits * (1.0 / logit_cap))
    unnorm = torch.where(ok, torch.exp(logit_cap * tanh_t), 0.0)
    denom = unnorm.sum(-1, keepdim=True)
    unnorm = torch.where(denom == 0.0, 1.0, unnorm)
    denom = torch.where(denom == 0.0, float(s), denom)
  else:
    lm = torch.where(ok, logits, NEG_INF)
    unnorm = torch.exp(lm - lm.amax(-1, keepdim=True))
    denom = unnorm.sum(-1, keepdim=True)
  probs = unnorm / denom
  probs_c = probs.to(dtype).float()
  dv = (probs_c.transpose(-1, -2) @ dof).to(dtype)
  dp = dof @ vf.transpose(-1, -2)
  row_dot = (dp * probs).sum(-1, keepdim=True)
  dl = torch.where(ok, probs * (dp - row_dot), 0.0)
  if logit_cap > 0.0:
    dl = dl * (1.0 - tanh_t * tanh_t)
  dl_c = dl.to(dtype).float()
  dq = (dl_c @ kf).to(dtype)
  dk = (dl_c.transpose(-1, -2) @ qf).to(dtype)
  if with_ctx:
    return (probs_c @ vf).to(dtype), dq, dk, dv
  return dq, dk, dv


def fused_attention_bwd(
    q: torch.Tensor,      # [B, N, T, H] (as given to the forward)
    k: torch.Tensor,      # [B, N, S, H]
    v: torch.Tensor,      # [B, N, S, H]
    mask: torch.Tensor,   # [B|1, T|1, S] additive fp32
    do: torch.Tensor,     # [B, N, T, H] output cotangent
    *,
    logit_cap: float = 0.0,
    with_ctx: bool = False,
    stats: torch.Tensor | None = None,   # K5's [2, B*N, T_pad] fp32
    impl: str = 'auto',
) -> tuple[torch.Tensor, ...]:
  """dq, dk, dv of :func:`fused_attention` -> (dq, dk, dv), or with
  ``with_ctx`` (ctx, dq, dk, dv), ctx being the forward's output recomputed
  in the same pass (so a block backward never replays the forward).
  ``stats``: each row's max and sum of weights as K5 wrote them for these
  inputs, which spares the kernel two sweeps (the twin takes none)."""
  if not _lib.use_kernel(impl, q):
    return _reference_attention_bwd(q, k, v, mask, do,
                                    logit_cap=float(logit_cap),
                                    with_ctx=with_ctx)
  b, n, t, h = q.shape
  s = k.shape[2]
  _lib.check_tensors(q.device, q=q, k=k, v=v, mask=mask, do=do)
  _check_operands(q, k, v, mask, max_head_dim=BWD_MAX_HEAD_DIM,
                  kernel='the flash backward (K7)')
  _lib.check(do.shape == q.shape,
             f'do {tuple(do.shape)} does not match q {tuple(q.shape)}')
  if h % 8:
    grads = fused_attention_bwd(_pad(q), _pad(k), _pad(v), mask, _pad(do),
                                logit_cap=logit_cap, with_ctx=with_ctx,
                                stats=stats, impl=impl)
    return tuple(g[..., :h].contiguous() for g in grads)
  t_pad = _padded_rows(t)
  if stats is not None:
    _lib.check_tensors(q.device, fp32=('stats',), stats=stats)
    _lib.check(stats.shape == (2, b * n, t_pad),
               f'stats {tuple(stats.shape)}: K5 writes {(2, b * n, t_pad)} '
               f'for q {tuple(q.shape)}')
  scratch = torch.empty((4, b * n, t_pad), dtype=torch.float32,
                        device=q.device)
  ctx = torch.empty_like(q) if with_ctx else None
  dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
  _lib.launch('vp_flash_attention_bwd', q.device, q, k, v, mask, do, stats,
              ctx, dq, dk, dv, scratch, b, n, t, s, h, mask.shape[0],
              mask.shape[1], float(logit_cap))
  _lib.LAUNCHES['fused_attention_bwd'] += 1
  _lib.CTX_LAUNCHES['fused_attention_bwd'] += with_ctx
  _lib.STATS_LAUNCHES['fused_attention_bwd'] += stats is not None
  return (ctx, dq, dk, dv) if with_ctx else (dq, dk, dv)


def _capped_weight(logits: torch.Tensor, logit_cap: float
                   ) -> tuple[torch.Tensor, torch.Tensor]:
  """The capped weight every attention kernel computes per logit
  (``csrc/mma_sync.cuh`` ``logit_weight``), on a CUDA fp32 tensor of
  logits: (exp(cap * tanh(l / cap)), 1 - tanh(l / cap)^2).  The check of
  the helper's accuracy: no path calls it, and it counts no launch."""
  _lib.check(logits.is_cuda, '_capped_weight runs on the card only')
  _lib.check_tensors(logits.device, fp32=('logits',), logits=logits)
  _lib.check(logit_cap > 0.0, f'logit_cap {logit_cap} must be positive')
  w, dt = torch.empty_like(logits), torch.empty_like(logits)
  _lib.launch('vp_capped_weight', logits.device, logits, w, dt,
              logits.numel(), float(logit_cap))
  return w, dt
