"""K5: head-major soft-capped softmax attention for long sequences.

Ports ``videoprism_tpu/ops/pallas/flash_attention.py`` ``fused_attention``
(``_attention_kernel``): q [B, N, T, H], k and v [B, N, S, H] bf16, an
additive fp32 mask [B|1, T|1, S]; returns [B, N, T, H] in q's dtype.  On a
CUDA tensor it runs ``csrc/flash_attention.cu`` (K and V streamed in tiles,
the TPU kernel's exact-softmax op order kept by recomputing the logits);
on a CPU tensor, or with ``impl='reference'``, the plain twin
(``transformer_block.attention_core``, the head-major composed math with
fp32 logits, masked exp and uniform fully-masked rows).

:func:`supports` is the JAX package's dispatch gate: ``multi_head_attention
(impl='flash')`` takes the kernel for those shapes and the composed path
for others, as the JAX package does.  The kernel itself takes any T and S.
The packed small-sequence route of the JAX package
(``_packed_small_seq_attention``) is TPU tiling and is not ported.
"""

from __future__ import annotations

import torch

from videoprism_tpu_torch.ops.kernels import _lib
from videoprism_tpu_torch.ops.kernels.transformer_block import attention_core


def supports(t: int, s: int) -> bool:
  """The JAX gate: whether ``impl='flash'`` runs the kernel at (T, S)."""
  return t % 128 == 0 and s % 128 == 0 and s >= 128


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
  if not _lib.use_kernel(impl, q):
    return attention_core(q, k, v, mask, logit_cap=float(logit_cap),
                          dtype=q.dtype)
  b, n, t, h = q.shape
  s = k.shape[2]
  _lib.check_tensors(q.device, q=q, k=k, v=v, mask=mask)
  _lib.check(k.shape == (b, n, s, h) and v.shape == (b, n, s, h),
             f'k {tuple(k.shape)} / v {tuple(v.shape)} do not match q '
             f'{tuple(q.shape)}')
  _lib.check(mask.ndim == 3 and mask.shape[0] in (1, b)
             and mask.shape[1] in (1, t) and mask.shape[2] == s,
             f'mask {tuple(mask.shape)} does not fit q {tuple(q.shape)} and '
             f'S={s}')
  _lib.check(h % 16 == 0 and 16 <= h <= 128,
             f'head dim {h} must be a multiple of 16, at most 128')
  _lib.check(t > 0 and s > 0, 'empty query or key sequence')
  out = torch.empty_like(q)
  _lib.launch('vp_flash_attention', q.device, q, k, v, mask, out, b, n, t, s,
              h, mask.shape[0], mask.shape[1], float(logit_cap))
  _lib.LAUNCHES['fused_attention'] += 1
  return out
