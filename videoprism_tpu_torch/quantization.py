"""Weight quantization for int8 (W8A8) serving (port of
``videoprism_tpu.quantization``).

:func:`quantize_for_serving` walks a numpy parameter tree and converts
every transformer matmul weight (the q/k/v/post projections of each
``self_attention`` and the two FFN kernels) to symmetric
per-output-channel int8, storing the scale under a sibling ``w_scale`` /
``kernel_scale`` key.  Everything else (LayerNorms, biases, embeddings,
poolers, the patch projection) stays in floating point.  It is the JAX
package's host path (``_quantize_leaf_host``): numpy, ``np.round`` rounding half
to even like ``jnp.round``, and ``w / s`` as there, so the codes and
scales are the JAX package's bit for bit.

Quantize the fp32 numpy tree, then hand it to
``io.checkpoints.params_from_numpy`` (which keeps the int8 leaves and the
fp32 scales whatever ``dtype`` it casts the rest to) and
``prepare_for_kernels``.  :func:`dequantize` inverts the transform on a
tree of tensors for the layers that take the float path.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

Params = dict[str, Any]

# Weight-leaf name -> contraction axes (reduced over in the matmul); the
# scale lives on the remaining (output) axes.  Shapes per the checkpoint
# schema:
#   query/key/value w: [D, N, H]  (contract D)   -> scale [N, H]
#   post           w: [D, N, H]  (contract N,H) -> scale [D]
#   ffn kernel      : [In, Out]   (contract In)  -> scale [Out]
_QKV = ('query', 'key', 'value')
# Leaf names of the scales, which stay fp32.
SCALE_KEYS = ('w_scale', 'kernel_scale')


def is_int8(a) -> bool:
  if isinstance(a, torch.Tensor):
    return a.dtype == torch.int8
  return np.asarray(a).dtype == np.int8


def _quantize_leaf(w, contract_axes: tuple[int, ...]):
  wf = np.asarray(w, dtype=np.float32)
  s = np.abs(wf).max(axis=contract_axes, keepdims=True) / 127.0
  s = np.maximum(s, 1e-12)
  q = np.clip(np.round(wf / s), -127, 127).astype(np.int8)
  return q, np.squeeze(s, axis=contract_axes)


def _dequantize_leaf(q: torch.Tensor, scale: torch.Tensor,
                     contract_axes: tuple[int, ...], dtype: torch.dtype):
  s = scale.float()
  for axis in sorted(contract_axes):
    s = s.unsqueeze(axis)
  return (q.float() * s).to(dtype)


def _axes(stacked: bool, kind: str) -> tuple[int, ...]:
  # Leaves under a scanned stack carry a leading [L] layer axis.
  base = 1 if stacked else 0
  if kind == 'post':
    return (base + 1, base + 2)         # contract N, H of [.., D, N, H]
  return (base,)                        # qkv [.., D, N, H]; ffn [.., In, Out]


def _is_stacked(w, kind: str) -> bool:
  return w.ndim == (4 if kind in ('qkv', 'post') else 3)


def _walk(tree: Params, fn) -> Params:
  """fn(key, subtree) -> replacement or None (recurse)."""
  out = {}
  for k, v in tree.items():
    if isinstance(v, dict):
      replaced = fn(k, v)
      out[k] = replaced if replaced is not None else _walk(v, fn)
    else:
      out[k] = v
  return out


def _is_attention(key: str, sub: Params) -> bool:
  return key == 'self_attention' and all(k in sub for k in (*_QKV, 'post'))


def quantize_for_serving(params: Params, *, on_host: bool = False
                         ) -> Params:
  """Returns a new numpy tree with the transformer matmul weights in int8
  and their fp32 scales beside them; other leaves are shared.

  The port quantizes on the host whatever ``on_host`` says (the JAX
  package's ``on_host=True`` path, which keeps the tree off the device);
  the flag is kept for the JAX signature.
  """
  del on_host

  def visit(key, sub):
    if _is_attention(key, sub):
      new = dict(sub)
      for name in (*_QKV, 'post'):
        kind = 'qkv' if name in _QKV else 'post'
        w = np.asarray(sub[name]['w'])
        if w.dtype == np.int8:
          continue
        q, s = _quantize_leaf(w, _axes(_is_stacked(w, kind), kind))
        new[name] = dict(sub[name], w=q, w_scale=s)
      return new
    if key in ('ffn_layer1', 'ffn_layer2') and 'linear' in sub:
      w = np.asarray(sub['linear']['kernel'])
      if w.dtype == np.int8:
        return dict(sub)
      q, s = _quantize_leaf(w, _axes(w.ndim == 3, 'ffn'))
      return dict(sub, linear=dict(sub['linear'], kernel=q, kernel_scale=s))
    return None

  return _walk(params, visit)


def dequantize(params: Params, dtype: torch.dtype = torch.bfloat16
               ) -> Params:
  """Inverts :func:`quantize_for_serving` on a tree of tensors, to
  ``dtype``.  The int8 kernel layout that ``prepare_for_kernels`` adds
  (``fused``) is dropped: the float path builds its own."""

  def visit(key, sub):
    if key == 'ff_layer' and 'fused' in sub:
      return _walk({k: v for k, v in sub.items() if k != 'fused'}, visit)
    if _is_attention(key, sub):
      new = {k: v for k, v in sub.items() if k != 'fused'}
      for name in (*_QKV, 'post'):
        w = sub[name]['w']
        if not is_int8(w):
          continue
        kind = 'qkv' if name in _QKV else 'post'
        deq = _dequantize_leaf(w, sub[name]['w_scale'],
                               _axes(_is_stacked(w, kind), kind), dtype)
        new[name] = {k: v for k, v in sub[name].items() if k != 'w_scale'}
        new[name]['w'] = deq
      return new
    if key in ('ffn_layer1', 'ffn_layer2') and 'linear' in sub:
      w = sub['linear']['kernel']
      if not is_int8(w):
        return None
      deq = _dequantize_leaf(w, sub['linear']['kernel_scale'],
                             _axes(w.ndim == 3, 'ffn'), dtype)
      linear = {k: v for k, v in sub['linear'].items()
                if k != 'kernel_scale'}
      linear['kernel'] = deq
      return dict(sub, linear=linear)
    return None

  return _walk(params, visit)


def is_quantized(layer_params: Params) -> bool:
  """True if a transformer-layer subtree carries int8 weights."""
  try:
    return is_int8(layer_params['self_attention']['query']['w'])
  except (KeyError, TypeError, AttributeError):
    return False
