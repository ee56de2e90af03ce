"""Checkpoint trees: flat npz keys <-> nested trees, and the bridge from
numpy trees to tensors (port of ``videoprism_tpu.io.checkpoints``).

The port keeps the checkpoint schema: scan-stacked transformer weights keep
their leading layer axis under ``x_layers`` and attention weights stay
(D, N, H).  So the JAX package's params, after ``np.asarray`` on every
leaf, load with :func:`params_from_numpy` and no renaming.
"""

from __future__ import annotations

import collections
from collections.abc import Mapping
from typing import Any

import numpy as np
import torch

from videoprism_tpu_torch import quantization
from videoprism_tpu_torch.ops.transformer import (
    fused_attention_weights,
    int8_attention_weights,
    int8_ffn_weights,
)


def recover_tree(keys, values) -> dict:
  """Rebuilds a nested dict from ``a/b/c`` flat keys."""
  tree = {}
  sub_trees = collections.defaultdict(list)
  for k, v in zip(keys, values):
    if '/' not in k:
      tree[k] = v
    else:
      k_left, k_right = k.split('/', 1)
      sub_trees[k_left].append((k_right, v))
  for k, kv_pairs in sub_trees.items():
    k_subtree, v_subtree = zip(*kv_pairs)
    tree[k] = recover_tree(k_subtree, v_subtree)
  return tree


def load_checkpoint(source: str | Mapping[str, np.ndarray]) -> dict:
  """Loads a flat-key npz file (or a flat dict) as a nested numpy tree."""
  if isinstance(source, str):
    if not source.endswith('.npz'):
      raise ValueError(f'only local .npz checkpoints load here, got {source!r}')
    with np.load(source, allow_pickle=False) as f:
      source = {k: f[k] for k in f.files}
  keys, values = zip(*source.items())
  return recover_tree(keys, values)


def save_checkpoint(path: str, tree) -> None:
  """Saves a nested tree of arrays as a flat-key (``a/b/c``) npz file, as
  the JAX package's ``save_checkpoint`` writes one (safetensors is not
  ported: ROADMAP.md, queue 1 item 1)."""
  if not path.endswith('.npz'):
    raise ValueError(f'only .npz checkpoints are written here, got {path!r}')
  flat = {}

  def walk(sub, prefix):
    for k, v in sub.items():
      if isinstance(v, Mapping):
        walk(v, f'{prefix}{k}/')
      else:
        flat[prefix + k] = np.ascontiguousarray(np.asarray(v))

  walk(tree, '')
  np.savez(path, **flat)


def _tree_map(fn, tree, key=None):
  """fn(leaf, key) over a nested tree; ``key`` is the leaf's own name."""
  if isinstance(tree, Mapping):
    return {k: _tree_map(fn, v, k) for k, v in tree.items()}
  return fn(tree, key)


def params_from_numpy(tree, *, device: torch.device | str = 'cuda',
                      dtype: torch.dtype = torch.float32) -> dict:
  """Nested tree of numpy arrays -> the same tree of tensors on ``device``.

  Floating leaves become ``dtype``, except the fp32 weight scales of a
  quantized tree (``w_scale``, ``kernel_scale``); int8 weights and other
  non-floating leaves keep their type.  bfloat16 arrays (``ml_dtypes``, as
  JAX hands them out) go through float32.  The default device is the card;
  without one it raises (pass ``device='cpu'`` to run on the CPU).
  """
  device = torch.device(device)
  if device.type == 'cuda' and not torch.cuda.is_available():
    raise RuntimeError(
        "no CUDA device is available; pass device='cpu' to load on the CPU")

  def convert(leaf, key):
    arr = np.asarray(leaf)
    if arr.dtype.name == 'bfloat16':
      arr = arr.astype(np.float32)
    t = torch.from_numpy(np.ascontiguousarray(arr))
    want = (torch.float32 if key in quantization.SCALE_KEYS
            else dtype if t.is_floating_point() else t.dtype)
    return t.to(device=device, dtype=want)

  return _tree_map(convert, tree)


def _has_int8(tree) -> bool:
  if isinstance(tree, Mapping):
    return any(_has_int8(v) for v in tree.values())
  return quantization.is_int8(tree)


def _int8_views(value: dict[str, Any], fused: dict[str, torch.Tensor],
                attention: bool) -> dict[str, Any]:
  """The int8 [K, N] weight leaves of an attention (or ``ff_layer``) tree
  as views of the K-major copies in ``fused``, so that the two layouts
  share their memory; the leaves as they are where the copies are padded
  (a head dim off a multiple of 8)."""
  value = dict(value)
  if attention:
    n, h = value['query']['w'].shape[-2:]
    w = fused['wqkv'].transpose(-1, -2)               # [.., D, 3 N H']
    if w.shape[-1] != 3 * n * h:
      return value
    for i, name in enumerate(('query', 'key', 'value')):
      view = w[..., i * n * h:(i + 1) * n * h].unflatten(-1, (n, h))
      value[name] = dict(value[name], w=view)
    return value
  for name, key in (('ffn_layer1', 'w1'), ('ffn_layer2', 'w2')):
    linear = dict(value[name]['linear'], kernel=fused[key].transpose(-1, -2))
    value[name] = dict(value[name], linear=linear)
  return value


def prepare_for_kernels(params: dict[str, Any]) -> dict[str, Any]:
  """Adds the kernels' weight layout as ``fused`` subtrees, once at load:

  * beside every float ``self_attention`` tree's (D, N, H) weights, in
    their dtype, {wqkv [.., D, 3NH'], bqkv [.., 3NH'], wo [.., NH', D]};
  * beside every int8 one, the int8 kernels' K-major operands
    {wqkv [.., 3NH', D], sqkv and bqkv [.., 3NH'], wo [.., D, NH']}
    (``ops/transformer.py`` ``int8_attention_weights``), and beside every
    int8 ``ff_layer`` {w1 [.., F, D], w2 [.., D, F]}; the int8 q, k, v
    and FFN leaves then become views of those copies (transposed, not
    contiguous) and Wo already is one of the ``post`` leaf, so the int8
    weights are held once.

  H' is the head dim rounded up to a multiple of 8, each head's padding
  zeros (the same function, exactly; a no-op at every shipped config's
  head dim).  Done once at load time, so the attention blocks (K1, and
  K8a, which reads a head group as a column block of Wqkv and a row block
  of Wo; K9-K12b) do not concatenate and transpose their projection
  weights on every forward.  A float CLIP model's ``auxiliary_encoder`` is
  left as it is: its 4096-token attention runs the composed path (K5),
  which takes the (D, N, H) weights; an int8 one runs K12a + K5 + K12b
  and K9 and gets the int8 layout.  Returns a new tree; the other leaves
  are shared.
  """
  out = {}
  for key, value in params.items():
    if key == 'self_attention' and 'query' in value:
      if quantization.is_quantized({'self_attention': value}):
        fused = int8_attention_weights(value)
        value = dict(_int8_views(value, fused, attention=True), fused=fused)
      else:
        value = dict(value, fused=fused_attention_weights(
            value, value['query']['w'].dtype))
    elif (key == 'ff_layer' and 'ffn_layer1' in value
          and quantization.is_int8(value['ffn_layer1']['linear']['kernel'])):
      fused = int8_ffn_weights(value)
      value = dict(_int8_views(value, fused, attention=False), fused=fused)
    elif isinstance(value, Mapping) and (key != 'auxiliary_encoder'
                                         or _has_int8(value)):
      value = prepare_for_kernels(value)
    out[key] = value
  return out
