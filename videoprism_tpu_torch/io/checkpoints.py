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

from videoprism_tpu_torch.ops.transformer import fused_attention_weights


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


def _tree_map(fn, tree):
  if isinstance(tree, Mapping):
    return {k: _tree_map(fn, v) for k, v in tree.items()}
  return fn(tree)


def params_from_numpy(tree, *, device: torch.device | str = 'cuda',
                      dtype: torch.dtype = torch.float32) -> dict:
  """Nested tree of numpy arrays -> the same tree of tensors on ``device``.

  Floating leaves become ``dtype``; others keep their type.  bfloat16
  arrays (``ml_dtypes``, as JAX hands them out) go through float32.  The
  default device is the card; without one it raises (pass
  ``device='cpu'`` to run on the CPU).
  """
  device = torch.device(device)
  if device.type == 'cuda' and not torch.cuda.is_available():
    raise RuntimeError(
        "no CUDA device is available; pass device='cpu' to load on the CPU")

  def convert(leaf):
    arr = np.asarray(leaf)
    if arr.dtype.name == 'bfloat16':
      arr = arr.astype(np.float32)
    t = torch.from_numpy(np.ascontiguousarray(arr))
    return t.to(device=device,
                dtype=dtype if t.is_floating_point() else t.dtype)

  return _tree_map(convert, tree)


def prepare_for_kernels(params: dict[str, Any]) -> dict[str, Any]:
  """Adds ``fused`` = {wqkv [.., D, 3NH], bqkv [.., 3NH], wo [.., NH, D]}
  beside every ``self_attention`` tree's (D, N, H) weights, in their dtype.

  Done once at load time, so the attention block (K1, and K8a, which reads
  a head group as a column block of Wqkv and a row block of Wo) does not
  concatenate and transpose its projection weights on every forward.  The CLIP
  model's ``auxiliary_encoder`` is left as it is: its 4096-token attention
  runs the composed path (K5), which takes the (D, N, H) weights.  Returns
  a new tree; the other leaves are shared.
  """
  out = {}
  for key, value in params.items():
    if key == 'self_attention' and 'query' in value:
      value = dict(value, fused=fused_attention_weights(
          value, value['query']['w'].dtype))
    elif isinstance(value, Mapping) and key != 'auxiliary_encoder':
      value = prepare_for_kernels(value)
    out[key] = value
  return out
