"""The CLIP contrastive train step (port of
``videoprism_tpu.train.train_step``, one device).

``make_optimizer`` mirrors the reference's optax chain as plain functions
on tensors: ``clip_by_global_norm``, then AdamW (b1, b2, eps 1e-8, bias
correction, decoupled weight decay masked by leaf name, first moment in
``mu_dtype``) scaled by a warmup + cosine / linear / constant schedule read
at the update count before the update (so step 1 runs at lr(0) = 0, as in
optax), optionally wrapped in ``apply_if_finite`` (``skip_nonfinite``).
Gradients come from autograd through the model's kernel wrappers: each
runs its hand-written kernel forward and its ``torch.autograd.Function``
backward (``ops/kernels/``), every attention backward through K7.  Master
weights stay in their own dtype (fp32); the config's ``dtype`` is the
activations'.  No dropout (the port's configs have no dropout fields) and
no rematerialization: ROADMAP.md queues both.

Trees are nested dicts (params) and tuples (the trainable pair ``(params,
log_temperature)``) of tensors.
"""

from __future__ import annotations

import dataclasses
import math
from collections.abc import Callable
from typing import Any

import torch

from videoprism_tpu_torch import quantization
from videoprism_tpu_torch.models import clip as clip_lib
from videoprism_tpu_torch.models import init as init_lib
from videoprism_tpu_torch.train import objectives

Params = dict[str, Any]
Tree = Any
# The reference's other update rules, queued in ROADMAP.md.
_NOT_PORTED = ('adafactor', 'lion', 'sgd')


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
  """Applies ``fn`` leaf-wise over trees of the same structure."""
  if isinstance(tree, dict):
    return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
  if isinstance(tree, (tuple, list)):
    return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                      for i, v in enumerate(tree))
  return fn(tree, *rest)


def tree_leaves(tree: Tree) -> list:
  if isinstance(tree, dict):
    return [leaf for v in tree.values() for leaf in tree_leaves(v)]
  if isinstance(tree, (tuple, list)):
    return [leaf for v in tree for leaf in tree_leaves(v)]
  return [tree]


def global_norm(tree: Tree) -> torch.Tensor:
  """sqrt of the sum of squares of every leaf, in fp32."""
  return torch.sqrt(sum((x.float().square()).sum() for x in tree_leaves(tree)))


@dataclasses.dataclass
class TrainState:
  step: int
  params: Params
  log_temperature: torch.Tensor
  opt_state: dict


def _weight_decay_mask(params: Tree, name: str | None = None) -> Tree:
  """True (decay) only for matmul and embedding weights, by the leaf's
  name: ``w`` (attention), ``kernel`` (dense) and ``emb_var`` (embedding
  and pos-emb tables).  Biases, LayerNorm scales, ``per_dim_scale`` and the
  bare ``log_temperature`` leaf are not decayed."""
  if isinstance(params, dict):
    return {k: _weight_decay_mask(v, k) for k, v in params.items()}
  if isinstance(params, (tuple, list)):
    return type(params)(_weight_decay_mask(v) for v in params)
  return name in ('w', 'kernel', 'emb_var')


def _schedule(name: str, learning_rate: float, warmup_steps: int,
              total_steps: int) -> Callable[[int], float]:
  """optax's warmup_cosine_decay_schedule, or the linear / constant join
  the reference builds, as a function of the update count."""
  def linear(init, end, steps, count):
    if steps <= 0:
      return init
    frac = 1.0 - min(max(count, 0), steps) / steps
    return (init - end) * frac + end

  if name == 'cosine':
    decay_steps = total_steps - warmup_steps
    if decay_steps <= 0:
      raise ValueError(f'the cosine decay needs total_steps > warmup_steps, '
                       f'got {total_steps} and {warmup_steps}')

    def after(count):
      count = min(count, decay_steps)
      return learning_rate * 0.5 * (1.0 + math.cos(math.pi * count
                                                   / decay_steps))
  elif name == 'linear':
    after = lambda count: linear(learning_rate, 0.0,
                                 total_steps - warmup_steps, count)
  elif name == 'constant':
    after = lambda count: learning_rate
  else:
    raise ValueError(f"unknown schedule {name!r} (expected 'cosine', "
                     "'linear', or 'constant')")
  return lambda count: (linear(0.0, learning_rate, warmup_steps, count)
                        if count < warmup_steps
                        else after(count - warmup_steps))


@dataclasses.dataclass(frozen=True)
class Optimizer:
  """A gradient transformation: ``init(trainable) -> state`` and
  ``update(grads, state, trainable) -> (updates, state)``; the new
  trainable is ``apply_updates(trainable, updates)``."""

  init: Callable[[Tree], dict]
  update: Callable[[Tree, dict, Tree], tuple[Tree, dict]]
  learning_rate: Callable[[int], float]


def apply_updates(trainable: Tree, updates: Tree) -> Tree:
  return tree_map(lambda p, u: (p + u).to(p.dtype), trainable, updates)


def make_optimizer(
    learning_rate: float = 1e-4,
    weight_decay: float = 1e-4,
    warmup_steps: int = 1000,
    total_steps: int = 100_000,
    b1: float = 0.9,
    b2: float = 0.95,
    clip_norm: float = 1.0,
    mu_dtype: torch.dtype | None = None,
    skip_nonfinite: int | None = None,
    schedule: str = 'cosine',
    optimizer: str = 'adamw',
) -> Optimizer:
  """Global-norm clipping, then AdamW with a warmup schedule: the
  reference's ``make_optimizer`` chain for ``optimizer='adamw'``.

  ``warmup_steps`` is clamped to ``total_steps - 1`` where it would leave
  the decay no steps.  ``mu_dtype`` stores the first moment in that dtype
  (the second stays fp32).  ``skip_nonfinite`` applies a zero update and
  keeps the moments when a gradient holds NaN or inf, for up to that many
  consecutive steps (``optax.apply_if_finite``).
  """
  if optimizer in _NOT_PORTED:
    raise NotImplementedError(
        f'optimizer={optimizer!r} is not ported yet (only adamw); see '
        'ROADMAP.md, queue 1 item 12')
  if optimizer != 'adamw':
    raise ValueError(f"unknown optimizer {optimizer!r} (expected 'adamw', "
                     "'adafactor', 'lion', or 'sgd')")
  if skip_nonfinite is not None and skip_nonfinite <= 0:
    raise ValueError(f'skip_nonfinite must be positive, got {skip_nonfinite}')
  if warmup_steps >= total_steps:
    warmup_steps = max(total_steps - 1, 0)
  lr = _schedule(schedule, learning_rate, warmup_steps, total_steps)
  eps = 1e-8

  def adamw_init(trainable):
    return {'count': 0,
            'mu': tree_map(lambda p: torch.zeros_like(p, dtype=mu_dtype),
                           trainable),
            'nu': tree_map(torch.zeros_like, trainable)}

  def adamw_update(grads, state, trainable):
    g_norm = global_norm(grads)
    trigger = g_norm < clip_norm
    grads = tree_map(lambda g: torch.where(
        trigger, g, (g / g_norm.to(g.dtype)) * clip_norm), grads)
    # b1 * mu in mu's dtype (b1 rounded to it first), as optax computes it.
    mu = tree_map(lambda g, m: (1 - b1) * g + torch.tensor(b1, dtype=m.dtype)
                  * m, grads, state['mu'])
    nu = tree_map(lambda g, n: (1 - b2) * g * g + b2 * n, grads, state['nu'])
    count = state['count'] + 1
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)
    bc1 = (1 - f32(b1) ** count).item()
    bc2 = (1 - f32(b2) ** count).item()
    step = -f32(lr(state['count'])).item()
    mask = _weight_decay_mask(trainable)

    def update(m, n, p, decay):
      u = (m / bc1) / (torch.sqrt(n / bc2) + eps)
      if decay and weight_decay:
        u = u + weight_decay * p
      return u * step

    updates = tree_map(update, mu, nu, trainable, mask)
    if mu_dtype is not None:
      mu = tree_map(lambda m: m.to(mu_dtype), mu)
    return updates, {'count': count, 'mu': mu, 'nu': nu}

  if skip_nonfinite is None:
    return Optimizer(adamw_init, adamw_update, lr)

  def init(trainable):
    return {'notfinite_count': 0, 'last_finite': True, 'total_notfinite': 0,
            'inner_state': adamw_init(trainable)}

  def update(grads, state, trainable):
    isfinite = all(bool(torch.isfinite(g).all()) for g in tree_leaves(grads))
    notfinite = 0 if isfinite else state['notfinite_count'] + 1
    if isfinite or notfinite > skip_nonfinite:
      updates, inner = adamw_update(grads, state['inner_state'], trainable)
    else:
      updates = tree_map(torch.zeros_like, grads)
      inner = state['inner_state']
    return updates, {
        'notfinite_count': notfinite, 'last_finite': isfinite,
        'total_notfinite': state['total_notfinite'] + (not isfinite),
        'inner_state': inner}

  return Optimizer(init, update, lr)


def _check_trainable(params: Params) -> None:
  if any(quantization.is_int8(leaf) for leaf in tree_leaves(params)):
    raise ValueError('an int8 (quantized) tree serves only: the W8A8 route '
                     'has no backward, as the reference refuses train=True')


def create_train_state(
    seed: int,
    cfg: clip_lib.VideoCLIPConfig,
    optimizer: Optimizer,
    *,
    objective: str = 'infonce',
    init_log_temperature: float | None = None,
    init_bias: float = -10.0,
    pretrained_params: Params | None = None,
    device: torch.device | str = 'cuda',
) -> TrainState:
  """Seeded fp32 params (``init_video_clip``) or ``pretrained_params``, the
  objective's temperature leaf (InfoNCE: a scalar, init log(1/0.07);
  SigLIP: [log 10, -10]) and the optimizer's state, on ``device``."""
  params = (pretrained_params if pretrained_params is not None
            else init_lib.init_video_clip(seed, cfg, device=device))
  _check_trainable(params)
  log_temperature = objectives.init_temperature_state(
      objective, init_log_temperature, init_bias,
      device=tree_leaves(params)[0].device)
  return TrainState(step=0, params=params, log_temperature=log_temperature,
                    opt_state=optimizer.init((params, log_temperature)))


def clip_loss_fn(trainable: tuple[Params, torch.Tensor],
                 batch: dict[str, torch.Tensor],
                 cfg: clip_lib.VideoCLIPConfig,
                 generator: torch.Generator | None = None,
                 objective: str = 'infonce', *, impl: str = 'auto'
                 ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
  """The contrastive loss of a batch ``{'video', 'text_token_ids',
  'text_paddings'}`` -> (loss, metrics).  ``generator`` is the reference's
  ``rng`` (dropout), unused: the port has no dropout."""
  del generator
  params, log_temperature = trainable
  video_emb, text_emb, _ = clip_lib.apply(
      params, batch['video'], batch['text_token_ids'],
      batch['text_paddings'], cfg, impl=impl)
  return objectives.contrastive_loss(objective, video_emb, text_emb,
                                     log_temperature)


def value_and_grad(loss_fn: Callable) -> Callable:
  """``loss_fn(trainable, *args) -> (loss, metrics)`` ->
  ``fn(trainable, *args) -> ((loss, metrics), grads)`` by autograd, the
  grads in the trainable's structure and dtypes."""
  def fn(trainable, *args, **kwargs):
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), trainable)
    loss, metrics = loss_fn(leaves, *args, **kwargs)
    flat = tree_leaves(leaves)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = iter([torch.zeros_like(p) if g is None else g
                  for p, g in zip(flat, grads)])
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), tree_map(lambda _: next(grads), leaves)
  return fn


def accumulate_gradients(value_and_grad_fn: Callable, trainable: Tree,
                         batch: dict[str, torch.Tensor], accum_steps: int
                         ) -> tuple[Tree, dict[str, torch.Tensor]]:
  """Gradients of ``accum_steps`` microbatches (the batch leaves' leading
  axis), one backward live at a time -> (mean grads, mean metrics).  As in
  the reference, the contrastive negatives are each microbatch's own."""
  grad_sum, metric_sum = None, None
  for i in range(accum_steps):
    (_, metrics), grads = value_and_grad_fn(
        trainable, {k: v[i] for k, v in batch.items()})
    grad_sum = grads if grad_sum is None else tree_map(torch.add, grad_sum,
                                                       grads)
    metric_sum = (metrics if metric_sum is None
                  else {k: metric_sum[k] + v for k, v in metrics.items()})
  return (tree_map(lambda g: g / accum_steps, grad_sum),
          {k: v / accum_steps for k, v in metric_sum.items()})


def make_train_step(cfg: clip_lib.VideoCLIPConfig, optimizer: Optimizer, *,
                    accum_steps: int = 1, objective: str = 'infonce',
                    impl: str = 'auto'):
  """Returns ``step(state, batch, generator=None) -> (state, metrics)``.

  With ``accum_steps > 1`` the batch leaves carry a leading
  ``[accum_steps, ...]`` microbatch axis and the gradients are averaged
  over the microbatches before the one optimizer update.  The metrics are
  the objective's plus ``grad_norm`` (of the unclipped gradients), 0-d
  tensors.  ``impl`` reaches every kernel wrapper ('reference' runs the
  plain twins and lets autograd differentiate them).
  """
  if objective not in objectives.CONTRASTIVE_OBJECTIVES:
    raise objectives._unknown(objective)
  vg = value_and_grad(lambda tr, mb: clip_loss_fn(tr, mb, cfg, None,
                                                  objective, impl=impl))

  def train_step(state: TrainState, batch, generator=None):
    del generator
    trainable = (state.params, state.log_temperature)
    if accum_steps > 1:
      grads, metrics = accumulate_gradients(vg, trainable, batch, accum_steps)
    else:
      (_, metrics), grads = vg(trainable, batch)
    with torch.no_grad():
      updates, opt_state = optimizer.update(grads, state.opt_state,
                                            trainable)
      params, log_temperature = apply_updates(trainable, updates)
      metrics['grad_norm'] = global_norm(grads)
    return TrainState(state.step + 1, params, log_temperature,
                      opt_state), metrics

  return train_step
