"""Training in videoprism_tpu_torch against the JAX package, fp32 on the CPU.

Four items, each a loop that reports every failing case (the suite's item
count is kept low: ROADMAP.md, "the item-count trap"):

1. K7's plain twin (``fused_attention_bwd`` on a CPU tensor) against the
   Pallas ``fused_attention_bwd`` in interpret mode (cap 50 and 0, with and
   without ctx, padded keys with a fully masked row, a causal mask, T = S =
   128 and T = 128 / S = 256): fp32 atol 3e-4 (``test_kernel_vjp.py``'s),
   bf16 2e-2; and the gradients of K5's Function against ``jax.vjp`` of
   ``flash_attention_head_major(interpret=True)``.
2. The Functions of K1, K8a, K2, K8b, K3, K4 and K6 (twin forward,
   hand-written backward) against ``jax.vjp`` of the reference's
   ``attention_block_vjp``, ``ffn_block_vjp``, ``spatial_to_temporal_vjp``,
   ``temporal_to_output_vjp`` and ``fused_layer_norm``, in interpret mode:
   fp32 atol 2e-4 (``test_kernel_vjp.py``'s).
3. The tiny lvt config (``scripts/smoke_configs.py`` ``TINY_CLIP``; the JAX
   side with ``attention_impl='flash'``, ``kernel_interpret=True``): loss
   to 1e-5 and each gradient leaf to 2e-4 of its largest value, InfoNCE
   and SigLIP (unchanged when the tree carries ``prepare_for_kernels``'s
   cached fused weights); the classification objectives to 1e-6.  No
   padded frames (the JAX temporal packing differs there).
4. ``make_optimizer`` against the reference's optax chain over 3 updates
   of the same gradients (the three schedules, the weight-decay mask,
   clipping, a bf16 first moment, ``skip_nonfinite``): to 1e-6; then
   ``make_train_step`` against the JAX one over 3 steps of the tiny lvt
   config (the three schedules, decay, clipping, ``accum_steps=2``):
   params and metrics to 1e-5.

The key biases' exact gradient is 0 (softmax ignores a shift of a query's
logits), so both packages return fp32 rounding noise there: item 3 scales
their tolerance by the key weight's gradient, and item 4 bounds their
params by the steps Adam can take on noise (2 lr a step).

Both packages start from the same numpy tree (the port's seeded
``numpy_video_clip``) and the same numpy inputs.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videoprism_tpu.models import clip as jclip
from videoprism_tpu.ops.pallas import boundary as jbd
from videoprism_tpu.ops.pallas import flash_attention as jflash
from videoprism_tpu.ops.pallas import layer_norm as jln
from videoprism_tpu.ops.pallas import transformer_block as jtb
from videoprism_tpu.train import train_step as jts
from videoprism_tpu_torch.io.checkpoints import (
    params_from_numpy,
    prepare_for_kernels,
)
from videoprism_tpu_torch.models import clip as tclip
from videoprism_tpu_torch.models import init as tinit
from videoprism_tpu_torch.ops.kernels import boundary as tbd
from videoprism_tpu_torch.ops.kernels import flash_attention as tflash
from videoprism_tpu_torch.ops.kernels import layer_norm as tln
from videoprism_tpu_torch.ops.kernels import transformer_block as ttb
from videoprism_tpu_torch.quantization import quantize_for_serving
from videoprism_tpu_torch.train import train_step as tts

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'scripts'))
from smoke_configs import TINY_CLIP  # noqa: E402

NEG = np.float32(ttb.NEG_INF)


def _np(x) -> np.ndarray:
  return x.detach().float().numpy() if isinstance(x, torch.Tensor) else (
      np.asarray(x, np.float32))


def _tree(fn, tree):
  if isinstance(tree, dict):
    return {k: _tree(fn, v) for k, v in tree.items()}
  return fn(tree)


def _compare(failures, label, got, want, atol, rtol=0.0):
  got, want = _np(got), _np(want)
  if got.shape != want.shape:
    failures.append(f'{label}: shape {got.shape} != {want.shape}')
    return
  err = float(np.abs(got - want).max()) if got.size else 0.0
  if not np.allclose(got, want, atol=atol, rtol=rtol):
    failures.append(f'{label}: max abs err {err:.3g} > atol {atol}')


def _rng_inputs(seed, *shapes, scale=1.0):
  rng = np.random.default_rng(seed)
  return [(scale * rng.standard_normal(s)).astype(np.float32) for s in shapes]


def _attention_mask(kind, b, t, s):
  """[b, t|1, s] fp32: 'pad' (a padded key tail in one sequence, every key
  padded in the other: its rows are fully masked) or 'causal' (a key after
  its query is masked, plus one fully masked row)."""
  if kind == 'pad':
    masked = np.zeros((b, 1, s), bool)
    masked[0, :, s - 37:] = True
    masked[1:] = True
  else:
    masked = np.broadcast_to(
        np.arange(s)[None, None, :] > np.arange(t)[None, :, None],
        (b, t, s)).copy()
    masked[0, 5] = True
  return (masked * NEG).astype(np.float32)


def test_flash_backward_and_k5_gradients_match_jax():
  failures = []
  b, n, h = 2, 2, 32
  for t, s in ((128, 128), (128, 256)):
    for kind in ('pad', 'causal'):
      q, k, v, do = _rng_inputs(t + s, (b, n, t, h), (b, n, s, h),
                                (b, n, s, h), (b, n, t, h))
      q *= 3.0 / np.sqrt(h)       # logits of std ~3
      mask = _attention_mask(kind, b, t, s)
      for cap in (50.0, 0.0):
        for with_ctx in (False, True):
          for dtype, jdtype, atol in ((torch.float32, jnp.float32, 3e-4),
                                      (torch.bfloat16, jnp.bfloat16, 2e-2)):
            label = (f'K7 T={t} S={s} {kind} cap={cap} ctx={with_ctx} '
                     f'{dtype}')
            want = jflash.fused_attention_bwd(
                *(jnp.asarray(a, jdtype) for a in (q, k, v)),
                jnp.asarray(mask), jnp.asarray(do, jdtype), logit_cap=cap,
                with_ctx=with_ctx, interpret=True)
            got = tflash.fused_attention_bwd(
                *(torch.from_numpy(a).to(dtype) for a in (q, k, v)),
                torch.from_numpy(mask), torch.from_numpy(do).to(dtype),
                logit_cap=cap, with_ctx=with_ctx)
            if len(got) != len(want):
              failures.append(f'{label}: {len(got)} outputs')
              continue
            for name, g, w in zip(('ctx', 'dq', 'dk', 'dv')[not with_ctx:],
                                  got, want):
              if g.dtype != dtype:
                failures.append(f'{label} {name}: dtype {g.dtype}')
              _compare(failures, f'{label} {name}', g, w, atol)

        # K5's Function: fused_attention forward, K7 backward.
        label = f'K5 vjp T={t} S={s} {kind} cap={cap}'
        mask4 = jnp.asarray(mask[:, None])
        fn = lambda q_, k_, v_: jflash.flash_attention_head_major(
            q_, k_, v_, mask4, logit_cap=cap, interpret=True)
        out, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (q, k, v)))
        want = vjp(jnp.asarray(do))
        tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
        got_out = tflash.fused_attention(tq, tk, tv, torch.from_numpy(mask),
                                         logit_cap=cap)
        got_out.backward(torch.from_numpy(do))
        _compare(failures, f'{label} out', got_out, out, 1e-5)
        for name, g, w in zip(('dq', 'dk', 'dv'), (tq.grad, tk.grad, tv.grad),
                              want):
          _compare(failures, f'{label} {name}', g, w, 3e-4)
  assert not failures, '\n'.join(failures)


def _torch_vjp(fn, args, grad_mask, g):
  """(out, cotangents) of ``fn(*args)`` by autograd; args with a False in
  ``grad_mask`` take no gradient (None)."""
  targs = [torch.from_numpy(a).requires_grad_(m)
           for a, m in zip(args, grad_mask)]
  out = fn(*targs)
  out.backward(torch.from_numpy(g))
  return out, [a.grad if m else None for a, m in zip(targs, grad_mask)]


def test_block_gradients_match_jax():
  failures = []
  atol = 2e-4
  # K1 / K8a at T = 128 (the reference's hand-written block backward).
  b, t, d, n, h = 2, 128, 128, 2, 64
  nh = n * h
  x, lns, lnb, wq, wk, wv, wo, bq, bk, bv, bo, g = _rng_inputs(
      1, (b, t, d), (d,), (d,), (d, nh), (d, nh), (d, nh), (nh, d), (nh,),
      (nh,), (nh,), (d,), (b, t, d))
  for w in (wq, wk, wv, wo):
    w /= np.sqrt(w.shape[0])
  lns, lnb, bq, bk, bv, bo = (0.1 * a for a in (lns, lnb, bq, bk, bv, bo))
  for kind, cap, chunks in (('pad', 50.0, None), ('causal', 0.0, None),
                            ('pad', 50.0, 2)):
    label = f'K1 {kind} cap={cap} chunks={chunks}'
    mask = _attention_mask(kind, b, t, t)
    f = jtb.attention_block_vjp(n, h, cap, 1e-6, h ** -0.5, interpret=True,
                                chunks=chunks)
    jargs = [jnp.asarray(a) for a in (x, mask, lns, lnb, wq, bq, wk, bk, wv,
                                      bv, wo, bo)]
    want_out, vjp = jax.vjp(f, *jargs)
    want = vjp(jnp.asarray(g))
    static = dict(num_heads=n, dim_per_head=h, logit_cap=cap,
                  query_scale=h ** -0.5)
    if chunks:
      fn = lambda *a: ttb.fused_attention_block_chunked(*a, chunks=chunks,
                                                        **static)
    else:
      fn = lambda *a: ttb.fused_attention_block(*a, **static)
    targs = (x, mask, lns, lnb, np.concatenate([wq, wk, wv], 1),
             np.concatenate([bq, bk, bv]), wo, bo)
    out, got = _torch_vjp(fn, targs, [True, False] + [True] * 6, g)
    _compare(failures, f'{label} out', out, want_out, 2e-5)
    dwq, dbq, dwk, dbk, dwv, dbv = want[4:10]
    for name, gg, w in (
        ('dx', got[0], want[0]), ('dln_scale', got[2], want[2]),
        ('dln_bias', got[3], want[3]),
        ('dwqkv', got[4], np.concatenate([dwq, dwk, dwv], 1)),
        ('dbqkv', got[5], np.concatenate([dbq, dbk, dbv])),
        ('dwo', got[6], want[10]), ('dbo', got[7], want[11])):
      _compare(failures, f'{label} {name}', gg, w, atol)

  # K2 / K8b over 64 rows, a block of them padded.
  rows, f_dim = 64, 256
  x, lns, lnb, w1, b1, w2, b2, g = _rng_inputs(
      2, (rows, d), (d,), (d,), (d, f_dim), (f_dim,), (f_dim, d), (d,),
      (rows, d))
  w1 /= np.sqrt(d)
  w2 /= np.sqrt(f_dim)
  lns, lnb, b1, b2 = (0.1 * a for a in (lns, lnb, b1, b2))
  pads = np.zeros((rows, 1), np.float32)
  pads[40:50] = 1.0
  args = (x, pads, lns, lnb, w1, b1, w2, b2)
  for activation, chunks in (('gelu', None), ('relu', None), ('gelu', 2)):
    label = f'K2 {activation} chunks={chunks}'
    f = jtb.ffn_block_vjp(activation, 1e-6, chunks, interpret=True)
    want_out, vjp = jax.vjp(f, *map(jnp.asarray, args))
    want = vjp(jnp.asarray(g))
    kw = dict(activation=activation)
    fn = ((lambda *a: ttb.fused_ffn_block_chunked(*a, chunks=chunks, **kw))
          if chunks else (lambda *a: ttb.fused_ffn_block(*a, **kw)))
    out, got = _torch_vjp(fn, args, [True, False] + [True] * 6, g)
    _compare(failures, f'{label} out', out, want_out, 2e-5)
    for i, name in enumerate(('dx', None, 'dln_scale', 'dln_bias', 'dw1',
                              'db1', 'dw2', 'db2')):
      if name:
        _compare(failures, f'{label} {name}', got[i], want[i], atol)

  # K3 / K4 at 2 clips of 4 frames x 16 tokens.
  bb, tt, nn = 2, 4, 16
  feats, lns, lnb, pos, g3, g4 = _rng_inputs(
      3, (bb * tt, nn, d), (d,), (d,), (tt, d), (bb * nn, tt, d),
      (bb, tt * nn, d))
  lns, lnb = 0.1 * lns, 0.1 * lnb
  for label, jf, tf, args, g in (
      ('K3', jbd.spatial_to_temporal_vjp(bb, tt, interpret=True),
       lambda *a: tbd.spatial_to_temporal(*a, b=bb, t=tt),
       (feats, lns, lnb, pos), g3),
      ('K4', jbd.temporal_to_output_vjp(bb, nn, interpret=True),
       lambda *a: tbd.temporal_to_output(*a, b=bb, n=nn),
       (feats.reshape(bb, tt, nn, d).transpose(0, 2, 1, 3).reshape(
           bb * nn, tt, d).copy(), lns, lnb), g4)):
    want_out, vjp = jax.vjp(jf, *map(jnp.asarray, args))
    want = vjp(jnp.asarray(g))
    out, got = _torch_vjp(tf, args, [True] * len(args), g)
    _compare(failures, f'{label} out', out, want_out, 2e-5)
    for i, (gg, w) in enumerate(zip(got, want)):
      _compare(failures, f'{label} cotangent {i}', gg, w, atol)

  # K6 at 24 rows, both scale conventions.
  x, s, bias, g = _rng_inputs(4, (24, d), (d,), (d,), (24, d))
  for direct_scale in (False, True):
    label = f'K6 direct_scale={direct_scale}'
    scale = 1.0 + 0.1 * s if direct_scale else 0.1 * s
    jf = lambda *a: jln.fused_layer_norm(*a, direct_scale=direct_scale,
                                         interpret=True)
    want_out, vjp = jax.vjp(jf, *map(jnp.asarray, (x, scale, bias)))
    want = vjp(jnp.asarray(g))
    out, got = _torch_vjp(
        lambda *a: tln.fused_layer_norm_2d(*a, direct_scale=direct_scale),
        (x, scale, bias), [True] * 3, g)
    _compare(failures, f'{label} out', out, want_out, 2e-5)
    for i, (gg, w) in enumerate(zip(got, want)):
      _compare(failures, f'{label} cotangent {i}', gg, w, atol)
  assert not failures, '\n'.join(failures)


def _tiny_setup(batch, seed=0):
  """(port config, JAX config, numpy params, numpy batch) of the tiny lvt
  config: real frames only, the text ragged (one row fully real)."""
  kw = dict(TINY_CLIP)
  tcfg = tclip.VideoCLIPConfig(**kw)
  jcfg = jclip.VideoCLIPConfig(**kw, attention_impl='flash',
                               kernel_interpret=True)
  tree = tinit.numpy_video_clip(seed, tcfg, norm_bias_std=0.1)
  rng = np.random.default_rng(seed + 1)
  b = batch
  lengths = rng.integers(1, 9, size=b)
  lengths[0] = 8
  data = {
      'video': rng.standard_normal((b, 2, 12, 12, 3)).astype(np.float32),
      'text_token_ids': rng.integers(0, tcfg.vocabulary_size,
                                     size=(b, 8)).astype(np.int32),
      'text_paddings': (np.arange(8)[None, :] >= lengths[:, None]).astype(
          np.float32),
  }
  return tcfg, jcfg, tree, data


def _leaf_paths(tree, prefix=''):
  if isinstance(tree, dict):
    for k, v in tree.items():
      yield from _leaf_paths(v, f'{prefix}/{k}')
  else:
    yield prefix, tree


def _get(tree, path):
  for k in path.strip('/').split('/'):
    tree = tree[k]
  return tree


def _torch_batch(data):
  return {k: torch.from_numpy(v) for k, v in data.items()}


def test_tiny_clip_loss_and_gradients_match_jax():
  failures = []
  tcfg, jcfg, tree, data = _tiny_setup(batch=3)
  from videoprism_tpu.train import objectives as jobj
  from videoprism_tpu_torch.train import objectives as tobj
  for objective in ('infonce', 'siglip'):
    temp = np.asarray(jobj.init_temperature_state(objective))
    jtrain = (_tree(jnp.asarray, tree), jnp.asarray(temp))
    (jloss, jmetrics), (jgrads, jgtemp) = jax.value_and_grad(
        jts.clip_loss_fn, has_aux=True)(
            jtrain, _tree(jnp.asarray, data), jcfg, jax.random.PRNGKey(0),
            objective)
    ttrain = (params_from_numpy(tree, device='cpu'),
              tobj.init_temperature_state(objective))
    (tloss, tmetrics), (tgrads, tgtemp) = tts.value_and_grad(
        tts.clip_loss_fn)(ttrain, _torch_batch(data), tcfg, None, objective)
    _compare(failures, f'{objective} loss', tloss, jloss, 1e-5)
    for k, v in jmetrics.items():
      if k not in tmetrics:
        failures.append(f'{objective}: no metric {k}')
      else:
        _compare(failures, f'{objective} {k}', tmetrics[k], v, 1e-5)
    leaves = [('log_temperature', tgtemp, jgtemp)] + [
        (path, g, _get(jgrads, path)) for path, g in _leaf_paths(tgrads)]
    if objective == 'infonce':
      # A tree prepared for serving carries fused attention weights; under
      # autograd they are rebuilt from the leaves, so nothing changes.
      (ploss, _), (pgrads, _) = tts.value_and_grad(tts.clip_loss_fn)(
          (prepare_for_kernels(ttrain[0]), ttrain[1]), _torch_batch(data),
          tcfg, None, objective)
      if not (torch.equal(ploss, tloss) and all(
          torch.equal(g, _get(pgrads, path))
          for path, g in _leaf_paths(tgrads))):
        failures.append('the cached fused weights changed the gradient')
    for path, g, w in leaves:
      scale = float(np.abs(_np(w)).max())
      if path.endswith('/key/b'):
        # Softmax is invariant to a shift of a query's logits, so the key
        # bias's exact gradient is 0 and both sides return fp32 rounding
        # noise: its scale is that of the key weight's gradient.
        scale = max(scale, float(np.abs(_np(_get(jgrads, path[:-1] + 'w'))
                                        ).max()))
      _compare(failures, f'{objective} grad {path}', g, w,
               2e-4 * max(scale, 1e-30))
  # The classification objectives, on logits with ties in one row.
  logits, probs = _rng_inputs(7, (5, 6), (5, 6))
  logits[2, :] = 1.0
  probs = np.exp(probs) / np.exp(probs).sum(-1, keepdims=True)
  labels = np.array([0, 3, 2, 5, 1], np.int32)
  for name, args in (
      ('softmax_cross_entropy_loss', (logits, labels, 0.0)),
      ('softmax_cross_entropy_loss', (logits, labels, 0.1)),
      ('soft_cross_entropy_loss', (logits, probs))):
    want = getattr(jobj, name)(*(jnp.asarray(a) if isinstance(a, np.ndarray)
                                 else a for a in args))[1]
    got = getattr(tobj, name)(*(torch.from_numpy(a)
                                if isinstance(a, np.ndarray) else a
                                for a in args))[1]
    for k, v in want.items():
      _compare(failures, f'{name} {len(args)} {k}', got[k], v, 1e-6)
  assert not failures, '\n'.join(failures)


def _optimizer_tree(seed):
  """A small trainable ``(params, log_temperature)`` whose leaf names cover
  the decay mask (``w``, ``kernel``, ``emb_var`` decayed; ``b``, ``bias``,
  ``scale`` not)."""
  w, kern, emb, b, bias, scale = _rng_inputs(seed, (4, 2, 3), (3, 5), (6, 4),
                                             (2, 3), (5,), (4,))
  return ({'attn': {'w': w, 'b': b}, 'dense': {'kernel': kern, 'bias': bias},
           'table': {'emb_var': emb}, 'ln': {'scale': scale}},
          np.float32(0.3))


def _optimizer_steps(make, tree_fn, to, updates_fn, grads):
  """Three updates of an optimizer from ``make`` on ``grads`` (a list of
  trainables); returns the trainables after each."""
  trainable = tree_fn(to)
  opt = make()
  state = opt.init(trainable)
  out = []
  for g in grads:
    trainable, state = updates_fn(opt, g, state, trainable)
    out.append(trainable)
  return out


def test_optimizer_and_train_steps_match_jax():
  """make_optimizer against the reference's optax chain on the same
  gradients (every schedule, the decay mask, clipping on and off, a bf16
  first moment, skip_nonfinite over a NaN gradient), then make_train_step
  against the JAX one on the tiny lvt config (accum_steps=2 too)."""
  import optax

  failures = []
  grads = [_optimizer_tree(10 + i) for i in range(3)]
  for run in (
      dict(schedule='cosine', warmup_steps=1, total_steps=10,
           clip_norm=0.5, weight_decay=0.1),
      dict(schedule='linear', warmup_steps=2, total_steps=5, clip_norm=100.0,
           weight_decay=0.05, mu_dtype='bfloat16'),
      dict(schedule='constant', warmup_steps=0, total_steps=4,
           weight_decay=0.0, skip_nonfinite=1)):
    label = str(run)
    mu = run.pop('mu_dtype', None)
    run['learning_rate'] = 1e-2
    steps = grads
    if 'skip_nonfinite' in run:    # a NaN at the second step is skipped
      bad = _optimizer_tree(11)
      bad[0]['attn']['w'][0, 0, 0] = np.nan
      steps = [grads[0], bad, grads[2]]

    def jax_update(opt, g, state, trainable):
      g = (_tree(jnp.asarray, g[0]), jnp.asarray(g[1]))
      updates, state = opt.update(g, state, trainable)
      return optax.apply_updates(trainable, updates), state

    def torch_update(opt, g, state, trainable):
      g = (_tree(torch.from_numpy, g[0]), torch.tensor(g[1]))
      updates, state = opt.update(g, state, trainable)
      return tts.apply_updates(trainable, updates), state

    want = _optimizer_steps(
        lambda: jts.make_optimizer(**run, mu_dtype=mu and jnp.dtype(mu)),
        lambda to: (_tree(to, _optimizer_tree(0)[0]),
                    to(_optimizer_tree(0)[1])),
        jnp.asarray, jax_update, steps)
    got = _optimizer_steps(
        lambda: tts.make_optimizer(**run, mu_dtype=mu and getattr(torch, mu)),
        lambda to: (_tree(to, _optimizer_tree(0)[0]),
                    torch.tensor(_optimizer_tree(0)[1])),
        torch.from_numpy, torch_update, steps)
    for i, (g, w) in enumerate(zip(got, want)):
      _compare(failures, f'{label} update {i + 1} log_temperature', g[1],
               w[1], 1e-6)
      for path, p in _leaf_paths(g[0]):
        _compare(failures, f'{label} update {i + 1} {path}', p,
                 _get(w[0], path), 1e-6)

  tcfg, jcfg, tree, data = _tiny_setup(batch=4, seed=1)
  lr = 1e-3
  for run in (
      dict(schedule='cosine', warmup_steps=1, total_steps=10,
           weight_decay=0.1, clip_norm=1e-2),
      dict(schedule='linear', warmup_steps=2, total_steps=5,
           weight_decay=0.05, clip_norm=10.0, accum_steps=2),
      dict(schedule='constant', warmup_steps=1, total_steps=4,
           weight_decay=0.0, clip_norm=1.0)):
    run = dict(run, learning_rate=lr)
    accum = run.pop('accum_steps', 1)
    label = f"train step {run['schedule']} accum={accum}"
    jopt, topt = jts.make_optimizer(**run), tts.make_optimizer(**run)
    batch = data
    if accum > 1:
      batch = {k: v.reshape(accum, -1, *v.shape[1:]) for k, v in data.items()}
    jstate = jts.create_train_state(
        jax.random.PRNGKey(0), jcfg, jopt,
        pretrained_params=_tree(jnp.asarray, tree))
    tstate = tts.create_train_state(
        0, tcfg, topt, pretrained_params=params_from_numpy(tree,
                                                           device='cpu'),
        device='cpu')
    jstep = jax.jit(jts.make_train_step(jcfg, jopt, accum_steps=accum))
    tstep = tts.make_train_step(tcfg, topt, accum_steps=accum)
    jbatch, tbatch = _tree(jnp.asarray, batch), _torch_batch(batch)
    for i in range(3):
      jstate, jmetrics = jstep(jstate, jbatch, jax.random.PRNGKey(i))
      tstate, tmetrics = tstep(tstate, tbatch)
      for k, v in jmetrics.items():
        _compare(failures, f'{label} step {i + 1} {k}', tmetrics[k], v, 1e-5,
                 1e-5)
      _compare(failures, f'{label} step {i + 1} log_temperature',
               tstate.log_temperature, jstate.log_temperature, 1e-5)
      for path, p in _leaf_paths(tstate.params):
        # The key biases' gradients are rounding noise on both sides (see
        # the test above), which Adam scales to steps of up to ~lr each way.
        atol = 2 * lr * (i + 1) if path.endswith('/key/b') else 1e-5
        _compare(failures, f'{label} step {i + 1} {path}', p,
                 _get(jstate.params, path), atol)
    if tstate.step != 3:
      failures.append(f'{label}: step {tstate.step}')
  with pytest.raises(NotImplementedError, match='ROADMAP'):
    tts.make_optimizer(optimizer='lion')
  with pytest.raises(ValueError, match='int8'):    # int8 serves only
    tts.create_train_state(0, tcfg, topt, device='cpu',
                           pretrained_params=params_from_numpy(
                               quantize_for_serving(tree), device='cpu'))
  assert not failures, '\n'.join(failures[:50])
