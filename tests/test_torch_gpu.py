"""Hand-written Hopper kernels against their plain twins, on the card.

Marked ``gpu``; every test skips where ``torch.cuda.is_available()`` is
false.  The file imports no JAX, so it also runs where the suite's
conftest (which imports JAX) cannot:

    python -m pytest tests/test_torch_gpu.py -m gpu -q --noconftest

Tolerances are those of ``videoprism_tpu_torch.ops.kernels.cases``.  The
kernel cases are grouped, a few tests to a family of shapes, each running
every case and reporting every one that disagrees: the suite's item count
is kept low on purpose (ROADMAP.md, "the item-count trap"): the int8
kernels (K9-K12b) run inside ``test_dispatch_counts_and_refusals``, the
tiny models and the tiny CLIP train step inside
``test_tiny_models_kernel_path_matches_reference``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from videoprism_tpu_torch import quantization
from videoprism_tpu_torch.io.checkpoints import (
    params_from_numpy,
    prepare_for_kernels,
)
from videoprism_tpu_torch.models import classifier as vc_lib
from videoprism_tpu_torch.models import clip as clip_lib
from videoprism_tpu_torch.models import factorized_encoder as fe
from videoprism_tpu_torch.models import init as init_lib
from videoprism_tpu_torch.models import registry
from videoprism_tpu_torch.ops import masks as mask_lib
from videoprism_tpu_torch.ops import transformer as transformer_lib
from videoprism_tpu_torch.ops.kernels import _lib
from videoprism_tpu_torch.ops.kernels import cases as cases_lib
from videoprism_tpu_torch.train import objectives
from videoprism_tpu_torch.train import train_step as train_lib

pytestmark = pytest.mark.gpu


@pytest.fixture
def device():
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA device')
  return torch.device('cuda', 0)


def _check_all(cases):
  """Runs every case; fails listing each that disagrees with its twin."""
  bad = [r for r in map(cases_lib.run_case, cases) if not r['ok']]
  assert not bad, bad


def test_kernels_at_the_paths_and_ragged_shapes(device):
  """K1-K7 at the shapes of two requests: the base encoder's spatial and
  temporal attention (cap 50 and 0, with and without paddings), its FFN
  (gelu and relu), the boundaries; the text tower's causal T = 65; K5 at
  the auxiliary encoder's [2, 12, 4096, 64]; K6 at 8192, 130 and 1 rows;
  K7 at the lvt base train step's shapes; K2 at one B=8 product shape
  (32768 rows) and at 1 and 130 rows; K1 at the route's longest T = 1024
  at head dims 64 and 88, cap 50 and 0, padded.  Then ragged shapes: K1 at
  lengths off the tiles (4, 40, 100) and at head dims 88 (giant's, padded
  to 96 inside), 128 and 8; K2 with ragged rows; K5 and K7 with query and
  key counts off the tiles and other head widths (giant's 88, 8 and 96
  among them, 88 and 8 padded to 96 and 16 inside)."""
  cases = []
  # Two clips of 16 frames x 256 tokens, and the text tower's 65 tokens.
  for b, t, causal in ((32, 256, False), (512, 16, False), (2, 65, True)):
    for cap in (50.0, 0.0):
      for padded in (False, True):
        cases.append(cases_lib.attention_case(b, t, 768, 12, 64, cap=cap,
                                              padded=padded, causal=causal,
                                              device=device))
  for activation in ('gelu', 'relu'):
    for padded in (False, True):
      cases.append(cases_lib.ffn_case(8192, 768, 3072, activation=activation,
                                      padded=padded, device=device))
  cases += cases_lib.boundary_cases(2, 16, 256, 768, device=device)
  for cap in (50.0, 0.0):
    for mask in ('none', 'keys', 'rows'):
      cases.append(cases_lib.flash_case(2, 12, 4096, 4096, 64, cap=cap,
                                        mask=mask, device=device))
  for rows in (8192, 130, 1):
    for direct_scale in (False, True):
      cases.append(cases_lib.layer_norm_case(rows, 768,
                                             direct_scale=direct_scale,
                                             device=device))
  cases += cases_lib.flash_bwd_path_cases(device)
  cases.append(cases_lib.ffn_case(32768, 768, 3072, activation='gelu',
                                  padded=True, device=device))
  for rows, padded in ((1, False), (130, True)):
    cases.append(cases_lib.ffn_case(rows, 768, 3072, activation='gelu',
                                    padded=padded, device=device))
  t = transformer_lib.MAX_FUSED_ATTENTION_T
  for d, heads, head_dim in ((768, 12, 64), cases_lib.GIANT[:3]):
    for cap in (50.0, 0.0):
      cases.append(cases_lib.attention_case(1, t, d, heads, head_dim, cap=cap,
                                            padded=True, device=device))

  for t in (4, 40, 100):
    for cap in (50.0, 0.0):
      cases.append(cases_lib.attention_case(6, t, 128, 2, 64, cap=cap,
                                            padded=True, device=device))
  for heads, head_dim in ((2, 88), (1, 128), (4, 8)):
    cases.append(cases_lib.attention_case(4, 24, 176, heads, head_dim,
                                          cap=50.0, padded=True,
                                          device=device))
  cases.append(cases_lib.ffn_case(200, 136, 264, activation='gelu',
                                  padded=True, device=device))
  for t, s, h in ((1, 1, 64), (100, 200, 32), (130, 70, 128), (256, 128, 16),
                  (70, 130, 88), (33, 65, 8), (100, 70, 96)):
    for mask in ('keys', 'rows'):
      cases.append(cases_lib.flash_case(3, 2, t, s, h, cap=50.0, mask=mask,
                                        device=device))
  for t, s, h in ((1, 1, 64), (100, 200, 32), (130, 70, 64), (65, 65, 48),
                  (70, 130, 88), (33, 65, 8), (100, 70, 96)):
    for mask in ('keys', 'rows'):
      for cap in (50.0, 0.0):
        cases.append(cases_lib.flash_bwd_case(3, 2, t, s, h, cap=cap,
                                              mask=mask, with_ctx=True,
                                              device=device))
  cases.append(cases_lib.flash_bwd_case(3, 2, 130, 70, 16, cap=50.0,
                                        mask='keys', with_ctx=False,
                                        device=device))
  _check_all(cases)


def test_chunked_kernels(device):
  """K8a at narrow widths (head groups of 48 columns, not a multiple of the
  GEMM's 32-deep tile; 4 groups; giant's 88-wide heads) and at giant's
  spatial and temporal shapes; K8b with ragged rows and F-slices of 136
  and 64 columns, and at large's and giant's rows."""
  cases = []
  for heads, head_dim, chunks in ((4, 24, 2), (4, 32, 4), (2, 88, 2)):
    for cap in (50.0, 0.0):
      cases.append(cases_lib.attention_case(6, 40, 136, heads, head_dim,
                                            cap=cap, padded=True,
                                            chunks=chunks, device=device))
  for f, chunks in ((272, 2), (256, 4)):
    cases.append(cases_lib.ffn_case(200, 136, f, activation='gelu',
                                    padded=True, chunks=chunks,
                                    device=device))
  _check_all(cases + cases_lib.wide_path_cases(device))


def test_dispatch_counts_and_refusals(device):
  """Every wrapper counts its own launches and refuses what its kernel does
  not take; the int8 kernels also run their twin checks and tiny int8
  models here (``_int8_kernels_and_dispatch``)."""
  case = cases_lib.attention_case(2, 16, 128, 2, 64, cap=50.0, padded=False,
                                  device=device)
  _lib.reset_launches()
  case.fn(*case.args, **case.kwargs)
  case.fn(*case.args, **case.kwargs, impl='reference')
  torch.cuda.synchronize()
  assert _lib.LAUNCHES['fused_attention_block'] == 1
  with pytest.raises(ValueError, match='bfloat16'):
    case.fn(case.args[0].float(), *case.args[1:], **case.kwargs)
  with pytest.raises(ValueError, match='contiguous'):
    case.fn(case.args[0].transpose(0, 1), *case.args[1:], **case.kwargs)
  # A head dim off a multiple of 8 (32 heads of 4) runs padded to 8; one
  # past the attention core's 128 raises, naming it.
  _check_all([dataclasses.replace(
      case, kwargs=dict(case.kwargs, num_heads=32, dim_per_head=4))])
  wide = cases_lib.attention_case(1, 16, 136, 1, 136, cap=50.0,
                                  padded=False, device=device)
  with pytest.raises(ValueError, match='at most 128'):
    wide.fn(*wide.args, **wide.kwargs)
  flash = cases_lib.flash_case(1, 2, 128, 128, 64, cap=50.0, mask='none',
                               device=device)
  ln = cases_lib.layer_norm_case(16, 768, direct_scale=False, device=device)
  _lib.reset_launches()
  flash.fn(*flash.args, **flash.kwargs)
  ln.fn(*ln.args, **ln.kwargs)
  torch.cuda.synchronize()
  assert dict(_lib.LAUNCHES) == {'fused_attention': 1,
                                 'fused_layer_norm_2d': 1}
  # K5 pads a head dim off a multiple of 8 (12 -> 16) and raises past 128.
  _check_all([cases_lib.flash_case(2, 2, 128, 128, 12, cap=50.0,
                                   mask='keys', device=device)])
  q136 = torch.zeros((1, 2, 128, 136), dtype=torch.bfloat16, device=device)
  with pytest.raises(ValueError, match='head dim 136.*at most 128'):
    flash.fn(q136, q136, q136, flash.args[3], **flash.kwargs)
  with pytest.raises(ValueError, match='bfloat16'):
    ln.fn(ln.args[0].float(), *ln.args[1:], **ln.kwargs)
  # K7 counts its launches (and those that emit the context), takes
  # giant's head dim (88, padded to 96 inside) and refuses one past its
  # limit, naming it.
  bwd = cases_lib.flash_bwd_case(1, 2, 128, 128, 64, cap=50.0, mask='none',
                                 with_ctx=True, device=device)
  _lib.reset_launches()
  bwd.fn(*bwd.args, **bwd.kwargs)
  bwd.fn(*bwd.args, **bwd.kwargs, impl='reference')
  torch.cuda.synchronize()
  assert dict(_lib.LAUNCHES) == {'fused_attention_bwd': 1}
  assert _lib.CTX_LAUNCHES['fused_attention_bwd'] == 1
  _check_all([cases_lib.flash_bwd_case(1, 2, 128, 128, hd, cap=50.0,
                                       mask='none', with_ctx=True,
                                       device=device) for hd in (88, 36)])
  q104 = torch.zeros((1, 2, 128, 104), dtype=torch.bfloat16, device=device)
  with pytest.raises(ValueError, match='head dim 104.*at most 96'):
    bwd.fn(q104, q104, q104, bwd.args[3], q104, **bwd.kwargs)
  # Under autograd on the card a block runs its kernel forward and K7 in
  # its backward, never a twin.
  att = cases_lib.attention_case(2, 40, 128, 2, 64, cap=50.0, padded=True,
                                 device=device)
  args = [a.clone().requires_grad_(a.dtype == torch.bfloat16)
          for a in att.args]
  _lib.reset_launches()
  att.fn(*args, **att.kwargs).float().sum().backward()
  torch.cuda.synchronize()
  assert dict(_lib.LAUNCHES) == {'fused_attention_block': 1,
                                 'fused_attention_bwd': 1}
  assert all(a.grad is not None and bool(torch.isfinite(a.grad).all())
             for a in args if a.requires_grad)
  # K8a and K8b count their own launches and refuse chunks that do not
  # divide the heads or leave F-slices off 16-byte rows.
  att = cases_lib.attention_case(2, 16, 128, 4, 32, cap=50.0, padded=False,
                                 chunks=2, device=device)
  ffn = cases_lib.ffn_case(64, 128, 256, activation='relu', padded=False,
                           chunks=2, device=device)
  _lib.reset_launches()
  att.fn(*att.args, **att.kwargs)
  ffn.fn(*ffn.args, **ffn.kwargs)
  att.fn(*att.args, **att.kwargs, impl='reference')
  torch.cuda.synchronize()
  assert dict(_lib.LAUNCHES) == {'fused_attention_block_chunked': 1,
                                 'fused_ffn_block_chunked': 1}
  with pytest.raises(ValueError, match='chunks'):
    att.fn(*att.args, **dict(att.kwargs, chunks=3))
  with pytest.raises(ValueError, match='chunks'):
    ffn.fn(*ffn.args, **dict(ffn.kwargs, chunks=64))   # slices of 4
  _int8_kernels_and_dispatch(device)


def _layer_params(device, d, heads, f, seed=0):
  cfg = transformer_lib.TransformerLayerConfig(
      num_layers=1, hidden_dim=f, num_heads=heads, activation='gelu',
      enable_per_dim_scale=False, logit_cap=50.0, dtype=torch.bfloat16)
  init = init_lib._Init(seed, 0.1)
  params = prepare_for_kernels(params_from_numpy(
      {'layer': init.layer(d, cfg)}, device=device,
      dtype=torch.bfloat16))['layer']
  return params, cfg


def _min_cosine(got, want):
  return torch.nn.functional.cosine_similarity(
      got.float(), want.float(), -1).min().item()


def test_attention_capacity_gate(device):
  """K1's core streams K and V, so it takes every T up to the route's 1024
  (ROADMAP fault 3.1, closed): K1 at T = 1024 at H = 64 and 88 agrees with
  its twin; a base-width and a giant-width layer at T = 1024 run through
  the core on the route the reference's chunk rule picks (K8a over 4 head
  groups; K1) and agree with the plain path, as does lvt base with a
  4-frame clip (auxiliary T = 1024: K8a); past the route, at giant's head
  dim (ROADMAP fault 3.2, closed), the giant-width layer takes the
  composed half, K6 + K5, and agrees with the plain path at T = 1032 and
  1152 (on the card K5 takes lengths off 128 too)."""
  _check_all(cases_lib.capacity_cases(device))
  gen = torch.Generator(device=device).manual_seed(0)
  t = transformer_lib.MAX_FUSED_ATTENTION_T
  for b, d, heads, f, want_routes in (
      (2, 768, 12, 3072, {'fused_attention_block_chunked': 1,
                          'fused_ffn_block': 1}),
      (1, 1408, 16, 6144, {'fused_attention_block': 1,
                           'fused_ffn_block_chunked': 1})):
    params, cfg = _layer_params(device, d, heads, f)
    x = torch.randn((b, t, d), generator=gen, device=device,
                    dtype=torch.bfloat16)
    pads = torch.zeros((b, t), device=device)
    pads[-1, 900:] = 1.0
    mask = mask_lib.attention_mask_for_fprop(x, pads)
    _lib.reset_launches()
    got = transformer_lib.transformer_layer(params, x, pads, mask, cfg)
    torch.cuda.synchronize()
    assert dict(_lib.LAUNCHES) == want_routes
    want = transformer_lib.transformer_layer(params, x, pads, mask, cfg,
                                             impl='reference')
    assert _min_cosine(got, want) >= 0.999

  want_routes = {'fused_layer_norm_2d': 1, 'fused_attention': 1,
                 'fused_ffn_block_chunked': 1}
  for t_past in (t + 8, t + 128):
    x = torch.randn((1, t_past, 1408), generator=gen, device=device,
                    dtype=torch.bfloat16)
    pads = torch.zeros((1, t_past), device=device)
    pads[0, 900:] = 1.0
    mask = mask_lib.attention_mask_for_fprop(x, pads)
    _lib.reset_launches()
    got = transformer_lib.transformer_layer(params, x, pads, mask, cfg)
    torch.cuda.synchronize()
    assert dict(_lib.LAUNCHES) == want_routes
    want = transformer_lib.transformer_layer(params, x, pads, mask, cfg,
                                             impl='reference')
    assert _min_cosine(got, want) >= 0.999

  model = registry.get_model('videoprism_lvt_public_v1_base',
                             fprop_dtype=torch.bfloat16)
  params = prepare_for_kernels(model.init(0, device=device,
                                          norm_bias_std=0.1)['params'])
  video = torch.rand((2, 4, 288, 288, 3), generator=gen, device=device)
  _lib.reset_launches()
  got, _, _ = model.apply(params, video)
  torch.cuda.synchronize()
  assert dict(_lib.LAUNCHES) == {
      'fused_attention_block': 16, 'fused_attention_block_chunked': 2,
      'fused_ffn_block': 18, 'spatial_to_temporal': 1,
      'temporal_to_output': 1, 'fused_layer_norm_2d': 1}
  want, _, _ = model.apply(params, video, impl='reference')
  assert got.shape == (2, 768) and bool(torch.isfinite(got).all())
  assert _min_cosine(got, want) >= 0.999


def _tiny_encoder(device):
  cfg = fe.FactorizedEncoderConfig(
      patch_size=6, pos_emb_shape=(4, 4, 4), model_dim=128,
      num_spatial_layers=2, num_temporal_layers=2, num_heads=2, mlp_dim=256,
      atten_logit_cap=50.0, dtype=torch.bfloat16)
  params = prepare_for_kernels(init_lib.init_factorized_encoder(
      0, cfg, device=device, dtype=torch.bfloat16, norm_bias_std=0.1))
  gen = torch.Generator(device=device).manual_seed(0)
  video = torch.randn((2, 4, 24, 24, 3), generator=gen, device=device)
  frame_paddings = torch.tensor([[0, 0, 0, 1], [0, 0, 0, 0]],
                                dtype=torch.float32, device=device)
  _lib.reset_launches()
  got, _ = fe.apply(params, video, cfg, frame_paddings=frame_paddings)
  torch.cuda.synchronize()
  assert dict(_lib.LAUNCHES) == {
      'fused_attention_block': 4, 'fused_ffn_block': 4,
      'spatial_to_temporal': 1, 'temporal_to_output': 1}
  want, _ = fe.apply(params, video, cfg, frame_paddings=frame_paddings,
                     impl='reference')
  assert got.shape == (2, 64, 128) and bool(torch.isfinite(got).all())
  cos = torch.nn.functional.cosine_similarity(got.float(), want.float(), -1)
  assert cos.min().item() >= 0.999, cos.min().item()


def _tiny_clip_config(dtype=torch.bfloat16):
  return clip_lib.VideoCLIPConfig(
      patch_size=6, pos_emb_shape=(8, 12, 12), num_spatial_layers=1,
      num_temporal_layers=1, mlp_dim=128, num_auxiliary_layers=2,
      vocabulary_size=128, num_unimodal_layers=2, model_dim=64, num_heads=2,
      atten_logit_cap=50.0, dtype=dtype)


def _tiny_clip(device):
  """A tiny CLIP config whose auxiliary encoder sees 1152 tokens, so K5
  and K6 run beside K1-K4, against the plain path on the same card."""
  cfg = _tiny_clip_config()
  params = prepare_for_kernels(init_lib.init_video_clip(
      0, cfg, device=device, dtype=torch.bfloat16, norm_bias_std=0.1))
  gen = torch.Generator(device=device).manual_seed(0)
  video = torch.randn((2, 8, 72, 72, 3), generator=gen, device=device)
  ids = torch.randint(0, 128, (2, 16), generator=gen, device=device)
  pads = (torch.arange(16, device=device)
          >= torch.tensor([[16], [5]], device=device)).float()
  _lib.reset_launches()
  got = clip_lib.apply(params, video, ids, pads, cfg)
  torch.cuda.synchronize()
  # Width 64 is not a multiple of 128, so the reference's plan chains every
  # FFN in 2 F-slices (K8b).
  assert dict(_lib.LAUNCHES) == {
      'fused_attention_block': 4, 'fused_ffn_block_chunked': 6,
      'spatial_to_temporal': 1, 'temporal_to_output': 1,
      'fused_attention': 2, 'fused_layer_norm_2d': 4}
  want = clip_lib.apply(params, video, ids, pads, cfg, impl='reference')
  for g, w in zip(got[:2], want[:2]):
    assert g.shape == (2, 64) and bool(torch.isfinite(g).all())
    cos = torch.nn.functional.cosine_similarity(g.float(), w.float(), -1)
    assert cos.min().item() >= 0.999, cos.min().item()


def _tiny_classifier(device):
  """A tiny classifier (width 64: the FFN chained in 2 F-slices) against
  the plain path on the same card."""
  cfg = vc_lib.VideoClassifierConfig(
      fe.FactorizedEncoderConfig(
          patch_size=6, pos_emb_shape=(4, 4, 4), model_dim=64,
          num_spatial_layers=2, num_temporal_layers=2, num_heads=2,
          mlp_dim=128, atten_logit_cap=50.0, dtype=torch.bfloat16), 10)
  params = prepare_for_kernels(init_lib.init_video_classifier(
      0, cfg, device=device, dtype=torch.bfloat16, norm_bias_std=0.1))
  video = torch.from_numpy(np.random.default_rng(0).standard_normal(
      (2, 4, 24, 24, 3)).astype(np.float32)).to(device)
  _lib.reset_launches()
  got, _ = vc_lib.apply(params, video, cfg)
  torch.cuda.synchronize()
  assert dict(_lib.LAUNCHES) == {
      'fused_attention_block': 4, 'fused_ffn_block_chunked': 4,
      'spatial_to_temporal': 1, 'temporal_to_output': 1,
      'fused_layer_norm_2d': 1}
  want, _ = vc_lib.apply(params, video, cfg, impl='reference')
  assert got.shape == (2, 10) and bool(torch.isfinite(got).all())
  assert _min_cosine(got, want) >= 0.999


def _tiny_train(device):
  """The tiny CLIP config's loss and gradients (fp32 master weights): the
  kernel path in bf16, K7 in every attention backward, against the plain
  path in fp32 (autograd through the twins) on the same card: the cosine
  of the whole gradient at 0.999 or, where the bf16 plain path itself
  falls below that, no farther from the fp32 path than
  ``cases.FP32_ERR_RATIO`` times it (``chip_smoke.py [train]``'s gate)."""
  cfg = _tiny_clip_config()
  params = init_lib.init_video_clip(0, cfg, device=device, norm_bias_std=0.1)
  trainable = (params, objectives.init_temperature_state('infonce',
                                                         device=device))
  gen = torch.Generator(device=device).manual_seed(1)
  ids = torch.randint(0, 128, (2, 16), generator=gen, device=device)
  batch = {'video': torch.randn((2, 8, 72, 72, 3), generator=gen,
                                device=device),
           'text_token_ids': ids,
           'text_paddings': (torch.arange(16, device=device) >= torch.tensor(
               [[16], [5]], device=device)).float()}
  vg = train_lib.value_and_grad(train_lib.clip_loss_fn)
  _lib.reset_launches()
  (loss, _), grads = vg(trainable, batch, cfg)
  torch.cuda.synchronize()
  # Spatial, temporal and 2 text layers with the context, 2 auxiliary
  # layers (K5) without.
  assert _lib.LAUNCHES['fused_attention_bwd'] == 6
  assert _lib.CTX_LAUNCHES['fused_attention_bwd'] == 4
  (loss32, _), grads32 = vg(trainable, batch,
                            _tiny_clip_config(torch.float32),
                            impl='reference')
  (_, _), grads16 = vg(trainable, batch, cfg, impl='reference')
  assert abs(loss.item() - loss32.item()) <= 1e-2
  flat = lambda g: torch.cat([x.double().flatten() for x in
                              train_lib.tree_leaves(g)])
  cos = lambda a: torch.nn.functional.cosine_similarity(
      flat(a), flat(grads32), dim=0).item()
  got, twin = cos(grads), cos(grads16)
  assert got >= 0.999 or 1.0 - got <= cases_lib.FP32_ERR_RATIO * (
      1.0 - twin), (got, twin)


def test_tiny_models_kernel_path_matches_reference(device):
  """Tiny encoder, CLIP model, classifier and CLIP train step through the
  kernels against the plain path on the same card."""
  _tiny_encoder(device)
  _tiny_clip(device)
  _tiny_classifier(device)
  _tiny_train(device)


def _int8_params(tree, device):
  return prepare_for_kernels(params_from_numpy(
      quantization.quantize_for_serving(tree), device=device,
      dtype=torch.bfloat16))


def _int8_kernels_and_dispatch(device):
  """K9-K12b against their twins at ragged and chunked shapes (rows and T
  off the tiles, widths of 144, head groups of 48, F-chunks of 144 and 64)
  and at the int8 paths' shapes (the giant encoder's too); their launch
  counts and refusals; an int8 layer at T = 800, H = 64 on the
  reference's route (K10 and K9 in one chunk), and past the fused route at
  giant's H = 88 (K12a + K5 + K12b, K9 over 2 F-slices); a tiny int8 encoder
  through K11 (F = 256) and through K10 + K9 (F = 192, which
  the reference's layer kernel refuses) and a tiny int8 CLIP through K12a
  + K5 + K12b, each against the plain path on the card."""
  ffn = cases_lib.int8_ffn_case(200, 144, 288, activation='gelu',
                                padded=True, chunks=2, device=device)
  _check_all([
      ffn,
      cases_lib.int8_ffn_case(200, 144, 256, activation='relu', padded=True,
                              chunks=4, device=device),
      cases_lib.int8_attention_case(6, 40, 144, 3, 48, cap=50.0, padded=True,
                                    chunks=3, device=device),
      cases_lib.int8_attention_case(5, 100, 128, 2, 64, cap=0.0, padded=True,
                                    causal=True, chunks=1, device=device),
      cases_lib.int8_layer_case(3, 24, 128, 4, 32, 256, cap=50.0,
                                padded=True, chunks=(2, 2), device=device),
      cases_lib.int8_layer_case(2, 65, 144, 3, 48, 288, cap=0.0, padded=True,
                                causal=True, chunks=(3, 2), device=device),
      *cases_lib.int8_projection_cases(200, 144, 128, device=device),
      *cases_lib.int8_path_cases(device),
      *cases_lib.int8_giant_cases(device),
  ])
  # The products that quantize their own rows (K12b at ragged rows and
  # giant's width, K11 at (2, 2) and T = 65) hold their twins and are the
  # bits of their composition from the primitives in separate launches.
  fused = [
      *cases_lib.int8_projection_cases(300, 1408, 1408, device=device),
      cases_lib.int8_layer_case(2, 65, 256, 4, 64, 512, cap=50.0, padded=True,
                                causal=True, chunks=(2, 2), device=device),
      cases_lib.int8_layer_case(2, 65, 144, 3, 48, 288, cap=0.0, padded=True,
                                causal=True, chunks=(3, 2), device=device),
  ]
  _check_all(fused)
  for case in fused:
    got = cases_lib._joined(case.fn(*case.args, **case.kwargs))
    assert torch.equal(got, cases_lib._joined(
        cases_lib.int8_composed(case))), case.label

  _lib.reset_launches()
  ffn.fn(*ffn.args, **ffn.kwargs)
  ffn.fn(*ffn.args, **ffn.kwargs, impl='reference')
  torch.cuda.synchronize()
  assert dict(_lib.LAUNCHES) == {'int8_ffn_block_chunked': 1}
  with pytest.raises(ValueError, match='bfloat16'):
    ffn.fn(ffn.args[0].float(), *ffn.args[1:], **ffn.kwargs)
  with pytest.raises(ValueError, match='int8'):
    kmajor = dict(ffn.kwargs['kmajor'],
                  w1=ffn.kwargs['kmajor']['w1'].bfloat16())
    ffn.fn(*ffn.args, **dict(ffn.kwargs, kmajor=kmajor))
  # Given [K, N] weights the wrappers build the K-major operands
  # themselves: the same bits (K12a's projection too, with its one launch).
  for case in (ffn, cases_lib.int8_attention_case(
      6, 40, 144, 3, 48, cap=50.0, padded=True, chunks=3, device=device),
               *cases_lib.int8_projection_cases(200, 144, 128,
                                                device=device)):
    got = cases_lib._joined(case.fn(*case.args, **case.kwargs))
    kn = cases_lib._joined(case.fn(*case.args,
                                   **dict(case.kwargs, kmajor=None)))
    assert torch.equal(got, kn), case.label
  with pytest.raises(ValueError, match='multiple of 16'):
    ffn.fn(*ffn.args, **dict(ffn.kwargs, chunks=36))      # chunks of 8

  # At T = 800, H = 64 (past the old core's shared-memory capacity) the
  # layer takes the reference's route (int8_plan): K10 in one head group
  # around K1's core, K9 in one F-chunk.
  cfg = transformer_lib.TransformerLayerConfig(
      num_layers=1, hidden_dim=256, num_heads=2, activation='gelu',
      enable_per_dim_scale=False, logit_cap=50.0, dtype=torch.bfloat16)
  params = _int8_params({'layer': init_lib._Init(0, 0.1).layer(128, cfg)},
                        device)['layer']
  gen = torch.Generator(device=device).manual_seed(0)
  x = torch.randn((2, 800, 128), generator=gen, device=device,
                  dtype=torch.bfloat16)
  pads = torch.zeros((2, 800), device=device)
  pads[1, 700:] = 1.0
  mask = mask_lib.attention_mask_for_fprop(x, pads)
  _lib.reset_launches()
  got = transformer_lib.transformer_layer(params, x, pads, mask, cfg)
  torch.cuda.synchronize()
  assert dict(_lib.LAUNCHES) == {
      'int8_attention_block_chunked': 1, 'int8_ffn_block_chunked': 1}
  want = transformer_lib.transformer_layer(params, x, pads, mask, cfg,
                                           impl='reference')
  assert _min_cosine(got, want) >= 0.999
  # Past the fused route (T = 1032) the reference's int8 route is K12a + K5
  # + K12b, K5 at giant's head dim (88, padded to 96 inside).
  cfg = dataclasses.replace(cfg, hidden_dim=6144, num_heads=16)
  params = _int8_params({'layer': init_lib._Init(0, 0.1).layer(1408, cfg)},
                        device)['layer']
  t = transformer_lib.MAX_FUSED_ATTENTION_T + 8
  x = torch.randn((1, t, 1408), generator=gen, device=device,
                  dtype=torch.bfloat16)
  pads = torch.zeros((1, t), device=device)
  pads[0, 900:] = 1.0
  mask = mask_lib.attention_mask_for_fprop(x, pads)
  _lib.reset_launches()
  got = transformer_lib.transformer_layer(params, x, pads, mask, cfg)
  torch.cuda.synchronize()
  assert dict(_lib.LAUNCHES) == {
      'int8_qkv_projection': 1, 'fused_attention': 1,
      'int8_out_projection': 1, 'int8_ffn_block_chunked': 1}
  want = transformer_lib.transformer_layer(params, x, pads, mask, cfg,
                                           impl='reference')
  assert _min_cosine(got, want) >= 0.999

  video = torch.randn((2, 4, 24, 24, 3), generator=gen, device=device)
  for f, want_launches in (
      (256, {'int8_layer_block': 4}),
      (192, {'int8_attention_block_chunked': 4,
             'int8_ffn_block_chunked': 4})):
    cfg = fe.FactorizedEncoderConfig(
        patch_size=6, pos_emb_shape=(4, 4, 4), model_dim=128,
        num_spatial_layers=2, num_temporal_layers=2, num_heads=2, mlp_dim=f,
        atten_logit_cap=50.0, dtype=torch.bfloat16)
    params = _int8_params(init_lib.numpy_factorized_encoder(
        0, cfg, norm_bias_std=0.1), device)
    _lib.reset_launches()
    got, _ = fe.apply(params, video, cfg)
    torch.cuda.synchronize()
    assert dict(_lib.LAUNCHES) == dict(
        want_launches, spatial_to_temporal=1, temporal_to_output=1)
    want, _ = fe.apply(params, video, cfg, impl='reference')
    assert got.shape == (2, 64, 128) and bool(torch.isfinite(got).all())
    assert _min_cosine(got, want) >= 0.999

  cfg = clip_lib.VideoCLIPConfig(
      patch_size=6, pos_emb_shape=(8, 12, 12), num_spatial_layers=1,
      num_temporal_layers=1, mlp_dim=256, num_auxiliary_layers=2,
      vocabulary_size=128, num_unimodal_layers=2, model_dim=128, num_heads=2,
      atten_logit_cap=50.0, dtype=torch.bfloat16)
  params = _int8_params(init_lib.numpy_video_clip(0, cfg, norm_bias_std=0.1),
                        device)
  video = torch.randn((2, 8, 72, 72, 3), generator=gen, device=device)
  ids = torch.randint(0, 128, (2, 16), generator=gen, device=device)
  pads = (torch.arange(16, device=device)
          >= torch.tensor([[16], [5]], device=device)).float()
  _lib.reset_launches()
  got = clip_lib.apply(params, video, ids, pads, cfg)
  torch.cuda.synchronize()
  assert dict(_lib.LAUNCHES) == {
      'int8_layer_block': 4, 'int8_qkv_projection': 2, 'fused_attention': 2,
      'int8_out_projection': 2, 'int8_ffn_block_chunked': 2,
      'spatial_to_temporal': 1, 'temporal_to_output': 1,
      'fused_layer_norm_2d': 2}
  want = clip_lib.apply(params, video, ids, pads, cfg, impl='reference')
  for g, w in zip(got[:2], want[:2]):
    assert g.shape == (2, 128) and bool(torch.isfinite(g).all())
    assert _min_cosine(g, w) >= 0.999
