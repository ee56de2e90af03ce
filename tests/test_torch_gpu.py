"""Hand-written Hopper kernels against their plain twins, on the card.

Marked ``gpu``; every test skips where ``torch.cuda.is_available()`` is
false.  The file imports no JAX, so it also runs where the suite's
conftest (which imports JAX) cannot:

    python -m pytest tests/test_torch_gpu.py -m gpu -q --noconftest

Tolerances are those of ``videoprism_tpu_torch.ops.kernels.cases``.
"""

import pytest
import torch

from videoprism_tpu_torch.models import clip as clip_lib
from videoprism_tpu_torch.models import factorized_encoder as fe
from videoprism_tpu_torch.models import init as init_lib
from videoprism_tpu_torch.io.checkpoints import prepare_for_kernels
from videoprism_tpu_torch.ops.kernels import _lib
from videoprism_tpu_torch.ops.kernels import cases as cases_lib

pytestmark = pytest.mark.gpu


@pytest.fixture
def device():
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA device')
  return torch.device('cuda', 0)


def _check(case):
  result = cases_lib.run_case(case)
  assert result['ok'], result


@pytest.mark.parametrize('t', [256, 16])
@pytest.mark.parametrize('cap', [50.0, 0.0])
@pytest.mark.parametrize('padded', [False, True])
def test_attention_block_main_path_shapes(device, t, cap, padded):
  b = 32 if t == 256 else 512   # two clips of 16 frames x 256 tokens
  _check(cases_lib.attention_case(b, t, 768, 12, 64, cap=cap, padded=padded,
                                  device=device))


@pytest.mark.parametrize('t', [4, 40, 100])
@pytest.mark.parametrize('cap', [50.0, 0.0])
def test_attention_block_ragged_lengths(device, t, cap):
  _check(cases_lib.attention_case(6, t, 128, 2, 64, cap=cap, padded=True,
                                  device=device))


@pytest.mark.parametrize('heads,head_dim', [(2, 88), (1, 128), (4, 8)])
def test_attention_block_head_dims(device, heads, head_dim):
  """Giant's 88-wide heads (padded to 96 inside), 128, and 8."""
  _check(cases_lib.attention_case(4, 24, 176, heads, head_dim, cap=50.0,
                                  padded=True, device=device))


@pytest.mark.parametrize('activation', ['gelu', 'relu'])
@pytest.mark.parametrize('padded', [False, True])
def test_ffn_block_main_path_shapes(device, activation, padded):
  _check(cases_lib.ffn_case(8192, 768, 3072, activation=activation,
                            padded=padded, device=device))


def test_ffn_block_ragged_rows(device):
  _check(cases_lib.ffn_case(200, 136, 264, activation='gelu', padded=True,
                            device=device))


@pytest.mark.parametrize('which', [0, 1])
def test_boundaries_main_path_shapes(device, which):
  _check(cases_lib.boundary_cases(2, 16, 256, 768, device=device)[which])


@pytest.mark.parametrize('cap', [50.0, 0.0])
@pytest.mark.parametrize('padded', [False, True])
def test_attention_block_causal_text_shapes(device, cap, padded):
  """The text tower: T = 65 unpadded, causal + padding [B, T, T] mask."""
  _check(cases_lib.attention_case(2, 65, 768, 12, 64, cap=cap, padded=padded,
                                  causal=True, device=device))


@pytest.mark.parametrize('cap', [50.0, 0.0])
@pytest.mark.parametrize('mask', ['none', 'keys', 'rows'])
def test_flash_attention_aux_shapes(device, cap, mask):
  """K5 at the auxiliary encoder's [2, 12, 4096, 64]."""
  _check(cases_lib.flash_case(2, 12, 4096, 4096, 64, cap=cap, mask=mask,
                              device=device))


@pytest.mark.parametrize('t,s,h', [(1, 1, 64), (100, 200, 32), (130, 70, 128),
                                   (256, 128, 16)])
@pytest.mark.parametrize('mask', ['keys', 'rows'])
def test_flash_attention_ragged_shapes(device, t, s, h, mask):
  """Query and key counts off the tile sizes, and other head widths."""
  _check(cases_lib.flash_case(3, 2, t, s, h, cap=50.0, mask=mask,
                              device=device))


@pytest.mark.parametrize('rows', [8192, 130, 1])
@pytest.mark.parametrize('direct_scale', [False, True])
def test_layer_norm_rows(device, rows, direct_scale):
  _check(cases_lib.layer_norm_case(rows, 768, direct_scale=direct_scale,
                                   device=device))


def test_dispatch_counts_and_refusals(device):
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
  with pytest.raises(ValueError, match='dim_per_head'):
    case.fn(*case.args, **dict(case.kwargs, num_heads=32, dim_per_head=4))
  flash = cases_lib.flash_case(1, 2, 128, 128, 64, cap=50.0, mask='none',
                               device=device)
  ln = cases_lib.layer_norm_case(16, 768, direct_scale=False, device=device)
  _lib.reset_launches()
  flash.fn(*flash.args, **flash.kwargs)
  ln.fn(*ln.args, **ln.kwargs)
  torch.cuda.synchronize()
  assert dict(_lib.LAUNCHES) == {'fused_attention': 1,
                                 'fused_layer_norm_2d': 1}
  with pytest.raises(ValueError, match='head dim'):
    q = flash.args[0][..., :8].contiguous()
    flash.fn(q, q, q, flash.args[3], **flash.kwargs)
  with pytest.raises(ValueError, match='bfloat16'):
    ln.fn(ln.args[0].float(), *ln.args[1:], **ln.kwargs)


def test_tiny_encoder_kernel_path_matches_reference(device):
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


def test_tiny_clip_kernel_path_matches_reference(device):
  """A tiny CLIP config whose auxiliary encoder sees 1152 tokens, so K5
  and K6 run beside K1-K4, against the plain path on the same card."""
  cfg = clip_lib.VideoCLIPConfig(
      patch_size=6, pos_emb_shape=(8, 12, 12), num_spatial_layers=1,
      num_temporal_layers=1, mlp_dim=128, num_auxiliary_layers=2,
      vocabulary_size=128, num_unimodal_layers=2, model_dim=64, num_heads=2,
      atten_logit_cap=50.0, dtype=torch.bfloat16)
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
  assert dict(_lib.LAUNCHES) == {
      'fused_attention_block': 4, 'fused_ffn_block': 6,
      'spatial_to_temporal': 1, 'temporal_to_output': 1,
      'fused_attention': 2, 'fused_layer_norm_2d': 4}
  want = clip_lib.apply(params, video, ids, pads, cfg, impl='reference')
  for g, w in zip(got[:2], want[:2]):
    assert g.shape == (2, 64) and bool(torch.isfinite(g).all())
    cos = torch.nn.functional.cosine_similarity(g.float(), w.float(), -1)
    assert cos.min().item() >= 0.999, cos.min().item()
