"""K6's plain twin (videoprism_tpu_torch.ops.kernels.layer_norm) against the
JAX package's Pallas ``fused_layer_norm_2d`` in interpret mode, and the
port's ``basic.layer_norm`` against the JAX package's, on the CPU.

fp32: atol 1e-5 (the ops tolerance of ROADMAP.md).  bf16: the kernel and
the twin both take fp32 statistics and cast once, so they may differ only
where an fp32 last-bit difference flips the final bf16 rounding: one bf16
ulp, rtol 2**-7.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videoprism_tpu.ops import basic as jbasic
from videoprism_tpu.ops.pallas import layer_norm as jln
from videoprism_tpu_torch.ops import basic as tbasic
from videoprism_tpu_torch.ops.kernels import layer_norm as tln

ATOL = 1e-5


def _inputs(rows, d, direct_scale, seed=0):
  rng = np.random.default_rng(seed)
  x = (2.0 * rng.standard_normal((rows, d)) + 0.5).astype(np.float32)
  scale = ((1.0 if direct_scale else 0.0)
           + 0.1 * rng.standard_normal(d)).astype(np.float32)
  bias = (0.1 * rng.standard_normal(d)).astype(np.float32)
  return x, scale, bias


@pytest.mark.parametrize('direct_scale', [False, True])
@pytest.mark.parametrize('rows', [64, 8])
def test_twin_matches_pallas_kernel(direct_scale, rows):
  x, scale, bias = _inputs(rows, 256, direct_scale)
  want = jln.fused_layer_norm_2d(jnp.asarray(x), jnp.asarray(scale),
                                 jnp.asarray(bias), direct_scale=direct_scale,
                                 interpret=True)
  got = tln.fused_layer_norm_2d(*map(torch.from_numpy, (x, scale, bias)),
                                direct_scale=direct_scale)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                             rtol=0)


@pytest.mark.parametrize('direct_scale', [False, True])
def test_bf16_twin_matches_pallas_kernel(direct_scale):
  x, scale, bias = _inputs(32, 128, direct_scale, seed=1)
  cast = lambda a: jnp.asarray(a, jnp.bfloat16)
  want = jln.fused_layer_norm_2d(cast(x), cast(scale), cast(bias),
                                 direct_scale=direct_scale, interpret=True)
  bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)
  got = tln.fused_layer_norm_2d(bf(x), bf(scale), bf(bias),
                                direct_scale=direct_scale)
  assert got.dtype == torch.bfloat16
  np.testing.assert_allclose(got.float().numpy(),
                             np.asarray(want, np.float32), rtol=2 ** -7,
                             atol=1e-6)


@pytest.mark.parametrize('shape', [(2, 7, 96), (5, 128), (3, 1, 64)])
@pytest.mark.parametrize('direct_scale', [False, True])
def test_basic_layer_norm_matches_jax(shape, direct_scale):
  """Any rows and D (the JAX gate's rows % 8 and D % 128 are TPU tiling):
  the CPU takes the plain path, the JAX package's 'xla' one."""
  rng = np.random.default_rng(2)
  x = rng.standard_normal(shape).astype(np.float32)
  params = {'scale': (0.1 * rng.standard_normal(shape[-1])).astype(np.float32),
            'bias': (0.1 * rng.standard_normal(shape[-1])).astype(np.float32)}
  want = jbasic.layer_norm({k: jnp.asarray(v) for k, v in params.items()},
                           jnp.asarray(x), direct_scale=direct_scale,
                           impl='xla')
  got = tbasic.layer_norm({k: torch.from_numpy(v) for k, v in params.items()},
                          torch.from_numpy(x), direct_scale=direct_scale)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_dispatch_on_the_cpu():
  x, scale, bias = map(torch.from_numpy, _inputs(4, 16, False))
  params = {'scale': scale, 'bias': bias}
  assert torch.equal(tbasic.layer_norm(params, x),
                     tbasic.layer_norm(params, x, impl='reference'))
  with pytest.raises(ValueError, match='CUDA'):
    tbasic.layer_norm(params, x, impl='kernel')
  with pytest.raises(ValueError, match='CUDA'):
    tln.fused_layer_norm_2d(x, scale, bias, impl='kernel')
