"""K3/K4 twins of videoprism_tpu_torch against the JAX package's Pallas
boundary kernels (interpret mode), on the CPU.

fp32: atol 1e-6 (the same fp32 LN; only summation order differs).
bf16: both round once, after the fp32 LN (+ pos-emb); compared in fp32 with
atol = rtol = 1e-2, about one bf16 ulp at the outputs' magnitude.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videoprism_tpu.ops.pallas import boundary as jbd
from videoprism_tpu_torch.ops.kernels import _lib
from videoprism_tpu_torch.ops.kernels import boundary as tbd

B, T, N, D = 2, 4, 16, 128


def _inputs(seed, shape):
  rng = np.random.default_rng(seed)
  return (rng.standard_normal(shape).astype(np.float32) * 2 + 0.5,
          (0.1 * rng.standard_normal(D)).astype(np.float32),
          (0.1 * rng.standard_normal(D)).astype(np.float32),
          rng.standard_normal((T, D)).astype(np.float32))


@pytest.mark.parametrize('tdtype,jdtype,atol,rtol', [
    (torch.float32, jnp.float32, 1e-6, 0.0),
    (torch.bfloat16, jnp.bfloat16, 1e-2, 1e-2)])
@pytest.mark.parametrize('pos_rank', [2, 3])
def test_spatial_to_temporal(tdtype, jdtype, atol, rtol, pos_rank):
  x, s, b, pos = _inputs(0, (B * T, N, D))
  pos = pos if pos_rank == 2 else pos[None]
  t = lambda a: torch.from_numpy(a).to(tdtype)
  j = lambda a: jnp.asarray(a).astype(jdtype)
  got = tbd.spatial_to_temporal(t(x), t(s), t(b), t(pos), b=B, t=T)
  want = jbd.spatial_to_temporal(j(x), j(s), j(b), j(pos), b=B, t=T,
                                 interpret=True)
  assert tuple(got.shape) == want.shape == (B * N, T, D)
  np.testing.assert_allclose(got.float().numpy(),
                             np.asarray(want.astype(jnp.float32)),
                             atol=atol, rtol=rtol)


@pytest.mark.parametrize('tdtype,jdtype,atol,rtol', [
    (torch.float32, jnp.float32, 1e-6, 0.0),
    (torch.bfloat16, jnp.bfloat16, 1e-2, 1e-2)])
def test_temporal_to_output(tdtype, jdtype, atol, rtol):
  x, s, b, _ = _inputs(1, (B * N, T, D))
  t = lambda a: torch.from_numpy(a).to(tdtype)
  j = lambda a: jnp.asarray(a).astype(jdtype)
  got = tbd.temporal_to_output(t(x), t(s), t(b), b=B, n=N)
  want = jbd.temporal_to_output(j(x), j(s), j(b), b=B, n=N, interpret=True)
  assert tuple(got.shape) == want.shape == (B, T * N, D)
  np.testing.assert_allclose(got.float().numpy(),
                             np.asarray(want.astype(jnp.float32)),
                             atol=atol, rtol=rtol)


def test_shape_errors_and_cpu_dispatch():
  x, s, b, pos = (torch.from_numpy(a) for a in _inputs(2, (B * T, N, D)))
  with pytest.raises(ValueError, match='do not match'):
    tbd.spatial_to_temporal(x, s, b, pos, b=B, t=T + 1)
  with pytest.raises(ValueError, match='do not match'):
    tbd.temporal_to_output(x, s, b, b=B, n=N + 1)
  _lib.reset_launches()
  with pytest.raises(ValueError, match='CUDA'):
    tbd.spatial_to_temporal(x, s, b, pos, b=B, t=T, impl='kernel')
  tbd.spatial_to_temporal(x, s, b, pos, b=B, t=T)
  tbd.temporal_to_output(x.reshape(B * N, T, D), s, b, b=B, n=N)
  assert sum(_lib.LAUNCHES.values()) == 0
