"""Build, load and launch the hand-written Hopper kernels of ``csrc/``.

The CUDA sources are compiled at first use with ``nvcc`` for ``sm_90a``,
one ``nvcc`` per source, all started together, and linked into one shared
library with a plain C interface, cached under
``build/videoprism_tpu_torch/`` by a hash of the sources and flags, and
loaded with ``ctypes``.  Each C entry point launches on the stream it is
given and returns ``cudaGetLastError()``; :func:`launch` raises when that is
not 0.  Nothing here runs at import: a CPU-only install imports every module
and never builds.

Dispatch rule of every kernel wrapper (:func:`use_kernel`): ``impl='auto'``
runs the kernel for a CUDA tensor and the plain PyTorch twin for a CPU
tensor; ``impl='kernel'`` on a CPU tensor raises; ``impl='reference'`` runs
the twin anywhere.  On CUDA nothing falls back: a shape or dtype the kernel
does not take raises ``ValueError``.  Under autograd (:func:`needs_grad`)
the forward wrappers run through a ``torch.autograd.Function`` whose
forward follows that rule and whose backward is PyTorch code with the
flash backward (K7) dispatched by the same rule.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[2] / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[3] / 'build' / 'videoprism_tpu_torch'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-Xcompiler', '-fPIC', '-Xptxas', '-v')
IMPLS = ('auto', 'kernel', 'reference')

# Launches per kernel wrapper: each wrapper adds one where it launches its
# kernel chain and nowhere else.
LAUNCHES: collections.Counter = collections.Counter()
# The same launches of the int8 chunked blocks (K9, K10) by chunk count:
# (wrapper, chunks) -> launches.
CHUNK_LAUNCHES: collections.Counter = collections.Counter()
# The launches of the flash backward (K7) that also emit the context.
CTX_LAUNCHES: collections.Counter = collections.Counter()
# The launches of the flash backward (K7) given K5's row statistics.
STATS_LAUNCHES: collections.Counter = collections.Counter()

# Argument codes of the C entry points: p pointer (or the stream), i int,
# f float.  The stream is appended by launch().
_SIGNATURES = {
    'vp_attention_block': 'ppppppppppppp' 'iiiiiiii' 'fff' 'p',
    'vp_ffn_block': 'pppppppppppp' 'iiiii' 'f' 'p',
    'vp_spatial_to_temporal': 'ppppp' 'iiii' 'f' 'p',
    'vp_temporal_to_output': 'pppp' 'iiii' 'f' 'p',
    'vp_layer_norm': 'pppp' 'iii' 'f' 'p',
    'vp_flash_attention': 'pppppp' 'iiiiiii' 'f' 'p',
    'vp_flash_attention_bwd': 'ppppppppppp' 'iiiiiii' 'f' 'p',
    'vp_capped_weight': 'ppp' 'i' 'f' 'p',
    'vp_int8_ffn_block': 'p' * 17 + 'iiiii' 'f' 'p',
    'vp_int8_attention_block': 'p' * 18 + 'i' * 8 + 'fff' 'p',
    'vp_int8_layer_block': 'p' * 21 + 'i' * 11 + 'fff' 'p',
    'vp_int8_qkv_projection': 'p' * 7 + 'iii' 'ff' 'p',
    'vp_int8_out_projection': 'p' * 6 + 'iii' 'p',
    'vp_gemm_bf16': 'pppppp' 'iiiiii' 'f' 'i' 'p',
    'vp_gemm_i8': 'p' * 10 + 'iiiii' 'f' 'i' 'p',
    'vp_quant_rows': 'p' * 5 + 'iiii' 'f' 'p',
    'vp_capped_attention': 'ppp' + 'i' * 6 + 'f' 'p',
    'vp_host_probe': 'p' 'ii' 'p',
}
_CTYPES = {'p': ctypes.c_void_p, 'i': ctypes.c_int, 'f': ctypes.c_float}


def reset_launches() -> None:
  LAUNCHES.clear()
  CHUNK_LAUNCHES.clear()
  CTX_LAUNCHES.clear()
  STATS_LAUNCHES.clear()


def use_kernel(impl: str, x: torch.Tensor) -> bool:
  """Whether a wrapper given ``x`` runs its kernel (see module docstring)."""
  if impl not in IMPLS:
    raise ValueError(f'impl must be one of {IMPLS}, got {impl!r}')
  if impl == 'reference':
    return False
  if x.is_cuda:
    return True
  if impl == 'kernel':
    raise ValueError(
        f"impl='kernel' needs CUDA tensors; got a tensor on {x.device}")
  return False


def needs_grad(impl: str, *tensors: torch.Tensor | None) -> bool:
  """Whether a wrapper runs through its ``torch.autograd.Function`` (the
  kernel, or on the CPU its twin, forward; the hand-written backward):
  autograd is recording and an operand requires grad.  ``impl='reference'``
  never does: autograd then differentiates the plain twin itself, an
  independent check of the hand-written backwards."""
  if impl == 'reference' or not torch.is_grad_enabled():
    return False
  for t in tensors:   # a loop, not any(generator): this runs on every call
    if t is not None and t.requires_grad:
      return True
  return False


def check(cond: bool, msg: str) -> None:
  if not cond:
    raise ValueError(msg)


def check_tensors(device: torch.device, *, int8: tuple[str, ...] = (),
                  fp32: tuple[str, ...] = ('mask',),
                  **tensors: torch.Tensor) -> None:
  """Every kernel operand: on ``device``, contiguous, 16-byte aligned, and
  bf16, or int8 / fp32 for the operands named in ``int8`` / ``fp32``
  (masks: fp32).  One test per operand; the message is built only for an
  operand that fails it."""
  index = device.index
  for name, t in tensors.items():
    want = (torch.int8 if name in int8 else
            torch.float32 if name in fp32 else torch.bfloat16)
    if (t.dtype is not want or t.get_device() != index
        or not t.is_contiguous() or t.data_ptr() % 16):
      _refuse(name, t, device, want)


def _refuse(name: str, t: torch.Tensor, device: torch.device,
            want: torch.dtype) -> None:
  check(t.device == device, f'{name} is on {t.device}, expected {device}')
  check(t.dtype == want,
        f'{name} is {t.dtype}; the kernel takes {want} (fp32 activations '
        "run only with impl='reference')")
  check(t.is_contiguous(), f'{name} must be contiguous')
  check(t.data_ptr() % 16 == 0, f'{name} must be 16-byte aligned')


@dataclasses.dataclass(frozen=True)
class Build:
  path: Path
  seconds: float   # compile time, 0.0 when the cached library was reused
  log: str         # nvcc / ptxas output (registers, shared memory, spills)


def _nvcc() -> str:
  found = shutil.which('nvcc')
  if found:
    return found
  cuda_home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
  return str(Path(cuda_home) / 'bin' / 'nvcc')


@functools.cache
def build() -> Build:
  """Compiles ``csrc/*.cu`` once per source hash; returns the library."""
  sources = sorted(CSRC.glob('*.cu'))
  digest = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
  for f in sorted(CSRC.glob('*.cu*')):
    digest.update(f.name.encode())
    digest.update(f.read_bytes())
  path = BUILD_DIR / f'libvp_kernels_{digest.hexdigest()[:16]}.so'
  log_path = path.with_suffix('.log')
  if path.exists() and log_path.exists():
    return Build(path, 0.0, log_path.read_text())
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  stem = f'{path.stem}.{os.getpid()}'
  start = time.perf_counter()
  jobs = []
  for src in sources:
    obj = BUILD_DIR / f'{stem}.{src.stem}.o'
    cmd = [_nvcc(), *NVCC_FLAGS, '-c', '-o', str(obj), str(src)]
    jobs.append((cmd, obj, subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
  logs = []
  for cmd, _, proc in jobs:
    logs.append(proc.communicate()[0])
    if proc.returncode != 0:
      for _, _, other in jobs:
        other.kill()
        other.wait()
      raise RuntimeError(
          f'nvcc failed ({proc.returncode}):\n{" ".join(cmd)}\n{logs[-1]}')
  tmp = BUILD_DIR / f'{stem}.tmp.so'
  cmd = [_nvcc(), '-shared', '-o', str(tmp), *(str(obj) for _, obj, _ in jobs)]
  proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
  for _, obj, _ in jobs:
    obj.unlink()
  if proc.returncode != 0:
    raise RuntimeError(f'nvcc link failed ({proc.returncode}):\n'
                       f'{" ".join(cmd)}\n{proc.stdout}{proc.stderr}')
  seconds = time.perf_counter() - start
  log = ''.join(logs) + proc.stdout + proc.stderr
  log_path.write_text(log)
  os.replace(tmp, path)
  return Build(path, seconds, log)


@functools.cache
def library() -> ctypes.CDLL:
  lib = ctypes.CDLL(str(build().path))
  for name, codes in _SIGNATURES.items():
    fn = getattr(lib, name)
    fn.argtypes = [_CTYPES[c] for c in codes]
    fn.restype = ctypes.c_int
  lib.vp_int8_layer_scratch.argtypes = [ctypes.c_int] * 5
  lib.vp_int8_layer_scratch.restype = ctypes.c_size_t
  lib.vp_attention_max_t.argtypes = [ctypes.c_int]
  lib.vp_attention_max_t.restype = ctypes.c_int
  lib.vp_error_string.argtypes = [ctypes.c_int]
  lib.vp_error_string.restype = ctypes.c_char_p
  return lib


@functools.cache
def max_attention_t(head_dim: int) -> int:
  """The longest sequence K1's attention core takes at ``head_dim``, 0 when
  it takes no such head dim.  The core streams K and V, so where it takes
  the head dim this is a sentinel far past the route's 1024 tokens."""
  return library().vp_attention_max_t(head_dim)


def attention_fits(t: int, head_dim: int) -> bool:
  """Whether K1's attention core takes a T-token sequence at this head
  dim."""
  return t <= max_attention_t(head_dim)


@functools.cache
def _device_queries():
  """(current device index, index -> raw handle of its current stream):
  PyTorch's own accessors where it has them (no lazy-init check, no Stream
  object per call), else the public ``torch.cuda`` calls."""
  current = getattr(torch._C, '_cuda_getDevice', torch.cuda.current_device)
  raw = getattr(torch._C, '_cuda_getCurrentRawStream', None)
  if raw is None:
    raw = lambda index: torch.cuda.current_stream(index).cuda_stream
  return current, raw


@functools.cache
def _entry(name: str):
  """(C function, argument count, positions of the pointer arguments) of
  entry point ``name``, resolved once."""
  codes = _SIGNATURES[name][:-1]
  return (getattr(library(), name), len(codes),
          tuple(i for i, c in enumerate(codes) if c == 'p'))


def launch(name: str, device: torch.device, *args) -> None:
  """Calls C entry point ``name`` on the current stream of ``device``.

  Pointer arguments are tensors (or None), read once with ``data_ptr()``;
  ints and floats go to ctypes as they are.  The device is switched only
  when it is not the current one."""
  fn, count, pointers = _entry(name)
  if len(args) != count:
    raise TypeError(f'{name} takes {count} arguments, got {len(args)}')
  args = list(args)
  for i in pointers:
    if args[i] is not None:
      args[i] = args[i].data_ptr()
  current, raw_stream = _device_queries()
  here, index = current(), device.index
  if index is None or index == here:
    err = fn(*args, raw_stream(here))
  else:
    with torch.cuda.device(index):
      err = fn(*args, raw_stream(index))
  if err != 0:
    raise RuntimeError(
        f'{name} failed to launch: {library().vp_error_string(err).decode()} '
        f'({err})')
