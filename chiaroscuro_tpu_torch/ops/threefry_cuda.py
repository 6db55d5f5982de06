"""The sample streams' Threefry-2x32 on the card: the kernels of
``csrc/threefry.cu`` (its header says what bounds them and what the design
does about it), one a call site of ``sampling/prng.py``.

:func:`bounce_uniforms` is ``prng.bounce_uniforms_plain`` and
:func:`raygen` is ``prng.raygen_streams_plain``, bit for bit.  Both take
CUDA tensors only and raise on anything else: ``prng`` routes CPU tensors
to the plain versions.  ``LAUNCHES`` counts the launches issued; like every
kernel count of the port it does not advance when a captured CUDA graph
replays them.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from chiaroscuro_tpu_torch.ops.cuda_build import bind, check_launch

LAUNCHES = {"threefry_bounce": 0, "threefry_raygen": 0}

_M32 = 0xFFFFFFFF


def _check_words(name, x, device=None, shape=None):
    """Raise unless ``x`` is a contiguous int64 CUDA tensor (on ``device``
    and of ``shape`` where given)."""
    if not isinstance(x, torch.Tensor) or x.device.type != "cuda":
        where = x.device if isinstance(x, torch.Tensor) else type(x).__name__
        raise ValueError(f"{name} must be a CUDA tensor, got {where}")
    if device is not None and x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != torch.int64:
        raise ValueError(f"{name} has dtype {x.dtype}, expected torch.int64")
    if shape is not None and tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def bounce_uniforms(k0, k1, bounce: int, dims: int):
    """(dims, *B) f32 uniforms of path vertex ``bounce`` for the keys
    ``(k0, k1)``: int64 CUDA tensors of one shape B, contiguous, holding
    uint32 words (their low 32 bits are read).  ``dims`` is
    ``prng.N_BOUNCE_DIMS``; the launch raises unless the kernel writes as
    many."""
    _check_words("k0", k0)
    _check_words("k1", k1, k0.device, k0.shape)
    lib, _ = build()
    out = torch.empty((dims,) + tuple(k0.shape), dtype=torch.float32, device=k0.device)
    if k0.numel() == 0:
        return out
    with torch.cuda.device(k0.device):
        stream = torch.cuda.current_stream(k0.device).cuda_stream
        err = lib.threefry_bounce_launch(k0.data_ptr(), k1.data_ptr(), k0.numel(),
                                         int(bounce) & _M32, dims, out.data_ptr(), stream)
    check_launch(lib, err, "threefry_bounce")
    LAUNCHES["threefry_bounce"] += 1
    return out


def raygen(seed: int, pixel_idx, sample_idx):
    """(k0, k1, jx, jy) for each pixel of ``pixel_idx`` (int64 CUDA tensor,
    contiguous): the sample's key as int64 words and its jitter as f32, each
    shaped like ``pixel_idx``.  ``sample_idx`` is a Python int (a launch
    argument) or an int64 tensor on the same device, 0-dim or shaped like
    ``pixel_idx``, read by the kernel from device memory."""
    _check_words("pixel_idx", pixel_idx)
    device, shape = pixel_idx.device, pixel_idx.shape
    if isinstance(sample_idx, torch.Tensor):
        _check_words("sample_idx", sample_idx, device,
                     shape if sample_idx.dim() else ())
        sample, stride, word = sample_idx.data_ptr(), int(sample_idx.dim() > 0), 0
    else:
        sample, stride, word = None, 0, int(sample_idx) & _M32
    lib, _ = build()
    k0, k1 = (torch.empty(shape, dtype=torch.int64, device=device) for _ in range(2))
    jx, jy = (torch.empty(shape, dtype=torch.float32, device=device) for _ in range(2))
    if pixel_idx.numel() == 0:
        return k0, k1, jx, jy
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.threefry_raygen_launch(
            int(seed) & _M32, pixel_idx.data_ptr(), sample, stride, word,
            pixel_idx.numel(), k0.data_ptr(), k1.data_ptr(), jx.data_ptr(),
            jy.data_ptr(), stream)
    check_launch(lib, err, "threefry_raygen")
    LAUNCHES["threefry_raygen"] += 1
    return k0, k1, jx, jy


@functools.cache
def build() -> tuple:
    """Build and load ``csrc/threefry.cu`` (``ops/cuda_build.py``);
    returns ``(lib, info)``."""
    vp, cl, cu = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint
    return bind("threefry", {
        "threefry_bounce_launch": [vp, vp, cl, cu, ctypes.c_int, vp, vp],
        "threefry_raygen_launch": [cu, vp, vp, cl, cu, cl] + [vp] * 5,
    })
