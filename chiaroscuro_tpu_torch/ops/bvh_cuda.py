"""The threaded-BVH walks B1/B2: CUDA kernels and their wrappers.

- B1 ``closest_bvh`` replaces ``chiaroscuro_tpu/accel/bvh.py::bvh_closest``
  (a ``lax.while_loop`` over the ray wavefront): the closest hit of each
  (R, 3) ray row, the least (t, original id) (``accel/bvh.py``).
- B2 ``any_bvh`` replaces ``::bvh_any``: occluded iff some triangle whose
  original id is not the ray's exclude id hits at t < tmax.

The kernels live in ``csrc/bvh_traverse.cu`` (its header says what bounds
them and how the design answers it): persistent warps whose lanes take new
rays from a per-stream device counter as their walks end, and run the
leaves they hold together.  Their plain versions are the lock-step loops
:func:`~chiaroscuro_tpu_torch.accel.bvh.bvh_closest` /
:func:`~chiaroscuro_tpu_torch.accel.bvh.bvh_any`.  Each wrapper takes the
plain version only for CPU tensors; for CUDA tensors it launches its kernel
or raises.  ``LAUNCHES`` counts kernel launches.  Inside
``utils/profiling.counting()`` each launch (each plain walk on the CPU)
runs with counts and records its rays, steps and leaf tests there.  The
kernels read the packed tables that ``build_bvh`` makes, ``BVHArrays.nodes``
and ``.tris``.
The walk is a discrete search over detached geometry: the wrappers take no
gradient (``accel/bvh.py``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from chiaroscuro_tpu_torch.accel.bvh import BVHArrays, bvh_any, bvh_closest, step_limit
from chiaroscuro_tpu_torch.ops.cuda_build import bind, check_launch
from chiaroscuro_tpu_torch.ops.intersect_cuda import _check
from chiaroscuro_tpu_torch.utils.profiling import walk_counts

# Kernel launch counts, by kernel.  Incremented only where a wrapper
# launches its kernel; the plain versions never count.
LAUNCHES = {"bvh_closest": 0, "bvh_any": 0}


@functools.cache
def build() -> tuple:
    """Build (once per source and flag set) and load the kernel library
    (``ops/cuda_build.py``).  Returns ``(lib, info)``; a failed build
    raises with nvcc's output."""
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    return bind("bvh_traverse", {
        "bvh_closest_launch": [vp] * 6 + [ci, cl] + [vp] * 8,
        "bvh_any_launch": [vp] * 8 + [ci, cl] + [vp] * 4,
    })


def _prepare(bvh, origins, dirs, counts):
    """Checks shared by the wrappers; returns (lib, R, steps, tests) for
    a launch."""
    device = origins.device
    R = origins.shape[0]
    _check("origins", origins, (R, 3), torch.float32, device)
    _check("dirs", dirs, (R, 3), torch.float32, device)
    if bvh.device != device:
        raise ValueError(f"the BVH is on {bvh.device}, the rays on {device}")
    _check("nodes", bvh.nodes, (bvh.n_nodes, 8), torch.float32, device)
    _check("tris", bvh.tris, (bvh.tri_order.shape[0], 12), torch.float32, device)
    if bvh.nodes.data_ptr() % 16 or bvh.tris.data_ptr() % 16:
        raise ValueError("the BVH tables must be 16-byte aligned")
    steps = tests = None
    if counts:
        steps = torch.empty((R,), dtype=torch.int32, device=device)
        tests = torch.empty((R,), dtype=torch.int32, device=device)
    lib, _ = build()
    return lib, R, steps, tests


def _ptr(x):
    return 0 if x is None else x.data_ptr()


def _tables(bvh):
    """The BVH's four tables, as launch arguments."""
    return (bvh.nodes.data_ptr(), bvh.leaf_start.data_ptr(), bvh.tris.data_ptr(),
            bvh.tri_order.data_ptr())


def _counted(kernel, out, counts, sink):
    """A walk's outputs ``out``, which end in their (steps, tests) where
    ``counts`` or ``sink`` asked for them: inside an open ``counting()``
    (``sink``) one entry is recorded, where the walk had rays; the counts
    are handed back only where the caller asked (``counts``)."""
    if sink is None:
        return out
    *res, (steps, tests) = out
    if steps.numel():
        sink.append({"kernel": kernel, "rays": steps.numel(), "steps": int(steps.sum()),
                     "tests": int(tests.sum())})
    if counts:
        return out
    return res[0] if kernel == "bvh_any" else tuple(res)


def closest_bvh(bvh: BVHArrays, origins, dirs, counts: bool = False):
    """B1: (hit, t, tid, u, v) of (R, 3) f32 ray rows, t = inf on a miss;
    with ``counts`` also each ray's (steps, leaf triangle tests).  The
    kernel for CUDA tensors (no launch for R = 0), the plain walk for CPU
    tensors."""
    sink = walk_counts()
    out = _closest(bvh, origins, dirs, counts or sink is not None)
    return _counted("bvh_closest", out, counts, sink)


def _closest(bvh, origins, dirs, counts):
    origins, dirs = origins.detach().contiguous(), dirs.detach().contiguous()
    if origins.device.type == "cpu":
        return bvh_closest(bvh, origins, dirs, counts=counts)
    if origins.device.type != "cuda":
        raise ValueError(f"unsupported device {origins.device}")
    lib, R, steps, tests = _prepare(bvh, origins, dirs, counts)
    dev = origins.device
    hit = torch.empty((R,), dtype=torch.bool, device=dev)
    t = torch.empty((R,), dtype=torch.float32, device=dev)
    tid = torch.empty((R,), dtype=torch.int32, device=dev)
    u = torch.empty((R,), dtype=torch.float32, device=dev)
    v = torch.empty((R,), dtype=torch.float32, device=dev)
    if R > 0:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.bvh_closest_launch(
                *_tables(bvh), origins.data_ptr(), dirs.data_ptr(), R, step_limit(bvh),
                hit.data_ptr(), t.data_ptr(), tid.data_ptr(), u.data_ptr(), v.data_ptr(),
                _ptr(steps), _ptr(tests), stream,
            )
        check_launch(lib, err, "bvh_closest")
        LAUNCHES["bvh_closest"] += 1
    out = (hit, t, tid, u, v)
    return out + ((steps, tests),) if counts else out


def any_bvh(bvh: BVHArrays, origins, dirs, tmax, exclude_id, counts: bool = False):
    """B2: (R,) bool occlusion of (R, 3) f32 ray rows by a triangle whose
    original id is not ``exclude_id`` (R,) int, at t < ``tmax`` (R,) f32;
    with ``counts`` ``(occluded, (steps, tests))``.  The kernel for CUDA
    tensors (no launch for R = 0), the plain walk for CPU tensors."""
    sink = walk_counts()
    out = _any(bvh, origins, dirs, tmax, exclude_id, counts or sink is not None)
    return _counted("bvh_any", out, counts, sink)


def _any(bvh, origins, dirs, tmax, exclude_id, counts):
    origins, dirs = origins.detach().contiguous(), dirs.detach().contiguous()
    tmax = tmax.detach()
    if origins.device.type == "cpu":
        return bvh_any(bvh, origins, dirs, tmax, exclude_id, counts=counts)
    if origins.device.type != "cuda":
        raise ValueError(f"unsupported device {origins.device}")
    lib, R, steps, tests = _prepare(bvh, origins, dirs, counts)
    dev = origins.device
    tmax = tmax.contiguous()
    excl = exclude_id.to(torch.int32).contiguous()
    _check("tmax", tmax, (R,), torch.float32, dev)
    _check("exclude_id", excl, (R,), torch.int32, dev)
    occ = torch.empty((R,), dtype=torch.bool, device=dev)
    if R > 0:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.bvh_any_launch(
                *_tables(bvh), origins.data_ptr(), dirs.data_ptr(), tmax.data_ptr(),
                excl.data_ptr(), R, step_limit(bvh), occ.data_ptr(), _ptr(steps),
                _ptr(tests), stream,
            )
        check_launch(lib, err, "bvh_any")
        LAUNCHES["bvh_any"] += 1
    return (occ, (steps, tests)) if counts else occ
