"""The frozen walk replay counts each lane's tests as a direct walk of its
own list does, and the bound arithmetic is the smoke's."""

import dataclasses

import numpy as np
import torch

from benchmarks.metrics import bounds, visit_replay
from benchmarks.scenes import atrium
from chiaroscuro_tpu_torch.ops import cluster_cuda
from chiaroscuro_tpu_torch.scene.obj_loader import Mesh as PortMesh
from chiaroscuro_tpu_torch.scene.scene_arrays import build_scene_tensors

BIG = visit_replay.BIG


def _wavefront():
    meshes = atrium.atrium(2_200)
    paths = sorted({m.texture_diffuse for m in meshes if m.texture_diffuse})
    scene = build_scene_tensors(
        [PortMesh(**{f.name: getattr(m, f.name) for f in dataclasses.fields(m)}) for m in meshes],
        {p: atrium.proc_texture(p) for p in paths}, device="cpu")
    closest_fn, any_fn = cluster_cuda.make_cluster_intersectors(scene, M=32, Lmax=6)
    g = torch.Generator().manual_seed(11)
    B0 = 3
    wmin, wmax = scene.world_min, scene.world_max
    o3 = (wmin[:, None, None] + (wmax - wmin)[:, None, None]
          * torch.rand((3, B0, 128), generator=g)).contiguous()
    d3 = torch.randn((3, B0, 128), generator=g).contiguous()
    tmax = (torch.rand((B0, 128), generator=g) * 6.0).contiguous()
    excl = torch.randint(0, scene.n_tris, (B0, 128), generator=g, dtype=torch.int32)
    with visit_replay.recording() as calls:
        closest_fn.planar_fn(o3, d3)
        any_fn.planar_fn(o3, d3, tmax, excl)
    return calls


def _direct(call, b, lane):
    """One lane's tests, walking its row's list by hand."""
    meta, ids, nears, cutoff = (x[b] for x in call["lists"])
    packed = call["packed"]
    K, _, M = packed.shape
    o = [float(call["o3"][a, b, lane]) for a in range(3)]
    d = [float(call["d3"][a, b, lane]) for a in range(3)]
    closest = call["closest"]
    tmax = None if closest else float(call["tmax"][b, lane])
    excl = None if closest else int(call["excl"][b, lane])
    best, done, tests = BIG, False, 0

    def visit(c):
        nonlocal best, done, tests
        blk = packed[c]
        ok, t, _, _ = visit_replay.mt_core(
            tuple(torch.tensor([[x]]) for x in o), tuple(torch.tensor([[x]]) for x in d),
            tuple(blk[r][:, None] for r in range(0, 3)), tuple(blk[r][:, None] for r in range(3, 6)),
            tuple(blk[r][:, None] for r in range(6, 9)))
        ok, t = ok[:, 0].tolist(), t[:, 0].tolist()
        oid = blk[9].contiguous().view(torch.int32).tolist()
        if closest:
            tests += M
            best = min([best] + [tt for k, tt in zip(ok, t) if k and tt < BIG])
            return
        for j in range(M):
            tests += 1
            if ok[j] and t[j] < tmax and oid[j] != excl:
                done = True
                return

    def wants(bound):
        return best >= bound if closest else (not done and tmax >= bound)

    pos, trip = 0, int(meta[0])
    while pos < trip and wants(float(nears[pos])):
        visit(int(ids[pos]))
        pos += 1
    c = 0
    while c < K and wants(float(cutoff[0])):
        visit(c)
        c += 1
    return tests


def test_lane_counts_equal_a_direct_walk():
    calls = _wavefront()
    assert [c["closest"] for c in calls] == [True, False]
    overflow = False
    for call in calls:
        _, tests = visit_replay.lane_walk(*call["lists"], call["o3"], call["d3"], call["packed"],
                                          call.get("tmax"), call.get("excl"))
        overflow |= bool(call["lists"][0][:, 1].any())
        for b in range(tests.shape[0]):
            for lane in range(0, 128, 5):
                assert int(tests[b, lane]) == _direct(call, b, lane), (call["closest"], b, lane)
    assert overflow, "the wavefront should reach the overflow sweep"


def test_bound_arithmetic():
    assert bounds.bound_s(33.5e12, 0) == 1.0
    assert bounds.bound_s(0, 3.35e12) == 1.0
    # closest: rays 24 + 144 a lane, lists, blocks, hit rows
    assert bounds.visit_bytes(2, 32, 10, 2, 7, 4, True, 3) == \
        256 * 24 + 2 * 12 + 7 * 8 + 4 * 10 * 32 * 4 + 3 * 128 + 256 * 144
    assert bounds.visit_bytes(2, 32, 3, 2, 7, 4, False, 0) == \
        256 * 24 + 2 * 12 + 7 * 8 + 3 * 10 * 32 * 4 + 256 * 9
    assert np.isclose(bounds.MT_OPS * 1e9 / bounds.PEAK_FP32_UNFUSED, 54e9 / 33.5e12)


def _rank_trace(nccl_ms, units, other_ms=1.0):
    from benchmarks.harness import trace

    ops, t = [], 0.0
    for d in nccl_ms:
        ops.append(trace.DeviceOp("render_kernel", t, other_ms * 1e3, "kernel", False))
        t += other_ms * 1e3
        ops.append(trace.DeviceOp("ncclDevKernel_AllGather_RING_LL", t, d * 1e3, "kernel", False))
        t += d * 1e3
    return trace.Trace(ops, (0.0, t), [], [], units)


def test_collective_reads_the_last_arrival():
    """Per pass, the rank that arrives last waits for no one: the reading is
    the least NCCL time over the ranks, pass by pass, averaged."""
    from benchmarks.harness import spec

    read = spec.metric_readers(["collective_ms.frame"])["collective_ms.frame"].read
    ranks = [_rank_trace([5.0, 0.5, 9.0], 3), _rank_trace([0.4, 7.0, 0.6], 3),
             _rank_trace([3.0, 4.0, 8.0], 3)]
    assert abs(read({"rank_traces": ranks}) - (0.4 + 0.5 + 0.6) / 3) < 1e-9
    # kernels that do not split a pass alike: each rank's time a pass, least
    uneven = [_rank_trace([1.0, 2.0], 3), _rank_trace([0.3, 0.3, 0.3], 3)]
    assert abs(read({"rank_traces": uneven}) - 0.3) < 1e-9
    assert read({"rank_traces": [_rank_trace([], 3), ranks[1]]}) is None
    assert read({"trace": ranks[0]}) is None
