"""The frozen scene inputs equal the port's own generators, and the plain
reference renders what the port's CPU path renders."""

import dataclasses

import numpy as np
import pytest
import torch

from benchmarks.reference import accel, render, scene as ref_scene
from benchmarks.scenes import atrium as frozen_atrium, cornell as frozen_cornell
from chiaroscuro_tpu_torch.render.renderer import Renderer
from chiaroscuro_tpu_torch.scene import builtin, synthetic
from chiaroscuro_tpu_torch.scene.config import RenderConfig
from chiaroscuro_tpu_torch.scene.obj_loader import Mesh as PortMesh
from chiaroscuro_tpu_torch.scene.scene_arrays import build_scene_tensors


def _same_meshes(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for f in dataclasses.fields(x):
            u, v = getattr(x, f.name), getattr(y, f.name)
            if isinstance(u, np.ndarray):
                assert u.dtype == v.dtype and np.array_equal(u, v), f.name
            else:
                assert u == v, f.name


def test_atrium_equals_the_ports():
    _same_meshes(frozen_atrium.atrium(2_200), synthetic.atrium(2_200))
    for kind in ("stone", "plaster", "brick", "wood", "tile"):
        p = f"proc:{kind}:128"
        assert np.array_equal(frozen_atrium.proc_texture(p), synthetic.proc_texture(p))
    assert frozen_atrium.ATRIUM_CAMERA == synthetic.ATRIUM_CAMERA


def test_cornell_equals_the_ports():
    _same_meshes(frozen_cornell.cornell_box(), builtin.cornell_box())
    assert frozen_cornell.CORNELL_CAMERA == builtin.CORNELL_CAMERA


def _port_pixels(meshes, textures, cam, res, k, spp, passes, seed, intersector):
    pm = [PortMesh(**{f.name: getattr(m, f.name) for f in dataclasses.fields(m)}) for m in meshes]
    scene = build_scene_tensors(pm, textures, device="cpu")
    cfg = RenderConfig(obj_path="test", k=k, xres=res[0], yres=res[1], vp=cam["eye"],
                       la=cam["center"], up=cam["up"], yview=cam["yview"], samples=spp, seed=seed,
                       platform="cpu", intersector=intersector)
    r = Renderer(scene, cfg)
    for _ in range(passes):
        r.ray_trace()
    return r.pixels.reshape(-1, 3)


CASES = {
    "cornell_16": (lambda: (frozen_cornell.cornell_box(), {}), frozen_cornell.CORNELL_CAMERA,
                   (16, 16), 6, 4, 2, 2 ** 31 + 5, "auto"),
    "atrium_dense": (lambda: _atrium(), frozen_atrium.ATRIUM_CAMERA, (24, 16), 3, 1, 3,
                     123_456_789_012, "auto"),
    "atrium_cluster": (lambda: _atrium(), frozen_atrium.ATRIUM_CAMERA, (24, 16), 3, 1, 2, 7,
                       "cluster"),
}


def _atrium():
    meshes = frozen_atrium.atrium(2_200)
    paths = sorted({m.texture_diffuse for m in meshes if m.texture_diffuse})
    return meshes, {p: frozen_atrium.proc_texture(p) for p in paths}


@pytest.mark.parametrize("case", list(CASES))
def test_reference_equals_the_ports_cpu_path(case, capsys):
    make, cam, res, k, spp, passes, seed, inter = CASES[case]
    meshes, textures = make()
    got = _port_pixels(meshes, textures, cam, res, k, spp, passes, seed, inter)
    rs = ref_scene.flatten(meshes, textures, "cpu")
    lu, dx, dy = render.camera_basis(cam["eye"], cam["center"], cam["up"], cam["yview"], *res)
    samples = render.sample_radiance(rs, accel.Groups(rs), (cam["eye"], lu, dx, dy), res[0],
                                     np.arange(res[0] * res[1]), passes * spp, seed, k, (0, 0, 0))
    want = render.accumulate(samples, spp)
    assert want.mean() > 0.01
    np.testing.assert_array_equal(got, want)


def test_reference_queries_equal_brute_force():
    """The grouped walk answers as brute force does: least (t, id) hits
    and occlusion, on random rays through the atrium."""
    meshes, textures = _atrium()
    rs = ref_scene.flatten(meshes, textures, "cpu")
    groups = accel.Groups(rs, group=64)
    g = torch.Generator().manual_seed(3)
    o = rs.world_min + (rs.world_max - rs.world_min) * torch.rand((512, 3), generator=g)
    d = torch.randn((512, 3), generator=g)
    hit, t, tid, u, v = groups.closest(o, d)
    ok, tt, _, _ = accel.moller_trumbore(o[:, None], d[:, None], rs.v0[None], rs.e1[None],
                                         rs.e2[None])
    tt = torch.where(ok, tt, float("inf"))
    best = tt.amin(dim=1)
    first = torch.where(tt == best[:, None], torch.arange(rs.n_tris)[None], rs.n_tris).amin(1)
    assert torch.equal(hit, torch.isfinite(best))
    assert torch.equal(tid[hit], first[hit])
    assert torch.equal(t[hit], best[hit])
    tmax = torch.rand(512, generator=g) * 5.0
    excl = torch.randint(0, rs.n_tris, (512,), generator=g)
    occ = groups.occluded(o, d, tmax, excl)
    blocked = (ok & (tt < tmax[:, None]) & (torch.arange(rs.n_tris)[None] != excl[:, None])).any(1)
    assert torch.equal(occ, blocked)
    assert 0 < int(occ.sum()) < 512
