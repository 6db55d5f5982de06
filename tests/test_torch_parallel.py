"""The port's tile-sharded rendering and gradient all-reduce on the CPU,
with gloo ranks: tests/test_parallel.py ported case by case, and the port
held against the JAX package's ``parallel/`` on its virtual CPU devices.

The port's ranks are real processes (``parallel/scaling.run_ranks``: one
``torch.multiprocessing`` spawn a world size, a ``file://`` store in a
temporary directory).  Each rank builds the scene from its spec
(``builtin:cornell_box``); the port's builtin Cornell box equals the JAX
package's field for field (tests/test_torch_scene.py).  The frame is
Cornell 16x8, k 2, 2 spp at ``CORNELL_CAMERA``, off the walls' planes
(ROADMAP section 3, "Ties at t = 0").

Bounds, each with its reason:

- N ranks against 1 rank: frames bitwise (the counter PRNG keys every
  sample on its global pixel id, and every intersector answers each ray
  exactly whatever rows it shares); loss rtol 1e-6, gradients rtol 1e-5
  with atol 1e-8 (test_parallel.py's bounds: only the order of the float
  sums differs).
- Port against JAX: frames within the render bound (ROADMAP section 3:
  mean |d| <= 1e-4 x mean radiance, at most 0.5% of pixels outside rtol
  1e-3); the loss to rtol 1e-5 and each gradient to relative L1 1e-5 (the
  gradient bound there): XLA contracts products into FMAs on the CPU and
  torch rounds each op.
"""

import contextlib
import dataclasses
import io
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from chiaroscuro_tpu.accel import make_intersectors as jax_make_intersectors
from chiaroscuro_tpu.ops.cluster_pallas import (
    make_cluster_intersectors as jax_make_cluster_intersectors,
)
from chiaroscuro_tpu.ops.intersect_pallas import make_pallas_intersectors
from chiaroscuro_tpu.parallel import sharding as jax_sharding
from chiaroscuro_tpu.render.image_io import read_exr as jax_read_exr
from chiaroscuro_tpu.scene.builtin import cornell_box as jax_cornell_box
from chiaroscuro_tpu.scene.scene_arrays import build_scene_arrays
from chiaroscuro_tpu_torch import entry
from chiaroscuro_tpu_torch.accel.clusters import build_clusters
from chiaroscuro_tpu_torch.accel.dispatch import make_intersectors
from chiaroscuro_tpu_torch.parallel import multihost, scaling
from chiaroscuro_tpu_torch.parallel.sharding import (
    _pixel_grid,
    make_tile_mesh,
    render_frame_sharded,
    sharded_value_and_grad,
)
from chiaroscuro_tpu_torch.render.image_io import read_exr
from chiaroscuro_tpu_torch.render.renderer import render_image
from chiaroscuro_tpu_torch.scene.builtin import CORNELL_CAMERA as CAM
from chiaroscuro_tpu_torch.scene.config import RenderConfig
from chiaroscuro_tpu_torch.scene.scene_arrays import load_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INTERSECTORS = ("brute", "dense", "cluster", "bvh")
CLUSTER_M = 32          # Cornell's 36 triangles in two clusters
GRAD_FIELDS = ("kd", "ke")


def _cfg(intersector="brute", seed=0):
    return RenderConfig(
        obj_path="builtin:cornell_box", xres=16, yres=8, samples=2, k=2, seed=seed,
        intersector=intersector, vp=CAM["eye"], la=CAM["center"], up=CAM["up"],
        yview=CAM["yview"], use_preview=False, platform="cpu",
    )


FRAME_JOBS = [scaling.RankJob(_cfg(name), cluster_size=CLUSTER_M) for name in INTERSECTORS]
GRAD_JOB = scaling.RankJob(_cfg(), fields=GRAD_FIELDS)


def assert_render_close(img, ref, mean_rel=1e-4, outlier_share=0.005):
    """The render bound (ROADMAP section 3)."""
    assert img.shape == ref.shape and np.isfinite(img).all()
    assert np.abs(img - ref).mean() <= mean_rel * ref.mean()
    outside = ~np.isclose(img, ref, rtol=1e-3, atol=0.0).all(axis=-1)
    assert outside.mean() <= outlier_share, outside.mean()


def rel_l1(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).sum() / max(np.abs(ref).sum(), 1e-30)


@pytest.fixture(scope="module")
def scene():
    return load_scene(_cfg(), "cpu")


@pytest.fixture(scope="module")
def ranks():
    """{world size: per rank, one result a job}: the four frames at 2 and 4
    ranks, and the (kd, ke) gradient step at 2, one spawn a world size."""
    return {2: scaling.run_ranks(2, FRAME_JOBS + [GRAD_JOB], device="cpu"),
            4: scaling.run_ranks(4, FRAME_JOBS, device="cpu")}


def _pair(scene, name):
    clusters = None
    if name == "cluster":
        clusters = build_clusters(*(getattr(scene, f).numpy()
                                    for f in ("tri_v0", "tri_v1", "tri_v2")), CLUSTER_M)
    return make_intersectors(scene, name, clusters=clusters)


@pytest.fixture(scope="module")
def jax_frames(cpu_devices):
    """JAX's render_frame_sharded on 2 virtual devices through its brute
    oracle, interpreted Pallas (dense, and cluster at M = 32) and its BVH."""
    sa = build_scene_arrays(jax_cornell_box())
    pairs = {
        "brute": jax_make_intersectors(sa, "brute"),
        "dense": make_pallas_intersectors(sa, interpret=True),
        "cluster": jax_make_cluster_intersectors(sa, M=CLUSTER_M, interpret=True),
        "bvh": jax_make_intersectors(sa, "bvh"),
    }
    mesh = jax_sharding.make_tile_mesh(cpu_devices[:2])
    cfg = _cfg()
    out = {}
    for name, (cf, af) in pairs.items():
        def frame(sa, cf=cf, af=af):
            return jax_sharding.render_frame_sharded(
                sa, mesh, jnp.asarray(CAM["eye"], jnp.float32),
                jnp.asarray(CAM["center"], jnp.float32), jnp.asarray(CAM["up"], jnp.float32),
                jnp.float32(CAM["yview"]), cfg.xres, cfg.yres, cfg.samples, jnp.uint32(0),
                cfg.k, jnp.zeros(3, jnp.float32), cf, af)

        # Under jit, as a TPU run composes shard_map (and in half the time).
        out[name] = np.asarray(jax.jit(frame)(sa))
    return out


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", INTERSECTORS)
def test_sharded_render_bitwise_matches_single(name, world, ranks, scene):
    """test_parallel.py:38 (brute), :125 (dense) and :151 (cluster), and the
    BVH: every rank's gathered frame equals the port's own 1-rank frame."""
    single = render_image(scene, _cfg(name), intersectors=_pair(scene, name))
    for rank in ranks[world]:
        np.testing.assert_array_equal(
            rank[INTERSECTORS.index(name)]["frame"].numpy(), single.numpy())
    # On CPU tensors the wrappers take the kernels' plain versions.
    assert not any(ranks[world][0][INTERSECTORS.index(name)]["launches"].values())


@pytest.mark.parametrize("name", INTERSECTORS)
def test_sharded_render_matches_jax(name, ranks, jax_frames):
    """The 2-rank frame against JAX's 2-device frame (same intersector)."""
    img = ranks[2][0][INTERSECTORS.index(name)]["frame"].numpy()
    ref = jax_frames[name]
    assert ref.max() > 0.1 and (ref > 1e-3).mean() > 0.05
    assert_render_close(img, ref)


def test_cluster_ranks_take_the_resident_route(ranks):
    assert ranks[2][0][INTERSECTORS.index("cluster")]["route"] == "resident"


def _render_kwargs(cfg):
    return dict(eye=cfg.vp, center=cfg.la, up=cfg.up, yview=cfg.yview, xres=cfg.xres,
                yres=cfg.yres, sample_start=0, n_samples=cfg.samples, seed=cfg.seed,
                depth=cfg.k, background=cfg.background)


def test_sharded_gradients_allreduce(ranks, scene, cpu_devices):
    """test_parallel.py:60: the 2-rank (kd, ke) loss and gradients equal the
    1-rank step's, and JAX's psum step on 8 virtual devices."""
    cfg = _cfg()
    px, py = _pixel_grid(cfg.xres, cfg.yres)
    run = sharded_value_and_grad(scaling.mean_square, GRAD_FIELDS)(
        make_tile_mesh(device="cpu"), dict(_render_kwargs(cfg), intersector="brute"))
    loss1, grads1 = run(scene, px, py)
    loss1, grads1 = float(loss1), {k: g.numpy() for k, g in grads1.items()}

    for rank in ranks[2]:
        got = rank[-1]
        np.testing.assert_allclose(float(got["loss"]), loss1, rtol=1e-6)
        for k in GRAD_FIELDS:
            np.testing.assert_allclose(got["grads"][k].numpy(), grads1[k], rtol=1e-5,
                                       atol=1e-8)
    assert np.abs(grads1["ke"]).sum() > 0 and np.abs(grads1["kd"]).sum() > 0

    sa = build_scene_arrays(jax_cornell_box())
    cf, af = jax_make_intersectors(sa, "brute")
    jmesh = jax_sharding.make_tile_mesh(cpu_devices[:8])
    jax_run = jax_sharding.sharded_value_and_grad(
        lambda img: jnp.mean(img * img), GRAD_FIELDS)(jmesh, dict(
            eye=jnp.asarray(CAM["eye"], jnp.float32),
            center=jnp.asarray(CAM["center"], jnp.float32),
            up=jnp.asarray(CAM["up"], jnp.float32), yview=jnp.float32(CAM["yview"]),
            xres=cfg.xres, yres=cfg.yres, sample_start=jnp.int32(0), n_samples=cfg.samples,
            seed=jnp.uint32(0), depth=cfg.k, background=jnp.zeros(3, jnp.float32),
            closest_fn=cf, any_fn=af))
    jloss, jgrads = jax.jit(jax_run)(sa, jnp.asarray(px), jnp.asarray(py))
    np.testing.assert_allclose(loss1, float(jloss), rtol=1e-5)
    for k in GRAD_FIELDS:
        assert rel_l1(grads1[k], jgrads[k]) <= 1e-5, (k, rel_l1(grads1[k], jgrads[k]))


def test_seed_changes_image(scene):
    """test_parallel.py:118, through render_frame_sharded on a 1-rank mesh."""
    mesh = make_tile_mesh(device="cpu")
    cf, af = make_intersectors(scene, "brute")
    frames = []
    for seed in (0, 123):
        cfg = _cfg(seed=seed)
        frames.append(render_frame_sharded(
            scene, mesh, cfg.vp, cfg.la, cfg.up, cfg.yview, cfg.xres, cfg.yres,
            cfg.samples, cfg.seed, cfg.k, cfg.background, cf, af).numpy())
    assert frames[0].shape == (8, 16, 3)
    assert not np.array_equal(frames[0], frames[1])


def test_indivisible_grid_raises(scene):
    mesh = dataclasses.replace(make_tile_mesh(device="cpu"), size=3)
    cf, af = make_intersectors(scene, "brute")
    cfg = _cfg()
    with pytest.raises(ValueError, match="not divisible by 3 ranks"):
        render_frame_sharded(scene, mesh, cfg.vp, cfg.la, cfg.up, cfg.yview, cfg.xres,
                             cfg.yres, 1, 0, 1, cfg.background, cf, af)


def test_scaling_sweep_harness():
    """test_parallel.py:173: every world size measured, positive timings,
    bitwise shard-invariant frames, and the shared-device caveat."""
    report = scaling.measure_scaling(
        "builtin:cornell_box", CAM["eye"], CAM["center"], CAM["up"], CAM["yview"],
        xres=16, yres=8, n_samples=2, depth=2, world_sizes=(1, 2), device="cpu",
        intersector="brute", iters=1,
    )
    assert report["counts"] == [1, 2]
    assert all(t > 0 for t in report["ms"])
    assert report["bitwise_equal"]
    assert report["efficiency"][0] == 1.0
    assert report["platform"] == "cpu" and len(report["launches"][1]) == 2
    text = scaling.format_report(report)
    assert "2 rank(s)" in text and "shard-invariance (bitwise): OK" in text
    assert "2 ranks on one CPU: harness and sharding semantics, not a scaling efficiency" in text


def test_entry_points_without_a_card_raise():
    """Without a card every entry point raises unless asked for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_tile_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.global_tile_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        scaling.run_ranks(1, [GRAD_JOB])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.entry()
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        multihost.initialize(num_processes=2, process_id=0,
                             coordinator_address="localhost:1234")


def test_multihost_initialize_single_process_noop(monkeypatch):
    """test_parallel.py:196: no init at one process or when a group exists;
    other errors propagate."""

    def boom(**kw):
        raise AssertionError("init_process_group must not be called")

    monkeypatch.setattr(dist, "init_process_group", boom)
    multihost.initialize(num_processes=1)
    multihost.initialize(num_processes=0)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    multihost.initialize(num_processes=2, process_id=0,
                         coordinator_address="localhost:1234", backend="gloo")
    monkeypatch.setattr(dist, "is_initialized", lambda: False)

    def refused(**kw):
        raise RuntimeError("connection refused")

    monkeypatch.setattr(dist, "init_process_group", refused)
    with pytest.raises(RuntimeError, match="connection refused"):
        multihost.initialize(num_processes=2, process_id=0,
                             coordinator_address="localhost:1234", backend="gloo")


def test_multihost_initialize_rendezvous(monkeypatch):
    """A host:port address becomes tcp://, a scheme is kept, no address is
    torchrun's env://; the backend is the one named."""
    calls = []
    monkeypatch.setattr(dist, "init_process_group", lambda **kw: calls.append(kw))
    multihost.initialize("localhost:1234", 2, 1, backend="gloo")
    multihost.initialize("file:///tmp/store", 2, 0, backend="gloo")
    multihost.initialize(backend="gloo")
    assert calls == [
        dict(backend="gloo", init_method="tcp://localhost:1234", world_size=2, rank=1),
        dict(backend="gloo", init_method="file:///tmp/store", world_size=2, rank=0),
        dict(backend="gloo", init_method="env://", world_size=-1, rank=-1),
    ]


def test_multihost_global_tile_mesh():
    """test_parallel.py:226."""
    mesh = multihost.global_tile_mesh(device="cpu")
    assert mesh.axis_names == ("tile",)
    assert (mesh.rank, mesh.size, mesh.group) == (0, 1, None)
    assert mesh.device == torch.device("cpu")
    assert multihost.global_tile_mesh("px", device="cpu").axis_names == ("px",)


def test_multihost_export_on_process_zero(tmp_path, monkeypatch):
    """test_parallel.py:235: process 0 writes an EXR that the JAX reader
    decodes; another rank writes nothing."""
    img = torch.full((4, 4, 3), 0.25)
    p0 = tmp_path / "p0.exr"
    assert multihost.is_process_zero()
    multihost.export_on_process_zero(str(p0), img)
    np.testing.assert_allclose(jax_read_exr(str(p0)), img.numpy(), atol=1e-6)

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 3)
    p1 = tmp_path / "p1.exr"
    assert not multihost.is_process_zero()
    multihost.export_on_process_zero(str(p1), img)
    assert not p1.exists()


def test_dryrun_multichip_matches_jax(monkeypatch, cpu_devices):
    """dryrun_multichip(2) on two gloo CPU ranks against the JAX dry run on
    2 virtual devices (``__graft_entry__.py:66``): loss and |grad kd|, and
    each of the five gradients, to the bounds in the module docstring.  The
    port runs the dense pair's plain versions, JAX its brute oracle."""
    import __graft_entry__

    captured = {}
    real_jit = jax.jit

    def spy(f, *a, **kw):
        jitted = real_jit(f, *a, **kw)

        def call(*args):
            captured["out"] = jitted(*args)
            return captured["out"]

        return call

    monkeypatch.setattr(jax, "jit", spy)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        __graft_entry__.dryrun_multichip(2)
    monkeypatch.undo()
    jloss, jgrads = captured["out"]
    assert "dryrun_multichip(2): loss=" in out.getvalue()

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        loss, grads = entry.dryrun_multichip(2, device="cpu")
    line = [x for x in out.getvalue().splitlines() if x.startswith("dryrun_multichip")]
    assert line == [f"dryrun_multichip(2): loss={loss:.6f}, "
                    f"|grad kd|={float(grads['kd'].abs().sum()):.6f} — OK"]
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(grads["kd"].abs().sum()),
                               float(jnp.abs(jgrads["kd"]).sum()), rtol=1e-5)
    assert set(grads) == set(entry.DRYRUN_FIELDS)
    for k in entry.DRYRUN_FIELDS:
        assert rel_l1(grads[k].numpy(), jgrads[k]) <= 1e-5, (k, rel_l1(grads[k].numpy(),
                                                                        jgrads[k]))


def test_entry_forward_step():
    """entry(): the 64x64 forward step, equal to render_image of the same
    config and pair."""
    fn, args = entry.entry(device="cpu")
    with torch.no_grad():
        img = fn(*args)
    scene = args[0]
    cfg = RenderConfig(obj_path="builtin:cornell_box", xres=64, yres=64, samples=2, k=3,
                       intersector="dense", vp=CAM["eye"], la=CAM["center"], up=CAM["up"],
                       yview=CAM["yview"])
    assert img.shape == (64, 64, 3) and bool(torch.isfinite(img).all())
    torch.testing.assert_close(img, render_image(scene, cfg), rtol=0, atol=0)


def _main_argv(out):
    return ["chiaroscuro_tpu_torch", "scenes/cornell.rtc", "platform", "cpu", "xres", "16",
            "yres", "8", "samples", "2", "k", "2", "output", str(out), *sum(
                (["VP", *map(str, CAM["eye"])], ["LA", *map(str, CAM["center"])],
                 ["yview", str(CAM["yview"])]), [])]


def test_multihost_main_renders_and_exports(tmp_path, scene):
    """``python -m chiaroscuro_tpu_torch.parallel.multihost`` as one process
    (no torchrun) and as two torchrun gloo ranks (``--standalone``: a
    rendezvous on a free localhost port): both export the frame the port
    renders in one process."""
    want = render_image(scene, _cfg()).numpy()
    multihost.main(_main_argv(tmp_path / "one.exr"))
    # The EXR stores HALF floats: 2^-11 relative.
    np.testing.assert_allclose(read_exr(str(tmp_path / "one.exr")), want,
                               rtol=2.0**-10, atol=1e-6)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
         "2", "-m", "chiaroscuro_tpu_torch.parallel.multihost",
         *_main_argv(tmp_path / "two.exr")[1:]],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "2 rank(s) on cpu" in proc.stdout
    np.testing.assert_array_equal(read_exr(str(tmp_path / "two.exr")),
                                  read_exr(str(tmp_path / "one.exr")))
