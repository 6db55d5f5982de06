"""The port's public import surface against the JAX package's.

Every name in each JAX ``__all__`` (and the two top-level names) exists
in the port's counterpart package, under two renames: the JAX scene type
``SceneArrays`` is the port's ``SceneTensors``, and ``build_scene_arrays``
is ``build_scene_tensors``.  The row-major wrappers the JAX package
exports match its own on Cornell inputs, and importing the port's
``__init__``s builds and loads no CUDA library.

Tolerances: PRNG words and the uniforms made from them are exact; the
samplers atol 2e-6 (tests/test_torch_sampling.py); camera directions and
slab distances rtol 1e-6 (the same formulas, op for op, on float32
inputs); the row-major ``trace_paths`` the render bound of
tests/test_torch_render.py.
"""

import importlib
import os
import subprocess
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chiaroscuro_tpu.accel import make_intersectors as jax_make_intersectors
from chiaroscuro_tpu.geometry import camera as jcamera
from chiaroscuro_tpu.geometry import intersect as jintersect
from chiaroscuro_tpu.render import integrator as jintegrator
from chiaroscuro_tpu.sampling import prng as jprng
from chiaroscuro_tpu.sampling import samplers as jsamplers
from chiaroscuro_tpu.scene.builtin import cornell_box as jax_cornell_box
from chiaroscuro_tpu.scene.scene_arrays import build_scene_arrays
from chiaroscuro_tpu_torch.scene.builtin import CORNELL_CAMERA
from chiaroscuro_tpu_torch.scene.scene_arrays import (
    DATA_FIELDS,
    META_FIELDS,
    scene_tensors_from_numpy,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The JAX names the port spells differently, and nothing else.
RENAMES = {"SceneArrays": "SceneTensors", "build_scene_arrays": "build_scene_tensors"}
SUBPACKAGES = ["render", "scene", "accel", "geometry", "sampling"]


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_every_jax_export_exists_in_the_port(sub):
    jmod = importlib.import_module(f"chiaroscuro_tpu.{sub}")
    mod = importlib.import_module(f"chiaroscuro_tpu_torch.{sub}")
    missing = [n for n in jmod.__all__ if not hasattr(mod, RENAMES.get(n, n))]
    assert not missing, missing
    assert set(RENAMES.get(n, n) for n in jmod.__all__) <= set(mod.__all__)
    # The port's own functions and classes, not the JAX package's.
    own = [getattr(mod, n) for n in mod.__all__
           if isinstance(getattr(mod, n), (type, types.FunctionType))]
    assert own and all(x.__module__.startswith("chiaroscuro_tpu_torch.") for x in own)


def test_top_level_exports():
    import chiaroscuro_tpu
    import chiaroscuro_tpu_torch

    for name in ("RenderConfig", "SceneArrays"):
        assert hasattr(chiaroscuro_tpu, name)
        assert hasattr(chiaroscuro_tpu_torch, RENAMES.get(name, name)), name
    assert not hasattr(chiaroscuro_tpu_torch, "SceneArrays")
    assert not hasattr(importlib.import_module("chiaroscuro_tpu_torch.scene"),
                       "build_scene_arrays")


IMPORT_INITS = """
import sys
import chiaroscuro_tpu_torch
from chiaroscuro_tpu_torch import accel, geometry, render, sampling, scene
from chiaroscuro_tpu_torch.render import Renderer
from chiaroscuro_tpu_torch.ops import cluster_cuda, cuda_build, intersect_cuda
builds = [intersect_cuda.build, cluster_cuda.build, cluster_cuda.build_cull,
          cuda_build.build_library]
loaded = [l for l in open("/proc/self/maps") if "_build" in l and ".so" in l]
print(sum(b.cache_info().currsize for b in builds), len(loaded),
      sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "chiaroscuro_tpu")))
"""


def test_importing_the_inits_builds_nothing():
    """In a fresh interpreter (this one has imported jax): no library
    built or mapped, and neither jax nor the JAX package imported."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", IMPORT_INITS], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["0", "0", "[]"], proc.stdout


# ---------------------------------------------------------------------------
# The row-major wrappers against JAX's on Cornell inputs.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cornell():
    sa = build_scene_arrays(jax_cornell_box())
    fields = {k: np.asarray(getattr(sa, k)) for k in DATA_FIELDS}
    return sa, scene_tensors_from_numpy(fields, {k: getattr(sa, k) for k in META_FIELDS}, "cpu")


def _rays(xres=16, yres=12):
    """Pixel indices and (jittered) primary directions of a Cornell frame,
    from both packages' wrappers."""
    from chiaroscuro_tpu_torch.geometry import camera_basis, primary_ray_dirs
    from chiaroscuro_tpu_torch.sampling import aa_jitter
    from chiaroscuro_tpu_torch.sampling.prng import pixel_sample_keys

    cam = CORNELL_CAMERA
    ys, xs = np.meshgrid(np.arange(yres), np.arange(xres), indexing="ij")
    px, py = xs.reshape(-1).astype(np.int32), ys.reshape(-1).astype(np.int32)
    pix = py * xres + px
    basis = camera_basis(cam["eye"], cam["center"], cam["up"], cam["yview"], xres, yres)
    keys = pixel_sample_keys(5, torch.from_numpy(pix), 3)
    jit = aa_jitter(keys)
    dirs = primary_ray_dirs(*(torch.from_numpy(b) for b in basis), torch.from_numpy(px),
                            torch.from_numpy(py), jit[:, 0], jit[:, 1])
    jkeys = jprng.pixel_sample_keys(jnp.uint32(5), jnp.asarray(pix), jnp.int32(3))
    jjit = jprng.aa_jitter_batch(jkeys)
    jdirs = jcamera.primary_ray_dirs(*basis, jnp.asarray(px), jnp.asarray(py),
                                     jjit[:, 0], jjit[:, 1])
    return keys, jkeys, jit, jjit, dirs, jdirs


def test_prng_and_camera_wrappers_match_jax():
    from chiaroscuro_tpu_torch.sampling import bounce_uniforms, pixel_sample_key
    from chiaroscuro_tpu_torch.sampling.prng import aa_jitter_batch, bounce_uniforms_batch

    keys, jkeys, jit, jjit, dirs, jdirs = _rays()
    np.testing.assert_array_equal(keys.numpy().astype(np.uint32), np.asarray(jkeys))
    np.testing.assert_array_equal(
        pixel_sample_key(5, 7, 3).numpy().astype(np.uint32),
        np.asarray(jprng.pixel_sample_key(jnp.uint32(5), jnp.int32(7), jnp.int32(3))))
    np.testing.assert_array_equal(jit.numpy(), np.asarray(jjit))
    np.testing.assert_array_equal(aa_jitter_batch(keys).numpy(), np.asarray(jjit))
    np.testing.assert_allclose(dirs.numpy(), np.asarray(jdirs), rtol=1e-6)
    for bounce in (1, 4):
        np.testing.assert_array_equal(bounce_uniforms_batch(keys, bounce).numpy(),
                                      np.asarray(jprng.bounce_uniforms_batch(jkeys, bounce)))
        np.testing.assert_array_equal(
            bounce_uniforms(keys[7], bounce).numpy(),
            np.asarray(jprng.bounce_uniforms(jkeys[7], bounce)))


def test_sampler_and_aabb_wrappers_match_jax(cornell):
    from chiaroscuro_tpu_torch.geometry import intersect_aabb
    from chiaroscuro_tpu_torch.sampling import perpendicular, sample_wi_diffuse, tangent_frame

    sa, scene = cornell
    n = scene.normal                       # the raw, non-unit Cornell normals
    np.testing.assert_array_equal(perpendicular(n).numpy(),
                                  np.asarray(jsamplers.perpendicular(np.asarray(sa.normal))))
    for a, b in zip(tangent_frame(n), jsamplers.tangent_frame(np.asarray(sa.normal))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=2e-6)
    rng = np.random.default_rng(3)
    u, v = (rng.uniform(size=n.shape[0]).astype(np.float32) for _ in range(2))
    wi, pdf = sample_wi_diffuse(n, torch.from_numpy(u), torch.from_numpy(v))
    jwi, jpdf = jsamplers.sample_wi_diffuse(np.asarray(sa.normal), u, v)
    np.testing.assert_allclose(wi.numpy(), np.asarray(jwi), rtol=0, atol=2e-6)
    np.testing.assert_allclose(pdf.numpy(), np.asarray(jpdf), rtol=0, atol=2e-6)

    _, _, _, _, dirs, _ = _rays()
    eye = torch.tensor(CORNELL_CAMERA["eye"], dtype=torch.float32)
    o = eye.expand(dirs.shape[0], 3)
    dirs = dirs.clone()
    dirs[:4, 1] = 0.0                      # axis-parallel rays: IEEE infinities
    tmin, tmax = intersect_aabb(o, dirs, scene.world_min, scene.world_max)
    jmin, jmax = jintersect.intersect_aabb(o.numpy(), dirs.numpy(),
                                           np.asarray(sa.world_min), np.asarray(sa.world_max))
    np.testing.assert_allclose(tmin.numpy(), np.asarray(jmin), rtol=1e-6)
    np.testing.assert_allclose(tmax.numpy(), np.asarray(jmax), rtol=1e-6)
    hits = (tmax >= 0) & (tmax >= tmin)
    assert bool(hits.any()) and not bool(hits.all())      # both outcomes occur


def test_trace_paths_matches_jax(cornell):
    """The row-major ``trace_paths`` (R = 192, not a multiple of 128)
    through each package's brute oracle, under the render bound."""
    from chiaroscuro_tpu_torch.accel import make_intersectors
    from chiaroscuro_tpu_torch.render import trace_paths

    sa, scene = cornell
    keys, jkeys, _, _, dirs, jdirs = _rays()
    eye = np.asarray(CORNELL_CAMERA["eye"], np.float32)
    o = np.broadcast_to(eye, dirs.shape).copy()
    rad = trace_paths(scene, torch.from_numpy(o), dirs, keys, 3, torch.zeros(3),
                      *make_intersectors(scene, "brute")).numpy()
    ref = np.asarray(jintegrator.trace_paths(sa, jnp.asarray(o), jdirs, jkeys, 3,
                                             jnp.zeros(3), *jax_make_intersectors(sa, "brute")))
    assert rad.shape == ref.shape == (192, 3) and ref.mean() > 1e-3
    assert np.abs(rad - ref).mean() <= 1e-4 * ref.mean()
    outside = ~np.isclose(rad, ref, rtol=1e-3, atol=0.0).all(axis=-1)
    assert outside.mean() <= 0.005, outside.mean()
