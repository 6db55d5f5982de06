"""chiaroscuro_tpu_torch — the path tracer of ``chiaroscuro_tpu`` ported to
PyTorch and CUDA for an NVIDIA H100.

The JAX package stays the reference; this package keeps its subpackage and
module names so each counterpart is easy to find, and its planar
``(3, B0, 128)`` ray layout at every public function.  It imports torch and
numpy, never jax or ``chiaroscuro_tpu``:

  scene/     .rtc config, OBJ/MTL ingest, builtin and synthetic scenes,
             SceneTensors
  sampling/  counter-based Threefry streams + importance samplers
  geometry/  planar vec3 math, camera rays, brute-force Moller-Trumbore oracle
  accel/     intersector dispatch, meshlet clustering
  ops/       the intersection kernels in CUDA (csrc/): the dense sweep, the
             cluster cull and the cluster visits
  render/    wavefront integrator, renderer, tone map, image I/O
  utils/     accumulation-state files, phase timing and profiling
  preview/   the interactive preview: fly camera, raster walk-through frame
  parallel/  tile-sharded rendering and gradient all-reduce on
             torch.distributed, multi-process set-up, rank sweeps
  tools/     the cull shootout and the block-fetch repro, kernel comparisons
             between checkouts
  entry.py   the forward step and the multi-rank differentiable dry run

The batch render: ``python -m chiaroscuro_tpu_torch scene.rtc no-preview``.
"""

__version__ = "0.1.0"

from chiaroscuro_tpu_torch.scene.config import RenderConfig  # noqa: E402,F401
from chiaroscuro_tpu_torch.scene.scene_arrays import SceneTensors  # noqa: E402,F401
