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
  ops/       the intersection kernels: the dense sweep and the cluster visits
             in CUDA (csrc/), the cluster cull in Triton
  render/    wavefront integrator, renderer, tone map, image I/O

The batch render: ``python -m chiaroscuro_tpu_torch scene.rtc no-preview``.
"""

__version__ = "0.1.0"
