"""Readings that set the limits of ``correct``; the benchmark's runs make
none of them.

    python3 benchmarks/control.py --workload <cell> --seeds 1,2,3 --passes N
    python3 benchmarks/control.py --workload <cell> --seeds 1,2,3 --fault <name>

Without ``--fault``: the control, the reference computed in bfloat16 (the
precision below the configurations' float32) put in the program's place and
compared with the float32 reference by the cell's own numbers, at the cell's
own size: for a frame cell the image after ``--passes`` passes at the seed's
checked pixels, for the gradient cell the first steps.  With ``--fault``: a
run of the cell with that fault planted in the port
(``benchmarks/harness/faults.py``), for ``--seconds`` (default 1).  Each seed
prints one JSON line of readings.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def control(cell, seed, passes, device):
    import torch

    from benchmarks.drivers import frame, grad
    from benchmarks.harness import program

    cfg, tr = cell.config, cell.traffic
    meshes, textures = program.scene_inputs(cfg)
    if tr["driver"] in ("frame", "frame_sharded"):
        pix = program.check_pixels(int(cfg["xres"]) * int(cfg["yres"]), int(tr["check_pixels"]), seed)
        want = frame.reference_image(cfg, tr, seed, device, meshes, textures, pix, passes)
        got = frame.reference_image(cfg, tr, seed, device, meshes, textures, pix, passes,
                                    dtype=torch.bfloat16)
        checks = program.image_checks(got, want, tr["limits"])
    else:
        from benchmarks.reference import scene as ref_scene

        rs = ref_scene.flatten(meshes, textures, device)
        kd0, ke0, target = grad.inputs(rs.kd, rs.ke, int(cfg["xres"]) * int(cfg["yres"]), seed,
                                       device)
        want = grad.reference_steps(cfg, tr, seed, device, meshes, textures, kd0, ke0, target)
        got = grad.reference_steps(cfg, tr, seed, device, meshes, textures, kd0, ke0, target,
                                   dtype=torch.bfloat16)
        checks = grad.step_checks(got, want, tr["limits"])
    return {c.name: c.value for c in checks}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--passes", type=int, default=0)
    p.add_argument("--fault", default="")
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    from benchmarks.harness import runner, spec

    cell = spec.resolve(spec.load_benchmark(), a.workload)
    for seed in (int(s) for s in a.seeds.split(",")):
        t = time.perf_counter()
        if a.fault:
            runner.run(a.workload, seed, a.seconds, False, time.perf_counter(), a.device,
                       (a.fault,))
            continue
        readings = control(cell, seed, a.passes, a.device)
        print(json.dumps({"workload": a.workload, "seed": seed, "control": "bfloat16",
                          "passes": a.passes, "readings": readings,
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
