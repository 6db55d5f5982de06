"""Inverse rendering: a closed loop of steps, each the port's
``parallel.sharding.sharded_value_and_grad`` on a one-rank mesh (the image
rendered with ``render_samples(checkpoint=True)`` through the prebuilt
clusters, the MSE against a target image, the gradients with respect to kd
and ke) and one Adam update of kd and ke in the harness.  The materials
change every step, as in inverse rendering; step i renders the samples
[i spp, (i + 1) spp).

The seed makes the first materials (each kd and ke scaled by a uniform
factor) and the target (uniform noise), on the card.  Set-up builds the
scene and the clusters and runs the first ``first_steps`` steps, which warm
every shape; their losses, the first gradient (from Adam's first moment
after one step) and the change of the materials after them are what the
reference is held to.  The window then runs steps until ``--seconds`` have
gone: ``step_ms`` is the window over its steps.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from benchmarks.harness import faults, program, trace
from benchmarks.harness.runner import Check, Outcome
from benchmarks.reference import accel, render, scene as ref_scene

BETAS = (0.9, 0.999)


def inputs(scene_kd, scene_ke, n_pixels, seed, dev):
    """First materials and target from the seed: (kd0, ke0, target (R, 3)).
    ``scene_kd``, ``scene_ke`` are the reference's own per-triangle tables
    (``ref_scene.materials``), so the port's never reach the reference."""
    g = torch.Generator(device=dev).manual_seed(int(seed))
    kd0 = scene_kd * (0.5 + 0.5 * torch.rand(scene_kd.shape, generator=g, device=dev))
    ke0 = scene_ke * (0.5 + torch.rand(scene_ke.shape, generator=g, device=dev))
    target = torch.rand((n_pixels, 3), generator=g, device=dev)
    return kd0, ke0, target


def run(ctx) -> Outcome:
    cfg, tr, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    faults.apply(ctx.faults)
    spp, lr = int(tr["spp"]), float(tr["lr"])
    meshes, textures = program.scene_inputs(cfg)
    ctx.mark("inputs")
    scene, scene_s = program.port_scene(meshes, textures, dev)
    ctx.mark("scene")
    from chiaroscuro_tpu_torch.accel.clusters import build_clusters
    from chiaroscuro_tpu_torch.accel.dispatch import make_intersectors, resolve_auto
    from chiaroscuro_tpu_torch.parallel.sharding import make_tile_mesh, sharded_value_and_grad

    t = time.perf_counter()
    method = cfg.get("intersector", "auto")
    if method == "auto":
        method = resolve_auto(scene.n_tris, dev == "cuda")
    clusters = None
    if method == "cluster":
        clusters = build_clusters(*(x.cpu().numpy() for x in (scene.tri_v0, scene.tri_v1,
                                                               scene.tri_v2)), 128)
    make_intersectors(scene, method, clusters=clusters)
    program.sync(dev)
    accel_s = time.perf_counter() - t
    ctx.mark("clusters and intersectors")

    xres, yres = int(cfg["xres"]), int(cfg["yres"])
    R = xres * yres
    kd0, ke0, target = inputs(*ref_scene.materials(meshes, dev), R, ctx.seed, dev)
    kd = kd0.clone().requires_grad_(True)
    ke = ke0.clone().requires_grad_(True)
    opt = torch.optim.Adam([kd, ke], lr=lr, betas=BETAS)
    cam = cfg["camera"]
    kw = dict(eye=cam["eye"], center=cam["center"], up=cam["up"], yview=cam["yview"],
              xres=xres, yres=yres, n_samples=spp, seed=ctx.seed, depth=int(cfg["k"]),
              background=cfg.get("background", (0.0, 0.0, 0.0)), checkpoint=True,
              intersector=method, clusters=clusters)
    ys, xs = torch.meshgrid(torch.arange(yres, dtype=torch.int32, device=dev),
                            torch.arange(xres, dtype=torch.int32, device=dev), indexing="ij")
    px, py = xs.reshape(-1), ys.reshape(-1)
    mesh = make_tile_mesh(device=dev)
    make = sharded_value_and_grad(lambda img: ((img - target) ** 2).mean(), ("kd", "ke"))

    def step(i):
        run_ = make(mesh, dict(kw, sample_start=i * spp))
        with trace.span("step"):
            loss, grads = run_(scene.replace(kd=kd.detach(), ke=ke.detach()), px, py)
        with trace.span("update"):
            kd.grad, ke.grad = grads["kd"], grads["ke"]
            opt.step()
        return float(loss)

    first = int(tr["first_steps"])
    losses, g1 = [], None
    for i in range(first):
        losses.append(step(i))
        if i == 0:
            g1 = [float(opt.state[p]["exp_avg"].norm() / (1.0 - BETAS[0])) for p in (kd, ke)]
    change = [float((p.detach() - p0).norm()) for p, p0 in ((kd, kd0), (ke, ke0))]
    program.sync(dev)
    ctx.mark(f"{first} steps")
    t_w0 = time.perf_counter()
    setup_s = t_w0 - ctx.t0
    print(ctx.setup_parts(), file=sys.stderr)
    e2e, record, busy_s, window_s, breakdown = {"setup_s": setup_s}, None, None, None, None
    i, bad, times = first, 0, []
    if not ctx.trace:
        while True:
            a = time.perf_counter()
            loss = step(i)
            times.append(time.perf_counter() - a)
            bad += not np.isfinite(loss)
            i += 1
            if time.perf_counter() - t_w0 >= ctx.seconds:
                break
        program.sync(dev)
        print("step ms: " + program.quartiles(times), file=sys.stderr)
        e2e["step_ms"] = (time.perf_counter() - t_w0) * 1e3 / (i - first)
        peak = torch.cuda.max_memory_allocated() if dev == "cuda" else 0
    else:
        peak = torch.cuda.max_memory_allocated() if dev == "cuda" else 0
        if dev == "cuda":
            torch.cuda.reset_peak_memory_stats()
        n = int(tr["trace_steps"])
        with trace.profiled() as prof:
            with trace.span("window"):
                for _ in range(n):
                    bad += not np.isfinite(step(i))
                    i += 1
        window_peak = torch.cuda.max_memory_allocated() if dev == "cuda" else 0
        peak = max(peak, window_peak)
        t = trace.reduce(prof.events, n)
        busy_s, window_s = t.busy_s, t.window_s
        breakdown = {"device_ops": t.top_ops(), "idle_gaps": t.idle_gaps()}
        record = {"trace": t, "window_peak_bytes": window_peak}
    record = dict(record or {}, scene_s=scene_s, accel_s=accel_s)
    attempted = i - first
    del scene, clusters, opt, kd, ke, make, mesh
    program.free_cuda()
    t = time.perf_counter()
    ref = reference_steps(cfg, tr, ctx.seed, dev, meshes, textures, kd0, ke0, target)
    print(f"reference: {len(ref['losses'])} steps in {time.perf_counter() - t:.1f} s",
          file=sys.stderr)
    checks = step_checks({"losses": losses, "grad": g1, "change": change}, ref, tr["limits"])
    return Outcome(attempted, bad, e2e, record, checks,
                   program.device_info(ctx.cell.chips, peak, dev), busy_s, window_s, breakdown)


def reference_steps(cfg, tr, seed, dev, meshes, textures, kd0, ke0, target,
                    dtype=torch.float32, lanes=1 << 17):
    """The reference's own first ``first_steps`` steps from the same inputs:
    its losses, each leaf's first gradient norm and its materials' change
    after those steps."""
    spp, lr, n = int(tr["spp"]), float(tr["lr"]), int(tr["first_steps"])
    rs = ref_scene.flatten(meshes, textures, dev, dtype)
    groups = accel.Groups(rs)
    xres, yres = int(cfg["xres"]), int(cfg["yres"])
    cam = cfg["camera"]
    lu, dx, dy = render.camera_basis(cam["eye"], cam["center"], cam["up"], cam["yview"], xres, yres)
    kd = kd0.to(dtype).clone().requires_grad_(True)
    ke = ke0.to(dtype).clone().requires_grad_(True)
    opt = torch.optim.Adam([kd, ke], lr=lr, betas=BETAS)
    R = xres * yres
    pix = torch.arange(R, device=dev)
    losses, g1 = [], None
    for i in range(n):
        s = rs.with_materials(kd, ke)
        total = 0.0
        for b in range(0, R, lanes):
            p = pix[b:b + lanes]
            acc = None
            for j in range(spp):
                rad = render.trace(s, groups, (cam["eye"], lu, dx, dy), p, p % xres, p // xres,
                                   torch.full_like(p, i * spp + j), seed, int(cfg["k"]),
                                   cfg.get("background", (0.0, 0.0, 0.0))).float().T
                acc = rad if acc is None else acc + rad
            img = acc * (1.0 / spp)
            loss = ((img - target[b:b + lanes]) ** 2).sum() / (R * 3)
            loss.backward()
            total += float(loss.detach())
        losses.append(total)
        if i == 0:
            g1 = [float(p.grad.float().norm()) for p in (kd, ke)]
        opt.step()
        opt.zero_grad()
    change = [float((p.detach().float() - p0).norm()) for p, p0 in ((kd, kd0), (ke, ke0))]
    return {"losses": losses, "grad": g1, "change": change}


def _leaf_gap(got, want, keep):
    med = float(np.median(want))
    gaps = [abs(g - w) / max(w, med) for g, w, k in zip(got, want, keep) if k]
    return max(gaps) if gaps else 0.0


def step_checks(prog, ref, limits):
    """``loss_gap``: the largest relative gap of a step's loss over the steps
    the reference follows; ``grad_gap`` and ``change_gap``: the worst leaf's
    gap between the norms of its first gradient and of its change, over the
    larger of the reference's norm of that leaf and of the median leaf.  A
    leaf whose reference gradient is under a thousandth of the median
    leaf's moves by round-off alone and is left out of the change."""
    n = len(ref["losses"])
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"][:n], ref["losses"]))
    med = float(np.median(ref["grad"]))
    keep = [g >= 1e-3 * med for g in ref["grad"]]
    return [Check("loss_gap", loss_gap, float(limits["loss_gap"])),
            Check("grad_gap", _leaf_gap(prog["grad"], ref["grad"], [True] * len(keep)),
                  float(limits["grad_gap"])),
            Check("change_gap", _leaf_gap(prog["change"], ref["change"], keep),
                  float(limits["change_gap"]))]
