"""The port's spans (``utils/profiling.span``) on the CPU: no profiler range
is entered while no profiler runs; under torch.profiler a pass yields each
span nested in its parent, with the same pixels as without; the closest
hit's backward and checkpointing's recompute open theirs."""

import json
from collections import Counter

import numpy as np
import pytest
import torch

from chiaroscuro_tpu_torch.accel.dispatch import make_intersectors
from chiaroscuro_tpu_torch.render.renderer import Renderer, render_samples
from chiaroscuro_tpu_torch.scene.builtin import CORNELL_CAMERA, cornell_box
from chiaroscuro_tpu_torch.scene.config import RenderConfig
from chiaroscuro_tpu_torch.scene.scene_arrays import build_scene_tensors, params_from_numpy
from chiaroscuro_tpu_torch.utils import profiling

CAM = CORNELL_CAMERA
RES = (8, 8)
SPP, DEPTH = 2, 3
# Each span and the span it opens inside.
PARENT = {
    "render.to_host": "render.pass",
    "render.accumulate": "render.pass",
    "render.samples": "render.pass",
    "render.raygen": "render.samples",
    "render.bounce": "render.samples",
    "render.compact": "render.bounce",
    "render.closest": "render.bounce",
    "render.shadow": "render.bounce",
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for this module's many small plain-version ops, so
    that the suite's workers do not spin against each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def scene():
    return build_scene_tensors(cornell_box(), device="cpu")


def _renderer(scene):
    cfg = RenderConfig(obj_path="test", k=DEPTH, xres=RES[0], yres=RES[1], vp=CAM["eye"],
                       la=CAM["center"], up=CAM["up"], yview=CAM["yview"], samples=SPP, seed=7,
                       platform="cpu", intersector="dense")
    r = Renderer(scene, cfg)
    # Compaction leaves the radiance bitwise as it is; on, it opens render.compact.
    r.intersectors[0].prefers_compaction = True
    return r


def _profiled(fn, tmp_path):
    """Run ``fn`` under torch.profiler; its spans from the Chrome trace as
    (name, thread, start us, end us)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [(e["name"], e["tid"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def _names(spans):
    return Counter(name for name, *_ in spans)


def _inside(child, spans, parent):
    _, tid, a, b = child
    return any(n == parent and t == tid and s <= a and b <= e for n, t, s, e in spans)


def _leaf_scene(scene):
    params = params_from_numpy({"kd": scene.kd.numpy()}, "cpu")
    return scene.replace(**params), params["kd"]


def _pixels():
    ys, xs = torch.meshgrid(torch.arange(RES[1]), torch.arange(RES[0]), indexing="ij")
    return xs.reshape(-1), ys.reshape(-1)


def test_no_profiler_enters_no_range(scene, monkeypatch, tmp_path):
    """Without a profiler a pass enters no ``record_function`` and every span
    is the one shared no-op context; under one, every span enters one."""
    entered = []
    real = torch.profiler.record_function

    def counted(name, *args):
        entered.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    r = _renderer(scene)
    r.ray_trace()
    assert entered == []
    assert profiling.span("render.pass") is profiling.span("isect.closest_backward")
    spans = _profiled(r.ray_trace, tmp_path)
    assert sorted(entered) == sorted(n for n, *_ in spans if n in PARENT or n == "render.pass")


def test_pass_spans_nest(scene, tmp_path):
    """One pass: one ``render.pass`` holding the copy, the running mean and
    the samples; a raygen a sample; ``samples x depth`` bounces, each with
    its compaction, closest query and shadow query, on one thread."""
    spans = _profiled(_renderer(scene).ray_trace, tmp_path)
    n = _names(spans)
    bounces = SPP * DEPTH
    assert {k: n.get(k, 0) for k in ("render.pass", *PARENT)} == {
        "render.pass": 1, "render.to_host": 1, "render.accumulate": 1, "render.samples": 1,
        "render.raygen": SPP, "render.bounce": bounces, "render.compact": bounces,
        "render.closest": bounces, "render.shadow": bounces,
    }
    for s in spans:
        if s[0] in PARENT:
            assert _inside(s, spans, PARENT[s[0]]), s
    assert len({t for _, t, *_ in spans if t is not None}) == 1
    assert "isect.closest_backward" not in n


def test_pixels_equal_with_and_without_profiler(scene, tmp_path):
    """Two passes each: the pixels bitwise, and every count of ``last_stats``."""
    runs = []
    for traced in (False, True):
        r = _renderer(scene)
        for _ in range(2):
            if traced:
                _profiled(r.ray_trace, tmp_path)
            else:
                r.ray_trace()
        runs.append(r)
    off, on = runs
    assert np.array_equal(off.pixels, on.pixels)
    timed = ("seconds", "useful_rays_per_sec")
    assert {k: v for k, v in off.last_stats.items() if k not in timed} == \
        {k: v for k, v in on.last_stats.items() if k not in timed}


def test_closest_backward_span(scene, tmp_path):
    """A dense pair's closest hit on a scene whose kd requires grad: the
    backward opens ``isect.closest_backward`` once, the forward never."""
    s, kd = _leaf_scene(scene)
    closest_fn, _ = make_intersectors(s, "dense")
    g = torch.Generator().manual_seed(3)
    eye = torch.tensor(CAM["eye"], dtype=torch.float32)
    aim = torch.tensor(CAM["center"], dtype=torch.float32) - eye
    o3 = eye[:, None, None].expand(3, 1, 128).contiguous()
    d3 = (aim[:, None, None] + 0.3 * torch.randn((3, 1, 128), generator=g)).contiguous()
    state = {}

    def forward():
        res = closest_fn.planar_fn(o3, d3)
        state["loss"] = (res.attrs["kd"] * res.hit).sum()

    assert "isect.closest_backward" not in _names(_profiled(forward, tmp_path))
    spans = _profiled(lambda: state["loss"].backward(), tmp_path)
    assert _names(spans).get("isect.closest_backward") == 1
    assert float(kd.grad.abs().sum()) > 0.0


def test_checkpoint_recompute_reopens_spans(scene, tmp_path):
    """``render_samples(checkpoint=True)`` opens each sample's raygen and
    bounces twice: in the forward, inside ``render.samples``, and again in
    the backward's recompute, outside it."""
    s, kd = _leaf_scene(scene)
    pair = make_intersectors(s, "dense")
    px, py = _pixels()

    def step():
        img = render_samples(s, CAM["eye"], CAM["center"], CAM["up"], CAM["yview"], *RES, px,
                             py, 0, SPP, 0, DEPTH, (0.0, 0.0, 0.0), *pair, checkpoint=True)
        img.sum().backward()

    spans = _profiled(step, tmp_path)
    for name, per_sample in (("render.raygen", 1), ("render.bounce", DEPTH)):
        opened = [x for x in spans if x[0] == name]
        inside = [x for x in opened if _inside(x, spans, "render.samples")]
        assert len(opened) == 2 * SPP * per_sample, name
        assert len(inside) == SPP * per_sample, name
    assert float(kd.grad.abs().sum()) > 0.0
