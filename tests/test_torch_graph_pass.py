"""A progressive pass replayed as one CUDA graph (``Renderer`` on the card),
its running mean on the device, and what that rests on, checked on the CPU.

On the CPU: ``render_samples`` with the first sample index, the camera and
the background as tensors equals the Python values' render bitwise (the
graph's inputs); ``threefry2x32`` with Python-int words equals the
tensor-word form; ``running_mean_`` equals numpy's ``(p * (L - 1) + img) /
L`` bitwise, inf and NaN included; the renderer's bookkeeping (the static
inputs, the device image, its re-seeding), which CPU tensors take too,
gives numpy's running mean of eager renders; a CPU renderer never
captures; and a pass's key holds its scene and pair.

On the card (marker ``cuda``, skipped without one; this file imports no
jax): five passes through the dense pair (Cornell) and the BVH pair (a
small atrium), with a camera change and a state round trip, equal the
eager renders averaged by numpy, bitwise, and count one eager pass, one
capture and four replays; each returned array outlives the next pass; a
pass under ``counting()`` runs eagerly and records the eager pass's
entries; a pass after the pair or the scene is swapped runs eagerly; the
cluster pair's passes all run eagerly; the sample streams' kernels give
the passes of the int64 operator chain bitwise, launch on the eager pass
and the capture but not on a replay, and leave no xor operator to run.

    python -m pytest --noconftest -q tests/test_torch_graph_pass.py
"""

import contextlib
import io
import os

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from chiaroscuro_tpu_torch.accel.dispatch import make_intersectors
from chiaroscuro_tpu_torch.ops import threefry_cuda
from chiaroscuro_tpu_torch.render import renderer as R
from chiaroscuro_tpu_torch.sampling import prng
from chiaroscuro_tpu_torch.scene.builtin import CORNELL_CAMERA, cornell_box
from chiaroscuro_tpu_torch.scene.config import RenderConfig
from chiaroscuro_tpu_torch.scene.scene_arrays import build_scene_tensors, load_scene
from chiaroscuro_tpu_torch.utils import profiling

CAM = CORNELL_CAMERA
ATRIUM = ["input", "synthetic:atrium:2200", "samples", "2", "k", "3", "VP", "1.8", "4.2",
          "5.0", "LA", "24", "3.2", "6.8", "UP", "0", "1", "0", "yview", "0.9"]
# A pass's eye, or None for the configuration's: the camera moves at pass 3.
EYES = [None, None, (1.8, 4.0, 5.5), (1.8, 4.0, 5.5), (1.8, 4.0, 5.5)]


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Two torch threads for this module's plain-version ops, so that the
    suite's workers do not spin against each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _cornell_cfg(dev, res=(16, 12), intersector="dense"):
    return RenderConfig(obj_path="test", k=3, xres=res[0], yres=res[1], vp=CAM["eye"],
                        la=CAM["center"], up=CAM["up"], yview=CAM["yview"], samples=2,
                        seed=2 ** 32 + 7, platform=dev.type, intersector=intersector)


def _atrium_cfg(dev, res=(24, 16), intersector="bvh"):
    return RenderConfig.from_tokens(ATRIUM + ["xres", str(res[0]), "yres", str(res[1]),
                                              "intersector", intersector, "seed", "3000000077",
                                              "platform", dev.type])


def _pixels(xres, yres, dev):
    ys, xs = torch.meshgrid(torch.arange(yres, device=dev), torch.arange(xres, device=dev),
                            indexing="ij")
    return xs.reshape(-1), ys.reshape(-1)


def _bits_equal(a, b):
    """Bitwise equal where not NaN, NaN at the same places (a NaN's payload
    is the hardware's)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    nan = np.isnan(a)
    return np.array_equal(nan, np.isnan(b)) and np.array_equal(
        a[~nan].view(np.int32), b[~nan].view(np.int32))


def _quiet(fn, *args, **kw):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kw)


def _passes():
    return dict(profiling.PASSES)


def _delta(before):
    return {k: profiling.PASSES[k] - before[k] for k in before}


def _numpy_mean(scene, cfg, pair, layers):
    """``layers`` passes at the configuration's camera, rendered eagerly and
    averaged by numpy."""
    want = np.zeros((cfg.yres, cfg.xres, 3), np.float32)
    for layer in range(1, layers + 1):
        img = R.render_image(scene, cfg, sample_start=(layer - 1) * cfg.samples,
                             intersectors=pair).cpu().numpy()
        want = (want * (layer - 1) + img) / layer
    return want


def _progressive(r, tmp_path):
    """``EYES``' five passes of ``r``, saving and reloading the state after
    the fourth; each pass's (returned array, a copy of it, max_val)."""
    out = []
    for i, eye in enumerate(EYES):
        got = _quiet(r.ray_trace, eye=eye)
        out.append((got, got.copy(), r.max_val))
        if i == 3:
            path = os.path.join(str(tmp_path), "state.npz")
            r.save_state(path)
            assert r.load_state(path)
    return out


def _numpy_reference(scene, cfg, pair, tmp_path):
    """The same five passes rendered eagerly by ``render_image`` with
    Python-int sample starts and averaged by numpy, the state rounded
    through its file as ``Renderer.save_state``/``load_state`` round it."""
    from chiaroscuro_tpu_torch.utils.checkpoint import AccumulationState

    pixels, layers, last, out = np.zeros((cfg.yres, cfg.xres, 3), np.float32), 0, None, []
    for i, eye in enumerate(EYES):
        eye = tuple(np.asarray(eye if eye is not None else cfg.vp, np.float32))
        layers = layers + 1 if eye == last else 1
        last = eye
        img = R.render_image(scene, cfg, eye=eye, sample_start=(layers - 1) * cfg.samples,
                             intersectors=pair).cpu().numpy()
        pixels = (pixels * (layers - 1) + img) / layers
        out.append((pixels, float(pixels.max(initial=0.0))))
        if i == 3:
            path = os.path.join(str(tmp_path), "ref.npz")
            AccumulationState(pixels.astype(np.float64) * layers, layers, cfg.samples,
                              (eye, tuple(cfg.la), tuple(cfg.up), cfg.yview), cfg.seed).save(path)
            pixels = AccumulationState.load(path).pixels
    return out


# ---------------------------------------------------------------------------
# On the CPU.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scene_name", ["cornell", "atrium"])
def test_render_samples_tensor_inputs_equal_python_values(scene_name):
    """The first sample index as a 0-dim int64 tensor, the camera as
    ``camera_tensors`` and the background as a tensor: the radiance and the
    counts equal the Python values' bitwise, at a sample index past 2^31."""
    dev = torch.device("cpu")
    if scene_name == "cornell":
        cfg = _cornell_cfg(dev)
        scene = build_scene_tensors(cornell_box(), device=dev)
    else:
        cfg = _atrium_cfg(dev, intersector="cluster")
        scene = load_scene(cfg, dev)
    pair = make_intersectors(scene, cfg.intersector)
    px, py = _pixels(cfg.xres, cfg.yres, dev)
    start = 2 ** 31 + 5
    args = (cfg.xres, cfg.yres, px, py)
    want = R.render_samples(scene, cfg.vp, cfg.la, cfg.up, cfg.yview, *args, start, 2, cfg.seed,
                            cfg.k, (0.1, 0.2, 0.3), *pair, with_stats=True)
    camera = R.camera_tensors(cfg.vp, cfg.la, cfg.up, cfg.yview, cfg.xres, cfg.yres, dev)
    got = R.render_samples(scene, None, None, None, None, *args,
                           torch.tensor(start, dtype=torch.int64), 2, cfg.seed, cfg.k,
                           torch.tensor((0.1, 0.2, 0.3)), *pair, with_stats=True, camera=camera)
    assert float(want[0].abs().sum()) > 0
    assert _bits_equal(got[0].numpy(), want[0].numpy())
    assert torch.equal(got[1], want[1])


def test_threefry_python_words_equal_tensor_words():
    """Every mix of Python-int and tensor words, the extremes among them,
    gives the tensor-word block's int64 outputs bitwise."""
    g = np.random.default_rng(11)
    words = [0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1, prng._JITTER_TAG, 3000000077]
    a, b = (torch.from_numpy(g.integers(0, 2 ** 32, (3, 7), dtype=np.int64)) for _ in range(2))
    for w0 in words:
        for w1 in words:
            for args, ref in (
                ((w0, w1, a, b), (torch.tensor(w0), torch.tensor(w1), a, b)),
                ((a, b, w0, w1), (a, b, torch.tensor(w0), torch.tensor(w1))),
                ((w0, a, w1, b), (torch.tensor(w0), a, torch.tensor(w1), b)),
                ((w0, w1, w0, w1), tuple(torch.tensor(x) for x in (w0, w1, w0, w1))),
            ):
                got, want = prng.threefry2x32(*args), prng.threefry2x32(*ref)
                for x, y in zip(got, want):
                    assert x.dtype == torch.int64 and torch.equal(x, y)


@pytest.mark.parametrize("layers", range(1, 7))
def test_running_mean_equals_numpy(layers):
    """``running_mean_`` on CPU tensors: numpy's ``(p * (L - 1) + img) / L``
    bitwise, with inf, -inf and NaN in both images, and the maximum floored
    at 0 as numpy's ``max(initial=0.0)`` (NaN where the image has one)."""
    g = np.random.default_rng(layers)
    p = (g.random((9, 7, 3)) * 10).astype(np.float32)
    img = (g.random((9, 7, 3)) * 10).astype(np.float32)
    p[0, 0, 0], p[1, 2, 1], p[3, 3, 2] = np.inf, np.nan, -np.inf
    img[0, 1, 0], img[2, 2, 2], img[4, 0, 1] = np.inf, np.nan, 1e-39
    with np.errstate(invalid="ignore"):           # inf x 0 is NaN, as intended
        cases = ((p, img), (np.abs(np.nan_to_num(p, posinf=0, neginf=0)), img * 0.5),
                 (p * 0, img * 0))
    for a, b in cases:
        with np.errstate(invalid="ignore"):
            want = (a * (layers - 1) + b) / layers
        image = torch.from_numpy(a.copy())
        m = R.running_mean_(image, torch.from_numpy(b),
                            torch.tensor((layers - 1, layers), dtype=torch.float32))
        assert _bits_equal(image.numpy(), want)
        ref = float(want.max(initial=0.0))
        assert (np.isnan(ref) and np.isnan(float(m))) or float(m) == ref


def test_cpu_renderer_never_captures():
    """On the CPU every pass runs eagerly and reports ``replayed`` False,
    whatever the pair declares."""
    dev = torch.device("cpu")
    scene = build_scene_tensors(cornell_box(), device=dev)
    r = R.Renderer(scene, _cornell_cfg(dev))
    assert r.intersectors[0].capturable() and r.intersectors[1].capturable()
    before = _passes()
    _quiet(r.ray_trace)
    _quiet(r.ray_trace)
    _quiet(r.ray_trace, eye=(1.0, 1.0, 3.0))
    assert _delta(before) == {"captured": 0, "replayed": 0, "eager": 3}
    assert r.last_stats["replayed"] is False


def test_card_bookkeeping_on_cpu_tensors(tmp_path):
    """The renderer's state (static inputs, device image, re-seeding on a
    new ``pixels``) on CPU tensors, every pass eager: ``EYES``' five passes
    with a state round trip equal eager ``render_image`` calls averaged by
    numpy, bitwise, and each returned array keeps its values after the next
    pass."""
    dev = torch.device("cpu")
    scene = build_scene_tensors(cornell_box(), device=dev)
    cfg = _cornell_cfg(dev)
    r = R.Renderer(scene, cfg)
    got = _progressive(r, tmp_path)
    want = _numpy_reference(scene, cfg, r.intersectors, tmp_path)
    for i, ((g, g_copy, g_max), (w, w_max)) in enumerate(zip(got, want)):
        assert float(w.sum()) > 0, i
        assert _bits_equal(g, w) and _bits_equal(g, g_copy) and g_max == w_max, i
    assert len({id(g) for g, *_ in got}) == len(got)


def test_pass_key_holds_scene_and_pair():
    """The last pass's key keeps its scene and pair alive, so no later
    object can take their addresses while a graph may replay against
    them; the next pass with another pair lets the old one go."""
    import gc
    import weakref

    dev = torch.device("cpu")
    cfg = _cornell_cfg(dev)
    r = R.Renderer(build_scene_tensors(cornell_box(), device=dev), cfg)
    _quiet(r.ray_trace)
    old = [weakref.ref(f) for f in r.intersectors]
    old_scene = weakref.ref(r.scene)
    r.scene = build_scene_tensors(cornell_box(), device=dev)
    r.intersectors = make_intersectors(r.scene, cfg.intersector)
    gc.collect()
    assert all(w() is not None for w in old) and old_scene() is not None
    _quiet(r.ray_trace)
    gc.collect()
    assert all(w() is None for w in old) and old_scene() is None


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA graph has no CPU mode")
    return torch.device("cuda", 0)


def _card_scene(name, dev):
    if name == "dense":
        return build_scene_tensors(cornell_box(), device=dev), _cornell_cfg(dev, (64, 64))
    cfg = _atrium_cfg(dev, (64, 36))
    return load_scene(cfg, dev), cfg


@pytest.mark.cuda
@pytest.mark.parametrize("pair", ["dense", "bvh"])
def test_replayed_passes_equal_eager_numpy_mean(pair, cuda_device, tmp_path):
    """Five passes (the camera moves at pass 3, the state goes through its
    file after pass 4): pixels and ``max_val`` bitwise those of eager
    ``render_image`` calls averaged by numpy; one eager pass, one capture,
    four replays; each returned array unchanged by the next pass."""
    scene, cfg = _card_scene(pair, cuda_device)
    r = R.Renderer(scene, cfg)
    before = _passes()
    got = _progressive(r, tmp_path)
    assert _delta(before) == {"captured": 1, "replayed": 4, "eager": 1}
    assert r.last_stats["replayed"] is True
    want = _numpy_reference(scene, cfg, r.intersectors, tmp_path)
    for i, ((g, g_copy, g_max), (w, w_max)) in enumerate(zip(got, want)):
        assert float(w.sum()) > 0, i
        assert _bits_equal(g, w), i
        assert _bits_equal(g, g_copy), i
        assert g_max == w_max, i
    assert len({id(g) for g, *_ in got}) == len(got)


@pytest.mark.cuda
def test_counted_pass_runs_eager_on_card(cuda_device):
    """A BVH pass under ``counting()`` after a replayed one runs eagerly and
    records the entries, and gives the pixels, of the same pass on a
    renderer whose every pass was counted."""
    scene, cfg = _card_scene("bvh", cuda_device)
    replaying, counted = R.Renderer(scene, cfg), R.Renderer(scene, cfg)
    _quiet(replaying.ray_trace)
    _quiet(replaying.ray_trace)
    assert replaying.last_stats["replayed"] is True
    for _ in range(2):
        with profiling.counting():
            _quiet(counted.ray_trace)
    before = _passes()
    with profiling.counting() as got:
        _quiet(replaying.ray_trace)
    assert _delta(before) == {"captured": 0, "replayed": 0, "eager": 1}
    with profiling.counting() as want:
        _quiet(counted.ray_trace)
    assert [e["kernel"] for e in got] == ["bvh_closest", "bvh_any"] * (cfg.samples * cfg.k)
    assert got == want
    assert _bits_equal(replaying.pixels, counted.pixels)


@pytest.mark.cuda
@pytest.mark.parametrize("swap", ["pair", "scene"])
def test_swapped_pair_runs_eager_on_card(swap, cuda_device):
    """After a replayed pass, a freshly built pair (over the same scene, or
    over a fresh copy of it) makes the next pass run eagerly and the one
    after capture anew; the four passes equal numpy's mean of eager
    renders, bitwise."""
    import gc

    scene, cfg = _card_scene("bvh", cuda_device)
    r = R.Renderer(scene, cfg)
    _quiet(r.ray_trace)
    _quiet(r.ray_trace)
    assert r.last_stats["replayed"] is True
    if swap == "scene":
        r.scene = scene = load_scene(cfg, cuda_device)
    r.intersectors = None
    gc.collect()
    r.intersectors = make_intersectors(scene, cfg.intersector)
    before = _passes()
    _quiet(r.ray_trace)
    assert _delta(before) == {"captured": 0, "replayed": 0, "eager": 1}
    assert r.last_stats["replayed"] is False
    _quiet(r.ray_trace)
    assert _delta(before) == {"captured": 1, "replayed": 1, "eager": 1}
    want = _numpy_mean(scene, cfg, r.intersectors, 4)
    assert float(want.sum()) > 0
    assert _bits_equal(r.pixels, want) and r.max_val == float(want.max(initial=0.0))


@pytest.mark.cuda
def test_cluster_passes_stay_eager(cuda_device):
    """The cluster pair declares nothing: every pass runs eagerly, and its
    device mean equals numpy's over eager renders."""
    cfg = _atrium_cfg(cuda_device, (64, 36), intersector="cluster")
    scene = load_scene(cfg, cuda_device)
    r = R.Renderer(scene, cfg)
    before = _passes()
    for layer in range(1, 4):
        _quiet(r.ray_trace)
        want = _numpy_mean(scene, cfg, r.intersectors, layer)
        assert _bits_equal(r.pixels, want) and r.max_val == float(want.max(initial=0.0))
    assert _delta(before) == {"captured": 0, "replayed": 0, "eager": 3}


class _OpNames(TorchDispatchMode):
    """The names of the ATen operators run while the mode is on."""

    def __init__(self):
        super().__init__()
        self.names = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.add(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.cuda
@pytest.mark.parametrize("pair", ["dense", "bvh"])
def test_stream_kernels_keep_passes_bitwise(pair, cuda_device, monkeypatch):
    """Three passes (eager, captured, replayed) whose sample streams run as
    kernels equal, bitwise, three passes of a renderer whose streams take
    the int64 operator chain (``prng``'s plain versions patched in); the
    kernels launch once a sample and a bounce on the eager pass and the
    capture, and not on the replay; an eager render through the kernels
    runs no xor, the chain's mark, where the chain's render runs some."""
    scene, cfg = _card_scene(pair, cuda_device)

    def three_passes():
        r, images, launched = R.Renderer(scene, cfg), [], []
        for _ in range(3):
            before = dict(threefry_cuda.LAUNCHES)
            images.append(_quiet(r.ray_trace).copy())
            launched.append({k: n - before[k] for k, n in threefry_cuda.LAUNCHES.items()})
        with _OpNames() as ops:
            R.render_image(scene, cfg, intersectors=r.intersectors)
        return images, launched, {n for n in ops.names if "xor" in n}

    before = _passes()
    got, launched, xors = three_passes()
    assert _delta(before) == {"captured": 1, "replayed": 2, "eager": 1}
    per_pass = {"threefry_bounce": cfg.samples * cfg.k, "threefry_raygen": cfg.samples}
    assert launched == [per_pass, per_pass, dict.fromkeys(per_pass, 0)]
    assert not xors
    monkeypatch.setattr(prng, "raygen_streams", prng.raygen_streams_plain)
    monkeypatch.setattr(prng, "bounce_uniforms_planar", prng.bounce_uniforms_plain)
    want, launched, xors = three_passes()
    assert launched == [dict.fromkeys(per_pass, 0)] * 3
    assert xors
    for i, (g, w) in enumerate(zip(got, want)):
        assert float(w.sum()) > 0, i
        assert _bits_equal(g, w), i
