"""Image export of the port against the JAX package, and the port's own
OpenEXR shim.

- ``.hdr``: the port's ``write_hdr`` -> ``read_hdr`` round trip within the
  RGBE bound, and ``write_image`` to ``.hdr`` and ``.png`` decoding to the
  same pixels as the JAX package's ``write_image`` of the same image.
- ``.exr``: a file the port writes (through its shim, built from
  ``csrc/exr_io.cpp``, and through the pure-Python writer) decodes through
  the JAX package's ``read_exr`` to the same pixels as the JAX package's
  own file.
- No string literal of a port module (docstrings aside) names a path
  under the JAX package: the port builds what it loads.
- A host library (the shim, the BVH builder) is built once and reused, and
  a failed build is recorded so that later processes do not compile it
  again (``ops/cuda_build.py``).
"""

import ast
import glob
import os

import numpy as np
import pytest
from PIL import Image

from chiaroscuro_tpu.render import image_io as jax_io
from chiaroscuro_tpu_torch.ops import cuda_build
from chiaroscuro_tpu_torch.render import image_io

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "chiaroscuro_tpu_torch")


def _image(seed, shape=(6, 9, 3), hi=20.0):
    return np.random.default_rng(seed).uniform(0, hi, shape).astype(np.float32)


def test_hdr_round_trip(tmp_path):
    img = _image(2)
    p = str(tmp_path / "t.hdr")
    image_io.write_hdr(p, img)
    back = image_io.read_hdr(p)
    assert back.shape == img.shape and back.dtype == np.float32
    # RGBE shares an 8-bit mantissa across channels: |error| <= max / 256
    # per channel (tests/test_tonemap_io.py).
    bound = img.max(axis=-1, keepdims=True) / 256.0 + 1e-4
    assert (np.abs(back - img) <= bound).all()


@pytest.mark.parametrize("ext", [".hdr", ".png"])
def test_write_image_decodes_as_jax(ext, tmp_path):
    img = _image(3, hi=4.0)
    ours, theirs = str(tmp_path / f"port{ext}"), str(tmp_path / f"jax{ext}")
    image_io.write_image(ours, img)
    jax_io.write_image(theirs, img)
    if ext == ".hdr":
        got, want = jax_io.read_hdr(ours), jax_io.read_hdr(theirs)
        np.testing.assert_array_equal(image_io.read_hdr(ours), want)
    else:
        got, want = (np.asarray(Image.open(p)) for p in (ours, theirs))
        assert got.dtype == np.uint8 and got.shape == img.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("writer", ["shim", "python"])
def test_exr_written_by_the_port_decodes_through_jax(writer, tmp_path):
    img = _image(4, shape=(7, 5, 3), hi=4.0)
    ours, theirs = str(tmp_path / "port.exr"), str(tmp_path / "jax.exr")
    if writer == "shim":
        if image_io._native() is None:
            pytest.skip("the OpenEXR shim does not build here (no OpenEXR 3.1)")
        image_io.write_exr(ours, img)
    else:
        image_io._write_exr_py(ours, img)
    jax_io.write_exr(theirs, img)
    got = jax_io.read_exr(ours)
    np.testing.assert_array_equal(got, jax_io.read_exr(theirs))
    # HALF scanlines: the image rounded to float16.
    np.testing.assert_array_equal(got, img.astype(np.float16).astype(np.float32))
    np.testing.assert_array_equal(image_io.read_exr(ours), got)


def test_the_shim_is_built_from_the_port():
    lib = image_io._native()
    if lib is None:
        pytest.skip("the OpenEXR shim does not build here (no OpenEXR 3.1)")
    assert os.path.dirname(lib._name) == os.path.join(PORT, "_build")
    assert os.path.basename(lib._name).startswith("libexr_io_")


def _docstrings(tree):
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            b = node.body
            if b and isinstance(b[0], ast.Expr) and isinstance(b[0].value, ast.Constant):
                out.add(id(b[0].value))
    return out


def test_no_port_literal_names_a_jax_package_path():
    """A path into the JAX package, whole ("chiaroscuro_tpu/native/...") or
    as a component of a join ("chiaroscuro_tpu", "native"), in any string
    literal that is not a docstring."""
    bad = []
    for path in sorted(glob.glob(os.path.join(PORT, "**", "*.py"), recursive=True)):
        with open(path) as f:
            tree = ast.parse(f.read())
        docs = _docstrings(tree)
        for node in ast.walk(tree):
            if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                    and id(node) not in docs):
                s = node.value
                if s.strip("/\\") == "chiaroscuro_tpu" or "chiaroscuro_tpu/" in s \
                        or "chiaroscuro_tpu\\" in s:
                    bad.append(f"{os.path.relpath(path, REPO)}:{node.lineno}: {s[:60]!r}")
    assert len(glob.glob(os.path.join(PORT, "**", "*.py"), recursive=True)) >= 20
    assert not bad, bad


def _host_sources(tmp_path, monkeypatch):
    """A csrc/ with a source that builds and one that does not, and an
    empty _build/, for ``build_host_library`` unwrapped of its cache."""
    csrc, build = tmp_path / "csrc", tmp_path / "_build"
    csrc.mkdir()
    (csrc / "good.cpp").write_text('extern "C" int answer() { return 42; }\n')
    (csrc / "bad.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(cuda_build, "CSRC_DIR", str(csrc))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(build))
    return cuda_build.build_host_library.__wrapped__, build


def test_host_build_is_reused(tmp_path, monkeypatch):
    build_host, build = _host_sources(tmp_path, monkeypatch)
    lib, info = build_host("good")
    assert lib.answer() == 42 and info["seconds"] > 0
    assert os.path.dirname(info["path"]) == str(build)
    lib, again = build_host("good")
    assert again["path"] == info["path"] and again["seconds"] == 0.0
    assert build_host("good", ("-DUNUSED=1",))[1]["path"] != info["path"]


def test_failed_host_build_is_recorded(tmp_path, monkeypatch):
    """The failure is kept in ``lib<stem>_<hash>.failed`` with the
    compiler's output; while it exists a call raises without compiling;
    once deleted the build is tried again."""
    build_host, build = _host_sources(tmp_path, monkeypatch)
    with pytest.raises(RuntimeError, match="failed") as first:
        build_host("bad")
    (marker,) = build.glob("libbad_*.failed")
    assert marker.read_text() == str(first.value)
    assert not list(build.glob("*.so")) and not list(build.glob("tmp*"))

    def no_compile(*a, **k):
        raise AssertionError("compiled again")

    monkeypatch.setattr(cuda_build.subprocess, "run", no_compile)
    with pytest.raises(RuntimeError, match="an earlier build") as again:
        build_host("bad")
    assert str(first.value).splitlines()[0] in str(again.value)
    marker.unlink()
    with pytest.raises(AssertionError, match="compiled again"):
        build_host("bad")
