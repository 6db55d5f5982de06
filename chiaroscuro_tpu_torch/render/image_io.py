"""Host-side image I/O: EXR/HDR float export + read, tone-mapped LDR export.

Plays the role of the reference's FreeImage export path
(``src/rayTracer.cpp:225-279``): ``.exr``/``.hdr`` extensions get raw float
RGB radiance; anything else is tone mapped (exrdisplay knee/gamma) to 8-bit.

EXR goes through the native OpenEXR shim that the JAX package ships
(``chiaroscuro_tpu/native/libexr_io.so``) —
HALF-RGB scanlines, PIZ-compressed, matching the reference goldens' encoding —
with a pure-Python fallback writer/reader (uncompressed or ZIP scanline
format) when the native library is unavailable.  ``.hdr`` is Radiance RGBE.

The shim is loaded by file path with ``ctypes``, which imports no Python
module of the JAX package; it is never built from here.
"""

from __future__ import annotations

import ctypes
import functools
import os
import struct
import zlib
from typing import Optional

import numpy as np

from chiaroscuro_tpu_torch.render.tonemap import normalize_image

# Imf::Compression values used by the native shim.
EXR_NONE = 0
EXR_ZIP = 3
EXR_PIZ = 4

_EXR_LIB = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "chiaroscuro_tpu", "native", "libexr_io.so",
)


@functools.cache
def _native() -> Optional[ctypes.CDLL]:
    """The OpenEXR shim, or None where it does not load."""
    try:
        l = ctypes.CDLL(_EXR_LIB)
    except OSError as e:
        print(f"WARNING: cannot load {_EXR_LIB}: {e}")
        return None
    l.exr_get_size.restype = ctypes.c_int
    l.exr_get_size.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    l.exr_read_rgb.restype = ctypes.c_int
    l.exr_read_rgb.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float)]
    l.exr_write_rgb.restype = ctypes.c_int
    l.exr_write_rgb.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
    ]
    return l


# --------------------------------------------------------------------------
# EXR via native OpenEXR
# --------------------------------------------------------------------------

def read_exr(path: str) -> np.ndarray:
    """Read an EXR file to (H, W, 3) float32 RGB (any source channel set)."""
    l = _native()
    if l is not None:
        w = ctypes.c_int()
        h = ctypes.c_int()
        if l.exr_get_size(path.encode(), ctypes.byref(w), ctypes.byref(h)):
            raise IOError(f"failed to open EXR: {path}")
        out = np.empty((h.value, w.value, 3), np.float32)
        if l.exr_read_rgb(
            path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        ):
            raise IOError(f"failed to read EXR: {path}")
        return out
    return _read_exr_py(path)


def write_exr(path: str, pixels: np.ndarray, compression: int = EXR_PIZ) -> None:
    """Write (H, W, 3) RGB radiance as HALF scanlines (row 0 = image top)."""
    img = np.ascontiguousarray(np.asarray(pixels, np.float32))
    l = _native()
    if l is not None:
        h, w = img.shape[:2]
        if l.exr_write_rgb(
            path.encode(),
            img.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            w,
            h,
            compression,
        ):
            raise IOError(f"failed to write EXR: {path}")
        return
    _write_exr_py(path, img)


# --------------------------------------------------------------------------
# Pure-Python EXR fallback (scanline, HALF, NONE or ZIP compression)
# --------------------------------------------------------------------------

def _write_exr_py(path: str, img: np.ndarray) -> None:
    h, w = img.shape[:2]
    half = img.astype(np.float16)

    def attr(name, typ, payload):
        return name.encode() + b"\0" + typ.encode() + b"\0" + struct.pack(
            "<I", len(payload)
        ) + payload

    chan = b""
    for c in (b"B", b"G", b"R"):  # alphabetical, as OpenEXR requires
        chan += c + b"\0" + struct.pack("<iiii", 1, 0, 1, 1)  # HALF, linear, 1x1
    chan += b"\0"

    header = b""
    header += attr("channels", "chlist", chan)
    header += attr("compression", "compression", struct.pack("<B", 0))
    header += attr("dataWindow", "box2i", struct.pack("<iiii", 0, 0, w - 1, h - 1))
    header += attr("displayWindow", "box2i", struct.pack("<iiii", 0, 0, w - 1, h - 1))
    header += attr("lineOrder", "lineOrder", struct.pack("<B", 0))
    header += attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += attr("screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0))
    header += attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\0"

    magic = struct.pack("<I", 20000630) + struct.pack("<I", 2)
    offset_table_pos = len(magic) + len(header)
    first_scanline = offset_table_pos + 8 * h
    scan_size = 8 + w * 2 * 3  # y + size prefix + 3 HALF channels

    with open(path, "wb") as f:
        f.write(magic)
        f.write(header)
        for y in range(h):
            f.write(struct.pack("<Q", first_scanline + y * scan_size))
        for y in range(h):
            f.write(struct.pack("<ii", y, w * 2 * 3))
            # Channel-planar per scanline, alphabetical: B, G, R.
            f.write(half[y, :, 2].tobytes())
            f.write(half[y, :, 1].tobytes())
            f.write(half[y, :, 0].tobytes())


def _read_exr_py(path: str) -> np.ndarray:
    """Minimal scanline reader: HALF/FLOAT channels, NONE/ZIP/ZIPS."""
    with open(path, "rb") as f:
        data = f.read()
    if struct.unpack("<I", data[:4])[0] != 20000630:
        raise IOError(f"not an EXR file: {path}")
    pos = 8
    attrs = {}
    while data[pos] != 0:
        e = data.index(b"\0", pos)
        name = data[pos:e].decode()
        pos = e + 1
        e = data.index(b"\0", pos)
        typ = data[pos:e].decode()
        pos = e + 1
        (size,) = struct.unpack_from("<I", data, pos)
        pos += 4
        attrs[name] = (typ, data[pos:pos + size])
        pos += size
    pos += 1

    x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"][1])
    w, h = x1 - x0 + 1, y1 - y0 + 1
    comp = attrs["compression"][1][0]
    chs = []
    cdata = attrs["channels"][1]
    cpos = 0
    while cdata[cpos] != 0:
        e = cdata.index(b"\0", cpos)
        cname = cdata[cpos:e].decode()
        ptype = struct.unpack_from("<i", cdata, e + 1)[0]
        chs.append((cname, ptype))
        cpos = e + 17
    if comp not in (0, 2, 3):
        raise IOError(
            f"pure-Python EXR fallback cannot decode compression={comp} "
            f"(build the native shim for PIZ)"
        )
    lines_per_block = {0: 1, 2: 1, 3: 16}[comp]
    n_blocks = (h + lines_per_block - 1) // lines_per_block
    pos += 8 * n_blocks  # skip offset table (read sequentially)

    out = np.zeros((h, w, 3), np.float32)
    idx = {"R": 0, "G": 1, "B": 2}
    for _ in range(n_blocks):
        y, size = struct.unpack_from("<ii", data, pos)
        pos += 8
        raw = data[pos:pos + size]
        pos += size
        n_lines = min(lines_per_block, h - (y - y0))
        expect = sum(
            w * (2 if t == 1 else 4) for _, t in chs
        ) * n_lines
        if comp in (2, 3) and size != expect:
            raw = zlib.decompress(raw)
            buf = np.frombuffer(raw, np.uint8).astype(np.int16)
            buf = np.cumsum((buf - 128) % 256).astype(np.uint8)  # delta decode
            half_n = (len(buf) + 1) // 2
            inter = np.empty(len(buf), np.uint8)
            inter[0::2] = buf[:half_n]
            inter[1::2] = buf[half_n:]
            raw = inter.tobytes()
        off = 0
        for line in range(n_lines):
            for cname, ptype in chs:
                nbytes = w * (2 if ptype == 1 else 4)
                arr = np.frombuffer(
                    raw[off:off + nbytes],
                    np.float16 if ptype == 1 else np.float32,
                )
                off += nbytes
                if cname in idx:
                    out[y - y0 + line, :, idx[cname]] = arr.astype(np.float32)
    return out


# --------------------------------------------------------------------------
# Radiance HDR (.hdr) — RGBE, flat (non-RLE) scanlines
# --------------------------------------------------------------------------

def write_hdr(path: str, pixels: np.ndarray) -> None:
    img = np.asarray(pixels, np.float32)
    h, w = img.shape[:2]
    maxc = img.max(axis=-1)
    nz = maxc > 1e-32
    _, e = np.frexp(np.where(nz, maxc, 1.0))  # maxc = m * 2^e, m in [0.5, 1)
    scale = np.where(nz, 255.9999 / np.exp2(e.astype(np.float64)), 0.0)
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.clip(img * scale[..., None], 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(nz, e + 128, 0).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())


# --------------------------------------------------------------------------
# Unified export (reference exportImage semantics)
# --------------------------------------------------------------------------

def write_image(path: str, pixels: np.ndarray, exposure: float = 5.0) -> None:
    """Export as the reference's ``exportImage`` (``rayTracer.cpp:225-279``):
    float radiance for .exr/.hdr, tone-mapped 8-bit otherwise."""
    ext = os.path.splitext(path)[1].lower()
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    if ext == ".exr":
        write_exr(path, pixels)
    elif ext == ".hdr":
        write_hdr(path, pixels)
    else:
        from PIL import Image

        ldr = normalize_image(np.asarray(pixels), exposure)
        Image.fromarray(ldr, "RGB").save(path)
    print(f"Render succesfully saved to file {path}")
