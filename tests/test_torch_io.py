"""The port's image and mesh files against mitsuba_tpu on the CPU.

Images: a file one package writes, the other reads equal, and both read a
third party's file equal (PIL's PNGs of every row filter, OpenCV's PFM
and Radiance HDR files).  Where OpenCV is built without OpenEXR, the JAX
package reads and writes no EXR (tests/test_load.py's round trip
skips); the port's EXR codec is held against files that
``_exr`` below writes from the OpenEXR file layout (scanline chunks,
channels in name order, the ZIP predictor and byte split), HALF and FLOAT
channels under NONE, ZIPS and ZIP, and against its own writer.  Meshes:
OBJ, ASCII and binary PLY and ``.serialized`` files written here, read
by both packages equal."""
import os
import struct
import zlib

import numpy as np
import pytest

from mitsuba_tpu.utils import bitmap as jbitmap
from mitsuba_tpu.utils import mesh_io as jmesh_io
from mitsuba_tpu_torch.utils import bitmap, mesh_io

os.environ.setdefault("OPENCV_IO_ENABLE_OPENEXR", "1")


def _rng(k=0):
    return np.random.default_rng(20 + k)


# ------------------------------------------------------------------ PNG

def _png(path, img, filters):
    """An 8-bit PNG of (H, W, C) uint8 whose row y takes the filter
    filters[y % len(filters)] (PNG spec section 9), written byte by
    byte."""
    h, w, c = img.shape
    rows, prior = [], bytes(w * c)
    for y in range(h):
        raw, kind = img[y].tobytes(), filters[y % len(filters)]
        out = bytearray([kind])
        for i, x in enumerate(raw):
            a = raw[i - c] if i >= c else 0
            b = prior[i]
            cc = prior[i - c] if i >= c else 0
            if kind == 4:
                p = a + b - cc
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else cc)
            else:
                pred = [0, a, b, (a + b) // 2][kind]
            out.append((x - pred) & 0xFF)
        rows.append(bytes(out))
        prior = raw

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    color = {1: 0, 3: 2, 4: 6}[c]
    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n"
                 + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0,
                                              0, 0))
                 + chunk(b"IDAT", zlib.compress(b"".join(rows)))
                 + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_every_filter_matches_jax(tmp_path, channels):
    """Rows under each of the five filters, gray, RGB and RGBA: the port
    reads what PIL reads (linear and sRGB-encoded)."""
    img = _rng(channels).integers(0, 256, (23, 17, channels), np.uint8)
    img[5:9] = img[5]   # runs that Up and Paeth see as small differences
    path = str(tmp_path / "f.png")
    _png(path, img, [0, 1, 2, 3, 4])
    for linear in (True, False):
        got = bitmap.read_image(path, to_linear=linear)
        assert np.array_equal(got, jbitmap.read_image(path, to_linear=linear))
    rgb = np.repeat(img, 3, axis=2) if channels == 1 else img[..., :3]
    assert np.array_equal(bitmap.read_image(path, False), rgb / np.float32(255))


def test_png_both_ways(tmp_path):
    """The port's PNG read by the JAX package and the JAX package's read by
    the port, equal; PIL's own files (its adaptive filters) too."""
    from PIL import Image

    img = _rng(1).uniform(0.0, 1.2, (19, 27, 3)).astype(np.float32)
    a, b, c = (str(tmp_path / f"{k}.png") for k in "abc")
    bitmap.write_image(a, img)
    jbitmap.write_image(b, img)
    for p in (a, b):
        assert np.array_equal(bitmap.read_image(p), jbitmap.read_image(p))
    with open(a, "rb") as fa, open(b, "rb") as fb:
        ia, ib = fa.read(), fb.read()
    assert np.array_equal(bitmap._read_png(ia, a), bitmap._read_png(ib, b))
    smooth = np.stack(np.meshgrid(np.arange(40) * 6, np.arange(30) * 8), -1)
    Image.fromarray(np.concatenate([smooth, smooth[..., :1]], -1)
                    .astype(np.uint8)).save(c, optimize=True)
    assert np.array_equal(bitmap.read_image(c), jbitmap.read_image(c))


# ------------------------------------------------------- PFM and HDR

@pytest.mark.parametrize("ext,shape", [(".pfm", (13, 11, 3)),
                                       (".pfm", (9, 7)), (".hdr", (6, 5, 3)),
                                       (".hdr", (20, 300, 3))])
def test_float_files_match_jax(tmp_path, ext, shape):
    """OpenCV's PFM (RGB, gray) and Radiance HDR (flat below 8 pixels a
    row, run-length coded above, with runs) files: both packages read
    them equal."""
    import cv2

    img = _rng(2).uniform(0.0, 4.0, shape).astype(np.float32)
    if shape[1] == 300:
        img[:, :100] = 1.5
    path = str(tmp_path / f"i{ext}")
    assert cv2.imwrite(path, img[..., ::-1] if img.ndim == 3 else img)
    got = bitmap.read_image(path)
    assert np.array_equal(got, jbitmap.read_image(path))
    if ext == ".pfm":
        assert np.array_equal(got, img)


# -------------------------------------------------------------- OpenEXR

def _exr(path, img, pixel_type, compression):
    """An OpenEXR scanline file of (H, W, C) channels R, G, B(, A)
    (pixel_type 1 HALF, 2 FLOAT; compression 0 NONE, 2 ZIPS, 3 ZIP)."""
    h, w, c = img.shape
    names = ["R", "G", "B", "A"][:c]
    order = sorted(range(c), key=lambda i: names[i])
    dt = {1: "<f2", 2: "<f4"}[pixel_type]

    def attr(name, kind, value):
        return (name.encode() + b"\0" + kind.encode() + b"\0"
                + struct.pack("<i", len(value)) + value)

    chlist = b"".join(names[i].encode() + b"\0"
                      + struct.pack("<i", pixel_type) + bytes(4)
                      + struct.pack("<ii", 1, 1) for i in order) + b"\0"
    box = struct.pack("<4i", 0, 0, w - 1, h - 1)
    head = (struct.pack("<ii", 20000630, 2) + attr("channels", "chlist", chlist)
            + attr("compression", "compression", bytes([compression]))
            + attr("dataWindow", "box2i", box)
            + attr("displayWindow", "box2i", box)
            + attr("lineOrder", "lineOrder", bytes([0]))
            + attr("pixelAspectRatio", "float", struct.pack("<f", 1))
            + attr("screenWindowCenter", "v2f", struct.pack("<ff", 0, 0))
            + attr("screenWindowWidth", "float", struct.pack("<f", 1)) + b"\0")
    lines = 16 if compression == 3 else 1
    chunks = []
    for y0 in range(0, h, lines):
        raw = b"".join(img[y, :, i].astype(dt).tobytes()
                       for y in range(y0, min(h, y0 + lines)) for i in order)
        if compression:
            split = raw[0::2] + raw[1::2]
            pred = bytes([split[0]]) + bytes(
                (split[k] - split[k - 1] + 128) & 0xFF
                for k in range(1, len(split)))
            packed = zlib.compress(pred)
            raw = packed if len(packed) < len(raw) else raw
        chunks.append(struct.pack("<ii", y0, len(raw)) + raw)
    offsets, at = [], len(head) + 8 * len(chunks)
    for ch in chunks:
        offsets.append(at)
        at += len(ch)
    with open(path, "wb") as fh:
        fh.write(head + struct.pack(f"<{len(chunks)}Q", *offsets)
                 + b"".join(chunks))


@pytest.mark.parametrize("pixel_type", [1, 2], ids=["half", "float"])
@pytest.mark.parametrize("compression", [0, 2, 3], ids=["NONE", "ZIPS", "ZIP"])
def test_exr_read(tmp_path, pixel_type, compression):
    """Each compression and pixel type: FLOAT exactly, HALF within 1 ulp
    of half of the float data (the write rounds it once); constant rows
    make the ZIP blocks smaller than raw, noise rows store some raw."""
    img = _rng(3).uniform(-2.0, 8.0, (37, 21, 3)).astype(np.float32)
    img[10:20] = 0.75
    path = str(tmp_path / "i.exr")
    _exr(path, img, pixel_type, compression)
    got = bitmap.read_image(path)
    if pixel_type == 2:
        assert np.array_equal(got, img)
    else:
        half = img.astype(np.float16)
        assert np.array_equal(got, half.astype(np.float32))
        ulp = np.spacing(np.abs(half)).astype(np.float32)
        assert (np.abs(got - img) <= ulp).all()


def test_exr_write_both_ways(tmp_path):
    """The port's EXR (FLOAT, ZIP) read back bit for bit, RGB, RGBA and
    one channel; the same file read by the JAX package where its OpenCV
    reads EXR (an OpenCV built without OpenEXR raises IOError)."""
    img = _rng(4).uniform(0.0, 100.0, (35, 18, 4)).astype(np.float32)
    for data in (img[..., :3], img, img[..., 0]):
        path = str(tmp_path / "o.exr")
        bitmap.write_image(path, data)
        assert np.array_equal(bitmap.read_image(path), data)
    path = str(tmp_path / "rgb.exr")
    bitmap.write_image(path, img[..., :3])
    try:
        theirs = jbitmap.read_image(path)
    except IOError:
        return
    assert np.array_equal(theirs, img[..., :3])


def test_unsupported_files_raise(tmp_path):
    """PIZ, a tiled EXR, JPEG and an interlaced PNG raise IOError naming
    what they are."""
    img = np.ones((4, 4, 3), np.float32)
    path = str(tmp_path / "p.exr")
    _exr(path, img, 2, 0)
    with open(path, "rb") as fh:
        data = bytearray(fh.read())
    at = data.index(b"compression\0compression\0") + 28
    data[at] = 4
    with open(path, "wb") as fh:
        fh.write(bytes(data))
    with pytest.raises(IOError, match="PIZ"):
        bitmap.read_image(path)
    data[at] = 0
    data[5] |= 0x02   # the version field's tiled bit (0x200)
    with open(path, "wb") as fh:
        fh.write(bytes(data))
    with pytest.raises(IOError, match="tiled"):
        bitmap.read_image(path)
    with pytest.raises(IOError, match="jpg"):
        bitmap.read_image(str(tmp_path / "x.jpg"))
    png = str(tmp_path / "i.png")
    bitmap.write_image(png, img)
    with open(png, "rb") as fh:
        data = bytearray(fh.read())
    data[28] = 1   # IHDR's interlace byte
    with open(png, "wb") as fh:
        fh.write(bytes(data))
    with pytest.raises(IOError, match="interlaced"):
        bitmap.read_image(png)


# --------------------------------------------------------------- meshes

def _same_mesh(got, want):
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is not None:
            assert g.dtype == w.dtype and np.array_equal(g, w)


def test_obj_matches_jax(tmp_path):
    """An OBJ with a quad and a pentagon (fan-triangulated), negative
    indices, and v/vt/vn corners; and one of plain triangles written by
    the port."""
    path = tmp_path / "m.obj"
    path.write_text(
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0.5 1.5 0.25\n"
        "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
        "vn 0 0 1\nvn 0 0.6 0.8\n"
        "f 1/1/1 2/2/1 3/3/2 4/4/2\n"
        "f -5/1/1 -4/2/2 -3/3/1 -2/4/2 -1/1/1\n")
    _same_mesh(mesh_io.load_obj(str(path)), jmesh_io.load_obj(str(path)))
    r = _rng(5)
    v = r.normal(size=(30, 3)).astype(np.float32)
    f = r.integers(0, 30, (40, 3))
    mesh_io.write_obj(str(tmp_path / "t.obj"), v, f)
    got = mesh_io.load_obj(str(tmp_path / "t.obj"))
    _same_mesh(got, jmesh_io.load_obj(str(tmp_path / "t.obj")))
    assert np.array_equal(got[0], v) and np.array_equal(got[1], f)


def test_ply_matches_jax(tmp_path):
    """Binary little-endian PLY (the port's writer, and a polygonal one
    with normals, uvs and a double column) and ASCII PLY; a big-endian
    file raises."""
    r = _rng(6)
    v = r.normal(size=(50, 3)).astype(np.float32)
    n = r.normal(size=(50, 3)).astype(np.float32)
    f = r.integers(0, 50, (60, 3))
    path = str(tmp_path / "w.ply")
    mesh_io.write_ply(path, v, f, n)
    got = mesh_io.load_ply(path)
    _same_mesh(got, jmesh_io.load_ply(path))
    assert np.array_equal(got[0], v) and np.array_equal(got[1], f)
    head = ("ply\nformat binary_little_endian 1.0\nelement vertex 5\n"
            "property float x\nproperty float y\nproperty double z\n"
            "property float nx\nproperty float ny\nproperty float nz\n"
            "property float u\nproperty float v\nelement face 2\n"
            "property list uchar int vertex_indices\nend_header\n")
    rec = np.zeros(5, [("x", "<f4"), ("y", "<f4"), ("z", "<f8"),
                       ("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4"),
                       ("u", "<f4"), ("v", "<f4")])
    for k in rec.dtype.names:
        rec[k] = r.uniform(size=5)
    faces = struct.pack("<B4i", 4, 0, 1, 2, 3) + struct.pack("<B3i", 3, 2, 3,
                                                             4)
    path = str(tmp_path / "q.ply")
    with open(path, "wb") as fh:
        fh.write(head.encode() + rec.tobytes() + faces)
    _same_mesh(mesh_io.load_ply(path), jmesh_io.load_ply(path))
    path = str(tmp_path / "a.ply")
    with open(path, "w") as fh:
        fh.write("ply\nformat ascii 1.0\nelement vertex 4\nproperty float x\n"
                 "property float y\nproperty float z\nelement face 1\n"
                 "property list uchar int vertex_indices\nend_header\n"
                 "0 0 0\n1 0 0\n1 1 0.5\n0 1 0\n4 0 1 2 3\n")
    _same_mesh(mesh_io.load_ply(path), jmesh_io.load_ply(path))
    path = str(tmp_path / "b.ply")
    with open(path, "w") as fh:
        fh.write("ply\nformat binary_big_endian 1.0\nelement vertex 0\n"
                 "property float x\nend_header\n")
    with pytest.raises(IOError, match="big_endian"):
        mesh_io.load_ply(path)


def test_serialized_both_ways(tmp_path):
    """A ``.serialized`` container of two meshes, each package's writer
    read by both loaders equal, every shape index."""
    r = _rng(7)
    v = r.random((10, 3)).astype(np.float32)
    f = r.integers(0, 10, (6, 3)).astype(np.int32)
    n = r.random((10, 3)).astype(np.float32)
    uv = r.random((10, 2)).astype(np.float32)
    meshes = [(v, f, n, uv), (v * 2.0, f, None, None)]
    for k, write in enumerate((mesh_io.write_serialized,
                               jmesh_io.write_serialized)):
        path = str(tmp_path / f"{k}.serialized")
        write(path, meshes)
        for i in (0, 1):
            got = mesh_io.load_serialized(path, i)
            _same_mesh(got, jmesh_io.load_serialized(path, i))
            _same_mesh(got, meshes[i])
