"""Image files in and out (mitsuba_tpu/utils/bitmap.py; reference
src/core/bitmap.cpp): ``read_image`` and ``write_image``, with their
codecs written here in numpy and the standard library (``zlib``,
``struct``), so that the port needs no imaging package.

Formats:

- PNG: 8-bit gray, RGB and RGBA, not interlaced, every row filter.  Read
  as (H, W, 3) RGB (gray repeated, alpha dropped) in [0, 1], turned
  linear through the sRGB transfer unless ``to_linear=False``; written
  through the sRGB transfer, 8 bits, unfiltered rows.
- PFM: gray ("Pf") or RGB ("PF"), either byte order.
- Radiance ``.hdr``: RGBE pixels, flat or run-length coded scanlines
  (new-style RLE), the "-Y H +X W" orientation; a channel is m 2^(e-136)
  as OpenCV decodes it.
- OpenEXR: single-part scanline files of HALF, FLOAT or UINT channels,
  compression NONE, ZIPS or ZIP; channels R, G, B (A kept as a fourth
  channel) or one channel of any name.  Written as FLOAT with ZIP
  compression.

Float images come back as (H, W, 3) or, for one channel, (H, W), as the
JAX package's reads (OpenCV) give them.  Any other format, compression or
layout (JPEG, PIZ, a tiled EXR, an interlaced PNG) raises ``IOError``
naming it.
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_EXR_MAGIC = 20000630
_EXR_COMPRESSION = {0: "NONE", 1: "RLE", 2: "ZIPS", 3: "ZIP", 4: "PIZ",
                    5: "PXR24", 6: "B44", 7: "B44A", 8: "DWAA", 9: "DWAB"}
_EXR_LINES = {0: 1, 2: 1, 3: 16}   # scanlines a chunk, by compression
_EXR_TYPES = {0: np.dtype("<u4"), 1: np.dtype("<f2"), 2: np.dtype("<f4")}


def srgb_to_linear(x):
    x = np.asarray(x, np.float32)
    return np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)


def linear_to_srgb(x):
    x = np.asarray(x, np.float32)
    x = np.clip(x, 0.0, None)
    return np.where(
        x <= 0.0031308, 12.92 * x, 1.055 * np.power(x, 1.0 / 2.4) - 0.055
    )


def read_image(path, to_linear: bool = True):
    """An image file -> (H, W, C) float32 (a one-channel float file:
    (H, W)); 8-bit files are turned linear through the sRGB transfer
    unless ``to_linear`` is False (bitmap.cpp convert())."""
    p = str(path)
    ext = os.path.splitext(p)[1].lower()
    with open(p, "rb") as fh:
        data = fh.read()
    if ext == ".exr":
        return _read_exr(data, p)
    if ext == ".hdr":
        return _read_hdr(data, p)
    if ext == ".pfm":
        return _read_pfm(data, p)
    if ext == ".png":
        img = _read_png(data, p).astype(np.float32) / 255.0
        return srgb_to_linear(img) if to_linear else img
    raise IOError(f"{p}: the {ext or 'extensionless'} format is not "
                  "supported (PNG, PFM, Radiance HDR and OpenEXR are)")


def write_image(path, img, from_linear: bool = True):
    """Write (H, W, C) float32 (or (H, W)): an EXR keeps linear float
    (FLOAT channels, ZIP compression); a PNG is tonemapped through the
    sRGB transfer unless ``from_linear`` is False (bitmap.cpp write())."""
    p = str(path)
    img = np.asarray(img, np.float32)
    ext = os.path.splitext(p)[1].lower()
    if ext == ".exr":
        data = _encode_exr(img)
    elif ext == ".png":
        ldr = linear_to_srgb(img) if from_linear else np.clip(img, 0, 1)
        data = _encode_png((np.clip(ldr, 0.0, 1.0) * 255.0 + 0.5)
                           .astype(np.uint8))
    else:
        raise IOError(f"{p}: writing {ext or 'extensionless'} files is not "
                      "supported (OpenEXR and PNG are)")
    with open(p, "wb") as fh:
        fh.write(data)


# ------------------------------------------------------------------- PNG

def _read_png(data, p):
    """The (H, W, 3) uint8 RGB of an 8-bit gray, RGB or RGBA PNG."""
    if not data.startswith(_PNG_MAGIC):
        raise IOError(f"{p}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (n,), kind = struct.unpack_from(">I", data, pos), data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise IOError(f"{p}: a PNG file without its IHDR chunk")
    w, h, depth, color, _, _, interlace = hdr
    channels = {0: 1, 2: 3, 6: 4}.get(color)
    if channels is None:
        what = {3: "palette", 4: "gray-alpha"}.get(color, f"type {color}")
        raise IOError(f"{p}: {what} PNG files are not supported (8-bit "
                      "gray, RGB and RGBA are)")
    if depth != 8:
        raise IOError(f"{p}: {depth}-bit PNG files are not supported (8-bit "
                      "ones are)")
    if interlace:
        raise IOError(f"{p}: interlaced (Adam7) PNG files are not supported")
    raw = zlib.decompress(b"".join(idat))
    stride = w * channels
    rows = np.frombuffer(raw, np.uint8, count=h * (stride + 1)).reshape(
        h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        out[y] = prior = _unfilter(int(rows[y, 0]), rows[y, 1:], prior,
                                   channels, p)
    img = out.reshape(h, w, channels)
    if channels == 1:
        return np.repeat(img, 3, axis=2)
    return img[..., :3]


def _unfilter(kind, row, prior, bpp, p):
    """One scanline with its filter (PNG spec section 9) undone."""
    if kind == 0:
        return row
    if kind == 2:
        return row + prior                       # uint8 wraps mod 256
    if kind == 1:
        return np.cumsum(row.reshape(-1, bpp), axis=0, dtype=np.uint8) \
            .reshape(-1)
    if kind not in (3, 4):
        raise IOError(f"{p}: unknown PNG row filter {kind}")
    x, b = bytearray(row.tobytes()), prior.tobytes()
    for i in range(len(x)):
        a = x[i - bpp] if i >= bpp else 0
        if kind == 3:
            x[i] = (x[i] + ((a + b[i]) >> 1)) & 0xFF
            continue
        c = b[i - bpp] if i >= bpp else 0
        pa, pb, pc = abs(b[i] - c), abs(a - c), abs(a + b[i] - 2 * c)
        pred = a if pa <= pb and pa <= pc else (b[i] if pb <= pc else c)
        x[i] = (x[i] + pred) & 0xFF
    return np.frombuffer(bytes(x), np.uint8)


def _png_chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _encode_png(img):
    """An 8-bit PNG of (H, W), (H, W, 1), (H, W, 3) or (H, W, 4) uint8."""
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    color = {1: 0, 3: 2, 4: 6}[c]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * c)],
                          axis=1)
    return (_PNG_MAGIC
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0,
                                              0, 0))
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _png_chunk(b"IEND", b""))


# ------------------------------------------------------------------- PFM

def _read_pfm(data, p):
    fields, pos = [], 0
    while len(fields) < 4:   # "PF"/"Pf", width, height, scale
        while data[pos:pos + 1].isspace():
            pos += 1
        end = pos
        while not data[end:end + 1].isspace():
            end += 1
        fields.append(data[pos:end].decode("ascii"))
        pos = end
    pos += 1   # the single whitespace before the raster
    channels = {"PF": 3, "Pf": 1}.get(fields[0])
    if channels is None:
        raise IOError(f"{p}: not a PFM file")
    w, h, scale = int(fields[1]), int(fields[2]), float(fields[3])
    dt = np.dtype("<f4" if scale < 0 else ">f4")
    img = np.frombuffer(data, dt, count=w * h * channels, offset=pos)
    img = img.reshape(h, w, channels)[::-1].astype(np.float32)
    return img[..., 0] if channels == 1 else img


# ---------------------------------------------------------- Radiance HDR

def _read_hdr(data, p):
    if not data.startswith((b"#?RADIANCE", b"#?RGBE")):
        raise IOError(f"{p}: not a Radiance HDR file")
    pos = data.index(b"\n") + 1
    while True:   # header lines up to the blank line
        end = data.index(b"\n", pos)
        line = data[pos:end].decode("ascii", "replace").strip()
        pos = end + 1
        if not line:
            break
        if line.startswith("FORMAT=") and line != "FORMAT=32-bit_rle_rgbe":
            raise IOError(f"{p}: the {line[7:]} pixel format is not "
                          "supported (32-bit_rle_rgbe is)")
    end = data.index(b"\n", pos)
    res = data[pos:end].decode("ascii").split()
    pos = end + 1
    if len(res) != 4 or res[0] != "-Y" or res[2] != "+X":
        raise IOError(f"{p}: the orientation {' '.join(res)!r} is not "
                      "supported (-Y H +X W is)")
    h, w = int(res[1]), int(res[3])
    buf = np.frombuffer(data, np.uint8, offset=pos)
    rgbe = np.empty((h, w, 4), np.uint8)
    at = 0
    for y in range(h):
        head = buf[at:at + 4]
        if not (8 <= w < 0x8000 and head[0] == 2 and head[1] == 2
                and not head[2] & 0x80):
            # flat pixels: the rest of the file, four bytes a pixel
            flat = buf[at:at + 4 * w * (h - y)].reshape(h - y, w, 4)
            rgbe[y:] = flat
            break
        if (int(head[2]) << 8 | int(head[3])) != w:
            raise IOError(f"{p}: a run-length scanline of the wrong width")
        at += 4
        for c in range(4):   # each component's runs in turn
            x = 0
            while x < w:
                n = int(buf[at])
                if n > 128:
                    rgbe[y, x:x + n - 128, c] = buf[at + 1]
                    x += n - 128
                    at += 2
                else:
                    rgbe[y, x:x + n, c] = buf[at + 1:at + 1 + n]
                    x += n
                    at += 1 + n
    e = rgbe[..., 3:4].astype(np.int32)
    f = np.where(e > 0, np.ldexp(np.float32(1.0), e - 136), 0.0)
    return (rgbe[..., :3].astype(np.float64) * f).astype(np.float32)


# --------------------------------------------------------------- OpenEXR

def _read_exr(data, p):
    magic, version = struct.unpack_from("<ii", data, 0)
    if magic != _EXR_MAGIC:
        raise IOError(f"{p}: not an OpenEXR file")
    if version & 0x200:
        raise IOError(f"{p}: tiled OpenEXR files are not supported "
                      "(scanline ones are)")
    if version & 0x1800:
        raise IOError(f"{p}: deep or multi-part OpenEXR files are not "
                      "supported")
    pos, attrs = 8, {}
    while data[pos] != 0:
        name_end = data.index(b"\0", pos)
        type_end = data.index(b"\0", name_end + 1)
        (size,) = struct.unpack_from("<i", data, type_end + 1)
        start = type_end + 5
        attrs[data[pos:name_end].decode()] = data[start:start + size]
        pos = start + size
    pos += 1
    comp = attrs["compression"][0]
    if comp not in _EXR_LINES:
        raise IOError(f"{p}: {_EXR_COMPRESSION.get(comp, comp)} compression "
                      "is not supported (NONE, ZIPS and ZIP are)")
    channels, at, raw = [], 0, attrs["channels"]
    while raw[at] != 0:
        end = raw.index(b"\0", at)
        kind, _, xs, ys = struct.unpack_from("<iB3xii", raw, end + 1)
        if (xs, ys) != (1, 1):
            raise IOError(f"{p}: subsampled channels are not supported")
        channels.append((raw[at:end].decode(), _EXR_TYPES[kind]))
        at = end + 17
    x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"])
    w, h = x1 - x0 + 1, y1 - y0 + 1
    lines = _EXR_LINES[comp]
    n_chunks = (h + lines - 1) // lines
    offsets = struct.unpack_from(f"<{n_chunks}Q", data, pos)
    row_bytes = sum(w * dt.itemsize for _, dt in channels)
    planes = {name: np.empty((h, w), np.float32) for name, _ in channels}
    for off in offsets:
        y, size = struct.unpack_from("<ii", data, off)
        n = min(lines, y1 + 1 - y)
        block = data[off + 8:off + 8 + size]
        if size < n * row_bytes:
            block = _zip_decode(block)
        at = 0
        for row in range(y - y0, y - y0 + n):
            for name, dt in channels:
                planes[name][row] = np.frombuffer(block, dt, count=w,
                                                  offset=at)
                at += w * dt.itemsize
    names = [name for name, _ in channels]
    if {"R", "G", "B"} <= set(names):
        keep = ["R", "G", "B"] + (["A"] if "A" in names else [])
        return np.stack([planes[k] for k in keep], axis=-1)
    if len(names) == 1:
        return planes[names[0]]
    raise IOError(f"{p}: the channels {names} are not supported (R, G, B "
                  "with an optional A, or one channel)")


def _zip_decode(block):
    """A ZIP / ZIPS chunk's bytes: inflate, undo the predictor, then put
    back the bytes the encoder split into even and odd halves."""
    d = np.frombuffer(zlib.decompress(block), np.uint8).astype(np.int64)
    d[1:] -= 128                  # each byte stored as a difference + 128
    t = np.cumsum(d) & 0xFF
    half = (len(t) + 1) // 2
    out = np.empty(len(t), np.uint8)
    out[0::2] = t[:half]
    out[1::2] = t[half:]
    return out.tobytes()


def _zip_encode(raw):
    """The inverse of ``_zip_decode``: split even and odd bytes, apply the
    predictor, deflate."""
    b = np.frombuffer(raw, np.uint8)
    t = np.concatenate([b[0::2], b[1::2]]).astype(np.int64)
    d = t.copy()
    d[1:] = (t[1:] - t[:-1] + 128 + 256) & 0xFF
    return zlib.compress(d.astype(np.uint8).tobytes(), 6)


def _attr(name, kind, value):
    return name.encode() + b"\0" + kind.encode() + b"\0" + \
        struct.pack("<i", len(value)) + value


def _encode_exr(img):
    """A single-part scanline OpenEXR of FLOAT channels, ZIP compression,
    16 lines a chunk: (H, W) or (H, W, 1) as channel Y, (H, W, 3) as R,
    G, B, (H, W, 4) as R, G, B, A; channels stored in name order."""
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    names = {1: ["Y"], 3: ["R", "G", "B"], 4: ["R", "G", "B", "A"]}[c]
    order = sorted(range(c), key=lambda i: names[i])
    chlist = b"".join(names[i].encode() + b"\0"
                      + struct.pack("<iB3xii", 2, 0, 1, 1)
                      for i in order) + b"\0"
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header = (struct.pack("<ii", _EXR_MAGIC, 2)
              + _attr("channels", "chlist", chlist)
              + _attr("compression", "compression", bytes([3]))
              + _attr("dataWindow", "box2i", box)
              + _attr("displayWindow", "box2i", box)
              + _attr("lineOrder", "lineOrder", bytes([0]))
              + _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
              + _attr("screenWindowCenter", "v2f", struct.pack("<ff", 0, 0))
              + _attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
              + b"\0")
    planar = np.ascontiguousarray(
        img[..., order].astype("<f4").transpose(0, 2, 1))   # (H, C, W)
    chunks = []
    for y in range(0, h, 16):
        raw = planar[y:y + 16].tobytes()
        packed = _zip_encode(raw)
        body = packed if len(packed) < len(raw) else raw
        chunks.append(struct.pack("<ii", y, len(body)) + body)
    table_end = len(header) + 8 * len(chunks)
    offsets, at = [], table_end
    for ch in chunks:
        offsets.append(at)
        at += len(ch)
    return (header + struct.pack(f"<{len(chunks)}Q", *offsets)
            + b"".join(chunks))
