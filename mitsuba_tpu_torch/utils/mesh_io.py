"""Triangle-mesh files to numpy (mitsuba_tpu/utils/mesh_io.py; reference
src/shapes/{obj,ply,serialized}.cpp): OBJ, PLY (ASCII and binary
little-endian) and Mitsuba's ``.serialized`` container.

Each loader returns (vertices (V, 3) float32, faces (F, 3) int32,
normals (V, 3) | None, uvs (V, 2) | None), as the JAX package's do;
polygons are fan-triangulated.  ``utils/load.py`` makes ``Mesh`` es of
them on the chosen device.  A binary PLY's records are read as one numpy
structured array when its faces are all triangles (the common case),
record by record otherwise; the values are the same either way.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np


def load_obj(path):
    """Wavefront OBJ: v / vn / vt and polygonal f with v, v/vt, v//vn,
    v/vt/vn corners; negative indices count back from the last vertex.
    Corners that carry a normal or a uv are expanded to unshared vertices,
    as the JAX package does."""
    vs, vns, vts = [], [], []
    f_v, f_vt, f_vn = [], [], []
    with open(path, "r", errors="replace") as fh:
        for line in fh:
            if line.startswith("v "):
                vs.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("vn "):
                vns.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("vt "):
                vts.append([float(x) for x in line.split()[1:3]])
            elif line.startswith("f "):
                idx = []
                for t in line.split()[1:]:
                    parts = t.split("/")
                    idx.append((int(parts[0]),
                                int(parts[1]) if len(parts) > 1 and parts[1]
                                else 0,
                                int(parts[2]) if len(parts) > 2 and parts[2]
                                else 0))
                for k in range(1, len(idx) - 1):   # fan triangulation
                    for vi, ti, ni in (idx[0], idx[k], idx[k + 1]):
                        f_v.append(vi)
                        f_vt.append(ti)
                        f_vn.append(ni)

    def rebase(i, n):
        i = np.asarray(i, np.int64)
        return np.where(i > 0, i - 1, n + i)

    v = np.asarray(vs, np.float32)
    fv = rebase(f_v, len(vs))
    n_corner = uv_corner = None
    if vns and any(f_vn):
        n_corner = np.asarray(vns, np.float32)[rebase(f_vn, len(vns))]
    if vts and any(f_vt):
        uv_corner = np.asarray(vts, np.float32)[rebase(f_vt, len(vts))]
    if n_corner is not None or uv_corner is not None:
        return (v[fv].astype(np.float32),
                np.arange(fv.shape[0], dtype=np.int32).reshape(-1, 3),
                n_corner, uv_corner)
    return v, fv.reshape(-1, 3).astype(np.int32), None, None


_PLY_TYPES = {"char": "i1", "uchar": "u1", "short": "i2", "ushort": "u2",
              "int": "i4", "uint": "u4", "int8": "i1", "uint8": "u1",
              "int16": "i2", "uint16": "u2", "int32": "i4", "uint32": "u4",
              "float": "f4", "double": "f8", "float32": "f4",
              "float64": "f8"}


def _ply_columns(arr, names):
    """(vertices, normals | None, uvs | None) from the vertex columns."""
    def cols(keys):
        return arr[:, [names.index(c) for c in keys]]

    normals = cols(("nx", "ny", "nz")) if all(
        c in names for c in ("nx", "ny", "nz")) else None
    uvs = cols(("u", "v")) if all(c in names for c in ("u", "v")) else None
    return cols("xyz"), normals, uvs


def _fan(polys):
    return [[p[0], p[j], p[j + 1]] for p in polys for j in range(1, len(p) - 1)]


def load_ply(path):
    """PLY, ASCII 1.0 or binary_little_endian 1.0: the vertex element's
    x / y / z (and nx / ny / nz, u / v where present) and the face
    element's first property, a list of vertex indices.  Other elements
    are skipped.  A binary_big_endian file raises ``IOError``."""
    with open(path, "rb") as fh:
        header = []
        while True:
            line = fh.readline()
            if not line:
                raise IOError(f"{path}: a PLY header without end_header")
            line = line.decode("ascii", errors="replace").strip()
            header.append(line)
            if line == "end_header":
                break
        fmt = next(ln.split()[1] for ln in header if ln.startswith("format"))
        if fmt not in ("ascii", "binary_little_endian"):
            raise IOError(f"{path}: {fmt} PLY files are not supported "
                          "(ascii and binary_little_endian are)")
        elements = []   # (name, count, [(type | ("list", cnt, idx), name)])
        for line in header:
            t = line.split()
            if t and t[0] == "element":
                elements.append((t[1], int(t[2]), []))
            elif t and t[0] == "property":
                elements[-1][2].append(
                    (("list", t[2], t[3]), t[4]) if t[1] == "list"
                    else (t[1], t[2]))
        body = fh.read()
    verts = normals = uvs = None
    faces = []
    if fmt == "ascii":
        lines = iter(body.decode("ascii", errors="replace").splitlines())
        for name, count, props in elements:
            rows = [next(lines).split() for _ in range(count)]
            if name == "vertex":
                verts, normals, uvs = _ply_columns(
                    np.asarray(rows, np.float32), [p[1] for p in props])
            elif name == "face":
                faces = _fan([[int(x) for x in r[1:1 + int(r[0])]]
                              for r in rows])
    else:
        pos = 0
        for name, count, props in elements:
            if not any(isinstance(p[0], tuple) for p in props):
                dt = np.dtype([(n, "<" + _PLY_TYPES[k]) for k, n in props])
                rec = np.frombuffer(body, dt, count=count, offset=pos)
                pos += dt.itemsize * count
                if name == "vertex":
                    names = [p[1] for p in props]
                    arr = np.stack([rec[n].astype(np.float32)
                                    for n in names], axis=1)
                    verts, normals, uvs = _ply_columns(arr, names)
                continue
            faces_here, pos = _ply_lists(body, pos, count, props)
            if name == "face":
                faces = faces_here
    return (verts.astype(np.float32),
            np.asarray(faces, np.int32).reshape(-1, 3),
            None if normals is None else normals.astype(np.float32),
            None if uvs is None else uvs.astype(np.float32))


def _ply_lists(body, pos, count, props):
    """The fan-triangulated first property of ``count`` binary records
    (which holds a list; another element's lists are skipped), and the
    offset past them.  All-triangle records of a single list property are
    read at once."""
    if len(props) == 1 and count:
        _, cnt_t, idx_t = props[0][0]
        cnt_c, idx_c = "<" + _PLY_TYPES[cnt_t], "<" + _PLY_TYPES[idx_t]
        dt = np.dtype([("n", cnt_c), ("i", idx_c, (3,))])
        if len(body) - pos >= dt.itemsize * count:
            rec = np.frombuffer(body, dt, count=count, offset=pos)
            if (rec["n"] == 3).all():
                return (rec["i"].astype(np.int64),
                        pos + dt.itemsize * count)
    polys = []
    for _ in range(count):
        for k, (kind, _) in enumerate(props):
            if isinstance(kind, tuple):
                cnt = np.dtype("<" + _PLY_TYPES[kind[1]])
                n = int(np.frombuffer(body, cnt, count=1, offset=pos)[0])
                pos += cnt.itemsize
                dt = np.dtype("<" + _PLY_TYPES[kind[2]])
                if k == 0:
                    polys.append(np.frombuffer(body, dt, count=n,
                                               offset=pos).tolist())
                pos += dt.itemsize * n
            else:
                pos += np.dtype(_PLY_TYPES[kind]).itemsize
    return _fan(polys), pos


def load_mesh_file(path):
    p = str(path)
    if p.lower().endswith(".obj"):
        return load_obj(p)
    if p.lower().endswith(".ply"):
        return load_ply(p)
    raise ValueError(f"unsupported mesh format: {p}")


# ------------------------------------------------------- .serialized format

_SER_MAGIC = 0x041C
_SER_HAS_NORMALS = 0x0001
_SER_HAS_TEXCOORDS = 0x0002
_SER_HAS_COLORS = 0x0008
_SER_FACE_NORMALS = 0x0010
_SER_SINGLE = 0x1000
_SER_DOUBLE = 0x2000


def load_serialized(path, shape_index: int = 0):
    """One mesh of a Mitsuba ``.serialized`` container
    (src/shapes/serialized.cpp): per mesh a little-endian uint16 magic
    0x041C and uint16 version, then a zlib stream of [flags u32][name
    (version 4), NUL-terminated][vertex count u64][face count u64]
    [positions][normals?][uvs?][colors?][faces u32]; the footer is [offset
    u64 x count][count u32].  Colors are read and dropped."""
    with open(path, "rb") as fh:
        data = fh.read()
    (count,) = struct.unpack_from("<I", data, len(data) - 4)
    if not 0 <= shape_index < count:
        raise ValueError(f"{path}: shape_index {shape_index} of {count}")
    table = len(data) - 4 - 8 * count
    (start,) = struct.unpack_from("<Q", data, table + 8 * shape_index)
    magic, version = struct.unpack_from("<HH", data, start)
    if magic != _SER_MAGIC:
        raise IOError(f"{path}: not a .serialized mesh (magic {magic:#x})")
    end = (struct.unpack_from("<Q", data, table + 8 * (shape_index + 1))[0]
           if shape_index + 1 < count else table)
    raw = zlib.decompress(data[start + 4:end])
    (flags,) = struct.unpack_from("<I", raw, 0)
    pos = 4
    if version >= 4:
        pos = raw.index(b"\0", pos) + 1
    vc, fc = struct.unpack_from("<QQ", raw, pos)
    pos += 16
    dt = np.float64 if flags & _SER_DOUBLE else np.float32

    def arr(n, width):
        nonlocal pos
        a = np.frombuffer(raw, dt, count=n * width, offset=pos)
        pos += n * width * np.dtype(dt).itemsize
        return a.astype(np.float32).reshape(n, width)

    v = arr(vc, 3)
    n = arr(vc, 3) if flags & _SER_HAS_NORMALS else None
    uv = arr(vc, 2) if flags & _SER_HAS_TEXCOORDS else None
    if flags & _SER_HAS_COLORS:
        arr(vc, 3)
    f = np.frombuffer(raw, np.uint32, count=3 * fc,
                      offset=pos).astype(np.int32).reshape(fc, 3)
    if flags & _SER_FACE_NORMALS:
        n = None
    return v, f, n, uv


def write_serialized(path, meshes):
    """Write meshes, a list of (v, f, n | None, uv | None), as a version-4
    ``.serialized`` container."""
    blobs = []
    for v, f, n, uv in meshes:
        flags = _SER_SINGLE | (_SER_HAS_NORMALS if n is not None else 0) \
            | (_SER_HAS_TEXCOORDS if uv is not None else 0)
        payload = (struct.pack("<I", flags) + b"mesh\0"
                   + struct.pack("<QQ", v.shape[0], f.shape[0])
                   + np.asarray(v, np.float32).tobytes()
                   + (np.asarray(n, np.float32).tobytes()
                      if n is not None else b"")
                   + (np.asarray(uv, np.float32).tobytes()
                      if uv is not None else b"")
                   + np.asarray(f, np.uint32).tobytes())
        blobs.append(struct.pack("<HH", _SER_MAGIC, 4)
                     + zlib.compress(payload))
    offsets, at = [], 0
    for b in blobs:
        offsets.append(at)
        at += len(b)
    with open(path, "wb") as fh:
        fh.write(b"".join(blobs) + struct.pack(f"<{len(offsets)}Q", *offsets)
                 + struct.pack("<I", len(blobs)))


def write_ply(path, vertices, faces, normals=None):
    """A binary little-endian PLY of float vertices (and normals) and
    triangle faces (uchar counts, int indices), as exporters write
    them."""
    v = np.asarray(vertices, np.float32)
    cols = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    if normals is not None:
        cols += [("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4")]
    rec = np.empty(v.shape[0], np.dtype(cols))
    for i, c in enumerate("xyz"):
        rec[c] = v[:, i]
    if normals is not None:
        for i, c in enumerate(("nx", "ny", "nz")):
            rec[c] = np.asarray(normals, np.float32)[:, i]
    f = np.asarray(faces)
    frec = np.empty(f.shape[0], np.dtype([("n", "u1"), ("i", "<i4", (3,))]))
    frec["n"] = 3
    frec["i"] = f
    props = "".join(f"property float {c}\n" for c, _ in cols)
    head = (f"ply\nformat binary_little_endian 1.0\nelement vertex "
            f"{v.shape[0]}\n{props}element face {f.shape[0]}\nproperty list "
            "uchar int vertex_indices\nend_header\n").encode("ascii")
    with open(path, "wb") as fh:
        fh.write(head + rec.tobytes() + frec.tobytes())


def write_obj(path, vertices, faces):
    """An OBJ of the vertices and (1-based) triangle faces."""
    v, f = np.asarray(vertices, np.float32), np.asarray(faces) + 1
    with open(path, "w") as fh:
        fh.write("".join(f"v {a:.9g} {b:.9g} {c:.9g}\n" for a, b, c in v))
        fh.write("".join(f"f {a} {b} {c}\n" for a, b, c in f))
