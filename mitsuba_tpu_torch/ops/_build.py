"""Build a native source of the port at first use and load it with ctypes.

``csrc/<name>.cu`` (a CUDA kernel with a plain C interface) compiles with
nvcc, ``csrc/<name>.cpp`` (host code) with g++, each into
``_build/<name>-<hash>.so``.  The hash covers the source, every shared
header ``csrc/*.cuh`` and the flags, so editing a source or a header it
may include rebuilds.  No PyTorch header is included, which keeps a
build at seconds rather than minutes.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas=-v")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = (os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME
            else shutil.which("nvcc"))
    if not nvcc or not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return nvcc


def _source(name: str) -> Path:
    for ext in (".cu", ".cpp"):
        if (CSRC / f"{name}{ext}").exists():
            return CSRC / f"{name}{ext}"
    raise FileNotFoundError(f"no csrc/{name}.cu or csrc/{name}.cpp")


def _command(src: Path, out: Path) -> list[str]:
    if src.suffix == ".cu":
        return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(src)]
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the host BVH builder needs it")
    return [gxx, *GXX_FLAGS, str(src), "-o", str(out)]


def library_path(name: str) -> Path:
    src = _source(name)
    flags = NVCC_FLAGS if src.suffix == ".cu" else GXX_FLAGS
    h = hashlib.sha256(" ".join(flags).encode() + src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` or ``.cpp`` unless its library exists.
    Returns the compiler's log (for nvcc the ptxas register and spill
    report), empty when nothing was built; raises if the compiler fails."""
    out = library_path(name)
    if out.exists():
        return ""
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp")
    src = _source(name)
    proc = subprocess.run(_command(src, tmp), stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"build of {src.name} failed:\n{proc.stdout}")
    os.replace(tmp, out)
    return proc.stdout


def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>``, building it if needed."""
    if name not in _loaded:
        build(name)
        _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return _loaded[name]
