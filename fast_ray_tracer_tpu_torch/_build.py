"""Build the port's native sources into shared libraries at first use.

Two kinds of library, both loaded with ctypes through a plain C interface:
- the CUDA kernels, one library per `csrc/<name>.cu`, compiled with nvcc
  for sm_90a into build/kernels/;
- the host C++ walks of `native/` (OBJ scan, BVH-divide simulation, PNG
  scanline reconstruction), compiled with g++ into build/native/.

A library's file name carries a hash of its sources and flags, so an edit
rebuilds it and an unchanged tree reuses it. Builds write to a temporary
name and rename, so concurrent processes never load a half-written file.
A failed build raises with the compiler's output. No CUDA kernel falls
back: a failed nvcc build raises to the kernel's caller. Only the host
C++ walks do: `native.available()` catches their build's error, and the
scene compiler then takes the Python walks.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

PACKAGE = Path(__file__).resolve().parent
BUILD = PACKAGE.parent / "build"

# --fmad=false: nvcc would otherwise contract a*b + c into an FMA, and the
# kernels are held bit for bit to plain torch versions whose elementwise
# ops round every product. Division stays IEEE (no --use_fast_math).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas=-v", "-shared",
              "-Xcompiler", "-fPIC")
# -ffp-contract=off: the divide walk is held bit for bit to the Python one
GXX_FLAGS = ("-O3", "-ffp-contract=off", "-std=c++17", "-fPIC", "-shared")

CUDA_SOURCES = ("compact", "mesh", "gather", "photon")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _spec(name: str):
    """(library path, command without -o) of library `name`."""
    if name == "native":
        srcs = [PACKAGE / "native" / "obj_core.cpp",
                PACKAGE / "native" / "divide_core.cpp",
                PACKAGE / "native" / "png_core.cpp"]
        cmd, flags, out = ["g++"], GXX_FLAGS, BUILD / "native"
    elif name in CUDA_SOURCES:
        srcs = [PACKAGE / "csrc" / f"{name}.cu"]
        cmd, flags, out = [_nvcc()], NVCC_FLAGS, BUILD / "kernels"
    else:
        raise ValueError(f"no library named {name!r}")
    h = hashlib.sha256(" ".join(flags).encode())
    for s in srcs:
        h.update(s.read_bytes())
    so = out / f"libfrt_{name}_{h.hexdigest()[:16]}.so"
    return so, [*cmd, *flags, *map(str, srcs)]


def build(*names: str) -> Dict[str, Path]:
    """Build the named libraries that are not built yet, all compilers
    running at once; return {name: path}. The compiler's diagnostics
    (for nvcc, ptxas's register and shared-memory report) are kept
    beside each library as <library>.log."""
    paths, running = {}, []
    for name in names:
        so, cmd = _spec(name)
        paths[name] = so
        if so.exists():
            continue
        so.parent.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen([*cmd, "-o", str(tmp)], stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((name, so, tmp, proc))
    failed = []
    for name, so, tmp, proc in running:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{out}")
            continue
        so.with_name(so.name + ".log").write_text(out)
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("build failed: " + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The library `name`, built first if needed (loaded once)."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(str(build(name)[name]))
    return _loaded[name]
