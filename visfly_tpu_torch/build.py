"""Build the package's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library with a
plain C interface, in a directory named by the hash of its source, the
shared headers (``csrc/*.cuh``) and the flags, under ``build/kernels/`` at
the repository root (``build/`` is git-ignored). A library already built
from the same sources is reused. A build that fails raises; nothing falls
back. ``build_all`` starts one ``nvcc`` per source, all at once.

The mesh SDF baker, ``native/mesh_sdf.cpp`` (framework-free C++, shared with
the JAX package), builds the same way with the host compiler into
``build/native/`` (:func:`build_native`); nothing is written under
``native/``.

    python -m visfly_tpu_torch.build      # build every kernel, print ptxas info
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NATIVE_SRC = os.path.join(os.path.dirname(_PKG), "native")
NATIVE_ROOT = os.path.join(os.path.dirname(_PKG), "build", "native")
# the flags of native/Makefile, so that both packages bake the same grids;
# -fopenmp only spreads the grid's cells over threads and is dropped where the
# compiler has no OpenMP runtime (every cell is computed on its own, so the
# grid is the same)
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-shared")
# --fmad=false: every operation rounds as in the plain PyTorch version.
# With contraction on, one-ulp differences in the slab divisions of grazing
# rays moved t by up to 2.1e-3 m (H100, 1 M camera rays of the bench).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.isfile(path):
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return path


def library_path(name: str) -> str:
    """Where ``csrc/<name>.cu`` builds to, keyed by its content, the shared
    headers' and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [os.path.join(CSRC, f"{name}.cu"), *sorted(glob.glob(os.path.join(CSRC, "*.cuh")))]:
        with open(path, "rb") as f:
            h.update(f.read())
    digest = h.hexdigest()[:16]
    return os.path.join(BUILD_ROOT, f"{name}-{digest}", f"lib{name}.so")


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless it is built already; returns the
    library path. The compiler's output (ptxas register and shared-memory
    counts) is kept beside the library as ``build.log``."""
    lib = library_path(name)
    if os.path.isfile(lib):
        return lib
    out_dir = os.path.dirname(lib)
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.{threading.get_ident()}.tmp"  # one a building thread
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    with open(os.path.join(out_dir, "build.log"), "w") as f:
        f.write(proc.stdout + proc.stderr)
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    return lib


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    return ctypes.CDLL(build(name))


def _host_compiler() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise RuntimeError("no C++ compiler: put g++ on PATH or set CXX")
    return cxx


@functools.lru_cache(maxsize=None)
def has_openmp(cxx: str) -> bool:
    """Whether the compiler ``cxx`` links an empty program with ``-fopenmp``."""
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "probe.cpp")
        with open(src, "w") as f:
            f.write("int main() { return 0; }\n")
        cmd = [cxx, "-fopenmp", src, "-o", os.path.join(tmp, "probe")]
        return subprocess.run(cmd, capture_output=True).returncode == 0


def build_native(name: str = "mesh_sdf") -> str:
    """Compile ``native/<name>.cpp`` with the host C++ compiler (``$CXX`` or
    ``g++``) unless it is built already; returns the library path. OpenMP is
    used where the compiler has it (``build.log`` beside the library says
    which). A compiler that is missing or fails raises."""
    src = os.path.join(NATIVE_SRC, f"{name}.cpp")
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(src, "rb") as f:
        h.update(f.read())
    lib = os.path.join(NATIVE_ROOT, f"{name}-{h.hexdigest()[:16]}", f"lib{name}.so")
    if os.path.isfile(lib):
        return lib
    os.makedirs(os.path.dirname(lib), exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.{threading.get_ident()}.tmp"  # one a building thread
    cxx = _host_compiler()
    openmp = has_openmp(cxx)
    cmd = [cxx, *CXX_FLAGS, *(["-fopenmp"] if openmp else []), src, "-o", tmp]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} failed for {name} ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    with open(os.path.join(os.path.dirname(lib), "build.log"), "w") as f:
        f.write(f"{' '.join(cmd)}\nOpenMP: {'yes' if openmp else 'no'}\n")
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def load_native(name: str = "mesh_sdf") -> ctypes.CDLL:
    """The loaded library of ``native/<name>.cpp``, built first if needed."""
    return ctypes.CDLL(build_native(name))


def kernel_names() -> list:
    return sorted(os.path.splitext(os.path.basename(p))[0]
                  for p in glob.glob(os.path.join(CSRC, "*.cu")))


def build_all() -> dict:
    """Build and load every kernel and the mesh baker, the compilers running
    side by side; returns {name: (seconds, build log)}, the baker as
    ``mesh_sdf``."""
    jobs = {name: (build, load_library) for name in kernel_names()}
    jobs["mesh_sdf"] = (build_native, load_native)

    def one(name):
        t0 = time.perf_counter()
        lib = jobs[name][0](name)
        with open(os.path.join(os.path.dirname(lib), "build.log")) as f:
            return time.perf_counter() - t0, f.read()

    with concurrent.futures.ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        out = dict(zip(jobs, pool.map(one, jobs)))
    for name, (_, load) in jobs.items():
        load(name)
    return out


if __name__ == "__main__":
    for kname, (secs, log) in build_all().items():
        print(f"{kname}: {secs:.1f} s\n{log}")
