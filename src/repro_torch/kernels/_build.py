"""Build the CUDA sources in ``csrc/`` at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o .build/<name>-<hash>.so csrc/<name>.cu

The ``.so`` lands in ``kernels/.build/`` (listed in ``.gitignore``) under a
name keyed by a hash of the sources, so an edited source rebuilds and an
unchanged one loads.  `build_all` starts one ``nvcc`` per source at once and
waits for all of them.  Nothing here runs at import time.

Every C entry point returns ``cudaGetLastError()`` after its launch; the
wrappers raise through `check` when it is not 0.  ``LAUNCHES`` counts the
launches of each kernel entry: a wrapper adds one where it launches its
kernel and nowhere else.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / ".build"
SOURCES = ("modmatmul", "kmeans_assign", "delta_gemm", "bucketed_modmatmul")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

#: launch count per kernel entry, read by ``ops.launch_counts``
LAUNCHES = {"modmatmul_u8": 0, "modmatmul_u32": 0, "kmeans_assign": 0,
            "delta_gemm": 0, "add_delta": 0, "bucketed_modmatmul": 0}

_LIBS: dict[str, ctypes.CDLL] = {}
_P = ctypes.c_void_p
_I = ctypes.c_int64
#: C signature of every exported function: (argtypes,), restype is int
_SIGNATURES = {
    "modmatmul": {"modmatmul_u8": (_P, _P, _P, _I, _I, _I, _P),
                  "modmatmul_u32": (_P, _P, _P, _I, _I, _I, _P)},
    "kmeans_assign": {"kmeans_assign_f32": (_P, _P, _P, _P, _I, _I, _I, _P)},
    "delta_gemm": {"delta_gemm_u8": (_P, _P, _P, _P, _I, _I, _I, _P),
                   "add_delta_u32": (_P, _P, _I, _P)},
    "bucketed_modmatmul": {
        "bucketed_modmatmul_u8": (_P, _I, _P, _P, _I, _I, _I, _P),
        "bucketed_modmatmul_tile_rows": ()},
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def _lib_path(name: str) -> pathlib.Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(ARCH_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all() -> float:
    """Compile every missing library in parallel; return the seconds taken."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in SOURCES:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{name}: nvcc exit {proc.returncode}\n"
                          f"{log.decode(errors='replace')}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        if not _lib_path(name).exists():
            build_all()
        lib = ctypes.CDLL(str(_lib_path(name)))
        for fn, argtypes in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def check(code: int, what: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")


def stream_ptr(device) -> int:
    """The current torch stream of ``device`` as a raw pointer value."""
    import torch
    return torch.cuda.current_stream(device).cuda_stream
