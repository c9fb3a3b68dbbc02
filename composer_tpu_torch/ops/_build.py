"""Builds the port's CUDA kernels at first use and loads them with ctypes.

The sources under ``composer_tpu_torch/csrc`` are compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface (no PyTorch
headers, so a build takes seconds). The library lands in ``build/kernels``
at the repository root (ignored by git), named after a hash of its source,
the shared headers and the flags, so that an edited source is rebuilt.
Processes that reach a first build together (the ranks of a mesh) each
compile into a temporary directory of their own and ``os.replace`` the
result onto the same name: the rename is atomic, so a library is never seen
half written, and a process that loaded the first copy keeps its mapping.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PACKAGE = Path(__file__).resolve().parents[1]
CSRC = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBRARIES: dict = {}
# name -> {"seconds": build time (0.0 when the library was already built),
#          "log": compiler output including ptxas register/shared-memory use}
BUILD_INFO: dict = {}


def _nvcc() -> str:
    for candidate in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if candidate and os.path.exists(candidate):
            return candidate
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _library_path(name: str, csrc: Path) -> Path:
    # The shared headers are part of every source's digest: an edited header
    # rebuilds the libraries that include it.
    headers = b"".join(path.read_bytes() for path in sorted(csrc.glob("*.cuh")))
    digest = hashlib.sha256((csrc / f"{name}.cu").read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(name: str = "decode_generate", csrc: Path | None = None) -> Path:
    """Compiles ``<csrc>/<name>.cu`` (``csrc`` defaults to ``CSRC``) unless
    an up-to-date library exists."""
    csrc = CSRC if csrc is None else Path(csrc)
    source = csrc / f"{name}.cu"
    target = _library_path(name, csrc)
    if target.exists():
        BUILD_INFO.setdefault(name, {"seconds": 0.0, "log": ""})
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    start = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        partial = Path(tmp) / target.name
        result = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(partial), str(source)],
            capture_output=True, text=True,
        )
        if result.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {source}:\n{result.stderr}")
        os.replace(partial, target)
    BUILD_INFO[name] = {"seconds": time.perf_counter() - start,
                        "log": result.stdout + result.stderr}
    return target


def build_all(names) -> None:
    """Builds several libraries at once, one ``nvcc`` process each."""
    from concurrent.futures import ThreadPoolExecutor

    names = list(names)
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        for future in [pool.submit(build, name) for name in names]:
            future.result()


_PTR, _I32, _U32, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
# One entry per ``csrc/<name>.cu``: its C entry points and their argtypes
# (every entry point returns the ``cudaError_t`` of its launch as an int).
ENTRY_POINTS = {
    "decode_generate": {
        "decode_generate": (
            [_I32, _I32] + [_PTR] * 23 + [_I32] * 13 + [_U32, _F32, _F32, _I32, _PTR]
        ),
        "decode_generate_clusters": [_I32] * 8 + [_PTR],
    },
    "decode_segment": {
        "decode_segment": (
            [_I32, _I32] + [_PTR] * 24 + [_I32] * 13 + [_U32, _F32, _F32, _I32, _PTR]
        ),
        "decode_segment_clusters": [_I32] * 8 + [_PTR],
    },
    "decode_wide": {
        "decode_wide": [_I32] * 4 + [_PTR] * 27 + [_I32] * 13 + [_U32, _F32, _F32, _PTR],
    },
    "decode_wide_segment": {
        "decode_wide_segment": [_I32] * 3 + [_PTR] * 25 + [_I32] * 14 + [_U32, _F32, _F32, _PTR],
    },
    "spec_decode": {
        "spec_decode": (
            [_I32, _I32] + [_PTR] * 18 + [_I32] * 11 + [_U32] + [_F32] * 5 + [_I32] * 3
            + [_PTR] * 2
        ),
        "spec_decode_clusters": [_I32] * 11 + [_PTR],
    },
    "flash_attention": {
        "flash_attention_forward": (
            [_I32, _I32] + [_PTR] * 7 + [_I32] * 6 + [_F32, _U32, _F32, _I32, _PTR]
        ),
        "flash_attention_backward": (
            [_I32, _I32] + [_PTR] * 12 + [_I32] * 6 + [_F32, _U32, _F32, _I32, _PTR]
        ),
    },
}


def load_library(name: str = "decode_generate") -> ctypes.CDLL:
    """The built library ``name``, with ``argtypes`` declared for each entry
    point listed in ``ENTRY_POINTS[name]``."""
    lib = _LIBRARIES.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        for symbol, argtypes in ENTRY_POINTS[name].items():
            fn = getattr(lib, symbol)
            fn.restype = _I32
            fn.argtypes = argtypes
        _LIBRARIES[name] = lib
    return lib
