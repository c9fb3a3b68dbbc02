"""Builds the port's CUDA kernels at first use and loads them with ctypes.

The sources under ``composer_tpu_torch/csrc`` are compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface (no PyTorch
headers, so a build takes seconds). The library lands in ``build/kernels``
at the repository root (ignored by git), named after a hash of its source
and flags so that an edited source is rebuilt.
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


def _library_path(name: str, source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(name: str = "decode_generate") -> Path:
    """Compiles ``csrc/<name>.cu`` unless an up-to-date library exists."""
    source = CSRC / f"{name}.cu"
    target = _library_path(name, source)
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


def load_library(name: str = "decode_generate") -> ctypes.CDLL:
    """The built library, with ``argtypes`` declared for its entry point."""
    lib = _LIBRARIES.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn = lib.decode_generate
        fn.restype = i32
        fn.argtypes = (
            [i32, i32] + [ptr] * 23 + [i32] * 13
            + [ctypes.c_uint, ctypes.c_float, ctypes.c_float, ptr]
        )
        _LIBRARIES[name] = lib
    return lib
