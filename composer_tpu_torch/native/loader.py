"""Builds the host codec library at first use and binds it with ctypes.

``fastcodec.cpp`` (the port's copy of ``composer_tpu/native/fastcodec.cpp``)
is compiled by ``g++`` into ``build/native`` at the repository root (ignored
by git, beside the CUDA kernels' ``build/kernels``), named after a hash of
the source, the compiler and the flags, so that an edited source is rebuilt.
Concurrent first uses (several test workers, preprocessing workers) each
build into a temporary file and ``os.replace`` it into place.

Where there is no compiler, or the build or the load fails, ``load`` logs
one WARNING and returns None: the callers (``midi/serialization.py``,
``midi/midi_io.py``, ``data/tfrecord.py``) then take their pure-Python
paths, as the JAX package's do.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "fastcodec.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
COMPILER = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

# None: not tried yet; False: the build or the load failed (logged once).
_LIBRARY = None
_LOCK = threading.Lock()  # loader threads (load_event_ids) may arrive together


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join((COMPILER, *CXX_FLAGS)).encode())
    return BUILD_DIR / f"libfastcodec-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compiles ``SOURCE`` unless an up-to-date library exists; raises
    ``RuntimeError`` when the compiler is missing or fails."""
    target = library_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        partial = Path(tmp) / target.name
        try:
            result = subprocess.run([COMPILER, *CXX_FLAGS, str(SOURCE), "-o", str(partial)],
                                    capture_output=True, text=True)
        except OSError as error:
            raise RuntimeError(f"{COMPILER} could not run: {error}") from error
        if result.returncode != 0:
            raise RuntimeError(f"{COMPILER} failed to build {SOURCE}:\n{result.stderr}")
        os.replace(partial, target)
    return target


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.composer_crc32c.restype = ctypes.c_uint32
    lib.composer_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    for name in ("composer_decode_event_ids", "composer_encode_event_pairs"):
        getattr(lib, name).restype = ctypes.c_int
        getattr(lib, name).argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int32,
                                       ctypes.c_int32, ctypes.c_void_p]
    lib.composer_midi_parse.restype = ctypes.c_void_p
    lib.composer_midi_parse.argtypes = [ctypes.c_char_p, ctypes.c_size_t] + [
        ctypes.POINTER(ctypes.c_int64)] * 3
    lib.composer_midi_fill.restype = ctypes.c_int
    lib.composer_midi_fill.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 11
    lib.composer_midi_release.restype = None
    lib.composer_midi_release.argtypes = [ctypes.c_void_p]
    return lib


def load():
    """The bound library, built on the first call; None (after one WARNING)
    when it cannot be built or loaded."""
    global _LIBRARY
    with _LOCK:
        if _LIBRARY is None:
            try:
                _LIBRARY = _bind(ctypes.CDLL(str(build())))
            except (RuntimeError, OSError, AttributeError) as error:
                logging.getLogger(__name__).warning(
                    "The native codec is unavailable, so the pure-Python paths run: %s", error)
                _LIBRARY = False
        return _LIBRARY or None


def _library() -> ctypes.CDLL:
    lib = load()
    if lib is None:
        raise RuntimeError("the native codec library is not available")
    return lib


def crc32c(data: bytes) -> int:
    return _library().composer_crc32c(bytes(data), len(data))


def decode_event_ids(pairs: np.ndarray, velocity_bins: int, max_time_steps: int) -> np.ndarray:
    """(N, 2) int16 (type, value) pairs -> (N,) int32 vocab ids."""
    pairs = np.ascontiguousarray(pairs, dtype=np.int16)
    if pairs.ndim != 2 or pairs.shape[1] != 2:
        raise ValueError(f"expected (N, 2) event pairs, got shape {pairs.shape}")
    out = np.empty(pairs.shape[0], dtype=np.int32)
    status = _library().composer_decode_event_ids(
        pairs.ctypes.data, pairs.shape[0], velocity_bins, max_time_steps, out.ctypes.data)
    if status != 0:
        raise ValueError("unknown event type in .data stream")
    return out


def encode_event_pairs(ids: np.ndarray, velocity_bins: int, max_time_steps: int) -> np.ndarray:
    """(N,) int32 vocab ids -> (N, 2) int16 (type, value) pairs."""
    ids = np.ascontiguousarray(ids, dtype=np.int32)
    if ids.ndim != 1:
        raise ValueError(f"expected (N,) event ids, got shape {ids.shape}")
    out = np.empty((ids.shape[0], 2), dtype=np.int16)
    status = _library().composer_encode_event_pairs(
        ids.ctypes.data, ids.shape[0], velocity_bins, max_time_steps, out.ctypes.data)
    if status != 0:
        raise ValueError("event id outside vocabulary")
    return out


_MIDI_ARRAYS = (  # composer_midi_fill's outputs, in its argument order
    ("program", np.int32, 0), ("is_drum", np.int32, 0), ("note_counts", np.int64, 0),
    ("control_counts", np.int64, 0), ("note_start", np.float64, 1),
    ("note_end", np.float64, 1), ("note_pitch", np.int32, 1), ("note_velocity", np.int32, 1),
    ("control_time", np.float64, 2), ("control_number", np.int32, 2),
    ("control_value", np.int32, 2),
)


def parse_midi_arrays(data: bytes):
    """SMF bytes -> flattened instrument/note/control arrays (seconds).

    Returns a dict of NumPy arrays grouped by instrument, or ``None`` when the
    native parser rejects the input (malformed files fall back to the Python
    parser so the caller raises the usual exceptions). Semantics mirror
    ``composer_tpu_torch.midi.midi_io.parse_midi`` exactly.
    """
    lib = _library()
    sizes = [ctypes.c_int64() for _ in range(3)]  # instruments, notes, controls
    handle = lib.composer_midi_parse(bytes(data), len(data), *map(ctypes.byref, sizes))
    if not handle:
        return None
    try:
        out = {name: np.empty(int(sizes[which].value), dtype)
               for name, dtype, which in _MIDI_ARRAYS}
        if lib.composer_midi_fill(handle, *(out[name].ctypes.data
                                            for name, _, _ in _MIDI_ARRAYS)) != 0:
            return None
        return out
    finally:
        lib.composer_midi_release(handle)
