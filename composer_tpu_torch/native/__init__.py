"""The host codec accelerator (C++, bound with ctypes), with pure-Python
fallbacks: the port's ``composer_tpu/native``.

The library is built with ``g++`` at first use (``loader.py``).
``available()`` says whether it built and loaded; when it did not, the
bindings raise ``RuntimeError`` and the callers take their Python paths.
"""

from composer_tpu_torch.native.loader import (
    crc32c,
    decode_event_ids,
    encode_event_pairs,
    load,
    parse_midi_arrays,
)


def available() -> bool:
    """Whether the native library is loaded (building it on the first call)."""
    return load() is not None


__all__ = ["available", "crc32c", "decode_event_ids", "encode_event_pairs",
           "parse_midi_arrays"]
