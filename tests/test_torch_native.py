"""The port's native codec (``composer_tpu_torch/native``) against the JAX
package's (``composer_tpu/native``) and against the port's own Python paths:
CRC32-C, the bulk id codec and the SMF parser, array for array. Also where
the library is built (``build/native``, never inside the package) and the
fallback to the Python paths, with one warning, when the build fails."""

import logging
from pathlib import Path

import numpy as np
import pytest

from composer_tpu.midi import midi_io as jax_midi_io
from composer_tpu.native import loader as jax_native
from composer_tpu_torch import native
from composer_tpu_torch.data import tfrecord
from composer_tpu_torch.exceptions import EncodingError
from composer_tpu_torch.midi import midi_io, serialization
from composer_tpu_torch.midi.events import Note, NoteSequence, SustainPeriod
from composer_tpu_torch.midi.vocab import get_vocabulary
from composer_tpu_torch.native import loader

REPO = Path(__file__).resolve().parents[1]
FIXTURES = sorted((Path(__file__).parent / "fixtures" / "pretty_midi").glob("*.mid"))


def _python_crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for byte in data:
        crc = (crc >> 8) ^ tfrecord._CRC_TABLE_LIST[(crc ^ byte) & 0xFF]
    return crc ^ 0xFFFFFFFF


def test_the_library_is_built_under_build_not_in_the_package():
    assert native.available()
    path = loader.library_path()
    assert path.parent == REPO / "build" / "native" and path.exists()
    assert not list((REPO / "composer_tpu_torch").rglob("*.so"))
    assert (loader.SOURCE.read_bytes().split(b"#include <cstdint>")[1]
            == (REPO / "composer_tpu" / "native" / "fastcodec.cpp").read_bytes()
            .split(b"#include <cstdint>")[1])  # the original's code, only the header differs


def test_crc32c_known_vector():
    # RFC 3720 test vector: 32 bytes of zeros -> 0x8A9136AA.
    assert native.crc32c(b"\x00" * 32) == 0x8A9136AA
    # "123456789" -> 0xE3069283.
    assert native.crc32c(b"123456789") == 0xE3069283


def test_crc32c_matches_the_original_and_python(rng):
    for size in [0, 1, 7, 8, 9, 63, 1024, 4097]:
        data = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
        assert native.crc32c(data) == jax_native.crc32c(data) == _python_crc32c(data)


def test_id_codec_matches_the_original_and_the_vocabulary(rng):
    vocab = get_vocabulary(10, 100, 32)
    ids = rng.integers(0, vocab.size, 1000).astype(np.int32)

    pairs = native.encode_event_pairs(ids, 32, 100)
    np.testing.assert_array_equal(pairs, jax_native.encode_event_pairs(ids, 32, 100))
    types, values = vocab.decode_ids(ids)
    np.testing.assert_array_equal(pairs[:, 0], types)
    np.testing.assert_array_equal(pairs[:, 1], values)  # None is -1 in both

    back = native.decode_event_ids(pairs, 32, 100)
    np.testing.assert_array_equal(back, jax_native.decode_event_ids(pairs, 32, 100))
    np.testing.assert_array_equal(back, ids)
    np.testing.assert_array_equal(serialization._pairs_to_ids(pairs, vocab),
                                  vocab.encode_pairs(pairs[:, 0], pairs[:, 1]))


def test_decode_rejects_bad_type():
    bad = np.array([[99, 0]], dtype=np.int16)
    with pytest.raises(ValueError):
        native.decode_event_ids(bad, 32, 100)
    with pytest.raises(EncodingError):
        serialization._pairs_to_ids(bad, get_vocabulary(10, 100, 32))
    with pytest.raises(ValueError):
        native.encode_event_pairs(np.array([10_000], np.int32), 32, 100)
    # Shapes the C loops would read past are refused before the call.
    with pytest.raises(ValueError, match="shape"):
        native.decode_event_ids(np.zeros(4, np.int16), 32, 100)
    with pytest.raises(ValueError, match="shape"):
        native.encode_event_pairs(np.zeros((2, 2), np.int32), 32, 100)


# --------------------------------------------------------------- SMF parser

def _varlen(value):
    chunks = [value & 0x7F]
    value >>= 7
    while value:
        chunks.append(0x80 | (value & 0x7F))
        value >>= 7
    return bytes(reversed(chunks))


def _track(events):
    """events: list of (delta, message bytes). Appends end-of-track."""
    body = b"".join(_varlen(d) + m for d, m in events)
    body += _varlen(0) + bytes([0xFF, 0x2F, 0x00])
    return b"MTrk" + len(body).to_bytes(4, "big") + body


def _gnarly_smf():
    """tests/test_native.py's file: tempo changes mid-stream, running status,
    vel-0 note-offs, program changes mid-track, a zero-length note, several
    channels and tracks, drums."""
    def tempo(us):
        return bytes([0xFF, 0x51, 0x03]) + us.to_bytes(3, "big")

    t0 = _track([(0, tempo(500000)), (0, bytes([0x90, 60, 100])), (240, bytes([62, 90])),
                 (240, bytes([60, 0])), (0, tempo(250000)), (480, bytes([0x80, 62, 64])),
                 (0, bytes([0xB0, 64, 100])), (480, bytes([0xB0, 64, 20]))])
    t1 = _track([(0, bytes([0xC1, 42])), (10, bytes([0x91, 70, 80])),
                 (0, bytes([0x91, 70, 70])), (0, bytes([0x81, 70, 0])),
                 (100, bytes([0x81, 70, 0])), (0, bytes([0xC1, 7])),
                 (50, bytes([0x91, 71, 60])), (50, bytes([0x81, 71, 0])),
                 (0, bytes([0x99, 36, 90])), (60, bytes([0x89, 36, 0]))])
    header = b"MThd" + (6).to_bytes(4, "big") + (1).to_bytes(2, "big")
    return header + (2).to_bytes(2, "big") + (480).to_bytes(2, "big") + t0 + t1


def _assert_same_arrays(ours, theirs):
    assert ours is not None and theirs is not None
    assert set(ours) == set(theirs)
    for key in theirs:
        assert ours[key].dtype == theirs[key].dtype, key
        np.testing.assert_array_equal(ours[key], theirs[key], err_msg=key)


@pytest.mark.parametrize("source", ["gnarly"] + [f.name for f in FIXTURES])
def test_parse_midi_arrays_matches_the_original(source):
    data = _gnarly_smf() if source == "gnarly" else \
        (FIXTURES[0].parent / source).read_bytes()
    ours = native.parse_midi_arrays(data)
    _assert_same_arrays(ours, jax_native.parse_midi_arrays(data))
    # and the port's Python parser, which read_note_arrays falls back to
    _assert_same_arrays(ours, midi_io._parsed_arrays_from_midifile(midi_io.parse_midi(data)))
    if source == "gnarly":
        assert ours["note_counts"].tolist() == [2, 2, 1, 1]
        assert ours["is_drum"].tolist() == [0, 0, 0, 1]
        assert ours["program"].tolist() == [0, 42, 7, 0]


def test_parse_midi_arrays_randomized_roundtrip(rng, tmp_path):
    """Random NoteSequences written by the port's writer parse identically
    through the port's native parser, the JAX one and the Python one."""
    for index in range(5):
        count = int(rng.integers(1, 120))
        t, notes = 0.0, []
        for _ in range(count):
            duration = float(rng.integers(10, 900))
            notes.append(Note(t, t + duration, int(rng.integers(0, 128)),
                              int(rng.integers(1, 128))))
            t += float(rng.integers(0, 400))
        periods = [SustainPeriod(0.0, max(t / 2, 1.0)), SustainPeriod(t / 2 + 10, t + 20)]
        path = tmp_path / f"fuzz{index}.mid"
        NoteSequence(notes, periods).to_midi(str(path))
        raw = path.read_bytes()
        ours = native.parse_midi_arrays(raw)
        _assert_same_arrays(ours, jax_native.parse_midi_arrays(raw))
        _assert_same_arrays(ours, midi_io._parsed_arrays_from_midifile(midi_io.parse_midi(raw)))


def test_parse_midi_arrays_rejects_garbage(tmp_path):
    assert native.parse_midi_arrays(b"not a midi file") is None
    assert native.parse_midi_arrays(b"") is None
    # The reader then runs the Python parser, which raises its usual error.
    path = tmp_path / "garbage.mid"
    path.write_bytes(b"not a midi file")
    with pytest.raises(Exception) as ours:
        midi_io.read_note_arrays(path)
    with pytest.raises(Exception) as theirs:
        jax_midi_io.read_note_arrays(path)
    assert type(ours.value).__name__ == type(theirs.value).__name__


def test_read_note_arrays_matches_the_original(tmp_path):
    """The reader, on the native parser, gives the JAX reader's arrays."""
    path = tmp_path / "g.mid"
    path.write_bytes(_gnarly_smf())
    ours, theirs = midi_io.read_note_arrays(path), jax_midi_io.read_note_arrays(path)
    for mine, original in zip(ours, theirs):
        np.testing.assert_array_equal(mine, original)
    sequence = midi_io.read_note_sequence(path)
    assert len(ours[0]) == len(sequence.notes) and 36 not in ours[2].tolist()


@pytest.mark.parametrize("compiler", ["missing", "fails"])
def test_a_failed_build_falls_back_with_one_warning(compiler, monkeypatch, tmp_path, caplog,
                                                     rng):
    monkeypatch.setattr(loader, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(loader, "COMPILER",
                        str(tmp_path / "no-such-g++") if compiler == "missing" else "false")
    monkeypatch.setattr(loader, "_LIBRARY", None)
    with caplog.at_level(logging.WARNING, logger=loader.__name__):
        assert not native.available()
        assert not native.available()
        with pytest.raises(RuntimeError):
            native.crc32c(b"x")
        data = rng.integers(0, 256, 100, dtype=np.uint8).tobytes()
        assert tfrecord.crc32c(data) == _python_crc32c(data)
        vocab = get_vocabulary(10, 100, 32)
        ids = rng.integers(0, vocab.size, 200)
        pairs = np.stack(vocab.decode_ids(ids), axis=1).astype(np.int16)
        np.testing.assert_array_equal(serialization._pairs_to_ids(pairs, vocab), ids)
        path = tmp_path / "g.mid"
        path.write_bytes(_gnarly_smf())
        for mine, original in zip(midi_io.read_note_arrays(path),
                                  jax_midi_io.read_note_arrays(path)):
            np.testing.assert_array_equal(mine, original)
    warnings = [r for r in caplog.records if r.levelno == logging.WARNING]
    assert len(warnings) == 1 and "pure-Python" in warnings[0].getMessage()
    assert not list((tmp_path / "native").glob("*.so"))
