"""Standard MIDI File (SMF) reader and writer: the port's copy of
``composer_tpu/midi/midi_io.py``.

Semantics of the original (its reference delegated MIDI I/O to
``pretty_midi``, sequence.py:594-680):

* times are converted tick -> seconds through the full tempo map,
* ``note_on`` with velocity 0 is a note-off,
* a note-off closes every open note of that (channel, pitch) whose start tick
  differs from the off tick (zero-length notes stay open, as in pretty_midi),
* drums are channel 10 (index 9),
* sustain is control change #64 (>=64 down, <64 up), with a dangling release
  extending the previous sustain period (sequence.py:659-678).

``read_note_sequence``/``write_note_sequence`` bridge to
:class:`composer_tpu_torch.midi.events.NoteSequence` with millisecond
timing. Reading takes the native parser where it is built (``_parse_arrays``,
``composer_tpu_torch.native``) and the pure-Python one otherwise;
``tests/test_torch_codec.py`` and ``tests/test_torch_native.py`` hold the copy
to the original.
"""

from __future__ import annotations

import bisect
import struct
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional, Tuple

from composer_tpu_torch.exceptions import InvalidParameterError
from composer_tpu_torch.midi.events import Note, NoteSequence, SustainPeriod

DEFAULT_TEMPO = 500000  # microseconds per quarter note (120 bpm)
DEFAULT_TICKS_PER_QUARTER = 960


@dataclass
class MidiNote:
    start: float  # seconds
    end: float  # seconds
    pitch: int
    velocity: int


@dataclass
class MidiControlChange:
    time: float  # seconds
    number: int
    value: int


@dataclass
class MidiInstrument:
    program: int = 0
    is_drum: bool = False
    notes: List[MidiNote] = field(default_factory=list)
    control_changes: List[MidiControlChange] = field(default_factory=list)


@dataclass
class MidiFile:
    instruments: List[MidiInstrument] = field(default_factory=list)
    ticks_per_quarter: int = DEFAULT_TICKS_PER_QUARTER


# --------------------------------------------------------------------- parsing

def _read_varlen(data: bytes, offset: int) -> Tuple[int, int]:
    value = 0
    while True:
        byte = data[offset]
        offset += 1
        value = (value << 7) | (byte & 0x7F)
        if not byte & 0x80:
            return value, offset


class _TempoMap:
    """Piecewise tick->seconds conversion from (tick, us_per_quarter) changes."""

    def __init__(self, changes: List[Tuple[int, int]], ticks_per_quarter: int):
        changes = sorted(changes)
        if not changes or changes[0][0] != 0:
            changes.insert(0, (0, DEFAULT_TEMPO))
        self._ticks = []
        self._seconds = []
        self._rates = []  # seconds per tick in each segment
        seconds = 0.0
        prev_tick = 0
        prev_rate = changes[0][1] / (1_000_000.0 * ticks_per_quarter)
        self._ticks.append(0)
        self._seconds.append(0.0)
        self._rates.append(prev_rate)
        for tick, tempo in changes[1:]:
            seconds += (tick - prev_tick) * prev_rate
            prev_tick = tick
            prev_rate = tempo / (1_000_000.0 * ticks_per_quarter)
            self._ticks.append(tick)
            self._seconds.append(seconds)
            self._rates.append(prev_rate)

    def to_seconds(self, tick: int) -> float:
        index = bisect.bisect_right(self._ticks, tick) - 1
        return self._seconds[index] + (tick - self._ticks[index]) * self._rates[index]


def _parse_track(data: bytes):
    """Yields (tick, status, payload) message tuples for one MTrk body."""
    offset = 0
    tick = 0
    running_status = None
    while offset < len(data):
        delta, offset = _read_varlen(data, offset)
        tick += delta
        status = data[offset]
        if status & 0x80:
            offset += 1
            if status < 0xF0:
                running_status = status
        else:
            if running_status is None:
                raise InvalidParameterError("Malformed MIDI track: dangling data byte.")
            status = running_status

        if status == 0xFF:  # meta event
            meta_type = data[offset]
            offset += 1
            length, offset = _read_varlen(data, offset)
            payload = data[offset : offset + length]
            offset += length
            yield tick, status, (meta_type, payload)
            if meta_type == 0x2F:  # end of track
                return
        elif status in (0xF0, 0xF7):  # sysex
            length, offset = _read_varlen(data, offset)
            offset += length
        else:
            kind = status & 0xF0
            if kind in (0x80, 0x90, 0xA0, 0xB0, 0xE0):
                payload = (data[offset], data[offset + 1])
                offset += 2
            elif kind in (0xC0, 0xD0):
                payload = (data[offset],)
                offset += 1
            else:
                raise InvalidParameterError(f"Unknown MIDI status byte: {status:#x}")
            yield tick, status, payload


def parse_midi(source) -> MidiFile:
    """Parses an SMF file (path or bytes) into a :class:`MidiFile`."""
    if isinstance(source, (bytes, bytearray)):
        data = bytes(source)
    else:
        data = Path(source).read_bytes()

    if data[:4] != b"MThd":
        raise InvalidParameterError("Not a Standard MIDI File (missing MThd).")
    header_length = struct.unpack(">I", data[4:8])[0]
    _format, num_tracks, division = struct.unpack(">HHH", data[8:14])
    if division & 0x8000:
        # SMPTE timing: frames/sec * ticks/frame gives ticks/second directly.
        frames = 256 - (division >> 8)  # two's complement of the negative byte
        ticks_per_frame = division & 0xFF
        ticks_per_second = frames * ticks_per_frame
        smpte = True
    else:
        ticks_per_quarter = division
        smpte = False

    # Slice out track chunks.
    offset = 8 + header_length
    tracks = []
    while offset + 8 <= len(data) and len(tracks) < num_tracks:
        chunk_type = data[offset : offset + 4]
        chunk_length = struct.unpack(">I", data[offset + 4 : offset + 8])[0]
        body = data[offset + 8 : offset + 8 + chunk_length]
        offset += 8 + chunk_length
        if chunk_type == b"MTrk":
            tracks.append(list(_parse_track(body)))

    # Tempo map from all tracks (well-formed files keep it in track 0).
    tempo_changes = []
    for track in tracks:
        for tick, status, payload in track:
            if status == 0xFF and payload[0] == 0x51 and len(payload[1]) >= 3:
                tempo = int.from_bytes(payload[1][:3], "big")
                tempo_changes.append((tick, tempo))
    if smpte:
        rate = 1.0 / ticks_per_second
        to_seconds = lambda tick: tick * rate  # noqa: E731
    else:
        tempo_map = _TempoMap(tempo_changes, ticks_per_quarter)
        to_seconds = tempo_map.to_seconds

    midi = MidiFile(ticks_per_quarter=division if not smpte else DEFAULT_TICKS_PER_QUARTER)
    for track in tracks:
        # One instrument per (channel, program) actually used in this track.
        instruments = {}
        channel_programs = [0] * 16
        open_notes = {}

        def instrument_for(channel):
            key = (channel, channel_programs[channel])
            if key not in instruments:
                instruments[key] = MidiInstrument(
                    program=channel_programs[channel], is_drum=(channel == 9)
                )
            return instruments[key]

        for tick, status, payload in track:
            if status == 0xFF:
                continue
            kind = status & 0xF0
            channel = status & 0x0F
            if kind == 0xC0:
                channel_programs[channel] = payload[0]
            elif kind == 0x90 and payload[1] > 0:
                open_notes.setdefault((channel, payload[0]), []).append(
                    (tick, payload[1], instrument_for(channel))
                )
            elif kind == 0x80 or (kind == 0x90 and payload[1] == 0):
                key = (channel, payload[0])
                stack = open_notes.get(key)
                if stack:
                    end_tick = tick
                    remaining = []
                    for start_tick, velocity, instrument in stack:
                        if start_tick == end_tick:
                            remaining.append((start_tick, velocity, instrument))
                            continue
                        instrument.notes.append(
                            MidiNote(
                                start=to_seconds(start_tick),
                                end=to_seconds(end_tick),
                                pitch=payload[0],
                                velocity=velocity,
                            )
                        )
                    if remaining:
                        open_notes[key] = remaining
                    else:
                        del open_notes[key]
            elif kind == 0xB0:
                instrument_for(channel).control_changes.append(
                    MidiControlChange(
                        time=to_seconds(tick), number=payload[0], value=payload[1]
                    )
                )

        for instrument in instruments.values():
            instrument.notes.sort(key=lambda n: (n.start, n.pitch))
            if instrument.notes or instrument.control_changes:
                midi.instruments.append(instrument)

    return midi


# -------------------------------------------------------------------- writing

def _varlen(value: int) -> bytes:
    chunks = [value & 0x7F]
    value >>= 7
    while value:
        chunks.append(0x80 | (value & 0x7F))
        value >>= 7
    return bytes(reversed(chunks))


def write_midi(midi: MidiFile, filepath) -> None:
    """Writes a single-track (format 0) SMF at fixed 120 bpm."""
    tpq = midi.ticks_per_quarter
    ticks_per_second = tpq * 1_000_000.0 / DEFAULT_TEMPO

    # (tick, order, status bytes); order keeps note-offs before note-ons at the
    # same tick so zero-gap repeated notes re-trigger instead of being merged.
    messages = []
    non_drum_channels = [c for c in range(16) if c != 9]
    for index, instrument in enumerate(midi.instruments):
        channel = 9 if instrument.is_drum else non_drum_channels[index % 15]
        messages.append((0, 0, bytes([0xC0 | channel, instrument.program & 0x7F])))
        for control in instrument.control_changes:
            tick = round(control.time * ticks_per_second)
            messages.append(
                (tick, 1, bytes([0xB0 | channel, control.number & 0x7F, control.value & 0x7F]))
            )
        for note in instrument.notes:
            start_tick = round(note.start * ticks_per_second)
            end_tick = round(note.end * ticks_per_second)
            messages.append(
                (start_tick, 2, bytes([0x90 | channel, note.pitch & 0x7F, max(1, note.velocity) & 0x7F]))
            )
            messages.append((end_tick, 0, bytes([0x80 | channel, note.pitch & 0x7F, 64])))

    messages.sort(key=lambda m: (m[0], m[1]))

    body = bytearray()
    body += _varlen(0) + bytes([0xFF, 0x51, 0x03]) + DEFAULT_TEMPO.to_bytes(3, "big")
    previous_tick = 0
    for tick, _, status in messages:
        body += _varlen(tick - previous_tick) + status
        previous_tick = tick
    body += _varlen(0) + bytes([0xFF, 0x2F, 0x00])

    header = b"MThd" + struct.pack(">IHHH", 6, 0, 1, tpq)
    track = b"MTrk" + struct.pack(">I", len(body)) + bytes(body)
    Path(filepath).write_bytes(header + track)


# ------------------------------------------------------- NoteSequence bridge

def _parsed_arrays_from_midifile(midi: MidiFile) -> dict:
    """MidiFile (Python parser) -> the flat array layout of the native parser."""
    import numpy as np

    program, is_drum, note_counts, control_counts = [], [], [], []
    note_start, note_end, note_pitch, note_velocity = [], [], [], []
    control_time, control_number, control_value = [], [], []
    for instrument in midi.instruments:
        program.append(instrument.program)
        is_drum.append(1 if instrument.is_drum else 0)
        note_counts.append(len(instrument.notes))
        control_counts.append(len(instrument.control_changes))
        for note in instrument.notes:
            note_start.append(note.start)
            note_end.append(note.end)
            note_pitch.append(note.pitch)
            note_velocity.append(note.velocity)
        for control in instrument.control_changes:
            control_time.append(control.time)
            control_number.append(control.number)
            control_value.append(control.value)
    return {
        "program": np.asarray(program, np.int32),
        "is_drum": np.asarray(is_drum, np.int32),
        "note_counts": np.asarray(note_counts, np.int64),
        "control_counts": np.asarray(control_counts, np.int64),
        "note_start": np.asarray(note_start, np.float64),
        "note_end": np.asarray(note_end, np.float64),
        "note_pitch": np.asarray(note_pitch, np.int32),
        "note_velocity": np.asarray(note_velocity, np.int32),
        "control_time": np.asarray(control_time, np.float64),
        "control_number": np.asarray(control_number, np.int32),
        "control_value": np.asarray(control_value, np.int32),
    }


def _parse_arrays(filepath) -> dict:
    """Parses a MIDI file into flat arrays, preferring the native parser.

    The C++ parser (native/fastcodec.cpp composer_midi_parse) mirrors
    ``parse_midi`` exactly; malformed input makes it return None and the
    Python parser runs instead, raising the usual exceptions. Without the
    native library (no compiler) the Python parser always runs.
    """
    from composer_tpu_torch import native

    data = Path(filepath).read_bytes()
    if native.available():
        parsed = native.parse_midi_arrays(data)
        if parsed is not None:
            return parsed
    return _parsed_arrays_from_midifile(parse_midi(data))


def read_note_arrays(filepath, programs=None, ignore_drums: bool = True):
    """MIDI file -> flat millisecond arrays, the preprocessing hot path.

    Returns ``(starts, ends, pitches, velocities, sus_starts, sus_ends)``
    with note arrays grouped by instrument (each group in (start, pitch)
    order) and sustain periods paired from CC64 per instrument — exactly the
    note/sustain multiset ``read_note_sequence`` produces, without building
    per-note Python objects (parity: sequence.py:626-680).
    """
    import numpy as np

    filepath = Path(filepath)
    if not filepath.is_file():
        raise InvalidParameterError(
            f"Cannot create NoteSequence from '{filepath}' since it is not a file."
        )

    parsed = _parse_arrays(filepath)
    note_offsets = np.concatenate([[0], np.cumsum(parsed["note_counts"])])
    control_offsets = np.concatenate([[0], np.cumsum(parsed["control_counts"])])

    keep_slices = []
    sus_starts: list = []
    sus_ends: list = []
    for index in range(len(parsed["program"])):
        if ignore_drums and parsed["is_drum"][index]:
            continue
        if programs is not None and int(parsed["program"][index]) not in programs:
            continue
        keep_slices.append((int(note_offsets[index]), int(note_offsets[index + 1])))

        lo, hi = int(control_offsets[index]), int(control_offsets[index + 1])
        numbers = parsed["control_number"][lo:hi]
        pedal = np.flatnonzero(numbers == 64)
        times = parsed["control_time"][lo:hi]
        values = parsed["control_value"][lo:hi]
        current_start = None
        for position in pedal:
            time_ms = times[position] * 1000.0
            if values[position] >= 64 and current_start is None:
                current_start = time_ms
            elif values[position] < 64:
                if current_start is not None:
                    sus_starts.append(current_start)
                    sus_ends.append(time_ms)
                    current_start = None
                elif sus_ends:
                    # Release without a matching press extends the previous
                    # period (sequence.py:675-678).
                    sus_ends[-1] = time_ms

    if keep_slices:
        starts = np.concatenate([parsed["note_start"][a:b] for a, b in keep_slices])
        ends = np.concatenate([parsed["note_end"][a:b] for a, b in keep_slices])
        pitches = np.concatenate([parsed["note_pitch"][a:b] for a, b in keep_slices])
        velocities = np.concatenate(
            [parsed["note_velocity"][a:b] for a, b in keep_slices]
        )
    else:
        starts = ends = np.empty(0, np.float64)
        pitches = velocities = np.empty(0, np.int32)

    return (
        starts * 1000.0,
        ends * 1000.0,
        pitches.astype(np.int64),
        velocities.astype(np.int64),
        np.asarray(sus_starts, np.float64),
        np.asarray(sus_ends, np.float64),
    )


def read_note_sequence(filepath, programs=None, ignore_drums: bool = True) -> NoteSequence:
    """MIDI file -> NoteSequence in milliseconds (parity: sequence.py:626-680)."""
    starts, ends, pitches, velocities, sus_starts, sus_ends = read_note_arrays(
        filepath, programs=programs, ignore_drums=ignore_drums
    )
    notes = [
        Note(float(s), float(e), int(p), int(v))
        for s, e, p, v in zip(starts, ends, pitches, velocities)
    ]
    sustains = [
        SustainPeriod(float(s), float(e)) for s, e in zip(sus_starts, sus_ends)
    ]
    return NoteSequence(notes, sustains)


def write_note_sequence(note_sequence: NoteSequence, filepath, program: int = 1) -> None:
    """NoteSequence (ms) -> MIDI file; sustain periods become CC64 pairs."""
    instrument = MidiInstrument(program=program)
    for note in note_sequence.notes:
        instrument.notes.append(
            MidiNote(note.start / 1000.0, note.end / 1000.0, int(note.pitch), int(note.velocity))
        )
    for period in note_sequence.sustain_periods:
        instrument.control_changes.append(MidiControlChange(period.start / 1000.0, 64, 64))
        instrument.control_changes.append(MidiControlChange(period.end / 1000.0, 64, 63))
    instrument.control_changes.sort(key=lambda c: c.time)

    write_midi(MidiFile(instruments=[instrument]), filepath)
