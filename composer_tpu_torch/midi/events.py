"""MIDI-like note sequences and their event-token representation.

The port's copy of ``composer_tpu/midi/events.py`` (the port imports nothing
of the JAX package); ``tests/test_torch_codec.py`` holds the copy to the
original.

Behavioural parity surface: composer/dataset/sequence.py (reference). The
observable semantics — event ordering at equal timestamps, the time-shift
quantisation expression, velocity binning, the clean pass, and sustain-period
EXTEND behaviour — are bit-identical to the reference and pinned by the golden
tests in tests/test_sequences.py. The implementation is new: dataclass-based,
no TensorFlow, with pure functions where the reference used stateful classes.

Two deliberate fixes over the reference (documented divergences):
  * ``to_event_sequence`` never mutates the caller's notes in EXTEND mode
    (the reference extended the caller's Note objects in place,
    sequence.py:491-514).
  * The clean pass de-duplicates removal indices; the reference could pop the
    same index twice and crash/corrupt on ON/OFF/ON same-pitch runs at equal
    timestamps (sequence.py:566-590).
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum, IntEnum, unique
from typing import List, Optional

import numpy as np

from composer_tpu_torch.exceptions import InvalidParameterError


@unique
class EventType(IntEnum):
    """Event kinds (integer values are the on-disk ABI; sequence.py:87-92)."""

    NOTE_ON = 1
    NOTE_OFF = 2
    TIME_SHIFT = 3
    VELOCITY = 4
    SUSTAIN_ON = 5
    SUSTAIN_OFF = 6


# Sentinel used on disk for a None event value (sequence.py:125).
NONE_VALUE = -1


@dataclass
class Event:
    """A (type, value) pair; ``value`` is None for sustain markers."""

    type: EventType
    value: Optional[int] = None

    def encode_value(self) -> int:
        return NONE_VALUE if self.value is None else int(self.value)

    @staticmethod
    def decode_value(value: int) -> Optional[int]:
        return None if value == NONE_VALUE else value

    def __str__(self):
        return f"{self.type.name}<{self.value}>"


@dataclass
class Note:
    """A note with millisecond timing and MIDI pitch/velocity."""

    start: float
    end: float
    pitch: int
    velocity: int

    @property
    def duration(self) -> float:
        return self.end - self.start


@dataclass
class SustainPeriod:
    """An interval (milliseconds) during which the sustain pedal is down."""

    start: float
    end: Optional[float] = None


@unique
class SustainPeriodEncodeMode(Enum):
    """How sustain periods are represented in the event stream (sequence.py:219-241)."""

    NONE = "none"
    EXTEND = "extend"
    EVENTS = "events"


class NoteSequence:
    """A collection of notes and sustain periods, ordered by note start time."""

    SustainPeriodEncodeMode = SustainPeriodEncodeMode  # reference-compat alias

    def __init__(self, notes=None, sustain_periods=None):
        self.notes: List[Note] = list(notes) if notes else []
        self.notes.sort(key=lambda n: n.start)
        self.sustain_periods: List[SustainPeriod] = (
            list(sustain_periods) if sustain_periods else []
        )

    def add_notes(self, notes, maintain_order: bool = True) -> None:
        self.notes.extend(notes)
        if maintain_order:
            self.notes.sort(key=lambda n: n.start)

    # ------------------------------------------------------------ augmentations
    def _copies(self, inplace: bool):
        if inplace:
            return self, self.notes, self.sustain_periods
        notes = [Note(n.start, n.end, n.pitch, n.velocity) for n in self.notes]
        periods = [SustainPeriod(p.start, p.end) for p in self.sustain_periods]
        result = NoteSequence.__new__(NoteSequence)
        result.notes = notes
        result.sustain_periods = periods
        return result, notes, periods

    def time_stretch(self, percent: float, inplace: bool = True) -> "NoteSequence":
        """Scales all timings by ``percent`` (1.0 = unchanged)."""
        result, notes, periods = self._copies(inplace)
        for note in notes:
            note.start *= percent
            note.end *= percent
        for period in periods:
            period.start *= percent
            period.end *= percent
        return result

    def time_shift(self, offset: float, inplace: bool = True) -> "NoteSequence":
        result, notes, periods = self._copies(inplace)
        for note in notes:
            note.start += offset
            note.end += offset
        for period in periods:
            period.start += offset
            period.end += offset
        return result

    def trim_start(self, inplace: bool = True) -> "NoteSequence":
        """Shifts the sequence so the earliest note or sustain starts at 0."""
        offset = self.notes[0].start if self.notes else 0
        if self.sustain_periods:
            first_sustain = self.sustain_periods[0].start
            offset = min(offset, first_sustain) if self.notes else first_sustain
        return self.time_shift(-offset, inplace=inplace)

    def pitch_shift(self, offset: int, inplace: bool = True) -> "NoteSequence":
        """Shifts all pitches, clamping to [0, 127]."""
        result, notes, _ = self._copies(inplace)
        for note in notes:
            note.pitch = int(np.clip(note.pitch + offset, 0, 127))
        return result

    # ------------------------------------------------------------------ encoder
    def to_event_sequence(
        self,
        time_step_increment: int = 10,
        max_time_steps: Optional[int] = 100,
        velocity_bins: int = 32,
        sustain_period_encode_mode: SustainPeriodEncodeMode = SustainPeriodEncodeMode.EVENTS,
        clean: bool = True,
    ) -> "EventSequence":
        """Encodes this sequence as ordered events.

        Notes and sustain periods are split into ON/OFF markers, stably sorted
        by time (sustain markers before note markers at equal timestamps, both
        in start order), and replayed forward in time. TIME_SHIFTs are
        quantised with the reference's exact expression
        ``int(round(delta_ms) / increment)`` and chunked at ``max_time_steps``;
        VELOCITY is emitted (binned ``(v * bins) // 128``) whenever a note
        marker's velocity differs from the running velocity.

        Parity: sequence.py:383-592.
        """
        for period in self.sustain_periods:
            if period.end is None:
                # An open period (end defaults to None) would otherwise
                # surface as a TypeError deep inside the marker sort — the
                # reference crashed the same way (sequence.py:431-441);
                # surface a clean error instead.
                raise InvalidParameterError(
                    "Cannot encode a sustain period with no end time "
                    f"(starts at {period.start} ms)."
                )
        ordered_notes = sorted(self.notes, key=lambda n: n.start)
        ordered_sustains = sorted(self.sustain_periods, key=lambda p: p.start)

        if sustain_period_encode_mode == SustainPeriodEncodeMode.EXTEND:
            # Work on copies so the caller's notes are not mutated (see module
            # docstring); the extension semantics themselves match
            # sequence.py:491-514 exactly, including the resume-index behaviour.
            ordered_notes = [Note(n.start, n.end, n.pitch, n.velocity) for n in ordered_notes]
            _extend_notes_through_sustains(ordered_notes, ordered_sustains)

        # Marker tuples: (time, kind, payload). Python's stable sort preserves
        # the append order at equal times, which the golden streams depend on.
        markers = []
        if sustain_period_encode_mode == SustainPeriodEncodeMode.EVENTS:
            for period in ordered_sustains:
                markers.append((period.start, EventType.SUSTAIN_ON, None))
                markers.append((period.end, EventType.SUSTAIN_OFF, None))
        for note in ordered_notes:
            markers.append((note.start, EventType.NOTE_ON, note))
            markers.append((note.end, EventType.NOTE_OFF, note))
        markers.sort(key=lambda m: m[0])

        events: List[Event] = []
        current_time = 0.0
        current_velocity = 0
        for time, kind, note in markers:
            # Exact reference quantisation: round the raw millisecond delta,
            # then float-divide by the increment and truncate (sequence.py:530).
            interval = int(round(time - current_time) / time_step_increment)
            if max_time_steps is not None:
                for _ in range(interval // max_time_steps):
                    events.append(Event(EventType.TIME_SHIFT, max_time_steps))
                interval %= max_time_steps
            if interval > 0:
                events.append(Event(EventType.TIME_SHIFT, interval))

            if note is not None:
                if current_velocity != note.velocity:
                    events.append(
                        Event(EventType.VELOCITY, (note.velocity * velocity_bins) // 128)
                    )
                events.append(Event(kind, note.pitch))
                current_velocity = note.velocity
            else:
                events.append(Event(kind, None))

            current_time = time

        if clean:
            events = _clean_events(events)

        return EventSequence(events, time_step_increment, max_time_steps, velocity_bins)

    # -------------------------------------------------------------- MIDI bridge
    def to_midi(self, filepath, program: int = 1) -> None:
        """Writes this sequence as a Standard MIDI File (sustain = CC64)."""
        from composer_tpu_torch.midi import midi_io

        midi_io.write_note_sequence(self, filepath, program=program)

    @staticmethod
    def from_midi(filepath, programs=None, ignore_drums: bool = True) -> "NoteSequence":
        """Parses a Standard MIDI File into a NoteSequence (times in ms)."""
        from composer_tpu_torch.midi import midi_io

        return midi_io.read_note_sequence(filepath, programs=programs, ignore_drums=ignore_drums)


def _extend_notes_through_sustains(ordered_notes: List[Note], ordered_sustains) -> None:
    """Extends notes inside each sustain period to the period end or to the
    next same-pitch note start, whichever comes first (sequence.py:491-514)."""
    start_note_index = 0
    for period in ordered_sustains:
        notes_in_interval = []
        i = start_note_index
        for i in range(start_note_index, len(ordered_notes)):
            note = ordered_notes[i]
            if note.start < period.start:
                continue
            if note.start > period.end:
                break
            notes_in_interval.append(note)

        if notes_in_interval:
            start_note_index = i
            next_start_by_pitch = {}
            for note in reversed(notes_in_interval):
                if note.pitch in next_start_by_pitch:
                    note.end = next_start_by_pitch[note.pitch]
                else:
                    note.end = max(period.end, note.end)
                next_start_by_pitch[note.pitch] = note.start


def _clean_events(events: List[Event]) -> List[Event]:
    """Removes zero-length time shifts and same-pitch ON<->OFF adjacent pairs
    (sequence.py:566-590; indices de-duplicated, see module docstring)."""
    remove = set()
    for i in range(len(events) - 1, -1, -1):
        event = events[i]
        if event.type == EventType.TIME_SHIFT and event.value == 0:
            remove.add(i)
        if i >= 1:
            prev = events[i - 1]
            on_off_pair = (
                (event.type == EventType.NOTE_OFF and prev.type == EventType.NOTE_ON)
                or (event.type == EventType.NOTE_ON and prev.type == EventType.NOTE_OFF)
            )
            if on_off_pair and event.value == prev.value:
                remove.add(i)
                remove.add(i - 1)
    return [e for i, e in enumerate(events) if i not in remove]


class EventSequence:
    """An ordered list of events plus the codec parameters that scope it."""

    def __init__(self, events, time_step_increment, max_time_steps, velocity_bins):
        self.events: List[Event] = list(events)
        self.time_step_increment = time_step_increment
        self.max_time_steps = max_time_steps
        self.velocity_bins = velocity_bins

    # ----------------------------------------------------------------- vocab
    @property
    def vocabulary(self):
        from composer_tpu_torch.midi.vocab import get_vocabulary

        max_steps = self.max_time_steps
        if max_steps is None:
            # No cap configured: derive from the largest observed shift
            # (sequence.py:782-783).
            max_steps = max(
                (e.value for e in self.events if e.type == EventType.TIME_SHIFT),
                default=1,
            )
        return get_vocabulary(self.time_step_increment, max_steps, self.velocity_bins)

    @property
    def event_value_ranges(self):
        return self.vocabulary.event_value_ranges

    @property
    def event_dimensions(self):
        return self.vocabulary.event_dimensions

    @property
    def event_ranges(self):
        return self.vocabulary.event_ranges

    # --------------------------------------------------------------- decoder
    def to_note_sequence(self) -> NoteSequence:
        """Replays the event stream into notes/sustains.

        Lenient replay semantics match the reference (sequence.py:867-924):
        double-ONs, OFF-without-ON, and double-SUSTAIN_ONs are ignored;
        velocity is un-binned as ``(128 * bin) // bins``.
        """
        current_time = 0
        current_velocity = 0
        open_notes = {}
        open_sustain = None
        notes: List[Note] = []
        sustains: List[SustainPeriod] = []

        for event in self.events:
            kind = event.type
            if kind == EventType.TIME_SHIFT:
                current_time += event.value * self.time_step_increment
            elif kind == EventType.VELOCITY:
                current_velocity = (128 * event.value) // self.velocity_bins
            elif kind == EventType.NOTE_ON:
                if open_notes.get(event.value) is None:
                    open_notes[event.value] = Note(
                        current_time, 0, event.value, current_velocity
                    )
            elif kind == EventType.NOTE_OFF:
                note = open_notes.get(event.value)
                if note is not None:
                    note.end = current_time
                    notes.append(note)
                    open_notes[event.value] = None
            elif kind == EventType.SUSTAIN_ON:
                if open_sustain is None:
                    open_sustain = SustainPeriod(current_time, 0)
            elif kind == EventType.SUSTAIN_OFF:
                if open_sustain is not None:
                    open_sustain.end = current_time
                    sustains.append(open_sustain)
                    open_sustain = None

        return NoteSequence(notes, sustains)

    # ---------------------------------------------------------- array bridge
    def to_arrays(self) -> tuple[np.ndarray, np.ndarray]:
        """(type, value) int16 arrays; value -1 encodes None."""
        types = np.fromiter((int(e.type) for e in self.events), dtype=np.int16, count=len(self.events))
        values = np.fromiter((e.encode_value() for e in self.events), dtype=np.int16, count=len(self.events))
        return types, values

    @classmethod
    def from_arrays(cls, types, values, time_step_increment, max_time_steps, velocity_bins):
        events = [
            Event(EventType(int(t)), Event.decode_value(int(v)))
            for t, v in zip(types, values)
        ]
        return cls(events, time_step_increment, max_time_steps, velocity_bins)

    def to_ids(self) -> np.ndarray:
        """Vectorized event-id encoding of the whole sequence."""
        types, values = self.to_arrays()
        return self.vocabulary.encode_pairs(types, values)

    @classmethod
    def from_ids(cls, ids, time_step_increment, max_time_steps, velocity_bins):
        from composer_tpu_torch.midi.vocab import get_vocabulary

        vocab = get_vocabulary(time_step_increment, max_time_steps, velocity_bins)
        types, values = vocab.decode_ids(np.asarray(ids))
        return cls.from_arrays(types, values, time_step_increment, max_time_steps, velocity_bins)

    # ----------------------------------------------------------- serialization
    def to_integer_encoding(self):
        from composer_tpu_torch.midi.serialization import IntegerEncodedEventSequence

        return IntegerEncodedEventSequence.encode(self)

    def to_one_hot_encoding(self):
        from composer_tpu_torch.midi.serialization import OneHotEncodedEventSequence

        return OneHotEncodedEventSequence.encode(self)

    @staticmethod
    def from_file(filepath, decode: bool = True):
        from composer_tpu_torch.midi import serialization

        return serialization.load(filepath, decode=decode)

    def __repr__(self):
        return "\n".join(str(event) for event in self.events)

    def __len__(self):
        return len(self.events)
