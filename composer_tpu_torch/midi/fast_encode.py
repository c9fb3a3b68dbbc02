"""Vectorized event encoding: NoteSequence arrays -> (type, value) arrays.
The port's copy of ``composer_tpu/midi/fast_encode.py``; ``tests/test_torch_codec.py``
holds it to the original.

The reference encoded events one at a time in Python (sequence.py:516-592);
this module produces the identical stream with NumPy array ops — markers,
stable time ordering, banker's-rounded time quantization, chunked time
shifts, change-triggered velocity events, and the clean pass are all
vectorized. Exact equivalence with the object encoder is pinned by
randomized tests (tests/test_fast_encode.py).

This is the preprocessing hot path: files/sec scales with this function.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from composer_tpu_torch.midi.events import EventType, SustainPeriodEncodeMode

# Marker kinds in emission order at equal timestamps are controlled by the
# stable sort over append order, not by these codes.
_NOTE_ON = int(EventType.NOTE_ON)
_NOTE_OFF = int(EventType.NOTE_OFF)
_TIME_SHIFT = int(EventType.TIME_SHIFT)
_VELOCITY = int(EventType.VELOCITY)
_SUSTAIN_ON = int(EventType.SUSTAIN_ON)
_SUSTAIN_OFF = int(EventType.SUSTAIN_OFF)


def _extend_notes(starts, ends, pitches, sus_starts, sus_ends):
    """EXTEND-mode note stretching (reference semantics incl. resume index;
    sequence.py:491-514). Small loop over sustain periods only."""
    ends = ends.copy()
    count = len(starts)
    start_note_index = 0
    for period_start, period_end in zip(sus_starts, sus_ends):
        index = start_note_index
        last = index
        in_interval = []
        for index in range(start_note_index, count):
            if starts[index] < period_start:
                last = index
                continue
            if starts[index] > period_end:
                last = index
                break
            in_interval.append(index)
            last = index
        if in_interval:
            start_note_index = last
            next_start_by_pitch = {}
            for note_index in reversed(in_interval):
                pitch = pitches[note_index]
                if pitch in next_start_by_pitch:
                    ends[note_index] = next_start_by_pitch[pitch]
                else:
                    ends[note_index] = max(period_end, ends[note_index])
                next_start_by_pitch[pitch] = starts[note_index]
    return ends


def encode_events(
    starts,
    ends,
    pitches,
    velocities,
    sus_starts=None,
    sus_ends=None,
    *,
    time_step_increment: int = 10,
    max_time_steps: Optional[int] = 100,
    velocity_bins: int = 32,
    sustain_period_encode_mode: SustainPeriodEncodeMode = SustainPeriodEncodeMode.EVENTS,
    clean: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (types, values) int16 arrays; value -1 encodes None."""
    starts = np.asarray(starts, dtype=np.float64)
    ends = np.asarray(ends, dtype=np.float64)
    pitches = np.asarray(pitches, dtype=np.int64)
    velocities = np.asarray(velocities, dtype=np.int64)
    sus_starts = np.asarray(sus_starts if sus_starts is not None else [], dtype=np.float64)
    sus_ends = np.asarray(sus_ends if sus_ends is not None else [], dtype=np.float64)

    # Stable note order by start; stable sustain order by start.
    note_order = np.argsort(starts, kind="stable")
    starts, ends = starts[note_order], ends[note_order]
    pitches, velocities = pitches[note_order], velocities[note_order]
    sus_order = np.argsort(sus_starts, kind="stable")
    sus_starts, sus_ends = sus_starts[sus_order], sus_ends[sus_order]

    mode = sustain_period_encode_mode
    if mode == SustainPeriodEncodeMode.EXTEND and len(sus_starts):
        ends = _extend_notes(starts, ends, pitches, sus_starts, sus_ends)

    # Markers in reference append order: sustains (ON,OFF interleaved per
    # period) first when mode==EVENTS, then notes (ON,OFF per note); a stable
    # time sort then reproduces the reference's tie-breaking exactly.
    note_count = len(starts)
    if mode == SustainPeriodEncodeMode.EVENTS and len(sus_starts):
        sus_times = np.empty(2 * len(sus_starts))
        sus_times[0::2] = sus_starts
        sus_times[1::2] = sus_ends
        sus_kinds = np.tile([_SUSTAIN_ON, _SUSTAIN_OFF], len(sus_starts))
    else:
        sus_times = np.empty(0)
        sus_kinds = np.empty(0, dtype=np.int64)

    note_times = np.empty(2 * note_count)
    note_times[0::2] = starts
    note_times[1::2] = ends
    note_kinds = np.tile([_NOTE_ON, _NOTE_OFF], note_count)
    note_pitch = np.repeat(pitches, 2)
    note_velocity = np.repeat(velocities, 2)

    times = np.concatenate([sus_times, note_times])
    kinds = np.concatenate([sus_kinds, note_kinds]).astype(np.int64)
    pitch_of = np.concatenate([np.full(len(sus_kinds), -1), note_pitch])
    velocity_of = np.concatenate([np.full(len(sus_kinds), -1), note_velocity])

    order = np.argsort(times, kind="stable")
    times, kinds = times[order], kinds[order]
    pitch_of, velocity_of = pitch_of[order], velocity_of[order]

    if len(times) == 0:
        return np.empty(0, np.int16), np.empty(0, np.int16)

    # Time intervals: int(round(delta_ms) / increment) with banker's rounding
    # (reference-exact, sequence.py:530), then chunked at max_time_steps.
    previous = np.concatenate([[0.0], times[:-1]])
    intervals = (np.round(times - previous) / time_step_increment).astype(np.int64)
    if max_time_steps is not None:
        full_chunks = intervals // max_time_steps
        remainder = intervals % max_time_steps
    else:
        full_chunks = np.zeros_like(intervals)
        remainder = intervals
    has_remainder = remainder > 0

    # Velocity events: the running velocity changes only at note markers;
    # emit VELOCITY when a note marker's velocity differs from the previous
    # note marker's (0 before the first).
    is_note = (kinds == _NOTE_ON) | (kinds == _NOTE_OFF)
    note_positions = np.flatnonzero(is_note)
    marker_velocities = velocity_of[note_positions]
    previous_velocity = np.concatenate([[0], marker_velocities[:-1]])
    needs_velocity = np.zeros(len(times), dtype=bool)
    needs_velocity[note_positions] = marker_velocities != previous_velocity

    # Assemble: per marker [TS(max)]*n + [TS(rem)]? + [VELOCITY]? + event.
    counts = full_chunks + has_remainder + needs_velocity + 1
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
    total = int(counts.sum())

    types = np.empty(total, dtype=np.int16)
    values = np.empty(total, dtype=np.int16)

    # TIME_SHIFT(max) runs: grouped-arange flat indices.
    if max_time_steps is not None and full_chunks.sum() > 0:
        group_starts = np.repeat(offsets, full_chunks)
        group_base = np.repeat(np.cumsum(full_chunks) - full_chunks, full_chunks)
        intra = np.arange(int(full_chunks.sum())) - group_base
        slots = group_starts + intra
        types[slots] = _TIME_SHIFT
        values[slots] = max_time_steps

    rem_slots = (offsets + full_chunks)[has_remainder]
    types[rem_slots] = _TIME_SHIFT
    values[rem_slots] = remainder[has_remainder]

    vel_slots = (offsets + full_chunks + has_remainder)[needs_velocity]
    types[vel_slots] = _VELOCITY
    values[vel_slots] = (velocity_of[needs_velocity] * velocity_bins) // 128

    event_slots = offsets + counts - 1
    types[event_slots] = kinds.astype(np.int16)
    values[event_slots] = np.where(is_note, pitch_of, -1).astype(np.int16)

    if clean:
        # Remove same-pitch ON<->OFF adjacent pairs (single pass over the
        # ORIGINAL adjacency, marks unioned — matches events._clean_events).
        # Zero time shifts are never emitted by construction.
        on = types == _NOTE_ON
        off = types == _NOTE_OFF
        pair = np.zeros(total, dtype=bool)
        if total > 1:
            adjacent = ((off[1:] & on[:-1]) | (on[1:] & off[:-1])) & (
                values[1:] == values[:-1]
            )
            pair[1:] |= adjacent
            pair[:-1] |= adjacent
        if pair.any():
            keep = ~pair
            types, values = types[keep], values[keep]

    return types, values


def encode_note_sequence(note_sequence, **kwargs) -> Tuple[np.ndarray, np.ndarray]:
    """Convenience wrapper over a NoteSequence object."""
    notes = note_sequence.notes
    return encode_events(
        [n.start for n in notes],
        [n.end for n in notes],
        [n.pitch for n in notes],
        [n.velocity for n in notes],
        [p.start for p in note_sequence.sustain_periods],
        [p.end for p in note_sequence.sustain_periods],
        **kwargs,
    )
