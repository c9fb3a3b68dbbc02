"""Built-in additive-synthesis WAV renderer, ``synthesize`` without
fluidsynth: the port's copy of ``composer_tpu/midi/synth.py`` (numpy only).

The reference's ``synthesize`` shells out to fluidsynth with a downloaded
soundfont (reference cli.py:682-744) and fails where neither is available.
This renderer is the dependency-free fallback: a small vectorized additive
synthesizer (per-note decaying harmonics + attack/release envelopes,
velocity-scaled, soft-clipped mixdown) writing 16-bit PCM through the stdlib
``wave`` module. It will not replace a soundfont for timbre, but it is fully
offline, deterministic, and good enough to audit a generation by ear;
``composer synthesize --renderer builtin`` (or ``auto`` without fluidsynth)
uses it. On the same MIDI file it writes the original's WAV byte for byte.
"""

from __future__ import annotations

import wave
from pathlib import Path

import numpy as np

from composer_tpu_torch.midi.events import NoteSequence

SAMPLE_RATE = 22050
# Relative amplitudes of the first partials: a mellow, piano-ish rolloff.
_HARMONICS = (1.0, 0.45, 0.22, 0.1, 0.05)
_ATTACK_S = 0.008
_RELEASE_S = 0.04
# Exponential amplitude decay time constant, scaled by pitch (high notes
# die faster, as on a struck string).
_DECAY_AT_A4_S = 1.4


def _pitch_hz(pitch: int) -> float:
    return 440.0 * 2.0 ** ((pitch - 69) / 12.0)


def render_note_sequence(sequence: NoteSequence,
                         sample_rate: int = SAMPLE_RATE) -> np.ndarray:
    """Renders a NoteSequence (millisecond timing) to a mono f32 buffer.

    Sustain periods are honored by extending each note's sounding time to
    the end of any pedal-down interval covering its release (the audible
    effect of CC64; mirrors the codec's EXTEND semantics at render time).
    """
    if not sequence.notes:
        return np.zeros(sample_rate // 10, np.float32)

    pedals = [(p.start, p.end) for p in sequence.sustain_periods]

    def sounding_end(note) -> float:
        end = note.end
        for start, stop in pedals:
            if start <= end <= stop:
                end = max(end, stop)
        return end

    total_ms = max(sounding_end(n) for n in sequence.notes)
    samples = int(total_ms / 1000.0 * sample_rate) + int(
        (_RELEASE_S + 0.1) * sample_rate
    )
    mix = np.zeros(samples, np.float64)

    for note in sequence.notes:
        start = int(note.start / 1000.0 * sample_rate)
        end_s = sounding_end(note) / 1000.0 + _RELEASE_S
        length = max(int(end_s * sample_rate) - start, 1)
        t = np.arange(length, dtype=np.float64) / sample_rate

        freq = _pitch_hz(int(note.pitch))
        decay = _DECAY_AT_A4_S * (440.0 / freq) ** 0.5
        envelope = np.exp(-t / decay)
        attack = min(int(_ATTACK_S * sample_rate), length)
        if attack:
            envelope[:attack] *= np.linspace(0.0, 1.0, attack)
        release = min(int(_RELEASE_S * sample_rate), length)
        if release:
            envelope[-release:] *= np.linspace(1.0, 0.0, release)

        tone = np.zeros(length, np.float64)
        for index, amp in enumerate(_HARMONICS, start=1):
            partial_hz = freq * index
            if partial_hz >= sample_rate / 2:
                break  # stay under Nyquist
            tone += amp * np.sin(2.0 * np.pi * partial_hz * t)
        velocity = max(int(note.velocity), 1) / 127.0
        mix[start : start + length] += tone * envelope * (velocity ** 1.5)

    # Soft-clip the mixdown (dense chords sum well past 1.0) and normalize.
    mix = np.tanh(mix / max(np.abs(mix).max(), 1e-9) * 2.0)
    peak = np.abs(mix).max()
    if peak > 0:
        mix = mix / peak * 0.9
    return mix.astype(np.float32)


def write_wav(buffer: np.ndarray, filepath,
              sample_rate: int = SAMPLE_RATE) -> None:
    """Writes a mono f32 [-1, 1] buffer as 16-bit PCM."""
    pcm = np.clip(buffer, -1.0, 1.0)
    pcm = (pcm * 32767.0).astype("<i2")
    with wave.open(str(filepath), "wb") as handle:
        handle.setnchannels(1)
        handle.setsampwidth(2)
        handle.setframerate(sample_rate)
        handle.writeframes(pcm.tobytes())


def render_midi_to_wav(midi_filepath, wav_filepath,
                       sample_rate: int = SAMPLE_RATE) -> Path:
    """MIDI file -> WAV through the built-in renderer; returns the path."""
    sequence = NoteSequence.from_midi(str(midi_filepath))
    buffer = render_note_sequence(sequence, sample_rate=sample_rate)
    write_wav(buffer, wav_filepath, sample_rate=sample_rate)
    return Path(wav_filepath)
