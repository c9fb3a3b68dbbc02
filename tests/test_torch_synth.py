"""The port's built-in WAV renderer (``composer_tpu_torch/midi/synth.py``):
the WAV bytes of the JAX package's renderer on the same MIDI files, and the
cases of ``tests/test_synth.py`` (pitch from the dominant frequency, duration
from note timing, the sustain pedal's extension, velocity, clipping)."""

import wave

import numpy as np
import pytest

from composer_tpu.midi.synth import render_midi_to_wav as jax_render_midi_to_wav
from composer_tpu_torch.midi import Note, NoteSequence, SustainPeriod
from composer_tpu_torch.midi.synth import (
    SAMPLE_RATE,
    render_midi_to_wav,
    render_note_sequence,
    write_wav,
)


def _dominant_hz(buffer, sample_rate=SAMPLE_RATE):
    spectrum = np.abs(np.fft.rfft(buffer * np.hanning(buffer.size)))
    return np.fft.rfftfreq(buffer.size, 1.0 / sample_rate)[np.argmax(spectrum)]


def _random_sequence(seed: int, count: int) -> NoteSequence:
    rng = np.random.default_rng(seed)
    starts = np.cumsum(rng.integers(0, 300, count)).astype(float)
    notes = [Note(s, s + float(d), int(p), int(v)) for s, d, p, v in zip(
        starts, rng.integers(20, 1500, count), rng.integers(21, 109, count),
        rng.integers(1, 128, count))]
    pedal = [SustainPeriod(float(starts[count // 3]), float(starts[count // 2]))]
    return NoteSequence(notes, pedal)


@pytest.mark.parametrize("seed,count", [(0, 1), (1, 12), (2, 60)])
def test_wav_bytes_equal_the_originals(seed, count, tmp_path):
    midi = tmp_path / "piece.mid"
    _random_sequence(seed, count).to_midi(str(midi))
    render_midi_to_wav(midi, tmp_path / "ours.wav")
    jax_render_midi_to_wav(midi, tmp_path / "theirs.wav")
    ours = (tmp_path / "ours.wav").read_bytes()
    assert len(ours) > 44 and ours == (tmp_path / "theirs.wav").read_bytes()


def test_silence_for_an_empty_sequence():
    buffer = render_note_sequence(NoteSequence([], []))
    assert buffer.shape == (SAMPLE_RATE // 10,) and not buffer.any()


def test_single_note_pitch_and_duration():
    # A4 (midi 69) for 500 ms: the fundamental dominates the spectrum and the
    # buffer spans the note and its release tail.
    buf = render_note_sequence(NoteSequence([Note(0.0, 500.0, 69, 100)], []))
    assert abs(_dominant_hz(buf) - 440.0) < 5.0
    assert buf.size >= int(0.5 * SAMPLE_RATE)
    assert np.abs(buf).max() > 0.5  # normalized, audible


def test_octave_transposition_doubles_frequency():
    low = render_note_sequence(NoteSequence([Note(0.0, 400.0, 57, 100)], []))
    high = render_note_sequence(NoteSequence([Note(0.0, 400.0, 69, 100)], []))
    assert abs(_dominant_hz(high) / _dominant_hz(low) - 2.0) < 0.05


def test_sustain_pedal_extends_sounding_time():
    # The same 200 ms note under a pedal held to 900 ms rings about 4x longer.
    note = [Note(0.0, 200.0, 60, 100)]
    dry = render_note_sequence(NoteSequence(note, []))
    wet = render_note_sequence(NoteSequence(note, [SustainPeriod(0.0, 900.0)]))
    assert wet.size > dry.size * 2


def test_velocity_scales_amplitude():
    # A quiet note next to a loud one, so normalization cannot equalize them.
    both = render_note_sequence(NoteSequence(
        [Note(0.0, 300.0, 60, 120), Note(500.0, 800.0, 60, 20)], []))
    split = int(0.4 * SAMPLE_RATE)
    assert np.abs(both[:split]).max() > \
        3 * np.abs(both[split + int(0.1 * SAMPLE_RATE):]).max() * 0.5


def test_midi_round_trip_to_wav(tmp_path):
    seq = NoteSequence([Note(0.0, 400.0, 60, 90), Note(400.0, 800.0, 64, 90),
                        Note(800.0, 1400.0, 67, 90)], [])
    midi = tmp_path / "phrase.mid"
    seq.to_midi(str(midi))
    wav = tmp_path / "phrase.wav"
    assert render_midi_to_wav(midi, wav) == wav
    with wave.open(str(wav)) as handle:
        assert handle.getnchannels() == 1 and handle.getsampwidth() == 2
        duration = handle.getnframes() / handle.getframerate()
    assert 1.4 <= duration <= 2.0  # 1.4 s of notes + release/tail padding


def test_write_wav_clips_and_encodes(tmp_path):
    path = tmp_path / "x.wav"
    write_wav(np.asarray([0.0, 2.0, -2.0, 0.5], np.float32), path)
    with wave.open(str(path)) as handle:
        pcm = np.frombuffer(handle.readframes(4), "<i2")
    assert pcm[1] == 32767 and pcm[2] == -32767
