"""The port's copies of the framework-free layers (codec, vocabulary, MIDI
reader and writer, config, dataset windows) against the JAX package's
originals."""

from pathlib import Path

import numpy as np
import pytest

from composer_tpu import ModelSaveFrequencyMode as JaxSaveMode
from composer_tpu import exceptions as jax_exceptions
from composer_tpu.config import get_default as jax_get_default
from composer_tpu.data.loader import WindowDataset as JaxWindowDataset
from composer_tpu.midi import events as jax_events
from composer_tpu.midi import midi_io as jax_midi_io
from composer_tpu.models import get_event_vocab_size as jax_vocab_size
from composer_tpu_torch import ModelSaveFrequencyMode
from composer_tpu_torch import exceptions
from composer_tpu_torch.config import get_default
from composer_tpu_torch.data import WindowDataset
from composer_tpu_torch.exceptions import DatasetError
from composer_tpu_torch.midi import events, midi_io
from composer_tpu_torch.models import get_event_vocab_size


def _notes(module, seed, count=60):
    rng = np.random.default_rng(seed)
    starts = np.cumsum(rng.integers(0, 300, count))
    return [module.Note(float(s), float(s + d), int(p), int(v)) for s, d, p, v in
            zip(starts, rng.integers(10, 2000, count), rng.integers(21, 109, count),
                rng.integers(1, 128, count))]


def _sustains(module, seed):
    rng = np.random.default_rng(seed + 100)
    starts = np.sort(rng.integers(0, 8000, 3)).astype(float)
    return [module.SustainPeriod(s, s + 500.0) for s in starts]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("mode", ["none", "extend", "events"])
def test_codec_ids_match_the_original(seed, mode):
    config = get_default()
    params = (config.dataset.time_step_increment, config.dataset.max_time_steps,
              config.dataset.velocity_bins)
    ours = events.NoteSequence(_notes(events, seed), _sustains(events, seed)).to_event_sequence(
        *params, sustain_period_encode_mode=events.SustainPeriodEncodeMode(mode))
    theirs = jax_events.NoteSequence(
        _notes(jax_events, seed), _sustains(jax_events, seed)).to_event_sequence(
        *params, sustain_period_encode_mode=jax_events.SustainPeriodEncodeMode(mode))
    ids = ours.to_ids()
    np.testing.assert_array_equal(ids, theirs.to_ids())
    decoded = events.EventSequence.from_ids(ids, *params).to_note_sequence()
    expected = jax_events.EventSequence.from_ids(ids, *params).to_note_sequence()
    assert [(n.start, n.end, n.pitch, n.velocity) for n in decoded.notes] == \
        [(n.start, n.end, n.pitch, n.velocity) for n in expected.notes]


def test_vocab_size_and_config_match_the_original():
    assert get_event_vocab_size(get_default()) == jax_vocab_size(jax_get_default()) == 390
    ours, theirs = get_default(), jax_get_default()
    assert ours.dataset == theirs.dataset
    assert ours.transformer == theirs.transformer
    assert ours.music_rnn == theirs.music_rnn
    assert [m.value for m in ModelSaveFrequencyMode] == [m.value for m in JaxSaveMode]


def test_midi_writer_matches_the_original(tmp_path):
    ours = events.NoteSequence(_notes(events, 3), _sustains(events, 3))
    theirs = jax_events.NoteSequence(_notes(jax_events, 3), _sustains(jax_events, 3))
    ours.to_midi(tmp_path / "ours.mid")
    jax_midi_io.write_note_sequence(theirs, tmp_path / "theirs.mid")
    assert (tmp_path / "ours.mid").read_bytes() == (tmp_path / "theirs.mid").read_bytes()


@pytest.mark.parametrize("shuffle", [False, True])
def test_window_dataset_matches_the_original(shuffle):
    stream = np.random.default_rng(4).integers(0, 390, 5000)
    ours = WindowDataset(stream, 3, 64, shuffle=shuffle, seed=5)
    theirs = JaxWindowDataset(stream, 3, 64, shuffle=shuffle, seed=5)
    assert len(ours) == len(theirs)
    for _ in range(2):  # two epochs: the reshuffle follows the same stream
        for (x, y), (jx, jy) in zip(ours, theirs):
            np.testing.assert_array_equal(x, jx)
            np.testing.assert_array_equal(y, jy)
    with pytest.raises(DatasetError):
        WindowDataset(stream[:10], 3, 64)


@pytest.mark.parametrize("name", ["ComposerError", "InvalidParameterError", "DatasetError",
                                  "CheckpointError", "EncodingError", "ServiceOverloadedError",
                                  "DeadlineExceededError", "RequestCancelledError"])
def test_exceptions_match_the_original(name):
    ours, theirs = getattr(exceptions, name), getattr(jax_exceptions, name)
    assert ours.__doc__ == theirs.__doc__
    assert [base.__name__ for base in ours.__mro__] == [base.__name__ for base in theirs.__mro__]


FIXTURES = sorted((Path(__file__).parent / "fixtures" / "pretty_midi").glob("*.mid"))


def _written(module, tmp_path, seed):
    path = tmp_path / f"written_{seed}.mid"
    module.NoteSequence(_notes(module, seed), _sustains(module, seed)).to_midi(path)
    return path


def _sequence_tuples(sequence):
    return ([(n.start, n.end, n.pitch, n.velocity) for n in sequence.notes],
            [(p.start, p.end) for p in sequence.sustain_periods])


@pytest.mark.parametrize("source", [f.name for f in FIXTURES] + ["written-0", "written-1"])
@pytest.mark.parametrize("programs, ignore_drums", [(None, True), (None, False), ({1}, True)])
def test_midi_reader_matches_the_original(source, programs, ignore_drums, tmp_path):
    """``read_note_arrays`` and ``read_note_sequence`` give the original's
    arrays and notes on every fixture and on files the writer produced."""
    if source.startswith("written"):
        path = _written(events, tmp_path, int(source[-1]))
    else:
        path = Path(__file__).parent / "fixtures" / "pretty_midi" / source
    ours = midi_io.read_note_arrays(path, programs=programs, ignore_drums=ignore_drums)
    theirs = jax_midi_io.read_note_arrays(path, programs=programs, ignore_drums=ignore_drums)
    for mine, reference in zip(ours, theirs, strict=True):
        assert mine.dtype == reference.dtype
        np.testing.assert_array_equal(mine, reference)
    assert _sequence_tuples(midi_io.read_note_sequence(path, programs, ignore_drums)) == \
        _sequence_tuples(jax_midi_io.read_note_sequence(path, programs, ignore_drums))
    assert _sequence_tuples(events.NoteSequence.from_midi(path, programs, ignore_drums)) == \
        _sequence_tuples(jax_events.NoteSequence.from_midi(path, programs, ignore_drums))


def test_parse_midi_matches_the_original_on_every_fixture():
    for path in FIXTURES:
        ours, theirs = midi_io.parse_midi(path), jax_midi_io.parse_midi(path.read_bytes())
        assert ours.ticks_per_quarter == theirs.ticks_per_quarter
        assert [(i.program, i.is_drum, [vars(n) for n in i.notes],
                 [vars(c) for c in i.control_changes]) for i in ours.instruments] == \
            [(i.program, i.is_drum, [vars(n) for n in i.notes],
              [vars(c) for c in i.control_changes]) for i in theirs.instruments]


def _bad_midi(kind: str) -> bytes:
    data = FIXTURES[0].read_bytes()
    return {
        "junk": b"junkjunkjunk",
        "empty": b"",
        "header-only": data[:14],
        "short-header": data[:10],
        "truncated-track": data[: len(data) - 7],
        "truncated-event": data[:26],
        "dangling-data-byte": data[:22] + bytes([0x00, 0x40]) + data[24:],
        "unknown-status": data[:14] + b"MTrk" + (6).to_bytes(4, "big") + bytes([0, 0xF4, 0, 0, 0, 0]),
    }[kind]


@pytest.mark.parametrize("kind", ["junk", "empty", "header-only", "short-header",
                                  "truncated-track", "truncated-event", "dangling-data-byte",
                                  "unknown-status"])
def test_parse_midi_raises_like_the_original(kind):
    """Truncated and junk bytes: the same exception class (by name, each
    package has its own) and message, or the same parse where the cut still
    leaves a readable file."""
    data = _bad_midi(kind)

    def outcome(module):
        try:
            midi = module.parse_midi(data)
        except Exception as error:  # the class is what is compared
            return type(error).__name__, str(error)
        return "ok", [(i.program, [vars(n) for n in i.notes]) for i in midi.instruments]

    ours = outcome(midi_io)
    assert ours == outcome(jax_midi_io)
    if kind in ("junk", "empty", "dangling-data-byte", "unknown-status"):
        assert ours[0] == "InvalidParameterError"
    elif kind in ("short-header", "truncated-track"):
        assert ours[0] != "ok"  # struct.error, IndexError


# ------------------------------------------------- the CLI slice's copies

@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("mode", ["none", "extend", "events"])
def test_fast_encode_matches_the_original(seed, mode):
    from composer_tpu.midi import fast_encode as jax_fast_encode
    from composer_tpu_torch.midi import fast_encode

    notes, sustains = _notes(events, seed), _sustains(events, seed)
    arrays = ([n.start for n in notes], [n.end for n in notes], [n.pitch for n in notes],
              [n.velocity for n in notes], [p.start for p in sustains],
              [p.end for p in sustains])
    ours = fast_encode.encode_events(
        *arrays, sustain_period_encode_mode=events.SustainPeriodEncodeMode(mode))
    theirs = jax_fast_encode.encode_events(
        *arrays, sustain_period_encode_mode=jax_events.SustainPeriodEncodeMode(mode))
    for got, expected in zip(ours, theirs):
        np.testing.assert_array_equal(got, expected)
        assert got.dtype == expected.dtype


def test_serialization_matches_the_original(tmp_path):
    """``.data`` bytes (integer and one-hot encodings, ``write_event_pairs``)
    and what ``load`` and ``event_ids_from_file`` read back."""
    from composer_tpu.midi import serialization as jax_serialization
    from composer_tpu_torch.midi import serialization

    sequence = events.NoteSequence(_notes(events, 5), _sustains(events, 5)).to_event_sequence(
        10, 100, 32)
    jax_sequence = jax_events.NoteSequence(
        _notes(jax_events, 5), _sustains(jax_events, 5)).to_event_sequence(10, 100, 32)
    for ours, theirs in ((sequence.to_integer_encoding(), jax_sequence.to_integer_encoding()),
                         (sequence.to_one_hot_encoding(), jax_sequence.to_one_hot_encoding())):
        assert ours.to_bytes() == theirs.to_bytes()
    types, values = sequence.to_arrays()
    serialization.write_event_pairs(tmp_path / "ours.data", types, values, 10, 100, 32)
    jax_serialization.write_event_pairs(tmp_path / "theirs.data", types, values, 10, 100, 32)
    assert (tmp_path / "ours.data").read_bytes() == (tmp_path / "theirs.data").read_bytes()
    ids = serialization.IntegerEncodedEventSequence.event_ids_from_file(
        tmp_path / "ours.data", as_numpy_array=True)[0]
    np.testing.assert_array_equal(ids, jax_serialization.IntegerEncodedEventSequence
                                  .event_ids_from_file(tmp_path / "ours.data",
                                                       as_numpy_array=True)[0])
    np.testing.assert_array_equal(ids, sequence.to_ids())
    loaded = events.EventSequence.from_file(tmp_path / "ours.data")
    np.testing.assert_array_equal(loaded.to_ids(), sequence.to_ids())
    sequence.to_one_hot_encoding().to_file(tmp_path / "one_hot.data")
    np.testing.assert_array_equal(
        serialization.load(tmp_path / "one_hot.data").to_ids(),
        jax_serialization.load(tmp_path / "one_hot.data").to_ids())


def test_logging_colours_match_the_original():
    """The port writes colorama's ANSI codes itself: each level formats to
    the original's string."""
    import logging

    from composer_tpu import logging_utils as jax_logging_utils
    from composer_tpu_torch import logging_utils

    ours = logging_utils._ColourFormatter(logging_utils._DEFAULT_FORMAT)
    theirs = jax_logging_utils._ColourFormatter(jax_logging_utils._DEFAULT_FORMAT)
    for level in (logging.DEBUG, logging.INFO, logging.WARNING, logging.ERROR, logging.FATAL):
        record = logging.LogRecord("x", level, __file__, 1, "message %d", (7,), None)
        assert ours.format(record) == theirs.format(record)
    with pytest.raises(ValueError, match="Must be"):
        logging_utils.set_verbosity("loud")


def test_click_enum_type_matches_the_original():
    from composer_tpu import click_utils as jax_click_utils
    from composer_tpu.midi.events import SustainPeriodEncodeMode as JaxMode
    from composer_tpu_torch import click_utils

    ours = click_utils.EnumType(events.SustainPeriodEncodeMode, False)
    theirs = jax_click_utils.EnumType(JaxMode, False)
    assert ours.choices == theirs.choices
    assert ours.get_metavar(None) == theirs.get_metavar(None)
    assert ours.convert("EXTEND", None, None).value == theirs.convert("EXTEND", None, None).value


@pytest.mark.parametrize("workers", [1, 3])
def test_parallel_map_matches_the_original(workers):
    """Results in input order, failures collected, with one worker and with
    a pool of spawned processes (the port's start method)."""
    import math

    from composer_tpu import utils as jax_utils
    from composer_tpu_torch import utils

    items = [4.0, -1.0, 9.0, 16.0, -4.0, 25.0, 36.0]
    ours = utils.parallel_map(items, math.sqrt, num_workers=workers, show_progress_bar=False,
                              return_exceptions=True)
    theirs = jax_utils.parallel_map(items, math.sqrt, num_workers=workers,
                                    show_progress_bar=False, return_exceptions=True,
                                    multithread=True)
    assert [repr(r) for r in ours] == [repr(r) for r in theirs]
    with pytest.raises(ValueError):
        utils.parallel_map(items, math.sqrt, num_workers=workers, show_progress_bar=False)


def test_model_config_helpers_match_the_original():
    from composer_tpu import models as jax_models
    from composer_tpu_torch import models

    assert [(m.name, m.value) for m in models.EventEncodingType] == \
        [(m.name, m.value) for m in jax_models.EventEncodingType]
    for model_type in models.ModelType:
        jax_type = jax_models.ModelType(model_type.value)
        for name in ("get_batch_size", "get_learning_rate", "get_window_size"):
            assert getattr(models, name)(model_type, get_default()) == \
                getattr(jax_models, name)(jax_type, jax_get_default()), name
