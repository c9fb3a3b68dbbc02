"""Raw MIDI -> ``.data`` dataset preprocessing: the port's copy of
``composer_tpu/data/preprocess.py``. Names, contents and the augmentation
stream are the original's byte for byte (``tests/test_torch_cli.py``).

Parity surface: composer/dataset/preprocess.py. Each MIDI file becomes an
integer-encoded ``.data`` file named ``{stem}_{md5(filepath)}.data``; with
``transform`` enabled, 9 augmented copies are written per file (one per
non-zero pitch shift in the configured range plus one uniform time stretch),
suffixed ``-NN``.

Deliberate fixes over the reference (documented divergences):

* The base (untransformed) conversion honours the configured codec parameters
  and sustain mode; the reference silently used hard-coded defaults for it
  (preprocess.py:80).
* ``num_workers`` is actually honoured (the reference accepted ``-w`` but
  always used the pool default, preprocess.py:174,246-247).
* The time-stretch factor is drawn from a *seeded* per-file RNG so
  preprocessing is reproducible (the reference used the global unseeded
  ``np.random``, preprocess.py:86; cli.py:51-56 computed a seed but never fed
  it to any RNG).
"""

from __future__ import annotations

import hashlib
import logging
from pathlib import Path

import numpy as np

from composer_tpu_torch.exceptions import InvalidParameterError
from composer_tpu_torch.midi.events import SustainPeriodEncodeMode
from composer_tpu_torch.utils import parallel_map

OUTPUT_EXTENSION = "data"
SUPPORTED_EXTENSIONS = ("mid", "midi")


def get_processed_files(dataset_path):
    """All ``.data`` files under ``dataset_path`` (recursive)."""
    dataset_path = Path(dataset_path)
    if not dataset_path.is_dir():
        raise InvalidParameterError(f"'{dataset_path}' is an invalid dataset path!")
    return sorted(dataset_path.glob(f"**/*.{OUTPUT_EXTENSION}"))


def get_midi_files(dataset_path):
    dataset_path = Path(dataset_path)
    filepaths = []
    for extension in SUPPORTED_EXTENSIONS:
        filepaths.extend(dataset_path.glob(f"**/*.{extension}"))
    return filepaths


def _coerce_sustain_mode(mode) -> SustainPeriodEncodeMode:
    if isinstance(mode, SustainPeriodEncodeMode):
        return mode
    return SustainPeriodEncodeMode(str(mode).lower())


def convert_file(
    filepath,
    output_path,
    transform=False,
    time_stretch_range=(0.90, 1.10),
    pitch_shift_range=(-4, 4),
    time_step_increment=10,
    max_time_steps=100,
    velocity_bins=32,
    sustain_period_encode_mode=SustainPeriodEncodeMode.EXTEND,
    trim_start=False,
    seed=None,
):
    """Converts one MIDI file (plus optional augmented copies) to ``.data``.

    Returns the list of written file paths.
    """
    from composer_tpu_torch.midi.fast_encode import encode_events
    from composer_tpu_torch.midi.serialization import write_event_pairs

    filepath = Path(filepath)
    output_path = Path(output_path)
    sustain_period_encode_mode = _coerce_sustain_mode(sustain_period_encode_mode)

    file_id = hashlib.md5(str(filepath).encode()).hexdigest()
    base_path = output_path / f"{filepath.stem}_{file_id}.{OUTPUT_EXTENSION}"

    # Array representation end-to-end: the SMF parser emits flat arrays, and
    # augmentation/encoding are vectorized (midi/fast_encode.py).
    from composer_tpu_torch.midi.midi_io import read_note_arrays

    starts, ends, pitches, velocities, sus_starts, sus_ends = read_note_arrays(filepath)

    if trim_start and (len(starts) or len(sus_starts)):
        # NoteSequence.trim_start semantics: notes[0].start after the
        # constructor's sort-by-start == the arrays' global minimum; sustains
        # are NOT sorted by the constructor, so the *first listed* period's
        # start is the one that counts.
        offset = starts.min() if len(starts) else sus_starts[0]
        if len(starts) and len(sus_starts):
            offset = min(offset, sus_starts[0])
        starts, ends = starts - offset, ends - offset
        sus_starts, sus_ends = sus_starts - offset, sus_ends - offset

    codec_kwargs = dict(
        time_step_increment=time_step_increment,
        max_time_steps=max_time_steps,
        velocity_bins=velocity_bins,
        sustain_period_encode_mode=sustain_period_encode_mode,
    )

    def write(path, starts, ends, pitches, velocities, sus_starts, sus_ends):
        types, values = encode_events(
            starts, ends, pitches, velocities, sus_starts, sus_ends, **codec_kwargs
        )
        write_event_pairs(
            path, types, values, time_step_increment, max_time_steps, velocity_bins
        )

    written = [base_path]
    write(base_path, starts, ends, pitches, velocities, sus_starts, sus_ends)

    if transform:
        # Deterministic per-file stream: global seed + file hash.
        entropy = int(file_id[:8], 16)
        rng = np.random.default_rng(entropy if seed is None else (seed, entropy))

        variants = []
        low, high = int(pitch_shift_range[0]), int(pitch_shift_range[1])
        for pitch_shift in range(low, high + 1):
            if pitch_shift == 0:
                continue
            variants.append(
                (starts, ends, np.clip(pitches + pitch_shift, 0, 127), velocities,
                 sus_starts, sus_ends)
            )
        stretch = rng.uniform(float(time_stretch_range[0]), float(time_stretch_range[1]))
        variants.append(
            (starts * stretch, ends * stretch, pitches, velocities,
             sus_starts * stretch, sus_ends * stretch)
        )

        for index, variant in enumerate(variants):
            destination = base_path.parent / f"{base_path.stem}-{index:02d}{base_path.suffix}"
            write(destination, *variant)
            written.append(destination)

    return written


def _build_kwargs(config, files, transform_flags, output_path, sustain_mode, seed):
    return [
        {
            "filepath": file,
            "output_path": output_path,
            "transform": transform_flags.get(file, False),
            "time_stretch_range": (
                config.dataset.time_stretch_range.start,
                config.dataset.time_stretch_range.stop,
            ),
            "pitch_shift_range": (
                config.dataset.pitch_shift_range.start,
                config.dataset.pitch_shift_range.stop,
            ),
            "time_step_increment": config.dataset.time_step_increment,
            "max_time_steps": config.dataset.max_time_steps,
            "velocity_bins": config.dataset.velocity_bins,
            "sustain_period_encode_mode": sustain_mode,
            "trim_start": config.dataset.trim_start,
            "seed": seed,
        }
        for file in files
    ]


def _transform_flags(files, transform, transform_percent):
    flags = {file: False for file in files}
    if transform:
        for file in files[: int(len(files) * transform_percent)]:
            flags[file] = True
    return flags



def _convert_batch(kwargs, num_workers, show_progress_bar):
    """Runs convert_file over a batch, skipping (and logging) bad files.

    Returns the number of successfully converted inputs. One corrupt MIDI
    must not abort a corpus-sized run (the reference stored exceptions in
    the results list and kept going, utils.py:61-66); failures are logged
    per file with the exception message.
    """
    results = parallel_map(
        kwargs, convert_file, num_workers=num_workers, use_kwargs=True,
        show_progress_bar=show_progress_bar, return_exceptions=True,
    )
    converted = 0
    for item, result in zip(kwargs, results):
        if isinstance(result, Exception):
            logging.error(
                "Skipping '%s': %s: %s",
                item["filepath"], type(result).__name__, result,
            )
        else:
            converted += 1
    return converted


def convert_all(
    config,
    dataset_path,
    output_path,
    sustain_period_encode_mode,
    transform,
    transform_percent,
    num_workers: int = 16,
    seed=None,
    show_progress_bar: bool = True,
):
    """Converts every MIDI file under ``dataset_path`` into ``output_path``."""
    dataset_path = Path(dataset_path)
    if not dataset_path.is_dir():
        raise InvalidParameterError(
            f"Dataset path '{dataset_path}' does not exist or is not a directory."
        )

    output_path = Path(dataset_path / "processed" if output_path is None else output_path)
    output_path.mkdir(exist_ok=True, parents=True)

    files = get_midi_files(dataset_path)
    flags = _transform_flags(files, transform, transform_percent)
    kwargs = _build_kwargs(config, files, flags, output_path, sustain_period_encode_mode, seed)
    converted = _convert_batch(kwargs, num_workers, show_progress_bar)
    logging.info(
        "Preprocessed %d of %d MIDI files into '%s'.",
        converted, len(files), output_path,
    )


def split_dataset(
    config,
    dataset_path,
    root_output_directory,
    sustain_period_encode_mode,
    test_percent,
    transform,
    transform_percent,
    num_workers: int = 16,
    seed=None,
    show_progress_bar: bool = True,
):
    """Converts a dataset into ``train/`` and ``test/`` subsets.

    Matches the reference split semantics: the first ``1 - test_percent`` of
    the glob order goes to train (preprocess.py:206-211); only the train set
    is augmented.
    """
    dataset_path = Path(dataset_path)
    if not dataset_path.is_dir():
        raise InvalidParameterError(
            f"Dataset path '{dataset_path}' does not exist or is not a directory."
        )

    files = get_midi_files(dataset_path)
    train_count = int(len(files) * (1 - test_percent))
    train_files, test_files = files[:train_count], files[train_count:]

    root = Path(root_output_directory)
    train_path = root / "train"
    test_path = root / "test"
    train_path.mkdir(exist_ok=True, parents=True)
    test_path.mkdir(exist_ok=True, parents=True)

    train_flags = _transform_flags(train_files, transform, transform_percent)
    converted_train = _convert_batch(
        _build_kwargs(config, train_files, train_flags, train_path, sustain_period_encode_mode, seed),
        num_workers, show_progress_bar,
    )
    converted_test = _convert_batch(
        _build_kwargs(config, test_files, {}, test_path, sustain_period_encode_mode, seed),
        num_workers, show_progress_bar,
    )
    logging.info(
        "Preprocessed %d of %d train / %d of %d test MIDI files into '%s'.",
        converted_train, len(train_files), converted_test, len(test_files), root,
    )
