"""Packed-window dataset loading: the port's copy of
``composer_tpu/data/loader.py`` (``tests/test_torch_codec.py`` and
``tests/test_torch_cli.py`` hold it to the original batch for batch).

Parity surface: composer/models/__init__.py:160-313. The reference streamed
per-event Python generators into tf.data; here the whole token stream is
packed into one contiguous int32 array and windowing/batching are pure NumPy
reshapes (static shapes, zero per-element Python).

Window semantics are identical to the reference pipeline
(models/__init__.py:304-312): the flat event stream is cut into
*non-overlapping* windows of ``window_size + 1`` (remainder dropped, windows
may span file boundaries), inputs are ``window[:-1]`` and labels are
``window[1:]``, windows are shuffled, then grouped into batches of
``batch_size`` (remainder dropped).
"""

from __future__ import annotations

import hashlib
import itertools
import logging
import os
from collections import deque
from pathlib import Path
from typing import Iterator, Tuple

import numpy as np

from composer_tpu_torch.exceptions import DatasetError
from composer_tpu_torch.midi.serialization import IntegerEncodedEventSequence
from composer_tpu_torch.utils import parallel_map


def load_event_ids(filepaths, num_workers: int = 8, show_progress_bar: bool = False) -> np.ndarray:
    """Loads and concatenates the event-id streams of many ``.data`` files."""
    filepaths = [Path(p) for p in filepaths]
    if not filepaths:
        return np.zeros(0, dtype=np.int32)

    def _load(path):
        ids, _, _, _ = IntegerEncodedEventSequence.event_ids_from_file(
            path, as_numpy_array=True, numpy_dtype=np.int32
        )
        return ids

    if len(filepaths) == 1 or num_workers <= 1:
        chunks = [_load(p) for p in filepaths]
    else:
        chunks = parallel_map(
            filepaths,
            _load,
            num_workers=num_workers,
            multithread=True,
            show_progress_bar=show_progress_bar,
        )
    return np.concatenate(chunks) if chunks else np.zeros(0, dtype=np.int32)


class WindowDataset:
    """(input, label) batches over non-overlapping windows of a token stream.

    Iterating yields ``(x, y)`` int32 arrays of shape
    ``[batch_size, window_size]``; each epoch reshuffles with a fresh
    deterministic stream when ``shuffle`` is enabled.
    """

    def __init__(
        self,
        token_stream: np.ndarray,
        batch_size: int,
        window_size: int,
        shuffle: bool = True,
        seed: int = 0,
        shard_count: int = 1,
        shard_index: int = 0,
        clamp_batch: bool = False,
    ):
        stream = np.ascontiguousarray(token_stream, dtype=np.int32)
        stride = window_size + 1
        num_windows = stream.shape[0] // stride
        if num_windows == 0:
            raise DatasetError(
                f"Token stream of {stream.shape[0]} events is shorter than one "
                f"window ({stride} events)."
            )
        self.windows = stream[: num_windows * stride].reshape(num_windows, stride)
        if shard_count > 1:
            # Per-host sharding for the data-parallel mesh axis.
            self.windows = self.windows[shard_index::shard_count]
        if clamp_batch and self.windows.shape[0] < batch_size:
            # Small evaluation sets: shrink the batch rather than fail.
            batch_size = self.windows.shape[0]
        self.batch_size = batch_size
        self.window_size = window_size
        self.shuffle = shuffle
        self._rng = np.random.default_rng(seed)
        self._epoch = 0

    @property
    def num_batches(self) -> int:
        return self.windows.shape[0] // self.batch_size

    def __len__(self) -> int:
        return self.num_batches

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        order = np.arange(self.windows.shape[0])
        if self.shuffle:
            self._rng.shuffle(order)
        self._epoch += 1

        usable = self.num_batches * self.batch_size
        if usable == 0:
            raise DatasetError(
                f"{self.windows.shape[0]} windows cannot fill one batch of "
                f"{self.batch_size}."
            )
        batches = order[:usable].reshape(self.num_batches, self.batch_size)
        for batch_indices in batches:
            window = self.windows[batch_indices]
            yield window[:, :-1], window[:, 1:]

    def batched_array(self) -> Tuple[np.ndarray, np.ndarray]:
        """All batches stacked: ``(steps, batch, window)`` x/y arrays (no shuffle)."""
        usable = self.num_batches * self.batch_size
        window = self.windows[:usable].reshape(
            self.num_batches, self.batch_size, self.window_size + 1
        )
        return window[:, :, :-1], window[:, :, 1:]


def load_events(filepaths, num_workers: int = 8, show_progress_bar: bool = False) -> np.ndarray:
    """Reference-API alias of :func:`load_event_ids` (models/__init__.py:160)."""
    return load_event_ids(
        filepaths, num_workers=num_workers, show_progress_bar=show_progress_bar
    )


# ------------------------------------------------------------- streaming path
#
# The reference's --use-generator mode streamed token ids file-by-file through
# a Python generator (models/__init__.py:147-158) so corpora larger than RAM
# could train. The equivalent here: one bounded-memory pass packs the
# decoded id stream into a flat little-endian int32 cache file on disk, and a
# StreamingWindowDataset gathers each batch's windows with os.pread — resident
# memory stays O(num_workers * largest file) during the pack and O(one batch)
# during training, while batch contents stay bit-identical to the in-memory
# WindowDataset (pinned in tests/test_streaming.py for the original).

def _iter_file_ids(filepaths, num_workers: int):
    """Yields each file's decoded int32 id array in order, decoding up to
    ``num_workers`` files ahead (bounded prefetch: never holds more than
    ``2 * num_workers`` decoded files)."""

    def _load(path):
        ids, _, _, _ = IntegerEncodedEventSequence.event_ids_from_file(
            path, as_numpy_array=True, numpy_dtype=np.int32
        )
        return ids

    if num_workers <= 1 or len(filepaths) <= 1:
        for path in filepaths:
            yield _load(path)
        return

    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        pending = deque()
        it = iter(filepaths)
        for path in itertools.islice(it, 2 * num_workers):
            pending.append(pool.submit(_load, path))
        for path in it:
            yield pending.popleft().result()
            pending.append(pool.submit(_load, path))
        while pending:
            yield pending.popleft().result()


def _corpus_cache_key(filepaths) -> str:
    """Cache identity = the ordered (path, size, mtime) list. Order matters:
    windows span file boundaries, so a different file order is a different
    token stream."""
    h = hashlib.sha1()
    for p in filepaths:
        stat = p.stat()
        h.update(f"{p}\x00{stat.st_size}\x00{stat.st_mtime_ns}\n".encode())
    return h.hexdigest()[:16]


def build_packed_cache(
    filepaths, cache_dir, num_workers: int = 8, show_progress_bar: bool = False
) -> Path:
    """Packs the concatenated id stream of ``filepaths`` into an int32 cache
    file under ``cache_dir``, streaming one file at a time (bounded memory).
    Returns the cache path; reuses an existing cache for the same ordered
    file list (keyed on paths + sizes + mtimes). Build is atomic (tmp file +
    rename), so a killed run never leaves a truncated cache behind."""
    filepaths = [Path(p) for p in filepaths]
    cache_dir = Path(cache_dir)
    cache_dir.mkdir(parents=True, exist_ok=True)
    cache = cache_dir / f"packed-{_corpus_cache_key(filepaths)}.i32"
    if cache.exists():
        logging.info("Reusing packed corpus cache '%s'.", cache)
        return cache

    iterator = _iter_file_ids(filepaths, num_workers)
    if show_progress_bar:
        import tqdm

        iterator = tqdm.tqdm(iterator, total=len(filepaths), unit="file")

    tmp = cache.with_name(cache.name + f".tmp{os.getpid()}")
    total = 0
    try:
        with open(tmp, "wb") as fh:
            for ids in iterator:
                data = np.ascontiguousarray(ids, dtype="<i4")
                fh.write(data.tobytes())
                total += data.shape[0]
        os.replace(tmp, cache)
    finally:
        if tmp.exists():
            tmp.unlink()
    logging.info(
        "Packed %d files (%d events, %.1f MB) into '%s'.",
        len(filepaths), total, total * 4 / 1e6, cache,
    )
    return cache


class StreamingWindowDataset:
    """Disk-backed :class:`WindowDataset`: same batches, O(batch) memory.

    Windows are gathered per batch with ``os.pread`` against the packed
    int32 cache file, so neither the corpus nor the window table is ever
    resident. Ordering, sharding, shuffling, and clamping reproduce
    :class:`WindowDataset` exactly (same rng stream), which the equality
    test in tests/test_streaming.py pins batch-for-batch for the original.
    """

    def __init__(
        self,
        cache_path,
        batch_size: int,
        window_size: int,
        shuffle: bool = True,
        seed: int = 0,
        shard_count: int = 1,
        shard_index: int = 0,
        clamp_batch: bool = False,
    ):
        self._path = Path(cache_path)
        self._fd = os.open(self._path, os.O_RDONLY)
        total_events = self._path.stat().st_size // 4
        stride = window_size + 1
        num_windows = total_events // stride
        if num_windows == 0:
            raise DatasetError(
                f"Token stream of {total_events} events is shorter than one "
                f"window ({stride} events)."
            )
        self._window_ids = np.arange(num_windows, dtype=np.int64)
        if shard_count > 1:
            self._window_ids = self._window_ids[shard_index::shard_count]
        if clamp_batch and self._window_ids.shape[0] < batch_size:
            batch_size = self._window_ids.shape[0]
        self._stride = stride
        self.batch_size = batch_size
        self.window_size = window_size
        self.shuffle = shuffle
        self._rng = np.random.default_rng(seed)
        self._epoch = 0

    def __del__(self):
        try:
            os.close(self._fd)
        except (OSError, AttributeError):
            pass

    @property
    def num_batches(self) -> int:
        return self._window_ids.shape[0] // self.batch_size

    def __len__(self) -> int:
        return self.num_batches

    def _read_windows(self, window_ids) -> np.ndarray:
        out = np.empty((len(window_ids), self._stride), dtype=np.int32)
        nbytes = self._stride * 4
        for row, w in enumerate(window_ids):
            buf = os.pread(self._fd, nbytes, int(w) * nbytes)
            if len(buf) != nbytes:
                raise DatasetError(
                    f"Short read from packed cache '{self._path}' at window {w}."
                )
            out[row] = np.frombuffer(buf, dtype="<i4")
        return out

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        order = np.arange(self._window_ids.shape[0])
        if self.shuffle:
            self._rng.shuffle(order)
        self._epoch += 1

        usable = self.num_batches * self.batch_size
        if usable == 0:
            raise DatasetError(
                f"{self._window_ids.shape[0]} windows cannot fill one batch of "
                f"{self.batch_size}."
            )
        batches = order[:usable].reshape(self.num_batches, self.batch_size)
        for batch_indices in batches:
            window = self._read_windows(self._window_ids[batch_indices])
            yield window[:, :-1], window[:, 1:]


def load_dataset(
    filepaths,
    batch_size: int,
    window_size: int,
    shuffle: bool = True,
    seed: int = 0,
    num_workers: int = 8,
    show_progress_bar: bool = False,
    shard_count: int = 1,
    shard_index: int = 0,
    clamp_batch: bool = False,
    streaming: bool = False,
    cache_dir=None,
) -> "WindowDataset | StreamingWindowDataset":
    """Loads ``.data`` files into a :class:`WindowDataset`.

    With ``streaming`` (the reference's ``--use-generator`` mode,
    models/__init__.py:147-158), the id stream is packed once into a
    disk cache under ``cache_dir`` (default: ``_packed_cache`` beside the
    first file) and batches are read back per-step with O(batch) resident
    memory — same batches as the in-memory path, corpora larger than RAM
    train fine.
    """
    # Materialize first: callers pass generators (e.g. Path.glob), and the
    # len() in the log line must not exhaust the iterator before loading.
    filepaths = list(filepaths)
    if streaming:
        if not filepaths:
            raise DatasetError("Cannot stream an empty dataset.")
        if cache_dir is None:
            cache_dir = Path(filepaths[0]).parent / "_packed_cache"
        cache = build_packed_cache(
            filepaths, cache_dir, num_workers=num_workers,
            show_progress_bar=show_progress_bar,
        )
        return StreamingWindowDataset(
            cache,
            batch_size=batch_size,
            window_size=window_size,
            shuffle=shuffle,
            seed=seed,
            shard_count=shard_count,
            shard_index=shard_index,
            clamp_batch=clamp_batch,
        )
    logging.info("Loading %d .data files into memory.", len(filepaths))
    stream = load_event_ids(filepaths, num_workers=num_workers, show_progress_bar=show_progress_bar)
    return WindowDataset(
        stream,
        batch_size=batch_size,
        window_size=window_size,
        shuffle=shuffle,
        seed=seed,
        shard_count=shard_count,
        shard_index=shard_index,
        clamp_batch=clamp_batch,
    )
