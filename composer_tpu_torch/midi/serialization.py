"""Binary serialization of event sequences — the ``.data`` on-disk ABI: the
port's copy of ``composer_tpu/midi/serialization.py``.

Format parity with the reference so existing datasets remain loadable:

* Integer encoding (sequence.py:1416-1866): little-endian
  ``u64 type_id (9223372036854775805)`` + header ``i16 x3`` (time_step_increment,
  max_time_steps, velocity_bins) + per-event ``i16 x2`` (type, value; value -1
  encodes None).
* One-hot encoding (sequence.py:1068-1414): ``u64 type_id (9223372036854775806)``
  + ``i32 count`` + count x ``i16 x3`` event ranges + ``i32 count`` + count x
  ``i16 x3`` event value ranges (start=stop=-1 encodes None) + ``i16``
  time_step_increment + per-event ``u8 x vocab_size`` one-hot vectors.

The bulk loaders are vectorized with NumPy (single ``frombuffer`` + arithmetic)
instead of the reference's per-event ``struct.unpack`` loop — this is the
tokenizer-throughput hot path (reference hot loop: sequence.py:1686-1692).
The original first tries its native C++ decoder (``composer_tpu.native``); the
port has no native codec yet (ROADMAP.md, Queue 1 item 5), so ids are always
decoded by the numpy path, ``Vocabulary.encode_pairs``.
"""

from __future__ import annotations

import struct
from collections import OrderedDict
from pathlib import Path

import numpy as np

from composer_tpu_torch.exceptions import EncodingError
from composer_tpu_torch.midi.events import Event, EventSequence, EventType
from composer_tpu_torch.midi.vocab import Vocabulary, get_vocabulary

INTEGER_ENCODING_TYPE_ID = 9223372036854775805
ONE_HOT_ENCODING_TYPE_ID = 9223372036854775806

_TYPE_ID_STRUCT = struct.Struct("<Q")
_INT_HEADER_STRUCT = struct.Struct("<hhh")

def _pairs_to_ids(pairs: np.ndarray, vocab: Vocabulary) -> np.ndarray:
    return vocab.encode_pairs(pairs[:, 0], pairs[:, 1])


def _read_type_id(buffer: bytes) -> int:
    if len(buffer) < _TYPE_ID_STRUCT.size:
        raise EncodingError("File too short to contain an encoding-type header.")
    return _TYPE_ID_STRUCT.unpack_from(buffer, 0)[0]


class IntegerEncodedEventSequence:
    """The compact integer (type, value) pair encoding used by ``.data`` files."""

    def __init__(self, time_step_increment, max_time_steps, velocity_bins, events=None):
        self.time_step_increment = time_step_increment
        self.max_time_steps = max_time_steps
        self.velocity_bins = velocity_bins
        # List of (int type, int value) tuples; value -1 encodes None.
        self.events = list(events) if events is not None else []

    @staticmethod
    def get_encoding_type() -> int:
        return INTEGER_ENCODING_TYPE_ID

    @classmethod
    def encode(cls, event_sequence: EventSequence) -> "IntegerEncodedEventSequence":
        pairs = [(int(e.type), e.encode_value()) for e in event_sequence.events]
        return cls(
            event_sequence.time_step_increment,
            event_sequence.max_time_steps,
            event_sequence.velocity_bins,
            pairs,
        )

    def decode(self) -> EventSequence:
        events = [
            Event(EventType(t), Event.decode_value(v)) for t, v in self.events
        ]
        return EventSequence(
            events, self.time_step_increment, self.max_time_steps, self.velocity_bins
        )

    # ------------------------------------------------------------------- I/O
    def to_bytes(self) -> bytes:
        header = _TYPE_ID_STRUCT.pack(INTEGER_ENCODING_TYPE_ID) + _INT_HEADER_STRUCT.pack(
            self.time_step_increment, self.max_time_steps, self.velocity_bins
        )
        body = np.asarray(self.events, dtype="<i2").tobytes() if self.events else b""
        return header + body

    def to_file(self, filepath) -> None:
        Path(filepath).write_bytes(self.to_bytes())

    @classmethod
    def _parse_header(cls, buffer: bytes):
        type_id = _read_type_id(buffer)
        if type_id != INTEGER_ENCODING_TYPE_ID:
            raise EncodingError(
                f"Not an integer-encoded event sequence (type id {type_id})."
            )
        offset = _TYPE_ID_STRUCT.size
        tsi, mts, vbins = _INT_HEADER_STRUCT.unpack_from(buffer, offset)
        return tsi, mts, vbins, offset + _INT_HEADER_STRUCT.size

    @staticmethod
    def _event_pairs(buffer: bytes, body_offset: int) -> np.ndarray:
        # Tolerate trailing garbage shorter than one event record, like the
        # reference's ``buffer_length // event_size`` loop (sequence.py:1577).
        usable = (len(buffer) - body_offset) // 4 * 4
        body = buffer[body_offset : body_offset + usable]
        return np.frombuffer(body, dtype="<i2").reshape(-1, 2)

    @classmethod
    def from_file(cls, filepath, decode: bool = False):
        buffer = Path(filepath).read_bytes()
        tsi, mts, vbins, body_offset = cls._parse_header(buffer)
        pairs = cls._event_pairs(buffer, body_offset)

        if decode:
            return EventSequence.from_arrays(pairs[:, 0], pairs[:, 1], tsi, mts, vbins)
        return cls(tsi, mts, vbins, [tuple(int(v) for v in row) for row in pairs])

    # -------------------------------------------------------------- bulk load
    @classmethod
    def event_ids_from_file(cls, filepath, as_numpy_array: bool = False, numpy_dtype=np.int64):
        """Loads a ``.data`` file directly as a flat event-id array.

        Returns ``(ids, event_value_ranges, event_ranges, settings)`` for
        API parity with the reference (sequence.py:1642-1695); the id
        computation itself is one vectorized pass.
        """
        buffer = Path(filepath).read_bytes()
        tsi, mts, vbins, body_offset = cls._parse_header(buffer)
        vocab = get_vocabulary(tsi, mts, vbins)

        pairs = cls._event_pairs(buffer, body_offset)
        ids = _pairs_to_ids(pairs, vocab)
        if as_numpy_array:
            ids = ids.astype(numpy_dtype)
        else:
            ids = ids.astype(np.uint16)

        settings = (tsi, mts, vbins)
        return ids, vocab.event_value_ranges, vocab.event_ranges, settings

    @classmethod
    def event_ids_from_file_as_generator(cls, filepath):
        ids, _, _, _ = cls.event_ids_from_file(filepath, as_numpy_array=True)
        yield from (int(i) for i in ids)

    @classmethod
    def one_hot_from_file_as_generator(cls, filepath, as_numpy_array: bool = False, numpy_dtype=np.float32):
        vectors, _, _, _ = cls.one_hot_from_file(
            filepath, as_numpy_array=True, numpy_dtype=numpy_dtype
        )
        yield from vectors

    @classmethod
    def one_hot_from_file(cls, filepath, as_numpy_array: bool = False, numpy_dtype=np.float32):
        ids, value_ranges, ranges, settings = cls.event_ids_from_file(
            filepath, as_numpy_array=True
        )
        vocab = get_vocabulary(*settings)
        vectors = np.zeros((ids.shape[0], vocab.size), dtype=numpy_dtype)
        vectors[np.arange(ids.shape[0]), ids] = 1
        if not as_numpy_array:
            vectors = vectors.astype(int).tolist()
        return vectors, value_ranges, ranges, settings

    # --------------------------------------------------- reference-compat ids
    @staticmethod
    def event_to_id(event_type, event_value, event_ranges, event_value_ranges) -> int:
        """id = event_ranges[type].start + (value - value_range.start)
        (sequence.py:1589-1612)."""
        offset = 0
        value_range = event_value_ranges[event_type]
        if value_range is not None:
            offset = event_value - value_range.start
        return event_ranges[event_type].start + offset

    @staticmethod
    def id_to_event(event_id, event_ranges, event_value_ranges) -> Event:
        for event_type, interval in event_ranges.items():
            if event_id in interval:
                value = None
                value_range = event_value_ranges[event_type]
                if value_range is not None:
                    value = event_id - interval.start + value_range.start
                return Event(event_type, value)
        raise EncodingError(f"Event id {event_id} matches no event range.")


class OneHotEncodedEventSequence:
    """One-hot vector encoding (kept for ABI parity; sequence.py:1068-1414)."""

    _RANGE_STRUCT = struct.Struct("<hhh")
    _COUNT_STRUCT = struct.Struct("<i")
    _TSI_STRUCT = struct.Struct("<h")

    def __init__(self, time_step_increment, event_ranges, event_value_ranges, vectors=None):
        self.time_step_increment = time_step_increment
        self.event_ranges = event_ranges
        self.event_value_ranges = event_value_ranges
        self.vectors = vectors if vectors is not None else []

    @staticmethod
    def get_encoding_type() -> int:
        return ONE_HOT_ENCODING_TYPE_ID

    @staticmethod
    def get_one_hot_size(event_ranges) -> int:
        return event_ranges[next(reversed(event_ranges))].stop

    @property
    def one_hot_size(self) -> int:
        return self.get_one_hot_size(self.event_ranges)

    @classmethod
    def encode(cls, event_sequence: EventSequence) -> "OneHotEncodedEventSequence":
        vocab = event_sequence.vocabulary
        ids = event_sequence.to_ids()
        vectors = np.zeros((ids.shape[0], vocab.size), dtype=np.uint8)
        if ids.size:
            vectors[np.arange(ids.shape[0]), ids] = 1
        return cls(
            event_sequence.time_step_increment,
            vocab.event_ranges,
            vocab.event_value_ranges,
            [row.tolist() for row in vectors],
        )

    def decode(self) -> EventSequence:
        if not self.vectors:
            max_steps = self.event_value_ranges[EventType.TIME_SHIFT].stop
            vbins = self.event_value_ranges[EventType.VELOCITY].stop
            return EventSequence([], self.time_step_increment, max_steps, vbins)

        matrix = np.asarray(self.vectors)
        if matrix.ndim != 2:
            raise EncodingError("Mismatched one-hot vector shapes.")
        ids = np.argmax(matrix, axis=1)

        events = [
            IntegerEncodedEventSequence.id_to_event(
                int(i), self.event_ranges, self.event_value_ranges
            )
            for i in ids
        ]
        # Recover the codec parameters from the value ranges
        # (sequence.py:1186-1195).
        max_steps = self.event_value_ranges[EventType.TIME_SHIFT].stop
        vbins = self.event_value_ranges[EventType.VELOCITY].stop
        return EventSequence(events, self.time_step_increment, max_steps, vbins)

    # ------------------------------------------------------------------- I/O
    def to_bytes(self) -> bytes:
        chunks = [_TYPE_ID_STRUCT.pack(ONE_HOT_ENCODING_TYPE_ID)]
        chunks.append(self._COUNT_STRUCT.pack(len(self.event_ranges)))
        for event_type, rng in self.event_ranges.items():
            chunks.append(self._RANGE_STRUCT.pack(int(event_type), rng.start, rng.stop))
        chunks.append(self._COUNT_STRUCT.pack(len(self.event_value_ranges)))
        for event_type, rng in self.event_value_ranges.items():
            start = rng.start if rng is not None else -1
            stop = rng.stop if rng is not None else -1
            chunks.append(self._RANGE_STRUCT.pack(int(event_type), start, stop))
        chunks.append(self._TSI_STRUCT.pack(self.time_step_increment))
        if self.vectors:
            chunks.append(np.asarray(self.vectors, dtype=np.uint8).tobytes())
        return b"".join(chunks)

    def to_file(self, filepath) -> None:
        Path(filepath).write_bytes(self.to_bytes())

    @classmethod
    def from_file(cls, filepath, decode: bool = False):
        buffer = Path(filepath).read_bytes()
        type_id = _read_type_id(buffer)
        if type_id != ONE_HOT_ENCODING_TYPE_ID:
            raise EncodingError(
                f"Not a one-hot encoded event sequence (type id {type_id})."
            )
        offset = _TYPE_ID_STRUCT.size

        def read_ranges(offset, allow_none):
            count = cls._COUNT_STRUCT.unpack_from(buffer, offset)[0]
            offset += cls._COUNT_STRUCT.size
            ranges = OrderedDict()
            for _ in range(count):
                type_value, start, stop = cls._RANGE_STRUCT.unpack_from(buffer, offset)
                offset += cls._RANGE_STRUCT.size
                rng = None
                if not (allow_none and start == -1 and stop == -1):
                    rng = range(start, stop)
                ranges[EventType(type_value)] = rng
            return ranges, offset

        event_ranges, offset = read_ranges(offset, allow_none=False)
        event_value_ranges, offset = read_ranges(offset, allow_none=True)
        time_step_increment = cls._TSI_STRUCT.unpack_from(buffer, offset)[0]
        offset += cls._TSI_STRUCT.size

        size = cls.get_one_hot_size(event_ranges)
        body = np.frombuffer(buffer, dtype=np.uint8, offset=offset)
        count = body.size // size
        vectors = body[: count * size].reshape(count, size)

        instance = cls(
            time_step_increment,
            event_ranges,
            event_value_ranges,
            [row.tolist() for row in vectors],
        )
        return instance.decode() if decode else instance

    @classmethod
    def event_as_one_hot_vector(
        cls, event, event_ranges, event_value_ranges, as_numpy_array=False, numpy_dtype=np.int64
    ):
        size = cls.get_one_hot_size(event_ranges)
        vector = np.zeros(size, dtype=numpy_dtype) if as_numpy_array else [0] * size
        index = IntegerEncodedEventSequence.event_to_id(
            event.type, event.value if event.value is not None else None, event_ranges, event_value_ranges
        )
        vector[index] = 1
        return vector

    @staticmethod
    def one_hot_vector_as_event(vector, event_ranges, event_value_ranges) -> Event:
        array = np.asarray(vector)
        hot_index = int(np.flatnonzero(array == 1)[0])
        return IntegerEncodedEventSequence.id_to_event(
            hot_index, event_ranges, event_value_ranges
        )


def write_event_pairs(filepath, types, values, time_step_increment, max_time_steps, velocity_bins):
    """Writes (type, value) arrays straight to the ``.data`` format (the
    zero-object fast path used by preprocessing)."""
    header = _TYPE_ID_STRUCT.pack(INTEGER_ENCODING_TYPE_ID) + _INT_HEADER_STRUCT.pack(
        time_step_increment, max_time_steps, velocity_bins
    )
    pairs = np.empty((len(types), 2), dtype="<i2")
    pairs[:, 0] = types
    pairs[:, 1] = values
    Path(filepath).write_bytes(header + pairs.tobytes())


_ENCODERS = {
    INTEGER_ENCODING_TYPE_ID: IntegerEncodedEventSequence,
    ONE_HOT_ENCODING_TYPE_ID: OneHotEncodedEventSequence,
}


def load(filepath, decode: bool = True):
    """Loads any encoded event-sequence file, dispatching on its type header."""
    with open(filepath, "rb") as handle:
        header = handle.read(_TYPE_ID_STRUCT.size)
    type_id = _read_type_id(header)
    encoder = _ENCODERS.get(type_id)
    if encoder is None:
        raise EncodingError(
            f"Cannot load '{filepath}': {type_id} is not a valid encoding type id."
        )
    return encoder.from_file(filepath, decode=decode)
