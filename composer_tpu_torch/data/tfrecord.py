"""TF-free TFRecord export/import: the port's copy of
``composer_tpu/data/tfrecord.py``.

The reference exported datasets as TFRecords of ``tf.train.Example`` records
(cli.py:346-380) and read them back with tf.data (models/__init__.py:315-374).
This module reimplements the whole stack — record framing, the Example
protobuf, and TensorProto serialization — directly, so the framework reads and
writes byte-compatible ``.tfrecord`` files without importing TensorFlow:

* framing: ``u64 length | u32 masked_crc(length) | data | u32 masked_crc(data)``
  with CRC32-C (Castagnoli) and the TFRecord mask.
* ``Example``: hand-rolled protobuf wire format (Features map of
  BytesList/FloatList/Int64List features).
* ``TensorProto``: dtype + shape + raw little-endian ``tensor_content``.

Record schema parity: record 0 is a header Example {model_type: bytes,
batch_size: int64, window_size: int64}; records 1..N are per-batch Examples
{x, y} of serialized int32 tensors shaped [batch, window].
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Iterator, Tuple

import numpy as np

from composer_tpu_torch import native
from composer_tpu_torch.exceptions import DatasetError

# --------------------------------------------------------------------- crc32c

_CRC32C_POLY = 0x82F63B78


def _make_crc_table() -> np.ndarray:
    table = np.zeros(256, dtype=np.uint32)
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (_CRC32C_POLY if crc & 1 else 0)
        table[i] = crc
    return table


_CRC_TABLE = _make_crc_table()
_CRC_TABLE_LIST = _CRC_TABLE.tolist()  # plain ints are faster in the Python loop


def crc32c(data: bytes) -> int:
    """CRC32-C (Castagnoli) of ``data``: the native library's where it is
    built (``composer_tpu_torch.native``), else the table loop below."""
    if native.available():
        return native.crc32c(data)
    crc = 0xFFFFFFFF
    table = _CRC_TABLE_LIST
    for byte in data:
        crc = (crc >> 8) ^ table[(crc ^ byte) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF)


# -------------------------------------------------------------------- framing

def write_records(filepath, records) -> None:
    with open(filepath, "wb") as handle:
        for record in records:
            header = struct.pack("<Q", len(record))
            handle.write(header)
            handle.write(struct.pack("<I", _masked_crc(header)))
            handle.write(record)
            handle.write(struct.pack("<I", _masked_crc(record)))


def read_records(filepath, verify_crc: bool = True) -> Iterator[bytes]:
    data = Path(filepath).read_bytes()
    offset = 0
    while offset < len(data):
        if offset + 12 > len(data):
            raise DatasetError(f"Truncated TFRecord file: '{filepath}'.")
        (length,) = struct.unpack_from("<Q", data, offset)
        (length_crc,) = struct.unpack_from("<I", data, offset + 8)
        if verify_crc and _masked_crc(data[offset : offset + 8]) != length_crc:
            raise DatasetError(f"Corrupt TFRecord length CRC in '{filepath}'.")
        offset += 12
        record = data[offset : offset + length]
        if len(record) != length:
            raise DatasetError(f"Truncated TFRecord payload in '{filepath}'.")
        offset += length
        if offset + 4 > len(data):
            raise DatasetError(f"Truncated TFRecord payload CRC in '{filepath}'.")
        (record_crc,) = struct.unpack_from("<I", data, offset)
        if verify_crc and _masked_crc(record) != record_crc:
            raise DatasetError(f"Corrupt TFRecord payload CRC in '{filepath}'.")
        offset += 4
        yield record


# ------------------------------------------------------------- protobuf wire

def _varint(value: int) -> bytes:
    if value < 0:
        value += 1 << 64  # protobuf encodes negative int64 as 10-byte varints
    out = bytearray()
    while True:
        byte = value & 0x7F
        value >>= 7
        if value:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _read_varint(data: bytes, offset: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        byte = data[offset]
        offset += 1
        result |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return result, offset
        shift += 7


def _tag(field: int, wire_type: int) -> bytes:
    return _varint((field << 3) | wire_type)


def _length_delimited(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def _iter_fields(data: bytes):
    """Yields (field_number, wire_type, value) where value is int or bytes."""
    offset = 0
    while offset < len(data):
        key, offset = _read_varint(data, offset)
        field, wire_type = key >> 3, key & 0x07
        if wire_type == 0:
            value, offset = _read_varint(data, offset)
        elif wire_type == 1:
            value = data[offset : offset + 8]
            offset += 8
        elif wire_type == 2:
            length, offset = _read_varint(data, offset)
            value = data[offset : offset + length]
            offset += length
        elif wire_type == 5:
            value = data[offset : offset + 4]
            offset += 4
        else:
            raise DatasetError(f"Unsupported protobuf wire type: {wire_type}")
        yield field, wire_type, value


# -------------------------------------------------------- tf.train.Example

def _encode_feature(value) -> bytes:
    """Encodes a Feature message from bytes / ints / floats (or lists thereof)."""
    if isinstance(value, (bytes, bytearray, str)):
        value = [value]
    elif isinstance(value, (int, np.integer, float, np.floating)):
        value = [value]
    value = list(value)

    if value and isinstance(value[0], (bytes, bytearray, str)):
        items = b"".join(
            _length_delimited(1, v.encode() if isinstance(v, str) else bytes(v))
            for v in value
        )
        return _length_delimited(1, items)  # bytes_list = field 1
    if value and isinstance(value[0], (float, np.floating)):
        packed = struct.pack(f"<{len(value)}f", *value)
        return _length_delimited(2, _length_delimited(1, packed))  # float_list
    packed = b"".join(_varint(int(v)) for v in value)
    return _length_delimited(3, _length_delimited(1, packed))  # int64_list


def make_example(features: dict) -> bytes:
    """Builds a serialized tf.train.Example from a {name: value} dict."""
    entries = b""
    for name, value in features.items():
        feature = _encode_feature(value)
        entry = _length_delimited(1, name.encode()) + _length_delimited(2, feature)
        entries += _length_delimited(1, entry)
    return _length_delimited(1, entries)  # Example.features = field 1


def parse_example(data: bytes) -> dict:
    """Parses a serialized Example into {name: list_of_values}."""
    result = {}
    for field, _, features_bytes in _iter_fields(data):
        if field != 1:
            continue
        for entry_field, _, entry in _iter_fields(features_bytes):
            if entry_field != 1:
                continue
            name = None
            feature_bytes = b""
            for map_field, _, value in _iter_fields(entry):
                if map_field == 1:
                    name = value.decode()
                elif map_field == 2:
                    feature_bytes = value
            values = []
            for kind, _, payload in _iter_fields(feature_bytes):
                if kind == 1:  # BytesList
                    values = [v for f, _, v in _iter_fields(payload) if f == 1]
                elif kind == 2:  # FloatList (packed)
                    for f, wt, v in _iter_fields(payload):
                        if f == 1 and wt == 2:
                            values = list(struct.unpack(f"<{len(v) // 4}f", v))
                        elif f == 1 and wt == 5:
                            values.append(struct.unpack("<f", v)[0])
                elif kind == 3:  # Int64List (packed)
                    for f, wt, v in _iter_fields(payload):
                        if f == 1 and wt == 2:
                            offset = 0
                            while offset < len(v):
                                item, offset = _read_varint(v, offset)
                                if item >= 1 << 63:
                                    item -= 1 << 64
                                values.append(item)
                        elif f == 1 and wt == 0:
                            if v >= 1 << 63:
                                v -= 1 << 64
                            values.append(v)
            if name is not None:
                result[name] = values
    return result


# ------------------------------------------------------------- TensorProto

_DTYPE_TO_ENUM = {np.dtype(np.float32): 1, np.dtype(np.int32): 3, np.dtype(np.int64): 9}
_ENUM_TO_DTYPE = {v: k for k, v in _DTYPE_TO_ENUM.items()}


def serialize_tensor(array: np.ndarray) -> bytes:
    """Serializes an array as a TensorProto (matches tf.io.serialize_tensor)."""
    array = np.ascontiguousarray(array)
    enum = _DTYPE_TO_ENUM.get(array.dtype)
    if enum is None:
        raise DatasetError(f"Unsupported tensor dtype for TFRecord export: {array.dtype}")
    shape = b"".join(
        _length_delimited(2, _tag(1, 0) + _varint(dim)) for dim in array.shape
    )
    proto = _tag(1, 0) + _varint(enum)
    proto += _length_delimited(2, shape)
    proto += _length_delimited(4, array.astype(array.dtype.newbyteorder("<")).tobytes())
    return proto


def parse_tensor(data: bytes) -> np.ndarray:
    dtype = None
    dims = []
    content = b""
    int_vals = []
    for field, wire_type, value in _iter_fields(data):
        if field == 1:
            dtype = _ENUM_TO_DTYPE.get(value)
            if dtype is None:
                raise DatasetError(f"Unsupported TensorProto dtype enum: {value}")
        elif field == 2:
            for shape_field, _, dim_bytes in _iter_fields(value):
                if shape_field == 2:
                    for dim_field, _, size in _iter_fields(dim_bytes):
                        if dim_field == 1:
                            dims.append(size)
        elif field == 4:
            content = value
        elif field in (5, 6, 7, 9) and wire_type == 0:
            int_vals.append(value)
    if dtype is None:
        raise DatasetError("TensorProto missing dtype.")
    if content:
        array = np.frombuffer(content, dtype=dtype.newbyteorder("<")).astype(dtype)
    else:
        array = np.asarray(int_vals, dtype=dtype)
    return array.reshape(dims)


# --------------------------------------------------------- dataset schema

def export_dataset(dataset, model_type: str, output_path) -> None:
    """Exports a WindowDataset-like iterable of (x, y) batches as a TFRecord.

    Record schema matches the reference exporter (cli.py:363-378).
    """

    def _records():
        iterator = iter(dataset)
        try:
            first_x, first_y = next(iterator)
        except StopIteration:
            raise DatasetError("Cannot export an empty dataset.") from None
        batch_size, window_size = first_x.shape
        yield make_example(
            {
                "model_type": model_type.encode(),
                "batch_size": int(batch_size),
                "window_size": int(window_size),
            }
        )
        for x, y in _chain_first((first_x, first_y), iterator):
            yield make_example(
                {
                    "x": serialize_tensor(np.asarray(x, dtype=np.int32)),
                    "y": serialize_tensor(np.asarray(y, dtype=np.int32)),
                }
            )

    write_records(output_path, _records())


def _chain_first(first, rest):
    yield first
    yield from rest


def index_records(filepath):
    """One cheap pass over a TFRecord file: returns ``(mmap, offsets)`` where
    ``offsets`` is a list of (payload_offset, length) per record.

    Only the 12-byte length headers are touched (and their CRCs verified);
    payload bytes stay untouched on disk until a record is actually read, so
    indexing a multi-GB file costs O(records), not O(bytes).
    """
    import mmap

    fh = open(filepath, "rb")
    try:
        data = mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ)
    except ValueError:  # empty file cannot be mmapped
        fh.close()
        raise DatasetError(f"Empty TFRecord file: '{filepath}'.") from None
    offsets = []
    offset = 0
    size = len(data)
    while offset < size:
        if offset + 12 > size:
            raise DatasetError(f"Truncated TFRecord file: '{filepath}'.")
        (length,) = struct.unpack_from("<Q", data, offset)
        (length_crc,) = struct.unpack_from("<I", data, offset + 8)
        if _masked_crc(data[offset : offset + 8]) != length_crc:
            raise DatasetError(f"Corrupt TFRecord length CRC in '{filepath}'.")
        payload_offset = offset + 12
        end = payload_offset + length + 4
        if end > size:
            raise DatasetError(f"Truncated TFRecord payload in '{filepath}'.")
        offsets.append((payload_offset, length))
        offset = end
    return data, offsets


def _record_at(data, entry, filepath="<tfrecord>", verify_crc=True):
    payload_offset, length = entry
    record = bytes(data[payload_offset : payload_offset + length])
    if verify_crc:
        (record_crc,) = struct.unpack_from("<I", data, payload_offset + length)
        if _masked_crc(record) != record_crc:
            raise DatasetError(f"Corrupt TFRecord payload CRC in '{filepath}'.")
    return record


class TFRecordWindowDataset:
    """Iterable of (x, y) batches from a TFRecord, trainer-compatible.

    Matches the reference's load path (models/__init__.py:315-374): batches
    come pre-shaped from the record; shuffling reorders batches per epoch.

    Two modes: the legacy in-memory list of batches, or (via
    :meth:`from_file`) a streaming view over an mmap'd record index — each
    epoch decodes batches on access in shuffled order, so resident memory is
    O(one batch + index) regardless of dataset size (payload CRCs are
    verified lazily, on first read of each record).
    """

    def __init__(self, header, batches, shuffle=True, seed=0,
                 shard_count=1, shard_index=0):
        self.header = header
        self.window_size = header["window_size"]
        self.batches = batches
        self.shuffle = shuffle
        self._rng = np.random.default_rng(seed)
        self._mmap = None
        self._offsets = None
        self._filepath = None
        self._crc_checked = None
        # Multi-host: each process takes a disjoint row slice of every
        # pre-shaped batch, so assembling the per-host rows over the data
        # mesh axis (mesh.make_global_batch) reconstructs exactly the
        # exported global batch.
        if header["batch_size"] % shard_count != 0:
            raise DatasetError(
                f"TFRecord batch size {header['batch_size']} is not divisible "
                f"by the process count {shard_count}; re-export with a "
                "divisible batch size for multi-host training."
            )
        self._rows = slice(
            shard_index * (header["batch_size"] // shard_count),
            (shard_index + 1) * (header["batch_size"] // shard_count),
        )
        self.batch_size = header["batch_size"] // shard_count

    @classmethod
    def from_file(cls, filepath, shuffle=True, seed=0,
                  shard_count=1, shard_index=0):
        """Streaming dataset over ``filepath``; returns (header, dataset)."""
        data, offsets = index_records(filepath)
        if not offsets:
            raise DatasetError(f"Empty TFRecord file: '{filepath}'.")
        header = _parse_header_record(
            _record_at(data, offsets[0], filepath), filepath
        )
        dataset = cls(header, batches=None, shuffle=shuffle, seed=seed,
                      shard_count=shard_count, shard_index=shard_index)
        dataset._mmap = data
        dataset._offsets = offsets[1:]
        dataset._filepath = str(filepath)
        dataset._crc_checked = np.zeros(len(dataset._offsets), dtype=bool)
        return header, dataset

    def _decode(self, index):
        # Payload CRCs are verified the first time a record is read; later
        # epochs skip the (pure-Python-fallback) CRC pass over the bytes.
        record = _record_at(
            self._mmap, self._offsets[index], self._filepath,
            verify_crc=not self._crc_checked[index],
        )
        self._crc_checked[index] = True
        fields = parse_example(record)
        shape = (self.header["batch_size"], self.window_size)
        x = parse_tensor(fields["x"][0]).reshape(shape)
        y = parse_tensor(fields["y"][0]).reshape(shape)
        return (
            x[self._rows].astype(np.int32),
            y[self._rows].astype(np.int32),
        )

    def __len__(self):
        if self.batches is not None:
            return len(self.batches)
        return len(self._offsets)

    def __iter__(self):
        order = np.arange(len(self))
        if self.shuffle:
            self._rng.shuffle(order)
        for index in order:
            if self.batches is not None:
                x, y = self.batches[index]
                yield x[self._rows], y[self._rows]
            else:
                yield self._decode(index)


def _parse_header_record(record, filepath):
    header_fields = parse_example(record)
    try:
        return {
            "model_type": header_fields["model_type"][0].decode(),
            "batch_size": int(header_fields["batch_size"][0]),
            "window_size": int(header_fields["window_size"][0]),
        }
    except (KeyError, IndexError):
        raise DatasetError(
            f"Missing TFRecord header record in '{filepath}'."
        ) from None


def load_tfrecord_dataset(filepath):
    """Loads a TFRecord dataset fully into memory: (header, [(x, y)]).

    For large files prefer ``TFRecordWindowDataset.from_file`` (streaming).
    """
    records = read_records(filepath)
    try:
        header_record = next(records)
    except StopIteration:
        raise DatasetError(f"Empty TFRecord file: '{filepath}'.") from None
    header = _parse_header_record(header_record, filepath)

    shape = (header["batch_size"], header["window_size"])
    batches = []
    for record in records:
        fields = parse_example(record)
        x = parse_tensor(fields["x"][0]).reshape(shape)
        y = parse_tensor(fields["y"][0]).reshape(shape)
        batches.append((x.astype(np.int32), y.astype(np.int32)))
    return header, batches
