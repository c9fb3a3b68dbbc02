"""The port's ``.tfrecord`` layer (``composer_tpu_torch/data/tfrecord.py``)
against the JAX package's (``composer_tpu/data/tfrecord.py``): byte-identical
files from the same ``WindowDataset``, each package reading the other's file,
framing and CRC checks, the streaming reader against the in-memory one, and
TensorFlow's own reader and writer where TensorFlow is installed. The cases
of ``tests/test_data_pipeline.py``'s TFRecord tests, on the port."""

import numpy as np
import pytest
import torch

from composer_tpu.data import tfrecord as jax_tfrecord
from composer_tpu.data.loader import WindowDataset as JaxWindowDataset
from composer_tpu_torch.data import WindowDataset, tfrecord
from composer_tpu_torch.exceptions import DatasetError


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The models here are tiny: one intra-op thread runs them fastest, and
    beside other test workers more threads only contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _dataset(module_class, length, batch, window, seed=None):
    stream = (np.arange(length) % 50).astype(np.int32) if seed is None else \
        np.random.default_rng(seed).integers(0, 390, length).astype(np.int32)
    return module_class(stream, batch_size=batch, window_size=window, shuffle=False)


def test_tfrecord_roundtrip(tmp_path):
    stream = np.arange(0, 330, dtype=np.int32) % 300
    dataset = WindowDataset(stream, batch_size=2, window_size=10, shuffle=False)
    path = tmp_path / "dataset.tfrecord"
    tfrecord.export_dataset(dataset, "transformer", path)

    header, batches = tfrecord.load_tfrecord_dataset(path)
    assert header == {"model_type": "transformer", "batch_size": 2, "window_size": 10}
    original = list(dataset)
    assert len(batches) == len(original)
    for (x, y), (ox, oy) in zip(batches, original):
        np.testing.assert_array_equal(x, ox)
        np.testing.assert_array_equal(y, oy)


@pytest.mark.parametrize("model_type,length,batch,window", [
    ("transformer", 4000, 4, 16), ("music_rnn", 2500, 3, 20), ("transformer", 120, 1, 100)])
def test_export_is_byte_identical_to_the_original(tmp_path, model_type, length, batch, window):
    ours, theirs = tmp_path / "ours.tfrecord", tmp_path / "theirs.tfrecord"
    tfrecord.export_dataset(_dataset(WindowDataset, length, batch, window, seed=3),
                            model_type, ours)
    jax_tfrecord.export_dataset(_dataset(JaxWindowDataset, length, batch, window, seed=3),
                                model_type, theirs)
    assert ours.read_bytes() == theirs.read_bytes()


@pytest.mark.parametrize("writer", ["ours", "theirs"])
def test_each_package_reads_the_others_file(tmp_path, writer):
    dataset = _dataset(WindowDataset, 2000, 4, 16, seed=4)
    path = tmp_path / "x.tfrecord"
    (tfrecord if writer == "ours" else jax_tfrecord).export_dataset(dataset, "transformer", path)
    reader = jax_tfrecord if writer == "ours" else tfrecord
    header, batches = reader.load_tfrecord_dataset(path)
    assert header == {"model_type": "transformer", "batch_size": 4, "window_size": 16}
    for shuffle in (False, True):
        _, streamed = reader.TFRecordWindowDataset.from_file(path, shuffle=shuffle, seed=7)
        _, ours = tfrecord.TFRecordWindowDataset.from_file(path, shuffle=shuffle, seed=7)
        pairs = list(zip(ours, streamed))
        assert len(pairs) == len(dataset) == len(batches)
        for (x, y), (x0, y0) in pairs:
            np.testing.assert_array_equal(x, x0)
            np.testing.assert_array_equal(y, y0)


def test_tfrecord_crc_detects_corruption(tmp_path):
    path = tmp_path / "x.tfrecord"
    tfrecord.write_records(path, [b"hello world"])
    raw = bytearray(path.read_bytes())
    raw[14] ^= 0xFF  # flip a payload byte
    path.write_bytes(bytes(raw))
    with pytest.raises(DatasetError):
        list(tfrecord.read_records(path))


def test_truncated_payload_crc_raises_dataset_error(tmp_path):
    path = tmp_path / "t.tfrecord"
    tfrecord.write_records(path, [b"payload-bytes"])
    path.write_bytes(path.read_bytes()[:-2])  # cut inside the trailing payload CRC
    with pytest.raises(DatasetError):
        list(tfrecord.read_records(path))


def test_empty_file_raises_dataset_error(tmp_path):
    path = tmp_path / "empty.tfrecord"
    path.write_bytes(b"")
    for module in (tfrecord, jax_tfrecord):
        with pytest.raises(module.DatasetError, match="Empty TFRecord file"):
            module.TFRecordWindowDataset.from_file(path)


def test_tfrecord_streaming_matches_in_memory(tmp_path):
    """``from_file`` (mmap + lazy decode) yields the in-memory batches,
    shuffling included (same seed), over two epochs."""
    dataset = _dataset(WindowDataset, 4000, 4, 16)
    path = tmp_path / "stream.tfrecord"
    tfrecord.export_dataset(dataset, "transformer", path)

    header_m, batches = tfrecord.load_tfrecord_dataset(path)
    header_s, streaming = tfrecord.TFRecordWindowDataset.from_file(path, shuffle=True, seed=7)
    assert header_s == header_m
    in_memory = tfrecord.TFRecordWindowDataset(header_m, batches, shuffle=True, seed=7)
    assert len(streaming) == len(in_memory) == len(batches)
    for _ in range(2):  # the second epoch reshuffles identically in both modes
        for (sx, sy), (mx, my) in zip(streaming, in_memory):
            np.testing.assert_array_equal(sx, mx)
            np.testing.assert_array_equal(sy, my)


def test_tfrecord_streaming_detects_payload_corruption(tmp_path):
    path = tmp_path / "corrupt.tfrecord"
    tfrecord.export_dataset(_dataset(WindowDataset, 500, 2, 8), "transformer", path)
    raw = bytearray(path.read_bytes())
    raw[len(raw) // 2] ^= 0xFF  # flip a payload byte in some record
    path.write_bytes(bytes(raw))
    with pytest.raises(DatasetError):
        _, streaming = tfrecord.TFRecordWindowDataset.from_file(path, shuffle=False)
        for _ in streaming:
            pass


def test_tfrecord_streaming_crc_verified_once(tmp_path, monkeypatch):
    """Payload CRCs are checked on the first read of each record only."""
    path = tmp_path / "crc_once.tfrecord"
    tfrecord.export_dataset(_dataset(WindowDataset, 600, 2, 8), "transformer", path)
    _, streaming = tfrecord.TFRecordWindowDataset.from_file(path, shuffle=False)

    calls = []
    real = tfrecord._masked_crc
    monkeypatch.setattr(tfrecord, "_masked_crc", lambda b: calls.append(1) or real(b))
    first = list(streaming)
    assert len(calls) == len(streaming)  # one payload CRC per record
    second = list(streaming)
    assert len(calls) == len(streaming)  # none on the second epoch
    for (ax, ay), (bx, by) in zip(first, second):
        np.testing.assert_array_equal(ax, bx)
        np.testing.assert_array_equal(ay, by)


def test_tfrecord_row_sharding_reassembles_global_batch(tmp_path):
    path = tmp_path / "sharded.tfrecord"
    tfrecord.export_dataset(_dataset(WindowDataset, 800, 4, 8), "transformer", path)
    _, full = tfrecord.TFRecordWindowDataset.from_file(path, shuffle=False)
    shards = [tfrecord.TFRecordWindowDataset.from_file(path, shuffle=False, shard_count=2,
                                                        shard_index=i)[1] for i in range(2)]
    assert all(s.batch_size == 2 for s in shards)
    for (fx, fy), (ax, ay), (bx, by) in zip(full, *shards):
        np.testing.assert_array_equal(fx, np.concatenate([ax, bx]))
        np.testing.assert_array_equal(fy, np.concatenate([ay, by]))
    with pytest.raises(DatasetError):
        tfrecord.TFRecordWindowDataset.from_file(path, shuffle=False, shard_count=3)


def test_evaluate_runs_on_streaming_tfrecord(tmp_path):
    """The port's ``Trainer.evaluate`` on a streaming ``.tfrecord`` equals it
    on the ``WindowDataset`` that was exported."""
    from composer_tpu_torch.models import ModelType
    from composer_tpu_torch.models.transformer import Transformer, TransformerConfig
    from composer_tpu_torch.train.trainer import Trainer

    dataset = _dataset(WindowDataset, 1200, 2, 8)
    path = tmp_path / "eval.tfrecord"
    tfrecord.export_dataset(dataset, "transformer", path)
    _, streaming = tfrecord.TFRecordWindowDataset.from_file(path, shuffle=False)

    model = Transformer(TransformerConfig(vocab_size=50, embed_dim=16, window_size=8,
                                          num_layers=1, num_heads=2))
    trainer = Trainer(model, ModelType.TRANSFORMER, 1e-3, device="cpu")
    state = trainer.init_state(2, 8)
    streamed = trainer.evaluate(streaming, state, scan_chunk=4)
    in_memory = trainer.evaluate(dataset, state, scan_chunk=4)
    assert streamed["loss"] == pytest.approx(in_memory["loss"], rel=1e-6)
    assert streamed["accuracy"] == pytest.approx(in_memory["accuracy"], rel=1e-6)


def test_tfrecord_compatible_with_tensorflow(tmp_path):
    """Byte-level compatibility with TF's own reader and writer, both ways."""
    tf = pytest.importorskip("tensorflow")

    ours = tmp_path / "ours.tfrecord"
    tfrecord.export_dataset(_dataset(WindowDataset, 132, 1, 10), "transformer", ours)
    records = list(tf.data.TFRecordDataset([str(ours)]).as_numpy_iterator())
    header = tf.io.parse_single_example(records[0], {
        "model_type": tf.io.FixedLenFeature([], tf.string),
        "batch_size": tf.io.FixedLenFeature([], tf.int64),
        "window_size": tf.io.FixedLenFeature([], tf.int64)})
    assert header["model_type"].numpy() == b"transformer"
    assert int(header["batch_size"].numpy()) == 1
    body = tf.io.parse_single_example(records[1], {
        "x": tf.io.FixedLenFeature([], tf.string), "y": tf.io.FixedLenFeature([], tf.string)})
    x = tf.io.parse_tensor(body["x"].numpy(), tf.int32).numpy()
    np.testing.assert_array_equal(x, np.arange(10)[None, :])

    def feature(**kwargs):
        return tf.train.Feature(**kwargs)

    theirs = tmp_path / "theirs.tfrecord"
    x = np.arange(10, dtype=np.int32)[None, :]
    with tf.io.TFRecordWriter(str(theirs)) as writer:
        writer.write(tf.train.Example(features=tf.train.Features(feature={
            "model_type": feature(bytes_list=tf.train.BytesList(value=[b"transformer"])),
            "batch_size": feature(int64_list=tf.train.Int64List(value=[1])),
            "window_size": feature(int64_list=tf.train.Int64List(value=[10]))}))
            .SerializeToString())
        writer.write(tf.train.Example(features=tf.train.Features(feature={
            name: feature(bytes_list=tf.train.BytesList(
                value=[tf.io.serialize_tensor(value).numpy()]))
            for name, value in (("x", x), ("y", x + 1))})).SerializeToString())
    header, batches = tfrecord.load_tfrecord_dataset(theirs)
    assert header["model_type"] == "transformer"
    np.testing.assert_array_equal(batches[0][0], np.arange(10)[None, :])
    np.testing.assert_array_equal(batches[0][1], np.arange(1, 11)[None, :])
