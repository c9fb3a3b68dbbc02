"""Dataset preprocessing, loading, and record export/import: the port's copy
of ``composer_tpu/data``."""

from composer_tpu_torch.data.loader import WindowDataset, load_dataset, load_event_ids
from composer_tpu_torch.data.preprocess import (
    convert_all,
    convert_file,
    get_processed_files,
    split_dataset,
)
from composer_tpu_torch.data.tfrecord import (
    TFRecordWindowDataset,
    export_dataset,
    index_records,
    load_tfrecord_dataset,
)

__all__ = [
    "TFRecordWindowDataset",
    "WindowDataset",
    "convert_all",
    "convert_file",
    "export_dataset",
    "get_processed_files",
    "index_records",
    "load_dataset",
    "load_event_ids",
    "load_tfrecord_dataset",
    "split_dataset",
]
