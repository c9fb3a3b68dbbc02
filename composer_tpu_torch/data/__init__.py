"""Dataset preprocessing and loading: the port's copy of
``composer_tpu/data`` (record export and import wait; ROADMAP.md, Queue 1
item 5)."""

from composer_tpu_torch.data.loader import WindowDataset, load_dataset, load_event_ids
from composer_tpu_torch.data.preprocess import (
    convert_all,
    convert_file,
    get_processed_files,
    split_dataset,
)

__all__ = [
    "WindowDataset",
    "convert_all",
    "convert_file",
    "get_processed_files",
    "load_dataset",
    "load_event_ids",
    "split_dataset",
]
