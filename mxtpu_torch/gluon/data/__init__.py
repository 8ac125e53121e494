"""Gluon data API (counterpart of mxtpu/gluon/data/). The vision datasets
(``data/vision.py``) need files that are not in the repository, so
``data.vision`` raises."""
from ...base import MXNetError
from .dataset import ArrayDataset, Dataset, RecordFileDataset, SimpleDataset
from .sampler import BatchSampler, RandomSampler, Sampler, SequentialSampler
from .dataloader import DataLoader


def __getattr__(name):
    if name == "vision":
        raise MXNetError("gluon.data.vision needs dataset files that are "
                         "not in the repository; not ported yet")
    raise AttributeError(name)
