"""Gluon data API (counterpart of mxtpu/gluon/data/; parity:
python/mxnet/gluon/data/)."""
from .dataset import ArrayDataset, Dataset, RecordFileDataset, SimpleDataset
from .sampler import BatchSampler, RandomSampler, Sampler, SequentialSampler
from .dataloader import DataLoader
from . import vision
