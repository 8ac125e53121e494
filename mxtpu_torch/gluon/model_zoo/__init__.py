"""Model zoo (counterpart of mxtpu/gluon/model_zoo/). No pretrained
weights are in the repository, so ``model_store`` is not ported."""
from ...base import MXNetError
from . import vision


def __getattr__(name):
    if name == "model_store":
        raise MXNetError("model_store needs pretrained weight files, which "
                         "are not in the repository")
    raise AttributeError(name)
