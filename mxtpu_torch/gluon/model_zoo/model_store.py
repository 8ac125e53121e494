"""Pretrained-model store: a copy of mxtpu/gluon/model_zoo/model_store.py
(parity: python/mxnet/gluon/model_zoo/model_store.py).

Looks in the local root only; never downloads."""
from __future__ import annotations

import os

from ...base import MXNetError

_model_sha1 = {}


def get_model_file(name, root=os.path.join("~", ".mxnet", "models")):
    root = os.path.expanduser(root)
    file_path = os.path.join(root, "%s.params" % name)
    if os.path.exists(file_path):
        return file_path
    raise MXNetError(
        "Pretrained model file %s is not found (no network access; place "
        "params under %s)" % (name, root))


def purge(root=os.path.join("~", ".mxnet", "models")):
    root = os.path.expanduser(root)
    if os.path.isdir(root):
        for f in os.listdir(root):
            if f.endswith(".params"):
                os.remove(os.path.join(root, f))


def load_pretrained(net, name, ctx=None,
                    root=os.path.join("~", ".mxnet", "models")):
    """Load locally-stored pretrained params into net (offline store)."""
    net.load_params(get_model_file(name, root), ctx=ctx)
