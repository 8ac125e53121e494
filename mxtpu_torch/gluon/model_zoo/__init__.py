"""Model zoo (counterpart of mxtpu/gluon/model_zoo/; parity:
python/mxnet/gluon/model_zoo/)."""
from . import vision
from . import model_store
