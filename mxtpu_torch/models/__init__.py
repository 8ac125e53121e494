"""Symbol-level model factories: the transformer LM, the image-
classification zoo, the SSD detector and the Faster R-CNN (copies of
``mxtpu/models`` and of the rcnn example), plus the serving fixtures."""
from . import transformer
from . import resnet
from . import resnet_v1
from . import resnext
from . import mobilenet
from . import inception_bn
from . import vgg
from . import alexnet
from . import lenet
from . import mlp
from . import ssd
from . import rcnn
from . import googlenet
from . import inception_v3
from . import inception_v4
from . import inception_resnet_v2
from . import serving_fixtures
from .serving_fixtures import get_fixture as get_serving_fixture
from .transformer import get_symbol as get_transformer_lm
from .resnet import get_symbol as get_resnet
from .inception_bn import get_symbol as get_inception_bn
from .vgg import get_symbol as get_vgg
from .alexnet import get_symbol as get_alexnet
from .lenet import get_symbol as get_lenet
from .mlp import get_symbol as get_mlp
from .googlenet import get_symbol as get_googlenet
from .inception_v3 import get_symbol as get_inception_v3

__all__ = ["transformer", "resnet", "resnet_v1", "resnext", "mobilenet",
           "inception_bn", "vgg", "alexnet", "lenet", "mlp", "ssd", "rcnn",
           "serving_fixtures", "get_serving_fixture", "get_transformer_lm",
           "get_resnet", "get_inception_bn", "get_vgg", "get_alexnet",
           "get_lenet", "get_mlp", "googlenet", "inception_v3",
           "inception_v4", "inception_resnet_v2", "get_googlenet",
           "get_inception_v3"]
