"""Symbol-level model factories ported so far: the transformer LM and the
image-classification zoo (copies of ``mxtpu/models``), plus the serving
fixtures."""
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
from . import serving_fixtures
from .serving_fixtures import get_fixture as get_serving_fixture
from .transformer import get_symbol as get_transformer_lm
from .resnet import get_symbol as get_resnet
from .inception_bn import get_symbol as get_inception_bn
from .vgg import get_symbol as get_vgg
from .alexnet import get_symbol as get_alexnet
from .lenet import get_symbol as get_lenet
from .mlp import get_symbol as get_mlp

__all__ = ["transformer", "resnet", "resnet_v1", "resnext", "mobilenet",
           "inception_bn", "vgg", "alexnet", "lenet", "mlp",
           "serving_fixtures", "get_serving_fixture", "get_transformer_lm",
           "get_resnet", "get_inception_bn", "get_vgg", "get_alexnet",
           "get_lenet", "get_mlp"]
