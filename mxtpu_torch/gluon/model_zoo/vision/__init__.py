"""Vision model zoo: a copy of mxtpu/gluon/model_zoo/vision/__init__.py
(parity: python/mxnet/gluon/model_zoo/vision/__init__.py): alexnet,
densenet, inception v3, mobilenet, resnet v1/v2, squeezenet and vgg, by
class, by factory and through ``get_model``."""
from .resnet import (BasicBlockV1, BasicBlockV2, BottleneckV1, BottleneckV2,
                     ResNetV1, ResNetV2, get_resnet, resnet18_v1, resnet18_v2,
                     resnet34_v1, resnet34_v2, resnet50_v1, resnet50_v2,
                     resnet101_v1, resnet101_v2, resnet152_v1, resnet152_v2)
from .alexnet import AlexNet, alexnet
from .densenet import (DenseNet, densenet121, densenet161, densenet169,
                       densenet201, get_densenet)
from .inception import Inception3, inception_v3
from .mobilenet import (MobileNet, get_mobilenet, mobilenet0_25,
                        mobilenet0_5, mobilenet0_75, mobilenet1_0)
from .squeezenet import (SqueezeNet, get_squeezenet, squeezenet1_0,
                         squeezenet1_1)
from .vgg import (VGG, get_vgg, vgg11, vgg11_bn, vgg13, vgg13_bn, vgg16,
                  vgg16_bn, vgg19, vgg19_bn)

_models = {
    "resnet18_v1": resnet18_v1, "resnet34_v1": resnet34_v1,
    "resnet50_v1": resnet50_v1, "resnet101_v1": resnet101_v1,
    "resnet152_v1": resnet152_v1, "resnet18_v2": resnet18_v2,
    "resnet34_v2": resnet34_v2, "resnet50_v2": resnet50_v2,
    "resnet101_v2": resnet101_v2, "resnet152_v2": resnet152_v2,
    "alexnet": alexnet,
    "densenet121": densenet121, "densenet161": densenet161,
    "densenet169": densenet169, "densenet201": densenet201,
    "inceptionv3": inception_v3,
    "mobilenet1.0": mobilenet1_0, "mobilenet0.75": mobilenet0_75,
    "mobilenet0.5": mobilenet0_5, "mobilenet0.25": mobilenet0_25,
    "squeezenet1.0": squeezenet1_0, "squeezenet1.1": squeezenet1_1,
    "vgg11": vgg11, "vgg13": vgg13, "vgg16": vgg16, "vgg19": vgg19,
    "vgg11_bn": vgg11_bn, "vgg13_bn": vgg13_bn, "vgg16_bn": vgg16_bn,
    "vgg19_bn": vgg19_bn,
}


def get_model(name, **kwargs):
    """Create a model by name (parity model_zoo.vision.get_model)."""
    name = name.lower()
    if name not in _models:
        raise ValueError(
            "Model %s is not supported. Available options are:\n\t%s" % (
                name, "\n\t".join(sorted(_models.keys()))))
    return _models[name](**kwargs)
