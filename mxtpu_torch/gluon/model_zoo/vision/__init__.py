"""Vision model zoo (counterpart of mxtpu/gluon/model_zoo/vision/): the
ResNet v1 and v2 families, by class, by factory and through
``get_model``. The rest of mxtpu's zoo (alexnet, densenet, inception,
mobilenet, squeezenet, vgg) is not ported yet: ``get_model`` raises for
it."""
from ....base import MXNetError
from .resnet import (BasicBlockV1, BasicBlockV2, BottleneckV1, BottleneckV2,
                     ResNetV1, ResNetV2, get_resnet, resnet18_v1, resnet18_v2,
                     resnet34_v1, resnet34_v2, resnet50_v1, resnet50_v2,
                     resnet101_v1, resnet101_v2, resnet152_v1, resnet152_v2)

_models = {
    "resnet18_v1": resnet18_v1, "resnet34_v1": resnet34_v1,
    "resnet50_v1": resnet50_v1, "resnet101_v1": resnet101_v1,
    "resnet152_v1": resnet152_v1, "resnet18_v2": resnet18_v2,
    "resnet34_v2": resnet34_v2, "resnet50_v2": resnet50_v2,
    "resnet101_v2": resnet101_v2, "resnet152_v2": resnet152_v2,
}
# mxtpu's zoo names that wait for a later slice
_NOT_PORTED = {
    "alexnet", "densenet121", "densenet161", "densenet169", "densenet201",
    "inceptionv3", "mobilenet1.0", "mobilenet0.75", "mobilenet0.5",
    "mobilenet0.25", "squeezenet1.0", "squeezenet1.1", "vgg11", "vgg13",
    "vgg16", "vgg19", "vgg11_bn", "vgg13_bn", "vgg16_bn", "vgg19_bn"}


def get_model(name, **kwargs):
    """Create a model by name (parity model_zoo.vision.get_model)."""
    name = name.lower()
    if name in _NOT_PORTED:
        raise MXNetError("model zoo: %s is not ported yet (only the ResNet "
                         "v1 and v2 families are)" % name)
    if name not in _models:
        raise ValueError(
            "Model %s is not supported. Available options are:\n\t%s" % (
                name, "\n\t".join(sorted(_models.keys()))))
    return _models[name](**kwargs)

