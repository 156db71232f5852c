"""Vision models — twins of ``paddle_tpu/vision/models``: LeNet, the
ResNet family, VGG and MobileNet V1 / V2, under the same names."""
from .lenet import LeNet  # noqa: F401
from .mobilenet import (MobileNetV1, MobileNetV2, mobilenet_v1,  # noqa: F401
                        mobilenet_v2)
from .resnet import (ResNet, resnet18, resnet34, resnet50,  # noqa: F401
                     resnet101, resnet152, wide_resnet50_2, wide_resnet101_2)
from .vgg import VGG, vgg11, vgg13, vgg16, vgg19  # noqa: F401

from . import mobilenet as mobilenetv1  # noqa: F401
from . import mobilenet as mobilenetv2  # noqa: F401
from . import lenet, resnet, vgg  # noqa: F401

__all__ = ["LeNet", "ResNet", "resnet18", "resnet34", "resnet50",
           "resnet101", "resnet152", "wide_resnet50_2", "wide_resnet101_2",
           "VGG", "vgg11", "vgg13", "vgg16", "vgg19", "MobileNetV1",
           "MobileNetV2", "mobilenet_v1", "mobilenet_v2"]
