"""Models of the port: the MNIST and CIFAR-10 convnets, the IMDB transformer."""

from simple_tip_tpu_torch.models.convnet import Cifar10ConvNet, MnistConvNet
from simple_tip_tpu_torch.models.transformer import ImdbTransformer

__all__ = ["Cifar10ConvNet", "ImdbTransformer", "MnistConvNet"]
