"""Models of the port (the MNIST convnet of this slice)."""

from simple_tip_tpu_torch.models.convnet import MnistConvNet

__all__ = ["MnistConvNet"]
