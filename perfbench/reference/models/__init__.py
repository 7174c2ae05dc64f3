from .autoencoder import Encoder
from .resnet import ResNet18GN
from .unet import UNetFiLM, build_model

__all__ = ["Encoder", "ResNet18GN", "UNetFiLM", "build_model"]
