from .autoencoder import Autoencoder, Decoder, Encoder
from .resnet import ResNet18GN
from .unet import MODEL_REGISTRY, UNetFiLM, UNetSimple, build_model

__all__ = ["Autoencoder", "Decoder", "Encoder", "ResNet18GN", "UNetFiLM",
           "UNetSimple", "build_model", "MODEL_REGISTRY"]
