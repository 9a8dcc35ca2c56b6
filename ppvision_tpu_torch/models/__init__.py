"""Networks of the de-identification pipeline: FAN and StarGAN-v2."""

from .fan import FAN, get_heatmap
from .stargan import Generator, MappingNetwork, StyleEncoder, build_gan_models

__all__ = ["FAN", "Generator", "MappingNetwork", "StyleEncoder", "build_gan_models", "get_heatmap"]
