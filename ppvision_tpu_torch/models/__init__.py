"""Networks of the de-identification pipeline and its training: FAN,
StarGAN-v2 (with its Discriminator) and RAFT."""

from .fan import FAN, get_heatmap
from .stargan import Discriminator, Generator, MappingNetwork, StyleEncoder, build_gan_models

__all__ = ["FAN", "Discriminator", "Generator", "MappingNetwork", "StyleEncoder", "build_gan_models", "get_heatmap"]
