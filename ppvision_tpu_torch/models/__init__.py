"""Networks of the de-identification pipeline and its training (FAN,
StarGAN-v2 with its Discriminator, RAFT) and of the captioner (the
ResNet-101 encoder, the attention-LSTM decoder)."""

from .captioner import AttentionLSTMDecoder, beam_search, beam_search_batch, caption_loss
from .fan import FAN, get_heatmap
from .resnet import CaptionEncoder, ResNetBackbone
from .stargan import Discriminator, Generator, MappingNetwork, StyleEncoder, build_gan_models

__all__ = ["FAN", "AttentionLSTMDecoder", "CaptionEncoder", "Discriminator", "Generator", "MappingNetwork",
           "ResNetBackbone", "StyleEncoder", "beam_search", "beam_search_batch", "build_gan_models",
           "caption_loss", "get_heatmap"]
