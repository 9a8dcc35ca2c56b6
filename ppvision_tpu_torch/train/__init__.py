"""Training of the de-identification GAN (the reference Solver) and of
the privacy-preserving captioner."""

from .caption import CaptionTrainState, init_caption, make_caption_train_step
from .gan import FrozenNets, GANTrainState, init_gan, make_train_step

__all__ = ["CaptionTrainState", "FrozenNets", "GANTrainState", "init_caption", "init_gan",
           "make_caption_train_step", "make_train_step"]
