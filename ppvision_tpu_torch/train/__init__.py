"""Training of the de-identification GAN (the reference Solver)."""

from .gan import FrozenNets, GANTrainState, init_gan, make_train_step

__all__ = ["FrozenNets", "GANTrainState", "init_gan", "make_train_step"]
