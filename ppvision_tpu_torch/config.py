"""Configuration dataclasses of the de-identification and captioning pipelines.

Own copy of the model, loss, training, camera, path and caption sections of
``ppvision_tpu/config.py`` (the reference's ``Face-DeId/main.py:86-198``
flags and ``Camera/Optics.py:10-36`` geometry; ``Image_Caption/train.py:17-60``);
defaults are identical.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Reference main.py:88-112."""

    img_size: int = 256
    num_domains: int = 2
    latent_dim: int = 16
    hidden_dim: int = 512
    style_dim: int = 64
    w_hpf: float = 1.0
    max_conv_dim: int = 512
    # FAN runs at this input resolution in the module tests; the de-id
    # pipeline always resizes to 256 like the reference (wing.py:244).
    fan_input_size: int = 256
    # Compute dtype of the conv nets (params stay float32).
    compute_dtype: str = "bfloat16"
    # Opt-in int8 generator-decoder serving mode (ops/quant.py): LOSSY
    # (dynamic per-sample activation / per-channel weight quantization).
    # Inference-only; training ignores it.
    quant_decode: bool = False


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Reference main.py:100-112, 187-189."""

    lambda_reg: float = 1.0
    lambda_cyc: float = 7.0  # privacy-consistency value
    lambda_sty: float = 1.0
    lambda_ds: float = 1.0
    ds_iter: int = 100_000
    lambda_lpips: float = 2000.0
    lambda_flow: float = 10.0
    lambda_heatmap: float = 1000.0  # value-only in the reference (no grad)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Reference main.py:114-136."""

    total_iters: int = 300_000
    resume_iter: int = 0
    batch_size: int = 4
    val_batch_size: int = 8
    lr: float = 1e-4
    f_lr: float = 1e-6  # mapping network
    beta1: float = 0.0
    beta2: float = 0.99
    weight_decay: float = 1e-4
    ema_beta: float = 0.999
    randcrop_prob: float = 0.5
    seed: int = 777
    print_every: int = 10
    save_every: int = 10_000
    sample_every: int = 1_000_000
    eval_every: int = 1_000_000
    debug_every: int = 100
    num_outs_per_domain: int = 10
    # Auxiliary generator losses (reference solver.py:161-184 mixes
    # LPIPS x2000 and RAFT-flow x10 into every G step).
    use_lpips: bool = True
    use_flow: bool = True
    flow_iters: int = 20  # RAFT refinement iterations inside the loss
    # Recompute the generator's and discriminator's activations in the
    # backward pass (torch.utils.checkpoint): the same values for about
    # one more forward of work and a lower peak of device memory.
    remat: bool = False


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Face-DeId camera (reference Camera/Optics.py:10-36)."""

    n: int = 256
    zernike_terms: int = 300
    height_tolerance: float = 2e-8


@dataclasses.dataclass(frozen=True)
class PathsConfig:
    train_img_dir: str = "data/celeba_hq/train"
    val_img_dir: str = "data/celeba_hq/val"
    src_dir: str = "assets/representative/celeba_hq/src"
    ref_dir: str = "assets/representative/celeba_hq/ref"
    checkpoint_dir: str = "checkpoints"
    checkpoint_save_dir: str = "expr/checkpoints"
    sample_dir: str = "expr/samples"
    eval_dir: str = "expr/eval"
    debug_dir: str = "expr/debug"
    result_dir: str = "expr/results"
    wing_path: str = "checkpoints/wing.ckpt"
    lm_path: str = "checkpoints/celeba_lm_mean.npz"
    camera_ckpt: str = "checkpoints/Model_wing.pth"
    # Aux-loss / metric-net weights (reference download.sh artifacts).
    lpips_path: str = "checkpoints/lpips_weights.ckpt"
    alexnet_path: str = "checkpoints/alexnet.pth"
    raft_path: str = "checkpoints/raft-things.pth"
    inception_path: str = "checkpoints/inception_v3.pth"
    arcface_path: str = "checkpoints/arcface.pth"
    # Reference torch GAN checkpoint ('{:06d}_nets_ema.ckpt').
    torch_nets_ckpt: str = ""


@dataclasses.dataclass(frozen=True)
class FaceDeIdConfig:
    model: ModelConfig = ModelConfig()
    loss: LossConfig = LossConfig()
    train: TrainConfig = TrainConfig()
    camera: CameraConfig = CameraConfig()
    paths: PathsConfig = PathsConfig()


@dataclasses.dataclass(frozen=True)
class CaptionConfig:
    """Image_Caption recipe (reference train.py:17-60)."""

    emb_dim: int = 512
    attention_dim: int = 512
    decoder_dim: int = 512
    dropout: float = 0.5
    encoded_image_size: int = 36
    batch_size: int = 64
    epochs: int = 20
    encoder_lr: float = 1e-4
    decoder_lr: float = 5e-4
    camera_lr: float = 5e-7
    grad_clip: float = 5.0
    alpha_c: float = 1.0  # doubly-stochastic attention weight
    w_caption: float = 0.4
    w_ssim: float = 6.0
    w_psf: float = 30.0
    # Camera fidelity term flavor (reference train.py:60, 171-175):
    # "SSIM" -> 1 - SSIM(orig, sensor); "MSE" -> 1 - MSE(orig, sensor)
    # Default "MSE" matches the shipped reference (train.py:59).
    camera_loss: str = "MSE"
    zernike_clamp: float = 1.0  # +/- clamp around the defocus init
    mask_mode: str = "3"  # reference prueba_psf
    bleu4_gate: float = 0.20  # checkpoint save gate
    max_caption_len: int = 50
    beam_size: int = 5
    # Recompute the ResNet encoder's activations in the backward pass
    # (torch.utils.checkpoint): the encoder holds the step's biggest
    # activation store.
    remat: bool = False
