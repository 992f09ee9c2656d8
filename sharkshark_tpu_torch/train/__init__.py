"""The training tree (counterpart of the JAX package's train/): the VSR
(FRNet), VSRGAN (TecoGAN: vsrgan, discriminators, the VGG feature loss),
SISR (SRVGG) and denoise (BSVD) recipes, their losses, schedules,
datasets, metrics, checkpoints, the steps compiled per signature
(`compiled`: CUDA graphs of the whole step) and the config driver
(`python -m sharkshark_tpu_torch.train.driver`).
"""

from .losses import (
    charbonnier_loss,
    cosine_similarity_loss,
    define_criterion,
    lsgan_loss,
    mse_loss,
    vanilla_gan_loss,
)
from .schedules import cosine_annealing_restart, define_lr_schedule, fixed_lr, multistep_lr
from .vsr import TrainState, VSRTrainConfig, create_train_state, make_train_step
from .vsrgan import GANTrainState, VSRGANConfig, create_gan_state, make_gan_train_step
from . import checkpoint, compiled, datasets, denoise, discriminators, metrics, model_summary, sisr, vgg, vsrgan

__all__ = [
    "charbonnier_loss", "mse_loss", "cosine_similarity_loss",
    "vanilla_gan_loss", "lsgan_loss", "define_criterion",
    "fixed_lr", "multistep_lr", "cosine_annealing_restart", "define_lr_schedule",
    "VSRTrainConfig", "TrainState", "create_train_state", "make_train_step",
    "VSRGANConfig", "GANTrainState", "create_gan_state", "make_gan_train_step",
    "checkpoint", "compiled", "datasets", "denoise", "discriminators", "metrics", "model_summary", "sisr",
    "vgg", "vsrgan",
]
