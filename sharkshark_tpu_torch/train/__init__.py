"""The training tree (counterpart of the JAX package's train/): the VSR
(FRNet), SISR (SRVGG) and denoise (BSVD) recipes, their losses,
schedules, datasets, metrics, checkpoints and the config driver
(`python -m sharkshark_tpu_torch.train.driver`).  The GAN recipe
(vsrgan, discriminators, vgg) is not ported yet (ROADMAP.md section 1).
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
from . import checkpoint, datasets, denoise, metrics, model_summary, sisr

__all__ = [
    "charbonnier_loss", "mse_loss", "cosine_similarity_loss",
    "vanilla_gan_loss", "lsgan_loss", "define_criterion",
    "fixed_lr", "multistep_lr", "cosine_annealing_restart", "define_lr_schedule",
    "VSRTrainConfig", "TrainState", "create_train_state", "make_train_step",
    "checkpoint", "datasets", "denoise", "metrics", "model_summary", "sisr",
]
