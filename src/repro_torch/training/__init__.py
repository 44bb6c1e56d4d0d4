"""Training: AdamW, the synthetic token stream, the trainer and npz
checkpoints in the JAX package's format."""
from repro_torch.training.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.training.optimizer import (AdamWConfig, adamw_update,
                                            init_adamw)
from repro_torch.training.trainer import Trainer, make_train_step

__all__ = ["AdamWConfig", "Trainer", "adamw_update", "init_adamw",
           "load_checkpoint", "make_train_step", "save_checkpoint"]
