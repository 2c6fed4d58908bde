"""LM training on one device or a mesh: AdamW (ZeRO-1 moments on a mesh),
the train step with accumulation and the loop with checkpoint/resume."""
from repro_torch.train.loop import StragglerMonitor, train_loop
from repro_torch.train.optimizer import (AdamWConfig, adamw_update, global_norm,
                                         init_opt_state, lr_schedule)
from repro_torch.train.trainer import build_train_step, cross_entropy, loss_fn

__all__ = ["AdamWConfig", "adamw_update", "global_norm", "init_opt_state", "lr_schedule",
           "build_train_step", "cross_entropy", "loss_fn", "StragglerMonitor", "train_loop"]
