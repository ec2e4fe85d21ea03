"""LM training of the port (counterpart of ``repro.train``): AdamW with
float32 state (``optim``), the microbatched step factory (``step``), the
reference's checkpoint files (``checkpoint``) and the int8 gradient
all-reduce (``compression``).  The launcher is ``launch/train.py``."""

from repro_torch.train.optim import (AdamState, adamw_init, adamw_update,
                                     cosine_lr)
from repro_torch.train.step import (cast_to_compute, make_loss,
                                    make_train_step, master_params)

__all__ = ["AdamState", "adamw_init", "adamw_update", "cast_to_compute",
           "cosine_lr", "make_loss", "make_train_step", "master_params"]
