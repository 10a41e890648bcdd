"""AdamW with a float32 master copy (the JAX package's ``optim``)."""

from .adamw import (AdamWConfig, adamw_update, global_norm, init_opt_state,
                    lr_schedule)

__all__ = ["AdamWConfig", "adamw_update", "global_norm", "init_opt_state",
           "lr_schedule"]
