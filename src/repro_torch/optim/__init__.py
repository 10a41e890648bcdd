"""AdamW with a float32 master copy and the pods' int8 gradient all-reduce
(the JAX package's ``optim``)."""

from .adamw import (AdamWConfig, adamw_update, global_norm, init_opt_state,
                    lr_schedule, square_sum)
from .compression import compressed_psum, init_error_state, q8_psum

__all__ = ["AdamWConfig", "adamw_update", "global_norm", "init_opt_state",
           "lr_schedule", "square_sum", "compressed_psum",
           "init_error_state", "q8_psum"]
