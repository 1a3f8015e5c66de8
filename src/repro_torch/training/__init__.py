"""Training of the port (counterpart of ``repro.training``): AdamW with
fp32 moments, microbatched gradient accumulation, a deterministic data
pipeline and atomic checkpoints in the reference's on-disk format.

Training differentiates through the plain torch paths
(``attn_impl="plain"``, ``use_ssm_kernel=False``), as the reference
trains through XLA attention and its chunked SSD: no kernel of either
package has a backward pass.
"""
from repro_torch.training.checkpoint import (latest_step, restore_checkpoint,
                                             save_checkpoint)
from repro_torch.training.data import SyntheticDataset, batch_specs
from repro_torch.training.optimizer import (AdamWConfig, TrainState,
                                            adamw_init, adamw_update,
                                            train_state_axes)
from repro_torch.training.train_step import make_train_step

__all__ = [
    "AdamWConfig", "TrainState", "adamw_init", "adamw_update",
    "train_state_axes", "make_train_step", "SyntheticDataset",
    "batch_specs", "save_checkpoint", "restore_checkpoint", "latest_step",
]
