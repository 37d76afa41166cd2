from repro_torch.optim.adamw import AdamWConfig, adamw_update, init_opt_state
from repro_torch.optim.compress import compress_grads, decompress_grads
from repro_torch.optim.schedule import lr_schedule

__all__ = [
    "AdamWConfig",
    "init_opt_state",
    "adamw_update",
    "lr_schedule",
    "compress_grads",
    "decompress_grads",
]
