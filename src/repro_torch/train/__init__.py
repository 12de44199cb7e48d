"""Training substrate of the port: optimizers, checkpoints, int8
error-feedback compression and the train loop (the JAX package's
``train/``)."""
from repro_torch.train.checkpoint import (
    latest_step, load_checkpoint, restore, save_checkpoint,
    save_checkpoint_async,
)
from repro_torch.train.compression import (
    dequantize_leaf, fake_quantize_ef, init_error_buffers, quantize_leaf,
)
from repro_torch.train.loop import (
    TrainConfig, make_train_step, train, value_and_grad,
)
from repro_torch.train.optimizer import (
    OptimizerConfig, OptState, apply_update, clip_by_global_norm,
    init_opt_state, schedule_lr,
)

__all__ = [
    "OptimizerConfig", "OptState", "init_opt_state", "apply_update",
    "schedule_lr", "clip_by_global_norm", "save_checkpoint",
    "save_checkpoint_async", "load_checkpoint", "latest_step", "restore",
    "quantize_leaf", "dequantize_leaf", "fake_quantize_ef",
    "init_error_buffers", "TrainConfig", "make_train_step", "train",
    "value_and_grad",
]
