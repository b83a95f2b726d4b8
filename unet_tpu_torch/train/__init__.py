"""Training stack of the port (counterpart of unet_tpu/train/): the optax
trainer as torch.optim, the epoch loop with checkpoints, and the recipes."""
from unet_tpu_torch.train.trainer import (  # noqa: F401
    LossCfg, OptimCfg, TrainState, create_train_state, make_train_step,
    make_eval_step, build_optimizer, build_schedule)
from unet_tpu_torch.train.loop import TrainRunCfg, train_model, overfit_test  # noqa: F401
from unet_tpu_torch.train.monitor import TrainingMonitor, SampleLossTracker, EarlyStopping  # noqa: F401
