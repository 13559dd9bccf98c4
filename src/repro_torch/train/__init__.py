"""The LM plane's training path in PyTorch: the port of ``repro.train``
(AdamW with int8 moments, DP-SGD, the train step, checkpoints)."""
from .optimizer import AdamWConfig, init_opt_state, apply_updates
from .train_step import TrainState, make_train_step, make_eval_step
from .dp import DPSGDConfig, DPSGDAccountant
