"""Optimizers (SGD / Adam / AdamW) and LR schedules on the trainer's
flat ``(N, D)`` parameter buffer, one state row per node (the
counterpart of ``repro.optim``)."""
from repro_torch.optim.optimizers import Optimizer, adam, adamw, get_optimizer, sgd
from repro_torch.optim.schedules import constant, cosine_decay, warmup_cosine
