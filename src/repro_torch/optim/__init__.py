"""Optimizers: AdamW, the learning-rate schedules and gradient
compression."""
from repro_torch.optim import adamw, compression, schedules
from repro_torch.optim.adamw import AdamWState
