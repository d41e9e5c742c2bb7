"""Optimizers: AdamW and the learning-rate schedules."""
from repro_torch.optim import adamw, schedules
from repro_torch.optim.adamw import AdamWState
