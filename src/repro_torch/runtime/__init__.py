"""Serving runtime of the port's LM stack."""
from repro_torch.runtime.serve_loop import (ContinuousBatcher, Request,
                                            ServeStats)
