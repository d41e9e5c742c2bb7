"""Runtime of the port's LM stack: the serving loop, the fault-tolerant
training loop and its fault-tolerance helpers, and the explicit
data-parallel step with compressed gradient sync."""
from repro_torch.runtime.dp_step import (init_error_feedback,
                                         make_dp_train_step)
from repro_torch.runtime.serve_loop import (ContinuousBatcher, Request,
                                            ServeStats)
from repro_torch.runtime.ft import (FailureInjector, SimulatedFailure,
                                    StragglerDetector, elastic_mesh_shape)
from repro_torch.runtime.train_loop import (TrainResult, make_train_step,
                                            train)
