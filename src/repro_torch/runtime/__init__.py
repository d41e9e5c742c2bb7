"""Runtime of the port's LM stack: the serving loop, the fault-tolerant
training loop and its fault-tolerance helpers."""
from repro_torch.runtime.serve_loop import (ContinuousBatcher, Request,
                                            ServeStats)
from repro_torch.runtime.ft import (FailureInjector, SimulatedFailure,
                                    StragglerDetector, elastic_mesh_shape)
from repro_torch.runtime.train_loop import (TrainResult, make_train_step,
                                            train)
