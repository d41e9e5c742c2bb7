"""The port's tracer, under the name the analytics package and its users
know it by. It lives in ``repro_torch.core.tracing``, below the kernels
and the analytics package, so that both can record spans; see that
module for the spans, the flight recorder and the discipline."""
from repro_torch.core.tracing import (  # noqa: F401
    FlightDump,
    FlightRecorder,
    Span,
    Trace,
    Tracer,
    current,
    disable_tracing,
    enable_tracing,
    note,
    now,
    scope,
    span,
    tracer,
    tracing,
    tracing_enabled,
)
