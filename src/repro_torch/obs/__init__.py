"""repro_torch.obs: observability of a session.

  TraceRecorder, validate_trace_events - Chrome/Perfetto trace events
"""

from repro_torch.obs.trace import TraceRecorder, validate_trace_events

__all__ = ["TraceRecorder", "validate_trace_events"]
