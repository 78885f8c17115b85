"""Host-side utilities: stage timing and error rates."""

from .tracing import Timings, stage_timer

__all__ = ["stage_timer", "Timings"]
