"""Host time inside the program's `engine.retrieve_auto` spans over the
traced window (%)."""

from perfbench.program_trace import retrieve_span_share as read  # noqa: F401
