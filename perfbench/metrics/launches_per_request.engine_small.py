"""Device operations launched per request (a count)."""

from perfbench.readers import launches_per_call as read  # noqa: F401
