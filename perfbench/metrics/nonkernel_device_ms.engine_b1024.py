"""Device ms per batch of every operation that is not kernel B (the
annex chain, top-k, gathers, the probe)."""

from perfbench.readers import nonkernel_device_ms as read  # noqa: F401
