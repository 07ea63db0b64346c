"""The whole retrieval call's share of the card's roofline: the bytes
and operations the call needs over its wall time (%)."""

from perfbench.readers import call_mfu as read  # noqa: F401
