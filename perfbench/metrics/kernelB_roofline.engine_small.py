"""Kernel B's share of its roofline: the filled rows of the probed
clusters read once, over its device time per call (%)."""

from perfbench.readers import kernel_b_roofline as read  # noqa: F401
