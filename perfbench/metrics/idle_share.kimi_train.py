"""The device's idle share of the traced window (%)."""

from perfbench.readers import idle_share as read  # noqa: F401
