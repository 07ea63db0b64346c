"""The whole step's model FLOPs (`counts.moonlight`: products and the
causal core from the shapes, the held experts from the window's tallied
assignments) per second of the traced window, over the card's bf16 peak
(%)."""

from perfbench.readers import model_mfu as read  # noqa: F401
