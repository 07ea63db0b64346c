"""The whole step's model FLOPs (`counts.lm`: matmuls and attention from
the shapes, embedding lookups not counted) per second of the traced
window, over the card's bf16 peak (%)."""

from perfbench.readers import model_mfu as read  # noqa: F401
