"""The whole step's model FLOPs (`counts.kimi_linear`: products, the MLA
core and the chunked KDA core from the shapes, the held experts from the
window's tallied assignments) per second of the traced window, over the
card's bf16 peak (%)."""

from perfbench.readers import model_mfu as read  # noqa: F401
