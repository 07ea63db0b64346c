"""Latent attention's causal core against its roofline (%): the forward
core's FLOPs (`counts.moonlight.attention_core_flops`, the full layers of
every step of the window) over the device time of the operations
launched inside the program's `mla.core` spans (the forward's), against
the card's bf16 peak. None on a program without those spans."""


def read(out):
    from perfbench.counts.peaks import BF16_FLOPS
    tr, flops = out.trace, out.counts.get("mla_core_flops")
    if not hasattr(tr, "span_device_s") or not flops \
            or not tr.program_span_count("mla.core"):
        return None
    dev_s = tr.span_device_s("mla.core")
    return None if dev_s <= 0 else 100.0 * flops / dev_s / BF16_FLOPS
