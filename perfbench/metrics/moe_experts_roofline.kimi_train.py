"""The held experts' share of their roofline (%): the grouped products'
FLOPs, forward and backward, from the window's tallied assignments
(`counts.moonlight.expert_flops`, three forwards' worth), over the device
time of the operations launched inside the program's `moe.experts` and
`moe.experts_bwd` spans, against the card's bf16 peak. None on a program
without those spans."""


def read(out):
    from perfbench.counts.peaks import BF16_FLOPS
    tr, flops = out.trace, out.counts.get("expert_flops")
    if not hasattr(tr, "span_device_s") or not flops \
            or not tr.program_span_count("moe.experts"):
        return None
    dev_s = tr.span_device_s("moe.experts") \
        + tr.span_device_s("moe.experts_bwd")
    return None if dev_s <= 0 else 100.0 * flops / dev_s / BF16_FLOPS
