"""Kimi Delta Attention's chunked core against its roofline (%): the
least time the card could take for the window's cores, forward and
backward (`counts.kimi_linear`: max(bytes / 3.35 TB/s, FLOPs / 989
TFLOP/s), the bytes of q, k, v, g and beta read and o written once and
the same for the backward's gradients; the FLOPs of the chunked form's
products at chunk 64, three forwards' worth), over the device time of
the operations launched inside the program's `kda.core` and
`kda.core_bwd` spans. Independent of the implementation, so a later
kernel is judged on the same work. None on a program without those
spans."""


def read(out):
    from perfbench.counts.peaks import BYTES_S, BF16_FLOPS
    tr = out.trace
    flops, nbytes = (out.counts.get("kda_core_flops"),
                     out.counts.get("kda_core_bytes"))
    if not hasattr(tr, "span_device_s") or not flops or not nbytes \
            or not tr.program_span_count("kda.core"):
        return None
    dev_s = tr.span_device_s("kda.core") + tr.span_device_s("kda.core_bwd")
    bound = max(nbytes / BYTES_S, flops / BF16_FLOPS)
    return None if dev_s <= 0 else 100.0 * bound / dev_s
