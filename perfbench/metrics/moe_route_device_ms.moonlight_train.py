"""Device ms a training step of the operations launched inside the
program's `moe.route`, `moe.dispatch` and `moe.combine` spans (the
router's product and top-k, the load tally, the dispatch plan, the
weighted sum of the held experts' rows), over every MoE layer's forward.
None on a program without those spans."""


def read(out):
    tr, steps = out.trace, out.counts.get("steps")
    if not hasattr(tr, "span_device_s") or not steps \
            or not tr.program_span_count("moe.route"):
        return None
    return 1e3 * sum(tr.span_device_s(s) for s in (
        "moe.route", "moe.dispatch", "moe.combine")) / steps
