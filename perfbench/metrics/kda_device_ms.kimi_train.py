"""Device ms a training step of the operations launched inside the
program's `kda.*` spans (`kda.project`, `kda.conv`, `kda.gate`,
`kda.core`, `kda.core_bwd`, `kda.out`) over every KDA layer. None on a
program without those spans."""

SPANS = ("kda.project", "kda.conv", "kda.gate", "kda.core",
         "kda.core_bwd", "kda.out")


def read(out):
    tr, steps = out.trace, out.counts.get("steps")
    if not hasattr(tr, "span_device_s") or not steps \
            or not tr.program_span_count("kda.core"):
        return None
    return 1e3 * sum(tr.span_device_s(s) for s in SPANS) / steps
