"""Host time inside `engine.retrieve_auto` (the harness's span around
the engine function the memory layers call) over the traced window (%)."""


def read(out):
    from perfbench.readers import span_share
    return span_share(out, "retrieve_auto")
