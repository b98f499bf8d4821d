"""Host milliseconds an iteration inside the likelihood function: its
``plf.fn`` spans (the forward's inputs, operators, kernel call and
finalisation) and ``plf.fn.backward`` (the backward's launch and host
side) in the traced window, over the window's iterations."""

import program_spans


def read(ctx):
    ps = program_spans.of_context(ctx)
    if ps is None or "fn" not in ps.by or not ctx.iterations:
        return None
    secs = ps.by["fn"][0] + ps.by.get("fn.backward", (0.0,))[0]
    return 1e3 * secs / ctx.iterations
