"""Share of the traced window in which the device was idle while the
program's own code ran on the host: the idle gaps under the union of its
``plf.*`` spans, on any thread (the part of ``device_idle_pct`` that the
program, and not its caller, holds)."""

import program_spans


def read(ctx):
    ps = program_spans.of_context(ctx)
    if ps is None or not ps.window_s:
        return None
    return 100.0 * ps.idle_s / ps.window_s
