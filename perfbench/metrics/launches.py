"""Device operations (kernels, copies, memsets) an iteration of the
cell's loop (a value-and-gradient step, an evaluation), from the traced
window."""


def read(ctx):
    return ctx.ops_per_iteration()
