"""Seconds of ``PhyloModel(tree, model, tips, alpha=...)``: the host
encoding of the tip codes, their upload, the operator stacks and the
plans, synchronised (the benchmark's span around the call)."""


def read(ctx):
    return ctx.spans.get("model_build")
