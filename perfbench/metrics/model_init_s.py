"""Seconds of ``PhyloModel.__init__`` by the program's own span
(``phylo.init``): the inside twin of ``model_build_s``, without its
synchronisation and the call's way in."""

import program_spans


def read(ctx):
    row = program_spans.span_totals().get("phylo.init")
    return None if row is None else row[0]
