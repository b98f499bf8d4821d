"""Seconds of ``PhyloModel.__init__``'s host encoding of the tip codes
(the program's span ``phylo.encode``: ``map_tip_codes``, the padding, the
cast to the tip dtype)."""

import program_spans


def read(ctx):
    row = program_spans.span_totals().get("phylo.encode")
    return None if row is None else row[0]
