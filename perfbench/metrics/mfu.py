"""The whole iteration's share of the card's peak: the flops of what one
iteration of the cell's loop computes (the value-and-gradient function,
``work.tree_bwd_work``, or the forward, every node's ``work.node_work``)
over the peak of their arithmetic times an iteration's wall time in the
traced window."""


def read(ctx):
    return ctx.mfu_pct()
