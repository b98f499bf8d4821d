"""Kernel 8 (``plf_tree_seg_bwd_kernel``, the segmented backward): the
whole-tree VJP's bound over the kernel's device time."""


def read(ctx):
    return ctx.kernel_roofline_pct("plf_tree_seg_bwd_kernel", "vjp")
