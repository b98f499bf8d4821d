"""Kernel 7 (``plf_tree_seg_kernel``, the segmented forward): the
forward's bound over the kernel's device time."""


def read(ctx):
    return ctx.kernel_roofline_pct("plf_tree_seg_kernel", "forward")
