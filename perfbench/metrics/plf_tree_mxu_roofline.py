"""Kernel 2m (``plf_tree_mxu_kernel``, the matrix-form whole-tree
forward): the forward's bound over the kernel's device time."""


def read(ctx):
    return ctx.kernel_roofline_pct("plf_tree_mxu_kernel", "forward")
