"""Device ops: layouts, the plain PyTorch PLF, and the CUDA kernels with
their plain versions."""

import importlib

#: Every kernel wrapper, by module: each adds one to its ``launches``
#: where it launches its kernel (a CPU tensor runs the plain version and
#: never counts).
WRAPPERS = {
    "plf_node": ("plf_node", "plf_node_batch", "plf_node_gen"),
    "plf_mxu": ("plf_node_mxu", "plf_node_mxu_batch"),
    "plf_tree": ("plf_tree", "plf_tree_mxu", "plf_tree_batch",
                 "plf_tree_mxu_batch"),
    "plf_grad": ("plf_node_bwd", "plf_node_bwd_mxu"),
    "plf_tree_grad": ("plf_tree_bwd", "plf_tree_bwd_mxu"),
    "plf_tree_seg": ("plf_tree_seg", "plf_tree_seg_bwd", "plf_tree_seg_mxu",
                     "plf_tree_seg_bwd_mxu", "plf_tree_seg_batch",
                     "plf_tree_seg_mxu_batch"),
}


def launch_counts() -> dict:
    """``{wrapper name: launches}`` of every kernel wrapper in this
    process."""
    out = {}
    for mod, names in WRAPPERS.items():
        m = importlib.import_module(f"{__name__}.{mod}")
        out.update((name, getattr(m, name).launches) for name in names)
    return out
