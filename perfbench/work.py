"""The work a likelihood function needs, and the card's peaks.

Frozen from ``chip_smoke.py:260-307`` at commit c0abfbb (``bound``,
``node_work``, ``node_bwd_flops``, ``tree_bwd_work`` and the data-sheet
peaks).  They count what the function needs from its shapes, whatever
kernel computes it, so a change of backend or kernel leaves the
yardstick where it is.
"""

from __future__ import annotations

__all__ = ["HBM_BYTES_PER_S", "FP32_FLOPS", "BF16_FLOPS", "bound",
           "node_work", "node_bwd_flops", "tree_bwd_work"]

# Peak rates of one H100 SXM (NVIDIA's data sheet, dense, at the 700 W
# power limit): each kernel's bound is the larger of its bytes over the
# memory rate and its operations over the peak rate of their type.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12            # outside the tensor cores
BF16_FLOPS = 989e12           # tensor cores: bf16 products, fp32 sums


def bound(n_bytes, flops, rate):
    """The least time the card could take: bytes each read or written
    once over the memory rate, or operations over their peak rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / rate * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def node_work(S, C, variant="vpu"):
    """(flops, peak rate) of one PLF node at one site: three stages of
    S*C rows x S multiply-adds (2 flops each) and the S*C products; the
    bf16x3 mode does each product three times, in bf16."""
    stages = 3 * 2 * S * S * C
    if variant == "mxu_3x":
        return 3 * stages, BF16_FLOPS
    if variant == "mxu_bf16":
        return stages, BF16_FLOPS
    return stages + S * C, FP32_FLOPS


def node_bwd_flops(S, C):
    """flops of one node's VJP at one site: the two stage-1 products and
    the stage-3 adjoint recomputed, the two stage-1 adjoints, three
    elementwise products, and the three operator gradients (S*C x S
    multiply-adds each)."""
    return 5 * 2 * S * S * C + 3 * S * C + 3 * 2 * S * S * C


def tree_bwd_work(S, C, E, variant="vpu"):
    """(flops, peak rate) of the whole-tree VJP (kernels 4 and 4m) at one
    site, counting what the function needs: the forward of every node;
    per node the stage-3 adjoint g_p, the two products g_u1 and g_u2 and
    the three operator gradients; and one adjoint stage per internal
    child (E - 1 of them: a tip child needs none).  The kernels' second
    computation of the stage-1 products in the reverse sweep is their own
    choice, not counted.  In bf16x3 mode the stages and operator
    gradients take three passes, the elementwise products one."""
    fwd, rate = node_work(S, C, variant)
    stage = 2 * S * S * C
    passes = 3 if variant == "mxu_3x" else 1
    return (E * (fwd + 4 * stage * passes + 2 * S * C)
            + (E - 1) * stage * passes), rate
