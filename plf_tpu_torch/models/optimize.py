"""Differentiable tree likelihood and the fitters built on it.

Counterpart of ``plf_tpu/models/optimize.py``: :func:`tree_loglik_fn`,
:func:`optimize_branch_lengths`, :func:`optimize_alpha`,
:func:`optimize_pinv`, :func:`fit_model` and :func:`fit_codon`.

``tree_loglik_fn`` builds ``(branch_lengths[, rates[, weights]]) ->
log-likelihood`` as a function of torch tensors whose gradient comes
from ``.backward()``.  Its backends follow ``config.py``'s names:

* ``"tree"`` (JAX ``"tree"``): the whole-tree forward and the
  checkpointed whole-tree backward, one launch each per evaluation
  (``ops/plf_tree_grad.py``): kernels 2 + 4 for "vpu" at S = 4, kernels
  2m + 4m in the model's arithmetic for every other model (the MXU
  variants, and "vpu" at S != 4: protein and codon models).  Residuals
  are the small operand arrays; the backward's checkpoint is scratch.
* ``"kernel"`` (JAX ``"pallas"``): kernel 1 forward and kernel 3 backward
  once per node (``ops/plf_grad.py``); at S != 4 kernel 1m in fp32 mode
  and kernel 3m, the same "vpu" arithmetic.  Every node keeps its two
  child CLVs for the backward (~20 GB at 160 taxa x 2^20 sites, 5.3 GB at
  64 protein taxa x 131,072).  A model of an MXU variant runs it in
  "vpu" arithmetic, as JAX's "pallas" path does.
* ``"torch"`` (JAX ``"xla"``): the plain element-wise site-major
  traversal under torch autograd, the CPU oracle.
* ``"segmented"`` (JAX ``"segmented"``): the segmented whole-tree forward
  and backward, one launch each per evaluation (``ops/plf_tree_seg.py``):
  kernels 7 + 8 for "vpu" at S = 4, kernels 7m + 8m in the model's
  arithmetic for every other model; the tree cut into subtrees whose
  roots pass through a boundary buffer, the VJP's only checkpoint kept
  across segments.  Under ``PLFConfig(dtype="bfloat16")`` that buffer and
  its adjoints are stored in bf16, with the JAX package's warning; the
  other backends ignore ``dtype``.

``"auto"`` takes ``"torch"`` for a model on the CPU, and for a model
whose config chose ``Backend.TORCH``.  For a "vpu" model at S != 4 on a
CUDA device it takes ``"kernel"`` from the size at which that was
measured faster than "tree" (``_kernel_wins``: at least 255 nodes and
255 x 131,072 node-sites for LG+G4 proteins, 15 nodes and 31 x 16,384
node-sites for GY94+G4 codons) while the per-node residuals fit half the
free device memory, as the
JAX package takes "pallas" on the TPU where they fit.
Otherwise, on a CUDA device it takes, when the forward kernel admits the
tree (``PhyloModel.can_fuse``), ``"segmented"`` for a DNA "vpu" model
stored in fp32 whose boundary buffers fit the free device memory, and
``"segmented"`` too with bf16 boundaries (DNA, or an "mxu_3x" model)
where kernel 4's (4m's) checkpoint would have to be chunked (more than
half the free memory) while those buffers fit; else ``"tree"``.  Past the forward
kernel's capacity it takes ``"kernel"`` for "vpu" at S = 4 and
``"segmented"`` for a model on the matrix-form kernels, as the JAX
package does.  The rule stands on the backends measured on an H100
(PERF.md): for DNA "segmented" (kernels 7 + 8) was the faster step at
every shape timed, 20-256 taxa x 4,096-2^20 sites (`backend_turns.py
--dna`; 13% at 160 x 2^20, 29.3 against 33.0 ms) and 256 x 2^22 int8
(170 against 203 ms); at 1,024 protein taxa x 131,072 sites, where
kernel 4m runs in two chunks, "tree" won in bf16x3 ("mxu_3x") and in fp32
("mxu"); for a "vpu" protein or codon model "kernel" won
only from the sizes above ("tree" was 4-10x faster at 1,500-4,096
protein sites, where the per-node cost of "kernel" dominates); the
per-node residuals grow with sites x nodes.
"mxu_bf16" raises ValueError on every backend, as in the JAX package.

The branch lengths, rates and mixture weights enter through the per-edge
lane-constant stacks and the root row vector, computed for all edges in
one batched expression; a model on kernels 2m/4m splits the whole stack
into its operator planes once per evaluation, on the device.  The
differentiable value is finalised on the device in fp32 (log, weighted
sum, rescale count, Lewis correction), as the JAX function does;
``PhyloModel.log_likelihood`` finalises on the host in fp64, so the two
agree to fp32 rounding of the site sum.  Underflow rescaling is kept: the
2^32 factors are constant almost everywhere, so gradients are exact
wherever the likelihood is differentiable.

Every returned function carries ``.variant`` (the arithmetic of the
kernels that run: "vpu" on the "kernel" backend) and ``.engine`` (the
backend that runs).  A call is the span ``fn`` (``utils/profiling.py``)
and its conversion of the inputs ``fn.inputs``; the kernel backends split
the rest into ``fn.operators``, ``fn.kernel`` and ``fn.finalise``, and
their backward is ``fn.backward``.

:func:`fit_model` fits GTR exchangeabilities, frequencies and branch
lengths (and, between epochs, the gamma shape) by Adam through the
"torch" core's traversal with the eigensystem inside the graph.
:func:`fit_codon` fits the GY94 omega (dN/dS) and kappa on their profile
likelihood, with branch lengths fitted through ``tree_loglik_fn``.
"""

from __future__ import annotations

import warnings
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..ops.plf_grad import make_plf_diff
from ..ops.plf_mxu import MODES, operator_planes, uses_mxu_kernels
from ..ops.plf_tree import reorder_schedule, root_reduce
from ..ops.plf_tree_grad import make_tree_diff, tree_bwd_scratch_bytes
from ..config import Backend
from ..io.alignment import AMBIGUITY
from ..ops.plf_tree_seg import make_tree_diff_segmented
from ..reference import MIN_LIKELIHOOD, TWO_TO_THE_32
from ..utils.profiling import span
from .phylo import LIK_FLOOR, LOG_MINLIK, PhyloModel

__all__ = ["tree_loglik_fn", "optimize_branch_lengths", "optimize_alpha",
           "optimize_pinv", "fit_model", "fit_codon"]

BACKENDS = ("auto", "tree", "kernel", "torch", "segmented")


def _free_bytes(dev) -> int:
    """The card's free memory plus the blocks PyTorch's caching allocator
    holds unused (which a step can take), so that the auto rules do not
    depend on what earlier steps left cached."""
    return (torch.cuda.mem_get_info(dev)[0] + torch.cuda.memory_reserved(dev)
            - torch.cuda.memory_allocated(dev))


#: Where a "kernel" step on a "vpu" model beat "tree" on an H100, by
#: (S, C): the fewest PLF nodes and the fewest node-sites (nodes x padded
#: sites) of the shapes it won at (``backend_turns.py``, PERF.md), both
#: of which a model must reach.  At S = 20, C = 4 "tree" won at every
#: shape up to 255 nodes x 65,536 sites (116.1 against 134.8-135.6 ms
#: there), "kernel" at 255 x 131,072 (192.2-192.3 against 224.6-225.1 ms)
#: and, since kernel 1m's redesign, at 63 x 131,072 (52.1-52.8 against
#: 54.7-54.9 ms), which these two minima cannot admit without 255 x
#: 65,536: proteins keep 255 nodes.  At S = 61 "kernel" won from 15 nodes
#: x 65,536 codons (160.8-161.1 against 171.2-171.5 ms), 31 x 16,384
#: (83.1-84.1 against 98.6-98.7) and at 127 nodes from 1,500 codons;
#: "tree" at every shape below 31 x 16,384 node-sites (15 x 16,384:
#: 46.8-46.9 against 56.3 ms).  Other (S, C) were not measured and keep
#: "tree".
KERNEL_MIN_NODES = {(20, 4): 255, (61, 4): 15}
KERNEL_MIN_NODE_SITES = {(20, 4): 255 * 131_072, (61, 4): 31 * 16_384}


def _kernel_wins(pm, free: Optional[int] = None) -> bool:
    """Whether a step on the card takes "kernel" (kernels 1m + 3m once per
    node) for a "vpu" model at S != 4: where it was measured faster than
    "tree" (the model's nodes and nodes x n_pad at least
    :data:`KERNEL_MIN_NODES` and :data:`KERNEL_MIN_NODE_SITES` for its S
    and C), and its per-node residuals, the two child CLVs of every node
    (``3 * E * S*C * n_pad * 4`` bytes, the JAX package's count,
    ``plf_tpu/models/optimize.py:104-111``), fit half the ``free`` device
    memory (default: :func:`_free_bytes`).  Measured on an H100 in turns
    (``backend_turns.py``, PERF.md): a "kernel" step pays a cost per node
    that sites hardly change (28-37 ms at 64 protein taxa x 4,096 sites,
    where "tree" takes 4.4 ms), which only many sites amortise; kernel 4m's
    cost grows faster than the nodes (128 codon taxa x 16,384: "kernel"
    410 against "tree" 961-962 ms), so at S = 61 "kernel" wins at 128 taxa
    and not at 32."""
    cfg = pm.config
    key = (cfg.states, cfg.categories)
    least = KERNEL_MIN_NODE_SITES.get(key)
    E = len(pm.schedule)
    if least is None or E < KERNEL_MIN_NODES[key] or E * pm.n_pad < least:
        return False
    if free is None:
        free = _free_bytes(pm.device)
    return 3 * E * cfg.rows * pm.n_pad * 4 <= free // 2


def _segmented_wins(pm, free: Optional[int] = None) -> bool:
    """Whether a step on the card takes "segmented" over "tree", where the
    segmented backward's boundary buffers (the residual and its adjoints,
    ``2 * n_boundaries * S*C * itemsize`` bytes per site, 4 or 2 by the
    config's ``dtype``) fit the ``free`` device memory: for a DNA "vpu"
    model stored in fp32 always (kernels 7 + 8 were the faster pair at
    every DNA shape timed on an H100, 20-256 taxa x 4,096-2^20 sites and
    256 x 2^22 int8, PERF.md), and with bf16 boundaries (DNA, or kernel
    8m's bf16x3 mode, "mxu_3x", whose values a "segmented" step rounds)
    only where kernel 4's (4m's) checkpoint (``E * (S*C*4 + 1)`` bytes per
    site) exceeds half the free memory, so it would run in chunks (kernel
    8m's own op checkpoint is chunked as kernel 4m's is).
    A matrix-form model in fp32 storage keeps "tree": at 1,024 protein
    taxa x 131,072 sites, with kernel 4m's checkpoint in two chunks, the
    "tree" step won by 4% in "mxu_3x" (2.74-2.76 against 2.87-2.88 s) and
    by 18% in "mxu" (PERF.md, PR 11; "segmented" had won by 7% in
    "mxu_3x" before kernels 4m and 8m were redesigned).  ``free`` defaults
    to the card's free memory plus the blocks PyTorch's caching allocator
    holds unused (which a step can take), so the rule does not depend on
    what earlier steps left cached."""
    if not pm.can_segment():
        return False
    variant, S = pm.config.resolved_kernel_variant, pm.config.states
    matrix_form = uses_mxu_kernels(variant, S)
    bf16 = pm.config.dtype == "bfloat16"
    if matrix_form and (MODES[variant] != MODES["mxu_3x"] or not bf16):
        return False
    if free is None:
        free = _free_bytes(pm.device)
    rows = pm.config.rows
    n_bnd = pm._segmented_inputs()[0].n_boundaries
    if 2 * n_bnd * rows * (2 if bf16 else 4) * pm.n_pad > free:
        return False
    if not matrix_form and not bf16:
        return True
    return tree_bwd_scratch_bytes(len(pm.schedule), rows,
                                  pm.n_pad) > free // 2


def _auto_backend(pm, matrix_form: bool = False, vpu: bool = False) -> str:
    """The ``"auto"`` choice (module docstring) for a model on the card
    or not: "torch" off the card; "kernel" for a "vpu" model (``vpu``) on
    the matrix-form kernels (S != 4) where :func:`_kernel_wins`; else
    "tree" when the forward kernel takes the tree ("segmented" where
    :func:`_segmented_wins`), else "kernel" -- or, for a model on the
    matrix-form kernels (``matrix_form``), "segmented" (kernels 7m + 8m),
    as the JAX package takes its segmented engine past the fused kernel's
    arena."""
    if pm.device.type != "cuda":
        return "torch"
    if matrix_form and vpu and _kernel_wins(pm):
        return "kernel"
    if pm.can_fuse():
        return "segmented" if _segmented_wins(pm) else "tree"
    return "segmented" if matrix_form else "kernel"


def _f32(a, device):
    """``a`` (array, list or tensor) as fp32 on ``device``; a tensor that
    already is one is returned as it is, so its gradient flows."""
    return torch.as_tensor(a, dtype=torch.float32, device=device)


def _lane_constants(t, r_vec, lam, u, S, C):
    """Per-branch lane constants for a vector of lengths ``t`` (E,):
    ``(E, S*C, S)`` with ``[e, k*C + c, a] = u[k, a] * exp(lam_a * t_e *
    r_c)``, the JAX package's per-branch expression batched over all
    branches."""
    e = torch.exp(lam * t[:, None, None] * r_vec[None, :, None])  # [e, c, a]
    b = u * e[:, :, None, :]                                       # [e,c,k,a]
    return b.permute(0, 2, 1, 3).reshape(t.shape[0], S * C, S).contiguous()


def _root_rows(pi_u, w_vec, S, C):
    """``(S*C,)`` root row vector: row ``a*C + c`` is ``pi_u[a] * w[c]``."""
    return pi_u.repeat_interleave(C) * w_vec.repeat(S)


def _partials(lik, sc_row, wpad, n, asc, d0):
    """The ``(2,)`` fp32 sums the log-likelihood is finalised from: the
    weighted site log-likelihoods with the rescale counts folded in, and
    (Lewis) the likelihood of the constant dummy sites (from ``d0``)."""
    site_ll = torch.log(torch.clamp_min(lik[:n], LIK_FLOOR))
    sc_f = sc_row.to(torch.float32)
    ll = (site_ll * wpad[:n]).sum() + (sc_f * wpad).sum() * LOG_MINLIK
    p = torch.zeros((), dtype=torch.float32, device=lik.device)
    if asc:
        p = torch.exp(site_ll[d0:] + sc_f[d0:n] * LOG_MINLIK).sum()
    return torch.stack([ll, p])


def _finalise(lik, sc_row, wpad, n, asc, d0, w_total, mesh=None):
    """fp32 log-likelihood on the device from the site likelihoods
    ``lik`` (n_pad,) and rescale counts ``sc_row`` (n_pad,), as the JAX
    function finalises (``optimize.py:520-530``); with ``mesh``, of this
    rank's shard, its sums all-reduced (``parallel.all_reduce_sum``)."""
    parts = _partials(lik, sc_row, wpad, n, asc, d0)
    if mesh is not None:
        from ..parallel.sharding import all_reduce_sum
        parts = all_reduce_sum(parts, mesh)
    ll, p_const = parts.unbind(0)
    return ll - w_total * torch.log1p(-p_const) if asc else ll


def tree_loglik_fn(pm: PhyloModel, with_rates: bool = False,
                   with_weights: bool = False, backend: str = "auto",
                   mesh=None):
    """Build ``(branch_lengths) -> log_likelihood`` (a 0-d fp32 tensor on
    ``pm.device``, differentiable by ``.backward()``).

    ``branch_lengths``: ``(n_nodes-1,)`` indexed by child node (every node
    but the root owns the branch to its parent).  Returns ``(fn, t0)``
    with ``t0`` the tree's current lengths (fp32 numpy).  With
    ``with_rates`` the signature is ``(t_vec, rates)``: the ``(C,)``
    category rates become an input; ``with_weights`` adds the ``(C,)``
    mixture weights, ``(t_vec, rates, weights)`` (implies with_rates).
    ``backend``: see the module docstring.

    ``mesh`` (``parallel.SiteMesh``): the site axis sharded over its
    ranks, as the JAX function's ``mesh`` (``plf_tpu/models/optimize.py:
    57-133``): every rank calls ``fn`` alike and runs the forward and the
    checkpointed backward ("tree": kernels 2 + 4 or 2m + 4m;
    "segmented": 7 + 8 or 7m + 8m) on its own shard of sites; the
    log-likelihood partials are all-reduced by an autograd-aware
    all-reduce, and the operator stacks' gradients are summed over the
    ranks in the backward, so every rank holds the same value and the
    same gradient.  "auto" takes "tree" when the fused arena fits, else
    "segmented" (the JAX rule under a mesh); any other backend with a
    mesh, or a mesh on another device than ``pm``'s, raises ValueError.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    if mesh is not None:
        from ..parallel.sharding import check_mesh_device
        check_mesh_device(pm.device, mesh, "tree_loglik_fn")
    variant = pm.config.resolved_kernel_variant
    if variant == "mxu_bf16":
        # 1-pass bf16 rounds near-underflow site likelihoods negative
        # through deep trees (an 11.6% ll drift on the TPU at 64 taxa x
        # 131,072 sites, benchmarks/results/r04_protein.csv): any fit
        # through it fits noise.  The JAX package's guard, copied.
        raise ValueError(
            "kernel_variant='mxu_bf16' is a bandwidth mode for forward "
            "streaming only; its likelihood drift makes optimisation "
            "unsound -- use 'mxu_3x' (fp32-grade, ~half the MXU passes "
            "of 'mxu') for training/fitting")
    S = pm.config.states
    matrix_form = uses_mxu_kernels(variant, S)
    with span("fn.build"):
        if backend == "auto" and mesh is not None:
            backend = "tree" if pm.can_fuse() else "segmented"
        elif backend == "auto":
            backend = ("torch" if pm.config.backend is Backend.TORCH
                       else _auto_backend(pm, matrix_form, variant == "vpu"))
        if mesh is not None and backend not in ("tree", "segmented"):
            raise ValueError(
                "mesh-sharded gradients require backend='tree' or "
                "'segmented' (the checkpointed whole-tree VJP is the "
                "shard-local kernel)")
        if backend == "kernel":
            variant = "vpu"          # kernels 1 + 3, as JAX's "pallas" path
        if backend in ("tree", "segmented"):
            core = _core_tree(pm, segmented=backend == "segmented",
                              mesh=mesh)
        else:
            core = {"torch": _core_torch,
                    "kernel": _core_kernel}[backend](pm)
        dev = pm.device
        rates = _f32(pm.rates, dev)
        cw = _f32(pm.rate_weights, dev)
    if with_weights:
        def inputs(t_vec, r_vec, w_vec):
            return _f32(t_vec, dev), _f32(r_vec, dev), _f32(w_vec, dev)
    elif with_rates:
        def inputs(t_vec, r_vec):
            return _f32(t_vec, dev), _f32(r_vec, dev), cw
    else:
        def inputs(t_vec):
            return _f32(t_vec, dev), rates, cw

    def fn(*args):
        with span("fn"):
            with span("fn.inputs"):
                args = inputs(*args)
            return core(*args)
    fn.variant = variant
    fn.engine = backend
    t0 = np.array([pm.tree.nodes[i].length
                   for i in range(pm.tree.n_nodes - 1)], np.float32)
    return fn, t0


def _model_tensors(pm):
    dev = pm.device
    m = pm.model
    return (_f32(m.u, dev), _f32(m.eigenvalues, dev),
            _f32(m.root_vector, dev))


def _plf_stage(x1, x2, left, right, ev, S):
    """Element-wise PLF on ``(n, C, S)`` eigen-coordinate CLVs, as the JAX
    package's ``_plf_stage`` (``optimize.py:41-54``): per-branch ``(C, S,
    S)`` factors ``left``/``right``, EV ``[k, a]``, 2^32 rescaling and its
    per-site flags.  With a leading axis of nodes (``(m, n, C, S)`` CLVs,
    ``(m, C, S, S)`` factors) it runs m nodes at once, each element by the
    same operations in the same order."""
    ump1 = torch.zeros_like(x1)
    ump2 = torch.zeros_like(x2)
    for a in range(S):
        ump1 = ump1 + x1[..., a:a + 1] * left[..., None, :, :, a]
        ump2 = ump2 + x2[..., a:a + 1] * right[..., None, :, :, a]
    p = ump1 * ump2
    x3 = torch.zeros_like(p)
    for k in range(S):
        x3 = x3 + p[..., k:k + 1] * ev[k]
    mask = (x3.abs() < float(MIN_LIKELIHOOD)).all(dim=-1).all(dim=-1)
    x3 = torch.where(mask[..., None, None], x3 * float(TWO_TO_THE_32), x3)
    return x3, mask.to(torch.int32)


def _waves(schedule):
    """The internal nodes in dependency waves: ``[(parents, lefts,
    rights)]``, each node one wave past the deepest internal child it has
    (schedule order within a wave); the root is the last wave's only
    node."""
    depth: Dict[int, int] = {}
    waves: Dict[int, Tuple[list, list, list]] = {}
    for p, l, r in schedule:
        depth[p] = 1 + max(depth.get(l, 0), depth.get(r, 0))
        for lst, v in zip(waves.setdefault(depth[p], ([], [], [])),
                          (p, l, r)):
            lst.append(v)
    return [waves[d] for d in sorted(waves)]


def _core_torch(pm):
    """Plain site-major traversal (the JAX "xla" backend, optimize.py:
    137-216) under torch autograd."""
    cfg = pm.config
    S, C = cfg.states, cfg.categories
    dev = pm.device
    u, lam, pi_u = _model_tensors(pm)
    ev = _f32(pm.model.plf_ev, dev)                        # [k, a]
    n, n_leaves = pm.n_sites, pm.tree.n_leaves
    codes = pm.codes[:, :n].long()
    tbl = pm.tip_table[::C]                                # (S, n_codes)
    wgt = _f32(pm.wgt, dev)
    wgt_i = torch.as_tensor(pm.wgt, dtype=torch.int32, device=dev)
    schedule = [(p, l, r) for (p, l, r, _, _) in pm.schedule]
    asc, d0 = pm.ascertainment == "lewis", pm.n_sites_obs
    w_total = float(np.sum(pm.wgt))

    def core(t_vec, r_vec, w_vec):
        # (C, S, S) factor per branch: u[k, a] * exp(lam_a * t * r_c)
        e = torch.exp(lam * t_vec[:, None, None] * r_vec[None, :, None])
        branch = u * e[:, :, None, :]
        clvs, scaler_sites = {}, torch.zeros(n, dtype=torch.int32,
                                             device=dev)
        for parent, l, r in schedule:
            for ch in (l, r):
                if ch < n_leaves and ch not in clvs:
                    clvs[ch] = tbl[:, codes[ch]].t()[:, None, :] \
                        .expand(n, C, S)
            x3, sv = _plf_stage(clvs[l], clvs[r], branch[l], branch[r], ev,
                                S)
            clvs[parent] = x3
            scaler_sites = scaler_sites + sv
        lik = (clvs[schedule[-1][0]] @ pi_u) @ w_vec
        site_ll = torch.log(torch.clamp_min(lik, LIK_FLOOR))
        scaler = (scaler_sites * wgt_i).sum().to(torch.float32)
        ll = (site_ll * wgt).sum() + scaler * LOG_MINLIK
        if asc:
            log_pc = site_ll[d0:] + scaler_sites[d0:].to(torch.float32) \
                * LOG_MINLIK
            ll = ll - w_total * torch.log1p(-torch.exp(log_pc).sum())
        return ll
    return core


def _core_kernel(pm):
    """Kernel 1 forward + kernel 3 backward per node (the JAX "pallas"
    backend, optimize.py:219-313); kernels 1m (fp32 mode) + 3m at
    S != 4."""
    cfg = pm.config
    S, C = cfg.states, cfg.categories
    u, lam, pi_u = _model_tensors(pm)
    n, n_leaves = pm.n_sites, pm.tree.n_leaves
    schedule = [(p, l, r) for (p, l, r, _, _) in pm.schedule]
    root = pm.tree.root
    wpad = pm.wgt_pad.to(torch.float32)
    asc, d0 = pm.ascertainment == "lewis", pm.n_sites_obs
    w_total = float(np.sum(pm.wgt))
    pdiff = make_plf_diff(S, C)

    def core(t_vec, r_vec, w_vec):
        with span("fn.operators"):
            ops = _lane_constants(t_vec, r_vec, lam, u, S, C)  # by child
            rr = _root_rows(pi_u, w_vec, S, C)
        with span("fn.kernel"):
            clvs = {}
            scaler_sites = torch.zeros(pm.n_pad, dtype=torch.int32,
                                       device=pm.device)
            for parent, l, r in schedule:
                x1, x2 = [pm._expand_tip(ch) if ch < n_leaves
                          else clvs.pop(ch) for ch in (l, r)]
                x3, sc = pdiff(x1, x2, ops[l], ops[r], pm.ec, n)
                clvs[parent] = x3
                scaler_sites = scaler_sites + sc[0]
            lik = root_reduce(rr, clvs[root])
        with span("fn.finalise"):
            return _finalise(lik, scaler_sites, wpad, n, asc, d0, w_total)
    return core


def _core_tree(pm, segmented: bool = False, mesh=None):
    """Kernel 2 forward + kernel 4 backward, or kernels 2m + 4m in the
    model's arithmetic (the JAX "tree" backend, optimize.py:355-545), or
    with ``segmented`` kernels 7 + 8 (7m + 8m) (the JAX "segmented"
    backend, optimize.py:446-457, bf16 boundaries and adjoints under the
    config's ``dtype``, with its warning); operators indexed by original
    edge.  With ``mesh``, on this rank's shard of the sites
    (``PhyloModel.site_shard``): the operator stacks and root rows pass
    through ``parallel.replicated`` (their gradients summed over the
    ranks) and the log-likelihood partials are all-reduced
    (:func:`_finalise`)."""
    from ..parallel.sharding import replicated
    cfg = pm.config
    S, C = cfg.states, cfg.categories
    variant = cfg.resolved_kernel_variant
    matrix_form = uses_mxu_kernels(variant, S)
    u, lam, pi_u = _model_tensors(pm)
    n, n_leaves = pm.n_sites, pm.tree.n_leaves
    E = len(pm.schedule)
    rows = cfg.rows
    sched = reorder_schedule(pm.schedule, n_leaves)
    kernel_variant = variant if matrix_form else "vpu"
    if segmented:
        if cfg.dtype == "bfloat16":
            warnings.warn(
                "optimising through bf16 boundary-CLV storage: "
                "likelihoods/gradients carry ~1e-3-class rounding from "
                "the bf16 streams; use dtype='float32' for final fits",
                stacklevel=3)
        tdiff = make_tree_diff_segmented(sched, n_leaves, states=S,
                                         categories=C,
                                         n_codes=pm.tip_table.shape[1],
                                         variant=kernel_variant,
                                         dtype=cfg.dtype)
    else:
        tdiff = make_tree_diff(sched, n_leaves, states=S, categories=C,
                               variant=kernel_variant)
    child = torch.as_tensor([[e[1] for e in pm.schedule],
                             [e[2] for e in pm.schedule]],
                            dtype=torch.long, device=pm.device)
    codes, wpad = pm.codes, pm.wgt_pad.to(torch.float32)
    asc, d0 = pm.ascertainment == "lewis", pm.n_sites_obs
    w_total = float(np.sum(pm.wgt))
    if mesh is not None:
        codes, wgt, lo, n = pm.site_shard(mesh)
        wpad = wgt.to(torch.float32)
        d0 = int(np.clip(d0 - lo, 0, n))   # this rank's first dummy site

    def core(t_vec, r_vec, w_vec):
        with span("fn.operators"):
            ops = _lane_constants(t_vec[child.reshape(-1)], r_vec, lam, u,
                                  S, C)
            rr = _root_rows(pi_u, w_vec, S, C)
            if mesh is not None:
                flat = replicated(torch.cat([ops.reshape(-1), rr]), mesh)
                ops, rr = flat[:-rows].view(2 * E, rows, S), flat[-rows:]
            lcs, rcs = ops.view(2, -1, S * C, S).unbind(0)
            planes = None
            if matrix_form:
                # this step's lengths split once, the whole (2E, rows, S)
                # stack at a time; the EV planes are the model's own
                hi, lo_ = operator_planes(ops.detach(), variant)
                planes = (hi[:E], lo_[:E], hi[E:], lo_[E:], pm.ec_planes[0],
                          pm.ec_planes[1])
            lcs, rcs = lcs.contiguous(), rcs.contiguous()
        with span("fn.kernel"):
            lik, sc = tdiff(codes, lcs, rcs, pm.ec, pm.fused_tip_table, rr,
                            n, planes=planes)
        with span("fn.finalise"):
            return _finalise(lik[0], sc[0], wpad, n, asc, d0, w_total, mesh)
    return core


def optimize_branch_lengths(pm: PhyloModel, steps: int = 100,
                            learning_rate: float = 0.02,
                            min_length: float = 1e-6, backend: str = "auto",
                            mesh=None) -> Tuple[np.ndarray, float, float]:
    """Maximise the tree likelihood over all branch lengths.

    Adam (``torch.optim.Adam`` with optax's defaults: b1 0.9, b2 0.999,
    eps 1e-8 added outside the square root) on log lengths, so lengths
    stay positive.  On a CUDA model each step is one forward and one
    backward through the kernels of ``backend`` (see :func:`tree_loglik_fn`).
    With ``mesh`` every rank runs the step on its shard of the sites and
    holds the same all-reduced value and gradient, so the ranks take the
    same steps ("tree" or "segmented" backends).
    Returns ``(optimised_lengths, ll_before, ll_after)``.
    """
    fn, t0 = tree_loglik_fn(pm, backend=backend, mesh=mesh)
    dev = pm.device
    t0_dev = torch.as_tensor(t0, device=dev)
    with torch.no_grad():
        ll0 = float(fn(t0_dev))
    log_t = torch.log(torch.clamp_min(t0_dev, min_length)).requires_grad_()
    opt = torch.optim.Adam([log_t], lr=learning_rate, betas=(0.9, 0.999),
                           eps=1e-8)
    for _ in range(steps):
        opt.zero_grad()
        loss = -fn(torch.exp(log_t) + min_length)
        loss.backward()
        opt.step()
    with torch.no_grad():
        t_opt = torch.exp(log_t) + min_length
        ll1 = float(fn(t_opt))
    return t_opt.cpu().numpy(), ll0, ll1


def _golden_section(f, lo: float, hi: float, iters: int = 30):
    """Maximise a unimodal scalar function on [lo, hi]."""
    invphi = (np.sqrt(5.0) - 1.0) / 2.0
    a, b = lo, hi
    c = b - invphi * (b - a)
    d = a + invphi * (b - a)
    fc, fd = f(c), f(d)
    for _ in range(iters):
        if fc > fd:
            b, d, fd = d, c, fc
            c = b - invphi * (b - a)
            fc = f(c)
        else:
            a, c, fc = c, d, fd
            d = a + invphi * (b - a)
            fd = f(d)
    x = (a + b) / 2.0
    return x, f(x)


def optimize_alpha(pm: PhyloModel, alpha_bounds=(0.02, 100.0),
                   iters: int = 30, backend: str = "auto"
                   ) -> Tuple[float, float, float]:
    """Maximum-likelihood gamma shape at fixed tree and lengths:
    golden-section search in log-alpha over one likelihood function of
    the ``(C,)`` rate vector (the discretisation runs on the host).
    Returns ``(alpha_hat, ll_before, ll_after)``; ``ll_before`` uses the
    model's current rates."""
    from .substitution import discrete_gamma_rates, gamma_invariant_rates

    C = pm.config.categories
    fn, t0 = tree_loglik_fn(pm, with_rates=True, backend=backend)

    def ll_of_rates(r) -> float:
        with torch.no_grad():
            return float(fn(t0, np.asarray(r, np.float32)))

    def ll_of_log_alpha(la: float) -> float:
        alpha = float(np.exp(la))
        # +I models carry the rate-0 category at index 0 and C-1 gamma
        # categories (the mixture weights stay fixed).
        if pm.p_inv is not None:
            return ll_of_rates(gamma_invariant_rates(alpha, pm.p_inv,
                                                     C - 1)[0])
        return ll_of_rates(discrete_gamma_rates(alpha, C))

    ll0 = ll_of_rates(pm.rates)
    la, ll1 = _golden_section(ll_of_log_alpha, np.log(alpha_bounds[0]),
                              np.log(alpha_bounds[1]), iters)
    return float(np.exp(la)), ll0, ll1


def optimize_pinv(pm: PhyloModel, alpha: Optional[float] = None,
                  bounds=(1e-4, 0.99), iters: int = 30,
                  backend: str = "auto") -> Tuple[float, float, float]:
    """Maximum-likelihood proportion of invariant sites (+I / +I+G) by
    golden-section search at fixed tree, lengths and gamma shape
    ``alpha`` (default: the shape implied by ``pm.rates``).  ``pm`` must
    have been built with ``p_inv``.  Returns ``(p_inv_hat, ll_before,
    ll_after)``."""
    if pm.p_inv is None:
        raise ValueError("build the PhyloModel with p_inv to optimise it")
    C = pm.config.categories            # includes the invariant category
    fn, t0 = tree_loglik_fn(pm, with_weights=True, backend=backend)

    def ll_at(rates, weights) -> float:
        with torch.no_grad():
            return float(fn(t0, np.asarray(rates, np.float32),
                            np.asarray(weights, np.float32)))

    ll0 = ll_at(pm.rates, pm.rate_weights)
    if alpha is None:          # gamma rates at weight-free scale
        base_g = np.asarray(pm.rates[1:]) * (1.0 - pm.p_inv)
    else:
        from .substitution import discrete_gamma_rates
        base_g = discrete_gamma_rates(alpha, C - 1)

    def ll_of(p: float) -> float:
        weights = np.concatenate([[p], np.full(C - 1, (1.0 - p) / (C - 1))])
        return ll_at(np.concatenate([[0.0], base_g / (1.0 - p)]), weights)

    p_hat, ll1 = _golden_section(ll_of, bounds[0], bounds[1], iters)
    return float(p_hat), ll0, ll1


# ---------------------------------------------------------------------------
# Full model fitting: GTR exchangeabilities + base frequencies + branch
# lengths, all by gradient ascent with the eigendecomposition inside the
# graph (plf_tpu/models/optimize.py:694-800).  The gamma shape alpha stays
# an outer-loop scalar (its discretisation uses a quantile function with no
# stable gradient).
# ---------------------------------------------------------------------------


def _gtr_eigen_torch(log_rates, logits_pi, S: int):
    """Differentiable reversible-Q eigensystem (``substitution._make`` in
    torch; the JAX package's ``_gtr_eigen_jnp``, ``optimize.py:703``).

    Returns ``(lam, u, w, pi)``.  Caution: exactly degenerate eigenvalues
    (e.g. literal JC69) make eigh gradients NaN -- start from slightly
    perturbed rates, as :func:`fit_model` does.
    """
    rates = torch.exp(log_rates)
    pi = torch.softmax(logits_pi, dim=0)
    i0, i1 = (torch.as_tensor(ix) for ix in np.triu_indices(S, 1))
    qsym = torch.zeros((S, S), dtype=rates.dtype,
                       device=rates.device).index_put((i0, i1), rates)
    qsym = qsym + qsym.T
    q = qsym * pi[None, :]
    q = q - torch.diag(q.sum(dim=1))
    rate = -(pi * torch.diagonal(q)).sum()
    q = q / rate
    d = torch.sqrt(pi)
    b = (q * d[:, None]) / d[None, :]
    b = 0.5 * (b + b.T)
    lam, v = torch.linalg.eigh(b)
    u = v / d[:, None]
    w = v.T * d[None, :]
    return lam, u, w, pi


def _tip_table(w, S: int):
    """``io/alignment.py::tip_expansion_table`` of a differentiable ``w``:
    columns W.e_b, the gap column W.1, the ambiguity columns."""
    cols = [w, w.sum(dim=1, keepdim=True)]
    for members in AMBIGUITY.get(S, ()):
        cols.append(w[:, list(members)].sum(dim=1, keepdim=True))
    return torch.cat(cols, dim=1)


def fit_model(pm: PhyloModel, steps: int = 150, learning_rate: float = 0.02,
              min_length: float = 1e-6, fit_lengths: bool = True,
              fit_alpha: bool = False, alpha_rounds: int = 2,
              alpha_bounds=(0.02, 100.0), seed: int = 0):
    """Maximum-likelihood fit of GTR rates, frequencies and branch lengths.

    Starts from the PhyloModel's current model/lengths (rates jittered by
    a seeded 1e-3 log-normal factor, ``seed``, to break eigh
    degeneracies).  Returns ``(fitted SubstitutionModel, fitted lengths,
    ll_before, ll_after)``.

    The likelihood is the "torch" core's plain element-wise traversal on
    ``pm.device`` (no kernel: the tip table depends on the fitted
    eigenvectors, and the kernels' backward takes no tip-table
    gradient), under torch autograd; the S x S eigensystem
    (``torch.linalg.eigh``, fp32) runs on the host inside the graph.  The
    traversal runs in dependency waves (:func:`_waves`): one batched stage
    for every node whose children are ready, each element computed as a
    single node's stage computes it, so a step launches E / waves times
    fewer small kernels (the card's cost of this plain path is its
    launches).
    Adam (``torch.optim.Adam`` with optax's defaults) updates log
    exchangeabilities, frequency logits and log lengths together.

    With ``fit_alpha`` the gamma shape is fitted too, by coordinate
    descent: the adam steps split into ``alpha_rounds`` epochs with a
    golden-section alpha line search after each.  With ``fit_alpha`` the
    return gains a fifth element: ``(..., alpha_hat)``.
    """
    from .substitution import (discrete_gamma_rates, gamma_invariant_rates,
                               gtr)

    cfg = pm.config
    S, C = cfg.states, cfg.categories
    dev = pm.device
    schedule = [(p, l, r) for (p, l, r, _, _) in pm.schedule]
    n_leaves, n = pm.tree.n_leaves, pm.n_sites
    codes = pm.codes[:, :n].long()
    wgt = _f32(pm.wgt, dev)
    wgt_i = torch.as_tensor(pm.wgt, dtype=torch.int32, device=dev)
    cw = _f32(pm.rate_weights, dev)
    asc, d0 = pm.ascertainment == "lewis", pm.n_sites_obs
    w_total = float(np.sum(pm.wgt))

    # Initial parameters from the current model: recover the
    # exchangeabilities from Q = U diag(lam) W via qsym[i,j] = q[i,j]/pi[j].
    m0 = pm.model
    q0 = (m0.u * m0.eigenvalues[None, :]) @ m0.w
    iu = np.triu_indices(S, 1)
    ex0 = np.clip(q0[iu] / m0.pi[iu[1]], 1e-3, None)
    rng = np.random.default_rng(seed)
    ex0 = ex0 * np.exp(rng.normal(0, 1e-3, ex0.shape))  # break degeneracy
    lengths = [pm.tree.nodes[i].length for i in range(pm.tree.n_nodes - 1)]
    # the traversal by waves: each wave's children as rows of the store
    # and as node indices of the length vector
    row_of = {leaf: leaf for leaf in range(n_leaves)}
    waves = []
    for parents, lefts, rights in _waves(schedule):
        waves.append(tuple(torch.tensor(v, dtype=torch.long, device=dev)
                           for v in ([row_of[c] for c in lefts],
                                     [row_of[c] for c in rights],
                                     lefts, rights)))
        for p in parents:
            row_of[p] = len(row_of)
    log_rates = torch.tensor(np.log(ex0), dtype=torch.float32,
                             requires_grad=True)
    logits_pi = torch.tensor(np.log(m0.pi), dtype=torch.float32,
                             requires_grad=True)
    log_t = torch.log(torch.clamp_min(_f32(lengths, dev), min_length)
                      ).requires_grad_()

    def loglik(rates_gamma):
        lam, u, w, pi = (x.to(dev) for x in _gtr_eigen_torch(
            log_rates, logits_pi, S))
        t_vec = torch.exp(log_t) + min_length
        if not fit_lengths:
            t_vec = t_vec.detach()
        wg = _tip_table(w, S)                     # (S, n_codes)

        def branch_factor(t):             # (m, C, S, S): [j, c, k, a]
            e = torch.exp(lam * t[:, None, None] * rates_gamma[:, None])
            return u * e[..., None, :]

        # one stage a wave of nodes; store rows: the leaves, then each
        # wave's parents in turn
        # (embedding: its backward sums repeated codes in a fixed order)
        store = torch.nn.functional.embedding(codes, wg.t())[
            :, :, None, :].expand(n_leaves, n, C, S)
        scaler_sites = torch.zeros(n, dtype=torch.int32, device=dev)
        for rows_l, rows_r, t_l, t_r in waves:
            x3, sv = _plf_stage(store.index_select(0, rows_l),
                                store.index_select(0, rows_r),
                                branch_factor(t_vec.index_select(0, t_l)),
                                branch_factor(t_vec.index_select(0, t_r)),
                                w.T, S)
            store = torch.cat([store, x3])
            scaler_sites = scaler_sites + sv.sum(dim=0, dtype=torch.int32)
        lik = (store[-1] @ (pi @ u)) @ cw
        site_ll = torch.log(torch.clamp_min(lik, LIK_FLOOR))
        scaler = (scaler_sites * wgt_i).sum().to(torch.float32)
        ll = (site_ll * wgt).sum() + scaler * LOG_MINLIK
        if asc:
            log_pc = site_ll[d0:] + scaler_sites[d0:].to(torch.float32) \
                * LOG_MINLIK
            ll = ll - w_total * torch.log1p(-torch.exp(log_pc).sum())
        return ll

    def ll_at(rates_gamma) -> float:
        with torch.no_grad():
            return float(loglik(rates_gamma))

    opt = torch.optim.Adam([log_rates, logits_pi, log_t], lr=learning_rate,
                           betas=(0.9, 0.999), eps=1e-8)

    def step(rates_gamma):
        opt.zero_grad()
        (-loglik(rates_gamma)).backward()
        opt.step()

    rg = _f32(pm.rates, dev)
    ll0 = ll_at(rg)
    alpha_hat = None
    if fit_alpha:
        def rates_of(alpha: float) -> np.ndarray:
            if pm.p_inv is not None:
                return gamma_invariant_rates(alpha, pm.p_inv, C - 1)[0]
            return discrete_gamma_rates(alpha, C)

        epochs = max(1, alpha_rounds)
        per = max(1, steps // epochs)
        for _ in range(epochs):
            for _ in range(per):
                step(rg)
            la, _ = _golden_section(
                lambda x: ll_at(_f32(rates_of(float(np.exp(x))), dev)),
                np.log(alpha_bounds[0]), np.log(alpha_bounds[1]), iters=25)
            alpha_hat = float(np.exp(la))
            rg = _f32(rates_of(alpha_hat), dev)
    else:
        for _ in range(steps):
            step(rg)
    ll1 = ll_at(rg)

    with torch.no_grad():
        fitted = gtr(np.exp(log_rates.detach().numpy().astype(np.float64)),
                     torch.softmax(logits_pi, dim=0).detach().numpy()
                     .astype(np.float64))
        t_opt = (torch.exp(log_t) + min_length).detach().cpu().numpy()
    if fit_alpha:
        return fitted, t_opt, ll0, ll1, alpha_hat
    return fitted, t_opt, ll0, ll1


# ---------------------------------------------------------------------------
# Codon-model fitting: ML estimation of the GY94 omega (dN/dS) and kappa on
# their 2-D profile likelihood (plf_tpu/models/optimize.py:889-982).
# ---------------------------------------------------------------------------


def fit_codon(tree, tip_states, wgt=None, alpha: Optional[float] = None,
              config=None, pi: Optional[np.ndarray] = None,
              kappa0: float = 2.0, omega0: float = 0.5,
              kappa_bounds=(0.2, 40.0), omega_bounds=(1e-3, 10.0),
              rounds: int = 3, iters: int = 10,
              fit_lengths: bool = True, length_steps: int = 60,
              fit_alpha: bool = False, verbose: bool = False,
              device: Union[str, torch.device] = "cuda"):
    """Maximum-likelihood GY94 fit: omega (dN/dS), kappa, F3x4
    frequencies, branch lengths (and optionally the gamma shape).

    ``tip_states``: ``(n_leaves, n_codons)`` codon state codes
    (:func:`substitution.encode_codon_alignment`).  Frequencies default to
    the F3x4 estimate from the data (:func:`substitution.f3x4_from_codes`).

    Coordinate golden-section search on (log kappa, log omega): each
    candidate rebuilds the 61-state eigensystem on the host and evaluates
    one whole-tree likelihood (``PhyloModel.log_likelihood``: kernel 2m on
    the card).  Branch lengths are fitted under the initial model and
    re-fitted under the winner by :func:`optimize_branch_lengths` (on the
    card kernels 2m + 4m per step; the default config resolves to
    "mxu_3x" at S = 61).  The models live on ``device``.

    Returns ``(model, info)`` with ``info`` a dict holding kappa, omega,
    alpha, lengths (node-indexed vector), ll, pi and the fitted tree.
    """
    from ..config import PLFConfig
    from .substitution import codon_gy94, f3x4_from_codes
    from .tree import Tree, TreeNode

    codes = np.asarray(tip_states)
    if pi is None:
        pi = f3x4_from_codes(codes, wgt)
    cfg = config or PLFConfig(states=61, kernel_variant="auto",
                              block_sites=1024)

    def with_lengths(t: Tree, t_vec) -> Tree:
        nodes = [TreeNode(n.index, n.name,
                          float(t_vec[n.index]) if n.index < len(t_vec)
                          else n.length, n.children)
                 for n in t.nodes]
        return Tree(nodes=nodes, root=t.root)

    def model_at(k: float, w: float, t: Tree, a=None) -> PhyloModel:
        return PhyloModel(t, codon_gy94(k, w, pi), codes, wgt=wgt,
                          alpha=alpha_hat if a is None else a, config=cfg,
                          device=device)

    kappa, omega = float(kappa0), float(omega0)
    alpha_hat = alpha

    def ll_of(k: float, w: float, t: Tree) -> float:
        return model_at(k, w, t).log_likelihood().log_likelihood

    if fit_lengths:          # initial branch lengths under the start model
        t_opt, _, _ = optimize_branch_lengths(model_at(kappa, omega, tree),
                                              steps=length_steps)
        tree = with_lengths(tree, t_opt)

    for r in range(rounds):
        lw, _ = _golden_section(
            lambda x: ll_of(kappa, float(np.exp(x)), tree),
            np.log(omega_bounds[0]), np.log(omega_bounds[1]), iters)
        omega = float(np.exp(lw))
        lk, _ = _golden_section(
            lambda x: ll_of(float(np.exp(x)), omega, tree),
            np.log(kappa_bounds[0]), np.log(kappa_bounds[1]), iters)
        kappa = float(np.exp(lk))
        if fit_alpha:
            alpha_hat, _, _ = optimize_alpha(
                model_at(kappa, omega, tree, alpha_hat or 0.5))
        if verbose:
            print(f"fit_codon round {r}: kappa={kappa:.3f} "
                  f"omega={omega:.4f} alpha={alpha_hat}", flush=True)

    model = codon_gy94(kappa, omega, pi)
    if fit_lengths:
        t_opt, _, ll = optimize_branch_lengths(model_at(kappa, omega, tree),
                                               steps=length_steps // 2)
        tree = with_lengths(tree, t_opt)
    else:
        t_opt = np.asarray([tree.nodes[i].length
                            for i in range(tree.n_nodes - 1)])
        ll = ll_of(kappa, omega, tree)
    info = dict(kappa=kappa, omega=omega, alpha=alpha_hat,
                lengths=np.asarray(t_opt), ll=float(ll), pi=pi, tree=tree)
    return model, info
