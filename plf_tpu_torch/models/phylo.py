"""Whole-tree likelihood: the evaluation paths around the PLF kernels.

Counterpart of ``plf_tpu/models/phylo.py``.  ``PhyloModel`` is an
``nn.Module`` whose device-resident state lives in registered buffers:
the tip codes, the site weights, the per-edge operator stacks, the EV
constants, the tip table, the root rows and the register-machine
schedule.  Two evaluation paths:

* **fused** -- kernel 2 (``ops/plf_tree.py``): the whole post-order
  traversal in one launch, internal CLVs in shared memory, tips expanded
  on demand from int codes;
* **per-node** -- kernel 1 (``ops/plf_node.py``) once per internal node,
  the parent written in place over a dead internal child, and a final
  root reduction in kernel 2's op order (``ops/plf_tree.py::root_reduce``).

Those are the "vpu" kernels at S = 4.  Every other model -- the "mxu",
"mxu_3x" and "mxu_bf16" variants, and "vpu" at S != 4 (protein: S = 20)
-- runs kernel 2m fused and kernel 1m per node (``ops/plf_mxu.py``), with
the JAX package's tip semantics: the fused path expands tips from a tip
table rounded as the variant's tip product rounds it
(``ops/plf_mxu.py::round_tip_table``), the per-node path exactly.

Those kernels take their operators split once here, for the variant
(``ops/plf_mxu.py::operator_planes``), not on every launch.

A third path, **segmented** (``ops/plf_tree_seg.py``: kernel 7, or 7m
for a matrix-form model), cuts the tree into subtrees whose roots pass
through a boundary buffer in device memory: the JAX package's route for
trees too big for one arena.  ``config.dtype="bfloat16"`` stores that
buffer in bf16; the fused and per-node paths ignore ``dtype`` and stay
fp32, as the JAX package's do.

``auto`` takes the fused path whenever the GPU capacity rule of the
model's kernel (``ops/plf_tree.py::tree_fused_threads`` or
``tree_mxu_fits``) admits the tree, then the segmented path
(:meth:`PhyloModel.can_segment`), then per-node.  The log and the sum
over sites run on the host in float64.

``config.backend`` is the user's choice of compute path, as in the JAX
package: ``Backend.KERNEL`` (the default) runs the routes above;
``Backend.TORCH`` runs the plain site-major PLF of ``ops/plf_torch.py``
node by node (``can_fuse`` and ``can_segment`` are False and no kernel
wrapper is called), on whatever device the model lives, the card
included.

:func:`batch_log_likelihood` scores a tree-search neighbourhood (models
over one alignment that differ in topology and branch lengths) in one
launch of kernel 2 or 2m with a candidate axis
(``ops/plf_tree.py::plf_tree_batch``), where the batch fits the kernel's
arena (:func:`batch_fits`); :func:`batch_log_likelihood_segmented` scores
one that does not on kernel 7 or 7m with a candidate axis
(``ops/plf_tree_seg.py::plf_tree_seg_batch``).
:meth:`PhyloModel.log_likelihood_sharded` shards the sites over the ranks
of a ``torch.distributed`` group (``parallel.SiteMesh``), each rank on its
own shard, the partials all-reduced.

Log-likelihood:  ll = sum_s wgt_s * log( sum_c w_c rv . x_root[s,c,:] )
                     + scaler_total * log(2^-32)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import numpy as np
import torch
from torch import nn

from ..config import Backend, PLFConfig
from ..devices import resolve_device
from ..io.alignment import AMBIGUITY, map_tip_codes, tip_expansion_table
from ..ops import layout as L
from ..ops.plf_mxu import operator_planes, round_tip_table, uses_mxu_kernels
from ..ops.plf_node import plf_node
from ..ops.plf_torch import plf_torch
from ..ops.plf_tree import (LIK_FLOOR, LOG_MINLIK,
                            batched_tree_loglik_parts, carry_program,
                            compile_register_schedule, plf_tree,
                            reorder_schedule, root_reduce,
                            tree_fused_threads, tree_mxu_fits)
from ..ops.plf_tree_seg import (batched_seg_loglik_parts,
                                carry_segment_program, plan_segments,
                                plf_tree_seg, segment_program, stack_programs)
from .substitution import (SubstitutionModel, branch_matrices,
                           discrete_gamma_rates, gamma_invariant_rates)
from .tree import Tree

__all__ = ["PhyloModel", "TreeLikelihoodResult", "batch_log_likelihood",
           "batch_log_likelihood_segmented", "batch_fits", "batch_inputs",
           "segmented_batch_inputs"]


@dataclasses.dataclass
class TreeLikelihoodResult:
    log_likelihood: float
    site_log_likelihood: np.ndarray   # (n_sites,) float64, pre-weighting
    scaler_total: int                 # wgt-weighted rescale count
    root_clv: Optional[torch.Tensor] = None  # lane-major root CLV (if kept)
    scaler_sites: Optional[np.ndarray] = None  # (n_sites,) per-site counts

    def true_site_log_likelihood(self) -> np.ndarray:
        """Per-site log-likelihood with 2^-32 rescale factors folded in
        (what bootstrap/RELL resampling must weight)."""
        if self.scaler_sites is None:
            return self.site_log_likelihood
        return self.site_log_likelihood + self.scaler_sites * LOG_MINLIK


class PhyloModel(nn.Module):
    """Tree + substitution model + alignment -> log-likelihood.

    Example::

        model = PhyloModel(tree, empirical_protein("lg"), tip_states,
                           alpha=0.5)          # on the card
        out = model.log_likelihood()
    """

    def __init__(self, tree: Tree, model: SubstitutionModel,
                 tip_states: np.ndarray, wgt: Optional[np.ndarray] = None,
                 alpha: Optional[float] = None,
                 config: Optional[PLFConfig] = None,
                 ascertainment: Optional[str] = None,
                 p_inv: Optional[float] = None,
                 rate_weights: Optional[np.ndarray] = None,
                 rates: Optional[np.ndarray] = None,
                 share_device_from: Optional["PhyloModel"] = None,
                 device: Union[str, torch.device] = "cuda"):
        """
        Args:
          tip_states: (n_leaves, n_sites) int array of observed states per
            leaf in alignment code space (``io/alignment.py``).
          wgt: (n_sites,) site pattern weights.
          alpha: gamma shape; None = uniform rates.
          ascertainment: None or "lewis" (Lewis 2001): S zero-weight
            constant dummy sites are appended and ll_s -= log(1 - p_const).
          p_inv: proportion of invariant sites: a rate-0 category of weight
            ``p_inv`` is added, so the category count becomes
            ``config.categories + 1``.
          rate_weights: explicit per-category mixture weights (sum 1).
          rates: explicit per-category rates, instead of ``alpha``/
            ``p_inv``; the category count becomes ``len(rates)``.  This is
            how ``convert.py`` carries a JAX model's rate mixture by value.
          share_device_from: a PhyloModel over the same alignment,
            substitution model, rates and config whose device tensors
            (codes, weights, EV constants, tip table) and branch-operator
            cache are reused instead of rebuilt.
          device: where the buffers live; "cuda" (the default) runs the
            CUDA kernels, "cpu" their plain versions.  Without a card the
            default fails here, at construction.
        """
        super().__init__()
        self.tree = tree
        self.model = model
        cfg = config or PLFConfig(states=model.states, kernel_variant="auto")
        if cfg.states != model.states:
            cfg = dataclasses.replace(cfg, states=model.states)
        self.tip_states = np.asarray(tip_states)
        self.n_sites_obs = int(self.tip_states.shape[1])
        self.wgt = (np.ones(self.n_sites_obs, np.int32) if wgt is None
                    else np.asarray(wgt, np.int32))
        if ascertainment not in (None, "lewis"):
            raise ValueError(f"unknown ascertainment {ascertainment!r}")
        self.ascertainment = ascertainment
        if ascertainment == "lewis":
            S_ = model.states
            const = np.tile(np.arange(S_, dtype=self.tip_states.dtype),
                            (self.tip_states.shape[0], 1))
            self.tip_states = np.concatenate([self.tip_states, const],
                                             axis=1)
            self.wgt = np.concatenate([self.wgt, np.zeros(S_, np.int32)])
        self.n_sites = int(self.tip_states.shape[1])
        self.p_inv = p_inv
        if rates is not None:
            if alpha is not None or p_inv is not None:
                raise ValueError("pass rates or alpha/p_inv, not both")
            self.rates = np.asarray(rates, np.float64)
            cfg = dataclasses.replace(cfg, categories=len(self.rates))
        elif p_inv is not None:
            if rate_weights is not None:
                raise ValueError("pass either p_inv or rate_weights")
            self.rates, rate_weights = gamma_invariant_rates(
                alpha, p_inv, cfg.categories)
            cfg = dataclasses.replace(cfg, categories=cfg.categories + 1)
        elif alpha is None:
            self.rates = np.ones(cfg.categories)
        else:
            self.rates = discrete_gamma_rates(alpha, cfg.categories)
        if rate_weights is None:
            self.rate_weights = np.full(cfg.categories, 1.0 / cfg.categories)
        else:
            self.rate_weights = np.asarray(rate_weights, np.float64)
            if self.rate_weights.shape != (cfg.categories,):
                raise ValueError(
                    f"rate_weights must have shape ({cfg.categories},)")
            if abs(float(self.rate_weights.sum()) - 1.0) > 1e-6:
                raise ValueError("rate_weights must sum to 1")
        self.config = cfg

        S, C = cfg.states, cfg.categories
        self.n_pad = L.sites_padding(self.n_sites, cfg.block_sites)
        self.schedule = tree.schedule()
        # "cuda" is resolved to its card (in a run, the rank's own), so
        # that a model, its share_device_from donor and a mesh compare equal
        device = resolve_device(device)

        donor = share_device_from
        if donor is not None and (
                donor.model is not model
                or not np.array_equal(donor.rates, self.rates)
                or donor.config != self.config):
            raise ValueError(
                "share_device_from needs an identical model/rates/"
                "config (only topology/branch lengths may differ)")
        # Encoded-operator cache keyed by branch length, shared with a
        # donor: same-alignment candidates mostly share branch lengths.
        self._branch_cache = {} if donor is None else donor._branch_cache

        def enc_cached(t):
            key = float(t)
            v = self._branch_cache.get(key)
            if v is None:
                v = L.branch_to_lane_constants(
                    branch_matrices(model, key, self.rates, C), S, C)
                self._branch_cache[key] = v
            return v

        for name, col in (("lcs", 3), ("rcs", 4)):   # (E, rows, S) stacks
            self.register_buffer(name, torch.as_tensor(np.stack(
                [enc_cached(entry[col]) for entry in self.schedule]),
                device=device))
        rows = np.repeat(model.root_vector, C) * np.tile(self.rate_weights, S)
        self.register_buffer("root_rows", torch.as_tensor(
            rows.astype(np.float32).reshape(1, -1), device=device))

        if donor is not None:
            same_aln = (donor.tip_states is self.tip_states
                        or (donor.tip_states.shape == self.tip_states.shape
                            and np.array_equal(donor.tip_states,
                                               self.tip_states)))
            same_wgt = (donor.wgt is self.wgt
                        or np.array_equal(donor.wgt, self.wgt))
            if donor.n_pad != self.n_pad or not same_aln or not same_wgt:
                raise ValueError(
                    "share_device_from needs an identical alignment and "
                    "site weights (only topology/branch lengths may differ)")
            if donor.codes.device != device:
                raise ValueError("share_device_from: donor lives on "
                                 f"{donor.codes.device}, not {device}")
            for name in ("codes", "wgt_pad", "ec", "tip_table",
                         "fused_tip_table"):
                self.register_buffer(name, getattr(donor, name))
        else:
            # Tip-table columns: states, gap (S, also the padding code) and
            # the IUPAC columns up to the largest code observed.
            codes = map_tip_codes(self.tip_states, S)
            n_codes = max(S + 1, int(codes.max()) + 1)
            codes = L.pad_to_multiple(codes, self.n_pad, axis=-1)
            codes[:, self.n_sites:] = S
            # C order whatever the tip matrix's (a column selection such
            # as compress_patterns' is Fortran-ordered): the kernels take
            # contiguous codes
            codes = np.ascontiguousarray(
                codes, np.int8 if cfg.tip_dtype == "int8" else np.int32)
            self.register_buffer("codes", torch.as_tensor(codes,
                                                          device=device))
            wpad = L.pad_to_multiple(self.wgt.reshape(1, -1), self.n_pad,
                                     axis=-1)[0]
            self.register_buffer("wgt_pad", torch.as_tensor(wpad,
                                                            device=device))
            self.register_buffer("ec", torch.as_tensor(
                L.ev_to_lane_constants(model.plf_ev, S, C), device=device))
            tbl = tip_expansion_table(model.w, S)[:, :n_codes]
            self.register_buffer("tip_table", torch.as_tensor(
                np.repeat(tbl, C, axis=0).astype(np.float32),
                device=device))
            # The fused path's tips: the table as the variant's tip
            # product rounds it (the same tensor for "vpu" and "mxu").
            self.register_buffer("fused_tip_table", round_tip_table(
                self.tip_table, cfg.resolved_kernel_variant).contiguous())

        # Kernels 1m, 2m and 7m take (hi, lo) operator planes: split once
        # here.
        mxu = uses_mxu_kernels(cfg.resolved_kernel_variant, S)
        for name, k in (("lcs_planes", self.lcs), ("rcs_planes", self.rcs),
                        ("ec_planes", self.ec)):
            self.register_buffer(name, torch.stack(operator_planes(
                k, cfg.resolved_kernel_variant)) if mxu else None)

        sched = reorder_schedule(self.schedule, tree.n_leaves)
        arrs, self.n_slots, self.root_slot = compile_register_schedule(
            sched, tree.n_leaves)
        self._sched_np = np.stack(arrs)
        self.register_buffer("sched", torch.as_tensor(self._sched_np,
                                                      device=device))
        # kernel 2's program: operands of the op before from registers
        self._carry_np, self.carry_slots = carry_program(arrs)
        self._carry = None
        self._seg_cache = self._seg_np = None

    @property
    def device(self) -> torch.device:
        return self.codes.device

    @property
    def tree_program(self):
        """Kernel 2's ``(program, n_slots)`` (``ops/plf_tree.py::
        carry_program`` of ``sched``), the program on the model's device,
        built once per device."""
        if self._carry is None or self._carry[0].device != self.device:
            self._carry = (torch.as_tensor(self._carry_np,
                                           device=self.device),
                           self.carry_slots)
        return self._carry

    def _planes(self, e: Optional[int] = None):
        """The operator planes of edge ``e`` (of every edge if None) for
        the matrix-form kernels, or None for kernels 1 and 2."""
        if self.ec_planes is None:
            return None
        lp, rp = self.lcs_planes, self.rcs_planes
        if e is not None:
            lp, rp = lp[:, e], rp[:, e]
        return (lp[0], lp[1], rp[0], rp[1], self.ec_planes[0],
                self.ec_planes[1])

    # -- per-node traversal (kernel 1) ---------------------------------------

    def _expand_tip(self, leaf: int) -> torch.Tensor:
        """Lane-major ``(rows, n_pad)`` eigen-coordinate CLV of a leaf: the
        tip-table column of each site's code (exact)."""
        return self.tip_table[:, self.codes[leaf].long()]

    def _traverse(self):
        """Post-order traversal, one kernel-1 (or 1m) launch per internal
        node (the plain site-major PLF under ``Backend.TORCH``).
        Leaf CLVs are expanded when first needed and dropped after use
        (each leaf is read once); the parent CLV is written in place over
        a dead internal child's buffer."""
        cfg = self.config
        if cfg.backend is Backend.TORCH:
            return self._traverse_torch()
        S, C = cfg.states, cfg.categories
        n_leaves = self.tree.n_leaves
        clvs: Dict[int, torch.Tensor] = {}
        scaler_sites = torch.zeros(self.n_pad, dtype=torch.int32,
                                   device=self.device)
        variant = cfg.resolved_kernel_variant
        for e, (parent, l, r, _, _) in enumerate(self.schedule):
            x1 = clvs.pop(l) if l >= n_leaves else self._expand_tip(l)
            x2 = clvs.pop(r) if r >= n_leaves else self._expand_tip(r)
            donate = x1 if l >= n_leaves else x2 if r >= n_leaves else None
            x3, sc = plf_node(x1, x2, self.lcs[e], self.rcs[e], self.ec,
                              self.n_sites, states=S, categories=C,
                              out=donate, variant=variant,
                              planes=self._planes(e))
            scaler_sites += sc[0]
            clvs[parent] = x3
        x_root = clvs[self.tree.root]
        lik = root_reduce(self.root_rows[0], x_root)
        return lik, scaler_sites, x_root

    def _traverse_torch(self):
        """The per-node traversal of ``Backend.TORCH``: the plain
        site-major PLF (``ops/plf_torch.py``, the JAX package's ``plf_xla``
        path, ``plf_tpu/models/phylo.py:373-382``) on ``(n_pad, C, S)``
        CLVs and the lane constants unpacked per edge; the root CLV goes
        back to the lane-major layout for the sequential root reduction."""
        cfg = self.config
        S, C = cfg.states, cfg.categories
        n_leaves = self.tree.n_leaves
        wgt = self.wgt_pad.to(torch.int32)
        # lane constants (rows, S) -> [c, k, a] branches; EV [a*C+c, k] ->
        # [k, a] (plf_tpu/models/phylo.py::_unlane_branch, _unlane_ev)
        branch = lambda k: k.reshape(S, C, S).permute(1, 0, 2)
        ev = self.ec.reshape(S, C, S)[:, 0, :].t()
        site_major = lambda leaf: L.from_lane_major(self._expand_tip(leaf),
                                                    S, C)
        clvs: Dict[int, torch.Tensor] = {}
        scaler_sites = torch.zeros(self.n_pad, dtype=torch.int32,
                                   device=self.device)
        for e, (parent, l, r, _, _) in enumerate(self.schedule):
            x1 = clvs.pop(l) if l >= n_leaves else site_major(l)
            x2 = clvs.pop(r) if r >= n_leaves else site_major(r)
            clvs[parent], sv, _ = plf_torch(
                x1, x2, branch(self.lcs[e]), branch(self.rcs[e]), ev, wgt,
                states=S, categories=C)
            scaler_sites += sv
        x_root = L.to_lane_major(clvs[self.tree.root], S, C).contiguous()
        return root_reduce(self.root_rows[0], x_root), scaler_sites, x_root

    def _scaler_total(self, scaler_sites: torch.Tensor) -> int:
        """wgt-weighted rescale count, summed in int64."""
        return int((scaler_sites.to(torch.int64)
                    * self.wgt_pad.to(torch.int64)).sum())

    # -- host finalisation ----------------------------------------------------

    def _asc_log_one_minus_pconst(self, lik_pad: np.ndarray,
                                  sc_sites: np.ndarray) -> float:
        """log(1 - p_const) from the S dummy constant-site likelihoods."""
        d0, d1 = self.n_sites_obs, self.n_sites
        log_pc = (np.log(np.asarray(lik_pad[d0:d1], np.float64))
                  + np.asarray(sc_sites[d0:d1], np.float64) * LOG_MINLIK)
        p_const = float(np.exp(log_pc).sum())
        if p_const >= 1.0:
            raise FloatingPointError(
                f"ascertainment correction degenerate: p_const={p_const}")
        return float(np.log1p(-p_const))

    def _finalise_ll(self, lik_pad: np.ndarray, sc_sites, scaler_total: int
                     ) -> TreeLikelihoodResult:
        """Host-side fp64 log/sum + optional ascertainment correction."""
        n_obs = self.n_sites_obs
        lik_h = np.asarray(lik_pad, dtype=np.float64)
        site_ll = np.log(np.maximum(lik_h[:n_obs], LIK_FLOOR))
        if self.ascertainment == "lewis":
            site_ll = site_ll - self._asc_log_one_minus_pconst(lik_h,
                                                               sc_sites)
        ll = float(np.sum(site_ll * self.wgt[:n_obs])
                   + scaler_total * LOG_MINLIK)
        return TreeLikelihoodResult(
            log_likelihood=ll, site_log_likelihood=site_ll,
            scaler_total=int(scaler_total), root_clv=None,
            scaler_sites=np.asarray(sc_sites)[:n_obs].astype(np.int64))

    # -- fused whole-tree kernel (kernel 2) ----------------------------------

    def can_fuse(self, slots: Optional[int] = None) -> bool:
        """Whether the tree's register-machine arena fits one block's
        shared memory (the capacity rule of the model's tree kernel,
        ops/plf_tree.py), or an arena of ``slots`` slots of that kernel
        (a batch's largest, :func:`batch_fits`); False under
        ``Backend.TORCH``."""
        cfg = self.config
        if cfg.backend is Backend.TORCH:
            return False
        if slots is None:
            slots = self.fused_slots
        n_codes = self.tip_table.shape[1]
        if self._matrix_form:
            return tree_mxu_fits(slots, cfg.rows, n_codes)
        return tree_fused_threads(slots, cfg.rows, n_codes,
                                  cfg.states) is not None

    @property
    def _matrix_form(self) -> bool:
        """Whether the model runs the matrix-form kernels (2m, 1m, 7m)."""
        return uses_mxu_kernels(self.config.resolved_kernel_variant,
                                self.config.states)

    @property
    def fused_slots(self) -> int:
        """Arena slots of the model's fused kernel: kernel 2's carried
        program, or kernel 2m's register schedule."""
        return self.n_slots if self._matrix_form else self.carry_slots

    def _kernel_path(self, name: str):
        if self.config.backend is Backend.TORCH:
            raise ValueError(f"the {name} path runs a CUDA kernel; this "
                             f"model's config chose Backend.TORCH")

    def log_likelihood_fused(self) -> TreeLikelihoodResult:
        """Whole-tree single-kernel evaluation."""
        self._kernel_path("fused")
        cfg = self.config
        lik, sc = plf_tree(
            self.codes, self.sched, self.lcs, self.rcs, self.ec,
            self.fused_tip_table, self.root_rows[0], self.n_sites,
            n_slots=self.n_slots, root_slot=self.root_slot,
            states=cfg.states, categories=cfg.categories,
            variant=cfg.resolved_kernel_variant, planes=self._planes(),
            program=self.tree_program)
        return self._finalise_ll(lik[0].cpu().numpy(), sc[0].cpu().numpy(),
                                 self._scaler_total(sc[0]))

    # -- segmented whole-tree kernel (kernel 7 or 7m) -----------------------

    def can_segment(self) -> bool:
        """Whether the segmented kernels take this model: every kernel
        variant (kernel 7 for "vpu" at S = 4, kernel 7m for the rest), but
        not under ``Backend.TORCH``."""
        return self.config.backend is not Backend.TORCH

    def _segmented_inputs(self):
        """``(plan, prog, segs, n_slots)`` for kernel 7 (7m), built once
        and cached on the model: the plan of the reordered schedule
        (:func:`ops.plf_tree_seg.plan_segments`, the JAX package's cut, at
        the cap of the capacity rule of the kernels that run) and its
        register-allocated program on the model's device; for kernel 7
        also its carried program (:attr:`segmented_program`)."""
        if self._seg_cache is None:
            self._kernel_path("segmented")
            cfg = self.config
            n_leaves = self.tree.n_leaves
            sched = reorder_schedule(self.schedule, n_leaves)
            pos_sched = [(p, l, r, 0.0, 0.0, i)
                         for i, (p, l, r, *_x) in enumerate(sched)]
            plan = plan_segments(
                pos_sched, n_leaves, rows=cfg.rows,
                n_codes=self.tip_table.shape[1],
                matrix_form=uses_mxu_kernels(cfg.resolved_kernel_variant,
                                             cfg.states))
            prog, segs, n_slots = segment_program(plan, sched,
                                                  reuse_slots=True)
            self._seg_cache = (plan, torch.as_tensor(prog, device=self.device),
                               torch.as_tensor(segs, device=self.device),
                               n_slots)
            # the program kernel 7 (7m) runs, on the host: the batched
            # scorer stacks these
            self._seg_np = (prog, segs, n_slots)
            self._seg_program = None
            if not uses_mxu_kernels(cfg.resolved_kernel_variant, cfg.states):
                cprog, slots = carry_segment_program(prog, segs)
                self._seg_np = (cprog, segs, slots)
                self._seg_program = (torch.as_tensor(cprog,
                                                     device=self.device),
                                     slots)
        return self._seg_cache

    @property
    def segmented_program(self):
        """Kernel 7's ``(program, n_slots)`` (``ops/plf_tree_seg.py::
        carry_segment_program`` of the cached segment program, built with
        it, on the model's device), or None for a model on kernel 7m."""
        self._segmented_inputs()
        return self._seg_program

    def log_likelihood_segmented(self) -> TreeLikelihoodResult:
        """Segmented whole-tree evaluation (kernel 7 or 7m, one launch):
        the tree's subtrees in order, their roots through a boundary
        buffer in the config's CLV storage (``dtype``; the one path of
        this model that honours it, as in the JAX package).  With fp32
        boundaries bit-equal to the fused path (and, in the "vpu" form, to
        the per-node path)."""
        cfg = self.config
        plan, prog, segs, n_slots = self._segmented_inputs()
        lik, sc, _ = plf_tree_seg(
            self.codes, prog, segs, self.lcs, self.rcs, self.ec,
            self.fused_tip_table, self.root_rows[0], self.n_sites,
            n_boundaries=plan.n_boundaries, n_slots=n_slots,
            states=cfg.states, categories=cfg.categories,
            variant=cfg.resolved_kernel_variant, planes=self._planes(),
            dtype=getattr(torch, cfg.dtype), program=self.segmented_program)
        return self._finalise_ll(lik[0].cpu().numpy(), sc[0].cpu().numpy(),
                                 self._scaler_total(sc[0]))

    # -- evaluation ----------------------------------------------------------

    def log_likelihood(self, keep_root_clv: bool = False,
                       method: str = "auto") -> TreeLikelihoodResult:
        """Evaluate the tree log-likelihood.

        ``method``: "auto" takes the fused kernel when the tree fits the
        GPU capacity rule, else the segmented kernel where it applies
        (:meth:`can_segment`), else the per-node path; "fused",
        "segmented" and "per-node" force a path ("per-node" is needed to
        keep the root CLV).  Under ``Backend.TORCH`` "auto" is the plain
        per-node path, and "fused" and "segmented" raise ValueError.
        """
        if method not in ("auto", "fused", "per-node", "segmented"):
            raise ValueError(f"unknown method {method!r}")
        auto = method == "auto" and not keep_root_clv
        if method == "fused" or (auto and self.can_fuse()):
            return self.log_likelihood_fused()
        if method == "segmented" or (auto and self.can_segment()):
            return self.log_likelihood_segmented()
        lik, scaler_sites, x_root = self._traverse()
        res = self._finalise_ll(lik.cpu().numpy(),
                                scaler_sites.cpu().numpy(),
                                self._scaler_total(scaler_sites))
        if keep_root_clv:
            res.root_clv = x_root
        return res

    # -- site sharding over torch.distributed --------------------------------

    def site_shard(self, mesh):
        """This rank's share of the sites under ``mesh``
        (``parallel.SiteMesh``): ``(codes, wgt, lo, n_local)``, the tip
        codes ``(n_leaves, shard)`` and int32 weights ``(shard,)`` of its
        shard of the sites padded to ``ranks * block_sites``
        (``parallel.padded_sites``; padding sites hold the gap code and
        weight 0) on the model's device, its first global site and its
        count of valid sites."""
        from ..parallel.sharding import padded_sites, shard_sites, shard_span
        cfg = self.config
        n_pad = padded_sites(mesh, self.n_sites, cfg.block_sites)
        lo, _, n_local = shard_span(mesh, self.n_sites, n_pad)
        codes = shard_sites(mesh, self.codes[:, :self.n_sites], n_pad,
                            fill=cfg.states).to(self.device)
        wgt = shard_sites(mesh, self.wgt_pad[:self.n_sites], n_pad
                          ).to(self.device, torch.int32)
        return codes, wgt, lo, n_local

    def log_likelihood_sharded(self, mesh=None) -> TreeLikelihoodResult:
        """Whole-tree likelihood with the site axis sharded over the ranks
        of ``mesh`` (``parallel.SiteMesh``; default ``parallel.make_mesh``
        on the model's device: every rank of an initialised
        ``torch.distributed``, else one).  Counterpart of
        ``plf_tpu/models/phylo.py:638-712``: each rank runs the model's
        fused kernel (2 or 2m; the segmented kernel 7 or 7m where the
        fused arena does not fit) on its own shard of sites with its count
        of valid sites, and the weighted log-likelihood partials (float64)
        and scaler counts (int64) are all-reduced; a Lewis ascertainment
        correction all-reduces its constant-site likelihoods too.  Every
        rank calls this with the same model and gets the same
        ``log_likelihood`` and ``scaler_total``; its
        ``site_log_likelihood`` and ``scaler_sites`` are THIS rank's shard
        only (its observed sites, in order from its first).  With one rank
        the result equals :meth:`log_likelihood`'s, site for site.  A mesh
        on another device than the model's raises ValueError."""
        from ..parallel.sharding import check_mesh_device, make_mesh
        self._kernel_path("sharded")
        cfg = self.config
        mesh = make_mesh(device=self.device) if mesh is None else mesh
        check_mesh_device(self.device, mesh, "log_likelihood_sharded")
        codes, wgt, lo, n_local = self.site_shard(mesh)
        kw = dict(states=cfg.states, categories=cfg.categories,
                  variant=cfg.resolved_kernel_variant, planes=self._planes())
        if self.can_fuse():
            lik, sc = plf_tree(codes, self.sched, self.lcs, self.rcs,
                               self.ec, self.fused_tip_table,
                               self.root_rows[0], n_local,
                               n_slots=self.n_slots, root_slot=self.root_slot,
                               program=self.tree_program, **kw)
        else:
            plan, prog, segs, n_slots = self._segmented_inputs()
            lik, sc, _ = plf_tree_seg(
                codes, prog, segs, self.lcs, self.rcs, self.ec,
                self.fused_tip_table, self.root_rows[0], n_local,
                n_boundaries=plan.n_boundaries, n_slots=n_slots,
                dtype=getattr(torch, cfg.dtype),
                program=self.segmented_program, **kw)
        lik_h = lik[0, :n_local].cpu().numpy().astype(np.float64)
        sc_h = sc[0, :n_local].cpu().numpy()
        w_h = wgt[:n_local].cpu().numpy()
        site_ll = np.log(np.maximum(lik_h, LIK_FLOOR))
        d0 = self.n_sites_obs
        n_obs = int(np.clip(d0 - lo, 0, n_local))   # this rank's observed
        p_part = 0.0
        if self.ascertainment == "lewis":
            p_part = float(np.exp(np.log(lik_h[n_obs:])
                                  + sc_h[n_obs:] * LOG_MINLIK).sum())
        parts = torch.tensor([float(np.sum(site_ll[:n_obs] * w_h[:n_obs])),
                              p_part], dtype=torch.float64,
                             device=mesh.device)
        counts = torch.tensor([int(np.sum(sc_h.astype(np.int64) * w_h))],
                              dtype=torch.int64, device=mesh.device)
        ll_sum, p_const = mesh.all_reduce(parts).tolist()
        scaler_total = int(mesh.all_reduce(counts)[0])
        site_ll = site_ll[:n_obs]
        ll = ll_sum + scaler_total * LOG_MINLIK
        if self.ascertainment == "lewis":
            if p_const >= 1.0:
                raise FloatingPointError(f"ascertainment correction "
                                         f"degenerate: p_const={p_const}")
            corr = float(np.log1p(-p_const))
            site_ll = site_ll - corr
            ll = ll - corr * float(np.sum(self.wgt[:d0]))
        return TreeLikelihoodResult(
            log_likelihood=ll, site_log_likelihood=site_ll,
            scaler_total=scaler_total, root_clv=None,
            scaler_sites=sc_h[:n_obs].astype(np.int64))

    # -- brute-force oracle (tests) -----------------------------------------

    def log_likelihood_bruteforce(self) -> float:
        """Float64 state-space pruning with explicit P matrices (oracle)."""
        m, cfg = self.model, self.config
        S, C = m.states, cfg.categories
        n = self.n_sites
        partials: Dict[int, np.ndarray] = {}
        amb = AMBIGUITY.get(S, ())
        for leaf in range(self.tree.n_leaves):
            si = self.tip_states[leaf]
            onehot = np.zeros((n, S))
            valid = (si >= 0) & (si < S)
            onehot[np.arange(n)[valid], si[valid]] = 1.0
            for k, members in enumerate(amb):
                hit = si == S + k
                for mem in members:
                    onehot[hit, mem] = 1.0
            gap = (si < 0) | (si >= S + len(amb))
            onehot[gap] = 1.0
            partials[leaf] = np.repeat(onehot[:, None, :], C, axis=1)
        for parent, lc, rc, tl, tr in self.schedule:
            out = np.empty((n, C, S))
            for c in range(C):
                P1 = m.p_matrix(tl, self.rates[c])
                P2 = m.p_matrix(tr, self.rates[c])
                out[:, c, :] = (partials[lc][:, c, :] @ P1.T) * (
                    partials[rc][:, c, :] @ P2.T)
            partials[parent] = out
            del partials[lc], partials[rc]
        root = partials[self.tree.root]
        lik = (root @ m.pi) @ self.rate_weights
        return float(np.sum(np.log(lik) * self.wgt))


# -- batch scoring (tree search) ----------------------------------------------


def _validate_batch_identity(pms) -> None:
    """Same-ALIGNMENT/model validation for the batch scorers.

    Shape equality alone is not enough: two models over different
    alignments (or substitution models / rates) of identical shape would
    pass a shape check and return silently wrong likelihoods.  Sharing via
    ``share_device_from`` makes the arrays identical objects, so the
    common case costs ``is`` checks only.
    """
    pm0 = pms[0]
    for pm in pms[1:]:
        same_aln = (pm.tip_states is pm0.tip_states
                    or (pm.tip_states.shape == pm0.tip_states.shape
                        and np.array_equal(pm.tip_states, pm0.tip_states)))
        same_wgt = (pm.wgt is pm0.wgt or np.array_equal(pm.wgt, pm0.wgt))
        same_model = (pm.model is pm0.model
                      or (np.array_equal(pm.model.pi, pm0.model.pi)
                          and np.array_equal(pm.model.eigenvalues,
                                             pm0.model.eigenvalues)
                          and np.array_equal(pm.model.u, pm0.model.u)))
        if (not same_aln or not same_wgt or not same_model
                or not np.array_equal(pm.rates, pm0.rates)
                or not np.array_equal(pm.rate_weights, pm0.rate_weights)):
            raise ValueError(
                "batch scoring needs identical alignment/weights/model/"
                "rates across candidates (only topology and branch "
                "lengths may differ); build candidates with "
                "share_device_from")


def batch_fits(pms) -> bool:
    """Whether one batched launch of the models' fused kernel (2 or 2m)
    takes the whole batch: :meth:`PhyloModel.can_fuse` at the batch's
    largest arena.  False under ``Backend.TORCH``."""
    return pms[0].can_fuse(max(pm.fused_slots for pm in pms))


def _operator_table(pms):
    """The batch's operator table: ``(ids, lcs, rcs, planes)`` with
    ``ids[b]`` ``(E,)`` the table row of each original edge of model
    ``b``, ``lcs``/``rcs`` ``(P, S*C, S)`` the batch's distinct (left,
    right) branch-length pairs, encoded once each from the models' shared
    operator cache, and ``planes`` their operator planes for a
    matrix-form model (None otherwise)."""
    pm0 = pms[0]
    E = len(pm0.schedule)
    pair_of: Dict[tuple, int] = {}
    left, right, ids = [], [], []
    for pm in pms:
        row = np.empty(E, np.int32)
        for e, (_p, _l, _r, tl, tr) in enumerate(pm.schedule):
            key = (float(tl), float(tr))
            k = pair_of.get(key)
            if k is None:
                k = pair_of[key] = len(left)
                left.append(pm._branch_cache[key[0]])
                right.append(pm._branch_cache[key[1]])
            row[e] = k
        ids.append(row)
    dev = pm0.device
    lcs = torch.as_tensor(np.stack(left), device=dev)
    rcs = torch.as_tensor(np.stack(right), device=dev)
    planes = None
    if pm0._matrix_form:
        hi, lo = operator_planes(torch.cat([lcs, rcs]),
                                 pm0.config.resolved_kernel_variant)
        P = len(left)
        planes = (hi[:P], lo[:P], hi[P:], lo[P:], pm0.ec_planes[0],
                  pm0.ec_planes[1])
    return ids, lcs, rcs, planes


def batch_inputs(pms):
    """The batched launch's inputs for same-alignment models ``pms``:
    ``(progs, lcs, rcs, planes, n_slots)`` on ``pms[0]``'s device.

    ``progs`` ``(B, 6, E)`` int32 holds each candidate's program (kernel
    2's carried program, or kernel 2m's register schedule) with its
    ``eidx`` row renumbered into the operator table ``lcs``/``rcs``
    ``(P, S*C, S)``: the batch's distinct (left, right) branch-length
    pairs, encoded once each from the models' shared operator cache (NNI
    and SPR candidates carry their lengths with their subtrees, so P stays
    near E plus a few pairs a candidate).  ``planes``: the table's
    operator planes for kernel 2m (None for kernel 2); ``n_slots``: the
    largest arena.
    """
    ids, lcs, rcs, planes = _operator_table(pms)
    E = len(pms[0].schedule)
    progs = np.empty((len(pms), 6, E), np.int32)
    for b, pm in enumerate(pms):
        progs[b] = pm._sched_np if pm._matrix_form else pm._carry_np
        progs[b, 5] = ids[b][progs[b, 5]]
    n_slots = max(pm.fused_slots for pm in pms)
    return (torch.as_tensor(progs, device=pms[0].device), lcs, rcs, planes,
            n_slots)


def _check_batch(pms, name: str) -> None:
    """The batch scorers' checks: same-shape models over one alignment,
    no ascertainment correction, a kernel backend (ValueError naming the
    reason)."""
    pm0 = pms[0]
    cfg = pm0.config
    n_leaves = pm0.tree.n_leaves
    E = len(pm0.schedule)
    for pm in pms[1:]:
        if (len(pm.schedule) != E or pm.tree.n_leaves != n_leaves
                or pm.n_pad != pm0.n_pad or pm.config != cfg):
            raise ValueError(f"{name} needs same-shape models")
    _validate_batch_identity(pms)
    if pm0.ascertainment is not None:
        raise ValueError("ascertainment not supported in the batch path")
    pm0._kernel_path("batch")


def batch_log_likelihood(pms) -> np.ndarray:
    """Score many same-shape topologies in ONE launch.

    ``pms``: PhyloModels sharing alignment, model, config and node count
    (the tree-search neighbourhood case: NNI/SPR preserve all of these;
    build them with ``share_device_from``).  On the card one launch of
    kernel 2 (or 2m) with a candidate axis scores every candidate
    (``ops/plf_tree.py::plf_tree_batch``); on the CPU its plain version
    runs candidate by candidate.  The batch fits where
    :meth:`PhyloModel.can_fuse` holds at the batch's largest arena
    (:func:`batch_fits`); else ValueError ("does not fit").

    Returns (B,) float64 log-likelihoods (fp32 partial sums over chunks of
    ``config.block_sites`` sites, host fp64 final reduction: the JAX
    package's precision policy, within ~1e-6 of ``log_likelihood()``).
    """
    pm0 = pms[0]
    cfg = pm0.config
    _check_batch(pms, "batch_log_likelihood")
    if not batch_fits(pms):
        slots = max(pm.fused_slots for pm in pms)
        raise ValueError(
            f"batch_log_likelihood: a {slots}-slot arena of {cfg.rows} rows "
            f"does not fit the fused kernel's shared memory; score "
            f"candidates individually")
    progs, lcs, rcs, planes, n_slots = batch_inputs(pms)
    parts = batched_tree_loglik_parts(
        pm0.codes, progs, lcs, rcs, pm0.ec, pm0.fused_tip_table,
        pm0.root_rows[0], pm0.wgt_pad.to(torch.float32), pm0.n_sites,
        n_slots=n_slots, states=cfg.states, categories=cfg.categories,
        variant=cfg.resolved_kernel_variant, planes=planes,
        n_parts=pm0.n_pad // cfg.block_sites)
    return parts.cpu().numpy().astype(np.float64).sum(axis=1)


def batch_log_likelihood_segmented(pms) -> np.ndarray:
    """Score many same-shape topologies on the segmented engine: kernel 7
    (or 7m) with a candidate axis (``ops/plf_tree_seg.py::
    plf_tree_seg_batch``), the scorer for a neighbourhood whose batch
    misses the fused kernel's arena.

    ``pms``: PhyloModels sharing alignment, model, config and node count
    (build them with ``share_device_from``).  Each candidate's plan and
    program are its own ``log_likelihood(method="segmented")``'s
    (``_segmented_inputs``), stacked to one shape
    (``ops/plf_tree_seg.py::stack_programs``) over one operator table of
    the batch's distinct length pairs; boundaries are stored in the
    config's ``dtype``.  On the card one launch per chunk of candidates
    whose boundary buffers fit ``ops/plf_tree_seg.py::
    SEG_BATCH_BBUF_BYTES``; on the CPU the plain
    version, candidate by candidate.  Raises ValueError for models of
    different shapes or alignments, an ascertainment correction, or
    ``Backend.TORCH``.

    Returns (B,) float64 log-likelihoods (fp32 partial sums over chunks of
    ``config.block_sites`` sites, host fp64 final reduction, as
    :func:`batch_log_likelihood`; within ~1e-6 of ``log_likelihood()``).
    """
    pm0 = pms[0]
    cfg = pm0.config
    _check_batch(pms, "batch_log_likelihood_segmented")
    progs, segs, lcs, rcs, planes, n_slots, n_bnd = \
        segmented_batch_inputs(pms)
    parts = batched_seg_loglik_parts(
        pm0.codes, progs, segs, lcs, rcs, pm0.ec, pm0.fused_tip_table,
        pm0.root_rows[0], pm0.wgt_pad.to(torch.float32), pm0.n_sites,
        n_parts=pm0.n_pad // cfg.block_sites, n_boundaries=n_bnd,
        n_slots=n_slots, states=cfg.states, categories=cfg.categories,
        variant=cfg.resolved_kernel_variant, planes=planes,
        dtype=getattr(torch, cfg.dtype))
    return parts.cpu().numpy().astype(np.float64).sum(axis=1)


def segmented_batch_inputs(pms):
    """The batched segmented launch's inputs for same-alignment models
    ``pms``: ``(progs, segs, lcs, rcs, planes, n_slots, n_boundaries)`` on
    ``pms[0]``'s device, each candidate's own segment program (kernel 7's
    carried program, or kernel 7m's register-allocated one, from its
    ``_segmented_inputs``) with its edge row renumbered into the operator
    table of :func:`batch_inputs`, stacked by
    ``ops/plf_tree_seg.py::stack_programs``."""
    ids, lcs, rcs, planes = _operator_table(pms)
    programs = []
    for b, pm in enumerate(pms):
        plan = pm._segmented_inputs()[0]
        prog, segs, n_slots = pm._seg_np
        prog = prog.copy()
        prog[5] = ids[b][prog[5]]
        programs.append((prog, segs, n_slots, plan.n_boundaries))
    progs, segs, n_slots, n_bnd = stack_programs(programs)
    dev = pms[0].device
    return (torch.as_tensor(progs, device=dev),
            torch.as_tensor(segs, device=dev), lcs, rcs, planes, n_slots,
            n_bnd)
