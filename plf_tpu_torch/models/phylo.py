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
trees too big for one arena.

``auto`` takes the fused path whenever the GPU capacity rule of the
model's kernel (``ops/plf_tree.py::tree_block_threads`` or
``tree_mxu_fits``) admits the tree, then the segmented path
(:meth:`PhyloModel.can_segment`), then per-node.  The log and the sum
over sites run on the host in float64.

``config.backend`` is the user's choice of compute path, as in the JAX
package: ``Backend.KERNEL`` (the default) runs the routes above;
``Backend.TORCH`` runs the plain site-major PLF of ``ops/plf_torch.py``
node by node (``can_fuse`` and ``can_segment`` are False and no kernel
wrapper is called), on whatever device the model lives, the card
included.

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
from ..io.alignment import AMBIGUITY, map_tip_codes, tip_expansion_table
from ..ops import layout as L
from ..ops.plf_mxu import operator_planes, round_tip_table, uses_mxu_kernels
from ..ops.plf_node import plf_node
from ..ops.plf_torch import plf_torch
from ..ops.plf_tree import (compile_register_schedule, plf_tree,
                            reorder_schedule, root_reduce,
                            tree_block_threads, tree_mxu_fits)
from ..ops.plf_tree_seg import plan_segments, plf_tree_seg, segment_program
from .substitution import (SubstitutionModel, branch_matrices,
                           discrete_gamma_rates, gamma_invariant_rates)
from .tree import Tree

__all__ = ["PhyloModel", "TreeLikelihoodResult"]

LOG_MINLIK = float(np.log(np.float64(2.0) ** -32))

#: Site-likelihood floor before the log (a normal fp32 value, as in the
#: JAX package; exact paths never go below it).
LIK_FLOOR = 1.1754944e-38


@dataclasses.dataclass
class TreeLikelihoodResult:
    log_likelihood: float
    site_log_likelihood: np.ndarray   # (n_sites,) float64, pre-weighting
    scaler_total: int                 # wgt-weighted rescale count
    root_clv: Optional[torch.Tensor] = None  # lane-major root CLV (if kept)
    scaler_sites: Optional[np.ndarray] = None  # (n_sites,) per-site counts


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
        cfg.check_ported()
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
        device = torch.device(device)

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
            codes = codes.astype(np.int8 if cfg.tip_dtype == "int8"
                                 else np.int32)
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
        self.register_buffer("sched", torch.as_tensor(np.stack(arrs),
                                                      device=device))
        self._seg_cache = None

    @property
    def device(self) -> torch.device:
        return self.codes.device

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

    def can_fuse(self) -> bool:
        """Whether the tree's register-machine arena fits one block's
        shared memory (the capacity rule of the model's tree kernel,
        ops/plf_tree.py); False under ``Backend.TORCH``."""
        cfg = self.config
        if cfg.backend is Backend.TORCH:
            return False
        n_codes = self.tip_table.shape[1]
        if uses_mxu_kernels(cfg.resolved_kernel_variant, cfg.states):
            return tree_mxu_fits(self.n_slots, cfg.rows, n_codes)
        return tree_block_threads(self.n_slots, cfg.rows, n_codes,
                                  cfg.states) is not None

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
            variant=cfg.resolved_kernel_variant, planes=self._planes())
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
        register-allocated program on the model's device."""
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
        return self._seg_cache

    def log_likelihood_segmented(self) -> TreeLikelihoodResult:
        """Segmented whole-tree evaluation (kernel 7 or 7m, one launch):
        the tree's subtrees in order, their roots through a boundary
        buffer.  Bit-equal to the fused path (and, in the "vpu" form, to
        the per-node path)."""
        cfg = self.config
        plan, prog, segs, n_slots = self._segmented_inputs()
        lik, sc, _ = plf_tree_seg(
            self.codes, prog, segs, self.lcs, self.rcs, self.ec,
            self.fused_tip_table, self.root_rows[0], self.n_sites,
            n_boundaries=plan.n_boundaries, n_slots=n_slots,
            states=cfg.states, categories=cfg.categories,
            variant=cfg.resolved_kernel_variant, planes=self._planes())
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

    def log_likelihood_sharded(self, *args, **kwargs):
        """Site-sharded evaluation over several cards: not ported yet."""
        raise NotImplementedError(
            "multi-device site sharding is not ported yet: ROADMAP.md, "
            "Queue 1 item 8")

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
