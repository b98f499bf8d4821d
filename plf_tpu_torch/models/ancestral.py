"""Marginal ancestral state reconstruction (RAxML -f A parity) and
per-site rates.

Counterpart of ``plf_tpu/models/ancestral.py``, in torch.  Given a
PhyloModel (tree + substitution model + alignment), compute for every
internal node the marginal posterior probability of each state at each
site:

    P(state_v = s | data) ∝ sum_c  w_c down_vc(s) * up_vc(s)

where ``up`` is the usual conditional likelihood of the subtree below
``v`` (Felsenstein pruning — what the PLF computes) and ``down`` is the
complementary likelihood of everything outside that subtree, obtained by
a root-to-tips pass.  Rate categories are integrated with their mixture
weights ``pm.rate_weights``.

This runs in STATE space with explicit per-category P matrices on
``pm.device``, outside any kernel, as the JAX package runs it outside
any Pallas kernel.  Its (n, C, S) x (C, S, S) contractions are written
as broadcast products summed over the state axis: elementwise fp32 on
any device, where a matmul on the card would go through cuBLAS and so
through whatever TF32 setting a caller left behind
(``torch.backends.cuda.matmul``).  The JAX package asks for
``Precision.HIGHEST``; this is that, independent of global state.
Sites run in chunks so that a product's temporary stays near
``_CHUNK_ELEMENTS`` floats.  Per-node per-site max-normalisation keeps
everything in fp32 range (posteriors are scale invariant).

:func:`site_rates` reads the per-category root likelihoods of the
per-node traversal (on the card kernel 1 at S=4, kernel 1m otherwise,
one launch per internal node) and finishes in float64 on the host.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..io.alignment import AMBIGUITY
from .phylo import PhyloModel

__all__ = ["ancestral_marginal", "site_rates", "ancestral_bruteforce"]

#: Sites per chunk are chosen so that one (sites, C, S, S) product holds
#: at most this many floats (64 MiB).
_CHUNK_ELEMENTS = 1 << 24


def _p_matrices(pm: PhyloModel) -> Dict[int, np.ndarray]:
    """(node -> (C, S, S) transition matrices P[c, from, to])."""
    out = {}
    for node in pm.tree.nodes:
        if node.index == pm.tree.root:
            continue
        out[node.index] = np.stack(
            [pm.model.p_matrix(node.length, r) for r in pm.rates]
        ).astype(np.float32)
    return out


def _tip_states_onehot(si: np.ndarray, S: int) -> np.ndarray:
    """(n, S) one-/multi-hot tip rows: plain states one-hot, IUPAC
    partial ambiguity -> its member states, gaps and unknown codes all
    ones."""
    n = si.shape[0]
    amb = AMBIGUITY.get(S, ())
    onehot = np.zeros((n, S), np.float32)
    valid = (si >= 0) & (si < S)
    onehot[np.arange(n)[valid], si[valid]] = 1.0
    for k, members in enumerate(amb):
        for m in members:
            onehot[si == S + k, m] = 1.0
    onehot[(si < 0) | (si >= S + len(amb))] = 1.0
    return onehot


def _norm(x: torch.Tensor) -> torch.Tensor:
    """Per-site max-normalisation (scale invariant downstream)."""
    m = torch.amax(x, dim=(1, 2), keepdim=True)
    return x / torch.clamp_min(m, 1e-30)


def _msg_up(child_up: torch.Tensor, P: torch.Tensor) -> torch.Tensor:
    """Message child -> parent, (n, C, S_parent): sum over the child
    state s of up[n, c, s] * P[c, u, s]."""
    return (child_up[:, :, None, :] * P[None]).sum(dim=3)


def _push_down(outer: torch.Tensor, P: torch.Tensor) -> torch.Tensor:
    """Outside likelihood through a branch, (n, C, S_child): sum over the
    parent state u of outer[n, c, u] * P[c, u, s]."""
    return (outer[:, :, :, None] * P[None]).sum(dim=2)


def _posteriors(tips, pdev, pi, weights, schedule, root, n_leaves):
    """The two passes on one chunk of sites; tips (leaf -> (n, C, S))."""
    n, C, S = tips[0].shape
    up = dict(tips)
    msgs = {}
    for parent, l, r in schedule:
        ml = _msg_up(up[l], pdev[l])
        mr = _msg_up(up[r], pdev[r])
        msgs[l], msgs[r] = ml, mr
        up[parent] = _norm(ml * mr)

    down = {root: pi[None, None, :].expand(n, C, S)}
    posts = {}
    # parent-before-child order = reversed post-order
    for parent, l, r in reversed(schedule):
        base = down[parent]
        for v, sib_msg in ((l, msgs[r]), (r, msgs[l])):
            # outside-likelihood at v's parent, excluding v's subtree,
            # pushed through v's branch
            down[v] = _norm(_push_down(base * sib_msg, pdev[v]))
        if parent >= n_leaves:
            # Integrate categories with their mixture weights (uniform
            # 1/C cancels in the normalisation; +I / explicit
            # rate_weights do not).
            joint = (down[parent] * up[parent]
                     * weights[None, :, None]).sum(dim=1)
            posts[parent] = joint / joint.sum(dim=1, keepdim=True)
    return posts


def ancestral_marginal(pm: PhyloModel) -> Dict[int, np.ndarray]:
    """Posterior state probabilities at every internal node.

    Returns ``{node_index: (n_sites, S) float32}`` with rows summing to
    1 (sites are the observed sites; ascertainment dummy columns are
    excluded).  Leaf nodes are omitted (their states are the data).
    """
    S = pm.model.states
    C = pm.config.categories
    n_obs = pm.n_sites_obs
    dev = pm.device
    schedule = [(p, l, r) for (p, l, r, _, _) in pm.schedule]
    n_leaves = pm.tree.n_leaves
    # one upload of every branch's P matrices and of the tips (a chunk at
    # a time), one download of the posteriors a chunk: the small copies
    # per node would otherwise set the pace
    pmats = _p_matrices(pm)
    pdev = dict(zip(pmats, torch.as_tensor(np.stack(list(pmats.values())),
                                           device=dev)))
    pi = torch.as_tensor(pm.model.pi.astype(np.float32), device=dev)
    weights = torch.as_tensor(np.asarray(pm.rate_weights, np.float32),
                              device=dev)
    onehot = np.stack([_tip_states_onehot(pm.tip_states[leaf, :n_obs], S)
                       for leaf in range(n_leaves)])      # (leaves, n, S)

    chunk = max(1, _CHUNK_ELEMENTS // (C * S * S))
    parts = []
    for lo in range(0, n_obs, chunk):
        hi = min(n_obs, lo + chunk)
        rows = torch.as_tensor(onehot[:, lo:hi], device=dev)
        tips = {leaf: rows[leaf][:, None, :].expand(hi - lo, C, S)
                for leaf in range(n_leaves)}
        posts = _posteriors(tips, pdev, pi, weights, schedule,
                            pm.tree.root, n_leaves)
        parts.append((list(posts),
                      torch.stack(list(posts.values())).cpu().numpy()))
    nodes = parts[0][0]
    whole = np.concatenate([p for _, p in parts], axis=1)
    return {k: whole[i] for i, k in enumerate(nodes)}


def site_rates(pm: PhyloModel):
    """Per-site posterior rates (RAxML per-site rate / CAT output).

    Returns ``(mean_rate, cat_posterior)``: the posterior-mean
    substitution rate per observed site,

        E[r | site] = sum_c w_c r_c L_c(site) / sum_c w_c L_c(site),

    and the (n_sites, C) per-category posterior.  The per-category site
    likelihoods come from the root CLV of the per-node traversal (kernel
    1 or 1m on the card; rescaling factors are shared across categories
    at a site, so they cancel in the ratio).
    """
    res = pm.log_likelihood(keep_root_clv=True, method="per-node")
    S, C = pm.config.states, pm.config.categories
    # (S*C, n_pad), rows a*C+c
    x_root = res.root_clv.cpu().numpy().astype(np.float64)
    n = pm.n_sites_obs
    rv = np.asarray(pm.model.root_vector, np.float64)  # (S,)
    # L_c(site) = sum_a rv[a] * x_root[a*C + c, site]
    lik_cs = np.einsum("a,acn->cn", rv,
                       x_root[:, :n].reshape(S, C, n))        # (C, n)
    w = np.asarray(pm.rate_weights, np.float64)[:, None]       # (C, 1)
    post = w * lik_cs                                          # (C, n)
    post = post / np.maximum(post.sum(axis=0, keepdims=True), 1e-300)
    mean_rate = np.asarray(pm.rates, np.float64) @ post        # (n,)
    return mean_rate, post.T.astype(np.float64)


def ancestral_bruteforce(pm: PhyloModel, n_sites=None):
    """Float64 oracle (tests): the same two passes in numpy on the host,
    unnormalised, over the first ``n_sites`` observed sites (all of them
    by default or where there are fewer).  Returns ``(posteriors, lik)``: ``{node: (n, S)}`` as
    :func:`ancestral_marginal` and the ``(n, C)`` per-category site
    likelihoods that :func:`site_rates` weighs."""
    S, C = pm.model.states, pm.config.categories
    n = pm.n_sites_obs if n_sites is None else min(int(n_sites),
                                                   pm.n_sites_obs)
    root, n_leaves = pm.tree.root, pm.tree.n_leaves
    schedule = [(p, l, r) for (p, l, r, _, _) in pm.schedule]
    P = {nd.index: np.stack([pm.model.p_matrix(nd.length, r)
                             for r in pm.rates]).astype(np.float64)
         for nd in pm.tree.nodes if nd.index != root}
    up = {leaf: np.repeat(_tip_states_onehot(pm.tip_states[leaf, :n], S)
                          .astype(np.float64)[:, None, :], C, axis=1)
          for leaf in range(n_leaves)}
    msgs = {}
    for parent, l, r in schedule:
        for v in (l, r):
            msgs[v] = np.einsum("ncs,cus->ncu", up[v], P[v])
        up[parent] = msgs[l] * msgs[r]
    pi = np.asarray(pm.model.pi, np.float64)
    w = np.asarray(pm.rate_weights, np.float64)
    down = {root: np.broadcast_to(pi, (n, C, S))}
    posts = {}
    for parent, l, r in reversed(schedule):
        for v, sib in ((l, r), (r, l)):
            down[v] = np.einsum("ncu,cus->ncs", down[parent] * msgs[sib],
                                P[v])
        joint = np.einsum("ncs,c->ns", down[parent] * up[parent], w)
        posts[parent] = joint / joint.sum(axis=1, keepdims=True)
    lik = np.einsum("s,ncs->nc", pi, up[root])
    return posts, lik
