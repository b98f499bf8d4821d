"""One rank of the port's multi-rank site-sharding tests.

Launched by tests/test_torch_parallel.py as
``python tests/torch_shard_worker.py <rank> <world> <init file> <out>``:
joins a gloo group of ``world`` CPU ranks through a ``file://`` store
(``parallel.initialize_distributed``), runs every sharded path of the
port on its shard of the sites and writes what it computed to ``<out>``
as JSON.  It imports ``plf_tpu_torch`` and nothing of the JAX package;
the test makes the same cases for the JAX package from the case functions
below (NumPy and seeds only).
"""

import json
import sys

import numpy as np

BLOCK = 128
#: Sites of the cases: 768 padded at 2 and at 3 ranks, whose last shard
#: holds 136 valid sites of 384 and 8 of 256.
N_SITES = 520
DNA_TAXA, PROT_TAXA, PART_TAXA = 20, 5, 6


def node_case():
    """Kernel 1's inputs: two (n, 4, 4) children, every 4th site of x1
    scaled by 1e-12 (it rescales), branches, EV and weights."""
    rng = np.random.default_rng(80)
    x1 = rng.random((N_SITES, 4, 4), dtype=np.float32)
    x2 = rng.random((N_SITES, 4, 4), dtype=np.float32)
    x1[::4] *= np.float32(1e-12)
    left, right = (rng.random((4, 4, 4), dtype=np.float32)
                   for _ in range(2))
    ev = rng.random((4, 4), dtype=np.float32)
    wgt = rng.integers(1, 6, size=N_SITES).astype(np.int32)
    return x1, x2, left, right, ev, wgt


def tips(taxa, states, seed, n=N_SITES):
    return np.random.default_rng(seed).integers(0, states, size=(taxa, n))


def partitions():
    """(sites, model name, alpha, scale) of two interleaved partitions,
    tests/test_partition.py's models: HKY85 k=2 with frequencies
    (0.3, 0.2, 0.3, 0.2) + G4 a=0.5, and JC69 with a 1.5 multiplier."""
    sites = np.arange(N_SITES)
    return [(sites[sites % 2 == 0], "hky", 0.5, 1.0),
            (sites[sites % 2 == 1], "jc", None, 1.5)]


def main():
    rank, world, init, out = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from plf_tpu_torch import PLFConfig
    from plf_tpu_torch.models import (Partition, PartitionedModel,
                                      PhyloModel, empirical_protein, hky85,
                                      jc69, random_tree)
    from plf_tpu_torch.models.optimize import tree_loglik_fn
    from plf_tpu_torch.parallel import (ShardedPLF, global_site_mesh,
                                        initialize_distributed, make_mesh,
                                        process_summary,
                                        validate_site_workload)

    assert initialize_distributed(f"file://{init}", world, rank,
                                  device="cpu")
    mesh = global_site_mesh(device="cpu")
    assert (mesh.size, mesh.rank, mesh.backend) == (world, rank, "gloo")
    res = dict(rank=rank, world=world, summary=process_summary())
    validate_site_workload(mesh, N_SITES, BLOCK)

    # kernel 1 on the shard, the increment all-reduced
    x1, x2, left, right, ev, wgt = node_case()
    sp = ShardedPLF(mesh, block_sites=BLOCK)
    lc, rc, ec = sp.constants(left, right, ev)
    x3, sc, inc = sp(sp.prepare(x1, N_SITES), sp.prepare(x2, N_SITES), lc,
                     rc, ec, sp.prepare_weights(wgt, N_SITES), N_SITES)
    res["plf"] = dict(x3=x3.numpy().tolist(), sc=sc[0].numpy().tolist(),
                      inc=int(inc), padded=sp.padded_sites(N_SITES))

    cfg = PLFConfig(block_sites=BLOCK)
    dna_tree = random_tree(DNA_TAXA, seed=81)
    models = dict(
        dna=PhyloModel(dna_tree, hky85(2.0), tips(DNA_TAXA, 4, 82),
                       alpha=0.5, config=cfg, device="cpu"),
        lewis=PhyloModel(dna_tree, hky85(2.0), tips(DNA_TAXA, 4, 82),
                         alpha=0.5, config=cfg, ascertainment="lewis",
                         device="cpu"),
        protein=PhyloModel(random_tree(PROT_TAXA, seed=83),
                           empirical_protein("lg"),
                           tips(PROT_TAXA, 20, 84, n=N_SITES - 40),
                           alpha=0.5,
                           config=PLFConfig(states=20, block_sites=BLOCK,
                                            kernel_variant="mxu"),
                           device="cpu"))
    for name, pm in models.items():
        r = pm.log_likelihood_sharded(mesh)
        res[name] = dict(ll=r.log_likelihood, scaler_total=r.scaler_total,
                         site_ll=r.site_log_likelihood.tolist(),
                         lo=pm.site_shard(mesh)[2])

    # training steps on the shard: value and gradient, all-reduced
    for backend in ("tree", "segmented"):
        fn, t0 = tree_loglik_fn(models["dna"], backend=backend, mesh=mesh)
        t = torch.tensor(t0, requires_grad=True)
        v = fn(t)
        v.backward()
        res[backend] = dict(value=float(v), grad=t.grad.numpy().tolist(),
                            engine=fn.engine)

    ptree = random_tree(PART_TAXA, seed=85, mean_branch=0.2)
    mods = dict(hky=hky85(2.0, [0.3, 0.2, 0.3, 0.2]), jc=jc69())
    parts = [Partition(f"p{i}", s, mods[m], alpha=a, scale=k)
             for i, (s, m, a, k) in enumerate(partitions())]
    pmod = PartitionedModel(ptree, parts, tips(PART_TAXA, 4, 86),
                            config=cfg, device="cpu")
    pr = pmod.log_likelihood_sharded(mesh)
    fn, t0, _ = pmod.loglik_fn(mesh=mesh)
    t = torch.tensor(t0, requires_grad=True)
    ls = torch.zeros(2, requires_grad=True)
    v = fn(t, ls)
    v.backward()
    res["partition"] = dict(
        ll=pr.log_likelihood, value=float(v), grad_t=t.grad.tolist(),
        grad_s=ls.grad.tolist(),
        scalers=[p.scaler_total for p in pr.per_partition])

    refusals = []
    for n, block in ((127 * world, BLOCK), (N_SITES, 100)):
        try:
            validate_site_workload(mesh, n, block)
            refusals.append(None)
        except ValueError as e:
            refusals.append(str(e))
    sub = dist.new_group([0])
    if rank:
        try:
            validate_site_workload(make_mesh(device="cpu", group=sub),
                                   N_SITES, BLOCK)
            refusals.append(None)
        except ValueError as e:
            refusals.append(str(e))
    res["refusals"] = refusals
    with open(out, "w") as f:
        json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
