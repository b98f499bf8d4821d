"""The device axis: site sharding over ``torch.distributed``
(``plf_tpu_torch.parallel``, ``PhyloModel.log_likelihood_sharded``,
``tree_loglik_fn(mesh=)``, ``PartitionedModel``'s sharded paths) against
the JAX package's on its virtual CPU devices (``make_mesh(2)`` and
``make_mesh(3)``, tests/conftest.py).

The port runs as 2 and 3 gloo ranks, each a process of its own that
imports only ``plf_tpu_torch`` (tests/torch_shard_worker.py), joined by a
``file://`` store under the test's temporary directory (so that parallel
test workers never share a port), each with a 120 s limit; both world
sizes run at once, and several tests read their results.  The cases'
site count leaves the last shard mostly padding (8 valid sites of 256 at
3 ranks).  A one-rank mesh (no process group) runs in this process.

Tolerances: log-likelihoods within rel 1e-6 (the port sums its partials
in float64, JAX in fp32) and per-site log-likelihoods of each rank's shard
within rel 1e-6 (the protein "mxu" model's within 5e-5 absolute, the bar
tests/test_torch_mxu.py holds JAX's dense fp32 products to); scaler
totals and kernel 1's increment exact, its parent
CLVs within 5e-7 (XLA:CPU contracts JAX's products into FMAs,
tests/test_torch_engine.py's bar); a training step's value within rel
1e-5 and its gradient within rtol 5e-4, atol 1e-4
(tests/test_torch_partition.py's bar between two gradient routes); every
rank's totals and gradients equal; one rank equals the unsharded path
bit for bit."""

import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_batch import _one_torch_thread  # noqa: E402,F401
import torch_shard_worker as W  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import plf_tpu.models as J  # noqa: E402
from plf_tpu.config import PLFConfig as JCfg  # noqa: E402
from plf_tpu.models.optimize import tree_loglik_fn as jtree_fn  # noqa: E402
from plf_tpu.parallel import ShardedPLF as JSharded  # noqa: E402
from plf_tpu.parallel import make_mesh as jmesh  # noqa: E402
from plf_tpu_torch import PLFConfig  # noqa: E402
from plf_tpu_torch.models import (PhyloModel, empirical_protein,  # noqa: E402
                                  hky85, random_tree)
from plf_tpu_torch.models.optimize import tree_loglik_fn  # noqa: E402
from plf_tpu_torch import parallel as P  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
WORLDS = (2, 3)
BLOCK = W.BLOCK
N = W.N_SITES
TIMEOUT = 120


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's JSON, by world size; both worlds run at once."""
    tmp = tmp_path_factory.mktemp("ranks")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = {}
    for k in WORLDS:
        for r in range(k):
            procs[k, r] = subprocess.Popen(
                [sys.executable, str(REPO / "tests" / "torch_shard_worker.py"),
                 str(r), str(k), str(tmp / f"init{k}"),
                 str(tmp / f"out{k}_{r}.json")],
                cwd=tmp, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)
    try:
        for (k, r), p in procs.items():
            _, err = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, f"world {k} rank {r}:\n{err[-3000:]}"
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return {k: [json.loads((tmp / f"out{k}_{r}.json").read_text())
                for r in range(k)] for k in WORLDS}


def _jax_models():
    cfg = JCfg(block_sites=BLOCK, interpret=True)
    tree = J.random_tree(W.DNA_TAXA, seed=81)
    dna_tips = W.tips(W.DNA_TAXA, 4, 82)
    return dict(
        dna=J.PhyloModel(tree, J.hky85(2.0), dna_tips, alpha=0.5, config=cfg),
        lewis=J.PhyloModel(tree, J.hky85(2.0), dna_tips, alpha=0.5,
                           config=cfg, ascertainment="lewis"),
        protein=J.PhyloModel(
            J.random_tree(W.PROT_TAXA, seed=83), J.empirical_protein("lg"),
            W.tips(W.PROT_TAXA, 20, 84, n=N - 40), alpha=0.5,
            config=JCfg(states=20, block_sites=BLOCK, interpret=True,
                        kernel_variant="mxu")))


@functools.cache
def _jax(k):
    """The JAX package's results of every case on ``make_mesh(k)``."""
    mesh = jmesh(k)
    out = {}
    x1, x2, left, right, ev, wgt = W.node_case()
    sp = JSharded(mesh=mesh, block_sites=BLOCK, interpret=True)
    x3, sc, inc = sp(sp.prepare(x1, N), sp.prepare(x2, N),
                     *sp.constants(left, right, ev),
                     sp.prepare_weights(wgt, N), N)
    out["plf"] = dict(x3=np.asarray(x3), sc=np.asarray(sc)[0],
                      inc=int(inc), padded=sp.padded_sites(N))
    models = _jax_models()
    for name, pm in models.items():
        r = pm.log_likelihood_sharded(mesh=mesh)
        out[name] = dict(ll=r.log_likelihood, scaler_total=r.scaler_total,
                         site_ll=np.asarray(r.site_log_likelihood))
    for backend in ("tree", "segmented"):
        fn, t0 = jtree_fn(models["dna"], backend=backend, mesh=mesh)
        v, g = jax.value_and_grad(fn)(jnp.asarray(t0))
        out[backend] = dict(value=float(v), grad=np.asarray(g))
    mods = dict(hky=J.hky85(2.0, [0.3, 0.2, 0.3, 0.2]), jc=J.jc69())
    parts = [J.Partition(f"p{i}", s, mods[m], alpha=a, scale=sc_)
             for i, (s, m, a, sc_) in enumerate(W.partitions())]
    pmod = J.PartitionedModel(
        J.random_tree(W.PART_TAXA, seed=85, mean_branch=0.2), parts,
        W.tips(W.PART_TAXA, 4, 86),
        config=JCfg(block_sites=BLOCK, interpret=True))
    pr = pmod.log_likelihood_sharded(mesh=mesh)
    fn, t0, _ = pmod.loglik_fn(mesh=mesh)
    v, (gt, gs) = jax.value_and_grad(fn, argnums=(0, 1))(jnp.asarray(t0),
                                                         jnp.zeros(2))
    out["partition"] = dict(ll=pr.log_likelihood, value=float(v),
                            grad_t=np.asarray(gt), grad_s=np.asarray(gs),
                            scalers=[p.scaler_total
                                     for p in pr.per_partition])
    return out


@pytest.mark.parametrize("k", WORLDS)
def test_plf_sharded_matches_jax(ranks, k):
    """Kernel 1 on each rank's shard: its parent CLVs and flags are the
    JAX mesh's shard of the same sites, and the increment (all-reduced)
    is JAX's psum exactly."""
    ref = _jax(k)["plf"]
    shard = ref["padded"] // k
    for r, res in enumerate(ranks[k]):
        got = res["plf"]
        assert got["padded"] == ref["padded"] and got["inc"] == ref["inc"]
        lo = r * shard
        np.testing.assert_allclose(np.asarray(got["x3"], np.float32),
                                   ref["x3"][:, lo:lo + shard], rtol=5e-7,
                                   atol=1e-37)
        np.testing.assert_array_equal(got["sc"], ref["sc"][lo:lo + shard])
    assert ref["inc"] > 0


@pytest.mark.parametrize("name", ["dna", "lewis", "protein"])
@pytest.mark.parametrize("k", WORLDS)
def test_log_likelihood_sharded_matches_jax(ranks, k, name):
    """Kernel 2 (2m for the "mxu" protein model) on each rank's shard
    with its count of valid sites: the all-reduced ll and scaler total
    are the JAX mesh's, and each rank's site log-likelihoods are JAX's
    sites of its shard."""
    ref = _jax(k)[name]
    for res in ranks[k]:
        got = res[name]
        assert got["ll"] == pytest.approx(ref["ll"], rel=1e-6)
        assert got["scaler_total"] == ref["scaler_total"]
        lo, site = got["lo"], np.asarray(got["site_ll"])
        want = ref["site_ll"][lo:lo + len(site)]
        if name == "protein":
            np.testing.assert_allclose(site, want, rtol=0, atol=5e-5)
        else:
            np.testing.assert_allclose(site, want, rtol=1e-6)
    assert sum(len(r[name]["site_ll"]) for r in ranks[k]) \
        == len(ref["site_ll"])
    if name == "dna":
        assert ref["scaler_total"] > 0


@pytest.mark.parametrize("backend", ["tree", "segmented"])
@pytest.mark.parametrize("k", WORLDS)
def test_mesh_step_matches_jax(ranks, k, backend):
    """A training step on the mesh (forward and checkpointed backward on
    each shard, the partials all-reduced, the operator-stack gradients
    summed over the ranks) against JAX's shard_map step."""
    ref = _jax(k)[backend]
    for res in ranks[k]:
        got = res[backend]
        assert got["engine"] == backend
        assert got["value"] == pytest.approx(ref["value"], rel=1e-5)
        np.testing.assert_allclose(got["grad"], ref["grad"], rtol=5e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("k", WORLDS)
def test_partition_sharded_matches_jax(ranks, k):
    ref = _jax(k)["partition"]
    for res in ranks[k]:
        got = res["partition"]
        assert got["ll"] == pytest.approx(ref["ll"], rel=1e-6)
        assert got["scalers"] == ref["scalers"]
        assert got["value"] == pytest.approx(ref["value"], rel=1e-5)
        np.testing.assert_allclose(got["grad_t"], ref["grad_t"], rtol=5e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(got["grad_s"], ref["grad_s"], rtol=5e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("k", WORLDS)
def test_ranks_agree(ranks, k):
    """Every rank returns the same totals, values and gradients."""
    first = ranks[k][0]
    for res in ranks[k][1:]:
        for name in ("dna", "lewis", "protein"):
            assert res[name]["ll"] == first[name]["ll"]
            assert res[name]["scaler_total"] == first[name]["scaler_total"]
        for name in ("tree", "segmented"):
            assert res[name] == first[name]
        assert res["partition"] == first["partition"]
        assert res["plf"]["inc"] == first["plf"]["inc"]
    assert first["summary"].startswith(f"process 0/{k}")


@pytest.mark.parametrize("k", WORLDS)
def test_validate_site_workload_refusals(ranks, k):
    """JAX's fail-fast checks: fewer than 128 sites a rank, a block that
    is not a lane multiple, and a process outside the mesh's group."""
    for r, res in enumerate(ranks[k]):
        ref = res["refusals"]
        assert "sites/device" in ref[0] and "lane multiple" in ref[1]
        if r:
            assert "contributes no devices" in ref[2]
        else:
            assert len(ref) == 2


def test_one_rank_mesh_equals_unsharded():
    """A mesh with no process group is one rank: the sharded paths equal
    the unsharded ones, per-site likelihoods and the gradient bit for
    bit, for the DNA (with and without Lewis) and protein cases."""
    mesh = P.make_mesh(device="cpu")
    assert (mesh.size, mesh.rank, mesh.group) == (1, 0, None)
    cfg = PLFConfig(block_sites=BLOCK)
    tree = random_tree(W.DNA_TAXA, seed=81)
    tips = W.tips(W.DNA_TAXA, 4, 82)
    models = [PhyloModel(tree, hky85(2.0), tips, alpha=0.5, config=cfg,
                         ascertainment=a, device="cpu")
              for a in (None, "lewis")]
    models.append(PhyloModel(
        random_tree(W.PROT_TAXA, seed=83), empirical_protein("lg"),
        W.tips(W.PROT_TAXA, 20, 84, n=N - 40), alpha=0.5,
        config=PLFConfig(states=20, block_sites=BLOCK,
                         kernel_variant="mxu"), device="cpu"))
    for pm in models:
        got, want = pm.log_likelihood_sharded(mesh), pm.log_likelihood()
        np.testing.assert_array_equal(got.site_log_likelihood,
                                      want.site_log_likelihood)
        np.testing.assert_array_equal(got.scaler_sites, want.scaler_sites)
        assert got.scaler_total == want.scaler_total
        assert got.log_likelihood == pytest.approx(want.log_likelihood,
                                                   rel=1e-12)
    for backend in ("tree", "segmented"):
        grads = []
        for m in (None, mesh):
            fn, t0 = tree_loglik_fn(models[0], backend=backend, mesh=m)
            t = torch.tensor(t0, requires_grad=True)
            fn(t).backward()
            grads.append(t.grad)
        assert torch.equal(grads[0], grads[1])


def test_padding_policy_and_helpers():
    """The JAX package's padding (``padded_sites``) and per-rank valid
    count (``clip(n - rank*shard, 0, shard)``) for 1-3 ranks; the helpers
    that need no group: ``initialize_distributed`` stays local,
    ``make_mesh`` refuses a device count the group does not have, and a
    one-rank ``plf_sharded`` equals kernel 1 on the whole array."""
    for k in (1, 2, 3):
        for n in (1, 127, 128, 300, 520, 1000, 4097):
            unit = k * BLOCK
            want = max(unit, -(-n // unit) * unit)
            meshes = [P.SiteMesh(None, k, r, torch.device("cpu"))
                      for r in range(k)]
            assert P.padded_sites(meshes[0], n, BLOCK) == want
            for r, m in enumerate(meshes):
                lo, shard, n_local = P.shard_span(m, n, want)
                assert (lo, shard) == (r * want // k, want // k)
                assert n_local == int(np.clip(n - r * shard, 0, shard))
            assert sum(P.shard_span(m, n, want)[2] for m in meshes) == n
        if k in (2, 3):
            assert JSharded(mesh=jmesh(k), block_sites=BLOCK) \
                .padded_sites(N) == P.padded_sites(meshes[0], N, BLOCK)
    assert not P.initialize_distributed(num_processes=1, device="cpu")
    env = {k: os.environ.pop(k) for k in ("MASTER_ADDR",)
           if k in os.environ}
    try:
        assert not P.initialize_distributed(device="cpu")
    finally:
        os.environ.update(env)
    with pytest.raises(ValueError, match="one process runs one rank"):
        P.make_mesh(2, device="cpu")
    mesh = P.make_mesh(device="cpu")
    x1, x2, left, right, ev, wgt = W.node_case()
    sp = P.ShardedPLF(mesh, block_sites=BLOCK)
    lc, rc, ec = sp.constants(left, right, ev)
    x3, sc, inc = sp(sp.prepare(x1, N), sp.prepare(x2, N), lc, rc, ec,
                     sp.prepare_weights(wgt, N), N)
    from plf_tpu_torch.reference import plf_reference
    x3_ref, sv_ref, inc_ref = plf_reference(x1, x2, left, right, ev, wgt)
    from plf_tpu_torch.ops import layout as L
    np.testing.assert_array_equal(L.from_lane_major(x3.numpy(), n=N),
                                  x3_ref)
    assert int(inc) == inc_ref > 0
    P.validate_site_workload(mesh, N, BLOCK)
