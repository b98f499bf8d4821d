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
import re
import socket
import subprocess
import sys
import time
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
import __graft_entry_torch__ as G  # noqa: E402
from plf_tpu_torch import __main__ as cli  # noqa: E402
from plf_tpu_torch import devices  # noqa: E402
from plf_tpu_torch import parallel as P  # noqa: E402
from plf_tpu_torch.engine import PLFEngine, plf  # noqa: E402
from plf_tpu_torch.models import distance  # noqa: E402
from plf_tpu_torch.models.consensus import bootstrap_nj_trees  # noqa: E402
from plf_tpu_torch.runtime.executor import StreamingExecutor  # noqa: E402

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


class _FakeCards:
    """``torch.cuda`` with ``n`` cards (``device_count``, ``set_device``,
    ``current_device``, ``Stream``) on a machine named ``host``, and a
    ``torch.distributed`` whose ``rendezvous`` hands out ``store`` (an
    in-memory store that :meth:`post` fills for the other ranks) and whose
    ``init_process_group`` records its call and brings a group up of the
    rank and backend it was given; ``calls`` is their order.  No card is
    pinned by an earlier run."""

    def __init__(self, monkeypatch, n, env, host="a"):
        self.n, self.card, self.calls = n, 0, []
        self.group = None
        self.store = torch.distributed.HashStore()
        for k in ("MASTER_ADDR", "RANK", "WORLD_SIZE", "LOCAL_RANK",
                  "LOCAL_WORLD_SIZE"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, str(v))
        dist = torch.distributed
        monkeypatch.setattr(devices, "_pinned", None, raising=False)
        monkeypatch.setattr(socket, "gethostname", lambda: host)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: self.n)
        monkeypatch.setattr(torch.cuda, "set_device", self.set_device)
        monkeypatch.setattr(torch.cuda, "current_device", lambda: self.card)
        monkeypatch.setattr(torch.cuda, "Stream",
                            lambda device=None: ("stream", device))
        monkeypatch.setattr(dist, "rendezvous", lambda url, rank=-1,
                            world_size=-1, **kw: iter([(self.store, rank,
                                                        world_size)]))
        monkeypatch.setattr(dist, "init_process_group", self.init)
        monkeypatch.setattr(dist, "is_initialized",
                            lambda: self.group is not None)
        monkeypatch.setattr(dist, "get_rank",
                            lambda group=None: self.group[0])
        monkeypatch.setattr(dist, "get_world_size",
                            lambda group=None: self.group[1])
        monkeypatch.setattr(dist, "get_backend",
                            lambda group=None: self.group[2])

    def post(self, hosts, me):
        """The other ranks' posts to the rendezvous store: rank r runs on
        machine ``hosts[r]`` of this one's ``n`` cards, has read every
        post, and ``me`` is this process's rank."""
        for r, host in enumerate(hosts):
            if r != me:
                self.store.set(f"plf_tpu_torch/host/{r}",
                               json.dumps([host, self.n]))
                self.store.set(f"plf_tpu_torch/read/{r}", "1")

    def set_device(self, card):
        self.card = torch.device(card).index if isinstance(
            card, torch.device) else int(card)
        self.calls.append(("set_device", self.card))

    def init(self, backend, init_method=None, world_size=-1, rank=-1,
             **kw):
        self.calls.append(("init_process_group", backend, kw))
        world = int(os.environ.get("WORLD_SIZE", world_size))
        rank = int(os.environ.get("RANK", rank))
        self.group = (rank, world, backend)


def test_nccl_pins_local_rank_card_before_the_group(monkeypatch):
    """Under torchrun on 4 cards, LOCAL_RANK=2 on NCCL: card 2 is the
    current card before the group starts and NCCL is bound to it; after,
    "cuda" is card 2 for the mesh, a model and kernel 1m's plan."""
    from plf_tpu_torch.devices import resolve_device
    from plf_tpu_torch.models import phylo
    from plf_tpu_torch.ops import plf_mxu
    fake = _FakeCards(monkeypatch, 4, dict(
        MASTER_ADDR="localhost", MASTER_PORT=29500, RANK=2, WORLD_SIZE=4,
        LOCAL_RANK=2, LOCAL_WORLD_SIZE=4))
    assert P.initialize_distributed()
    card = torch.device("cuda", 2)
    assert fake.calls == [("set_device", 2), ("init_process_group", "nccl",
                                              dict(device_id=card))]
    assert resolve_device("cuda") == card
    mesh = P.make_mesh()
    assert (mesh.device, mesh.rank, mesh.size) == (card, 2, 4)

    class Resolved(Exception):
        pass

    def stop(device):
        raise Resolved(phylo_resolve(device))
    phylo_resolve = phylo.resolve_device
    monkeypatch.setattr(phylo, "resolve_device", stop)
    with pytest.raises(Resolved) as e:
        PhyloModel(random_tree(4, seed=1), hky85(2.0), W.tips(4, 4, 1),
                   device="cuda")
    assert e.value.args[0] == card
    plans = []
    monkeypatch.setattr(plf_mxu, "_plan", lambda dev, *a: plans.append(dev))
    plf_mxu.node_mxu_plan(20, 4)
    assert plans == [card]


@pytest.mark.parametrize("env", [dict(LOCAL_RANK=4),
                                 dict(LOCAL_RANK=1, LOCAL_WORLD_SIZE=5)])
def test_nccl_refuses_a_rank_past_the_cards(monkeypatch, env):
    """On 4 cards, NCCL with LOCAL_RANK=4 (or 5 ranks on the machine):
    ValueError naming the ranks and the cards, and no group starts."""
    fake = _FakeCards(monkeypatch, 4, dict(
        MASTER_ADDR="localhost", MASTER_PORT=29500, RANK=env["LOCAL_RANK"],
        WORLD_SIZE=5, **env))
    with pytest.raises(ValueError, match=r"5 ranks asked for on 'cuda', "
                       r"but this machine has 4 card\(s\); NCCL takes one "
                       r"card a rank"):
        P.initialize_distributed()
    assert fake.calls == [] and fake.group is None


def test_gloo_ranks_share_the_card(monkeypatch):
    """Gloo on 1 card, rank 1 of 2 (no LOCAL_RANK): card 0 (rank modulo
    the cards), and no NCCL binding."""
    fake = _FakeCards(monkeypatch, 1, {})
    assert P.initialize_distributed("localhost:1", 2, 1, backend="gloo")
    assert fake.calls == [("set_device", 0),
                          ("init_process_group", "gloo", {})]
    assert P.make_mesh().device == torch.device("cuda", 0)


@pytest.mark.parametrize("group", [False, True])
def test_no_card_is_a_runtime_error(monkeypatch, group):
    """No card at all: "cuda" raises RuntimeError, with or without a
    group up (no ZeroDivisionError from a modulo of the cards)."""
    fake = _FakeCards(monkeypatch, 0, {})
    if group:
        fake.group = (1, 2, "gloo")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        P.make_mesh(device="cuda")
    if not group:
        with pytest.raises(RuntimeError, match="no CUDA card"):
            P.initialize_distributed("localhost:1", 2, 1, backend="gloo")
    assert fake.calls == []


def test_model_and_mesh_on_other_devices_refused(monkeypatch):
    """A CPU model with a mesh on cuda:1: ValueError from
    ``log_likelihood_sharded``, ``tree_loglik_fn(mesh=)`` and the
    partitioned model's sharded paths, before any shard is cut."""
    from plf_tpu_torch.models import Partition, PartitionedModel, jc69
    mesh = P.SiteMesh(None, 1, 0, torch.device("cuda", 1))
    tips = W.tips(W.DNA_TAXA, 4, 82)
    tree = random_tree(W.DNA_TAXA, seed=81)
    pm = PhyloModel(tree, hky85(2.0), tips, alpha=0.5,
                    config=PLFConfig(block_sites=BLOCK), device="cpu")
    parts = PartitionedModel(tree, [
        Partition("a", np.arange(0, N, 2), hky85(2.0), alpha=0.5),
        Partition("b", np.arange(1, N, 2), jc69())], tips,
        config=PLFConfig(block_sites=BLOCK), device="cpu")

    def no_shard(mesh):
        raise AssertionError("a shard was cut")
    for m in [pm] + parts.models:
        monkeypatch.setattr(m, "site_shard", no_shard)
    match = r"model is on cpu but the mesh computes on cuda:1"
    for call in (lambda: pm.log_likelihood_sharded(mesh),
                 lambda: tree_loglik_fn(pm, mesh=mesh),
                 lambda: parts.log_likelihood_sharded(mesh),
                 lambda: parts.loglik_fn(mesh=mesh),
                 lambda: parts.optimize(steps=1, mesh=mesh)):
        with pytest.raises(ValueError, match=match):
            call()


def _entry_point_devices(monkeypatch):
    """What "cuda" resolves to for each entry point: ``resolve_device``,
    ``make_mesh``, ``PhyloModel`` (stopped once it resolved),
    ``PLFEngine``, ``StreamingExecutor`` and kernel 1m's plan."""
    from plf_tpu_torch.models import phylo
    from plf_tpu_torch.ops import plf_mxu

    class Resolved(Exception):
        pass

    def stop(device):
        raise Resolved(resolve(device))
    resolve = phylo.resolve_device
    monkeypatch.setattr(phylo, "resolve_device", stop)
    with pytest.raises(Resolved) as e:
        PhyloModel(random_tree(4, seed=1), hky85(2.0), W.tips(4, 4, 1))
    plans = []
    monkeypatch.setattr(plf_mxu, "_plan", lambda dev, *a: plans.append(dev))
    plf_mxu.node_mxu_plan(20, 4)
    return dict(resolve_device=devices.resolve_device("cuda"),
                make_mesh=P.make_mesh().device, PhyloModel=e.value.args[0],
                PLFEngine=PLFEngine().device,
                StreamingExecutor=StreamingExecutor().device,
                node_mxu_plan=plans[0])


@pytest.mark.parametrize("rank,world,card,env", [
    (0, 2, 3, {}), (5, 8, 1, {}),
    (0, 2, 3, dict(LOCAL_RANK=0, LOCAL_WORLD_SIZE=2))])
def test_named_card_is_cuda_after_the_group(monkeypatch, rank, world, card,
                                            env):
    """``initialize_distributed(..., device="cuda:<card>")`` on 4 cards:
    that card is current before the group starts and NCCL is bound to
    it; after, "cuda" is that card for every entry point, whatever the
    rank, ``LOCAL_RANK`` or the count of ranks."""
    fake = _FakeCards(monkeypatch, 4, env)
    dev = torch.device("cuda", card)
    assert P.initialize_distributed("localhost:1", world, rank,
                                    device=f"cuda:{card}")
    assert fake.calls == [("set_device", card), ("init_process_group",
                                                 "nccl", dict(device_id=dev))]
    assert fake.group == (rank, world, "nccl")
    got = _entry_point_devices(monkeypatch)
    assert got == dict.fromkeys(got, dev)


@pytest.mark.parametrize("hosts,rank,card", [
    ("aaaabbbb", 0, 0), ("aaaabbbb", 3, 3), ("aaaabbbb", 5, 1),
    ("aaaabbbb", 7, 3), ("abababab", 5, 2), ("abababab", 6, 3)])
def test_caller_started_rank_pins_its_own_machines_card(monkeypatch, hosts,
                                                         rank, card):
    """README's second route, ``initialize_distributed("host:port", 8,
    rank)`` with no ``LOCAL_RANK``, on two machines of 4 cards (machine
    ``hosts[r]`` runs rank r): the rank pins its index among its own
    machine's ranks, binds NCCL to it and hands the group the rendezvous
    store that carried the count; after, "cuda" is that card for every
    entry point."""
    fake = _FakeCards(monkeypatch, 4, {}, host=hosts[rank])
    fake.post(hosts, rank)
    dev = torch.device("cuda", card)
    assert P.initialize_distributed("a:29500", 8, rank)
    assert fake.calls == [("set_device", card), ("init_process_group", "nccl",
                                                 dict(store=fake.store,
                                                      device_id=dev))]
    assert fake.group == (rank, 8, "nccl")
    got = _entry_point_devices(monkeypatch)
    assert got == dict.fromkeys(got, dev)


@pytest.mark.parametrize("rank", range(9))
def test_caller_started_nccl_refused_by_every_rank(monkeypatch, rank):
    """Five NCCL ranks on machine "a" of 4 cards and four on "b", no
    ``LOCAL_RANK``: every rank raises ValueError before any group starts,
    those of "a" naming their own machine's count and those of "b"
    naming machine "a", so that no rank waits for a refused one."""
    hosts = "ababababa"
    fake = _FakeCards(monkeypatch, 4, {}, host=hosts[rank])
    fake.post(hosts, rank)
    if hosts[rank] == "a":
        match = (f"rank {rank} (card {rank // 2}): 5 ranks asked for on "
                 f"'cuda', but this machine has 4 card(s)")
    else:
        match = (f"rank {rank}: 5 ranks asked for on 'cuda' on machine 'a', "
                 f"but it has 4 card(s)")
    with pytest.raises(ValueError, match=re.escape(match)):
        P.initialize_distributed("a:29500", 9, rank)
    assert fake.calls == [] and fake.group is None


#: One caller-started rank on a machine of ``cards`` fake cards, with no
#: torchrun environment: ``initialize_distributed(url, 2, rank)`` under
#: NCCL, whose group (bound to the card it pinned) comes up over gloo on
#: the CPU; it prints the cards pinned and bound, what "cuda" resolves to
#: and one all-reduce (arguments: repo, url, rank, cards).
CALLER_RANK = """
import json, sys
sys.path.insert(0, sys.argv[1])
import torch, torch.distributed as dist
cards = int(sys.argv[4])
torch.cuda.device_count = lambda: cards
pinned = []
torch.cuda.set_device = pinned.append
init = dist.init_process_group
def on_gloo(backend, device_id=None, **kw):
    pinned.append(device_id)
    init("gloo", **kw)
dist.init_process_group = on_gloo
from plf_tpu_torch.devices import resolve_device
from plf_tpu_torch.parallel import initialize_distributed
initialize_distributed(sys.argv[2], 2, int(sys.argv[3]))
t = torch.ones(1)
dist.all_reduce(t)
print(json.dumps(dict(pinned=[str(d) for d in pinned],
                      cuda=str(resolve_device("cuda")),
                      all_reduce=float(t))))
dist.destroy_process_group()
"""
PAIR_SECONDS = 30


@pytest.mark.parametrize("cards", [1, 2])
@pytest.mark.parametrize("store", ["host:port", "file"])
def test_caller_started_pair_counts_its_machines_cards(tmp_path, store,
                                                         cards):
    """Two caller-started NCCL ranks on one machine, each a process of its
    own (README's second route, no ``LOCAL_RANK``), ending within 30 s
    together.  On one card both exit with the ValueError before any group
    starts, and neither waits at the rendezvous for the other; on two
    cards rank r pins card r, NCCL is bound to it, and the group comes up
    over the store that carried the count."""
    if store == "file":
        url = f"file://{tmp_path / 'store'}"
    else:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            url = f"localhost:{s.getsockname()[1]}"
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                        "LOCAL_RANK", "LOCAL_WORLD_SIZE")}
    env["OMP_NUM_THREADS"] = "1"
    t0 = time.monotonic()
    procs = [subprocess.Popen(
        [sys.executable, "-c", CALLER_RANK, str(REPO), url, str(r),
         str(cards)], cwd=tmp_path, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=PAIR_SECONDS) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    secs = time.monotonic() - t0
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        if cards == 1:
            want = (f"ValueError: rank {r} (card {r}): 2 ranks asked for on "
                    f"'cuda', but this machine has 1 card(s)")
            assert p.returncode == 1 and want in err, err[-3000:]
            assert out == ""
        else:
            assert p.returncode == 0, err[-3000:]
            assert json.loads(out) == dict(pinned=[f"cuda:{r}"] * 2,
                                           cuda=f"cuda:{r}", all_reduce=2.0)
    assert secs < PAIR_SECONDS


def _fasta(tmp):
    path = tmp / "aln.fasta"
    path.write_text("".join(f">t{i}\nACGTACGTAC\n" for i in range(4)))
    return str(path)


_CODES = np.zeros((4, 10), np.int64)

#: Every entry point that takes a ``device`` (default "cuda"), called as a
#: user would: ``(fake, tmp) -> ...``.
NO_CARD_CALLS = {
    "PLFEngine": lambda f, t: PLFEngine(),
    "engine.plf": lambda f, t: plf(*W.node_case()),
    "StreamingExecutor": lambda f, t: StreamingExecutor(),
    "pairwise_mismatch": lambda f, t: distance.pairwise_mismatch(_CODES),
    "jc_distance_matrix": lambda f, t: distance.jc_distance_matrix(_CODES),
    "nj_tree": lambda f, t: distance.nj_tree(_CODES),
    "bootstrap_nj_trees": lambda f, t: bootstrap_nj_trees(_CODES,
                                                          n_replicates=2),
    "cli": lambda f, t: cli.main(["--sites", "1024", "--calls", "1"]),
    "cli infer": lambda f, t: cli.main(["infer", _fasta(t)]),
    "graft entry": lambda f, t: G.entry(),
    "dryrun_multichip": lambda f, t: G.dryrun_multichip(2, backend="gloo"),
    "PhyloModel": lambda f, t: PhyloModel(random_tree(4, seed=1), hky85(2.0),
                                          W.tips(4, 4, 1)),
    "make_mesh": lambda f, t: P.make_mesh(),
    "initialize_distributed": lambda f, t: (
        f.post("aa", 0), P.initialize_distributed("a:1", 2, 0)),
}


@pytest.mark.parametrize("name", list(NO_CARD_CALLS))
def test_every_entry_point_refuses_without_a_card(monkeypatch, tmp_path,
                                                  name):
    """No card: each entry point raises the one RuntimeError of
    ``devices.card_count`` when it is built (or, for a plain function,
    called), naming ``device='cpu'`` and ``--device cpu``; none goes on
    on the CPU.  A caller-started NCCL rank posts its count first, so
    that the other ranks refuse too."""
    fake = _FakeCards(monkeypatch, 0, {})
    with pytest.raises(RuntimeError, match=re.escape(
            "no CUDA card is visible to this process; pass device='cpu' "
            "(--device cpu on the command line)")):
        NO_CARD_CALLS[name](fake, tmp_path)
    assert fake.calls == [] and fake.group is None
