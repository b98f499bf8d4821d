"""``__graft_entry_torch__.py``, the port's twin of ``__graft_entry__.py``,
on the CPU against the JAX package.

``entry(device="cpu")`` runs kernel 1's plain version on the JAX twin's
example case (the same arrays, draw for draw): equal to the golden model
bit for bit, and to JAX's ``plf_pallas_lane_major`` in interpret mode
with the scaler flags exact and x3 within rel 5e-7 (XLA:CPU contracts
JAX's products into FMAs; tests/test_torch_parallel.py's bar).

``dryrun_multichip`` runs its ten checks in this process on one rank and
as two gloo ranks in processes of their own (120 s limit each); the
values it returns are held against the JAX package's single-device
values for the same seeded models (interpret mode) with
tests/test_torch_parallel.py's bars: log-likelihoods within rel 1e-6 and
scaler totals exact; a training step's value within rel 1e-5 and its
gradient within rtol 5e-4, atol 1e-4 of JAX's XLA oracle.  The "mxu_3x"
protein and codon models are held to their variant's class on these
inputs, measured here as the JAX package's own distance between its
"mxu_3x" and "mxu" forms of the same model (the sum over sites of their
per-site log-likelihood distances), never to a fixed bar.  The bf16
boundary storage is held to the JAX twin's class, within 5e-3 of the
fp32 log-likelihood."""

import functools
import re
import subprocess
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_batch import _one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import __graft_entry__ as JG  # noqa: E402
import __graft_entry_torch__ as G  # noqa: E402
import plf_tpu.models as J  # noqa: E402
from plf_tpu.config import PLFConfig as JCfg  # noqa: E402
from plf_tpu.models.optimize import tree_loglik_fn as jtree_fn  # noqa: E402
from plf_tpu.models.substitution import codon_gy94, random_gtr  # noqa: E402
from plf_tpu.ops import layout as JL  # noqa: E402
from plf_tpu.ops.plf_pallas import plf_pallas_lane_major  # noqa: E402
from plf_tpu.reference import plf_reference  # noqa: E402
from plf_tpu_torch.ops import layout as L  # noqa: E402

N, BLOCK = G.DRYRUN_SITES, G.DRYRUN_BLOCK
RANKS = (1, 2)
CHECKS = ("plf", "tree", "train", "protein", "int8", "plf_batch",
          "segmented", "partition", "codon", "bf16")


def test_example_case_is_jax_twins():
    for n in (300, 2048):
        for a, b in zip(G._example_case(n), JG._example_case(n)):
            np.testing.assert_array_equal(a, b)


def test_entry_matches_golden_and_jax():
    fn, args = G.entry(device="cpu")
    assert [tuple(a.shape) for a in args[:5]] == [(16, 2048)] * 2 + [
        (16, 4)] * 3 and args[5] == 2048
    x3, sc = fn(*args)
    assert x3.dtype == torch.float32 and sc.dtype == torch.int32
    x1, x2, left, right, ev = G._example_case(2048)
    x3r, svr, _ = plf_reference(x1, x2, left, right, ev)
    np.testing.assert_array_equal(L.from_lane_major(x3.numpy(), n=2048),
                                  x3r)
    np.testing.assert_array_equal(sc[0].numpy(), svr)
    assert int(sc.sum()) == 512
    _, jargs = JG.entry()
    for mine, theirs in zip(args[:5], jargs[:5]):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))
    jx3, jsc = plf_pallas_lane_major(*jargs, states=4, categories=4,
                                     block_sites=512, interpret=True)
    np.testing.assert_array_equal(sc.numpy(), np.asarray(jsc))
    np.testing.assert_allclose(x3.numpy(), np.asarray(jx3), rtol=5e-7,
                               atol=1e-37)


@pytest.fixture(scope="module")
def runs():
    """``dryrun_multichip``'s values by rank count: one rank here, two
    gloo ranks in processes of their own."""
    return {k: G.dryrun_multichip(k, device="cpu", timeout=120)
            for k in RANKS}


def _jgrad(pm, t):
    fn, _ = jtree_fn(pm, backend="xla")
    v, g = jax.value_and_grad(fn)(jnp.asarray(t, jnp.float32))
    return float(v), np.asarray(g)


def _class(pm_3x, pm_fp32):
    """The "mxu_3x" form's distance from the fp32 "mxu" form of the same
    model in the JAX package: the sum over sites of their per-site ll
    distances."""
    a = pm_3x.log_likelihood_fused().site_log_likelihood
    b = pm_fp32.log_likelihood_fused().site_log_likelihood
    return float(np.abs(np.asarray(a, np.float64) - b).sum())


@functools.cache
def _jax():
    """The JAX package's single-device values of the ten checks' models."""
    cfg = JCfg(block_sites=BLOCK, interpret=True)
    out = {}
    x1, x2, left, right, ev = JG._example_case(N)
    n_pad = L.sites_padding(N, BLOCK)
    x3, sc = plf_pallas_lane_major(
        *(jnp.asarray(JL.pad_to_multiple(JL.to_lane_major(x), n_pad))
          for x in (x1, x2)),
        *(jnp.asarray(c) for c in (JL.branch_to_lane_constants(left),
                                   JL.branch_to_lane_constants(right),
                                   JL.ev_to_lane_constants(ev))),
        jnp.int32(N), block_sites=BLOCK, interpret=True)
    rv = np.abs(np.random.default_rng(1).random((1, 16))).astype(np.float32)
    lik = (rv @ np.asarray(x3))[0, :N].astype(np.float64)
    out["plf"] = dict(scaler_inc=int(np.asarray(sc)[0, :N].sum()),
                      ll=float(np.log(np.maximum(lik, 1e-30)).sum()))

    tree = J.random_tree(6, seed=2)
    tips = np.random.default_rng(3).integers(0, 4, size=(6, N))
    pm = J.PhyloModel(tree, J.hky85(2.0), tips, alpha=0.5, config=cfg)
    r = pm.log_likelihood()
    out["tree"] = dict(ll=r.log_likelihood, scaler_total=r.scaler_total)
    out["train_pm"] = pm
    out["int8"] = J.PhyloModel(
        tree, J.hky85(2.0), tips, alpha=0.5,
        config=JCfg(block_sites=BLOCK, interpret=True, tip_dtype="int8")
    ).log_likelihood()

    for name, model, taxa, seed, states, n, alpha in (
            ("protein", random_gtr(20, 6), 5, 6, 20, N, 0.5),
            ("codon", codon_gy94(2.0, 0.3), 4, 11, 61, 160, 0.6)):
        tips_x = np.random.default_rng(seed).integers(0, states,
                                                      size=(taxa, n))
        pms = {v: J.PhyloModel(J.random_tree(taxa, seed=seed), model,
                               tips_x, alpha=alpha,
                               config=JCfg(states=states, block_sites=BLOCK,
                                           interpret=True,
                                           kernel_variant=v))
               for v in ("mxu_3x", "mxu")}
        r = pms["mxu_3x"].log_likelihood_fused()
        out[name] = dict(ll=r.log_likelihood, scaler_total=r.scaler_total,
                         bar=_class(pms["mxu_3x"], pms["mxu"]))

    rngb = np.random.default_rng(8)
    bx1 = rngb.random((3, 160, 16), dtype=np.float32)
    bx2 = rngb.random((3, 160, 16), dtype=np.float32)
    bl = rngb.random((3, 4, 4, 4), dtype=np.float32)
    br = rngb.random((3, 4, 4, 4), dtype=np.float32)
    bev = rngb.random((3, 4, 4), dtype=np.float32)
    out["plf_batch"] = [int(plf_reference(bx1[i], bx2[i], bl[i], br[i],
                                          bev[i])[2]) for i in range(3)]

    pm_b = J.PhyloModel(J.random_tree(16, seed=4), J.hky85(2.0),
                        np.random.default_rng(5).integers(0, 4,
                                                          size=(16, N)),
                        alpha=0.5, config=cfg)
    out["segmented_pm"] = pm_b

    parts = [J.Partition("g1", np.arange(N // 2), J.hky85(2.0), alpha=0.5),
             J.Partition("g2", np.arange(N // 2, N), J.jc69())]
    out["partition"] = J.PartitionedModel(
        tree, parts, np.random.default_rng(9).integers(0, 4, size=(6, N)),
        config=cfg).log_likelihood().log_likelihood
    return out


def test_dryrun_runs_every_check(runs):
    for k, v in runs.items():
        assert set(v) == set(CHECKS) | {"launches"}
        assert v["launches"] == {}        # the plain versions never count


@pytest.mark.parametrize("k", RANKS)
def test_dryrun_plf_step_matches_jax(runs, k):
    """Kernel 1 on each shard of the padded sites (512 at 2 ranks, as the
    JAX twin pads): the all-reduced increment exact, the masked ll within
    rel 1e-6."""
    got, ref = runs[k]["plf"], _jax()["plf"]
    unit = k * BLOCK
    assert got["x3_shape"] == [16, max(1, -(-N // unit)) * unit]
    assert got["scaler_inc"] == ref["scaler_inc"] > 0
    assert got["ll"] == pytest.approx(ref["ll"], rel=1e-6)


@pytest.mark.parametrize("name", ["tree", "int8"])
@pytest.mark.parametrize("k", RANKS)
def test_dryrun_tree_matches_jax(runs, k, name):
    """Kernel 2 on each shard (int32 and int8 tip codes): the ll within
    rel 1e-6 of JAX's single-device ll, the scaler totals exact."""
    got, jx = runs[k][name], _jax()
    ref = jx["tree"] if name == "tree" else dict(
        ll=jx["int8"].log_likelihood, scaler_total=jx["int8"].scaler_total)
    assert got["ll"] == pytest.approx(ref["ll"], rel=1e-6)
    assert got["scaler_total"] == ref["scaler_total"]
    if name == "tree":
        assert got["ll_single"] == pytest.approx(ref["ll"], rel=1e-6)
        assert got["scaler_total_single"] == ref["scaler_total"]


@pytest.mark.parametrize("k", RANKS)
def test_dryrun_training_step_matches_jax(runs, k):
    """The "tree" mesh step: its value and gradient, and the value after
    the update, against JAX's XLA oracle at the same lengths."""
    got = runs[k]["train"]
    assert got["engine"] == "tree"
    pm = _jax()["train_pm"]
    t0 = jtree_fn(pm, backend="xla")[1]
    v, g = _jgrad(pm, t0)
    assert got["ll0"] == pytest.approx(v, rel=1e-5)
    np.testing.assert_allclose(got["grad"], g, rtol=5e-4, atol=1e-4)
    gp = np.asarray(got["grad"], np.float32)
    t1 = np.maximum(t0 + 1e-3 * gp / (np.abs(gp).max() + 1e-9), 1e-6)
    assert got["ll1"] == pytest.approx(_jgrad(pm, t1)[0], rel=1e-5)
    assert got["ll1"] > got["ll0"]


@pytest.mark.parametrize("name", ["protein", "codon"])
@pytest.mark.parametrize("k", RANKS)
def test_dryrun_mxu_3x_within_its_class(runs, k, name):
    """Kernel 2m in "mxu_3x" (S = 20 and 61), sharded and fused, within
    the variant's class of JAX's "mxu_3x" ll; the scaler totals exact."""
    got, ref = runs[k][name], _jax()[name]
    assert ref["bar"] > 0
    for ll in (got["ll"], got["ll_fused"]):
        assert abs(ll - ref["ll"]) <= ref["bar"], (ll, ref)
    assert got["scaler_total"] == ref["scaler_total"]


@pytest.mark.parametrize("k", RANKS)
def test_dryrun_plf_batch_matches_golden(runs, k):
    """Held bit for bit inside the dry run; the increments are the JAX
    package's golden model's."""
    got = runs[k]["plf_batch"]
    assert (got["instances"], got["sites"]) == (3, 160)
    assert got["scaler_increments"] == _jax()["plf_batch"]


@pytest.mark.parametrize("k", RANKS)
def test_dryrun_segmented_matches_jax(runs, k):
    """Kernels 7 + 8's plain versions under the mesh: the value within rel 1e-5 and the gradient within rtol 5e-4,
    atol 1e-4 of JAX's XLA oracle; the bf16 boundary form within 5e-3 of
    the fp32 ll, its gradient finite and close to the fp32 one."""
    got, jx = runs[k]["segmented"], _jax()
    pm = jx["segmented_pm"]
    t0 = jtree_fn(pm, backend="xla")[1]
    v, g = _jgrad(pm, t0)
    assert got["engine"] == "segmented"
    assert got["segments"] > 1    # the port's own cap (JAX's plan: 2)
    assert got["ll"] == pytest.approx(v, rel=1e-5)
    assert got["ll_oracle"] == pytest.approx(v, rel=1e-5)
    np.testing.assert_allclose(got["grad"], g, rtol=5e-4, atol=1e-4)
    b16 = runs[k]["bf16"]
    assert b16["engine"] == "segmented"
    assert b16["ll_fp32"] == got["ll_oracle"]
    assert abs(b16["ll"] - v) < 5e-3 * abs(v)
    gb = np.asarray(b16["grad"])
    assert np.isfinite(gb).all()
    assert np.abs(gb - g).max() < 0.05 * np.abs(g).max()


@pytest.mark.parametrize("k", RANKS)
def test_dryrun_partition_matches_jax(runs, k):
    got = runs[k]["partition"]
    assert got["parts"] == 2
    for ll in (got["ll"], got["ll_single"]):
        assert ll == pytest.approx(_jax()["partition"], rel=1e-6)


def test_dryrun_ranks_agree_with_one_rank(runs):
    """Two ranks and one rank: the same scaler counts, segment plan and
    engines; lls within rel 1e-6 (the partials are summed in another
    order)."""
    one, two = runs[1], runs[2]
    for name in ("tree", "int8", "protein", "codon"):
        assert one[name]["scaler_total"] == two[name]["scaler_total"]
        assert one[name]["ll"] == pytest.approx(two[name]["ll"], rel=1e-6)
    assert one["plf"]["scaler_inc"] == two["plf"]["scaler_inc"]
    assert one["plf_batch"] == two["plf_batch"]
    assert one["segmented"]["segments"] == two["segmented"]["segments"]


def test_dryrun_refuses_more_ranks_than_cards(monkeypatch):
    """On "cuda", more ranks than cards raise before any process starts
    (here there are none)."""
    assert torch.cuda.device_count() < 2

    def no_process(*a, **k):
        raise AssertionError("a process was started")
    monkeypatch.setattr(subprocess, "Popen", no_process)
    with pytest.raises(ValueError, match=rf"2 ranks .* "
                       rf"{torch.cuda.device_count()} card"):
        G.dryrun_multichip(2, device="cuda")
    with pytest.raises(ValueError):
        G.dryrun_multichip(0, device="cpu")


@pytest.mark.parametrize("script,timeout,match", [
    ("import sys; sys.stderr.write('rank failed here'); sys.exit(3)", 60,
     r"rank [01] of 2 exited 3; ranks that exited non-zero by themselves: "),
    # the order forced: rank 0 (its rank is argv[2]) sleeps, rank 1 exits
    # at once, so rank 0 is stopped and does not count
    ("import sys, time; r = int(sys.argv[2]); "
     "sys.stderr.write(f'rank {r} failed here'); "
     "time.sleep(30 if r == 0 else 0); sys.exit(3)", 60,
     r"rank [01] of 2 exited 3; ranks that exited non-zero by themselves: "
     r"(0 \(exit 3\), )?1 \(exit 3\) "),
    ("import time; time.sleep(30)", 2, "ran past 2 s")])
def test_dryrun_raises_on_a_failed_rank(monkeypatch, script, timeout,
                                        match):
    """A rank that exits non-zero, or runs past its limit, raises with the
    end of its stderr; every rank is stopped.  The rank named is the
    lowest of those that exited non-zero by themselves, which the message
    lists, whichever exited first."""
    monkeypatch.setattr(G, "RANK_SCRIPT", script)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=match) as e:
        G.dryrun_multichip(2, device="cpu", timeout=timeout)
    assert time.monotonic() - t0 < 25
    msg = str(e.value)
    if "exited" in match:
        named = int(re.search(r"rank (\d) of 2 exited", msg)[1])
        listed = [int(r) for r in re.findall(r"(\d) \(exit 3\)", msg)]
        assert named == min(listed)
        assert "failed here" in msg
        if "argv" in script:
            assert f"rank {named} failed here" in msg


def test_launch_counts_cover_every_wrapper():
    """``ops.launch_counts`` (the dry run's and the CLI's launch report)
    reads every function of the ops modules that counts launches."""
    import importlib
    from plf_tpu_torch import ops
    counted = set()
    for mod in ("plf_node", "plf_mxu", "plf_tree", "plf_grad",
                "plf_tree_grad", "plf_tree_seg"):
        m = importlib.import_module(f"plf_tpu_torch.ops.{mod}")
        counted |= {name for name, f in vars(m).items()
                    if callable(f) and hasattr(f, "launches")
                    and f.__module__ == m.__name__}
    counts = ops.launch_counts()
    assert set(counts) == counted and len(counted) == 19
    assert all(isinstance(v, int) for v in counts.values())
