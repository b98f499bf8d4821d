"""The frozen copies equal what they were copied from; the reference
equals the port's plain path; nothing the benchmark runs loads JAX."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

import program
import run
import work
from inputs import make_inputs, paml_text
from reference.likelihood import log_likelihood
from reference.substitution import discrete_gamma_rates, gtr, paml

CONFIGS = {c["name"]: run.load_json(run.ROOT / c["file"])
           for c in run.benchmark()["configs"]}


def small(name, taxa=8, sites=1024):
    cfg = dict(CONFIGS[name])
    cfg.update(taxa=taxa, sites=sites)
    return cfg


@pytest.mark.parametrize("S,C,E,variant", [
    (4, 4, 47, "vpu"), (4, 4, 159, "vpu"), (20, 4, 143, "mxu_3x"),
    (20, 4, 63, "mxu"), (20, 4, 63, "mxu_bf16"), (61, 4, 31, "vpu")])
def test_counters_equal_chip_smoke(S, C, E, variant):
    import chip_smoke as cs
    assert work.node_work(S, C, variant) == cs.node_work(S, C, variant)
    assert work.node_bwd_flops(S, C) == cs.node_bwd_flops(S, C)
    assert work.tree_bwd_work(S, C, E, variant) == cs.tree_bwd_work(
        S, C, E, variant)
    assert work.bound(1e9, 1e12, work.FP32_FLOPS) == cs.bound(
        1e9, 1e12, cs.FP32_FLOPS)
    assert (work.HBM_BYTES_PER_S, work.FP32_FLOPS, work.BF16_FLOPS) == (
        cs.HBM_BYTES_PER_S, cs.FP32_FLOPS, cs.BF16_FLOPS)


def test_frozen_lg_equals_the_port():
    from plf_tpu_torch.models.substitution import empirical_protein
    text = paml_text(CONFIGS["prot144_lg_g4"]["model"])
    ours, port = paml(text), empirical_protein("lg")
    np.testing.assert_array_equal(ours.pi, port.pi)
    np.testing.assert_allclose(ours.lam, port.eigenvalues, rtol=0,
                               atol=1e-12)
    q = (port.u * port.eigenvalues) @ port.w
    np.testing.assert_allclose(ours.q, q, rtol=0, atol=1e-12)


def test_frozen_gtr_and_gamma_equal_the_port():
    from plf_tpu_torch.models import substitution as sub
    spec = CONFIGS["dna48_gtr_g4"]["model"]
    ours = gtr(spec["exchangeabilities"], spec["frequencies"])
    port = sub.gtr(spec["exchangeabilities"], spec["frequencies"])
    q = (port.u * port.eigenvalues) @ port.w
    np.testing.assert_allclose(ours.q, q, rtol=0, atol=1e-12)
    for a in (0.02, 0.6, 0.8, 100.0):
        np.testing.assert_array_equal(discrete_gamma_rates(a, 4),
                                      sub.discrete_gamma_rates(a, 4))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_simulator_matches_simulate_alignment(name):
    """State frequencies at the tips and the identity of tip pairs of the
    torch simulator against ``simulate_alignment`` on the same tree."""
    from plf_tpu_torch.models.simulate import simulate_alignment
    cfg = small(name, taxa=6, sites=40_000)
    inp = make_inputs(cfg, 7, "cpu")
    ours = inp.tips.numpy()
    spec = cfg["model"]
    model = program.substitution_model(
        spec, paml_text(spec) if spec["kind"] == "paml" else None)
    theirs = simulate_alignment(program.port_tree(inp.children, inp.lengths),
                                model, cfg["sites"], alpha=cfg["alpha"],
                                seed=7)
    S = model.states
    f_ours = np.bincount(ours.ravel(), minlength=S) / ours.size
    f_theirs = np.bincount(theirs.ravel(), minlength=S) / theirs.size
    np.testing.assert_allclose(f_ours, f_theirs, atol=0.01)
    same = lambda a: np.mean([np.mean(a[i] == a[j]) for i in range(6)
                              for j in range(i)])
    assert abs(same(ours) - same(theirs)) < 0.01


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_reference_equals_the_ports_plain_path(name):
    """At 8 taxa x 1,024 sites on the CPU: the log-likelihood and its
    gradient by the branch lengths (and the value at other rates)."""
    cfg = small(name)
    inp = make_inputs(cfg, 11, "cpu")
    spec = cfg["model"]
    model = program.substitution_model(
        spec, paml_text(spec) if spec["kind"] == "paml" else None)
    pm = program.phylo_model(inp.children, inp.lengths, model,
                             inp.tips.numpy(), cfg["alpha"],
                             cfg["plf_config"], "cpu")
    fn, t0 = program.loglik_fn(pm, False)
    t = torch.as_tensor(t0).requires_grad_()
    ll = fn(t)
    ll.backward()
    prob = inp.problem(256)
    t_ref = torch.as_tensor(t0, dtype=torch.float64).requires_grad_()
    ref, g = log_likelihood(prob, t_ref, torch.as_tensor(inp.rates),
                            grad_of=t_ref)
    assert abs(float(ll.detach()) - ref) <= 1e-6 * abs(ref)
    np.testing.assert_allclose(t.grad.double().numpy(), g.numpy(),
                               rtol=1e-4, atol=1e-4 * float(g.abs().max()))
    fr, _ = program.loglik_fn(pm, True)
    r = discrete_gamma_rates(0.1, cfg["categories"]).astype(np.float32)
    with torch.no_grad():
        v = float(fr(t0, r))
    ref_r, _ = log_likelihood(prob, torch.as_tensor(t0, dtype=torch.float64),
                              torch.as_tensor(r, dtype=torch.float64))
    assert abs(v - ref_r) <= 1e-6 * abs(ref_r)


PROBE = r"""
import json, sys
sys.path[:0] = [{here!r}, {root!r}]
import run
run._paths()
{body}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def _top_level_modules(body):
    code = PROBE.format(here=str(run.HERE), root=str(run.ROOT), body=body)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(run.ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    """A whole run of a cell (small, on the CPU) in a fresh process, then
    every loaded module's top-level name."""
    mods = _top_level_modules(
        "import calibrate\n"
        "run.run_cell('dna48-fit', 5, 0.2, True, device='cpu', overrides="
        "dict(taxa=6, sites=512, reference_block_sites=256))\n"
        "run.run_cell('prot144-alpha', 5, 0.2, False, device='cpu', "
        "overrides=dict(taxa=6, sites=512, reference_block_sites=256))")
    assert "plf_tpu_torch" in mods
    assert not mods & set(run.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    mods = _top_level_modules(
        "import reference.likelihood, reference.simulate, reference.tree\n"
        "import reference.substitution, check, inputs, work")
    assert not mods & set(run.FORBIDDEN + ("plf_tpu_torch",))


def test_no_card_no_result():
    """Without a card the run exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "dna48-fit",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=str(run.ROOT))
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
