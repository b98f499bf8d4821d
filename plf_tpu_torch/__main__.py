"""plf_tpu_torch CLI: the host_mem.exe equivalent on the card.

Counterpart of ``plf_tpu/__main__.py`` (``main``, ``:224-348``).  The
reference's primary entry point is ``host_mem.exe <xclbin> <BDF>
<alignment_sites> <plf_calls> <instances>`` (``app/src/host_mem.cpp:13-14``):
print the config/geometry report, generate random inputs with a
forced-underflow pattern, run the benchmark loop, verify against the CPU
golden model, and print timing/bandwidth tables::

    python -m plf_tpu_torch [config-name] --sites N --calls K
                            [--instances I] [--block B] [--no-verify]
                            [--csv out.csv] [--gen] [--prerun-check]
                            [--roundtrip] [--device cuda|cpu]

The positional config name plays the xclbin filename's role and is parsed
by ``PLFConfig.from_name``.  The calls stream through
``runtime/executor.py::StreamingExecutor`` (kernel 1, or kernel 1m in fp32
mode at S != 4) and the last one is checked against the native golden
oracle (``runtime/native.py``) with exact float equality, the reference's
bar, on the card and on the CPU alike.  ``--gen`` runs kernel 9, the
compute-only probe (``ops/plf_node.py::plf_node_gen``), instead.  Runs
are on the card unless ``--device cpu`` asks for the plain versions;
``--sites`` is never capped.

Beyond the reference's benchmark program, ``infer`` runs the full ML
pipeline on a real alignment (``models/pipeline.py``), on the card unless
``--device cpu`` asks for the plain versions::

    python -m plf_tpu_torch infer align.fasta [--model auto|jc|hky|gtr|lg|...]
        [--seq-type auto|dna|protein|codon] [--alpha A] [--pinv P]
        [--search nni|spr|mixed|none] [--bootstrap N] [--out tree.nwk]

Counterpart of ``plf_tpu/__main__.py::infer_main`` (``:56``).  ``--model
auto`` first ranks a candidate ladder by AICc on the NJ starting tree
(``models/selection.py``: the 10 DNA models, the 32 empirical protein
models, or GY94 against GY94+G for codons), logs the table, and runs the
pipeline under the winner.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np


def log(*a):
    print(*a, flush=True)


def make_data(n, states, categories, seed=7):
    """Random inputs incl. the reference's forced-underflow pattern
    (host_mem.cpp:179-209: scale=1e-12 for element index j%64<16); the
    JAX package's generator, draw for draw."""
    rng = np.random.default_rng(seed)
    S, C = states, categories
    e = S * C
    x1 = rng.random((n * e,), dtype=np.float32)
    x1.reshape(n, e)[0::4] *= np.float32(1e-12)   # flat index j % 4e < e
    x2 = rng.random((n * e,), dtype=np.float32)
    ev = rng.random((S, S), dtype=np.float32)
    left = rng.random((C, S, S), dtype=np.float32)
    right = rng.random((C, S, S), dtype=np.float32)
    wgt = np.ones((n,), dtype=np.int32)
    return (x1.reshape(n, C, S), x2.reshape(n, C, S), left, right, ev, wgt)


def _launches() -> str:
    """The kernel launches this process made, by wrapper (none on the
    CPU, where the plain versions run)."""
    from .ops import plf_grad, plf_tree, plf_tree_grad, plf_tree_seg
    from .ops.plf_mxu import plf_node_mxu
    from .ops.plf_node import plf_node, plf_node_gen
    wrappers = (plf_node, plf_node_mxu, plf_node_gen, plf_tree.plf_tree,
                plf_tree.plf_tree_mxu, plf_tree.plf_tree_batch,
                plf_tree.plf_tree_mxu_batch, plf_grad.plf_node_bwd,
                plf_grad.plf_node_bwd_mxu, plf_tree_grad.plf_tree_bwd,
                plf_tree_grad.plf_tree_bwd_mxu, plf_tree_seg.plf_tree_seg,
                plf_tree_seg.plf_tree_seg_mxu, plf_tree_seg.plf_tree_seg_bwd,
                plf_tree_seg.plf_tree_seg_bwd_mxu)
    counts = [f"{f.__name__} {f.launches}" for f in wrappers if f.launches]
    return ", ".join(counts) or "none (plain versions)"


def _gen(cfg, args, device) -> int:
    """The compute-only probe: ``--calls`` launches of kernel 9 over
    ``--sites`` sites (whole blocks of the config's ``block_sites``), 8
    chained nodes each."""
    import torch

    from .ops import layout as L
    from .ops.plf_node import gen_flops, plf_node_gen

    S, C = cfg.states, cfg.categories
    rng = np.random.default_rng(0)
    lc, rc, ec = (torch.as_tensor(a, device=device) for a in (
        L.branch_to_lane_constants(rng.random((C, S, S), np.float32), S, C),
        L.branch_to_lane_constants(rng.random((C, S, S), np.float32), S, C),
        L.ev_to_lane_constants(rng.random((S, S), np.float32), S, C)))
    nb = max(1, args.sites // cfg.block_sites)
    kw = dict(states=S, categories=C, block_sites=cfg.block_sites,
              n_blocks=nb, inner_iters=8)
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    plf_node_gen(lc, rc, ec, **kw)     # builds and loads the kernel
    sync()
    t0 = time.perf_counter()
    for _ in range(args.calls):
        out = plf_node_gen(lc, rc, ec, **kw)
    sync()
    dt = time.perf_counter() - t0
    ns = nb * cfg.block_sites * 8 * args.calls
    finite = int(torch.isfinite(out).sum())
    log(f"gen probe: {ns / dt / 1e9:.3f} Gnode-sites/s "
        f"({ns / dt * gen_flops(S, C) / 1e12:.3f} TFLOP/s fp32 equivalent, "
        f"{gen_flops(S, C)} flops per node-site) on {device}; "
        f"{finite} of {out.numel()} checksums finite")
    log(f"kernel launches: {_launches()}")
    return 0


def infer_main(argv):
    ap = argparse.ArgumentParser(prog="python -m plf_tpu_torch infer")
    ap.add_argument("alignment",
                    help="FASTA or PHYLIP file (DNA, or protein for "
                         "--model lg/wag)")
    ap.add_argument("--model", default="jc",
                    choices=["auto", "jc", "hky", "gtr", "lg", "wag",
                             "jtt", "dayhoff", "mtrev", "cprev",
                             "gy94"],
                    help="'auto' = AICc model selection (DNA: JC/HKY/"
                         "GTR +G/+I; protein: the empirical-matrix ladder; "
                         "codon: GY94 vs GY94+G); 'gy94' fits omega/kappa "
                         "by ML (fit_codon) directly; 'gtr' fits the GTR "
                         "model (fit_model)")
    ap.add_argument("--seq-type", default="auto",
                    choices=["auto", "dna", "protein", "codon"],
                    help="alignment alphabet; 'auto' treats the data as "
                         "protein when >10%% of residues fall outside "
                         "the DNA alphabet incl. IUPAC ambiguity codes")
    ap.add_argument("--kappa", type=float, default=2.0,
                    help="HKY transition/transversion ratio")
    ap.add_argument("--alpha", type=float, default=None,
                    help="initial gamma shape (enables +G)")
    ap.add_argument("--pinv", type=float, default=None,
                    help="initial invariant proportion (enables +I)")
    ap.add_argument("--search", default="nni",
                    choices=["nni", "spr", "mixed", "none"])
    ap.add_argument("--fit", default="lengths+alpha",
                    help="'+'-joined: lengths, alpha, pinv, model, none")
    ap.add_argument("--bootstrap", type=int, default=0)
    ap.add_argument("--out", default=None, help="write newick here")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default: the CUDA kernels) or 'cpu' "
                         "(their plain versions)")
    args = ap.parse_args(argv)

    from .models import empirical_protein, hky85, jc69, run_inference
    from .models.substitution import BUILTIN_PROTEIN_MODELS

    with open(args.alignment) as f:
        text = f.read()
    codon = args.seq_type == "codon" or args.model == "gy94"
    if args.seq_type == "auto" and not codon:
        protein = (args.model in BUILTIN_PROTEIN_MODELS
                   or _detect_protein(text))
    else:
        protein = args.seq_type == "protein"
    aln = _parse_alignment(text, protein=protein)
    if codon:
        # codon data arrives as in-frame DNA; encode to 61 states
        from .io.alignment import Alignment
        from .models.substitution import encode_codon_alignment
        aln = Alignment(aln.names, encode_codon_alignment(aln.codes))
        return _infer_codon(args, aln)
    if args.model in BUILTIN_PROTEIN_MODELS:
        model = empirical_protein(args.model)
    elif args.model == "auto":
        # ModelTest step: rank the candidate ladder by AICc on an NJ
        # starting tree, then run the full inference under the winner
        # (DNA: JC/HKY/GTR +G/+I; protein: the empirical-table ladder).
        from .config import PLFConfig
        from .models import nj_tree
        comp = aln.compressed()
        # the NJ distances use the alignment's alphabet size
        start = nj_tree(comp.codes, comp.weights,
                        states=20 if protein else 4, device=args.device)
        sel = _select(start, comp, PLFConfig(states=20) if protein
                      else None, args.device)
        model = sel.best.model
        if sel.best.alpha is not None and args.alpha is None:
            args.alpha = sel.best.alpha
        if sel.best.p_inv is not None and args.pinv is None:
            args.pinv = sel.best.p_inv
        args.model = sel.best.name.partition("+")[0].lower()
    else:
        model = {"jc": jc69, "hky": lambda: hky85(args.kappa),
                 "gtr": jc69}[args.model]()
    fit = args.fit if args.model != "gtr" else args.fit + "+model"
    res = run_inference(aln.codes, names=aln.names, model=model,
                        alpha=args.alpha, p_inv=args.pinv,
                        search=args.search, fit=fit,
                        bootstrap=args.bootstrap, progress=log,
                        device=args.device)
    return _report(res, args.out, f"(alpha={res.alpha}, p_inv={res.p_inv}, "
                                  f"{res.elapsed_s:.1f}s)")


def _select(start, comp, cfg, device, label="model selection"):
    """AICc model selection on the start tree; logs the table, each
    candidate's fit time and the winner."""
    from .models import model_select
    sel = model_select(start, comp.codes, wgt=comp.weights, config=cfg,
                       device=device)
    log(f"{label} (AICc):\n" + sel.table())
    log("fit seconds: " + ", ".join(f"{f.name} {f.seconds:.2f}"
                                    for f in sel.fits))
    log(f"selected: {sel.best.name} (alpha={sel.best.alpha}, "
        f"p_inv={sel.best.p_inv})")
    return sel


def _report(res, out, detail) -> int:
    log(f"final ll = {res.log_likelihood:.6f}  {detail}")
    log(res.newick)
    if out:
        with open(out, "w") as f:
            f.write(res.newick + "\n")
        log(f"wrote {out}")
    log(f"kernel launches: {_launches()}")
    return 0


def _infer_codon(args, aln) -> int:
    """Codon-model inference: GY94 omega/kappa ML fit (or GY94 vs
    GY94+G selection with --model auto), then the standard pipeline
    under the fitted model."""
    from .config import PLFConfig
    from .models import nj_tree, run_inference
    from .models.optimize import fit_codon

    comp = aln.compressed()
    cfg = PLFConfig(states=61, kernel_variant="auto", block_sites=1024)
    start = nj_tree(comp.codes, comp.weights, states=61, device=args.device)
    if args.model == "auto":
        sel = _select(start, comp, cfg, args.device,
                      label="codon model selection")
        model, alpha = sel.best.model, sel.best.alpha
    else:
        model, info = fit_codon(start, comp.codes, wgt=comp.weights,
                                config=cfg, fit_alpha=args.alpha
                                is not None, verbose=True,
                                device=args.device)
        log(f"GY94 fit: kappa={info['kappa']:.3f} "
            f"omega={info['omega']:.4f} ll={info['ll']:.4f}")
        alpha = info["alpha"]
    res = run_inference(aln.codes, names=aln.names, model=model,
                        alpha=alpha, search=args.search,
                        fit="lengths", bootstrap=args.bootstrap,
                        progress=log, device=args.device)
    return _report(res, args.out, f"({res.elapsed_s:.1f}s)")


def _detect_protein(text: str) -> bool:
    """Protein if a meaningful FRACTION of residues falls outside the
    DNA alphabet (>10%): a stray X/ambiguity code in a DNA file must not
    flip the whole alignment to the 20-state encoding (DNA alignments
    are >~90% ACGTUN/IUPAC/gap).  The DNA set includes the IUPAC
    nucleotide ambiguity codes (R/Y/S/W/K/M/B/D/H/V and X): an
    ambiguity-rich DNA alignment is still DNA."""
    from .io.alignment import parse_fasta, parse_phylip
    if text.lstrip().startswith(">"):
        _, seqs = parse_fasta(text)
    else:
        _, seqs = parse_phylip(text)
    dna = set("ACGTUN-?.RYSWKMBDHVX")
    dna |= set(c.lower() for c in dna)
    total = nondna = 0
    for seq in seqs:
        for ch in seq:
            total += 1
            if ch not in dna:
                nondna += 1
    return total > 0 and nondna / total > 0.10


def _parse_alignment(text: str, protein: bool = False):
    from .io.alignment import (Alignment, parse_fasta, parse_phylip,
                               encode_dna, encode_protein)
    if text.lstrip().startswith(">"):
        names, seqs = parse_fasta(text)
    else:
        names, seqs = parse_phylip(text)
    enc = encode_protein if protein else encode_dna
    return Alignment(names, enc(seqs))


def main(argv=None):
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "infer":
        return infer_main(argv[1:])
    ap = argparse.ArgumentParser(prog="python -m plf_tpu_torch")
    ap.add_argument("config", nargs="?", default=None,
                    help="config name (xclbin-filename analogue)")
    ap.add_argument("--sites", type=int, default=100_000)
    ap.add_argument("--calls", type=int, default=10)
    ap.add_argument("--instances", type=int, default=None,
                    help="instances reported (the name's count if not "
                         "given); the executor streams one node pair")
    ap.add_argument("--block", type=int, default=None)
    ap.add_argument("--no-verify", action="store_true",
                    help="skip golden check (NO_CORRECTNESS_CHECK knob, "
                         "Makefile:156-158)")
    ap.add_argument("--csv", default=None,
                    help="write per-call phase timings CSV")
    ap.add_argument("--gen", action="store_true",
                    help="compute-only probe (host_gen flavor)")
    ap.add_argument("--prerun-check", action="store_true",
                    help="interactive Y/n gate before running (the "
                         "reference's prerun_check, utils.cpp:9-39; "
                         "skipped by default = NO_PRERUN_CHECK)")
    ap.add_argument("--roundtrip", action="store_true",
                    help="time whole calls only, no phase split (the "
                         "NO_INTERMEDIATE_RESULTS mode, Makefile:159-161)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default: the CUDA kernels) or 'cpu' "
                         "(their plain versions)")
    args = ap.parse_args(argv)

    import torch

    from .config import PLFConfig
    from .engine import PLFEngine
    from .runtime.executor import StreamingExecutor
    from .utils.timing import format_timing_table, write_csv

    cfg, instances = (PLFConfig.from_name(args.config) if args.config
                      else (PLFConfig(), 1))
    if args.instances is not None:
        instances = args.instances
    if args.block:
        cfg = dataclasses.replace(cfg, block_sites=args.block)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run the "
                           "plain versions of the kernels")

    eng = PLFEngine(cfg, device=device)
    log(eng.describe(args.sites, args.calls, instances))
    log(f"device: {torch.cuda.get_device_name(device)}"
        if device.type == "cuda" else "device: cpu (plain versions)")

    if args.gen:
        return _gen(cfg, args, device)

    if args.prerun_check and sys.stdin.isatty():
        ans = input("Start the run? [Y/n] ").strip().lower()
        if ans and ans != "y":
            log("Aborted.")
            return 2

    log("Initialize test data ...")
    case = make_data(args.sites, cfg.states, cfg.categories)
    log("Running ...")
    ex = StreamingExecutor(cfg, inflight=1 if args.roundtrip else 2,
                           device=device)
    x3, inc = ex.run_repeated(case, args.calls)

    ok = True
    if not args.no_verify:
        from .runtime.native import golden_oracle, plf_golden_native
        log(f"Data collected, checking for correctness against the "
            f"{golden_oracle()} golden oracle (exact equality) ...")
        x3_ref, _, inc_ref = plf_golden_native(
            *case[:5], case[5], states=cfg.states, categories=cfg.categories)
        neq = x3 != x3_ref
        errors = int(neq.sum())
        for site, c, a in np.argwhere(neq)[:20]:
            log(f"ERROR: alignment data wrong at alignment {site}, "
                f"probability {c * cfg.states + a}: "
                f"{x3_ref[site, c, a]}!={x3[site, c, a]}")
        if inc != inc_ref:
            log(f"ERROR: scalerIncrement wrong: {inc_ref}!={inc}")
            errors += 1
        ok = errors == 0
        log(f"Test result: {'Passed' if ok else f'Failed with {errors} errors'}")

    log(f"kernel launches: {_launches()}")
    e = cfg.elements_per_site
    data_bytes = float(args.sites) * e * 4 * 3 * args.calls
    log(format_timing_table(ex.timing, data_bytes,
                            args.sites * args.calls))
    if args.csv:
        write_csv(args.csv, {"i0": ex.timing})
        log(f"wrote {args.csv}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
