"""The benchmark's plain reference: float64 PyTorch and NumPy.

Nothing here imports the program under test (``plf_tpu_torch``) or the
JAX package.  It makes the inputs that both sides get (the tree and the
simulated alignment, from the seed) and recomputes from them, in float64,
everything the timed path computes: the substitution model's eigensystem,
the transition matrices, Felsenstein pruning with rescaling, the
log-likelihood, its gradient by the branch lengths and the Adam steps.

Frozen copies, each naming its origin (commit c0abfbb of this
repository):

* ``tree.py``: the random rooted tree (``plf_tpu_torch/models/tree.py``
  ``random_tree``), its topology and its lengths drawn apart;
* ``simulate.py``: ``simulate_alignment``'s algorithm
  (``plf_tpu_torch/models/simulate.py``) in torch, on the card;
* ``lg.dat``: LG's PAML text (``plf_tpu_torch/models/data/lg.dat``);
* ``substitution.py``: the PAML parser, the GTR rate matrix and its
  normalisation (``plf_tpu_torch/models/substitution.py``) and the
  discrete-Gamma rule (``discrete_gamma_rates``, same file).
"""
