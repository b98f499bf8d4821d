from .substitution import (SubstitutionModel, jc69, hky85, gtr, random_gtr,
                           empirical_protein, parse_paml_matrix,
                           discrete_gamma_rates, gamma_invariant_rates,
                           branch_matrices, GENETIC_CODE, SENSE_CODONS,
                           codon_gy94, f3x4_frequencies, f3x4_from_codes,
                           encode_codon_alignment)
from .tree import Tree, TreeNode, parse_newick, random_tree
from .simulate import simulate_alignment
from .phylo import PhyloModel, TreeLikelihoodResult
from .optimize import (tree_loglik_fn, optimize_branch_lengths,
                       optimize_alpha, optimize_pinv, fit_codon)
