from .substitution import (SubstitutionModel, jc69, hky85, gtr, random_gtr,
                           empirical_protein, parse_paml_matrix,
                           discrete_gamma_rates, gamma_invariant_rates,
                           branch_matrices)
from .tree import Tree, TreeNode, parse_newick, random_tree
from .phylo import PhyloModel, TreeLikelihoodResult
from .optimize import (tree_loglik_fn, optimize_branch_lengths,
                       optimize_alpha, optimize_pinv)
