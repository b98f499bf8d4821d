from .substitution import (SubstitutionModel, jc69, hky85, gtr, random_gtr,
                           empirical_protein, parse_paml_matrix,
                           discrete_gamma_rates, gamma_invariant_rates,
                           branch_matrices, AMINO_ACIDS, GENETIC_CODE,
                           SENSE_CODONS,
                           codon_gy94, f3x4_frequencies, f3x4_from_codes,
                           encode_codon_alignment)
from .tree import Tree, TreeNode, parse_newick, random_tree
from .simulate import simulate_alignment
from .phylo import (PhyloModel, TreeLikelihoodResult, batch_log_likelihood,
                    batch_log_likelihood_segmented)
from .optimize import (tree_loglik_fn, optimize_branch_lengths,
                       optimize_alpha, optimize_pinv, fit_model, fit_codon)
from .search import (nni_neighbors, nni_search, spr_neighbors, spr_search,
                     tree_search, SearchResult)
from .bootstrap import (bootstrap_weights, bootstrap_log_likelihoods,
                        rell_support)
from .distance import (pairwise_mismatch, jc_distance_matrix,
                       neighbor_joining, nj_tree)
from .consensus import (bipartitions, rf_distance, majority_rule_consensus,
                        split_support, bootstrap_nj_trees, annotate_support)
from .pipeline import InferenceResult, run_inference
from .partition import Partition, PartitionedModel, PartitionedResult
from .ancestral import ancestral_marginal, site_rates
from .support import alrt_support, annotate_alrt
from .selection import (ModelFit, SelectionResult, model_select,
                        empirical_frequencies, DNA_CANDIDATES,
                        PROTEIN_CANDIDATES, CODON_CANDIDATES)
