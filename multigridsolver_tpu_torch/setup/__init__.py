from .prolongation import (prolong, restrict, labels_from_p_csr,
                           p_csr_from_labels, compose_labels)
from .strength import compute_strength, StrengthData
from .matching import mutual_match, labels_from_pairs
from .galerkin import galerkin_pair_arrays, galerkin_pair_ell
from .aggregation import (pairwise_aggregate, build_amg_setup,
                          refresh_setup, AggregationResult, SetupResult)
from .tentagg import checktentagg, member_ranks
from .smoothed import (tentative_p, smoothed_prolongation,
                       galerkin_general)
from .transfers import (TransferPlan, build_transfer_plan,
                        build_transfer_plan_from_p)
