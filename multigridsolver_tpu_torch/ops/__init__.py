"""Hand-written CUDA kernels of the main path (K1, K2, K3) and of its
row-sharded variant (K4)."""
from .gather import (gather_spmv, hyb_spmv, pack_lanes, take, take_rows,
                     take_rows_many, take_sharded, launch_counts,
                     reset_launch_counts)
