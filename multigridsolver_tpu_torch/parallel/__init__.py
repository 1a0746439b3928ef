"""Row-sharded setup and solve over a row mesh: all shards on one device
in one process, or one rank per card over ``torch.distributed``
(``multihost``: NCCL between cards, gloo on the CPU)."""
from .sharded import (RowMesh, RankTransfer, make_row_mesh, shard_ell,
                      shard_operator, shard_hierarchy, shard_vector,
                      replicate, repad_ell)
from .halo import make_halo_spmv, halo_width, HaloOp
from .exchange import ExchangeELL, build_exchange_plan, exchange_ell
from .dist_setup import (build_amg_setup_sharded, shard_ell_halo,
                         gather_setup, check_replicated, replicated_digest)
from .multihost import (init_multihost, global_row_mesh, put_global,
                        host_read, is_multiprocess, shutdown_multihost)
