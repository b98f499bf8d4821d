"""Site sharding over ``torch.distributed`` (counterpart of
``plf_tpu/parallel``)."""

from .sharding import (SiteMesh, ShardedPLF, make_mesh, padded_sites,
                       plf_sharded, shard_sites, shard_span)
from .distributed import (initialize_distributed, global_site_mesh,
                          validate_site_workload, process_summary)
