from .rollout import (rollout, make_rollout_fn, make_constant_policy,
                      make_gap_follower_policy)
from .mesh import (make_mesh, make_sharded_scan, make_sharded_step,
                   shard_state, gather_agents, gather_ranges)
from .ringmap import make_ring_scan, shard_sector_table
from .train import make_bptt_train_fn
from . import multihost
