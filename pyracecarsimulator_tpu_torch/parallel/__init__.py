from .rollout import (rollout, make_rollout_fn, make_constant_policy,
                      make_gap_follower_policy)
