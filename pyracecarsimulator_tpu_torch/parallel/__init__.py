from .rollout import (rollout, make_rollout_fn, make_constant_policy,
                      make_gap_follower_policy)
from .train import make_bptt_train_fn
