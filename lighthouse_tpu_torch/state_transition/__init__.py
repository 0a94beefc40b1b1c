"""State transition of the PyTorch/CUDA port: epoch processing
(``per_epoch.process_epoch``, through the epoch engine), the state
accessors and mutators (``helpers``) and the spec's swap-or-not shuffle
(``shuffle``) — copies of the JAX package's modules.  Slot and block
processing, genesis and the signature sets are not ported yet.
"""
from .per_epoch import compute_unrealized_checkpoints, process_epoch
from .helpers import CommitteeCache, get_beacon_proposer_index
from .shuffle import compute_shuffled_index, shuffle_indices, shuffle_list

__all__ = [n for n in dir() if not n.startswith("_")]
