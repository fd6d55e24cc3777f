"""API layer, as far as the port carries it: the proposal precompute cache
(ref ``KafkaCruiseControl.java``'s cached proposals) that the fleet registry
fills per member. The REST server, the facade and the user-task layer are
not ported yet."""

from .precompute import ProposalCache

__all__ = ["ProposalCache"]
