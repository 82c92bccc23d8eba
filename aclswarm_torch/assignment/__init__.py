"""Assignment solvers (port of `aclswarm_tpu.assignment`):

- ``cbaa``     — decentralized CBAA max-consensus, the reference-faithful
                 mode;
- ``auction``  — exact centralized LAP (Bertsekas auction), the engine's
                 default;
- ``sinkhorn`` — entropic-OT fast path with permutation rounding.

The host Jonker-Volgenant oracle stays with the reference package, where
the tests import it from.
"""
from aclswarm_torch.assignment import auction, cbaa, sinkhorn
from aclswarm_torch.assignment.auction import (AuctionResult, assign_min_dist,
                                               auction_lap)
from aclswarm_torch.assignment.cbaa import (CBAAResult, CbaaTables,
                                            bid_prices, cbaa_assign,
                                            cbaa_from_state, init_tables)
from aclswarm_torch.assignment.sinkhorn import (SinkhornResult,
                                                round_dominant,
                                                round_parallel,
                                                round_to_permutation,
                                                sinkhorn_assign, sinkhorn_log,
                                                two_opt_refine)

__all__ = [
    "auction", "cbaa", "sinkhorn",
    "auction_lap", "assign_min_dist", "AuctionResult",
    "cbaa_assign", "cbaa_from_state", "bid_prices", "CBAAResult",
    "CbaaTables", "init_tables",
    "sinkhorn_assign", "sinkhorn_log", "round_to_permutation",
    "round_parallel", "round_dominant", "two_opt_refine",
    "SinkhornResult",
]
