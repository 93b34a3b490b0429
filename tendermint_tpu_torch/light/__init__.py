"""Light client: header-chain verification without executing blocks
(see `client.py`)."""

from tendermint_tpu_torch.light.client import (ChainBatch, LightClient,
                                               SignedHeader, TrustedState,
                                               verify_chains_batched,
                                               verify_commit_any)

__all__ = ["ChainBatch", "LightClient", "SignedHeader", "TrustedState",
           "verify_chains_batched", "verify_commit_any"]
