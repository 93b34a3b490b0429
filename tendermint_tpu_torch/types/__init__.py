"""Domain types: blocks, votes, validators, and the crypto-plane contracts
(copies of `tendermint_tpu/types` for the fast-sync replay slice)."""

from tendermint_tpu_torch.types.block import (Block, BlockID, Commit,
                                              CompactCommit, EMPTY_COMMIT,
                                              Header, ZERO_BLOCK_ID)
from tendermint_tpu_torch.types.canonical import (SIGN_BYTES_LEN,
                                                  TYPE_PRECOMMIT,
                                                  TYPE_PREVOTE)
from tendermint_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
from tendermint_tpu_torch.types.keys import PrivKey, PubKey
from tendermint_tpu_torch.types.part_set import (PART_SIZE, Part, PartSet,
                                                 PartSetHeader, ZERO_PSH)
from tendermint_tpu_torch.types.tx import Tx, txs_hash
from tendermint_tpu_torch.types.validator import Validator, ValidatorSet
from tendermint_tpu_torch.types.vote import Vote

__all__ = [
    "Block", "BlockID", "Commit", "CompactCommit", "EMPTY_COMMIT", "Header",
    "ZERO_BLOCK_ID", "SIGN_BYTES_LEN", "TYPE_PRECOMMIT", "TYPE_PREVOTE",
    "GenesisDoc", "GenesisValidator", "PrivKey", "PubKey", "PART_SIZE",
    "Part", "PartSet", "PartSetHeader", "ZERO_PSH", "Tx", "txs_hash",
    "Validator", "ValidatorSet", "Vote",
]
