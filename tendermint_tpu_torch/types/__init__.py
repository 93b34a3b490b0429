"""Domain types: blocks, votes, validators, and the crypto-plane contracts
(copies of `tendermint_tpu/types`)."""

from tendermint_tpu_torch.types.block import (Block, BlockID, Commit,
                                              CompactCommit, EMPTY_COMMIT,
                                              Header, ZERO_BLOCK_ID)
from tendermint_tpu_torch.types.canonical import (SIGN_BYTES_LEN,
                                                  TYPE_HEARTBEAT,
                                                  TYPE_PRECOMMIT,
                                                  TYPE_PREVOTE,
                                                  TYPE_PROPOSAL)
from tendermint_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
from tendermint_tpu_torch.types.keys import PrivKey, PubKey
from tendermint_tpu_torch.types.part_set import (PART_SIZE, Part, PartSet,
                                                 PartSetHeader, ZERO_PSH)
from tendermint_tpu_torch.types.priv_validator import (DoubleSignError,
                                                       PrivValidator)
from tendermint_tpu_torch.types.proposal import Heartbeat, Proposal
from tendermint_tpu_torch.types.tx import Tx, txs_hash
from tendermint_tpu_torch.types.validator import Validator, ValidatorSet
from tendermint_tpu_torch.types.vote import (DuplicateVoteEvidence,
                                             ErrVoteConflict, Vote, VoteSet)

__all__ = [
    "Block", "BlockID", "Commit", "CompactCommit", "EMPTY_COMMIT", "Header",
    "ZERO_BLOCK_ID", "SIGN_BYTES_LEN", "TYPE_HEARTBEAT", "TYPE_PRECOMMIT",
    "TYPE_PREVOTE", "TYPE_PROPOSAL", "GenesisDoc", "GenesisValidator",
    "PrivKey", "PubKey", "PART_SIZE", "Part", "PartSet", "PartSetHeader",
    "ZERO_PSH", "DoubleSignError", "PrivValidator", "Heartbeat", "Proposal",
    "Tx", "txs_hash", "Validator", "ValidatorSet", "DuplicateVoteEvidence",
    "ErrVoteConflict", "Vote", "VoteSet",
]
