"""State sync: chunked, hash-verified state snapshots + verified rejoin.

A node crashed at height N rejoins from a recent snapshot plus a short
windowed fast-sync of `snapshot_height -> tip`, instead of replaying the
whole committed prefix from genesis.  Three pieces:

- `snapshot`: the on-disk format — fixed-size chunks of the serialized
  consensus `State` + app state, a Merkle root over the chunk hashes
  (batched through the backend it is given: kernel K4 on the card), a
  CRC-framed manifest written last so torn snapshots are detectable, and
  retention of the last K snapshots.
- `restore`: the offer/fetch/verify protocol — pick the best manifest
  across peers, cross-check its app_hash against a light-client-verified
  header, fetch chunks from multiple peers in parallel, verify every
  chunk hash (one batched call) before apply, and blame the serving
  peer for every mismatch (feeding p2p misbehavior scoring/bans).
- `messages`: the wire messages for a future statesync reactor
  (channel 0x60), codec-complete so rig-level protocols and the p2p
  layer share one vocabulary.

Copy of `tendermint_tpu/statesync/` for the port.
"""

from tendermint_tpu_torch.statesync.snapshot import (DEFAULT_CHUNK_SIZE,
                                               DEFAULT_RETAIN,
                                               SNAPSHOT_FORMAT,
                                               SnapshotManifest,
                                               SnapshotStore,
                                               decode_payload,
                                               encode_payload, hash_chunks,
                                               split_chunks)
from tendermint_tpu_torch.statesync.restore import (RestoreError, StateSyncer,
                                              StoreSource,
                                              verify_manifest_app_hash)
from tendermint_tpu_torch.statesync.messages import STATESYNC_CHANNEL

__all__ = ["DEFAULT_CHUNK_SIZE", "DEFAULT_RETAIN", "SNAPSHOT_FORMAT",
           "STATESYNC_CHANNEL", "RestoreError", "SnapshotManifest",
           "SnapshotStore", "StateSyncer", "StoreSource",
           "decode_payload", "encode_payload", "hash_chunks",
           "split_chunks", "verify_manifest_app_hash"]
