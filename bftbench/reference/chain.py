"""Plain semantics of the chain the program replays: the reference's own.

Written from the protocol the program states (fixed-layout binary codec,
big-endian integers, u32 length prefixes; SHA-256 simple Merkle trees
with 0x00 leaf and 0x01 inner prefixes and the (n + 1) // 2 split; the
header hash as the Merkle root of its sorted field map; a commit's hash
as the Merkle root of its signatures, its votes on the wire as the
program's codec lays them out; 64 KB block parts; the 128-byte
precommit sign bytes; the kvstore app's bucketed state hash), with
hashlib and numpy alone.  It imports nothing of the program: the
benchmark makes the wire bytes it feeds the program here, and judges
the program's outputs against what this module works out.
"""

from __future__ import annotations

import bisect
import hashlib
import struct

import numpy as np

PART_SIZE = 64 * 1024
SIGN_BYTES_LEN = 128
TYPE_PRECOMMIT = 2
KV_BUCKETS = 256


def sha256(b: bytes) -> bytes:
    return hashlib.sha256(b).digest()


def u8(x: int) -> bytes:
    return struct.pack(">B", x)


def u32(x: int) -> bytes:
    return struct.pack(">I", x)


def u64(x: int) -> bytes:
    return struct.pack(">Q", x)


def i64(x: int) -> bytes:
    return struct.pack(">q", x)


def lp(b: bytes) -> bytes:
    return u32(len(b)) + b


def leaf_hash(b: bytes) -> bytes:
    return sha256(b"\x00" + b)


def root_from_leaves(hashes: list) -> bytes:
    if not hashes:
        return sha256(b"")
    if len(hashes) == 1:
        return hashes[0]
    k = (len(hashes) + 1) // 2
    return sha256(b"\x01" + root_from_leaves(hashes[:k]) +
                  root_from_leaves(hashes[k:]))


def merkle_root(items: list) -> bytes:
    return root_from_leaves([leaf_hash(i) for i in items])


def address(pub: bytes) -> bytes:
    return sha256(pub)[:20]


def set_order(pubs: list) -> list:
    """Indices of `pubs` in validator-set order (sorted by address)."""
    return sorted(range(len(pubs)), key=lambda i: address(pubs[i]))


def validators_hash(pubs: list, powers: list) -> bytes:
    """Merkle root over lp(pubkey) || i64(power), in set order."""
    return merkle_root([lp(pubs[i]) + i64(powers[i])
                        for i in set_order(pubs)])


def block_id_bytes(block_hash: bytes, parts_total: int,
                   parts_hash: bytes) -> bytes:
    return lp(block_hash) + u32(parts_total) + lp(parts_hash)


def part_set_header(data: bytes) -> tuple:
    """(parts total, parts root) of a block's wire bytes."""
    chunks = [data[i:i + PART_SIZE]
              for i in range(0, len(data), PART_SIZE)] or [b""]
    return len(chunks), root_from_leaves([leaf_hash(c) for c in chunks])


def vote_row(address: bytes, index: int, height: int, block_id: bytes,
             sig: bytes) -> bytes:
    """A present precommit slot of a commit on the wire: flag 1, the
    vote (address, index, height, round 0, type, block ID, signature)."""
    return (u8(1) + lp(address) + u32(index) + u64(height) + u32(0) +
            u8(TYPE_PRECOMMIT) + block_id + lp(sig))


def last_commit(height: int, last_id: tuple, addresses: list,
                sigs) -> tuple:
    """(wire bytes, hash) of the last commit the block at `height`
    carries: every validator's precommit for `last_id` (block hash, parts
    total, parts hash) at `height` - 1 with its signature `sigs[i]`
    (uint8[V, 64], in set order); height 1 carries the empty commit.
    The hash is the Merkle root of the signatures."""
    bid = block_id_bytes(*last_id)
    if height == 1:
        return bid + u32(0), b""
    rows = [sigs[i].tobytes() for i in range(len(addresses))]
    wire = bid + u32(len(rows)) + b"".join(
        vote_row(a, i, height - 1, bid, s)
        for i, (a, s) in enumerate(zip(addresses, rows)))
    return wire, merkle_root(rows)


def make_block(chain_id: str, height: int, time_ns: int, txs: list,
               last_id: tuple, vals_hash: bytes, app_hash: bytes,
               commit: tuple) -> tuple:
    """(wire bytes, block hash) of the block at `height`: header, txs, and
    `commit`, the (wire bytes, hash) of its last commit for `last_id`
    (block hash, parts total, parts hash), from `last_commit`."""
    last_bid = block_id_bytes(*last_id)
    data_hash = merkle_root(txs)
    commit_wire, commit_hash = commit
    fields = {
        "app": app_hash, "chain_id": chain_id.encode(), "data": data_hash,
        "height": u64(height), "last_block_id": last_bid,
        "last_commit": commit_hash, "num_txs": u64(len(txs)),
        "time": i64(time_ns), "validators": vals_hash}
    block_hash = merkle_root([lp(k.encode()) + lp(fields[k])
                              for k in sorted(fields)])
    header = (lp(chain_id.encode()) + u64(height) + i64(time_ns) +
              u64(len(txs)) + last_bid + lp(commit_hash) + lp(data_hash) +
              lp(vals_hash) + lp(app_hash))
    body = u32(len(txs)) + b"".join(lp(tx) for tx in txs)
    return header + body + commit_wire, block_hash


def sign_bytes(chain_id: str, heights, block_hashes, parts_hashes,
               parts_totals) -> np.ndarray:
    """uint8[N, 128] precommit sign bytes, round 0: magic "TMS1", type,
    sha256(chain id), height, round, block hash, parts hash, parts total,
    pol round + 1 (0 for votes)."""
    n = len(heights)
    out = np.zeros((n, SIGN_BYTES_LEN), np.uint8)
    out[:, 0:4] = np.frombuffer(b"TMS1", np.uint8)
    out[:, 4] = TYPE_PRECOMMIT
    out[:, 8:40] = np.frombuffer(sha256(chain_id.encode()), np.uint8)
    out[:, 40:48] = np.asarray(heights, ">u8").view(np.uint8).reshape(n, 8)
    out[:, 52:84] = block_hashes
    out[:, 84:116] = parts_hashes
    out[:, 116:120] = np.asarray(parts_totals, ">u4").view(
        np.uint8).reshape(n, 4)
    return out


class KVStore:
    """The kvstore app's state hash: txs are key=value (or value alone,
    its own key); keys fall into 256 buckets by sha256(key)[0]; a bucket's
    digest is sha256 over its sorted lp32(key) || lp32(value); the app
    hash after `height` commits is sha256(the 256 digests || u64(height))
    cut to 20 bytes.  Each bucket keeps its keys sorted and their records
    beside them; the buckets a block wrote are digested once, at its
    commit, which is all the app hash reads."""

    def __init__(self):
        self.keys = [[] for _ in range(KV_BUCKETS)]
        self.recs = [[] for _ in range(KV_BUCKETS)]
        self.digests = [bytes(32)] * KV_BUCKETS
        self.dirty = set()
        self.height = 0

    def deliver(self, tx: bytes) -> None:
        k, v = tx.split(b"=", 1) if b"=" in tx else (tx, tx)
        b = sha256(k)[0]
        keys, recs = self.keys[b], self.recs[b]
        i = bisect.bisect_left(keys, k)
        rec = u32(len(k)) + k + u32(len(v)) + v
        if i < len(keys) and keys[i] == k:
            recs[i] = rec
        else:
            keys.insert(i, k)
            recs.insert(i, rec)
        self.dirty.add(b)

    def commit(self) -> bytes:
        for b in self.dirty:
            self.digests[b] = sha256(b"".join(self.recs[b]))
        self.dirty.clear()
        self.height += 1
        return sha256(b"".join(self.digests) + u64(self.height))[:20]
