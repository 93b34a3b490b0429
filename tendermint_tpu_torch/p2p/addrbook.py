"""AddrBook: known-peer address book with new/old buckets.

Reference: `p2p/addrbook.go:21-60` (btcd-derived) — addresses live in
hashed buckets (256 "new" for unvetted, 64 "old" for proven), eviction is
randomized within a full bucket, the book persists to JSON periodically
and on close.  This implementation keeps the bucket structure and
good/bad promotion semantics at a fraction of the size.

Abuse resistance: a NEW address's bucket is derived from BOTH the /16
group of the address and the /16 group of the peer that reported it
(reference `p2p/addrbook.go` calcNewBucket) — a single gossip source can
therefore occupy at most a handful of buckets no matter how many
addresses it invents, and eviction pressure stays confined there.  OLD
buckets key on the address group alone (proven peers vouch for
themselves).

Copy of `tendermint_tpu/p2p/addrbook.py`.  The book draws every random
choice (eviction, demotion, picks, samples) from the `random.Random` its
caller passes, where the JAX book makes its own unseeded one.
"""

from __future__ import annotations

import hashlib
import json
import os
import random
import threading
import time

from tendermint_tpu_torch.p2p.types import NetAddress

NEW_BUCKETS = 256
OLD_BUCKETS = 64
BUCKET_SIZE = 64
NEW_BUCKETS_PER_SRC = 8   # reference p2p/addrbook.go newBucketsPerGroup
MAX_FAILURES = 10         # reference numRetries/maxFailures isBad() bound
STALE_AFTER = 30 * 24 * 3600.0   # attempts older than this are expirable


class _Entry:
    __slots__ = ("addr", "src", "attempts", "last_attempt", "last_success",
                 "old", "bucket")

    def __init__(self, addr: NetAddress, src: str):
        self.addr = addr
        self.src = src
        self.attempts = 0
        self.last_attempt = 0.0
        self.last_success = 0.0
        self.old = False
        self.bucket = 0

    def to_json(self) -> dict:
        return {"addr": str(self.addr), "src": self.src,
                "attempts": self.attempts, "old": self.old,
                "last_success": self.last_success,
                "last_attempt": self.last_attempt}

    @classmethod
    def from_json(cls, d: dict) -> "_Entry":
        e = cls(NetAddress.parse(d["addr"]), d.get("src", ""))
        e.attempts = int(d.get("attempts", 0))
        e.old = bool(d.get("old", False))
        e.last_success = float(d.get("last_success", 0.0))
        e.last_attempt = float(d.get("last_attempt", 0.0))
        return e


class AddrBook:
    def __init__(self, path: str = "", our_addrs: set[str] | None = None,
                 *, rng: random.Random):
        self.path = path
        self._entries: dict[str, _Entry] = {}     # key: host:port
        self._our = our_addrs or set()
        self._lock = threading.Lock()
        self.rng = rng
        if path and os.path.exists(path):
            self._load()

    # -- bucket math (structure parity; buckets are implicit partitions) --
    @staticmethod
    def _group(host: str) -> str:
        """/16-style group: first two dotted components (or the whole
        host for names) — the poisoning-resistance granularity."""
        return ".".join(host.split(".")[:2])

    @classmethod
    def _new_bucket_of(cls, key: str, src: str) -> int:
        """Two-stage btcd hash: the address group picks one of
        NEW_BUCKETS_PER_SRC slots, then (source group, slot) picks the
        bucket — so a source GROUP reaches at most NEW_BUCKETS_PER_SRC
        buckets total, no matter how many addresses it invents."""
        host = key.rsplit(":", 1)[0]
        src_host = src.rsplit(":", 1)[0] if src else ""
        ag, sg = cls._group(host), cls._group(src_host)
        slot = int.from_bytes(
            hashlib.sha256((ag + "|" + sg).encode()).digest()[:2],
            "big") % NEW_BUCKETS_PER_SRC
        h = hashlib.sha256((sg + "|" + str(slot)).encode()).digest()
        return int.from_bytes(h[:2], "big") % NEW_BUCKETS

    @classmethod
    def _old_bucket_of(cls, key: str) -> int:
        host = key.rsplit(":", 1)[0]
        h = hashlib.sha256(cls._group(host).encode()).digest()
        return int.from_bytes(h[:2], "big") % OLD_BUCKETS

    def _bucket_members(self, bucket: int, old: bool) -> list[_Entry]:
        return [e for e in self._entries.values()
                if e.old == old and e.bucket == bucket]

    @staticmethod
    def _is_bad(e: _Entry, now: float) -> bool:
        """Expirable under pressure (reference `isBad`): repeatedly
        failed and never proven, or untouched for a month."""
        if e.last_success == 0.0 and e.attempts >= MAX_FAILURES:
            return True
        ref = max(e.last_attempt, e.last_success)
        return ref != 0.0 and now - ref > STALE_AFTER

    # -- mutation -------------------------------------------------------
    def add_address(self, addr: NetAddress, src: str = "") -> bool:
        key = addr.dial_string()
        if key in self._our or not addr.port:
            return False
        with self._lock:
            if key in self._entries:
                return False
            e = _Entry(addr, src)
            e.bucket = self._new_bucket_of(key, src)
            members = self._bucket_members(e.bucket, old=False)
            if len(members) >= BUCKET_SIZE:
                # expire a provably-bad entry first (reference expireNew);
                # only healthy-looking buckets lose a RANDOM member
                now = time.time()
                bad = [m for m in members if self._is_bad(m, now)]
                evict = (self.rng.choice(bad) if bad
                         else self.rng.choice(members))
                self._entries.pop(evict.addr.dial_string(), None)
            self._entries[key] = e
            return True

    def mark_attempt(self, addr: NetAddress) -> None:
        with self._lock:
            e = self._entries.get(addr.dial_string())
            if e is not None:
                e.attempts += 1
                e.last_attempt = time.time()

    def mark_good(self, addr: NetAddress) -> None:
        """Promote to an old bucket (proven peer)."""
        with self._lock:
            e = self._entries.get(addr.dial_string())
            if e is None:
                e = _Entry(addr, "")
                self._entries[addr.dial_string()] = e
            e.attempts = 0
            e.last_success = time.time()
            if not e.old:
                bucket = self._old_bucket_of(addr.dial_string())
                members = self._bucket_members(bucket, old=True)
                if len(members) >= BUCKET_SIZE:
                    demote = self.rng.choice(members)
                    demote.old = False
                    demote.bucket = self._new_bucket_of(
                        demote.addr.dial_string(), demote.src)
                e.old = True
                e.bucket = bucket

    def mark_bad(self, addr: NetAddress) -> None:
        with self._lock:
            self._entries.pop(addr.dial_string(), None)

    # -- selection ------------------------------------------------------
    def pick_address(self, new_bias: float = 0.5) -> NetAddress | None:
        """Random address, biased between new/old pools
        (reference PickAddress bias parameter)."""
        with self._lock:
            news = [e for e in self._entries.values() if not e.old]
            olds = [e for e in self._entries.values() if e.old]
            pool = None
            if news and (not olds or self.rng.random() < new_bias):
                pool = news
            elif olds:
                pool = olds
            if not pool:
                return None
            return self.rng.choice(pool).addr

    def sample(self, n: int = 10) -> list[NetAddress]:
        with self._lock:
            entries = list(self._entries.values())
        self.rng.shuffle(entries)
        return [e.addr for e in entries[:n]]

    def size(self) -> int:
        with self._lock:
            return len(self._entries)

    def has(self, addr: NetAddress) -> bool:
        with self._lock:
            return addr.dial_string() in self._entries

    # -- persistence ----------------------------------------------------
    def save(self) -> None:
        if not self.path:
            return
        with self._lock:
            data = [e.to_json() for e in self._entries.values()]
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"addrs": data}, f)
        os.replace(tmp, self.path)

    def _load(self) -> None:
        try:
            with open(self.path) as f:
                data = json.load(f)
            for d in data.get("addrs", []):
                e = _Entry.from_json(d)
                key = e.addr.dial_string()
                e.bucket = (self._old_bucket_of(key) if e.old
                            else self._new_bucket_of(key, e.src))
                self._entries[key] = e
        except (OSError, ValueError, KeyError):
            pass                         # corrupt book: start fresh
