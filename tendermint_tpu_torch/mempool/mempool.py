"""Ordered transaction pool gated by app CheckTx, behind an admission
controller that survives ingress overload.

Copy of `tendermint_tpu/mempool/mempool.py` for the port (reference
`mempool/mempool.go`): CheckTx on the mempool ABCI conn, the LRU dedup
cache, `reap` for proposals, post-commit `update` + recheck, the
height-gated TxsAvailable notification, the lock consensus holds across
app Commit, and the write-ahead journal with `recover_wal`.

Admission control, cheapest gate first: envelope parse -> dedup cache ->
reject-before-verify backpressure (the batch plane's mempool class depth)
-> capacity / priority eviction -> signature verify on the batch plane
the pool was given (ed25519 lanes ride the plane's raw kind, kernel K5 on
`CudaBackend`) -> app CheckTx -> evict + insert.  Every submission lands
in exactly one outcome.

That outcome is counted (the JAX package's metrics): the pool, or
`mempool_rejected{reason}`; every eviction in `mempool_evicted{reason}`;
`mempool_admit_seconds` histograms the admission latency.  Its lock is
the lock witness's "mempool.lock" role (`utils/lockwitness`, on only
when enabled).  Its scalar-verify fallback catches only
`DeviceFault`: the tx is then checked on the native scalar path rather
than rejected.  None of the port's own backends lets one out (a
supervised ladder's floor answers or raises its own error), so the
fallback runs only for a caller's backend that raises it; it is kept for
the JAX package's contract.  Any other failed verify flush (a bare
`CudaBackend`'s build or launch error) raises out of `check_tx`.
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
from collections import OrderedDict

import numpy as np

from tendermint_tpu_torch.abci.types import (ERR_BAD_SIG, ERR_ENCODING,
                                             ERR_MEMPOOL_FULL, Result)
from tendermint_tpu_torch.batchplane import CLASS_MEMPOOL
from tendermint_tpu_torch.crypto import secp256k1
from tendermint_tpu_torch.crypto.supervised import DeviceFault
from tendermint_tpu_torch.types import merkle
from tendermint_tpu_torch.types.keys import PrivKey, _verify_memo
from tendermint_tpu_torch.types.tx import Tx
from tendermint_tpu_torch.utils import lockwitness
from tendermint_tpu_torch.utils.metrics import REGISTRY

# -- signed-tx envelope ----------------------------------------------------
# Optional authenticated tx framing: a tagged prefix carries a fee/priority
# byte, the sender's key and a signature over sha256(priority || payload),
# so the pool can reject forged submissions BEFORE the app sees them — on
# the device batch plane, where concurrent RPC CheckTx lanes coalesce into
# one verify batch.  The signature covers the DIGEST (fixed 32-byte
# message) so every lane shares one compiled shape regardless of payload
# size, and covers the priority byte so a relay cannot bump or slash a
# tx's eviction rank in flight.  Unprefixed txs skip the check entirely
# (the app's own CheckTx still runs) and rank at priority 0.
TAG_ED25519 = 0xE1      # [tag][prio 1][pub 32][sig 64][payload...]
TAG_SECP256K1 = 0xE2    # [tag][prio 1][pub 33][siglen 1][sig][payload...]


def _priority_digest(priority: int, payload: bytes) -> bytes:
    if not 0 <= priority <= 255:
        raise ValueError(f"tx priority {priority} outside 0..255")
    return hashlib.sha256(bytes([priority]) + payload).digest()


def sign_tx_ed25519(seed: bytes, payload: bytes,
                    priority: int = 0) -> bytes:
    """Wrap payload in the ed25519 envelope (test/fixture helper)."""
    priv = PrivKey(seed)
    digest = _priority_digest(priority, payload)
    return (bytes([TAG_ED25519, priority]) + priv.pub_key.bytes_ +
            priv.sign(digest) + payload)


def sign_tx_secp256k1(priv, payload: bytes, priority: int = 0) -> bytes:
    """Wrap payload in the secp256k1 envelope (`PrivKeySecp256k1`)."""
    digest = _priority_digest(priority, payload)
    sig = priv.sign(digest)
    return (bytes([TAG_SECP256K1, priority]) + priv.pub_key.bytes_ +
            bytes([len(sig)]) + sig + payload)


def parse_signed_tx(tx: bytes):
    """(scheme, pub, sig, payload, priority) for enveloped txs, None
    for unsigned.

    Raises ValueError on a malformed envelope: a tx claiming a signature
    scheme must never fall through as unsigned."""
    if not tx or tx[0] not in (TAG_ED25519, TAG_SECP256K1):
        return None
    if tx[0] == TAG_ED25519:
        if len(tx) < 2 + 32 + 64 + 1:
            raise ValueError("ed25519 envelope truncated")
        return ("ed25519", tx[2:34], tx[34:98], tx[98:], tx[1])
    if len(tx) < 2 + 33 + 1 + 1 + 1:
        raise ValueError("secp256k1 envelope truncated")
    siglen = tx[35]
    if siglen == 0 or len(tx) < 2 + 33 + 1 + siglen + 1:
        raise ValueError("secp256k1 envelope truncated")
    return ("secp256k1", tx[2:35], tx[36:36 + siglen],
            tx[36 + siglen:], tx[1])


def tx_priority(tx: bytes) -> int:
    """Fee/priority byte of an enveloped tx; unsigned txs rank 0."""
    parsed = parse_signed_tx(tx)
    return 0 if parsed is None else parsed[4]


# shared rejection Results (callers treat Results as read-only)
_RES_FULL = Result(code=ERR_MEMPOOL_FULL, log="mempool is full")
_RES_BACKPRESSURE = Result(
    code=ERR_MEMPOOL_FULL,
    log="mempool backpressure: verify plane saturated")


class Mempool:
    def __init__(self, proxy_mempool_conn, config=None, wal_path: str = "",
                 *, plane):
        self.proxy = proxy_mempool_conn
        self.plane = plane            # the batch plane signed txs verify on
        cache_size = config.cache_size if config else 100_000
        self.recheck_enabled = config.recheck if config else True
        # admission caps (getattr: a pre-admission MempoolConfig or a
        # bare stub still constructs a working pool on the defaults)
        self.max_txs = getattr(config, "max_txs", 5_000)
        self.max_bytes = getattr(config, "max_bytes", 1_073_741_824)
        self.backpressure_lanes = getattr(config, "backpressure_lanes",
                                          4_096)
        self._txs: OrderedDict[bytes, bytes] = OrderedDict()  # hash -> tx
        self._cache: OrderedDict[bytes, None] = OrderedDict()
        self._cache_size = cache_size
        # re-entrant: update() runs under the lock consensus holds across
        # app Commit, and _prio_floor_locked re-takes it
        self._lock = lockwitness.new_lock("mempool.lock")
        self._height = 0
        self._notified_available = False
        self._txs_available_cb = None
        self._wal_path = wal_path
        self._wal = open(wal_path, "ab") if wal_path else None
        self._recovering = False
        self._notify_cbs: list = []   # gossip wakeups on pool change
        self._tx_heights: dict[bytes, int] = {}   # hash -> admission height
        self._tx_prio: dict[bytes, int] = {}      # hash -> priority byte
        self._bytes = 0                           # resident tx bytes
        # cached min priority over the pool: the O(1) shortcut that lets
        # a full pool shed can't-possibly-fit floods without the O(n)
        # victim scan; recomputed lazily after the floor tx leaves
        self._prio_floor = 0
        self._floor_dirty = True
        # observation hook for eviction audits (eviction-storm records
        # (hash, tx, priority) of every victim); fired under the lock
        self.on_evict = None
        # pre-bound metric cells: CounterVec.labels() takes a lock per
        # call, and the flood-shed path pays it on every rejection
        self._rejected = {r: REGISTRY.mempool_rejected.labels(r)
                          for r in ("encoding", "dup", "full",
                                    "backpressure", "bad_sig", "app")}
        self._evicted_prio = REGISTRY.mempool_evicted.labels("priority")

    def add_notify_cb(self, cb) -> None:
        """Register a zero-arg callback fired whenever the pool gains a
        tx (event-driven gossip instead of polling)."""
        self._notify_cbs.append(cb)

    def remove_notify_cb(self, cb) -> None:
        """Deregister (reactor shutdown must not leak dead callbacks)."""
        try:
            self._notify_cbs.remove(cb)
        except ValueError:
            pass

    def _fire_notify(self) -> None:
        for cb in self._notify_cbs:
            try:
                cb()
            except Exception:
                pass

    # -- locking across app Commit (reference state/execution.go:248) ----
    def lock(self):
        self._lock.acquire()

    def unlock(self):
        self._lock.release()

    # -- ingestion -------------------------------------------------------
    def check_tx(self, tx: bytes, tx_hash: bytes | None = None):
        """Admit via the admission controller + app CheckTx; returns the
        Result or None when the tx is a cache duplicate (reference
        `:166-205`).  Every submission is timed into
        `mempool_admit_seconds` and lands in exactly one outcome.
        `tx_hash`, when the caller already computed it, skips the second
        leaf hash."""
        t0 = time.perf_counter()
        try:
            return self._admit(tx, tx_hash if tx_hash is not None
                               else merkle.leaf_hash(tx))
        finally:
            REGISTRY.mempool_admit_seconds.observe(
                time.perf_counter() - t0)

    def _admit(self, tx: bytes, h: bytes):
        """The admission pipeline, cheapest gate first:

        envelope parse (priority) -> dedup cache -> backpressure
        (reject-before-verify) -> capacity/evictability -> signature
        verify (batch plane) -> app CheckTx -> evict + insert.

        The app call happens UNDER the mempool lock: consensus holds
        this lock across app Commit + update (reference proxyMtx
        semantics), so no tx can validate against a half-committed app
        and then slip into the pool after the recheck pass.  The
        signed-envelope verify runs OUTSIDE the lock (it is app-state
        independent) so concurrent RPC CheckTx lanes coalesce on the
        device batch plane instead of serializing a device round-trip
        each behind the pool lock.  Unsigned txs skip the verify legs
        entirely and resolve in ONE lock section — the flood-shed path
        a saturated pool serves at 100k+/s."""
        try:
            parsed = parse_signed_tx(tx)
        except ValueError as e:
            # malformed envelopes never enter the dedup cache: nothing
            # to uncache, and a resubmission re-parses to the same error
            self._rejected["encoding"].inc()
            return Result(code=ERR_ENCODING,
                          log=f"bad signed-tx envelope: {e}")
        prio = parsed[4] if parsed is not None else 0
        if parsed is not None:
            with self._lock:
                if not self._cache_admit_locked(h):
                    return None
            if self._backpressured():
                # reject BEFORE scheduling the verify: a signature flood
                # must not grow the plane's mempool queue unboundedly
                return self._reject(h, "backpressure", _RES_BACKPRESSURE)
            with self._lock:
                if self._find_victims_locked(len(tx), prio) is None:
                    # full and nothing strictly lower-priority to evict:
                    # reject before paying for the signature verify
                    return self._reject(h, "full", _RES_FULL)
            rej = self._verify_signed(parsed)
            if rej is not None:
                reason = ("bad_sig" if rej.code == ERR_BAD_SIG
                          else "encoding")
                return self._reject(h, reason, rej)
        with self._lock:
            if parsed is None and not self._cache_admit_locked(h):
                return None
            # capacity may have shifted while the verify ran off-lock:
            # re-pick victims under the lock that admits
            victims = self._find_victims_locked(len(tx), prio)
            if victims is None:
                # inline uncache+count (no _reject re-lock): the bulk
                # flood-shed exit, one lock section end to end
                self._cache.pop(h, None)
                self._rejected["full"].inc()
                return _RES_FULL
            res = self.proxy.check_tx(tx)
            if res.is_ok:
                for v in victims:
                    self._evict_locked(v)
                if victims:
                    # journal == surviving pool: a crash after the
                    # eviction must not resurrect the victims
                    self._rewrite_wal()
                if self._wal is not None and not self._recovering:
                    self._wal.write(len(tx).to_bytes(4, "big") + tx)
                    self._wal.flush()
                self._txs[h] = tx
                # reference memTx.Height: the height the tx was validated
                # at — the gossip height-gate keys on THIS, not the pool's
                # moving height (old txs must not be re-gated forever)
                self._tx_heights[h] = self._height + 1
                self._tx_prio[h] = prio
                self._bytes += len(tx)
                if not self._floor_dirty and prio < self._prio_floor:
                    self._prio_floor = prio
                self._set_gauges_locked()
                self._notify_available()
                self._fire_notify()
            else:
                # invalid tx: allow future resubmission (reference :259-264)
                self._cache.pop(h, None)
                self._rejected["app"].inc()
        return res

    def _cache_admit_locked(self, h: bytes) -> bool:
        """Claim `h` in the dedup cache; False (+ counted rejection)
        when it is already there."""
        if h in self._cache:
            self._rejected["dup"].inc()
            return False
        self._cache[h] = None
        while len(self._cache) > self._cache_size:
            self._cache.popitem(last=False)
        return True

    def _reject(self, h: bytes, reason: str, res: Result) -> Result:
        """Uncache + count: a rejected tx is never silently dropped and
        never permanently deduped — a client may resubmit once load
        drops (or with the signature fixed)."""
        with self._lock:
            self._cache.pop(h, None)
        self._rejected[reason].inc()
        return res

    # -- admission control ----------------------------------------------
    def _backpressured(self) -> bool:
        return (self.backpressure_lanes > 0 and
                self.plane.class_depth(CLASS_MEMPOOL)
                >= self.backpressure_lanes)

    def _prio_floor_locked(self) -> int:
        with self._lock:         # re-entrant; callers already hold it
            if self._floor_dirty:
                self._prio_floor = min(self._tx_prio.values(), default=0)
                self._floor_dirty = False
            return self._prio_floor

    def _find_victims_locked(self, nbytes: int, prio: int):
        """Eviction plan admitting a `prio` tx of `nbytes`: [] when it
        fits outright, the lowest-priority-oldest victim hashes when
        evicting strictly lower-priority txs makes room, None when the
        tx must be rejected (nothing evictable outranks it).  Priority
        inversion is impossible by construction: victims are consumed
        in (priority, insertion-order) order and only while < prio."""
        slots_full = (self.max_txs > 0
                      and len(self._txs) + 1 > self.max_txs)
        bytes_full = (self.max_bytes > 0
                      and self._bytes + nbytes > self.max_bytes)
        if not (slots_full or bytes_full):
            return []
        if prio <= self._prio_floor_locked():
            return None          # O(1) shed: nothing in the pool ranks lower
        victims: list[bytes] = []
        vbytes = 0
        candidates = sorted(
            ((self._tx_prio.get(hh, 0), i, hh)
             for i, hh in enumerate(self._txs)),
            key=lambda t: (t[0], t[1]))
        for p, _, hh in candidates:
            if p >= prio:
                break
            victims.append(hh)
            vbytes += len(self._txs[hh])
            slots_ok = (self.max_txs <= 0 or
                        len(self._txs) - len(victims) + 1 <= self.max_txs)
            bytes_ok = (self.max_bytes <= 0 or
                        self._bytes - vbytes + nbytes <= self.max_bytes)
            if slots_ok and bytes_ok:
                return victims
        return None

    def _evict_locked(self, h: bytes) -> None:
        tx = self._txs.pop(h)
        self._bytes -= len(tx)
        p = self._tx_prio.pop(h, 0)
        if p <= self._prio_floor:
            self._floor_dirty = True
        self._tx_heights.pop(h, None)
        # evicted != committed: the dedup cache entry goes too, so a
        # legitimate sender can resubmit once there is room
        self._cache.pop(h, None)
        self._evicted_prio.inc()
        if self.on_evict is not None:
            try:
                self.on_evict(h, tx, p)
            except Exception:
                pass

    def _set_gauges_locked(self) -> None:
        REGISTRY.mempool_size.set(len(self._txs))
        REGISTRY.mempool_bytes.set(self._bytes)

    def _verify_signed(self, parsed):
        """Envelope signature gate: None when tx may proceed to the app,
        else the rejecting `Result`.  Lanes ride the batch plane in the
        mempool class (preempted by consensus votes); a `DeviceFault`
        that survives the supervised ladder falls back to the scalar
        verifier rather than rejecting a possibly-valid tx, and any other
        failed flush raises out of `check_tx`."""
        if parsed is None:
            return None
        scheme, pub, sig, payload, prio = parsed
        digest = _priority_digest(prio, payload)
        if scheme == "secp256k1":
            if not secp256k1.AVAILABLE:
                return Result(code=ERR_ENCODING,
                              log="secp256k1 support unavailable")
            ok = bool(self.plane.verify_secp(
                [(pub, digest, sig)], producer="mempool",
                klass=CLASS_MEMPOOL)[0])
        else:
            try:
                ok = bool(self.plane.verify_batch(
                    np.frombuffer(pub, np.uint8).reshape(1, 32),
                    np.frombuffer(digest, np.uint8).reshape(1, 32),
                    np.frombuffer(sig, np.uint8).reshape(1, 64),
                    producer="mempool", klass=CLASS_MEMPOOL)[0])
            except DeviceFault:
                ok = _verify_memo(pub, digest, sig)
        if not ok:
            return Result(code=ERR_BAD_SIG,
                          log=f"invalid {scheme} tx signature")
        return None

    def _notify_available(self):
        if (self._txs_available_cb is not None and
                not self._notified_available and self._txs):
            self._notified_available = True
            self._txs_available_cb(self._height + 1)

    def set_txs_available_callback(self, cb):
        """Height-gated fire-once-per-height notification
        (reference `:99-104,277-294`)."""
        self._txs_available_cb = cb

    # -- WAL recovery (SURVEY §5 checkpoint layer 5) ----------------------
    def recover_wal(self, committed=None) -> int:
        """Re-admit journalled txs after a crash (call once at boot, after
        the app handshake restored app state).  Entries are re-run through
        CheckTx; `committed` (tx_bytes -> bool), when given, drops journal
        entries already committed to a block (e.g. via the tx index) so a
        crash between block commit and journal compaction does not re-admit
        them — apps whose CheckTx accepts anything (kvstore) would
        otherwise see at-least-once redelivery.  Without `committed` the
        contract IS at-least-once: the app's CheckTx must reject replays
        of committed txs.  A torn tail is truncated.  Returns the number
        of txs re-admitted."""
        if not self._wal_path:
            return 0
        try:
            with open(self._wal_path, "rb") as f:
                data = f.read()
        except FileNotFoundError:
            return 0
        txs, off = [], 0
        while off + 4 <= len(data):
            n = int.from_bytes(data[off:off + 4], "big")
            if off + 4 + n > len(data):
                break                      # torn tail from a mid-write crash
            txs.append(data[off + 4:off + 4 + n])
            off += 4 + n
        readmitted = 0
        self._recovering = True
        try:
            for tx in txs:
                if committed is not None and committed(tx):
                    with self._lock:
                        # permanently dedupe, like update(): a peer
                        # gossiping or a client rebroadcasting this tx
                        # after the restart must not re-admit it either
                        self._cache[Tx(tx).hash] = None
                    continue
                res = self.check_tx(tx)
                if res is not None and res.is_ok:
                    readmitted += 1
        finally:
            self._recovering = False
        with self._lock:
            self._rewrite_wal()
        return readmitted

    # -- queries ---------------------------------------------------------
    def size(self) -> int:
        with self._lock:
            return len(self._txs)

    def size_bytes(self) -> int:
        """Resident tx bytes (the max_bytes cap's numerator)."""
        with self._lock:
            return self._bytes

    def height(self) -> int:
        """Last committed height this pool was updated to (gossip gate)."""
        return self._height

    def reap(self, max_txs: int) -> list[bytes]:
        """First N txs in order for a proposal (reference `:298-324`)."""
        with self._lock:
            out = []
            for tx in self._txs.values():
                if 0 <= max_txs <= len(out):
                    break
                out.append(tx)
            return out

    def txs_after(self, n: int) -> list[bytes]:
        """Gossip helper: txs from position n onward."""
        with self._lock:
            return list(self._txs.values())[n:]

    def txs_with_heights(self) -> list[tuple[bytes, bytes, int]]:
        """Gossip helper: (hash, tx, admission height) triples in pool
        order — the hash rides along so broadcast sweeps need not
        recompute it per tx per peer."""
        with self._lock:
            return [(h, tx, self._tx_heights.get(h, 0))
                    for h, tx in self._txs.items()]

    # -- post-commit -----------------------------------------------------
    def update(self, height: int, committed_txs: list[bytes]) -> None:
        """Drop committed txs, recheck the rest (reference `:329-391`).
        Caller (apply_block) already holds the lock; _lock is an RLock,
        so taking it again here is free — and keeps the pool consistent
        if update is ever reached without the outer lock()."""
        with self._lock:
            self._height = height
            self._notified_available = False
            for tx in committed_txs:
                h = Tx(tx).hash
                if self._txs.pop(h, None) is not None:
                    self._bytes -= len(tx)
                self._tx_heights.pop(h, None)
                self._tx_prio.pop(h, None)
                self._cache[h] = None   # committed: permanently deduped
            if self.recheck_enabled and self._txs:
                survivors = OrderedDict()
                for h, tx in self._txs.items():
                    if self.proxy.check_tx(tx).is_ok:
                        survivors[h] = tx
                    else:
                        self._tx_heights.pop(h, None)
                        self._tx_prio.pop(h, None)
                        self._bytes -= len(tx)
                self._txs = survivors
            self._floor_dirty = True
            self._set_gauges_locked()
            # compact the journal to the surviving pool: committed txs
            # must not be re-admitted (re-EXECUTED) by recover_wal
            self._rewrite_wal()
            if self._txs:
                self._notify_available()

    def _rewrite_wal(self) -> None:
        """Atomically rewrite the journal to exactly the current pool
        (temp + rename: a crash mid-rewrite leaves the old journal, whose
        extra entries are merely re-checked, never the empty file a
        truncate-in-place would)."""
        if not self._wal_path:
            return
        if self._wal is not None:
            self._wal.close()
        tmp = self._wal_path + ".tmp"
        with open(tmp, "wb") as f:
            for tx in self._txs.values():
                f.write(len(tx).to_bytes(4, "big") + tx)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._wal_path)
        self._wal = open(self._wal_path, "ab")

    def flush(self) -> None:
        with self._lock:
            self._txs.clear()
            self._tx_heights.clear()
            self._tx_prio.clear()
            self._cache.clear()
            self._bytes = 0
            self._floor_dirty = True
            self._set_gauges_locked()
            self._rewrite_wal()   # journal == pool, or recovery resurrects

    def close(self) -> None:
        if self._wal is not None:
            self._wal.close()
