"""Snapshot offer/fetch/verify: the recovering node's side.

The trust chain, in order:

1. **Offer selection** — every source advertises its manifests; offers
   group by `(height, format, root, app_hash)` and the best group is the
   highest height (more providers breaks ties).  A manifest is only an
   OFFER — nothing in it is trusted yet.
2. **Light-client cross-check** — the caller supplies `verify_offer`,
   typically `verify_manifest_app_hash` over a light-client-verified
   header at `height+1` (whose `app_hash` field commits to the app
   state AFTER block `height` — exactly what the snapshot restores).
   An offer that fails the cross-check is a PROVEN lie: every provider
   is reported with `ban=True` and the next-best offer is tried.
3. **Chunk verification** — chunks fetched from the group's providers
   in parallel, then every hash verified in one batched call through the
   syncer's backend before a single byte reaches the app.  A bad chunk
   blames its serving peer (misbehavior score / ban via `p2p/switch.py`)
   and is refetched from another provider; a group that cannot complete
   falls through to the next offer, and a syncer that exhausts all
   offers raises `RestoreError` — the caller's cue to fall back to full
   fast-sync.
4. **Decode + apply** — payload re-roots, `State` decodes, heights and
   app hashes must agree, the app restores and (when it reports one)
   its recomputed app hash must equal the manifest's.

After `restore()` the caller replays only `snapshot_height -> tip`
through the existing windowed fast-sync (the block store is
bootstrapped at the snapshot height so the reactor's request window
starts there, not at genesis).

Copy of `tendermint_tpu/statesync/restore.py`; the chunk checks take the
backend given to `StateSyncer(backend=)` (`snapshot.hash_chunks`).
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor

from tendermint_tpu_torch.state.state import State
from tendermint_tpu_torch.statesync.snapshot import (SnapshotManifest,
                                                     SnapshotStore,
                                                     decode_payload,
                                                     verify_chunk_hashes)
from tendermint_tpu_torch.types import merkle as hmerkle
from tendermint_tpu_torch.utils.log import get_logger
from tendermint_tpu_torch.utils.metrics import REGISTRY

log = get_logger("statesync")

DEFAULT_FETCHERS = 4


class RestoreError(Exception):
    """No offer could be restored; the caller falls back to full
    fast-sync from genesis."""


class StoreSource:
    """Rig-level chunk source: a peer's SnapshotStore behind a peer id.
    The TCP equivalent speaks `statesync/messages.py` over channel 0x60;
    both shapes expose the same two methods, which is all the syncer
    needs."""

    def __init__(self, peer_id: str, store: SnapshotStore):
        self.peer_id = peer_id
        self.store = store

    def manifests(self) -> list[SnapshotManifest]:
        return self.store.list()

    def chunk(self, height: int, index: int) -> bytes | None:
        return self.store.load_chunk(height, index)


def verify_manifest_app_hash(manifest: SnapshotManifest, header) -> bool:
    """The light-client cross-check: `header` is a VERIFIED header at
    `manifest.height + 1`; its app_hash commits to the app state after
    block `manifest.height` — the state this snapshot claims to hold."""
    return (header.height == manifest.height + 1
            and header.app_hash == manifest.app_hash)


class StateSyncer:
    def __init__(self, sources: list, *, report_misbehavior=None,
                 verify_offer=None, fetchers: int = DEFAULT_FETCHERS,
                 backend=None):
        """`sources`: ChunkSource-shaped objects (peer_id, manifests(),
        chunk()).  `report_misbehavior(peer_id, reason, *, ban=...)`
        feeds the p2p switch's scoring (pass the bound method of a live
        Switch, or a recorder in tests).  `verify_offer(manifest) ->
        bool` is the light-client cross-check hook; offers failing it
        are discarded WITH blame.  `backend` hashes each fetch's chunks
        in one batched call (`snapshot.hash_chunks`)."""
        if not sources:
            raise ValueError("StateSyncer needs at least one source")
        self.sources = list(sources)
        self.report = report_misbehavior
        self.verify_offer = verify_offer
        self.fetchers = max(1, fetchers)
        self.backend = backend
        self.blamed: list[tuple[str, str]] = []   # (peer_id, reason)

    # -- offers ---------------------------------------------------------
    def offers(self) -> list[tuple[SnapshotManifest, list]]:
        """Offer groups best-first: [(manifest, [sources])] sorted by
        height desc, provider count desc.  A source whose manifests()
        raises is skipped — unreachable is not malicious."""
        groups: dict[tuple, tuple[SnapshotManifest, list]] = {}
        for src in self.sources:
            try:
                ms = src.manifests()
            except Exception:
                log.exception("snapshot source unreachable",
                              peer=src.peer_id)
                continue
            for m in ms:
                key = m.key()
                if key not in groups:
                    groups[key] = (m, [])
                groups[key][1].append(src)
        return sorted(groups.values(),
                      key=lambda g: (g[0].height, len(g[1])),
                      reverse=True)

    def _blame(self, peer_id: str, reason: str, ban: bool) -> None:
        self.blamed.append((peer_id, reason))
        log.warn("statesync blame", peer=peer_id, reason=reason, ban=ban)
        if self.report is not None:
            self.report(peer_id, reason, ban=ban)

    # -- chunk fetch + verify -------------------------------------------
    def _fetch_verified(self, manifest: SnapshotManifest,
                        providers: list) -> list[bytes] | None:
        """All chunks of `manifest`, every hash verified.  Providers
        serve interleaved in parallel; a bad or missing chunk rotates to
        the next provider (bad → blame + ban).  None when the group is
        exhausted with chunks still unverified."""
        n = manifest.chunks
        chunks: dict[int, bytes] = {}
        served: dict[int, object] = {}
        banned: set[str] = set()
        lock = threading.Lock()
        order = list(providers)

        def fetch(idx: int, src) -> None:
            try:
                c = src.chunk(manifest.height, idx)
            except Exception:
                c = None
            if c is not None:
                with lock:
                    chunks[idx] = c
                    served[idx] = src

        attempts = 0
        pending = list(range(n))
        while pending and attempts < len(order) + 1:
            live = [s for s in order if s.peer_id not in banned]
            if not live:
                return None
            with ThreadPoolExecutor(
                    min(self.fetchers, len(pending))) as pool:
                futs = [pool.submit(fetch, idx, live[k % len(live)])
                        for k, idx in enumerate(pending)]
                for f in futs:
                    f.result()
            fetched = {i: chunks[i] for i in pending if i in chunks}
            bad = set(verify_chunk_hashes(fetched, manifest.chunk_hashes,
                                          self.backend))
            for idx in sorted(bad):
                src = served.pop(idx)
                chunks.pop(idx, None)
                self._blame(
                    src.peer_id,
                    f"statesync: bad chunk {idx} of snapshot "
                    f"h={manifest.height} (hash mismatch)", ban=True)
                banned.add(src.peer_id)
            still_missing = [i for i in pending if i not in chunks]
            if not still_missing:
                break
            # rotate so a refetch lands on a different provider
            order = order[1:] + order[:1]
            pending = still_missing
            attempts += 1
        if len(chunks) != n:
            return None
        return [chunks[i] for i in range(n)]

    # -- restore --------------------------------------------------------
    def restore(self, db, genesis_doc, app) -> tuple[State,
                                                     SnapshotManifest]:
        """Walk offers best-first until one restores; returns the saved
        State (bound to `db`) and the manifest it came from.  Raises
        RestoreError when every offer fails."""
        t0 = time.time()
        tried = 0
        for manifest, providers in self.offers():
            tried += 1
            if self.verify_offer is not None and \
                    not self.verify_offer(manifest):
                for src in providers:
                    self._blame(
                        src.peer_id,
                        f"statesync: manifest h={manifest.height} "
                        f"app_hash fails the light-client cross-check "
                        f"(stale or forged snapshot)", ban=True)
                continue
            chunks = self._fetch_verified(manifest, providers)
            if chunks is None:
                log.warn("snapshot offer exhausted",
                         height=manifest.height,
                         providers=[s.peer_id for s in providers])
                continue
            try:
                state = self._apply(manifest, chunks, db, genesis_doc,
                                    app)
            except ValueError as e:
                # verified chunks that still decode wrong mean the
                # MANIFEST lied coherently; every provider is in on it
                for src in providers:
                    self._blame(src.peer_id,
                                f"statesync: snapshot h="
                                f"{manifest.height} failed apply: {e}",
                                ban=True)
                continue
            dt = time.time() - t0
            REGISTRY.snapshot_restore_seconds.observe(dt)
            log.info("snapshot restored", height=manifest.height,
                     chunks=manifest.chunks, seconds=round(dt, 3))
            return state, manifest
        raise RestoreError(
            f"no snapshot offer could be restored ({tried} tried); "
            f"fall back to full fast-sync")

    @staticmethod
    def _apply(manifest: SnapshotManifest, chunks: list[bytes], db,
               genesis_doc, app) -> State:
        """Decode + cross-check + hand the app its state.  Every check
        here is against material already hash-verified, so a failure
        indicts the manifest, not the transport."""
        payload = b"".join(chunks)
        # belt-and-braces: re-root the payload we are about to trust
        hashes = [hmerkle.leaf_hash(c) for c in chunks]
        if hmerkle.root_from_leaf_hashes(hashes) != manifest.root:
            raise ValueError("assembled payload does not re-root")
        state_bytes, app_state = decode_payload(payload)
        state = State.decode_bytes(state_bytes, db=db,
                                   genesis_doc=genesis_doc)
        if state.chain_id != genesis_doc.chain_id:
            raise ValueError(
                f"snapshot chain_id {state.chain_id!r} != genesis "
                f"{genesis_doc.chain_id!r}")
        if state.last_block_height != manifest.height:
            raise ValueError(
                f"snapshot state height {state.last_block_height} != "
                f"manifest height {manifest.height}")
        if state.app_hash != manifest.app_hash:
            raise ValueError("snapshot state app_hash != manifest "
                             "app_hash")
        app.restore_state(app_state)
        info = app.info()
        got = getattr(info, "last_block_app_hash", b"") or b""
        if got and got != manifest.app_hash:
            raise ValueError(
                f"restored app recomputes app_hash {got.hex()[:16]} != "
                f"manifest {manifest.app_hash.hex()[:16]}")
        state.save()
        return state
