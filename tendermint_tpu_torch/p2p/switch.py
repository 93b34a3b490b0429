"""Switch: peer lifecycle + reactor registry + channel routing.

Reference: `p2p/switch.go:60-131` — reactors register channel
descriptors; `AddPeer` runs the filter/handshake/start pipeline
(`:206-253`); `Broadcast` try-sends to every peer (`:368-380`);
persistent peers reconnect with exponential backoff (`:402-434`);
`MakeConnectedSwitches` (`:495-543`) is the in-process net harness the
test suite builds multi-node consensus on.

Copy of `tendermint_tpu/p2p/switch.py` (its peer, reconnect and eviction
metrics kept), its four locks `utils/lockwitness` roles (`switch.peers`,
`.threads`, `.ban`, `.reconnect_rng`).  Seeds come from the caller, not
from an installed chaos config: the reconnect jitter draws from a
`random.Random` seeded with `derive_seed(chaos_seed, "p2p.reconnect",
node id)`, and with
`config.fuzz` the i-th link this switch wraps in a `FuzzedConnection`
(`p2p/fuzz.py`) is seeded with `derive_seed(chaos_seed, "p2p.fuzz",
str(i))` from the switch's own link counter (the JAX package counts
links process-wide).  `chaos_seed` defaults to 0, as the JAX package's
seed is without an installed config.  A fault of
this node on a well-formed message (a device or plane fault out of a
reactor's `receive`, see `connection.py`) is kept as `fault`, blames no
peer, and
`stop()` raises it, as it raises the first error of a reactor's `stop()`.
"""

from __future__ import annotations

import random
import struct
import threading
import time

from tendermint_tpu_torch.p2p import transport
from tendermint_tpu_torch.p2p.connection import MConnection
from tendermint_tpu_torch.p2p.fuzz import FuzzedConnection, derived_seed
from tendermint_tpu_torch.p2p.peer import Peer, Reactor
from tendermint_tpu_torch.p2p.secret import SecretConnection
from tendermint_tpu_torch.p2p.types import NetAddress, NodeInfo
from tendermint_tpu_torch.types.keys import PrivKey
from tendermint_tpu_torch.utils import chaos as chaosmod
from tendermint_tpu_torch.utils import lockwitness
from tendermint_tpu_torch.utils.log import get_logger
from tendermint_tpu_torch.utils.metrics import REGISTRY

log = get_logger("p2p")

# Reconnect limits (defaults when the switch has no P2PConfig).  The
# attempt cap and the sleep ceiling are SEPARATE knobs: the old code's
# single RECONNECT_BACKOFF_MAX=16 was consumed as an attempt count while
# its name (and the reference reconnectToPeer) meant a seconds cap, so
# neither limit actually held.
RECONNECT_MAX_ATTEMPTS = 16
RECONNECT_BACKOFF_BASE_S = 1.0
RECONNECT_BACKOFF_MAX_S = 32.0
RECONNECT_JITTER_FRAC = 0.2

# misbehavior defaults (P2PConfig.misbehavior_* override)
MISBEHAVIOR_BAN_SCORE = 3.0
MISBEHAVIOR_BAN_WINDOW_S = 30.0

DEFAULT_MAX_PEERS = 50


def backoff_delay(attempt: int, rng,
                  base_s: float = RECONNECT_BACKOFF_BASE_S,
                  max_s: float = RECONNECT_BACKOFF_MAX_S,
                  jitter_frac: float = RECONNECT_JITTER_FRAC) -> float:
    """Sleep before reconnect `attempt` (0-based): exponential from
    base_s, capped at max_s seconds, with ±jitter_frac multiplicative
    jitter drawn from `rng` so the healed side of a partition doesn't
    thundering-herd every dialer onto the same instant."""
    capped = min(base_s * (2.0 ** attempt), max_s)
    if jitter_frac <= 0.0:
        return capped
    return capped * (1.0 - jitter_frac + 2.0 * jitter_frac * rng.random())


class SwitchError(Exception):
    pass


class Switch:
    def __init__(self, node_key: PrivKey, node_info: NodeInfo, config=None,
                 chaos_seed: int = 0):
        self.node_key = node_key
        self.node_info = node_info
        self.config = config
        self._reactors: dict[str, Reactor] = {}
        self._reactors_by_ch: dict[int, Reactor] = {}
        self._chan_descs: list = []
        self._peers: dict[str, Peer] = {}
        self._peers_lock = lockwitness.new_lock("switch.peers")
        self._listener: transport.Listener | None = None
        self._stopped = threading.Event()
        self._dialing: set[str] = set()
        self._threads: list[threading.Thread] = []
        self._threads_lock = lockwitness.new_lock("switch.threads",
                                                  reentrant=False)
        self._persistent_addrs: dict[str, NetAddress] = {}
        # misbehavior scoring + temporary bans, keyed by peer id so
        # strikes survive reconnects (a liar can't reset its tally by
        # redialing); guarded by one lock, never held across I/O
        self._misbehavior: dict[str, float] = {}
        self._banned: dict[str, float] = {}      # id -> monotonic expiry
        self._ban_lock = lockwitness.new_lock("switch.ban",
                                              reentrant=False)
        # reconnect jitter RNG derived from the chaos seed + our node
        # id, so scenario runs replay the exact backoff schedule while
        # distinct nodes still de-correlate
        self.chaos_seed = chaos_seed
        self._reconnect_rng = random.Random(chaosmod.derive_seed(
            chaos_seed, "p2p.reconnect", self.node_info.id))
        self._rng_lock = lockwitness.new_lock("switch.reconnect_rng",
                                              reentrant=False)
        self._fuzz_links = 0         # links wrapped so far (fuzz seeds)
        self._sleep = time.sleep     # fake-clock hook for reconnect tests
        # the first fault of this node on a peer's well-formed message
        # (a reactor's `receive` raised); `stop()` raises it
        self.fault: BaseException | None = None

    def _track_thread(self, t: threading.Thread) -> None:
        """Track a helper thread for stop()-time join, reaping finished
        ones first — soak runs dial thousands of times and the old
        unconditional append leaked a list entry per attempt."""
        with self._threads_lock:
            self._threads = [x for x in self._threads if x.is_alive()]
            self._threads.append(t)

    # -- reactor registry ----------------------------------------------
    def add_reactor(self, name: str, reactor: Reactor) -> Reactor:
        for desc in reactor.get_channels():
            if desc.id in self._reactors_by_ch:
                raise SwitchError(f"channel {desc.id} already claimed")
            self._reactors_by_ch[desc.id] = reactor
            self._chan_descs.append(desc)
        self._reactors[name] = reactor
        reactor.set_switch(self)
        # advertise channels in the handshake record
        self.node_info.channels = tuple(d.id for d in self._chan_descs)
        return reactor

    def reactor(self, name: str) -> Reactor | None:
        return self._reactors.get(name)

    # -- lifecycle ------------------------------------------------------
    def start(self) -> None:
        for r in self._reactors.values():
            r.start()
        if self.config is not None and self.config.laddr:
            addr = NetAddress.parse(self.config.laddr)
            if addr.scheme == "tcp":
                self._listener = transport.Listener(addr)
                # patch the real bound port into our advertised address
                if self.node_info.listen_addr.endswith(":0"):
                    self.node_info.listen_addr = str(self._listener.addr)
                t = threading.Thread(target=self._accept_routine,
                                     daemon=True, name="switch-accept")
                t.start()
                self._track_thread(t)
        if self.config is not None:
            for s in self.config.persistent_peers:
                self.dial_peer_async(NetAddress.parse(s), persistent=True)
            for s in self.config.seeds:
                self.dial_peer_async(NetAddress.parse(s))

    def stop(self) -> None:
        """Stop the listener, every peer and every reactor, then raise
        this switch's fault or else the first error a reactor's `stop()`
        raised (each reactor is stopped first)."""
        self._stopped.set()
        if self._listener is not None:
            self._listener.close()
        with self._peers_lock:
            peers = list(self._peers.values())
        for p in peers:
            p.stop()
        faults = [self.fault] if self.fault is not None else []
        for r in self._reactors.values():
            try:
                r.stop()
            except BaseException as e:      # every reactor stops; then raise
                faults.append(e)
        # bounded join so a stopped net leaves no accept/dial threads
        # gossiping into the next test's sockets
        with self._threads_lock:
            threads = list(self._threads)
        for t in threads:
            if t.is_alive():
                t.join(timeout=1.0)
        if faults:
            raise faults[0]

    def _on_fault(self, exc: BaseException) -> None:
        with self._peers_lock:
            if self.fault is None:
                self.fault = exc

    # -- peers ----------------------------------------------------------
    def peers(self) -> list[Peer]:
        with self._peers_lock:
            return list(self._peers.values())

    def n_peers(self) -> int:
        with self._peers_lock:
            return len(self._peers)

    def get_peer(self, peer_id: str) -> Peer | None:
        with self._peers_lock:
            return self._peers.get(peer_id)

    def net_info(self) -> dict:
        """Listener + per-peer connection snapshots for the `net_info`
        RPC (reference `rpc/core/net.go` NetInfo: listening, listeners,
        peers with NodeInfo + ConnectionStatus incl. flowrate)."""
        with self._peers_lock:
            peers = list(self._peers.values())
        return {
            "listening": self._listener is not None,
            "listeners": ([str(self._listener.addr)]
                          if self._listener is not None else []),
            "n_peers": len(peers),
            "banned_peers": self.banned_peers(),
            "peers": [{
                "id": p.id,
                "moniker": p.node_info.moniker,
                "listen_addr": p.node_info.listen_addr,
                "is_outbound": p.outbound,
                "misbehavior_score": p.misbehavior_score,
                "connection_status": p.mconn.status(),
            } for p in peers],
        }

    def broadcast(self, ch_id: int, msg: bytes) -> list[str]:
        """Non-blocking try-send to every peer; returns ids that accepted
        (reference `Broadcast` :368-380)."""
        sent = []
        for p in self.peers():
            if p.try_send(ch_id, msg):
                sent.append(p.id)
        return sent

    # -- dialing --------------------------------------------------------
    def dial_peer_async(self, addr: NetAddress,
                        persistent: bool = False) -> None:
        t = threading.Thread(target=self._dial_peer,
                             args=(addr, persistent), daemon=True,
                             name=f"dial-{addr.host}:{addr.port}")
        t.start()
        self._track_thread(t)

    def _dial_peer(self, addr: NetAddress, persistent: bool,
                   reschedule: bool = True) -> Peer | None:
        """Dial + handshake one peer.  `reschedule=False` is the backoff
        loop's re-entry: the loop owns the retry/attempt counting, so
        failures here must not fork a second reconnect chain — but the
        peer must still be CONSTRUCTED persistent, because a conn the
        far side kills instantly (e.g. we are banned there) can die
        before any after-the-fact persistent patching runs, silently
        ending the chain."""
        key = addr.dial_string()
        with self._peers_lock:
            if key in self._dialing:
                return None
            self._dialing.add(key)
        try:
            timeout = (self.config.dial_timeout_s
                       if self.config is not None else 3.0)
            conn = transport.dial(addr, timeout=timeout)
        except OSError as e:
            log.info("dial failed", addr=str(addr), err=str(e))
            if persistent and reschedule:
                self._schedule_reconnect(addr)
            return None
        finally:
            with self._peers_lock:
                self._dialing.discard(key)
        try:
            peer = self.add_peer_from_conn(conn, outbound=True,
                                           persistent=persistent)
            if persistent and peer is not None:
                self._persistent_addrs[peer.id] = addr
            return peer
        except Exception as e:
            log.info("handshake failed", addr=str(addr), err=str(e))
            conn.close()
            if persistent and reschedule and "duplicate peer" not in str(e):
                # a duplicate rejection means the peer is already back
                # (e.g. a racing reconnect won) — looping would redial a
                # connected peer forever
                self._schedule_reconnect(addr)
            return None

    def _reconnect_delay(self, attempt: int) -> float:
        cfg = self.config
        with self._rng_lock:
            return backoff_delay(
                attempt, self._reconnect_rng,
                base_s=(cfg.reconnect_backoff_base_s if cfg is not None
                        else RECONNECT_BACKOFF_BASE_S),
                max_s=(cfg.reconnect_backoff_max_s if cfg is not None
                       else RECONNECT_BACKOFF_MAX_S),
                jitter_frac=(cfg.reconnect_jitter_frac if cfg is not None
                             else RECONNECT_JITTER_FRAC))

    def _schedule_reconnect(self, addr: NetAddress, attempt: int = 0) -> None:
        """Jittered exponential-backoff reconnect for persistent peers
        (reference `reconnectToPeer` :402-434): sleeps are capped at
        reconnect_backoff_max_s SECONDS, and the dialer gives up after
        reconnect_max_attempts tries — two separate limits."""
        max_attempts = (self.config.reconnect_max_attempts
                        if self.config is not None
                        else RECONNECT_MAX_ATTEMPTS)
        if self._stopped.is_set():
            return
        if attempt >= max_attempts:
            log.info("reconnect gave up", addr=str(addr), attempts=attempt)
            return
        delay = self._reconnect_delay(attempt)

        def run():
            self._sleep(delay)
            if self._stopped.is_set():
                return
            known = next((p for p, a in self._persistent_addrs.items()
                          if a.dial_string() == addr.dial_string()), None)
            if known is not None and self.get_peer(known) is not None:
                return          # already back: a racing dial/accept won
            REGISTRY.switch_reconnect_attempts.inc()
            peer = self._dial_peer(addr, persistent=True,
                                   reschedule=False)
            if peer is None:
                self._schedule_reconnect(addr, attempt + 1)

        t = threading.Thread(target=run, daemon=True, name="reconnect")
        t.start()
        self._track_thread(t)

    # -- accept ---------------------------------------------------------
    def _accept_routine(self) -> None:
        while not self._stopped.is_set():
            conn = self._listener.accept(timeout=0.5)
            if conn is None:
                continue
            max_peers = (self.config.max_num_peers
                         if self.config is not None else 50)
            if self.n_peers() >= max_peers:
                conn.close()
                continue
            threading.Thread(
                target=self._accept_one, args=(conn,), daemon=True,
                name="accept-handshake").start()

    def _accept_one(self, conn) -> None:
        try:
            self.add_peer_from_conn(conn, outbound=False)
        except Exception as e:
            log.info("inbound handshake failed", err=str(e))
            conn.close()

    # -- misbehavior scoring + temporary bans ----------------------------
    def is_banned(self, peer_id: str) -> bool:
        """True while peer_id is inside its ban window (expired entries
        are purged on read, so a served-out ban clears itself)."""
        now = time.monotonic()
        with self._ban_lock:
            until = self._banned.get(peer_id)
            if until is None:
                return False
            if now >= until:
                del self._banned[peer_id]
                return False
            return True

    def misbehavior_score(self, peer_id: str) -> float:
        """Current strike tally for peer_id (0.0 for clean/unknown)."""
        with self._ban_lock:
            return self._misbehavior.get(peer_id, 0.0)

    def banned_peers(self) -> dict[str, float]:
        """{peer_id: seconds_remaining} for peers currently banned."""
        now = time.monotonic()
        with self._ban_lock:
            return {pid: round(until - now, 3)
                    for pid, until in self._banned.items() if until > now}

    def report_misbehavior(self, peer_id: str, reason,
                           weight: float = 1.0, ban: bool = False) -> bool:
        """Charge a misbehavior strike against `peer_id` (reactors call
        this for protocol lies — bad commits, undecodable garbage —
        NEVER for slowness or our own device faults).  Strikes accumulate
        across reconnects; at misbehavior_ban_score (or immediately with
        `ban=True`, for proven lies like a failed commit check) the peer
        is evicted and refused in dial/accept for
        misbehavior_ban_window_s.  Returns True when this report crossed
        the ban line."""
        cfg = self.config
        score_limit = (cfg.misbehavior_ban_score if cfg is not None
                       else MISBEHAVIOR_BAN_SCORE)
        window_s = (cfg.misbehavior_ban_window_s if cfg is not None
                    else MISBEHAVIOR_BAN_WINDOW_S)
        with self._ban_lock:
            score = self._misbehavior.get(peer_id, 0.0) + weight
            self._misbehavior[peer_id] = score
            should_ban = ban or score >= score_limit
            if should_ban:
                self._banned[peer_id] = time.monotonic() + window_s
                self._misbehavior.pop(peer_id, None)
        peer = self.get_peer(peer_id)
        if peer is not None:
            peer.misbehavior_score = score
        log.info("peer misbehavior", peer=peer_id[:12],
                 score=round(score, 2), reason=str(reason)[:80])
        if should_ban:
            REGISTRY.switch_peers_evicted.inc()
            log.info("peer banned", peer=peer_id[:12], window_s=window_s,
                     reason=str(reason)[:80])
            if peer is not None:
                self._remove_peer(peer, f"banned: {reason}")
        return should_ban

    # -- the add-peer pipeline (reference :206-253) ----------------------
    def add_peer_from_conn(self, raw_conn, outbound: bool,
                           persistent: bool = False) -> Peer | None:
        cfg = self.config
        conn = raw_conn
        if cfg is not None and cfg.fuzz:
            with self._rng_lock:
                index = self._fuzz_links
                self._fuzz_links += 1
            conn = FuzzedConnection(
                conn,
                drop_prob=cfg.fuzz_drop_prob,
                delay_prob=cfg.fuzz_delay_prob,
                max_delay=cfg.fuzz_max_delay,
                seed=derived_seed(index, self.chaos_seed))
        conn = SecretConnection(conn, self.node_key)
        info = self._handshake(conn)
        if info.pub_key != conn.remote_pub_key:
            raise SwitchError("node info pubkey != authenticated conn key")
        if info.id == self.node_info.id:
            raise SwitchError("connected to self")
        if self.is_banned(info.id):
            raise SwitchError(f"peer {info.id[:12]} is banned "
                              f"(misbehavior)")
        self.node_info.compatible_with(info)
        mconn_kwargs = {}
        if cfg is not None:
            mconn_kwargs = dict(send_rate=cfg.send_rate,
                                recv_rate=cfg.recv_rate,
                                flush_throttle=cfg.flush_throttle_ms / 1000)
        peer_holder: list[Peer] = []

        def on_receive(ch_id: int, msg: bytes) -> None:
            reactor = self._reactors_by_ch.get(ch_id)
            if reactor is not None and peer_holder:
                reactor.receive(ch_id, peer_holder[0], msg)

        def on_error(exc: Exception) -> None:
            if peer_holder:
                self.stop_peer_for_error(peer_holder[0], exc)

        mconn = MConnection(conn, self._chan_descs, on_receive,
                            on_error=on_error, on_fault=self._on_fault,
                            label=info.id[:12],
                            **mconn_kwargs)
        peer = Peer(info, mconn, outbound, persistent)
        peer_holder.append(peer)
        with self._ban_lock:
            peer.misbehavior_score = self._misbehavior.get(info.id, 0.0)
        max_peers = (cfg.max_num_peers if cfg is not None
                     else DEFAULT_MAX_PEERS)
        with self._peers_lock:
            if info.id in self._peers:
                raise SwitchError(f"duplicate peer {info.id[:12]}")
            # the cap must be enforced under the same lock as the insert:
            # the accept routine's pre-handshake check is only a fast
            # path, and a heal storm's simultaneous handshakes would all
            # pass it and overshoot max_num_peers
            if len(self._peers) >= max_peers:
                raise SwitchError(f"too many peers "
                                  f"({len(self._peers)}/{max_peers})")
            self._peers[info.id] = peer
        # re-check the ban after the insert: a handshake that passed the
        # pre-handshake ban check can finish AFTER a report lands, and
        # letting it register would re-admit a just-banned peer inside
        # its window (checked post-insert to keep ban/peers lock
        # ordering flat for the lock witness)
        if self.is_banned(info.id):
            with self._peers_lock:
                if self._peers.get(info.id) is peer:
                    del self._peers[info.id]
            raise SwitchError(f"peer {info.id[:12]} is banned "
                              f"(misbehavior)")
        REGISTRY.peers.set(self.n_peers())
        mconn.start()
        for r in self._reactors.values():
            r.add_peer(peer)
        log.info("added peer", peer=info.id[:12], moniker=info.moniker,
                 outbound=outbound)
        return peer

    def _handshake(self, conn) -> NodeInfo:
        """Parallel NodeInfo exchange with timeout (reference
        `p2p/peer.go:142-184`)."""
        raw = self.node_info.to_json()
        conn.write(struct.pack(">I", len(raw)) + raw)
        n = struct.unpack(">I", conn.read_exact(4))[0]
        if n > 1 << 16:
            raise SwitchError("oversized node info")
        return NodeInfo.from_json(conn.read_exact(n))

    # -- removal --------------------------------------------------------
    def stop_peer_for_error(self, peer: Peer, reason) -> None:
        # classify the death: framing/MAC garbage (ValueError from the
        # fuzz/secret/mconn stack) is a misbehavior strike — a corrupting
        # or lying link; clean socket deaths (OSError/ConnectionError)
        # are our network's fault, never the peer's
        if isinstance(reason, ValueError):
            self.report_misbehavior(peer.id,
                                    f"transport garbage: {reason}")
        if not self._remove_peer(peer, reason):
            # stale death notification: this id already reconnected and a
            # NEWER peer object owns the slot — don't tear that one down,
            # and don't spawn a redundant reconnect loop for it either
            return
        if peer.persistent and not self.is_banned(peer.id):
            addr = self._persistent_addrs.get(peer.id)
            if addr is None and peer.node_info.listen_addr:
                addr = NetAddress.parse(peer.node_info.listen_addr)
            if addr is not None:
                self._schedule_reconnect(addr)

    def stop_peer_gracefully(self, peer: Peer) -> None:
        self._remove_peer(peer, None)

    def _remove_peer(self, peer: Peer, reason) -> bool:
        """Unregister THIS peer object.  Removal is identity-checked, not
        id-checked: after a reconnect the same peer id maps to a fresh
        Peer, and a late death notification from the replaced
        connection's reader thread must only stop its own (dead) conn —
        popping by id here used to evict the healthy successor and leave
        its MConnection running unregistered, wedging the sync.  Returns
        True when this object was the registered one."""
        with self._peers_lock:
            existing = self._peers.get(peer.id)
            if existing is not peer:
                peer.stop()              # stale object: just reap its conn
                return False
            del self._peers[peer.id]
        peer.stop()
        REGISTRY.peers.set(self.n_peers())
        for r in self._reactors.values():
            r.remove_peer(peer, reason)
        if reason is not None:
            log.info("removed peer", peer=peer.id[:12], reason=str(reason))
        return True


# ---------------------------------------------------------------------------
# in-process test harness (reference p2p/switch.go:495-543)
# ---------------------------------------------------------------------------

def make_switch(network: str, reactors: dict[str, Reactor] | None = None,
                config=None, moniker: str = "test",
                chaos_seed: int = 0) -> Switch:
    key = PrivKey.generate()
    info = NodeInfo(pub_key=key.pub_key.bytes_, moniker=moniker,
                    network=network, version="0.1.0", listen_addr="")
    sw = Switch(key, info, config, chaos_seed=chaos_seed)
    for name, r in (reactors or {}).items():
        sw.add_reactor(name, r)
    return sw


def connect_switches(sw1: Switch, sw2: Switch) -> tuple[Peer, Peer]:
    """Connect two switches over an in-memory pair; both handshakes run
    concurrently (they block on each other's bytes)."""
    c1, c2 = transport.mem_pair()
    out: dict = {}
    errs: dict = {}

    def run(sw, conn, key, outbound):
        try:
            out[key] = sw.add_peer_from_conn(conn, outbound=outbound)
        except Exception as e:      # surfaced to the caller below
            errs[key] = e
            conn.close()

    t1 = threading.Thread(target=run, args=(sw1, c1, 1, True), daemon=True)
    t2 = threading.Thread(target=run, args=(sw2, c2, 2, False), daemon=True)
    t1.start(); t2.start()
    t1.join(timeout=10); t2.join(timeout=10)
    if errs:
        raise SwitchError(f"connect failed: {errs}")
    if 1 not in out or 2 not in out:
        raise SwitchError("connect timed out")
    return out[1], out[2]


def make_connected_switches(network: str, n: int, reactor_factory,
                            config=None) -> list[Switch]:
    """n switches, fully meshed in-memory.  `reactor_factory(i)` returns
    the reactor dict for switch i."""
    switches = [make_switch(network, reactor_factory(i), config,
                            moniker=f"node{i}") for i in range(n)]
    for sw in switches:
        sw.start()
    for i in range(n):
        for j in range(i + 1, n):
            connect_switches(switches[i], switches[j])
    return switches
