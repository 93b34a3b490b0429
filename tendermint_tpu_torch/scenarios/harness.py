"""In-process node harnesses the scenario catalog composes.

Three rigs, in increasing realism (mirroring the tiers the test suite
grew organically in `tests/test_consensus.py` / `test_fastsync.py` /
`test_reactor.py` / `test_wal_corruption.py`):

- `wire_net`: N ConsensusStates delivering broadcasts directly to each
  other's feed methods — no transport; the fastest rig for byzantine
  vote-stream scenarios.
- `fastsync_source` / `fastsync_syncer`: real switches + blockchain
  reactors over in-memory pairs; the rig for lying/stale/partial-commit
  peers and device-fault storms during sync.
- `reactor_net`: full consensus+mempool reactors over switches with
  FuzzedConnection wrappers in the conn stack, so partition/delay-storm
  injectors can flip fuzz profiles on live links.
- `solo_node`: a real sqlite-backed Node (WAL on disk) for
  crash-restart storms.

Copy of `tendermint_tpu/scenarios/harness.py` with the port's explicit
wiring.  Each rig takes the crypto backend it runs on (`backend=`), builds
one `BatchPlane` over it, hands that plane to every `ConsensusState` and
`Mempool` it builds, and stops it at teardown (`stop_wire_net`,
`WireMesh.stop`, `stop_syncer`, `stop_reactor_net`); the blockchain
reactors take the backend itself.  Switches take the run's chaos seed
(`chaos_seed=`, from `ctx.chaos`) and derive their fuzz seeds and
reconnect jitter from it with the JAX labels ("p2p.fuzz",
"p2p.reconnect").  No backend is installed process-wide.
"""

from __future__ import annotations

import threading
import time

from tendermint_tpu_torch.batchplane import BatchPlane
from tendermint_tpu_torch.blockchain.reactor import BlockchainReactor
from tendermint_tpu_torch.blockchain.store import BlockStore
from tendermint_tpu_torch.config import Config, test_config
from tendermint_tpu_torch.consensus import messages as M
from tendermint_tpu_torch.consensus.reactor import ConsensusReactor
from tendermint_tpu_torch.consensus.state import ConsensusState
from tendermint_tpu_torch.mempool.mempool import Mempool
from tendermint_tpu_torch.mempool.reactor import MempoolReactor
from tendermint_tpu_torch.p2p.fuzz import FuzzedConnection
from tendermint_tpu_torch.p2p.switch import connect_switches, make_switch
from tendermint_tpu_torch.proxy import ClientCreator
from tendermint_tpu_torch.scenarios import fixtures
from tendermint_tpu_torch.state import execution
from tendermint_tpu_torch.state.state import get_state
from tendermint_tpu_torch.utils import tracing
from tendermint_tpu_torch.utils.db import MemDB
from tendermint_tpu_torch.utils.metrics import Histogram


def wait_until(pred, timeout: float, poll: float = 0.02) -> bool:
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(poll)
    return bool(pred())


# -- wire net (no transport) ------------------------------------------------

class WireNode:
    """ConsensusState + mempool + store, broadcast_cb-wired, on `plane`.

    `state`, `conns` and `block_store` are injectable so a restart rig
    (WireMesh) can rebuild a node over a retained block store with an
    app replayed back to the crash height."""

    def __init__(self, priv, gen, cfg: Config | None = None,
                 app: str = "kvstore", wal_path: str = "",
                 state=None, conns=None, block_store=None,
                 node_id: str = "", *, plane):
        cfg = cfg or test_config()
        self.priv = priv
        self.plane = plane
        st = state if state is not None else get_state(MemDB(), gen)
        self.conns = conns or ClientCreator(app).new_app_conns()
        self.mempool = Mempool(self.conns.mempool, plane=plane)
        self.block_store = (block_store if block_store is not None
                            else BlockStore(MemDB()))
        self.cs = ConsensusState(cfg.consensus, st, self.conns.consensus,
                                 self.block_store, self.mempool, plane,
                                 priv_validator=priv, wal_path=wal_path,
                                 node_id=node_id)


def wire_net(chain_id: str, n: int, app: str = "kvstore",
             seed: int = 0, *, backend
             ) -> tuple[list[WireNode], list, object]:
    """N validators wired directly, on one plane over `backend`: every
    broadcast lands in every other node's feed methods.  Returns (nodes,
    privs, genesis); `stop_wire_net(nodes)` tears it down."""
    privs, _vs = fixtures.make_validators(n, seed=seed)
    gen = fixtures.make_genesis(chain_id, privs)
    plane = BatchPlane(backend)
    nodes = [WireNode(p, gen, app=app, plane=plane) for p in privs]

    def make_cb(me: WireNode):
        def cb(msg):
            for other in nodes:
                if other is me:
                    continue
                if isinstance(msg, M.VoteMessage):
                    other.cs.add_vote(msg.vote, peer_id="net")
                elif isinstance(msg, M.ProposalMessage):
                    other.cs.set_proposal(msg.proposal, peer_id="net")
                elif isinstance(msg, M.BlockPartMessage):
                    other.cs.add_proposal_block_part(
                        msg.height, msg.round, msg.part, peer_id="net")
        return cb

    for nd in nodes:
        nd.cs.broadcast_cb = make_cb(nd)
    return nodes, privs, gen


def _stop_all(nodes: list, stop) -> None:
    """`stop(node)` for every node, then stop their planes.  The first
    fault a part raised is raised after every part was stopped."""
    errors = []
    for nd in nodes:
        try:
            stop(nd)
        except Exception as e:  # noqa: BLE001 - raised after the rest stop
            errors.append(e)
    for plane in {id(nd.plane): nd.plane for nd in nodes}.values():
        plane.stop()
    if errors:
        raise errors[0]


def stop_wire_net(nodes: list[WireNode]) -> None:
    """Stop every node's consensus state, then their plane."""
    _stop_all(nodes, lambda nd: nd.cs.stop())


def start_wire_net(nodes: list[WireNode], stagger_s: float = 0.0) -> None:
    """Start every WireNode's consensus state, optionally staggered —
    late starters model operators bringing a big net up one node at a
    time; rounds must still converge once +2/3 are live."""
    for i, nd in enumerate(nodes):
        nd.cs.start()
        if stagger_s > 0.0 and i < len(nodes) - 1:
            time.sleep(stagger_s)


class WireMesh:
    """Partitionable wire mesh: the 50-100 validator live-consensus rig.

    Same no-transport delivery as `wire_net`, with the link matrix made
    explicit so chaos schedules can cut/heal node pairs and
    crash/restart nodes mid-round:

    - `isolate(victims)` cuts every victim<->survivor link (the victims
      keep talking among themselves — an island partition); `heal()`
      restores the full mesh.
    - `crash(i)` stops a node's consensus thread; `restart(i)` rebuilds
      it over its RETAINED block store, replaying the committed prefix
      through a fresh app so state/app stay consistent.

    Wire delivery has no catchup gossip: a node that misses commits
    while down or severed stays permanently behind the quorum (votes
    for heights it has not reached are dropped).  Scenario invariants
    must therefore assert QUORUM liveness plus committed-prefix
    agreement, and adversary schedules must keep >=2/3 of the voting
    power live and connected.

    A sampler thread timestamps every height the live quorum commits,
    so scenarios can assert metric budgets (commit latency percentiles)
    instead of only wall-clock.

    Every node, restarted ones too, runs on the mesh's one `plane` over
    `backend`.
    """

    def __init__(self, chain_id: str, n: int, seed: int = 0,
                 timeouts: dict[str, float] | None = None,
                 app: str = "kvstore", *, backend):
        self.chain_id = chain_id
        self.n = n
        self.app = app
        self.plane = BatchPlane(backend)
        self._timeouts = timeouts
        self.privs, _vs = fixtures.make_validators(n, seed=seed)
        self.gen = fixtures.make_genesis(chain_id, self.privs)
        self._lock = threading.Lock()
        self._down: set[int] = set()
        self._cut: set[frozenset[int]] = set()
        self.store_dbs = [MemDB() for _ in range(n)]
        self.nodes: list[WireNode] = [self._build(i) for i in range(n)]
        for i in range(n):
            self.nodes[i].cs.broadcast_cb = self._make_cb(i)
        self.restarts = 0
        # one report per restart(): {"node", "replay_blocks", "replay_s"}
        # — scenario notes cite these instead of re-deriving them, and
        # the snapshot-join budget compares them against restore+tail
        self.restart_reports: list[dict] = []
        self._last_replay = (0, 0.0)
        self._samples: list[tuple[int, float]] = []   # (height, t_seen)
        self._sampler: threading.Thread | None = None
        self._sampler_stop = threading.Event()
        # -- timeline plane (telemetry/) --
        # per-node height lifecycle records delivered by the commit_cb
        # hook at the COMMIT SITE — the exact-timestamp source the 50ms
        # poll sampler above only approximates
        self.lifecycle_records: list[dict] = []
        self._commit_stamps: dict[int, float] = {}  # height -> first commit
        # per-run gossip fan-out lag (send stamp -> delivery), kept
        # mesh-local so sequential scenario runs in one process don't
        # read each other through the global REGISTRY
        self.gossip_hist = Histogram(Histogram.LATENCY_BOUNDS)
        # (i, j) -> [count, sum_s, max_s]; each key is written only by
        # sender i's consensus thread, so per-op GIL atomicity suffices
        self._link_stats: dict[tuple[int, int], list] = {}

    # -- construction / restart ----------------------------------------

    def _build(self, i: int) -> WireNode:
        """(Re)build node `i` over its retained block store.  The app
        conns are fresh, so the committed prefix is replayed through
        them — a from-disk restart without WAL, driven by the store."""
        store = BlockStore(self.store_dbs[i])
        st = get_state(MemDB(), self.gen)
        conns = ClientCreator(self.app).new_app_conns()
        t0 = time.time()
        replayed = 0
        for h in range(store.base, store.height + 1):
            block = store.load_block(h)
            meta = store.load_block_meta(h)
            execution.apply_block(st, conns.consensus, block,
                                  meta.block_id.parts,
                                  execution.MockMempool())
            replayed += 1
        self._last_replay = (replayed, time.time() - t0)
        node = WireNode(self.privs[i], self.gen,
                        cfg=config_with_timeouts(self._timeouts),
                        app=self.app, state=st, conns=conns,
                        block_store=store, node_id=f"n{i}",
                        plane=self.plane)
        node.cs.commit_cb = self._on_lifecycle   # survives restarts
        return node

    def _on_lifecycle(self, rec: dict) -> None:
        """commit_cb from every node: ring the record into the mesh's
        merged timeline and stamp the height's FIRST commit — the
        commit-site timestamps commit_latencies() prefers over the poll
        sampler."""
        with self._lock:
            self.lifecycle_records.append(rec)
            h, t = rec["height"], rec["t_commit"]
            cur = self._commit_stamps.get(h)
            if cur is None or t < cur:
                self._commit_stamps[h] = t

    def _make_cb(self, me_i: int):
        def cb(msg):
            with self._lock:
                if me_i in self._down:
                    return
                down = set(self._down)
                cut = set(self._cut)
                nodes = list(self.nodes)
            # origin send stamp: one per broadcast, so every link's lag
            # includes the sender-loop serialization ahead of it — the
            # fan-out cost the gossip_fanout_p99 budget grades
            t0 = tracing.now_epoch()
            stats = self._link_stats
            for j, other in enumerate(nodes):
                if j == me_i or j in down:
                    continue
                if frozenset((me_i, j)) in cut:
                    continue
                if isinstance(msg, M.VoteMessage):
                    other.cs.add_vote(msg.vote, peer_id="net", sent_ts=t0)
                elif isinstance(msg, M.ProposalMessage):
                    other.cs.set_proposal(msg.proposal, peer_id="net",
                                          sent_ts=t0)
                elif isinstance(msg, M.BlockPartMessage):
                    other.cs.add_proposal_block_part(
                        msg.height, msg.round, msg.part, peer_id="net",
                        sent_ts=t0)
                else:
                    continue
                lag = tracing.now_epoch() - t0
                self.gossip_hist.observe(lag)
                st = stats.get((me_i, j))
                if st is None:
                    st = stats[(me_i, j)] = [0, 0.0, 0.0]
                st[0] += 1
                st[1] += lag
                if lag > st[2]:
                    st[2] = lag
        return cb

    # -- lifecycle ------------------------------------------------------

    def start(self) -> None:
        for nd in self.nodes:
            nd.cs.start()

    def stop(self) -> None:
        self.stop_sampler()
        with self._lock:
            self._down.update(range(self.n))
        stop_wire_net(self.nodes)

    def crash(self, i: int) -> None:
        """SIGKILL-shaped: mark the node dead FIRST (so no sender can
        block on its dead queue), then stop its consensus thread."""
        with self._lock:
            self._down.add(i)
        self.nodes[i].cs.stop()

    def restart(self, i: int) -> None:
        node = self._build(i)
        node.cs.broadcast_cb = self._make_cb(i)
        with self._lock:
            self.nodes[i] = node
            self._down.discard(i)
        node.cs.start()
        self.restarts += 1
        replayed, dt = self._last_replay
        self.restart_reports.append({"node": i,
                                     "replay_blocks": replayed,
                                     "replay_s": round(dt, 4)})

    # -- partitions -----------------------------------------------------

    def isolate(self, victims: list[int]) -> None:
        vs = set(victims)
        with self._lock:
            for v in vs:
                for j in range(self.n):
                    if j not in vs:
                        self._cut.add(frozenset((v, j)))

    def heal(self) -> None:
        with self._lock:
            self._cut.clear()

    # -- observation ----------------------------------------------------

    def live(self) -> list[int]:
        with self._lock:
            return [i for i in range(self.n) if i not in self._down]

    def stores(self) -> list:
        return [nd.block_store for nd in self.nodes]

    def quorum_height(self) -> int:
        """Max committed height across live nodes (0 when all down)."""
        with self._lock:
            nodes = [nd for i, nd in enumerate(self.nodes)
                     if i not in self._down]
        return max((nd.block_store.height for nd in nodes), default=0)

    def start_sampler(self, poll_s: float = 0.05) -> None:
        def run():
            last_h = self.quorum_height()
            while not self._sampler_stop.is_set():
                h = self.quorum_height()
                if h > last_h:
                    now = time.time()
                    for hh in range(last_h + 1, h + 1):
                        self._samples.append((hh, now))
                    last_h = h
                time.sleep(poll_s)
        self._sampler_stop.clear()
        self._sampler = threading.Thread(target=run, daemon=True,
                                         name="wiremesh-sampler")
        self._sampler.start()

    def stop_sampler(self) -> None:
        self._sampler_stop.set()
        if self._sampler is not None:
            self._sampler.join(timeout=5)
            self._sampler = None

    def commit_latencies(self) -> list[float]:
        """Gaps between consecutive commits (seconds), from the
        commit-site stamps the nodes' commit_cb hooks deliver — exact,
        not quantized to the sampler's 50ms poll.  Falls back to the
        poll samples when no hook fired (e.g. a rig built before
        start(), or every node crashed pre-commit)."""
        with self._lock:
            stamps = dict(self._commit_stamps)
        if stamps:
            ts = [stamps[h] for h in sorted(stamps)]
        else:
            ts = [t for _h, t in self._samples]
        return [b - a for a, b in zip(ts, ts[1:])]

    def commit_latency_p99(self) -> float | None:
        gaps = sorted(self.commit_latencies())
        if not gaps:
            return None
        return gaps[min(len(gaps) - 1, int(0.99 * len(gaps)))]

    def timeline_records(self) -> list[dict]:
        """Per-node height lifecycle records (see ConsensusState
        STAGE_NAMES) accumulated by the commit hooks — the mesh
        collector's in-process input."""
        with self._lock:
            return list(self.lifecycle_records)

    def gossip_stats(self) -> dict:
        """Mesh-wide gossip fan-out aggregates.  `per_receiver_wait_s`
        divides the total per-delivery lag by the fan-out degree — the
        serialized gossip wait ONE receiver experienced over the run,
        commensurate with per-node wall clock (the doctor's gossip_delay
        thief).  `worst_link` is the (sender, receiver) pair with the
        largest single-delivery lag."""
        with self._lock:
            links = {k: list(v) for k, v in self._link_stats.items()}
        count = sum(v[0] for v in links.values())
        total = sum(v[1] for v in links.values())
        worst = max(links.items(), key=lambda kv: kv[1][2], default=None)
        return {
            "count": count,
            "total_s": total,
            "mean_s": total / count if count else 0.0,
            "p50": self.gossip_hist.quantile(0.50),
            "p99": self.gossip_hist.quantile(0.99),
            "max_s": worst[1][2] if worst else 0.0,
            "worst_link": list(worst[0]) if worst else None,
            "per_receiver_wait_s": total / max(self.n - 1, 1),
        }


# -- fast-sync rig ----------------------------------------------------------

def fastsync_source(chain_id: str, chain, gen, moniker: str = "source",
                    config=None, app="kvstore", *, backend,
                    chaos_seed: int = 0):
    """A served chain: store + state advanced to the tip, behind a
    switch.  Returns (switch, state, store).  Pass a P2PConfig with a
    TCP `laddr` to make the source dialable (the rig for persistent-
    peer reconnect scenarios).  Pass an Application instance as `app`
    to keep a handle on the served app — the snapshot rigs do, so the
    source can also serve snapshots of its state.  The chain is applied
    without LastCommit checks; the serving reactor holds `backend`."""
    state = get_state(MemDB(), gen)
    conns = ClientCreator(app).new_app_conns()
    store = BlockStore(MemDB())
    for block, ps, seen in chain:
        store.save_block(block, ps, seen)
        execution.apply_block(state, conns.consensus, block,
                              ps.header, execution.MockMempool())
    reactor = BlockchainReactor(state, conns.consensus, store,
                                fast_sync=False, backend=backend)
    sw = make_switch(chain_id, {"blockchain": reactor}, config=config,
                     moniker=moniker, chaos_seed=chaos_seed)
    return sw, state, store


def fastsync_syncer(chain_id: str, gen, batch_size: int = 8,
                    fuzz: bool = False, state=None, store=None,
                    app="kvstore", *, backend, chaos_seed: int = 0):
    """A fresh syncing node.  Returns (switch, bc_reactor, cons_reactor,
    store); `stop_syncer(switch, cons_reactor)` tears it down.  With
    `fuzz=True` every link gets an inert FuzzedConnection wrapper (zero
    probabilities) so partition injectors can sever individual source
    links mid-sync.  Fast-sync windows verify on `backend`; the
    consensus state it switches to runs on a plane over it.

    `state`/`store`/`app` are injectable for the snapshot-join rig: a
    snapshot-restored State + a `bootstrap()`ed store + the restored
    Application instance make this node sync only the short tail
    `snapshot_height -> tip` instead of the whole chain."""
    state = state if state is not None else get_state(MemDB(), gen)
    conns = ClientCreator(app).new_app_conns()
    store = store if store is not None else BlockStore(MemDB())
    plane = BatchPlane(backend)
    mp = Mempool(conns.mempool, plane=plane)
    cs = ConsensusState(test_config().consensus, state.copy(),
                        conns.consensus, store, mp, plane)
    cons_reactor = ConsensusReactor(cs, fast_sync=True)
    bc_reactor = BlockchainReactor(state, conns.consensus, store,
                                   fast_sync=True, batch_size=batch_size,
                                   backend=backend)
    bc_reactor.on_caught_up = cons_reactor.switch_to_consensus
    p2p_cfg = None
    if fuzz:
        p2p_cfg = test_config().p2p
        p2p_cfg.laddr = ""
        p2p_cfg.fuzz = True
        p2p_cfg.fuzz_drop_prob = 0.0
        p2p_cfg.fuzz_delay_prob = 0.0
    sw = make_switch(chain_id, {"blockchain": bc_reactor,
                                "consensus": cons_reactor},
                     config=p2p_cfg, moniker="syncer",
                     chaos_seed=chaos_seed)
    return sw, bc_reactor, cons_reactor, store


def stop_syncer(switch, cons_reactor) -> None:
    """Stop a `fastsync_syncer`'s switch (raising what its parts kept)
    and then its plane."""
    try:
        switch.stop()
    finally:
        cons_reactor.cs.plane.stop()


def fuzz_link_to(switch, peer_id: str) -> FuzzedConnection | None:
    """The FuzzedConnection wrapping `switch`'s link to `peer_id`, or
    None when the peer is absent or the link is unfuzzed — the handle
    for asymmetric partitions that sever ONE link of a multi-peer
    switch while the others keep flowing."""
    for peer in switch.peers():
        if peer.id != peer_id:
            continue
        inner = getattr(peer.mconn.conn, "_conn", None)
        if isinstance(inner, FuzzedConnection):
            return inner
    return None


# -- reactor net (real p2p, fuzz wrappers in the stack) ---------------------

class ReactorNode:
    """Consensus core + reactors + switch (the gossip-only rig), on
    `plane`."""

    def __init__(self, priv, gen, chain_id: str, moniker: str,
                 cfg: Config | None = None, fuzz: bool = False, *,
                 plane, chaos_seed: int = 0):
        cfg = cfg or test_config()
        # kept for crash-restart rigs: rebuilding a node from genesis
        # needs (priv, gen, chain_id) back
        self.priv = priv
        self.gen = gen
        self.plane = plane
        cfg.p2p.laddr = ""        # in-memory pairs only, no TCP listener
        if fuzz:
            # wrappers with zero probabilities: inert until an injector
            # flips a profile (partition/delay storm)
            cfg.p2p.fuzz = True
            cfg.p2p.fuzz_drop_prob = 0.0
            cfg.p2p.fuzz_delay_prob = 0.0
        st = get_state(MemDB(), gen)
        self.conns = ClientCreator("kvstore").new_app_conns()
        self.mempool = Mempool(self.conns.mempool, plane=plane)
        self.block_store = BlockStore(MemDB())
        self.cs = ConsensusState(cfg.consensus, st, self.conns.consensus,
                                 self.block_store, self.mempool, plane,
                                 priv_validator=priv)
        self.cons_reactor = ConsensusReactor(self.cs)
        self.mp_reactor = MempoolReactor(self.mempool)
        self.switch = make_switch(chain_id, {
            "consensus": self.cons_reactor,
            "mempool": self.mp_reactor,
        }, config=cfg.p2p, moniker=moniker, chaos_seed=chaos_seed)

    def fuzz_links(self) -> list[FuzzedConnection]:
        """The FuzzedConnection wrapper of every live peer link on this
        node's side (empty when fuzz=False)."""
        out = []
        for peer in self.switch.peers():
            sec = peer.mconn.conn
            inner = getattr(sec, "_conn", None)
            if isinstance(inner, FuzzedConnection):
                out.append(inner)
        return out

    def start(self):
        self.switch.start()

    def stop(self):
        self.switch.stop()


def config_with_timeouts(timeouts: dict[str, float] | None) -> Config:
    """test_config with consensus timeouts overridden.  The defaults
    (20-100ms) are tuned for <=5-node rigs; a 10+ node net on pure-python
    crypto needs propose/prevote windows that cover its verify load or
    every height burns rounds on timeouts."""
    cfg = test_config()
    for k, v in (timeouts or {}).items():
        if not hasattr(cfg.consensus, k):
            raise ValueError(f"unknown consensus timeout field {k!r}")
        setattr(cfg.consensus, k, v)
    return cfg


def start_reactor_net(nodes: list[ReactorNode],
                      stagger_s: float = 0.0) -> None:
    """Rolling bring-up of a reactor net: each node starts, meshes with
    the already-live prefix, and (optionally) the next waits stagger_s —
    a 10-50 node net coming up one operator at a time."""
    for i, nd in enumerate(nodes):
        nd.start()
        for j in range(i):
            connect_switches(nodes[j].switch, nd.switch)
        if stagger_s > 0.0 and i < len(nodes) - 1:
            time.sleep(stagger_s)


def stop_reactor_net(nodes: list[ReactorNode]) -> None:
    """Stop every node's switch, then their planes."""
    _stop_all(nodes, ReactorNode.stop)


def reactor_net(chain_id: str, n: int, fuzz: bool = False,
                seed: int = 0, stagger_s: float = 0.0,
                profiles: dict[int, dict] | None = None,
                timeouts: dict[str, float] | None = None,
                autostart: bool = True, *, backend,
                chaos_seed: int = 0,
                ) -> tuple[list[ReactorNode], list]:
    """Full-mesh reactor net, sized for 10-50 validator rigs.

    `stagger_s` sleeps between node bring-ups (each node connects to the
    already-started prefix as it comes up), modeling a rolling start of
    a big net.  `profiles` maps node index -> fuzz profile fields
    (see FuzzedConnection.set_profile) applied to that node's links once
    the mesh is wired — per-node fault profiles, e.g. one flaky-link
    node in an otherwise clean net.  Profiles need `fuzz=True`.
    `timeouts` overrides consensus timeouts on every node (see
    config_with_timeouts).  `autostart=False` returns the net built but
    not started, so injector hooks can install before height 1.  Every
    node runs on one plane over `backend` (`stop_reactor_net`)."""
    if profiles and not fuzz:
        raise ValueError("per-node fault profiles need fuzz=True "
                         "(no FuzzedConnection wrappers to flip otherwise)")
    bad = [i for i in (profiles or {}) if not 0 <= i < n]
    if bad:
        raise ValueError(f"profile indices {bad} out of range for n={n}")
    privs, _vs = fixtures.make_validators(n, seed=seed)
    gen = fixtures.make_genesis(chain_id, privs)
    plane = BatchPlane(backend)
    nodes = [ReactorNode(privs[i], gen, chain_id, f"node{i}",
                         cfg=config_with_timeouts(timeouts), fuzz=fuzz,
                         plane=plane, chaos_seed=chaos_seed)
             for i in range(n)]
    if autostart:
        start_reactor_net(nodes, stagger_s=stagger_s)
        for idx, prof in (profiles or {}).items():
            for link in nodes[idx].fuzz_links():
                link.set_profile(**prof)
    elif profiles:
        raise ValueError("profiles need autostart=True (links exist only "
                         "after the mesh is wired); apply them after "
                         "start_reactor_net instead")
    return nodes, privs


# -- full node (sqlite home, WAL on disk) -----------------------------------

def solo_node(home: str, chain_id: str, pv_key_byte: int = 0x31, *,
              backend):
    """A real single-validator Node over a sqlite home dir — the rig for
    crash-restart storms (its consensus WAL lives on disk at
    <home>/data/cs.wal).  Rebuilding with the same args after a crash is
    the restart.  The node builds its own plane over `backend`."""
    from tendermint_tpu_torch.node.node import Node
    from tendermint_tpu_torch.types import (GenesisDoc, GenesisValidator, PrivKey,
                                      PrivValidator)
    cfg = test_config()
    cfg.base.home = home
    cfg.base.db_backend = "sqlite"
    cfg.rpc.laddr = ""
    cfg.p2p.laddr = ""
    pv = PrivValidator(PrivKey(bytes([pv_key_byte]) * 32))
    gen = GenesisDoc(chain_id=chain_id,
                     validators=[GenesisValidator(pv.pub_key.bytes_, 10)],
                     genesis_time_ns=1)
    return Node(cfg, priv_validator=pv, genesis_doc=gen, backend=backend)
