"""Command-line interface.

Reference: `cmd/tendermint/commands/` — `init`, `node`, `testnet`,
`gen_validator`, `show_validator`, `replay`, `unsafe_reset_all`,
`version` (file-per-command, root at `root.go:36-52`).  argparse-based;
every command takes --home.

Run as `python -m tendermint_tpu_torch.cli <command>`.

Copy of `tendermint_tpu/cli/__init__.py` with the commands `init`,
`node` (the supervised-ladder flags among its flags), `testnet`,
`gen_validator`, `show_validator`, `unsafe_reset_all`, `replay`,
`replay_console`, `wal-fsck`, `snapshot list | create | verify |
restore`, `trace`, `doctor`, `timeline`, `bench-history`, `lint`,
`chaos list | run | replay | smoke | soak | nightly`, `probe_upnp` and
`version` — every JAX command.  `init --warm-crypto` warms the backend
the home's config names into the home's on-disk comb-table cache, which
the node reads (`BaseConfig.table_cache_dir()`), and raises if the
warm-up fails; `lint` runs the port's tmlint (`analysis/`) over
`tendermint_tpu_torch/`.  Every `chaos` command runs on the card unless `--backend` names
a CPU backend ("python", "rig", "native"), and reads no environment
variable.  `trace`, `doctor` and `timeline` read a node's unsafe RPC
routes or a dump, and print what the JAX commands print.  The snapshot commands hash
chunks through `make_backend(base.crypto_backend)` (kernel K4 on the
card), and a persistent kvstore keeps its file in
`<data dir>/kvstore_app.json`.  `--home` defaults
to `~/.tendermint_tpu_torch`, so a port node and a JAX node never share a
home, and no environment variable (`TM_HOME`) sets it.  A node runs on
the card unless its config or `--crypto-backend` says otherwise; a fault
of the node, or an error out of building it, exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

from tendermint_tpu_torch import __version__
from tendermint_tpu_torch.config import (Config, config_file, load_config_file,
                                   save_config_file)


def _load_config(args) -> Config:
    cfg = Config()
    cfg.base.home = args.home
    # config.toml (written by init/testnet) is the base layer; explicit
    # CLI flags below override it (reference: viper file + flag binding)
    cf = config_file(os.path.expanduser(args.home))
    if os.path.exists(cf):
        cfg = load_config_file(cf, cfg)
        cfg.base.home = args.home
    if getattr(args, "proxy_app", None):
        cfg.base.proxy_app = args.proxy_app
    if getattr(args, "chain_id", None):
        cfg.base.chain_id = args.chain_id
    if getattr(args, "rpc_laddr", None):
        cfg.rpc.laddr = args.rpc_laddr
    if getattr(args, "p2p_laddr", None):
        cfg.p2p.laddr = args.p2p_laddr
    if getattr(args, "seeds", None):
        cfg.p2p.seeds = args.seeds.split(",")
    if getattr(args, "crypto_backend", None):
        cfg.base.crypto_backend = args.crypto_backend
    if getattr(args, "fast_sync", None) is not None:
        cfg.base.fast_sync = args.fast_sync
    if getattr(args, "crypto_supervised", None) is not None:
        cfg.crypto.supervised = args.crypto_supervised
    if getattr(args, "crypto_breaker_threshold", None):
        cfg.crypto.breaker_threshold = args.crypto_breaker_threshold
    if getattr(args, "crypto_call_timeout", None):
        cfg.crypto.call_timeout_s = args.crypto_call_timeout
    if getattr(args, "crypto_spot_check", None):
        cfg.crypto.spot_check_every = args.crypto_spot_check
    return cfg


def cmd_init(args) -> int:
    """Initialize home dir: priv validator + solo-validator genesis
    (reference cmd/tendermint/commands/init.go)."""
    from tendermint_tpu_torch.types import (GenesisDoc, GenesisValidator,
                                            PrivValidator)
    cfg = _load_config(args)
    root = cfg.base.root()
    os.makedirs(root, exist_ok=True)
    pv_file = cfg.base.priv_validator_file()
    pv = PrivValidator.load_or_generate(pv_file)
    gen_file = cfg.base.genesis_file()
    if not os.path.exists(gen_file):
        doc = GenesisDoc(
            chain_id=args.chain_id or "test-chain",
            validators=[GenesisValidator(pv.pub_key.bytes_, 10)])
        doc.save(gen_file)
        print(f"genesis written to {gen_file}")
    else:
        print(f"genesis already exists at {gen_file}")
    cf = config_file(root)
    if not os.path.exists(cf):
        save_config_file(cfg, cf)
        print(f"config written to {cf}")
    print(f"priv validator at {pv_file} ({pv.address.hex()})")
    if getattr(args, "warm_crypto", False):
        _warm_crypto(cfg)
    return 0


def _warm_crypto(cfg) -> int:
    """Warm the crypto plane for this home's genesis validator set, so the
    node's FIRST boot is already warm: the kernel library built (or
    loaded), the set's comb tables built on K2 and written to the home's
    on-disk cache (`BaseConfig.table_cache_dir()`, which the node reads),
    and K1 launched at the shapes the node produces
    (`precompile_for_validators`, the one shared derivation).  The node
    itself runs no warmer.  A no-op on the host backends; a failed build
    or launch raises."""
    import time
    from tendermint_tpu_torch.node.node import make_backend
    from tendermint_tpu_torch.types import GenesisDoc
    # warm the backend the HOME is configured to run
    be = make_backend(cfg.base.crypto_backend, cfg.crypto,
                      table_cache_dir=cfg.base.table_cache_dir())
    if not hasattr(be, "precompile_for_validators"):
        print(f"crypto backend {cfg.base.crypto_backend!r} has no device "
              "plane; nothing to warm")
        return 0
    doc = GenesisDoc.load(cfg.base.genesis_file())
    vals = doc.validator_set()
    t0 = time.time()
    print(f"warming crypto plane for {vals.size()} validators "
          f"(one-time; lands in the on-disk caches)...", flush=True)
    be.precompile_for_validators(vals)
    print(f"crypto warm done in {time.time() - t0:.1f}s")
    return 0


def cmd_node(args) -> int:
    """Run the node (reference run_node.go)."""
    from tendermint_tpu_torch.node.node import Node
    cfg = _load_config(args)
    node = Node(cfg)                    # applies base.log_level
    node.start()

    from tendermint_tpu_torch.types import events as ev

    def on_block(block):
        print(f"committed block height={block.height} "
              f"txs={len(block.txs)} hash={block.hash().hex()[:12]}",
              flush=True)

    node.evsw.subscribe("cli", ev.NEW_BLOCK, on_block)
    rpc = node.rpc_server.addr if node.rpc_server else "disabled"
    print(f"node started: chain={node.state.chain_id} rpc={rpc}",
          flush=True)
    node.run_forever()
    return 0


def cmd_testnet(args) -> int:
    """Generate N validator home dirs sharing one genesis
    (reference testnet.go:14-50)."""
    from tendermint_tpu_torch.types import (GenesisDoc, GenesisValidator,
                                            PrivValidator)
    n = args.n
    out = args.output
    os.makedirs(out, exist_ok=True)
    pvs = []
    for i in range(n):
        home = os.path.join(out, f"node{i}")
        os.makedirs(home, exist_ok=True)
        pv = PrivValidator.load_or_generate(
            os.path.join(home, "priv_validator.json"))
        pvs.append(pv)
    doc = GenesisDoc(
        chain_id=args.chain_id or "testnet-chain",
        validators=[GenesisValidator(pv.pub_key.bytes_, 10) for pv in pvs])
    for i in range(n):
        home = os.path.join(out, f"node{i}")
        doc.save(os.path.join(home, "genesis.json"))
        # per-node config file: distinct ports, peers pointed at node0
        base = args.base_port
        cfg = Config()
        cfg.base.home = home
        cfg.base.moniker = f"node{i}"
        cfg.rpc.laddr = f"tcp://0.0.0.0:{base + 1 + 2 * i}"
        cfg.p2p.laddr = f"tcp://0.0.0.0:{base + 2 * i}"
        if i > 0:
            cfg.p2p.persistent_peers = [f"127.0.0.1:{base}"]
        save_config_file(cfg, config_file(home))
    print(f"wrote {n} node homes under {out}")
    return 0


def cmd_gen_validator(args) -> int:
    from tendermint_tpu_torch.types import PrivValidator
    pv = PrivValidator.generate()
    print(json.dumps({"address": pv.address.hex(),
                      "pub_key": pv.pub_key.bytes_.hex(),
                      "priv_key": pv.priv_key.seed.hex()}, indent=2))
    return 0


def cmd_show_validator(args) -> int:
    from tendermint_tpu_torch.types import PrivValidator
    cfg = _load_config(args)
    pv = PrivValidator.load(cfg.base.priv_validator_file())
    print(json.dumps({"address": pv.address.hex(),
                      "pub_key": pv.pub_key.bytes_.hex()}, indent=2))
    return 0


def cmd_unsafe_reset_all(args) -> int:
    """Wipe data + reset priv validator HRS (reference
    reset_priv_validator.go)."""
    from tendermint_tpu_torch.types import PrivValidator
    cfg = _load_config(args)
    data = cfg.base.db_dir()
    if os.path.isdir(data):
        shutil.rmtree(data)
        print(f"removed {data}")
    pv_file = cfg.base.priv_validator_file()
    if os.path.exists(pv_file):
        pv = PrivValidator.load(pv_file)
        pv.reset()
        print(f"reset priv validator signing state at {pv_file}")
    return 0


def cmd_replay(args) -> int:
    """Replay stored blocks through a fresh app (reference replay.go)."""
    from tendermint_tpu_torch.blockchain.store import BlockStore
    from tendermint_tpu_torch.proxy import ClientCreator
    from tendermint_tpu_torch.state.execution import exec_commit_block
    from tendermint_tpu_torch.utils.db import new_db
    cfg = _load_config(args)
    bs = BlockStore(new_db("sqlite",
                           os.path.join(cfg.base.db_dir(),
                                        "blockstore.db")))
    conns = ClientCreator(cfg.base.proxy_app).new_app_conns()
    print(f"replaying {bs.height} blocks into {cfg.base.proxy_app}")
    app_hash = b""
    for h in range(1, bs.height + 1):
        block = bs.load_block(h)
        app_hash = exec_commit_block(conns.consensus, block)
    print(f"done; final app hash {app_hash.hex()}")
    return 0


def _describe_record(i: int, kind: int, payload: bytes) -> str:
    import struct
    from tendermint_tpu_torch.consensus import messages as M
    from tendermint_tpu_torch.consensus.wal import (REC_ENDHEIGHT, REC_MESSAGE,
                                              REC_TIMEOUT)
    if kind == REC_ENDHEIGHT:
        return f"[{i}] ENDHEIGHT {struct.unpack('>Q', payload)[0]}"
    if kind == REC_TIMEOUT:
        h, r, s = struct.unpack(">QIB", payload)
        return f"[{i}] TIMEOUT h={h} r={r} step={s}"
    if kind == REC_MESSAGE:
        try:
            return f"[{i}] MESSAGE {type(M.decode_msg(payload)).__name__}"
        except Exception:
            return f"[{i}] MESSAGE <undecodable {len(payload)}B>"
    return f"[{i}] kind={kind} ({len(payload)}B)"


def cmd_replay_console(args) -> int:
    """Interactive WAL playback console (reference
    `consensus/replay_file.go:76-230`): a live ConsensusState is driven
    record by record from the consensus WAL.

    Commands: next [N], back [N] (reset + re-feed, reference
    replayReset), until H (run to ENDHEIGHT H), rs [short|validators|
    proposal|proposal_block|locked_round|locked_block|votes], d (dump
    the next record), n (position), q.  Non-tty stdin feeds everything
    through (scriptable smoke-replay).
    """
    from tendermint_tpu_torch.batchplane import BatchPlane
    from tendermint_tpu_torch.consensus.replay import Playback
    from tendermint_tpu_torch.node.node import make_backend
    from tendermint_tpu_torch.types.genesis import GenesisDoc
    cfg = _load_config(args)
    wal_path = os.path.join(cfg.base.db_dir(), "cs.wal")
    gen = GenesisDoc.load(cfg.base.genesis_file())
    plane = BatchPlane(make_backend(cfg.base.crypto_backend))
    try:
        pb = Playback(gen, wal_path, plane,
                      proxy_app=cfg.base.proxy_app or "kvstore",
                      cfg=cfg.consensus)
        return _console(pb, wal_path)
    finally:
        plane.stop()


def _console(pb, wal_path: str) -> int:
    from tendermint_tpu_torch.consensus import messages as M
    from tendermint_tpu_torch.consensus.wal import REC_MESSAGE
    print(f"{len(pb.records)} records in {wal_path}")
    if not sys.stdin.isatty():
        while pb.count < len(pb.records):
            print(_describe_record(pb.count, *pb.records[pb.count]))
            pb.next(1)
        print(f"final round state: {pb.round_state('short')}")
        return 0
    while True:
        try:
            line = input(f"[{pb.count}/{len(pb.records)} "
                         f"{pb.round_state('short')}]> ").strip()
        except EOFError:
            break
        tok = line.split()
        cmd = tok[0] if tok else "next"

        def _arg_int(default=None):
            """Numeric argument or None; a typo must not crash the
            console and lose the replayed position."""
            if len(tok) < 2:
                return default
            try:
                return int(tok[1])
            except ValueError:
                print(f"{cmd} takes an integer argument")
                return None

        if cmd in ("q", "quit"):
            break
        elif cmd == "next":
            n = _arg_int(1)
            if n is None:
                continue
            for _ in range(n):
                if pb.count >= len(pb.records):
                    print("(end of WAL)")
                    break
                print(_describe_record(pb.count, *pb.records[pb.count]))
                pb.next(1)
        elif cmd == "back":
            n = _arg_int(1)
            if n is None:
                continue
            if n > pb.count:
                print(f"back must be <= current count ({pb.count})")
            else:
                pb.back(n)
                print(f"reset and re-fed {pb.count} records")
        elif cmd == "until":
            h = _arg_int()
            if h is None:
                print("until takes a height")
            else:
                pb.run_until(h)
        elif cmd == "rs":
            print(pb.round_state(tok[1] if len(tok) > 1 else "short"))
        elif cmd == "n":
            print(pb.count)
        elif cmd == "d":
            if pb.count < len(pb.records):
                kind, payload = pb.records[pb.count]
                if kind == REC_MESSAGE:
                    try:
                        print(M.decode_msg(payload))
                    except Exception as e:
                        print("undecodable:", e)
                else:
                    print(payload.hex())
        else:
            print("commands: next [N] | back [N] | until H | rs [field] "
                  "| d | n | q")
    return 0


def cmd_wal_fsck(args) -> int:
    """Check (and optionally repair) the consensus WAL.  Exit 0 when the
    log is clean, 1 when corruption was found (and left in place), 0
    after a successful --repair."""
    from tendermint_tpu_torch.consensus.wal import WAL
    cfg = _load_config(args)
    path = args.wal or os.path.join(cfg.base.db_dir(), "cs.wal")
    if not os.path.exists(path):
        print(f"no WAL at {path}")
        return 1
    report = WAL.fsck(path, repair=args.repair)
    eh = report["end_heights"]
    print(f"{path}: {report['records']} records, "
          f"{len(eh)} committed heights"
          + (f" (last {eh[-1]})" if eh else ""))
    for off, skipped in report["bad_regions"]:
        print(f"  corrupt region at offset {off}: {skipped} bytes skipped")
    if report["tail_garbage"]:
        print(f"  torn/corrupt tail: {report['tail_garbage']} bytes")
    dirty = bool(report["bad_regions"] or report["tail_garbage"])
    if not dirty:
        print("clean")
        return 0
    if report["repaired"]:
        print("repaired: rewrote the log with only the valid records")
        return 0
    print("corrupt (replay will skip the bad regions; "
          "run with --repair to rewrite)")
    return 1


def _snapshot_store(args, hashing: bool = True):
    """The home's config and its snapshot store; the store hashes chunks
    on `make_backend(base.crypto_backend)` unless `hashing` is False
    (listing re-roots manifests on the host and hashes no chunk)."""
    from tendermint_tpu_torch.statesync import SnapshotStore
    cfg = _load_config(args)
    root = args.dir or os.path.join(cfg.base.db_dir(), "snapshots")
    backend = None
    if hashing:
        from tendermint_tpu_torch.node.node import make_backend
        backend = make_backend(cfg.base.crypto_backend)
    return cfg, SnapshotStore(root, backend=backend)


def _home_app(cfg):
    """The home's Application instance, for snapshot create/restore.
    Remote app specs (tcp://, grpc://) cannot serialize their state from
    here — the operator snapshots on the app side instead."""
    from tendermint_tpu_torch.abci.app import Application, create_app
    from tendermint_tpu_torch.node.node import home_app
    spec = cfg.base.proxy_app
    if spec.startswith(("tcp://", "grpc://")):
        raise SystemExit(f"cannot snapshot a remote app ({spec}); "
                         "snapshots need in-process app state")
    app = home_app(cfg.base)
    return app if isinstance(app, Application) else create_app(app)


def cmd_snapshot_list(args) -> int:
    """List snapshots under the home (or --dir), torn ones included."""
    _cfg, store = _snapshot_store(args, hashing=False)
    valid, rejects = store.scan()
    if args.json:
        print(json.dumps({
            "dir": store.root_dir,
            "snapshots": [m.canonical_body() for m in valid],
            "rejected": [{"dir": d, "why": w} for d, w in rejects]},
            indent=1))
        return 0
    for m in valid:
        print(f"height {m.height}: {m.chunks} chunks "
              f"x {m.chunk_size}B, root {m.root.hex()[:16]}, "
              f"app_hash {m.app_hash.hex()[:16]}")
    for sdir, why in rejects:
        print(f"REJECTED {sdir}: {why}")
    if not valid and not rejects:
        print(f"no snapshots under {store.root_dir}")
    return 0


def cmd_snapshot_create(args) -> int:
    """Snapshot the home's committed state + app state."""
    from tendermint_tpu_torch.state.state import get_state
    from tendermint_tpu_torch.types.genesis import GenesisDoc
    from tendermint_tpu_torch.utils.db import new_db
    cfg, store = _snapshot_store(args)
    gen = GenesisDoc.load(cfg.base.genesis_file())
    state_db = new_db("sqlite", os.path.join(cfg.base.db_dir(),
                                             "state.db"))
    state = get_state(state_db, gen)
    if state.last_block_height == 0:
        print("state is at height 0; nothing to snapshot",
              file=sys.stderr)
        return 1
    app = _home_app(cfg)
    if not app.supports_snapshots():
        print(f"app {cfg.base.proxy_app!r} does not support state "
              "snapshots", file=sys.stderr)
        return 1
    app_height = app.info().last_block_height
    if app_height != state.last_block_height:
        print(f"app height {app_height} != state height "
              f"{state.last_block_height}; refusing an inconsistent "
              "snapshot (is the node still running?)", file=sys.stderr)
        return 1
    m = store.create(state, app.snapshot_state())
    print(f"snapshot at height {m.height}: {m.chunks} chunks, "
          f"root {m.root.hex()[:16]} -> {store.snapshot_dir(m.height)}")
    return 0


def cmd_snapshot_verify(args) -> int:
    """Re-hash every chunk of every snapshot under a directory against
    its manifest (wal-fsck for snapshots).  Exit 0 only when every
    snapshot is intact; torn/corrupt ones are listed and exit 1."""
    from tendermint_tpu_torch.node.node import make_backend
    from tendermint_tpu_torch.statesync import SnapshotStore
    from tendermint_tpu_torch.statesync.snapshot import MANIFEST_NAME
    backend = make_backend(_load_config(args).base.crypto_backend)
    target = os.path.expanduser(args.dir)
    if os.path.exists(os.path.join(target, MANIFEST_NAME)):
        # a single snapshot-XXXX dir: verify through its parent store
        root, name = os.path.split(os.path.abspath(target))
        store = SnapshotStore(root, backend=backend)
        valid = [m for m in store.list()
                 if store.snapshot_dir(m.height) == os.path.abspath(target)]
        rejects = [(d, w) for d, w in store.scan()[1]
                   if d == os.path.abspath(target)]
        if not valid and not rejects:
            rejects = [(target, "manifest invalid")]
    else:
        store = SnapshotStore(target, backend=backend)
        valid, rejects = store.scan()
    dirty = False
    for sdir, why in rejects:
        print(f"{sdir}: REJECTED ({why})")
        dirty = True
    for m in valid:
        rep = store.verify(m.height)
        if rep["ok"]:
            print(f"height {m.height}: {rep['chunks']} chunks clean")
            continue
        dirty = True
        if rep["missing_chunks"]:
            print(f"height {m.height}: missing chunks "
                  f"{rep['missing_chunks']}")
        if rep["bad_chunks"]:
            print(f"height {m.height}: corrupt chunks "
                  f"{rep['bad_chunks']} (hash mismatch)")
    if not valid and not rejects:
        print(f"no snapshots under {target}")
        return 1
    print("clean" if not dirty else
          "corrupt (a restoring peer would reject these chunks and "
          "blame the server)")
    return 1 if dirty else 0


def cmd_snapshot_restore(args) -> int:
    """Restore a home from a local snapshot: state db + app state +
    a block store bootstrapped at the snapshot height, so the node
    fast-syncs only `snapshot_height -> tip` on next boot.  The data
    dir must be fresh (init or unsafe_reset_all first)."""
    from tendermint_tpu_torch.blockchain.store import BlockStore
    from tendermint_tpu_torch.statesync import (RestoreError, StateSyncer,
                                                StoreSource)
    from tendermint_tpu_torch.types.genesis import GenesisDoc
    from tendermint_tpu_torch.utils.db import new_db
    cfg = _load_config(args)
    gen = GenesisDoc.load(cfg.base.genesis_file())
    os.makedirs(cfg.base.db_dir(), exist_ok=True)
    block_store = BlockStore(new_db("sqlite",
                                    os.path.join(cfg.base.db_dir(),
                                                 "blockstore.db")))
    if block_store.height != 0:
        print(f"block store already at height {block_store.height}; "
              "restore needs a fresh data dir (unsafe_reset_all first)",
              file=sys.stderr)
        return 1
    cfg, store = _snapshot_store(args)
    app = _home_app(cfg)
    if not app.supports_snapshots():
        print(f"app {cfg.base.proxy_app!r} does not support state "
              "snapshots", file=sys.stderr)
        return 1
    src = StoreSource("local", store)
    if args.height:
        # --height pins the offer: only advertise that snapshot (other
        # heights are skipped, not blamed — they're not lying)
        all_manifests = src.manifests
        src.manifests = lambda: [m for m in all_manifests()
                                 if m.height == args.height]
        if not src.manifests():
            print(f"no valid snapshot at height {args.height} under "
                  f"{store.root_dir}", file=sys.stderr)
            return 1
    syncer = StateSyncer([src], backend=store.backend)
    state_db = new_db("sqlite", os.path.join(cfg.base.db_dir(),
                                             "state.db"))
    try:
        state, manifest = syncer.restore(state_db, gen, app)
    except RestoreError as e:
        print(f"restore failed: {e}", file=sys.stderr)
        return 1
    if hasattr(app, "persist_state"):
        app.persist_state()
    block_store.bootstrap(manifest.height)
    print(f"restored height {manifest.height} "
          f"(app_hash {manifest.app_hash.hex()[:16]}); block store "
          f"bootstrapped — next boot fast-syncs from "
          f"{manifest.height + 1}")
    return 0


def _rpc_call(addr: str, method: str, params: dict, timeout: int = 30):
    """One JSON-RPC call; returns the result dict or raises SystemExit
    with a friendly message on an RPC-level error."""
    import urllib.request
    url = addr.rstrip("/")
    if not url.startswith("http"):
        url = "http://" + url
    body = json.dumps({"jsonrpc": "2.0", "id": 1, "method": method,
                       "params": params}).encode()
    req = urllib.request.Request(
        url, data=body, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        reply = json.loads(resp.read())
    if "error" in reply:
        raise SystemExit(f"rpc error: {reply['error'].get('message')} "
                         "(is rpc.unsafe enabled on the node?)")
    return reply["result"]


def _filter_trace(trace: dict, last: int, name: str) -> dict:
    """Apply --last/--name to a Chrome trace document: name filters by
    substring, last keeps the N most recent span/instant events (ts
    order); "M" metadata events always survive so thread names keep
    resolving in the viewer."""
    evs = trace.get("traceEvents", [])
    meta = [e for e in evs if e.get("ph") == "M"]
    spans = [e for e in evs if e.get("ph") != "M"]
    if name:
        spans = [e for e in spans if name in e.get("name", "")]
    if last and last > 0:
        spans = sorted(spans, key=lambda e: e.get("ts", 0))[-last:]
    return {**trace, "traceEvents": spans + meta}


def cmd_trace(args) -> int:
    """Fetch a running node's flight recorder over RPC (or filter a
    local dump with --in) and write it as Chrome trace-event JSON (open
    in Perfetto / chrome://tracing).  --last/--name narrow a 100k-block
    replay dump to the interesting tail without loading the full JSON.
    RPC mode requires the node to run with rpc.unsafe = true."""
    if args.infile:
        with open(args.infile) as f:
            trace = json.load(f)
        total = dropped = None
    else:
        params = {"format": "chrome"}
        if args.last:
            params["last"] = args.last
        if args.name:
            params["name"] = args.name
        result = _rpc_call(args.rpc, "debug_flight_recorder", params)
        trace = result["trace"]
        total, dropped = result["total"], result["dropped"]
    # local filtering applies in both modes (an old node may ignore the
    # RPC params; filtering again is idempotent)
    trace = _filter_trace(trace, args.last, args.name)
    spans = [e for e in trace["traceEvents"] if e.get("ph") != "M"]
    if args.format == "lines":
        for e in sorted(spans, key=lambda e: e.get("ts", 0)):
            dur = e.get("dur", 0.0) / 1e3
            cat = e.get("cat", "-")
            print(f"{e.get('ts', 0) / 1e6:.6f} {dur:10.3f}ms "
                  f"{cat:9s} {e.get('name', '')} "
                  f"{json.dumps(e.get('args', {}))}")
        return 0
    tmp = args.out + ".tmp"
    with open(tmp, "w") as f:
        json.dump(trace, f)
    os.replace(tmp, args.out)
    msg = f"wrote {len(spans)} trace events to {args.out}"
    if total is not None:
        msg += f" (recorder total={total} dropped={dropped})"
    print(msg)
    return 0


def cmd_doctor(args) -> int:
    """Pipeline attribution report: where the wall clock of a replay
    went (compile / transfer / device-busy / scalar / idle) and which
    component is the largest thief of the throughput target.  Reads a
    dumped trace file (--trace, e.g. bench_trace.json) or a live node's
    flight recorder over unsafe RPC (--rpc)."""
    from tendermint_tpu_torch.utils import attribution, ledger as ledger_mod
    if args.trace:
        with open(args.trace) as f:
            spans = attribution.spans_from_chrome(json.load(f))
    else:
        result = _rpc_call(args.rpc, "debug_flight_recorder",
                           {"format": "chrome"})
        spans = attribution.spans_from_chrome(result["trace"])
    regressions = None
    if args.ledger and os.path.exists(args.ledger):
        entries = ledger_mod.load(args.ledger)
        if entries:
            regressions = ledger_mod.compute_deltas(
                entries[:-1], entries[-1].get("configs") or {})
    report = attribution.doctor_report(spans, regressions=regressions)
    if args.json:
        print(json.dumps(report, indent=1))
    else:
        print(attribution.render_report(report))
    return 0


def cmd_timeline(args) -> int:
    """Merged consensus timeline across a rig: collect every node's
    height-lifecycle records (--rpc addr,addr,... via the unsafe
    debug_timeline route, skew-normalized on each node's wall-clock
    sample) or re-derive them from a dumped Chrome trace (--trace),
    write a per-node-track Chrome trace to --out, and print the
    consensus doctor report naming the largest thief per height
    range."""
    import time as _time
    from tendermint_tpu_torch import telemetry
    if args.trace:
        from tendermint_tpu_torch.utils import attribution
        with open(args.trace) as f:
            records = telemetry.records_from_spans(
                attribution.spans_from_chrome(json.load(f)))
        merged = {"records": records, "dropped": {}, "offsets": {}}
    else:
        dumps = []
        for addr in [a for a in args.rpc.split(",") if a.strip()]:
            try:
                d = _rpc_call(addr.strip(), "debug_timeline",
                              {"last": args.last} if args.last else {})
            except SystemExit:
                raise
            except Exception as e:   # a dead node degrades, not aborts
                d = {"node": addr.strip(), "records": None,
                     "error": str(e)}
            dumps.append(d)
        merged = telemetry.merge_dumps(dumps, ref_wall=_time.time())
    timeline = telemetry.build_timeline(merged["records"])
    report = telemetry.consensus_doctor(timeline, range_len=args.range)
    if args.out:
        trace = telemetry.to_chrome_trace(timeline)
        tmp = args.out + ".tmp"
        with open(tmp, "w") as f:
            json.dump(trace, f)
        os.replace(tmp, args.out)
    if args.json:
        print(json.dumps({"timeline": timeline, "doctor": report,
                          "dropped": merged["dropped"]}, indent=1))
    else:
        if args.out:
            n = len(timeline["nodes"])
            print(f"wrote timeline trace ({n} node tracks, heights "
                  f"{timeline['height_range'][0]}.."
                  f"{timeline['height_range'][1]}) to {args.out}")
        for node, why in merged["dropped"].items():
            print(f"dropped {node}: {why}")
        print(telemetry.render_consensus_report(report))
    return 0 if not merged["dropped"] else 1


def cmd_bench_history(args) -> int:
    """Render the bench regression ledger: every recorded run's
    per-config rates with deltas vs the best PRIOR run, so a slow creep
    across runs reads as clearly as a cliff in one."""
    from tendermint_tpu_torch.utils import ledger as ledger_mod
    entries = ledger_mod.load(args.ledger)
    print(ledger_mod.render_history(entries))
    return 1 if not entries else 0


def cmd_lint(args) -> int:
    """Run the tmlint static checks (tendermint_tpu_torch/analysis/): lock
    discipline, torch hot-path hygiene, RPC route gating, span/metric
    conventions, the batch plane.  Exit 0 when every finding is
    baselined or suppressed, 1 when fresh findings exist, 2 when a lint
    path is missing."""
    from tendermint_tpu_torch.analysis import (all_rules, baseline_path,
                                               lint_paths, load_baseline,
                                               save_baseline)
    if args.list_rules:
        for name, desc in all_rules():
            print(f"{name:24s} {desc}")
        return 0
    import tendermint_tpu_torch
    pkg_dir = os.path.dirname(os.path.abspath(tendermint_tpu_torch.__file__))
    if args.paths:
        paths, root = args.paths, None
    else:
        paths, root = [pkg_dir], os.path.dirname(pkg_dir)
    missing = [p for p in paths if not os.path.exists(p)]
    if missing:
        print(f"lint: no such path: {', '.join(missing)}",
              file=sys.stderr)
        return 2
    result = lint_paths(paths, root=root,
                        rules=args.rules.split(",") if args.rules
                        else None)
    bl_path = args.baseline or baseline_path()
    if args.update_baseline:
        save_baseline(result.findings, bl_path)
        print(f"baseline written: {len(result.findings)} findings "
              f"grandfathered at {bl_path}")
        return 0
    baseline = load_baseline(bl_path)
    fresh = result.fresh(baseline)
    if args.json:
        print(json.dumps(result.to_dict(baseline), indent=1))
    else:
        for f in result.findings:
            tag = "" if f.fingerprint not in baseline else " [baselined]"
            print(f.render() + tag)
        print(f"{result.files} files, {len(result.findings)} findings "
              f"({len(fresh)} fresh, {result.suppressed} suppressed)")
        for e in result.errors:
            print(f"parse error: {e}", file=sys.stderr)
    return 1 if fresh or result.errors else 0


def _print_scenario_result(result, as_json: bool) -> None:
    if as_json:
        print(json.dumps(result.to_dict(), indent=1))
        return
    verdict = "PASS" if result.ok else "FAIL"
    print(f"{verdict} {result.name} seed={result.seed} "
          f"({result.duration_s:.1f}s) "
          f"event_log_hash={result.event_log_hash[:16]}")
    for f in result.failures:
        print(f"  FAILED {f}")
    for b in result.budget_breaches:
        print(f"  OVER-BUDGET {b}")
    if result.artifact_dir:
        print(f"  artifacts: {result.artifact_dir}")


def cmd_chaos_list(args) -> int:
    """Catalogue of registered fault scenarios."""
    from tendermint_tpu_torch.scenarios import SCENARIOS
    if args.json:
        print(json.dumps({
            name: {"description": sc.description,
                   "tier": "smoke" if sc.smoke else "stress",
                   "safety": [n for n, _ in sc.safety],
                   "liveness": [n for n, _ in sc.liveness]}
            for name, sc in sorted(SCENARIOS.items())}, indent=1))
        return 0
    for name, sc in sorted(SCENARIOS.items()):
        tier = "smoke " if sc.smoke else "stress"
        print(f"{name:24s} [{tier}] {sc.description}")
        print(f"{'':24s}  safety: "
              + ", ".join(n for n, _ in sc.safety))
        print(f"{'':24s}  liveness: "
              + ", ".join(n for n, _ in sc.liveness))
    return 0


def cmd_chaos_run(args) -> int:
    """Run one scenario; exit 0 when every invariant held and the run
    stayed inside its declared budget.  The same --seed replays the same
    injected-fault schedule bit-identically (verify with the printed
    event_log_hash).  With --seed-range A:B the scenario is swept over
    the half-open seed range instead.  With no --backend the run is on
    the card (the card twin of the scenario's declared backend)."""
    from tendermint_tpu_torch.scenarios import (parse_seed_range, run_scenario,
                                          run_sweep)
    backend = getattr(args, "backend", "") or None
    if getattr(args, "seed_range", ""):
        seeds = parse_seed_range(args.seed_range)
        out = run_sweep(
            [args.scenario], seeds,
            artifacts=args.artifacts or None,
            keep_artifacts=args.keep_artifacts, ledger_path=None,
            backend=backend,
            progress=(None if args.json
                      else lambda r: _print_scenario_result(r, False)))
        summary = out["summary"]
        if args.json:
            print(json.dumps(summary, indent=1))
        else:
            a = summary["configs"][args.scenario]
            print(f"sweep {args.scenario} seeds {args.seed_range}: "
                  f"{a['runs'] - a['failures']}/{a['runs']} passed, "
                  f"{a['breaches']} over budget (mean "
                  f"{a['mean_duration_s']}s, max {a['max_duration_s']}s, "
                  f"budget {a['budget_s']}s)")
        bad = summary["total_failures"] or summary["total_breaches"]
        return 1 if bad else 0
    result = run_scenario(args.scenario, seed=args.seed,
                          artifacts=args.artifacts or None,
                          keep_artifacts=args.keep_artifacts,
                          backend=backend)
    _print_scenario_result(result, args.json)
    return 0 if result.ok and not result.budget_breaches else 1


def cmd_chaos_replay(args) -> int:
    """Re-run a scenario from a dumped result.json manifest and compare
    event-log hashes: MATCH means the replayed run injected the exact
    fault schedule of the original (the seed-replay contract); DIVERGED
    means the scenario gained nondeterminism and its artifacts can no
    longer be trusted as reproductions."""
    from tendermint_tpu_torch.scenarios import run_scenario
    with open(args.manifest) as f:
        manifest = json.load(f)
    name, seed = manifest["scenario"], manifest["seed"]
    want = manifest["event_log_hash"]
    # the backend rung is part of the hashed plan: a replay must run on
    # the SAME rung the original did or the hashes diverge by design
    result = run_scenario(name, seed=seed,
                          artifacts=args.artifacts or None,
                          keep_artifacts=args.keep_artifacts,
                          backend=manifest.get("backend") or None)
    _print_scenario_result(result, args.json)
    if result.event_log_hash == want:
        print(f"MATCH: replay reproduced event log {want[:16]}")
        return 0 if result.ok else 1
    print(f"DIVERGED: original {want[:16]} != replay "
          f"{result.event_log_hash[:16]} — scenario is nondeterministic")
    return 1


def _smoke_tier(scenarios: dict, smoke_order: list) -> list:
    """The smoke tier in cheapest-first order: `SMOKE_ORDER`, then any
    other smoke scenario by name."""
    names = [n for n in smoke_order if n in scenarios]
    return names + sorted(n for n, sc in scenarios.items()
                          if sc.smoke and n not in names)


def cmd_chaos_smoke(args) -> int:
    """The fast smoke subset under a wall-clock budget: scenarios run in
    cheapest-first order and the remainder is SKIPPED (reported, never
    silently dropped) once the budget is spent.  The faults-tier CI
    entry point."""
    import time as _time
    from tendermint_tpu_torch.scenarios import (SCENARIOS, SMOKE_ORDER,
                                                run_scenario)
    t0 = _time.time()
    failed, skipped, results = [], [], []
    for name in _smoke_tier(SCENARIOS, SMOKE_ORDER):
        spent = _time.time() - t0
        if args.budget and spent >= args.budget:
            skipped.append(name)
            continue
        result = run_scenario(name, seed=args.seed,
                              artifacts=args.artifacts or None,
                              keep_artifacts=args.keep_artifacts,
                              backend=getattr(args, "backend", "") or None)
        results.append(result)
        _print_scenario_result(result, args.json)
        if not result.ok:
            failed.append(name)
    for name in skipped:
        print(f"SKIP {name} (budget {args.budget:.0f}s spent)")
    print(f"chaos smoke: {len(results) - len(failed)}/{len(results)} "
          f"passed, {len(skipped)} skipped "
          f"in {_time.time() - t0:.1f}s")
    return 1 if failed else 0


def _chaos_sweep(args, names: list, label: str, row: dict,
                 summary: dict, per_run_ledger: bool) -> int:
    """The seed sweep `chaos soak` and `chaos nightly` share: each of
    `names` (or `--scenarios`, unknown names refused with 2) over
    `--seed-range` until the global `--budget` is spent, the rest
    reported SKIPPED; with `--budget-ledger` one aggregate row (`row`'s
    fields first) and, with `per_run_ledger`, every seed's own entry;
    the JSON summary (`summary`'s fields first) or the text report.
    Non-zero on any invariant failure or budget breach."""
    import time as _time
    from tendermint_tpu_torch.scenarios import (SCENARIOS, parse_seed_range,
                                                run_sweep)
    from tendermint_tpu_torch.scenarios.engine import CHAOS_LEDGER_SCHEMA
    from tendermint_tpu_torch.utils import ledger as ledgermod
    seeds = parse_seed_range(args.seed_range)
    if args.scenarios:
        want = [s.strip() for s in args.scenarios.split(",") if s.strip()]
        unknown = [w for w in want if w not in SCENARIOS]
        if unknown:
            print(f"unknown scenarios: {', '.join(unknown)} "
                  f"(see `chaos list`)", file=sys.stderr)
            return 2
        names = want                       # an explicit list overrides
    backend = getattr(args, "backend", "") or None
    t0 = _time.time()
    skipped: list[str] = []
    all_results: list = []
    configs: dict = {}
    progress = (None if args.json
                else lambda r: _print_scenario_result(r, False))
    for name in names:
        if args.budget and _time.time() - t0 >= args.budget:
            skipped.append(name)
            continue
        # per-run ledger entries (the nightly's) carry each seed's
        # per-metric budget verdicts: a regression bisects to the exact
        # scenario and seed
        out = run_sweep([name], seeds, artifacts=args.artifacts or None,
                        keep_artifacts=args.keep_artifacts,
                        ledger_path=(args.budget_ledger or None
                                     if per_run_ledger else None),
                        progress=progress, backend=backend)
        configs.update(out["summary"]["configs"])
        all_results.extend(out["results"])
    failures = [r for r in all_results if not r.ok]
    breaches = [r for r in all_results if r.budget_breaches]
    triage = sorted({r.artifact_dir for r in failures + breaches
                     if r.artifact_dir})
    deltas: dict = {}
    if args.budget_ledger:
        prior = [e for e in ledgermod.load(args.budget_ledger)
                 if e.get("schema") == CHAOS_LEDGER_SCHEMA]
        deltas = ledgermod.compute_deltas(prior, configs)
        ledgermod.append_entry(args.budget_ledger, {
            "schema": CHAOS_LEDGER_SCHEMA, **row,
            "seed_range": args.seed_range, "n_seeds": len(seeds),
            "configs": configs, "skipped": skipped,
            **({"backend": backend or ""} if per_run_ledger else {}),
            "timestamp": _time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                        _time.gmtime())})
    if args.json:
        print(json.dumps({
            **summary, "seed_range": args.seed_range, "configs": configs,
            "skipped": skipped, "deltas": deltas,
            "runs": len(all_results), "failures": len(failures),
            "breaches": len(breaches), "triage": triage,
            "duration_s": round(_time.time() - t0, 1)}, indent=1))
        return 1 if failures or breaches else 0
    for name in skipped:
        print(f"SKIP {name} x{len(seeds)} seeds "
              f"(global budget {args.budget:.0f}s spent)")
    for d in triage:
        print(f"triage: {d}")
    regressions = sorted(n for n, r in deltas.items() if r.get("regression"))
    if regressions:
        print(f"rate regressions vs best prior: {', '.join(regressions)}")
    print(f"chaos {label} seeds {args.seed_range}: "
          f"{len(all_results) - len(failures)}/{len(all_results)} passed, "
          f"{len(breaches)} over budget, {len(skipped)} scenarios "
          f"skipped in {_time.time() - t0:.1f}s"
          + (f" (ledger: {args.budget_ledger})"
             if args.budget_ledger else ""))
    return 1 if failures or breaches else 0


def cmd_chaos_soak(args) -> int:
    """Nightly seed-sweep soak: sweep a catalogue tier across a seed
    range with per-scenario declared budgets and a global wall cap.
    Never silent — scenarios that don't fit the global budget are
    reported as SKIPPED, every failed or over-budget run prints its
    triage bundle path, and per-scenario rates land in the chaos ledger
    so a fault-path latency regression bisects like a bench regression.
    Exits nonzero on any invariant failure or budget breach."""
    from tendermint_tpu_torch.scenarios import SCENARIOS, SMOKE_ORDER
    smoke = _smoke_tier(SCENARIOS, SMOKE_ORDER)
    stress = sorted(n for n, sc in SCENARIOS.items() if not sc.smoke)
    names = {"smoke": smoke, "stress": stress,
             "all": smoke + stress}[args.tier]
    return _chaos_sweep(args, names, f"soak [{args.tier}]",
                        {"soak": True, "tier": args.tier},
                        {"tier": args.tier}, per_run_ledger=False)


def cmd_chaos_nightly(args) -> int:
    """The nightly soak gate: sweep the FULL catalogue (smoke tier in
    cheapest-first order, then every stress rig) across a seed range,
    with per-seed metric-budget verdicts ledgered to the chaos ledger
    and a durable triage bundle for every failed or over-budget run.
    This is `chaos soak --tier all` hardened into a gate: per-run
    ledger entries (schema tpu-bft-chaos-run/1) land for every seed so
    a budget regression bisects to the exact scenario+seed, scenarios
    that miss the global wall cap are reported as SKIPPED (a skip is
    visible in the summary and the ledger, never silent), and the exit
    code is nonzero on any invariant failure or metric/wall budget
    breach."""
    from tendermint_tpu_torch.scenarios import SCENARIOS, SMOKE_ORDER
    names = _smoke_tier(SCENARIOS, SMOKE_ORDER) + sorted(
        n for n, sc in SCENARIOS.items() if not sc.smoke)
    return _chaos_sweep(args, names, "nightly", {"nightly": True}, {},
                        per_run_ledger=True)


def cmd_version(args) -> int:
    print(__version__)
    return 0


def cmd_probe_upnp(args) -> int:
    """Test UPnP functionality (reference
    `cmd/tendermint/commands/probe_upnp.go:1-35`)."""
    import json as _json
    from tendermint_tpu_torch.p2p import upnp
    try:
        caps = upnp.probe(int_port=args.int_port, ext_port=args.ext_port)
    except upnp.UPnPError as e:
        print(f"Probe failed: {e}")
        return 1
    print("Probe success!")
    print(_json.dumps(caps))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tendermint_tpu_torch",
                                description="BFT replication on the H100")
    p.add_argument("--home", default="~/.tendermint_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)

    sp = sub.add_parser("init", help="initialize home dir")
    sp.add_argument("--chain-id", default="")
    sp.add_argument("--warm-crypto", dest="warm_crypto",
                    action="store_true",
                    help="build the kernel library and the genesis "
                         "validator set's comb tables into the home's "
                         "on-disk cache (one-time; makes the first node "
                         "boot verify-warm)")
    sp.set_defaults(fn=cmd_init)

    sp = sub.add_parser("node", help="run the node")
    sp.add_argument("--proxy-app", dest="proxy_app", default="")
    sp.add_argument("--chain-id", default="")
    sp.add_argument("--rpc-laddr", dest="rpc_laddr", default="")
    sp.add_argument("--p2p-laddr", dest="p2p_laddr", default="")
    sp.add_argument("--seeds", default="")
    sp.add_argument("--crypto-backend", dest="crypto_backend", default="")
    sp.add_argument("--fast-sync", dest="fast_sync", action="store_true",
                    default=None)
    sp.add_argument("--no-fast-sync", dest="fast_sync",
                    action="store_false")
    sp.add_argument("--crypto-supervised", dest="crypto_supervised",
                    action="store_true", default=None,
                    help="wrap the crypto backend in the fault-tolerant "
                         "ladder (cuda -> native -> python: timeouts, "
                         "retry, circuit breaker)")
    sp.add_argument("--no-crypto-supervised", dest="crypto_supervised",
                    action="store_false")
    sp.add_argument("--crypto-breaker-threshold", type=int, default=0,
                    dest="crypto_breaker_threshold",
                    help="consecutive device faults before the breaker "
                         "trips to the next rung")
    sp.add_argument("--crypto-call-timeout", type=float, default=0.0,
                    dest="crypto_call_timeout",
                    help="per-call device timeout in seconds")
    sp.add_argument("--crypto-spot-check", type=int, default=0,
                    dest="crypto_spot_check",
                    help="re-verify one lane of every Nth device batch "
                         "on the reference backend (0 = off)")
    sp.set_defaults(fn=cmd_node)

    sp = sub.add_parser("testnet", help="generate a local testnet")
    sp.add_argument("--n", type=int, default=4)
    sp.add_argument("--output", default="./mytestnet")
    sp.add_argument("--chain-id", default="")
    sp.add_argument("--base-port", dest="base_port", type=int, default=26656)
    sp.set_defaults(fn=cmd_testnet)

    sp = sub.add_parser("gen_validator", help="print a fresh key")
    sp.set_defaults(fn=cmd_gen_validator)

    sp = sub.add_parser("show_validator", help="print this node's key")
    sp.set_defaults(fn=cmd_show_validator)

    sp = sub.add_parser("unsafe_reset_all", help="wipe data dir")
    sp.set_defaults(fn=cmd_unsafe_reset_all)

    sp = sub.add_parser("replay_console",
                        help="step through the consensus WAL")
    sp.set_defaults(fn=cmd_replay_console)

    sp = sub.add_parser("replay", help="replay blocks into the app")
    sp.add_argument("--proxy-app", dest="proxy_app", default="")
    sp.set_defaults(fn=cmd_replay)

    sp = sub.add_parser("wal-fsck", help="check/repair the consensus WAL")
    sp.add_argument("--wal", default="",
                    help="explicit WAL path (default: <data dir>/cs.wal)")
    sp.add_argument("--repair", action="store_true",
                    help="rewrite the log keeping only valid records")
    sp.set_defaults(fn=cmd_wal_fsck)

    sp = sub.add_parser("snapshot",
                        help="state snapshots: create, verify, restore "
                             "(crashed nodes rejoin from a snapshot + a "
                             "short fast-sync tail instead of a full "
                             "replay)")
    snap_sub = sp.add_subparsers(dest="snapshot_command", required=True)

    ssp = snap_sub.add_parser("list", help="list snapshots (torn ones "
                                           "flagged)")
    ssp.add_argument("--dir", default="",
                     help="snapshot root (default: <data dir>/snapshots)")
    ssp.add_argument("--json", action="store_true")
    ssp.set_defaults(fn=cmd_snapshot_list)

    ssp = snap_sub.add_parser("create",
                              help="snapshot the home's committed state")
    ssp.add_argument("--dir", default="",
                     help="snapshot root (default: <data dir>/snapshots)")
    ssp.set_defaults(fn=cmd_snapshot_create)

    ssp = snap_sub.add_parser(
        "verify", help="re-hash every chunk against its manifest "
                       "(wal-fsck for snapshots); exit 1 on any mismatch")
    ssp.add_argument("dir", help="snapshot root or a single "
                                 "snapshot-<height> directory")
    ssp.set_defaults(fn=cmd_snapshot_verify)

    ssp = snap_sub.add_parser(
        "restore", help="restore a FRESH data dir from a snapshot; the "
                        "next boot fast-syncs only the tail")
    ssp.add_argument("--dir", default="",
                     help="snapshot root (default: <data dir>/snapshots)")
    ssp.add_argument("--height", type=int, default=0,
                     help="restore this height (default: best available)")
    ssp.set_defaults(fn=cmd_snapshot_restore)

    sp = sub.add_parser("trace",
                        help="dump a node's flight recorder as Chrome "
                             "trace JSON")
    sp.add_argument("--rpc", default="http://127.0.0.1:26657",
                    help="node RPC address")
    sp.add_argument("--out", default="flight_trace.json",
                    help="output Chrome trace-event JSON path")
    sp.add_argument("--in", dest="infile", default="",
                    help="filter a local trace dump instead of RPC")
    sp.add_argument("--last", type=int, default=0,
                    help="keep only the N most recent spans")
    sp.add_argument("--name", default="",
                    help="keep only spans whose name contains SUBSTR")
    sp.add_argument("--format", choices=("chrome", "lines"),
                    default="chrome",
                    help="chrome: write JSON to --out; lines: print "
                         "one span per line to stdout")
    sp.set_defaults(fn=cmd_trace)

    sp = sub.add_parser("doctor",
                        help="pipeline attribution report: where the "
                             "wall clock went, largest thief of the "
                             "throughput target")
    sp.add_argument("--trace", default="",
                    help="read spans from a Chrome trace dump "
                         "(a flight-recorder dump) instead of RPC")
    sp.add_argument("--rpc", default="http://127.0.0.1:26657",
                    help="node RPC address (used when --trace unset)")
    sp.add_argument("--ledger", default="BENCH_LEDGER.jsonl",
                    help="bench ledger to fold regression flags from "
                         "('' to skip)")
    sp.add_argument("--json", action="store_true",
                    help="print the machine-readable report instead of "
                         "the human summary")
    sp.set_defaults(fn=cmd_doctor)

    sp = sub.add_parser("timeline",
                        help="merged consensus timeline: one Chrome "
                             "track per node + consensus doctor report")
    sp.add_argument("--rpc", default="http://127.0.0.1:26657",
                    help="comma-separated node RPC addresses "
                         "(unsafe debug_timeline route)")
    sp.add_argument("--trace", default="",
                    help="re-derive the timeline from a Chrome trace "
                         "dump instead of RPC")
    sp.add_argument("--out", default="timeline_trace.json",
                    help="output Chrome trace path ('' to skip)")
    sp.add_argument("--last", type=int, default=0,
                    help="fetch only the N most recent heights per node")
    sp.add_argument("--range", type=int, default=10,
                    help="doctor height-range chunk length")
    sp.add_argument("--json", action="store_true",
                    help="print machine-readable timeline + doctor "
                         "report")
    sp.set_defaults(fn=cmd_timeline)

    sp = sub.add_parser("bench-history",
                        help="render the bench regression ledger with "
                             "per-config deltas vs best prior run")
    sp.add_argument("--ledger", default="BENCH_LEDGER.jsonl",
                    help="ledger JSONL path (tpu-bft-bench-ledger/1)")
    sp.set_defaults(fn=cmd_bench_history)

    sp = sub.add_parser("lint",
                        help="run the tmlint static invariant checks "
                             "(lock discipline, torch hot-path hygiene, "
                             "route gating, span/metric conventions)")
    sp.add_argument("paths", nargs="*",
                    help="files/dirs to lint (default: the "
                         "tendermint_tpu_torch package)")
    sp.add_argument("--json", action="store_true",
                    help="machine-readable findings document")
    sp.add_argument("--rules", default="",
                    help="comma-separated rule subset to run")
    sp.add_argument("--baseline", default="",
                    help="baseline file (default: "
                         "tendermint_tpu_torch/analysis/baseline.json)")
    sp.add_argument("--update-baseline", action="store_true",
                    dest="update_baseline",
                    help="grandfather the current findings and exit 0")
    sp.add_argument("--list-rules", action="store_true",
                    dest="list_rules", help="print the rule catalog")
    sp.set_defaults(fn=cmd_lint)

    sp = sub.add_parser("chaos",
                        help="deterministic fault-scenario harness "
                             "(byzantine votes, partitions, crash "
                             "storms, device faults)")
    chaos_sub = sp.add_subparsers(dest="chaos_command", required=True)

    def _chaos_common(csp, scenario_arg: bool):
        from tendermint_tpu_torch.scenarios.engine import (DEFAULT_SEED,
                                                           KNOWN_BACKENDS)
        if scenario_arg:
            csp.add_argument("--scenario", required=True,
                             help="scenario name (see `chaos list`)")
        csp.add_argument("--seed", type=int, default=DEFAULT_SEED,
                         help="scenario seed; the same seed replays the "
                              "same fault schedule (default: %(default)s)")
        csp.add_argument("--backend", choices=list(KNOWN_BACKENDS),
                         default="",
                         help="crypto backend for the run (default: the "
                              "card twin of the scenario's declared one)")
        csp.add_argument("--artifacts", default="",
                         help="artifact root (default: ./chaos_artifacts)")
        csp.add_argument("--keep-artifacts", dest="keep_artifacts",
                         action="store_true",
                         help="dump trace/metrics/events/result even on "
                              "a passing run")
        csp.add_argument("--json", action="store_true",
                         help="machine-readable result")

    csp = chaos_sub.add_parser("list", help="catalogue of scenarios")
    csp.add_argument("--json", action="store_true")
    csp.set_defaults(fn=cmd_chaos_list)

    csp = chaos_sub.add_parser("run", help="run one scenario")
    _chaos_common(csp, scenario_arg=True)
    csp.add_argument("--seed-range", dest="seed_range", default="",
                     help="sweep a half-open seed range A:B (e.g. 0:25) "
                          "instead of the single --seed")
    csp.set_defaults(fn=cmd_chaos_run)

    csp = chaos_sub.add_parser(
        "replay", help="re-run from a dumped result.json and check the "
                       "event-log hash matches")
    csp.add_argument("--manifest", required=True,
                     help="path to a result.json from a prior run")
    csp.add_argument("--artifacts", default="")
    csp.add_argument("--keep-artifacts", dest="keep_artifacts",
                     action="store_true")
    csp.add_argument("--json", action="store_true")
    csp.set_defaults(fn=cmd_chaos_replay)

    csp = chaos_sub.add_parser(
        "smoke", help="run the smoke subset under a time budget")
    _chaos_common(csp, scenario_arg=False)
    csp.add_argument("--budget", type=float, default=300.0,
                     help="wall-clock budget in seconds; scenarios that "
                          "don't fit are reported as skipped "
                          "(default: %(default)s)")
    csp.set_defaults(fn=cmd_chaos_smoke)

    from tendermint_tpu_torch.scenarios.engine import (
        DEFAULT_CHAOS_LEDGER, KNOWN_BACKENDS as _KNOWN_BACKENDS)
    csp = chaos_sub.add_parser(
        "soak", help="nightly seed-sweep soak across a catalogue tier "
                     "with budget enforcement and a chaos ledger")
    csp.add_argument("--seed-range", dest="seed_range", default="0:3",
                     help="half-open seed range A:B to sweep "
                          "(default: %(default)s)")
    csp.add_argument("--tier", choices=["smoke", "stress", "all"],
                     default="smoke",
                     help="catalogue tier to sweep (default: %(default)s)")
    csp.add_argument("--scenarios", default="",
                     help="comma-separated scenario names; overrides "
                          "--tier when given")
    csp.add_argument("--budget", type=float, default=0.0,
                     help="global wall-clock cap in seconds; scenarios "
                          "that don't fit are reported as SKIPPED, never "
                          "silently dropped (0 = uncapped)")
    csp.add_argument("--budget-ledger", dest="budget_ledger",
                     default=DEFAULT_CHAOS_LEDGER,
                     help="chaos ledger path for per-scenario rates and "
                          "regression deltas; empty to disable "
                          "(default: %(default)s)")
    csp.add_argument("--backend", choices=list(_KNOWN_BACKENDS),
                     default="",
                     help="crypto backend for every run (default: the "
                          "card twin of each scenario's declared one)")
    csp.add_argument("--artifacts", default="")
    csp.add_argument("--keep-artifacts", dest="keep_artifacts",
                     action="store_true")
    csp.add_argument("--json", action="store_true")
    csp.set_defaults(fn=cmd_chaos_soak)

    csp = chaos_sub.add_parser(
        "nightly", help="the nightly soak gate: full-catalogue seed "
                        "sweep with per-seed metric-budget verdicts "
                        "ledgered and durable triage bundles on breach")
    csp.add_argument("--seed-range", dest="seed_range", default="0:5",
                     help="half-open seed range A:B to sweep "
                          "(default: %(default)s)")
    csp.add_argument("--scenarios", default="",
                     help="comma-separated scenario names; overrides "
                          "the full catalogue when given")
    csp.add_argument("--budget", type=float, default=0.0,
                     help="global wall-clock cap in seconds; scenarios "
                          "that don't fit are reported as SKIPPED, never "
                          "silently dropped (0 = uncapped)")
    csp.add_argument("--budget-ledger", dest="budget_ledger",
                     default=DEFAULT_CHAOS_LEDGER,
                     help="chaos ledger path; every seed's run lands as "
                          "its own entry with metric-budget verdicts, "
                          "plus one aggregate row (default: %(default)s)")
    csp.add_argument("--backend", choices=list(_KNOWN_BACKENDS),
                     default="",
                     help="crypto backend for every run (default: the "
                          "card twin of each scenario's declared one)")
    csp.add_argument("--artifacts", default="")
    csp.add_argument("--keep-artifacts", dest="keep_artifacts",
                     action="store_true")
    csp.add_argument("--json", action="store_true")
    csp.set_defaults(fn=cmd_chaos_nightly)

    sp = sub.add_parser("version", help="print version")
    sp.set_defaults(fn=cmd_version)

    sp = sub.add_parser("probe_upnp", help="test UPnP functionality")
    sp.add_argument("--int-port", dest="int_port", type=int, default=20000)
    sp.add_argument("--ext-port", dest="ext_port", type=int, default=20000)
    sp.set_defaults(fn=cmd_probe_upnp)

    args = p.parse_args(argv)
    return args.fn(args)
