"""Command-line interface.

Reference: `cmd/tendermint/commands/` — `init`, `node`, `testnet`,
`gen_validator`, `show_validator`, `replay`, `unsafe_reset_all`,
`version` (file-per-command, root at `root.go:36-52`).  argparse-based;
every command takes --home.

Run as `python -m tendermint_tpu_torch.cli <command>`.

Copy of `tendermint_tpu/cli/__init__.py` with the commands `init`,
`node`, `testnet`, `gen_validator`, `show_validator`, `unsafe_reset_all`,
`replay`, `replay_console`, `wal-fsck` and `version` and their flags.
The supervised-ladder flags, `init --warm-crypto` and the `snapshot`,
`trace`, `doctor`, `timeline`, `bench-history`, `lint`, `chaos` and
`probe_upnp` commands wait for the modules they drive.  `--home` defaults
to `~/.tendermint_tpu_torch`, so a port node and a JAX node never share a
home, and no environment variable (`TM_HOME`) sets it.  A node runs on
the card unless its config or `--crypto-backend` says otherwise; a fault
of the node, or an error out of building it, exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import logging
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
    return 0


def cmd_node(args) -> int:
    """Run the node (reference run_node.go)."""
    from tendermint_tpu_torch.node.node import Node
    cfg = _load_config(args)
    logging.basicConfig(
        level=cfg.base.log_level.upper(), stream=sys.stderr,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    node = Node(cfg)
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


def cmd_version(args) -> int:
    print(__version__)
    return 0




def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tendermint_tpu_torch",
                                description="BFT replication on the H100")
    p.add_argument("--home", default="~/.tendermint_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)

    sp = sub.add_parser("init", help="initialize home dir")
    sp.add_argument("--chain-id", default="")
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

    sp = sub.add_parser("version", help="print version")
    sp.set_defaults(fn=cmd_version)

    args = p.parse_args(argv)
    return args.fn(args)
