"""The port's consensus WAL and its replay held against the JAX package's:
the same writes give the same file bytes, each package reads the other's
files, the corruption cases of `tests/test_wal_corruption.py` (interior
body and length-field flips, a torn tail, early corruption before the
replay's marker, fsck report and repair) give the same records on both;
and a 4-validator net of each package writes WALs that the other
package's `Playback` and a restarted `ConsensusState` replay to the same
stored rows (blocks, seen commits) and app hashes, corrupted copies
too."""

import os
import shutil
import struct
import time

import pytest

from tendermint_tpu.blockchain.store import BlockStore as JBlockStore
from tendermint_tpu.config import test_config as jfast_config
from tendermint_tpu.consensus import messages as JM
from tendermint_tpu.consensus.replay import Playback as JPlayback
from tendermint_tpu.consensus.state import ConsensusState as JConsensusState
from tendermint_tpu.consensus.ticker import MockTicker as JMockTicker
from tendermint_tpu.consensus.wal import WAL as JWAL
from tendermint_tpu.crypto import backend as jcb
from tendermint_tpu.mempool.mempool import Mempool as JMempool
from tendermint_tpu.proxy import ClientCreator as JClientCreator
from tendermint_tpu.state import execution as jexec
from tendermint_tpu.state.state import get_state as jget_state
from tendermint_tpu.types import Block as JBlock
from tendermint_tpu.types import PrivKey as JPrivKey
from tendermint_tpu.types.block import Commit as JCommit
from tendermint_tpu.types.codec import Reader as JReader
from tendermint_tpu.types.priv_validator import PrivValidator as JPrivValidator
from tendermint_tpu.utils.db import MemDB as JMemDB
from tendermint_tpu_torch.batchplane import BatchPlane
from tendermint_tpu_torch.blockchain.store import BlockStore
from tendermint_tpu_torch.config import test_config as fast_config
from tendermint_tpu_torch.consensus import messages as M
from tendermint_tpu_torch.consensus.replay import Playback
from tendermint_tpu_torch.consensus.state import ConsensusState
from tendermint_tpu_torch.consensus.ticker import MockTicker
from tendermint_tpu_torch.consensus.wal import (REC_ENDHEIGHT, REC_MESSAGE,
                                                WAL)
from tendermint_tpu_torch.crypto import pure_ed25519 as ref
from tendermint_tpu_torch.crypto.backend import PythonBackend
from tendermint_tpu_torch.mempool.mempool import Mempool
from tendermint_tpu_torch.proxy import ClientCreator
from tendermint_tpu_torch.state import execution
from tendermint_tpu_torch.state.state import get_state
from tendermint_tpu_torch.types import (Block, Commit, GenesisDoc,
                                        GenesisValidator, PrivKey)
from tendermint_tpu_torch.types.codec import Reader
from tendermint_tpu_torch.types.priv_validator import PrivValidator
from tendermint_tpu_torch.utils.db import MemDB

from torch_chains import jax_genesis

CHAIN = "wal-chain"
N_VALS, HEIGHT, RESTART_AT = 4, 3, 2
WALS = {"port": WAL, "jax": JWAL}


@pytest.fixture(autouse=True)
def _jax_python_backend():
    old = jcb._current
    jcb.set_backend("python")
    yield
    jcb._current = old


# -- frames --------------------------------------------------------------

def _write_wal(wal_cls, path, heights=3, msgs_per_height=4):
    """`tests/test_wal_corruption.py`'s log, with a timeout per height."""
    w = wal_cls(path)
    for h in range(1, heights + 1):
        for i in range(msgs_per_height):
            w.save_message(bytes([h, i]) * (10 + i))
        w.save_timeout(h, i, 3)
        w.write_end_height(h)
    w.close()


def _record_bounds(path):
    data = open(path, "rb").read()
    bounds, pos = [], 0
    while pos + 8 <= len(data):
        ln = struct.unpack_from(">II", data, pos)[0]
        if pos + 8 + ln > len(data):
            break
        bounds.append(pos)
        pos += 8 + ln
    return bounds


def _flip_byte(path, offset):
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 0xFF]))


def test_wal_files_are_byte_equal_and_cross_read(tmp_path):
    paths = {k: str(tmp_path / f"{k}.wal") for k in WALS}
    for k, cls in WALS.items():
        _write_wal(cls, paths[k])
    data = open(paths["port"], "rb").read()
    assert data == open(paths["jax"], "rb").read()
    assert WAL.read_all(paths["jax"]) == JWAL.read_all(paths["port"])
    assert len(WAL.read_all(paths["jax"])) == 18
    for h in range(1, 5):
        assert WAL.records_since_height(paths["jax"], h) == \
            JWAL.records_since_height(paths["port"], h)


def _corrupt(case, path):
    """Apply one corruption of `tests/test_wal_corruption.py:57-110`."""
    bounds = _record_bounds(path)
    if case == "interior":
        _flip_byte(path, bounds[len(bounds) // 2] + 10)
    elif case == "length":
        _flip_byte(path, bounds[2] + 1)
    elif case == "torn_tail":
        with open(path, "r+b") as f:
            f.truncate(bounds[-1] + 5)
    elif case == "early":
        _flip_byte(path, bounds[1] + 10)


@pytest.mark.parametrize("case", ["interior", "length", "torn_tail",
                                  "early"])
def test_corruption_cases_match_reference(tmp_path, case):
    path = str(tmp_path / "cs.wal")
    _write_wal(WAL, path)
    if case == "early":
        w = WAL(path)                     # an in-progress height 4
        for i in range(3):
            w.save_message(bytes([4, i]) * 8)
        w.close()
    _corrupt(case, path)
    assert WAL.read_all(path) == JWAL.read_all(path)
    for h in range(1, 6):
        assert WAL.records_since_height(path, h) == \
            JWAL.records_since_height(path, h)
    if case == "early":
        recs = WAL.records_since_height(path, 4)
        assert len(recs) == 3 and all(k == REC_MESSAGE for k, _ in recs)
    assert WAL.fsck(path) == JWAL.fsck(path)


def test_fsck_repair_matches_reference(tmp_path):
    paths = {}
    for k, cls in WALS.items():
        paths[k] = str(tmp_path / f"{k}.wal")
        _write_wal(cls, paths[k])
        _flip_byte(paths[k], _record_bounds(paths[k])[3] + 10)
    reports = {k: cls.fsck(paths[k], repair=True) for k, cls in WALS.items()}
    assert reports["port"] == reports["jax"] and reports["port"]["repaired"]
    assert open(paths["port"], "rb").read() == \
        open(paths["jax"], "rb").read()
    assert WAL.fsck(paths["port"]) == JWAL.fsck(paths["jax"])


# -- nets that write WALs ------------------------------------------------

def _seeds():
    return [bytes([6, i + 1]) + bytes(30) for i in range(N_VALS)]


def _genesis() -> GenesisDoc:
    return GenesisDoc(chain_id=CHAIN, validators=[
        GenesisValidator(ref.pubkey_from_seed(s), 10) for s in _seeds()],
        genesis_time_ns=1_000_000_000)


def _node(pkg, seed, wal_path, plane):
    if pkg == "port":
        conns = ClientCreator("kvstore").new_app_conns()
        db = MemDB()
        return ConsensusState(
            fast_config().consensus, get_state(MemDB(), _genesis()),
            conns.consensus, BlockStore(db),
            Mempool(conns.mempool, plane=plane), plane,
            priv_validator=PrivValidator(PrivKey(seed)),
            wal_path=wal_path), db
    conns = JClientCreator("kvstore").new_app_conns()
    db = JMemDB()
    return JConsensusState(
        jfast_config().consensus, jget_state(JMemDB(), jax_genesis(
            _genesis())), conns.consensus, JBlockStore(db),
        JMempool(conns.mempool),
        priv_validator=JPrivValidator(JPrivKey(seed)),
        wal_path=wal_path), db


def _run_net(pkg, d) -> dict:
    """A 4-validator net of `pkg` with WALs, run until every store holds
    HEIGHT blocks, then stopped."""
    plane = BatchPlane(PythonBackend())
    nodes = [_node(pkg, s, os.path.join(d, f"{pkg}{i}.wal"), plane)
             for i, s in enumerate(_seeds())]
    mods = M if pkg == "port" else JM

    def make_cb(me):
        def cb(msg):
            for other, _ in nodes:
                if other is me:
                    continue
                if isinstance(msg, mods.VoteMessage):
                    other.add_vote(msg.vote, peer_id="net")
                elif isinstance(msg, mods.ProposalMessage):
                    other.set_proposal(msg.proposal, peer_id="net")
                elif isinstance(msg, mods.BlockPartMessage):
                    other.add_proposal_block_part(msg.height, msg.round,
                                                  msg.part, peer_id="net")
        return cb

    for cs, _ in nodes:
        cs.broadcast_cb = make_cb(cs)
    for cs, _ in nodes:
        cs.start()
    try:
        nodes[0][0].mempool.check_tx(b"wal=1")
        deadline = time.time() + 120
        while min(cs.block_store.height for cs, _ in nodes) < HEIGHT:
            assert time.time() < deadline, \
                [cs.block_store.height for cs, _ in nodes]
            time.sleep(0.01)
    finally:
        for cs, _ in nodes:
            cs.stop()
        plane.stop()
    cs0, db0 = nodes[0]
    return {"wal": os.path.join(d, f"{pkg}0.wal"), "cs": cs0,
            "rows": sorted(db0.iterate_prefix(b"")),
            "height": cs0.block_store.height,
            "app_hash": cs0.state.app_hash}


@pytest.fixture(scope="module")
def nets(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("nets"))
    jcb.set_backend("python")
    return {pkg: _run_net(pkg, d) for pkg in ("port", "jax")}


def _playback(pkg, wal_path, height):
    """`pkg`'s Playback over `wal_path` to `height`: (store rows, app hash,
    height reached)."""
    if pkg == "port":
        plane = BatchPlane(PythonBackend())
        try:
            pb = Playback(_genesis(), wal_path, plane,
                          cfg=fast_config().consensus)
            pb.run_until(height)
        finally:
            plane.stop()
    else:
        pb = JPlayback(jax_genesis(_genesis()), wal_path,
                       cfg=jfast_config().consensus)
        pb.run_until(height)
    return (sorted(pb.cs.block_store.db.iterate_prefix(b"")),
            pb.cs.state.app_hash, pb.cs.block_store.height)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_playback_replays_the_other_packages_wal(nets, writer):
    net = nets[writer]
    reader = "port" if writer == "jax" else "jax"
    rows, app_hash, height = _playback(reader, net["wal"], net["height"])
    assert height == net["height"] >= HEIGHT
    assert rows == net["rows"]
    assert app_hash == net["app_hash"]
    assert (rows, app_hash, height) == _playback(writer, net["wal"],
                                                 net["height"])


@pytest.mark.parametrize("case", ["interior", "length", "torn_tail"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_corrupted_wal_replays_the_same_on_both(nets, writer, case,
                                                tmp_path):
    path = str(tmp_path / "cs.wal")
    shutil.copy(nets[writer]["wal"], path)
    _corrupt(case, path)
    got = _playback("port", path, nets[writer]["height"])
    assert got == _playback("jax", path, nets[writer]["height"])


def _cut_before_end_height(src, dst, height):
    """Copy the WAL up to (not including) the #ENDHEIGHT `height` frame: a
    crash after the height's last input, before its block was saved."""
    data = open(src, "rb").read()
    for pos in _record_bounds(src):
        ln = struct.unpack_from(">I", data, pos)[0]
        body = data[pos + 8:pos + 8 + ln]
        if body[0] == REC_ENDHEIGHT and \
                struct.unpack(">Q", body[1:])[0] == height:
            with open(dst, "wb") as f:
                f.write(data[:pos])
            return
    raise AssertionError(f"no #ENDHEIGHT {height}")


def _restart(pkg, net, wal_path):
    """`pkg`'s ConsensusState restarted at height RESTART_AT - 1 (state and
    store rebuilt from the writer's blocks and seen commits) on
    `wal_path`, after its catchup replay: (store rows, app hash, round
    state dump without the wall-clock start)."""
    writer_cs = net["cs"]
    h0 = RESTART_AT - 1
    enc = [(writer_cs.block_store.load_block(h).encode(),
            writer_cs.block_store.load_seen_commit(h).encode())
           for h in range(1, h0 + 1)]
    if pkg == "port":
        plane = BatchPlane(PythonBackend())
        conns = ClientCreator("kvstore").new_app_conns()
        st = get_state(MemDB(), _genesis())
        db = MemDB()
        store = BlockStore(db)
        for b, sc in enc:
            block = Block.decode_bytes(b)
            ps = block.make_part_set()
            store.save_block(block, ps, Commit.decode(Reader(sc)))
            execution.apply_block(st, conns.consensus, block, ps.header,
                                  execution.MockMempool())
        cs = ConsensusState(fast_config().consensus, st, conns.consensus,
                            store, Mempool(conns.mempool, plane=plane),
                            plane, wal_path=wal_path)
        cs._ticker = MockTicker(cs._on_timeout_fire)
    else:
        plane = None
        conns = JClientCreator("kvstore").new_app_conns()
        st = jget_state(JMemDB(), jax_genesis(_genesis()))
        db = JMemDB()
        store = JBlockStore(db)
        for b, sc in enc:
            block = JBlock.decode_bytes(b)
            ps = block.make_part_set()
            store.save_block(block, ps, JCommit.decode(JReader(sc)))
            jexec.apply_block(st, None, conns.consensus, block, ps.header,
                              jexec.MockMempool())
        cs = JConsensusState(jfast_config().consensus, st, conns.consensus,
                             store, JMempool(conns.mempool),
                             wal_path=wal_path)
        cs._ticker = JMockTicker(cs._on_timeout_fire)
    try:
        cs._catchup_replay()
        dump = cs.get_round_state_dump()
    finally:
        cs.wal.close()
        if plane is not None:
            plane.stop()
    dump.pop("start_time")
    return (sorted(db.iterate_prefix(b"")), cs.state.app_hash,
            cs.block_store.height, dump)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_restarted_state_replays_the_other_packages_wal(nets, writer,
                                                        tmp_path):
    """A crash after height RESTART_AT's last input, before its block was
    saved: the restarted state replays the height from the WAL, saves
    the block and seen commit the writer saved and reaches its app
    hash, on either package."""
    net = nets[writer]
    reader = "port" if writer == "jax" else "jax"
    path = str(tmp_path / "cut.wal")
    _cut_before_end_height(net["wal"], path, RESTART_AT)
    rows, app_hash, height, dump = _restart(reader, net, path)
    assert height == RESTART_AT
    assert rows == _rows_to(net["rows"], RESTART_AT)
    next_block = net["cs"].block_store.load_block(RESTART_AT + 1)
    assert app_hash == next_block.header.app_hash
    path2 = str(tmp_path / "cut2.wal")
    _cut_before_end_height(net["wal"], path2, RESTART_AT)
    assert (rows, app_hash, height, dump) == _restart(writer, net, path2)


def _rows_to(rows, height):
    """A store's rows as they stood when it held `height` blocks."""
    out = []
    for k, v in rows:
        if k == b"blockStore:height":
            out.append((k, height.to_bytes(8, "big")))
            continue
        h = int(k.split(b":")[1])
        if h <= height:
            out.append((k, v))
    return sorted(out)


def test_seen_commit_plane_fault_raises_out_of_the_constructor(nets):
    """A restart whose seen-commit verify fails on the plane: the
    `PlaneFault` raises out of `ConsensusState`, no last commit is kept
    on the scalar path in its place."""
    from tendermint_tpu_torch.consensus.state import PlaneFault

    class Broken(PythonBackend):
        def verify_grouped(self, *a):
            raise RuntimeError("K1 launch failed")

    writer_cs = nets["port"]["cs"]
    plane = BatchPlane(Broken())
    conns = ClientCreator("kvstore").new_app_conns()
    st = get_state(MemDB(), _genesis())
    store = BlockStore(MemDB())
    block = Block.decode_bytes(writer_cs.block_store.load_block(1).encode())
    ps = block.make_part_set()
    store.save_block(block, ps, Commit.decode(Reader(
        writer_cs.block_store.load_seen_commit(1).encode())))
    execution.apply_block(st, conns.consensus, block, ps.header,
                          execution.MockMempool())
    try:
        with pytest.raises(PlaneFault, match="K1 launch failed"):
            ConsensusState(fast_config().consensus, st, conns.consensus,
                           store, Mempool(conns.mempool, plane=plane), plane)
    finally:
        plane.stop()
