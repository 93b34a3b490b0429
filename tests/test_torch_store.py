"""The port's block store, SQLite store and startup handshake held
against the JAX package's on the same chains: the stored rows byte for
byte (on `MemDB` and on `SQLiteDB`), every load, prune and bootstrap,
and each branch of the handshake's decision table in the cases of
`tests/test_replay.py`, with the same heights, app hashes and replayed
block counts."""

import dataclasses

import pytest

from tendermint_tpu.blockchain.store import BlockStore as JBlockStore
from tendermint_tpu.consensus.replay import Handshaker as JHandshaker
from tendermint_tpu.crypto import backend as jcb
from tendermint_tpu.proxy import ClientCreator as JClientCreator
from tendermint_tpu.state import execution as jexec
from tendermint_tpu.state.state import get_state as jget_state
from tendermint_tpu.utils.db import MemDB as JMemDB, SQLiteDB as JSQLiteDB
from tendermint_tpu_torch.abci.types import ResponseInfo
from tendermint_tpu_torch.blockchain import replay as rp
from tendermint_tpu_torch.blockchain.store import BlockStore
from tendermint_tpu_torch.consensus.replay import Handshaker
from tendermint_tpu_torch.crypto.backend import PythonBackend
from tendermint_tpu_torch.proxy import ClientCreator
from tendermint_tpu_torch.state import execution
from tendermint_tpu_torch.state.state import get_state
from tendermint_tpu_torch.types import GenesisDoc
from tendermint_tpu_torch.utils.db import MemDB, SQLiteDB

from chainutil import (build_chain, kvstore_app_hashes, make_genesis,
                       make_validators)
from torch_chains import (GoldenSigner, jax_block, jax_commit, jax_vals,
                          port_chain)

N_VALS, N_BLOCKS = 4, 5
PAYLOAD = 70_000                    # two parts per block: 64 KB + a tail


@pytest.fixture(autouse=True)
def _jax_python_backend():
    old = jcb._current
    jcb.set_backend("python")
    yield
    jcb._current = old


@pytest.fixture(scope="module")
def chain():
    return rp.build_chain(N_VALS, N_BLOCKS, GoldenSigner(), payload=PAYLOAD)


def _dbs(kind, tmp_path):
    if kind == "memdb":
        return MemDB(), JMemDB()
    return (SQLiteDB(str(tmp_path / "port.db")),
            JSQLiteDB(str(tmp_path / "jax.db")))


def _rows(db) -> list:
    return [(bytes(k), bytes(v)) for k, v in db.iterate_prefix(b"")]


def _fill(chain, db, jdb):
    """Save every block into both stores; the port's seen commits go in
    array form for the first heights and object form after."""
    vals = chain.genesis.validator_set()
    jvals = jax_vals(vals)
    bs, jbs = BlockStore(db), JBlockStore(jdb)
    for i, (b, cc) in enumerate(zip(chain.blocks, chain.commits)):
        seen = cc if i < 3 else cc.to_commit(vals)
        bs.save_block(b, b.make_part_set(), seen, validators=vals)
        jb = jax_block(b)
        jbs.save_block(jb, jb.make_part_set(),
                       jax_commit(cc).to_commit(jvals))
    return bs, jbs


@pytest.mark.parametrize("kind", ["memdb", "sqlite"])
def test_store_bytes_and_loads_match_reference(chain, kind, tmp_path):
    db, jdb = _dbs(kind, tmp_path)
    bs, jbs = _fill(chain, db, jdb)
    assert _rows(db) == _rows(jdb)
    assert (bs.height, bs.base) == (jbs.height, jbs.base) == (N_BLOCKS, 1)
    vals = chain.genesis.validator_set()
    for h in range(1, N_BLOCKS + 1):
        b = bs.load_block(h)
        assert b.encode() == jbs.load_block(h).encode() \
            == chain.blocks[h - 1].encode()
        meta = bs.load_block_meta(h)
        assert meta.encode() == jbs.load_block_meta(h).encode()
        assert meta.block_id.key() == chain.commits[h - 1].block_id.key()
        assert meta.block_id.parts.total == 2
        for i in range(meta.block_id.parts.total):
            assert bs.load_part(h, i).encode() == \
                jbs.load_part(h, i).encode()
        seen = bs.load_seen_commit(h)
        assert seen.encode() == jbs.load_seen_commit(h).encode() \
            == chain.commits[h - 1].to_commit(vals).encode()
        got, want = bs.load_block_commit(h), jbs.load_block_commit(h)
        assert (got is None) == (want is None) == (h == N_BLOCKS)
        if got is not None:
            assert got.encode() == want.encode()
    assert bs.load_block(N_BLOCKS + 1) is None is jbs.load_block(N_BLOCKS + 1)
    with pytest.raises(ValueError, match="expected 6"):
        bs.save_block(chain.blocks[0], chain.blocks[0].make_part_set(),
                      chain.commits[0], validators=vals)

    assert bs.prune(3) == jbs.prune(3) == 2
    assert _rows(db) == _rows(jdb)
    assert bs.base == jbs.base == 3
    assert bs.load_block(2) is None and bs.load_block(3) is not None
    assert bs.prune(2) == jbs.prune(2) == 0
    with pytest.raises(ValueError, match="cannot retain"):
        bs.prune(N_BLOCKS + 2)
    if kind == "sqlite":                # survives a reopen
        again = BlockStore(SQLiteDB(str(tmp_path / "port.db")))
        assert (again.height, again.base) == (N_BLOCKS, 3)
        assert again.load_block(4).encode() == chain.blocks[3].encode()


@pytest.mark.parametrize("kind", ["memdb", "sqlite"])
def test_store_bootstrap_matches_reference(chain, kind, tmp_path):
    db, jdb = _dbs(kind, tmp_path)
    bs, jbs = BlockStore(db), JBlockStore(jdb)
    bs.bootstrap(7)
    jbs.bootstrap(7)
    assert _rows(db) == _rows(jdb)
    assert (bs.height, bs.base) == (jbs.height, jbs.base) == (7, 8)
    assert bs.load_block(7) is None
    with pytest.raises(ValueError, match="non-empty"):
        bs.bootstrap(9)


def test_compact_commit_encodes_as_its_object_form(chain):
    vals = chain.genesis.validator_set()
    cc = chain.commits[2]
    present = cc.present.copy()
    present[[0, 2]] = False
    sparse = type(cc)(block_id=cc.block_id, height_=cc.height_,
                      round_=cc.round_, sigs=cc.sigs, present=present)
    for c in (cc, sparse):
        want = c.to_commit(vals).encode()
        assert c.encode_commit(vals) == want
        assert jax_commit(c).to_commit(jax_vals(vals)).encode() == want


def test_sqlite_db_matches_reference(tmp_path):
    db, jdb = SQLiteDB(str(tmp_path / "a.db")), JSQLiteDB(
        str(tmp_path / "b.db"))
    ops = [("set", b"k1", b"v1"), ("set", b"k\xff\xff", b"v2"),
           ("batch", [(b"k2", b"x"), (b"j", b"y")]), ("del", b"k1"),
           ("set", b"\xff", b"z")]
    for op in ops:
        for d in (db, jdb):
            if op[0] == "set":
                d.set(op[1], op[2])
            elif op[0] == "batch":
                d.set_batch(op[1])
            else:
                d.delete(op[1])
    for prefix in (b"", b"k", b"k\xff", b"\xff", b"q"):
        assert db.iterate_prefix(prefix) == jdb.iterate_prefix(prefix)
    assert db.get(b"k1") is None and db.get(b"j") == b"y"
    db.close()
    assert SQLiteDB(str(tmp_path / "a.db")).get(b"k2") == b"x"


# -- the handshake ------------------------------------------------------------

CHAIN = "replay-chain"
HS_BLOCKS = 4


class _Jax:
    """The JAX package's side of a handshake scenario."""
    BlockStore, Handshaker = JBlockStore, JHandshaker
    ClientCreator, MemDB = JClientCreator, JMemDB

    @staticmethod
    def state(gen):
        return jget_state(JMemDB(), gen)

    @staticmethod
    def apply(st, conns, block, ps):
        jexec.apply_block(st, None, conns.consensus, block, ps.header,
                          jexec.MockMempool())

    @staticmethod
    def exec_on_app(conns, block):
        return jexec.exec_block_on_app(conns.consensus, block, None)

    exec_commit = staticmethod(jexec.exec_commit_block)

    @staticmethod
    def handshaker(st, bs):
        return JHandshaker(st, bs)


class _Port:
    """The port's side: LastCommits verified by the golden backend, as
    the JAX handshake verifies them on its python backend."""
    BlockStore, Handshaker = BlockStore, Handshaker
    ClientCreator, MemDB = ClientCreator, MemDB

    @staticmethod
    def state(gen):
        return get_state(MemDB(), GenesisDoc.from_json(gen.to_json()))

    @staticmethod
    def apply(st, conns, block, ps):
        execution.apply_block(st, conns.consensus, block, ps.header,
                              execution.MockMempool(), PythonBackend())

    @staticmethod
    def exec_on_app(conns, block):
        return execution.exec_block_on_app(conns.consensus, block)

    exec_commit = staticmethod(execution.exec_commit_block)

    @staticmethod
    def handshaker(st, bs):
        return Handshaker(st, bs, PythonBackend())


@pytest.fixture(scope="module")
def hs_chains():
    """(genesis, {kv: chain}) built once by the JAX fixtures, with the
    port's copy of each chain."""
    gen = make_genesis(CHAIN, make_validators(4)[0])
    chains = {}
    for kv in (True, False):
        privs, vs = make_validators(4)      # fresh signers: no HRS regress
        hashes = kvstore_app_hashes(HS_BLOCKS) if kv else None
        jchain = build_chain(privs, vs, CHAIN, HS_BLOCKS, app_hashes=hashes)
        chains[kv] = {_Jax: jchain, _Port: port_chain(jchain)}
    return gen, chains


def _outcome(st, conns, h, out) -> tuple:
    info = conns.query.info()
    return (out, h.n_blocks, st.last_block_height, st.app_hash,
            info.last_block_height, info.last_block_app_hash)


def _hs_fresh(S, gen, chains):
    st, conns = S.state(gen), S.ClientCreator("kvstore").new_app_conns()
    h = S.handshaker(st, S.BlockStore(S.MemDB()))
    return _outcome(st, conns, h, h.handshake(conns))


def _hs_app_behind(S, gen, chains):
    """store == state, a fresh app at 0: replay every block into it."""
    st, conns = S.state(gen), S.ClientCreator("nilapp").new_app_conns()
    bs = S.BlockStore(S.MemDB())
    for block, ps, seen in chains[False][S]:
        bs.save_block(block, ps, seen)
        S.apply(st, conns, block, ps)
    fresh = S.ClientCreator("nilapp").new_app_conns()
    h = S.handshaker(st, bs)
    return _outcome(st, fresh, h, h.handshake(fresh))


def _hs_app_partly_behind(S, gen, chains):
    """store == state, app at 2: replay blocks 3 and 4 only."""
    st, conns = S.state(gen), S.ClientCreator("kvstore").new_app_conns()
    bs = S.BlockStore(S.MemDB())
    chain = chains[True][S]
    for block, ps, seen in chain:
        bs.save_block(block, ps, seen)
        S.apply(st, conns, block, ps)
    fresh = S.ClientCreator("kvstore").new_app_conns()
    for block, _, _ in chain[:2]:
        S.exec_commit(fresh.consensus, block)
    h = S.handshaker(st, bs)
    return _outcome(st, fresh, h, h.handshake(fresh))


def _hs_store_ahead(S, gen, chains):
    """store == state + 1, app == state: ApplyBlock on the real app."""
    st, conns = S.state(gen), S.ClientCreator("kvstore").new_app_conns()
    bs = S.BlockStore(S.MemDB())
    (b1, ps1, seen1), (b2, ps2, seen2) = chains[True][S][:2]
    bs.save_block(b1, ps1, seen1)
    S.apply(st, conns, b1, ps1)
    bs.save_block(b2, ps2, seen2)
    h = S.handshaker(st, bs)
    return _outcome(st, conns, h, h.handshake(conns))


def _hs_store_ahead_app_committed(S, gen, chains):
    """store == state + 1, app == store: the saved ABCIResponses bring
    the state up through the mock app."""
    st, conns = S.state(gen), S.ClientCreator("kvstore").new_app_conns()
    bs = S.BlockStore(S.MemDB())
    (b1, ps1, seen1), (b2, ps2, seen2) = chains[True][S][:2]
    bs.save_block(b1, ps1, seen1)
    S.apply(st, conns, b1, ps1)
    bs.save_block(b2, ps2, seen2)
    st.save_abci_responses(S.exec_on_app(conns, b2))
    conns.consensus.commit()
    h = S.handshaker(st, bs)
    return _outcome(st, conns, h, h.handshake(conns))


@pytest.mark.parametrize("case", [_hs_fresh, _hs_app_behind,
                                  _hs_app_partly_behind, _hs_store_ahead,
                                  _hs_store_ahead_app_committed],
                         ids=lambda f: f.__name__[4:])
def test_handshake_matches_reference(hs_chains, case):
    gen, chains = hs_chains
    got, want = case(_Port, gen, chains), case(_Jax, gen, chains)
    assert got == want
    assert got[1] == {"fresh": 0, "app_behind": HS_BLOCKS,
                      "app_partly_behind": 2, "store_ahead": 1,
                      "store_ahead_app_committed": 1}[case.__name__[4:]]


def test_handshake_unrecoverable_heights(hs_chains):
    gen, chains = hs_chains

    class LyingApp:
        def info(self):
            return ResponseInfo(last_block_height=99)

    class Conns:
        query = LyingApp()
        consensus = None

    st, conns = _Port.state(gen), ClientCreator("kvstore").new_app_conns()
    bs = BlockStore(MemDB())
    for block, ps, seen in chains[True][_Port][:2]:
        bs.save_block(block, ps, seen)
        _Port.apply(st, conns, block, ps)
    with pytest.raises(RuntimeError, match="unrecoverable"):
        Handshaker(st, bs).handshake(Conns())


def test_handshake_checks_the_stored_last_commit(hs_chains):
    """A stored block whose LastCommit carries a forged signature (and a
    header whose last-commit hash matches it) fails the handshake's
    ApplyBlock with the same error as the JAX one."""
    gen, chains = hs_chains
    results = []
    for S in (_Port, _Jax):
        st, conns = S.state(gen), S.ClientCreator("kvstore").new_app_conns()
        bs = S.BlockStore(S.MemDB())
        (b1, ps1, seen1), (b2, _, seen2) = chains[True][S][:2]
        bs.save_block(b1, ps1, seen1)
        S.apply(st, conns, b1, ps1)
        v = b2.last_commit.precommits[1]
        forged = v.signature[:5] + bytes([v.signature[5] ^ 0x10]) \
            + v.signature[6:]
        votes = list(b2.last_commit.precommits)
        votes[1] = dataclasses.replace(v, signature=forged)
        h = b2.header
        bad = type(b2).make(
            chain_id=h.chain_id, height=h.height, time_ns=h.time_ns,
            txs=b2.txs, last_commit=type(b2.last_commit)(
                block_id=b2.last_commit.block_id, precommits=votes),
            last_block_id=h.last_block_id, validators_hash=h.validators_hash,
            app_hash=h.app_hash)
        bs.save_block(bad, bad.make_part_set(), seen2)
        with pytest.raises(ValueError) as e:
            S.handshaker(st, bs).handshake(conns)
        results.append((type(e.value).__name__, str(e.value),
                        st.last_block_height))
    assert results[0] == results[1]
    assert results[0] == ("CommitSignatureError",
                          "invalid commit signature at height 1 (lane 1)", 1)
