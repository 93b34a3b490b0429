"""The reference agrees with the program where both are right, and a run
comes out not correct when the timed path is broken underneath it."""

import numpy as np
import pytest

from conftest import TINY, ref_signer, tiny_run
from bftbench import harness
from bftbench.reference import chain as ref
from bftbench.reference import ed25519

BENCH = harness.Bench()
SYNC, RELAY = "fastsync.v100.load1k", "light.v100.c8"


def sync_chain(seed=11):
    c = BENCH.cell(SYNC, TINY[SYNC])
    return BENCH.module("traffic", "chain").generate(
        seed, c.mix, c.config, "cpu", ref_signer)


def test_the_reference_chain_is_the_programs():
    from tendermint_tpu_torch.abci.apps.kvstore import KVStoreApp
    from tendermint_tpu_torch.types import Block, PartSet, canonical
    from tendermint_tpu_torch.types.keys import PubKey
    from tendermint_tpu_torch.types.validator import Validator, ValidatorSet
    t = sync_chain()
    vs = ValidatorSet([Validator(PubKey(p), t.power) for p in t.pubs])
    assert [v.pub_key.bytes_ for v in vs.validators] == t.pubs
    app = KVStoreApp()
    addresses = [v.address for v in vs.validators]
    for h, w in enumerate(t.wire, 1):
        b = Block.decode_bytes(w)
        b.validate_basic()          # the last commit's hash among the rest
        assert b.header.validators_hash == vs.hash()
        assert b.hash() == t.block_hash[h - 1]
        assert w.endswith(b.last_commit.encode())
        if h > 1:       # the predecessor's commit, every precommit signed
            votes = b.last_commit.precommits
            assert [v.validator_address for v in votes] == addresses
            assert [v.signature for v in votes] == [
                t.sigs[h - 2, i].tobytes() for i in range(len(votes))]
            assert b.last_commit.block_id.key() == (
                t.block_hash[h - 2], *t.parts[h - 2])
            assert {v.height for v in votes} == {h - 1}
        ps = PartSet.from_data(w).header
        assert (ps.total, ps.hash) == t.parts[h - 1]
        assert b.header.app_hash == t.app_hash[h - 1]
        for tx in b.txs:
            app.deliver_tx(tx)
        assert app.commit().data == t.app_hash[h]
    bh = np.frombuffer(b"".join(t.block_hash), np.uint8).reshape(-1, 32)
    ph = np.frombuffer(b"".join(p[1] for p in t.parts),
                       np.uint8).reshape(-1, 32)
    n = len(t.wire)
    want = canonical.batch_sign_bytes(
        t.chain_id, np.full(n, canonical.TYPE_PRECOMMIT), np.arange(1, n + 1),
        np.zeros(n, np.int64), bh, ph, np.array([p[0] for p in t.parts]))
    got = ref.sign_bytes(t.chain_id, np.arange(1, n + 1), bh, ph,
                         [p[0] for p in t.parts])
    assert np.array_equal(got, want)


def test_multi_part_blocks_root_as_the_programs():
    from tendermint_tpu_torch.types import PartSet
    data = bytes(range(256)) * 1000            # 4 parts, the last short
    ps = PartSet.from_data(data).header
    assert ref.part_set_header(data) == (ps.total, ps.hash)


def test_the_reference_ed25519_is_rfc8032():
    from tendermint_tpu_torch.crypto import pure_ed25519
    for i in range(3):
        seed, msg = bytes([i + 1]) * 32, bytes([i]) * (50 + i)
        assert ed25519.pubkey(seed) == pure_ed25519.pubkey_from_seed(seed)
        sig = ed25519.sign(seed, msg)
        assert sig == pure_ed25519.sign(seed, msg)
        assert ed25519.verify(ed25519.pubkey(seed), msg, sig)
        bad = bytes([sig[0] ^ 1]) + sig[1:]
        assert not ed25519.verify(ed25519.pubkey(seed), msg, bad)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", [SYNC, RELAY])
def test_sound_runs_are_correct(cell, trace):
    out = tiny_run(cell, trace=trace)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert out["attempted"] > 0 and out["failed"] == 0
    w = BENCH.data("workloads", cell)
    want = w["per_layer"] if trace else w["end_to_end"]
    assert set(out["metrics"]) <= set(want)
    if not trace:
        assert set(out["metrics"]) == set(want)
        assert all(m["value"] > 0 for m in out["metrics"].values())


class Broken:
    """The program's golden backend with its verdicts broken: `fault` maps
    each call's mask (bool[n]) to what the broken path returns."""

    def __init__(self, fault):
        from tendermint_tpu_torch.crypto.backend import PythonBackend
        self._be = PythonBackend()
        self._fault = fault

    def __getattr__(self, name):
        return getattr(self._be, name)

    def verify_grouped_templated(self, *args):
        return self._fault(self._be.verify_grouped_templated(*args).copy())

    def verify_grouped_templated_async(self, *args, **kw):
        ok = self._be.verify_grouped_templated_async(*args, **kw)()
        out = self._fault(ok.copy())
        return lambda: out


def accept_all(ok):          # the control: no signature is checked
    ok[:] = True
    return ok


def first_half_left_out(ok):  # the first half of each call's lanes unchecked
    ok[:len(ok) // 2] = True
    return ok


def half_left_out(ok):       # the second half of each call's lanes unchecked
    ok[len(ok) // 2:] = True
    return ok


def lane_flipped(ok):        # an answer altered where it is produced
    ok[len(ok) // 3] = not ok[len(ok) // 3]
    return ok


@pytest.mark.parametrize("fault", [accept_all, first_half_left_out,
                                   half_left_out, lane_flipped])
@pytest.mark.parametrize("cell", [SYNC, RELAY])
def test_a_broken_verify_is_caught(cell, fault):
    out = tiny_run(cell, backend=lambda: Broken(fault))
    assert out["correct"] is False
    assert out["checks"]["verdicts"]["value"] > 0


def test_a_state_left_unchanged_is_caught(monkeypatch):
    from tendermint_tpu_torch.abci.apps.kvstore import KVStoreApp
    from tendermint_tpu_torch.abci.types import OK, Result
    monkeypatch.setattr(KVStoreApp, "deliver_tx",
                        lambda self, tx: Result(OK))
    out = tiny_run(SYNC)
    assert out["correct"] is False
    assert out["checks"]["app_state"]["value"] > 0


def test_a_block_left_out_of_the_store_is_caught(monkeypatch):
    from tendermint_tpu_torch.blockchain.store import BlockStore
    save = BlockStore.save_block

    def skip_odd(self, block, *a, **kw):
        if block.height % 2 == 0:
            save(self, block, *a, **kw)
        else:       # the height advances, the block is not kept
            self._height = block.height
    monkeypatch.setattr(BlockStore, "save_block", skip_odd)
    out = tiny_run(SYNC, seconds=1.5)
    assert out["correct"] is False
    assert out["checks"]["store"]["value"] > 0
