"""The port's consensus timeline plane held against the JAX package's
(`tendermint_tpu/telemetry/`) with zero tolerance: the same lifecycle
dumps, made from a numpy seed (skewed clocks, garbage records, truncated
and missing nodes), give the same `merge_dumps`, `build_timeline`,
`consensus_doctor`, rendered report, `to_chrome_trace` and
`records_from_spans`, and feed the same metrics.  A 4-validator port net
over its reactors on `CudaBackend(device="cpu")` stamps its envelopes and
emits lifecycle records that the JAX `normalize_record` accepts
unchanged, each height's four stages summing to its wall.  And the port's
rule for a failing `commit_cb`: the state keeps it as its fault and
`stop()` raises it, where the JAX state logs it and goes on."""

import time

import numpy as np
import pytest

from tendermint_tpu import telemetry as jtelemetry
from tendermint_tpu.config import test_config as jfast_config
from tendermint_tpu.consensus.state import ConsensusState as JConsensusState
from tendermint_tpu.crypto import backend as jcb
from tendermint_tpu.blockchain.store import BlockStore as JBlockStore
from tendermint_tpu.mempool.mempool import Mempool as JMempool
from tendermint_tpu.proxy import ClientCreator as JClientCreator
from tendermint_tpu.state.state import get_state as jget_state
from tendermint_tpu.telemetry import collector as jcollector
from tendermint_tpu.types import PrivKey as JPrivKey
from tendermint_tpu.types.priv_validator import PrivValidator as JPrivValidator
from tendermint_tpu.utils import attribution as jattribution
from tendermint_tpu.utils import metrics as jmetrics
from tendermint_tpu.utils.db import MemDB as JMemDB
from tendermint_tpu_torch import telemetry
from tendermint_tpu_torch.batchplane import BatchPlane
from tendermint_tpu_torch.blockchain.store import BlockStore
from tendermint_tpu_torch.config import test_config as fast_config
from tendermint_tpu_torch.consensus import messages as M
from tendermint_tpu_torch.consensus.reactor import ConsensusReactor
from tendermint_tpu_torch.consensus.state import (CommitHookFault,
                                                  ConsensusState)
from tendermint_tpu_torch.crypto.backend import CudaBackend, PythonBackend
from tendermint_tpu_torch.mempool.mempool import Mempool
from tendermint_tpu_torch.proxy import ClientCreator
from tendermint_tpu_torch.scenarios import fixtures
from tendermint_tpu_torch.state.state import get_state
from tendermint_tpu_torch.telemetry import collector
from tendermint_tpu_torch.utils import attribution, metrics, tracing
from tendermint_tpu_torch.utils.db import MemDB

from torch_chains import jax_genesis, share_cores

SEEDS = (0, 1, 2, 3, 4, 5, 6)
CUTS = ("t_start", "t_proposal", "t_prevote", "t_precommit", "t_commit")
CHAIN = "timeline-chain"


def _dumps(seed: int) -> list:
    """Per-node dumps as `debug_timeline` answers them, on skewed clocks,
    with garbage and truncated parts."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(int(rng.integers(1, 6))):
        skew = float(rng.normal(0.0, 0.05))
        recs = []
        t = 1_700_000_000.0 + skew
        for h in range(1, int(rng.integers(2, 14))):
            cuts = np.cumsum(rng.exponential(0.05, 5)) + t
            if rng.random() < 0.1:
                cuts = cuts[::-1]                # non-monotone marks
            rec = dict(zip(CUTS, map(float, cuts)))
            rec.update(node=f"n{i}", height=h,
                       round=int(rng.integers(0, 3)),
                       proposer=bytes(rng.integers(0, 256, 20,
                                                   dtype=np.uint8)).hex(),
                       verify_wait_s=float(rng.random() * 0.01))
            r = rng.random()
            if r < 0.05:
                del rec["t_prevote"]
            elif r < 0.08:
                rec["height"] = 0
            elif r < 0.1:
                rec = "garbage"
            elif r < 0.12:
                rec["node"] = ""
            recs.append(rec)
            t = float(cuts.max()) + 0.01
        dump = {"node": f"n{i}", "wall_now": 1_700_000_010.0 + skew,
                "records": recs}
        r = rng.random()
        if r < 0.1:
            dump["records"] = None
        elif r < 0.15:
            del dump["wall_now"]
        elif r < 0.2:
            dump["records"] = ["x", 3]
        out.append(dump)
    if rng.random() < 0.3:
        out.append("not a dict")
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_timeline_matches_jax_on_the_same_dumps(seed):
    dumps = _dumps(seed)
    ref = None if seed % 2 else 1_700_000_010.0
    merged = telemetry.merge_dumps(dumps, ref_wall=ref)
    assert merged == jtelemetry.merge_dumps(dumps, ref_wall=ref)
    gossip = ({"count": 12, "p99": 0.002, "worst_link": "n0->n1",
               "max_s": 0.004, "per_receiver_wait_s": 0.3}
              if seed % 3 == 0 else None)
    tl = telemetry.build_timeline(merged["records"], gossip=gossip)
    assert tl == jtelemetry.build_timeline(merged["records"], gossip=gossip)
    for rl in (1, 3, 10):
        rep = telemetry.consensus_doctor(tl, range_len=rl)
        assert rep == jtelemetry.consensus_doctor(tl, range_len=rl)
        assert telemetry.render_consensus_report(rep) == \
            jtelemetry.render_consensus_report(rep)
        assert rep["sums_to_wall"]
    doc = telemetry.to_chrome_trace(tl)
    assert doc == jtelemetry.to_chrome_trace(tl)
    spans = attribution.spans_from_chrome(doc)
    assert telemetry.records_from_spans(spans) == \
        jtelemetry.records_from_spans(jattribution.spans_from_chrome(doc))


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_feed_registry_matches_jax(seed, monkeypatch):
    tl = telemetry.build_timeline(
        telemetry.merge_dumps(_dumps(seed))["records"])
    reg, jreg = metrics.Registry(), jmetrics.Registry()
    monkeypatch.setattr(collector, "REGISTRY", reg)
    monkeypatch.setattr(jcollector, "REGISTRY", jreg)
    telemetry.feed_registry(tl)
    jtelemetry.feed_registry(tl)
    for k in ("consensus_stage_seconds", "timeline_node_height"):
        assert reg.snapshot()[k] == jreg.snapshot()[k]


@pytest.mark.parametrize("n", [0, 1, 2, 7, 100])
def test_percentile_and_stage_durations_match_jax(n):
    rng = np.random.default_rng(n)
    vals = [float(v) for v in rng.exponential(0.1, n)]
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        assert collector.percentile(vals, q) == \
            jcollector.percentile(vals, q)
    for rec in telemetry.merge_dumps(_dumps(n))["records"]:
        assert collector.stage_durations(rec) == \
            jcollector.stage_durations(rec)


def test_normalize_record_matches_jax_on_edge_records():
    base = dict(zip(CUTS, (1.0, 2.0, 1.5, 4.0, 3.0)), node="a", height=3)
    cases = [base, {**base, "height": "7"}, {**base, "round": "x"},
             {**base, "t_commit": 0.5}, {**base, "verify_wait_s": -1},
             {k: v for k, v in base.items() if k != "height"}, None, 5]
    for raw in cases:
        for off in (0.0, 0.25):
            assert telemetry.normalize_record(raw, off) == \
                jtelemetry.normalize_record(raw, off)


# -- the port's nets -----------------------------------------------------------

def _wait(cond, deadline_s: float = 60.0) -> bool:
    t0 = time.monotonic()
    while time.monotonic() - t0 < deadline_s:
        if cond():
            return True
        time.sleep(0.02)
    return cond()


def _wire(states: list) -> None:
    """Each state's broadcasts into every other state's feed methods,
    stamped with the sender's clock as the reactor stamps them."""
    def make_cb(me):
        others = [o for o in states if o is not me]

        def cb(msg):
            ts = tracing.now_epoch()
            for o in others:
                if isinstance(msg, M.VoteMessage):
                    o.add_vote(msg.vote, peer_id="net", sent_ts=ts)
                elif isinstance(msg, M.ProposalMessage):
                    o.set_proposal(msg.proposal, peer_id="net", sent_ts=ts)
                elif isinstance(msg, M.BlockPartMessage):
                    o.add_proposal_block_part(msg.height, msg.round,
                                              msg.part, peer_id="net",
                                              sent_ts=ts)
        return cb

    for cs in states:
        cs.broadcast_cb = make_cb(cs)


def test_four_validator_net_emits_records_jax_accepts():
    """Four port validators on one plane over the plain kernels: every
    committed height leaves a lifecycle record per node that the JAX
    `normalize_record` returns unchanged, the four stages sum to the
    height's wall exactly, the recorder's stage spans rebuild the same
    records, the collector's timeline equals the JAX one, and stamped
    deliveries feed the gossip lag."""
    old = share_cores()
    be = CudaBackend(device="cpu")
    privs, _ = fixtures.make_validators(4)
    gen = fixtures.make_genesis(CHAIN, privs)
    plane = BatchPlane(be)
    states = []
    for i, priv in enumerate(privs):
        conns = ClientCreator("kvstore").new_app_conns()
        states.append(ConsensusState(
            fast_config().consensus, get_state(MemDB(), gen),
            conns.consensus, BlockStore(MemDB()),
            Mempool(conns.mempool, plane=plane), plane,
            priv_validator=priv, node_id=f"node{i}"))
    _wire(states)
    lag0 = metrics.REGISTRY.gossip_fanout_seconds.count
    tracing.RECORDER.clear()
    faults = []
    try:
        for cs in states:
            cs.start()
        assert _wait(lambda: all(len(cs.lifecycle) >= 2 for cs in states)), \
            [len(cs.lifecycle) for cs in states]
    finally:
        for cs in states:
            try:
                cs.stop()
            except Exception as e:          # collected, then asserted
                faults.append(e)
        plane.stop()
        import torch
        torch.set_num_threads(old)
    assert not faults, faults
    assert metrics.REGISTRY.gossip_fanout_seconds.count > lag0
    records = [r for cs in states for r in cs.lifecycle]
    for rec in records:
        assert jtelemetry.normalize_record(rec) == rec
        assert telemetry.normalize_record(rec) == rec
        stages = jcollector.stage_durations(rec)
        assert sum(stages.values()) == pytest.approx(
            rec["t_commit"] - rec["t_start"], rel=1e-12, abs=1e-12)
    assert {r["node"] for r in records} == {f"node{i}" for i in range(4)}
    tl = telemetry.collect_mesh(states)
    assert tl == jtelemetry.build_timeline(
        [jtelemetry.normalize_record(r) for r in records])
    rebuilt = {(r["node"], r["height"]): r for r in
               telemetry.records_from_spans(tracing.RECORDER.snapshot())}
    for rec in records:
        got = rebuilt[(rec["node"], rec["height"])]
        for k in CUTS:
            assert got[k] == pytest.approx(rec[k], abs=1e-6)


def test_reactor_stamps_envelopes_with_its_clock_and_node_id():
    """The consensus reactor's envelope carries the send time on the
    recorder's clock and the state's node id, and the JAX codec reads
    the same stamp."""
    from tendermint_tpu.consensus import messages as JM
    cs, plane = _solo("port")
    try:
        rx = ConsensusReactor(cs)
        t0 = tracing.now_epoch()
        raw = rx._stamp(M.NewRoundStepMessage(height=3, round=0, step=1,
                                              seconds_since_start=0,
                                              last_commit_round=-1))
        t1 = tracing.now_epoch()
    finally:
        plane.stop()
    msg = M.decode_msg(raw)
    assert msg.origin == "solo" and t0 <= msg.sent_ts <= t1
    jmsg = JM.decode_msg(raw)
    assert (jmsg.origin, jmsg.sent_ts) == (msg.origin, msg.sent_ts)


def _solo(pkg: str):
    privs, _ = fixtures.make_validators(1)
    gen = fixtures.make_genesis(CHAIN, privs)
    if pkg == "port":
        plane = BatchPlane(PythonBackend())
        conns = ClientCreator("kvstore").new_app_conns()
        cs = ConsensusState(fast_config().consensus,
                            get_state(MemDB(), gen), conns.consensus,
                            BlockStore(MemDB()),
                            Mempool(conns.mempool, plane=plane), plane,
                            priv_validator=privs[0], node_id="solo")
        return cs, plane
    conns = JClientCreator("kvstore").new_app_conns()
    cs = JConsensusState(jfast_config().consensus,
                         jget_state(JMemDB(), jax_genesis(gen)),
                         conns.consensus, JBlockStore(JMemDB()),
                         JMempool(conns.mempool),
                         priv_validator=JPrivValidator(JPrivKey(
                             privs[0].priv_key.seed)), node_id="solo")
    return cs, None


def test_commit_cb_fault_is_raised_by_stop():
    """A `commit_cb` that raises ends the port's receive routine at the
    first commit; `stop()` raises it as a `CommitHookFault` (its cause the
    hook's error).  The JAX state logs it and goes on committing."""
    old = jcb._current
    jcb.set_backend("python")
    calls = []

    def hook(rec):
        calls.append(rec["height"])
        raise KeyError("telemetry sink gone")

    cs, plane = _solo("port")
    jcs, _ = _solo("jax")
    cs.commit_cb = jcs.commit_cb = hook
    try:
        cs.start()
        jcs.start()
        assert _wait(lambda: cs.fault is not None, 30)
        assert _wait(lambda: jcs.block_store.height >= 3, 30)
        time.sleep(0.2)
        assert cs.block_store.height == 1
        assert len(cs.lifecycle) == 1
        with pytest.raises(CommitHookFault) as e:
            cs.stop()
        assert isinstance(e.value.__cause__, KeyError)
        assert calls.count(1) == 2           # each package's first commit
    finally:
        jcs.stop()
        plane.stop()
        jcb._current = old
