"""The port's p2p stack held against the JAX package's, byte for byte:
X25519 (RFC 7748's vector and seeded scalars), the key schedule, the
secret connection's frames under fixed keys (each package opens the
other's), `NodeInfo` JSON, `NetAddress`, the MConnection packets of
chunked messages (each package reassembles the other's), the reconnect
backoff for a seeded RNG and the flow-rate meter under a patched clock.
Then a port switch and a JAX switch over an in-memory pair: the secret
handshake and messages on every channel, both ways.  Also the port's own
rule: a device or plane error out of a reactor's `receive` is this
node's fault, kept on the connection and the switch and raised by
`stop()`, with the peer neither dropped nor blamed, while any other error
there drops the peer, as in the JAX package.  Every wait has its own
deadline; no speed is asserted."""

import random
import struct
import threading
import time

import pytest

from tendermint_tpu.p2p import connection as jconn
from tendermint_tpu.p2p import secret as jsecret
from tendermint_tpu.p2p import switch as jswitch
from tendermint_tpu.p2p.peer import Reactor as JReactor
from tendermint_tpu.p2p.types import (ChannelDescriptor as JChannelDescriptor,
                                      NetAddress as JNetAddress,
                                      NodeInfo as JNodeInfo)
from tendermint_tpu.utils import flowrate as jflowrate
from tendermint_tpu_torch.config import P2PConfig, test_config as fast_config
from tendermint_tpu_torch.p2p import (ChannelDescriptor, MConnection,
                                      NetAddress, NodeInfo, Reactor,
                                      SwitchError, connect_switches,
                                      make_connected_switches, make_switch,
                                      mem_pair)
from tendermint_tpu_torch.p2p import connection as conn
from tendermint_tpu_torch.p2p import secret
from tendermint_tpu_torch.p2p import switch as switch_mod
from tendermint_tpu_torch.p2p.switch import Switch
from tendermint_tpu_torch.types import PrivKey
from tendermint_tpu_torch.utils import flowrate

CHAIN = "p2p-chain"
# every channel the node's reactors claim: consensus state, data, vote,
# vote-set bits, mempool, blockchain
CHANNELS = (0x20, 0x21, 0x22, 0x23, 0x30, 0x40)
DEADLINE_S = 20.0


def _wait(cond, deadline_s: float = DEADLINE_S) -> bool:
    end = time.monotonic() + deadline_s
    while not cond():
        if time.monotonic() > end:
            return False
        time.sleep(0.01)
    return True


# -- X25519, key schedule, frames ---------------------------------------------

def test_x25519_rfc7748_vector():
    k = bytes.fromhex("a546e36bf0527c9d3b16154b82465edd"
                      "62144c0ac1fc5a18506a2244ba449ac4")
    u = bytes.fromhex("e6db6867583030db3594c1a424b15f7c"
                      "726624ec26b3353b10a903a6d0ab1c4c")
    want = bytes.fromhex("c3da55379de9c6908e94ea4df28d084f"
                         "32eccf03491c71f754b4075577a28552")
    assert secret.x25519(k, u) == want == jsecret.x25519(k, u)


@pytest.mark.parametrize("seed", range(4))
def test_x25519_seeded_scalars(seed):
    rng = random.Random(seed)
    a, b = rng.randbytes(32), rng.randbytes(32)
    pa = secret.x25519(a, secret._BASEPOINT)
    pb = secret.x25519(b, secret._BASEPOINT)
    assert pa == jsecret.x25519(a, jsecret._BASEPOINT)
    shared = secret.x25519(a, pb)
    assert shared == secret.x25519(b, pa) == jsecret.x25519(a, pb)


@pytest.mark.parametrize("n", [0, 16, 32, 100, 128])
def test_hkdf(n):
    rng = random.Random(n)
    s, info = rng.randbytes(32), b"keys" + rng.randbytes(64)
    assert secret._hkdf(s, info, n) == jsecret._hkdf(s, info, n)


FRAME_LENGTHS = [0, 1, 31, 32, 33, 1029, 5000, 65536]


def test_direction_frames_byte_equal_and_cross_open():
    rng = random.Random(7)
    key, mac = rng.randbytes(32), rng.randbytes(32)
    mine, theirs = secret._Direction(key, mac), jsecret._Direction(key, mac)
    opener, jopener = secret._Direction(key, mac), \
        jsecret._Direction(key, mac)
    for n in FRAME_LENGTHS:
        pt = rng.randbytes(n)
        sealed = mine.seal(pt)
        assert sealed == theirs.seal(pt)
        assert jopener.open(sealed) == pt
        assert opener.open(sealed) == pt
    assert mine.seq == theirs.seq == len(FRAME_LENGTHS)


def test_direction_rejects_tampered_and_replayed_frames():
    key, mac = b"k" * 32, b"m" * 32
    sealer, opener = secret._Direction(key, mac), secret._Direction(key, mac)
    frame = bytearray(sealer.seal(b"hello world"))
    frame[3] ^= 1
    with pytest.raises(ValueError, match="bad frame MAC"):
        opener.open(bytes(frame))
    ok = sealer.seal(b"second")
    opener.seq = 1
    assert opener.open(ok) == b"second"
    with pytest.raises(ValueError, match="bad frame MAC"):
        opener.open(ok)                 # a replay fails the next sequence


# -- identity records ---------------------------------------------------------

def _node_info(mod, seed: int, **kw):
    pub = PrivKey(bytes([seed]) * 32).pub_key.bytes_
    args = dict(pub_key=pub, moniker=f"n{seed}", network=CHAIN,
                version="0.1.0", listen_addr="tcp://127.0.0.1:26656",
                channels=CHANNELS, other={"rpc": "x", "a": [1, 2]})
    args.update(kw)
    return mod(**args)


@pytest.mark.parametrize("seed", [1, 2])
def test_node_info_json_byte_equal(seed):
    raw = _node_info(NodeInfo, seed).to_json()
    assert raw == _node_info(JNodeInfo, seed).to_json()
    back, jback = NodeInfo.from_json(raw), JNodeInfo.from_json(raw)
    assert back.__dict__ == jback.__dict__
    assert back.to_json() == raw and back.id == jback.id


def test_node_info_compatibility_rules_match():
    a = _node_info(NodeInfo, 1)
    for other in (dict(network="other"), dict(channels=(0x99,)), {}):
        b, jb = _node_info(NodeInfo, 2, **other), \
            _node_info(JNodeInfo, 2, **other)
        try:
            _node_info(JNodeInfo, 1).compatible_with(jb)
            want = None
        except ValueError as e:
            want = str(e)
        if want is None:
            a.compatible_with(b)
        else:
            with pytest.raises(ValueError) as ei:
                a.compatible_with(b)
            assert str(ei.value) == want


@pytest.mark.parametrize("s", ["tcp://127.0.0.1:26656", "10.0.0.2:80",
                               "mem://a:0", "localhost"])
def test_net_address_parse(s):
    a, ja = NetAddress.parse(s), JNetAddress.parse(s)
    assert (a.scheme, a.host, a.port) == (ja.scheme, ja.host, ja.port)
    assert str(a) == str(ja) and a.dial_string() == ja.dial_string()


# -- MConnection packets ------------------------------------------------------

class _Tape:
    """A conn that records what is written and replays given bytes."""

    def __init__(self, data: bytes = b""):
        self.writes: list[bytes] = []
        self._data = bytearray(data)
        self._cv = threading.Condition()
        self.closed = False
        self.label = "tape"

    def write(self, data: bytes) -> None:
        self.writes.append(bytes(data))

    def read_exact(self, n: int) -> bytes:
        with self._cv:
            self._cv.wait_for(lambda: len(self._data) >= n or self.closed)
            if len(self._data) < n:
                raise ConnectionError("tape closed")
            out = bytes(self._data[:n])
            del self._data[:n]
            return out

    def close(self) -> None:
        with self._cv:
            self.closed = True
            self._cv.notify_all()


def _packets(mod, descs, sends) -> list[bytes]:
    tape = _Tape()
    mc = mod.MConnection(tape, descs, lambda *a: None, send_rate=0,
                         recv_rate=0)
    mc.start()
    try:
        for ch, msg in sends:
            assert mc.send(ch, msg)
        total = sum(5 * ((len(m) + 1023) // 1024 or 1) + len(m)
                    for _, m in sends)
        assert _wait(lambda: sum(map(len, tape.writes)) >= total)
    finally:
        mc.stop()
    return tape.writes


def test_mconnection_packets_of_chunked_messages():
    rng = random.Random(3)
    sends = [(0x40, rng.randbytes(2500)), (0x20, b""),
             (0x22, rng.randbytes(1024)), (0x40, rng.randbytes(1))]
    descs = [ChannelDescriptor(id=c) for c in (0x20, 0x22, 0x40)]
    jdescs = [JChannelDescriptor(id=c) for c in (0x20, 0x22, 0x40)]
    mine = _packets(conn, descs, sends)
    theirs = _packets(jconn, jdescs, sends)
    assert mine == theirs
    # each package reassembles the other's bytes into the messages
    for mod, ds, tape_bytes in ((conn, descs, b"".join(theirs)),
                                (jconn, jdescs, b"".join(mine))):
        got = []
        tape = _Tape(tape_bytes)
        mc = mod.MConnection(tape, ds, lambda c, m: got.append((c, m)),
                             send_rate=0, recv_rate=0)
        mc.start()
        try:
            assert _wait(lambda: len(got) == len(sends))
        finally:
            mc.stop()
        assert sorted(got) == sorted(sends)


def test_mconnection_peer_garbage_kills_the_connection():
    """An unknown channel in the peer's bytes is the peer's error: the
    connection dies through `on_error`, as in the JAX package."""
    bad = struct.pack(">BBBH", conn.PKT_MSG, 0x77, conn.FLAG_EOF, 1) + b"x"
    errors, faults = [], []
    mc = MConnection(_Tape(bad), [ChannelDescriptor(id=0x20)],
                     lambda *a: None, on_error=errors.append,
                     on_fault=faults.append)
    mc.start()
    assert _wait(lambda: errors)
    assert isinstance(errors[0], ValueError) and not faults
    assert mc.fault is None


def test_mconnection_receive_error_is_a_fault_not_a_peer_error():
    pkt = struct.pack(">BBBH", conn.PKT_MSG, 0x20, conn.FLAG_EOF, 2) + b"ok"
    errors, faults = [], []
    boom = RuntimeError("kernel launch failed")

    def on_receive(ch, msg):
        raise boom

    mc = MConnection(_Tape(pkt), [ChannelDescriptor(id=0x20)], on_receive,
                     on_error=errors.append, on_fault=faults.append)
    mc.start()
    assert _wait(lambda: faults)
    assert faults == [boom] and mc.fault is boom and not errors
    mc.stop()


@pytest.mark.parametrize("boom", [ValueError("bad field"),
                                  MemoryError(), KeyError("slot")],
                         ids=["ValueError", "MemoryError", "KeyError"])
def test_mconnection_receive_peer_error_kills_the_connection(boom):
    pkt = struct.pack(">BBBH", conn.PKT_MSG, 0x20, conn.FLAG_EOF, 2) + b"ok"
    errors, faults = [], []

    def on_receive(ch, msg):
        raise boom

    mc = MConnection(_Tape(pkt), [ChannelDescriptor(id=0x20)], on_receive,
                     on_error=errors.append, on_fault=faults.append)
    mc.start()
    assert _wait(lambda: errors)
    assert errors == [boom] and mc.fault is None and not faults


def test_node_faults_are_device_and_plane_errors():
    from tendermint_tpu_torch.consensus.state import PlaneFault
    assert conn.is_node_fault(RuntimeError("K1: CUDA launch failed"))
    assert conn.is_node_fault(PlaneFault("batch plane verify failed"))
    assert conn.is_node_fault(KeyboardInterrupt())
    for e in (ValueError(), IndexError(), MemoryError(), KeyError(),
              TypeError(), struct.error()):
        assert not conn.is_node_fault(e)


# -- backoff, meter -----------------------------------------------------------

@pytest.mark.parametrize("jitter", [0.0, 0.2, 0.5])
def test_backoff_delay_for_a_seeded_rng(jitter):
    r, jr = random.Random(11), random.Random(11)
    mine = [switch_mod.backoff_delay(a, r, 1.0, 32.0, jitter)
            for a in range(12)]
    theirs = [jswitch.backoff_delay(a, jr, 1.0, 32.0, jitter)
              for a in range(12)]
    assert mine == theirs


def test_flowrate_meter_under_a_patched_clock():
    rng = random.Random(5)
    m, jm = flowrate.Meter(now=100.0), jflowrate.Meter(now=100.0)
    t = 100.0
    for _ in range(200):
        t += rng.choice([0.01, 0.1, 0.3, 1.7])
        n = rng.randrange(0, 5000)
        m.update(n, now=t)
        jm.update(n, now=t)
        assert m.rate(now=t) == jm.rate(now=t)
    assert m.total == jm.total and m.age(now=t) == jm.age(now=t)
    assert m.rate(now=t + 3600) == jm.rate(now=t + 3600)


# -- switches -----------------------------------------------------------------

class _Recorder:
    """Claims every channel of CHANNELS and keeps what arrives."""

    def __init__(self):
        self.got: list[tuple[int, bytes]] = []
        self.lock = threading.Lock()

    def get_channels(self):
        return [self._desc(id=c) for c in CHANNELS]

    def receive(self, ch_id, peer, msg):
        with self.lock:
            self.got.append((ch_id, msg))


class PortRecorder(_Recorder, Reactor):
    _desc = ChannelDescriptor

    def __init__(self):
        Reactor.__init__(self)
        _Recorder.__init__(self)


class JaxRecorder(_Recorder, JReactor):
    _desc = JChannelDescriptor

    def __init__(self):
        JReactor.__init__(self)
        _Recorder.__init__(self)


def _messages(tag: bytes) -> list[tuple[int, bytes]]:
    rng = random.Random(tag)
    return [(c, tag + rng.randbytes(n))
            for c, n in zip(CHANNELS, (3, 1500, 64, 9, 2100, 40000))]


def test_port_switch_and_jax_switch_handshake_and_exchange():
    mine, theirs = PortRecorder(), JaxRecorder()
    sw = make_switch(CHAIN, {"r": mine}, moniker="port")
    jsw = jswitch.make_switch(CHAIN, {"r": theirs}, moniker="jax")
    sw.start()
    jsw.start()
    try:
        a, b = mem_pair()
        out, errs = {}, {}

        def run(s, c, k, outbound):
            try:
                out[k] = s.add_peer_from_conn(c, outbound=outbound)
            except Exception as e:
                errs[k] = e

        ts = [threading.Thread(target=run, args=(sw, a, "port", True)),
              threading.Thread(target=run, args=(jsw, b, "jax", False))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(DEADLINE_S)
        assert not errs and set(out) == {"port", "jax"}
        assert out["port"].id == jsw.node_info.id
        assert out["jax"].id == sw.node_info.id
        to_jax, to_port = _messages(b"p>j"), _messages(b"j>p")
        for c, m in to_jax:
            assert out["port"].send(c, m)
        for c, m in to_port:
            assert out["jax"].send(c, m)
        assert _wait(lambda: len(theirs.got) == len(to_jax) and
                     len(mine.got) == len(to_port))
        assert sorted(theirs.got) == sorted(to_jax)
        assert sorted(mine.got) == sorted(to_port)
    finally:
        sw.stop()
        jsw.stop()


def test_connected_port_switches_mesh():
    switches = make_connected_switches(
        CHAIN, 3, lambda i: {"r": PortRecorder()})
    try:
        assert all(s.n_peers() == 2 for s in switches)
        switches[0].broadcast(0x30, b"tx")
        assert _wait(lambda: all(s.reactor("r").got == [(0x30, b"tx")]
                                 for s in switches[1:]))
    finally:
        for s in switches:
            s.stop()


class _Raising(PortRecorder):
    def receive(self, ch_id, peer, msg):
        raise RuntimeError("kernel launch failed")


def test_receive_fault_stops_nothing_blames_no_peer_and_stop_raises():
    bad, good = _Raising(), PortRecorder()
    sw, other = (make_switch(CHAIN, {"r": bad}, moniker="faulty"),
                 make_switch(CHAIN, {"r": good}, moniker="peer"))
    sw.start()
    other.start()
    p_sw, _ = connect_switches(sw, other)
    try:
        other.broadcast(0x20, b"vote")
        assert _wait(lambda: sw.fault is not None)
        assert isinstance(sw.fault, RuntimeError)
        time.sleep(0.2)
        # the link stays up and nobody is blamed
        assert sw.get_peer(p_sw.id) is p_sw and other.n_peers() == 1
        assert sw.misbehavior_score(p_sw.id) == 0.0
        assert not sw.is_banned(p_sw.id)
    finally:
        with pytest.raises(RuntimeError, match="kernel launch failed"):
            sw.stop()
        other.stop()


class _Failing(PortRecorder):
    def receive(self, ch_id, peer, msg):
        raise ValueError("bad message")


def test_receive_peer_error_drops_the_peer_as_jax_does():
    sw, other = (make_switch(CHAIN, {"r": _Failing()}, moniker="strict"),
                 make_switch(CHAIN, {"r": PortRecorder()}, moniker="peer"))
    sw.start()
    other.start()
    connect_switches(sw, other)
    try:
        other.broadcast(0x20, b"vote")
        assert _wait(lambda: sw.n_peers() == 0 and other.n_peers() == 0)
        assert sw.fault is None
    finally:
        sw.stop()                       # no fault: nothing to raise
        other.stop()


def test_switch_stop_raises_a_reactor_stop_error_after_stopping_all():
    class Stopping(PortRecorder):
        stopped = False

        def stop(self):
            Stopping.stopped = True
            raise RuntimeError("reactor fault")

    class Quiet(PortRecorder):
        def get_channels(self):
            return [ChannelDescriptor(id=0x50)]

        def stop(self):
            self.stopped = True

    q = Quiet()
    sw = make_switch(CHAIN, {"a": Stopping(), "b": q})
    sw.start()
    with pytest.raises(RuntimeError, match="reactor fault"):
        sw.stop()
    assert Stopping.stopped and q.stopped


def test_switch_refuses_fuzzed_connections_and_takes_the_jax_defaults():
    cfg = P2PConfig()
    from tendermint_tpu.config import P2PConfig as JP2PConfig
    assert cfg.__dict__ == JP2PConfig().__dict__
    assert fast_config().p2p.__dict__ == JP2PConfig().__dict__
    cfg.fuzz = True
    key = PrivKey(b"\x01" * 32)
    info = NodeInfo(pub_key=key.pub_key.bytes_, moniker="f", network=CHAIN,
                    version="0.1.0", listen_addr="")
    # since the fuzzed connection is ported the switch no longer refuses
    # `fuzz`: it wraps each link, seeded from its chaos seed (no drops
    # here, so the handshake goes through)
    from tendermint_tpu_torch.p2p.fuzz import FuzzedConnection
    cfg.laddr = ""
    cfg.fuzz_drop_prob = 0.0
    sw = Switch(key, info, cfg, chaos_seed=5)
    peer = make_switch(CHAIN, {})
    sw.start(); peer.start()
    try:
        connect_switches(sw, peer)
        (link,) = [p.mconn.conn._conn for p in sw.peers()]
        assert isinstance(link, FuzzedConnection)
        from tendermint_tpu_torch.utils.chaos import derive_seed
        assert link.seed == derive_seed(5, "p2p.fuzz", "0")
        assert (link.write_drop_prob, link.write_delay_prob,
                link.max_delay) == (cfg.fuzz_drop_prob, cfg.fuzz_delay_prob,
                                    cfg.fuzz_max_delay)
    finally:
        sw.stop(); peer.stop()


def test_switch_over_tcp_on_loopback():
    """Two port switches listening on 127.0.0.1 dial each other as
    persistent peers through the config, as the smoke's testnet does."""
    cfg = P2PConfig()
    cfg.laddr = "tcp://127.0.0.1:0"
    key = PrivKey(b"\x02" * 32)
    a = Switch(key, NodeInfo(pub_key=key.pub_key.bytes_, moniker="a",
                             network=CHAIN, version="0.1.0",
                             listen_addr=cfg.laddr), cfg, chaos_seed=1)
    a.add_reactor("r", PortRecorder())
    a.start()
    cfg_b = P2PConfig()
    cfg_b.laddr = "tcp://127.0.0.1:0"
    cfg_b.persistent_peers = [a.node_info.listen_addr]
    key_b = PrivKey(b"\x03" * 32)
    b = Switch(key_b, NodeInfo(pub_key=key_b.pub_key.bytes_, moniker="b",
                               network=CHAIN, version="0.1.0",
                               listen_addr=cfg_b.laddr), cfg_b)
    b.add_reactor("r", PortRecorder())
    try:
        assert a.node_info.listen_addr.startswith("tcp://127.0.0.1:")
        assert not a.node_info.listen_addr.endswith(":0")
        b.start()
        assert _wait(lambda: a.n_peers() == 1 and b.n_peers() == 1)
        assert b.peers()[0].persistent and b.peers()[0].outbound
        b.broadcast(0x40, b"status")
        assert _wait(lambda: a.reactor("r").got == [(0x40, b"status")])
    finally:
        a.stop()
        b.stop()
