"""The port's light client held against the JAX package's in the cases
of `tests/test_light.py`: sequential following, a wrong validator set
and a height gap, a commit for another block, the two-set rule of
`verify_commit_any`, an update through a validator-set change, and the
multi-chain grid (`verify_chains_batched`), each verdict (trusted state
or error type and message) equal.  The port verifies through a
`BatchPlane` over the golden backend, and over `CudaBackend(device="cpu")`
(the plain K1, templated and with per-lane keys) where one 4-key set is
enough."""

import pytest

from tendermint_tpu.crypto import backend as jcb
from tendermint_tpu.light import client as jlight
from tendermint_tpu.types.block import (Block as JBlock, BlockID as JBlockID,
                                        Commit as JCommit)
from tendermint_tpu.types.validator import (Validator as JValidator,
                                            ValidatorSet as JValidatorSet)
from tendermint_tpu_torch.batchplane import BatchPlane
from tendermint_tpu_torch.crypto.backend import CudaBackend, PythonBackend
from tendermint_tpu_torch.light import client as light
from tendermint_tpu_torch.types.block import Block, BlockID, Commit
from tendermint_tpu_torch.types.validator import Validator, ValidatorSet

from chainutil import build_chain, make_commit, make_validators
from torch_chains import port_chain, port_vals, share_cores

CHAIN = "light-chain"


@pytest.fixture(autouse=True, scope="module")
def _share_cores():
    n = share_cores()
    yield
    import torch
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _jax_python_backend():
    old = jcb._current
    jcb.set_backend("python")
    yield
    jcb._current = old


class _Jax:
    """The JAX light client (its module-level plane, python backend)."""
    Block, BlockID, Commit = JBlock, JBlockID, JCommit
    Validator, ValidatorSet = JValidator, JValidatorSet
    TrustedState, SignedHeader = jlight.TrustedState, jlight.SignedHeader
    ChainBatch = jlight.ChainBatch

    def chain(self, jchain):
        return jchain

    def vals(self, jvs):
        return jvs

    def client(self, chain_id, trusted):
        return jlight.LightClient(chain_id, trusted)

    def any(self, *args):
        return jlight.verify_commit_any(*args)

    def grid(self, chains):
        return jlight.verify_chains_batched(chains)


class _Port:
    """The port's light client over an explicit plane."""
    Block, BlockID, Commit = Block, BlockID, Commit
    Validator, ValidatorSet = Validator, ValidatorSet
    TrustedState, SignedHeader = light.TrustedState, light.SignedHeader
    ChainBatch = light.ChainBatch

    def __init__(self, backend):
        self.plane = BatchPlane(backend)

    def chain(self, jchain):
        return port_chain(jchain)

    def vals(self, jvs):
        return port_vals(jvs)

    def client(self, chain_id, trusted):
        return light.LightClient(chain_id, trusted, self.plane)

    def any(self, *args):
        return light.verify_commit_any(*args, self.plane)

    def grid(self, chains):
        return light.verify_chains_batched(chains, self.plane)


def _verdict(fn, *args) -> tuple:
    """("ok", result summary) or (error type, message)."""
    try:
        out = fn(*args)
    except ValueError as e:
        return (type(e).__name__, str(e))
    if out is None:
        return ("ok",)
    return ("ok", out.height, out.header_hash, out.validators.hash())


@pytest.fixture(scope="module")
def jchains():
    """Each case's chain, built once by the JAX fixtures (fresh signers
    per chain: the JAX signer refuses to sign a lower height)."""
    out = {}
    for name, n, seed in (("follow", 4, 0), ("reject", 3, 0),
                          ("tamper", 2, 0), ("any", 4, 0),
                          ("change", 1, 0)):
        privs, vs = make_validators(4, seed=seed)
        out[name] = (privs, vs, build_chain(privs, vs, CHAIN, n,
                                            txs_per_block=1))
    out["grid"] = []
    for c in range(3):
        privs, vs = make_validators(4, seed=c)
        out["grid"].append((f"chain-{c}", vs, build_chain(
            privs, vs, f"chain-{c}", 3, txs_per_block=1)))
    return out


def _follow(S, jc):
    _, jvs, jchain = jc["follow"]
    vs = S.vals(jvs)
    lc = S.client(CHAIN, S.TrustedState(0, b"", vs))
    return [_verdict(lc.update, S.SignedHeader(b.header, seen), vs)
            for b, _, seen in S.chain(jchain)]


def _reject(S, jc):
    _, jvs, jchain = jc["reject"]
    vs = S.vals(jvs)
    other = S.vals(make_validators(4, seed=9)[1])
    chain = S.chain(jchain)
    lc = S.client(CHAIN, S.TrustedState(0, b"", vs))
    (b1, _, seen1), (b3, _, seen3) = chain[0], chain[2]
    return [_verdict(lc.update, S.SignedHeader(b1.header, seen1), other),
            _verdict(lc.update, S.SignedHeader(b3.header, seen3), vs)]


def _tamper(S, jc):
    _, jvs, jchain = jc["tamper"]
    vs = S.vals(jvs)
    block, ps, seen = S.chain(jchain)[0]
    lc = S.client(CHAIN, S.TrustedState(0, b"", vs))
    bad = S.Commit(block_id=S.BlockID(b"\x55" * 32, ps.header),
                   precommits=seen.precommits)
    return [_verdict(lc.update, S.SignedHeader(block.header, bad), vs)]


def _any(S, jc):
    privs, jvs, jchain = jc["any"]
    vs = S.vals(jvs)
    block, ps, seen = S.chain(jchain)[0]
    bid = S.BlockID(block.hash(), ps.header)
    strangers = make_validators(2, seed=7)[0]
    old_small = S.ValidatorSet(
        [S.Validator(S.vals(JValidatorSet([JValidator(p.pub_key, 10)]))
                     .validators[0].pub_key, 10)
         for p in privs[:2] + strangers])
    old_over = S.ValidatorSet(
        [S.Validator(v.pub_key, 10) for v in vs.validators
         if v.address in {p.address for p in privs[:3]}])
    return [_verdict(S.any, old, vs, CHAIN, bid, 1, seen)
            for old in (vs, old_small, old_over)]


def _change(S, jc):
    privs, jvs, jchain = jc["change"]
    vs = S.vals(jvs)
    b1, ps1, seen1 = S.chain(jchain)[0]
    lc = S.client(CHAIN, S.TrustedState(0, b"", vs))
    out = [_verdict(lc.update, S.SignedHeader(b1.header, seen1), vs)]
    extra = make_validators(2, seed=5)[0]
    jnew = JValidatorSet([JValidator(p.pub_key, 10) for p in privs + extra])
    new_vs = S.vals(jnew)
    all_privs = sorted(privs + extra, key=lambda p: p.address)
    b2 = S.Block.make(chain_id=CHAIN, height=2, time_ns=2_000_000_000,
                      txs=[b"t"], last_commit=seen1,
                      last_block_id=S.BlockID(b1.hash(), ps1.header),
                      validators_hash=new_vs.hash(), app_hash=b"")
    ps2 = b2.make_part_set()
    jb2 = JBlock.decode_bytes(b2.encode())
    jseen2 = make_commit(all_privs, jnew, CHAIN, 2,
                         JBlockID(jb2.hash(), jb2.make_part_set().header))
    seen2 = S.chain([(jb2, jb2.make_part_set(), jseen2)])[0][2]
    assert seen2.block_id.hash == b2.hash()
    out.append(_verdict(lc.update, S.SignedHeader(b2.header, seen2), new_vs))
    out.append(lc.trusted.validators is new_vs)
    # trusting only strangers, the grown set cannot take over
    strangers = S.vals(make_validators(3, seed=11)[1])
    out.append(_verdict(S.any, strangers, new_vs, CHAIN,
                        S.BlockID(b2.hash(), ps2.header), 2, seen2))
    return out


def _grid(S, jc):
    chains = []
    for cid, jvs, jchain in jc["grid"]:
        items = [(S.BlockID(b.hash(), ps.header), b.height, seen)
                 for b, ps, seen in S.chain(jchain)]
        chains.append(S.ChainBatch(cid, S.vals(jvs), items))
    out = [_verdict(S.grid, chains)]
    bid, h, seen = chains[1].items[1]
    votes = list(seen.precommits)
    votes[0] = votes[1]                     # a lane of the wrong signer
    chains[1].items[1] = (bid, h, S.Commit(block_id=seen.block_id,
                                           precommits=votes))
    out.append(_verdict(S.grid, chains))
    sig = bytearray(votes[2].signature)
    sig[0] ^= 1
    votes[0] = seen.precommits[0]
    votes[2] = type(votes[2])(**{**votes[2].__dict__,
                                 "signature": bytes(sig)})
    chains[1].items[1] = (bid, h, S.Commit(block_id=seen.block_id,
                                           precommits=votes))
    out.append(_verdict(S.grid, chains))
    return out


CASES = [_follow, _reject, _tamper, _any, _change, _grid]


@pytest.mark.parametrize("case", CASES, ids=lambda f: f.__name__[1:])
def test_light_matches_reference(jchains, case):
    got = case(_Port(PythonBackend()), jchains)
    want = case(_Jax(), jchains)
    assert got == want
    assert got[0][0] == {"follow": "ok", "reject": "ValueError",
                         "tamper": "ValueError", "any": "ok",
                         "change": "ok", "grid": "ok"}[case.__name__[1:]]


def test_light_verdicts_pinned(jchains):
    """The verdicts themselves, beside their equality with the JAX ones."""
    S = _Port(PythonBackend())
    assert [v[0] for v in _any(S, jchains)] == ["ok", "CommitPowerError",
                                                "ok"]
    assert [v[0] for v in _reject(S, jchains)] == ["ValueError"] * 2
    change = _change(S, jchains)
    assert change[1][:2] == ("ok", 2) and change[2] is True
    assert change[3][0] == "CommitPowerError"
    grid = _grid(S, jchains)
    assert grid[0] == ("ok",)
    assert grid[1][0] == "CommitFormatError"
    assert grid[2] == ("CommitSignatureError",
                       "invalid commit signature at height 2 (lane 2)")


@pytest.mark.parametrize("case", [_follow, _tamper, _any],
                         ids=lambda f: f.__name__[1:])
def test_light_on_the_cuda_backend(jchains, case, cuda_plane):
    """The same verdicts with the plain K1 behind the plane: templated
    (`LightClient.update` on an unchanged set) and with per-lane keys
    (`verify_commit_any`); every case's set is the same 4 keys."""
    assert case(cuda_plane, jchains) == case(_Port(PythonBackend()), jchains)


@pytest.fixture(scope="module")
def cuda_plane():
    return _Port(CudaBackend(device="cpu"))
