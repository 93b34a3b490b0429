"""Seeded mempool load generator.

Copy of `tendermint_tpu/scenarios/loadgen.py` for the port: mixed valid /
bad-signature / duplicate / unsigned traffic through an RPC
`broadcast_tx_sync`-shaped handler into the admission controller and the
batch plane, every submission classified into exactly one outcome:

    offered == admitted + dup + full + backpressure + bad_sig
               + encoding + app + errors

`build_corpus` draws from the `random.Random` exactly as the reference
does, so both corpora are byte-equal for one seed, but signs every digest
in one batch through the backend's `sign_grouped_templated` (kernel K3 on
`CudaBackend`): host signing runs ~200 signatures per second.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

import numpy as np

from tendermint_tpu_torch.abci.types import (ERR_BAD_SIG, ERR_ENCODING,
                                             ERR_MEMPOOL_FULL, OK)
from tendermint_tpu_torch.mempool.mempool import (TAG_ED25519,
                                                  _priority_digest)
from tendermint_tpu_torch.types import merkle

OUTCOMES = ("admitted", "dup", "full", "backpressure", "bad_sig",
            "encoding", "app", "error")


@dataclass
class Mix:
    """Corpus composition.  Counts are absolute (the corpus is finite
    and cycled by the submit loop, so effective traffic shares follow
    these proportions)."""
    unsigned: int = 6_000
    signed: int = 256
    bad_sig: int = 64
    dup_frac: float = 0.25      # fraction of corpus repeated verbatim
    payload_bytes: int = 64
    priorities: tuple = (0, 1, 2, 5, 9)   # sampled per signed tx


@dataclass
class LoadReport:
    offered: int = 0
    duration_s: float = 0.0
    outcomes: dict = field(default_factory=dict)

    @property
    def offered_per_sec(self) -> float:
        return self.offered / max(self.duration_s, 1e-9)

    def summary(self) -> dict:
        return {"offered": self.offered,
                "duration_s": round(self.duration_s, 3),
                "offered_per_sec": round(self.offered_per_sec, 1),
                "outcomes": dict(self.outcomes)}


def build_corpus(rng, mix: Mix | None = None, *, backend) -> list[dict]:
    """Pre-built `broadcast_tx_*` params dicts, seed-deterministic in
    content AND order (the reference's draws, in its order).  All
    envelopes are signed in one `backend.sign_grouped_templated` call on
    their 32-byte digests, so the flood loop never pays for signing."""
    mix = mix or Mix()
    entries: list[dict] = []
    for i in range(mix.unsigned):
        payload = b"lg-u%08d-" % i + rng.randbytes(
            max(mix.payload_bytes - 14, 0))
        entries.append({"tx": payload.hex()})
    to_sign = []                    # (seed, prio, payload, corrupt)
    for i in range(mix.signed):
        seed = rng.randbytes(32)
        prio = rng.choice(mix.priorities)
        payload = b"lg-s%08d-" % i + rng.randbytes(
            max(mix.payload_bytes - 14, 0))
        to_sign.append((seed, prio, payload, False))
    for i in range(mix.bad_sig):
        seed = rng.randbytes(32)
        payload = b"lg-b%08d-" % i + rng.randbytes(
            max(mix.payload_bytes - 14, 0))
        to_sign.append((seed, rng.choice(mix.priorities), payload, True))
    if to_sign:
        seeds = [t[0] for t in to_sign]
        digests = np.frombuffer(b"".join(
            _priority_digest(t[1], t[2]) for t in to_sign),
            np.uint8).reshape(-1, 32)
        lanes = np.arange(len(to_sign), dtype=np.int32)
        sigs = backend.sign_grouped_templated(seeds, lanes, lanes, digests)
        pubs = backend.signing_keys(seeds)[2].cpu().numpy()
        for (_, prio, payload, corrupt), pub, sig in zip(to_sign, pubs,
                                                         sigs):
            tx = bytearray(bytes([TAG_ED25519, prio]) + pub.tobytes()
                           + sig.tobytes() + payload)
            if corrupt:
                tx[40] ^= 0x01           # corrupt one signature byte
            entries.append({"tx": bytes(tx).hex()})
    rng.shuffle(entries)
    n_dup = int(len(entries) * mix.dup_frac)
    entries += [entries[rng.randrange(len(entries))]
                for _ in range(n_dup)]
    rng.shuffle(entries)
    return entries


def broadcast_tx_sync(mempool):
    """A submit callable with the RPC `broadcast_tx_sync` handler's
    result shape (reference `rpc/core/mempool.go`): a cache duplicate
    raises ValueError, anything else answers {code, data, log, hash}."""
    def call(params: dict) -> dict:
        tx = params["tx"]
        tx = bytes.fromhex(tx[2:] if tx.startswith("0x") else tx)
        tx_hash = merkle.leaf_hash(tx)
        res = mempool.check_tx(tx, tx_hash=tx_hash)
        if res is None:
            raise ValueError("tx already in cache")
        return {"code": res.code, "data": res.data.hex(), "log": res.log,
                "hash": tx_hash.hex()}
    return call


def classify(call, params: dict) -> str:
    """Submit one tx through an RPC broadcast handler and name its
    outcome.  `call` is a handler such as `broadcast_tx_sync(mempool)`."""
    try:
        res = call(params)
    except ValueError:
        return "dup"                 # broadcast_tx_sync's cache-hit shape
    except Exception:
        return "error"
    code = res.get("code", OK)
    if code == OK:
        return "admitted"
    if code == ERR_MEMPOOL_FULL:
        return ("backpressure"
                if "backpressure" in res.get("log", "") else "full")
    if code == ERR_BAD_SIG:
        return "bad_sig"
    if code == ERR_ENCODING:
        return "encoding"
    return "app"


class LoadGen:
    """N workers drive a pre-built corpus through a submit callable:
    `run` cycles it closed-loop for a fixed duration, `submit_each`
    offers every entry exactly once.  Totals are merged post-join."""

    def __init__(self, call, corpus: list[dict], workers: int = 1):
        self.call = call
        self.corpus = corpus
        self.workers = max(workers, 1)

    def _run_worker(self, wid: int, stop_at: float,
                    out: list) -> None:
        call = self.call
        corpus = self.corpus
        n = len(corpus)
        counts = dict.fromkeys(OUTCOMES, 0)
        offered = 0
        i = (wid * n) // self.workers
        perf = time.perf_counter
        while perf() < stop_at:
            counts[classify(call, corpus[i])] += 1
            offered += 1
            i += 1
            if i == n:
                i = 0
        out[wid] = (offered, counts)

    def run(self, duration_s: float) -> LoadReport:
        out: list = [None] * self.workers
        t0 = time.perf_counter()
        stop_at = t0 + duration_s
        threads = [threading.Thread(target=self._run_worker,
                                    args=(w, stop_at, out), daemon=True)
                   for w in range(self.workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        elapsed = time.perf_counter() - t0
        report = LoadReport(duration_s=elapsed,
                            outcomes=dict.fromkeys(OUTCOMES, 0))
        for offered, counts in out:
            report.offered += offered
            for k, v in counts.items():
                report.outcomes[k] += v
        return report

    def submit_each(self, entries: list[dict]) -> tuple[list, float]:
        """Offer every entry once (entry i on worker i mod workers).
        Returns each entry's (outcome, seconds in the handler) and the
        wall seconds from the moment all workers are ready (thread start
        is not counted) to the last one's end."""
        out: list = [None] * len(entries)
        ready = threading.Barrier(self.workers + 1)

        def worker(wid: int) -> None:
            perf = time.perf_counter
            ready.wait()
            for i in range(wid, len(entries), self.workers):
                t0 = perf()
                outcome = classify(self.call, entries[i])
                out[i] = (outcome, perf() - t0)

        threads = [threading.Thread(target=worker, args=(w,), daemon=True)
                   for w in range(self.workers)]
        for t in threads:
            t.start()
        ready.wait()
        t0 = time.perf_counter()
        for t in threads:
            t.join()
        return out, time.perf_counter() - t0
