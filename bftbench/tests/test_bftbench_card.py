"""On the card, at each cell's own size: the control, the program with
every signature left unchecked (K1's mask read as all true), and the
program with the first or the second half of each K1 launch's lanes left
unchecked, each come out not correct on three seeds.  Their readings
print as JSON lines (`-s`)."""

import json
import time

import pytest

from bftbench import harness

# long enough for the mix's longest work: a whole fast-sync pass with its
# tips, or a round over every chain
SECONDS = {"fastsync.v100.load1k": 30.0, "light.v100.c8": 3.0}
SEEDS = (2**32 + 101, 2**32 + 202, 2**32 + 303)


def unchecked_all(ok):
    ok[:] = True


def unchecked_first_half(ok):
    ok[:len(ok) // 2] = True


def unchecked_second_half(ok):
    ok[len(ok) // 2:] = True


def break_k1(monkeypatch, fault):
    """Every K1 call's mask, its real lanes, goes through `fault`."""
    from tendermint_tpu_torch.crypto.backend import CudaBackend
    dispatch = CudaBackend.verify_grouped_templated_async

    def broken(self, *args, **kw):
        collect = dispatch(self, *args, **kw)

        def wait():
            ok = collect().copy()
            fault(ok)
            return ok
        return wait
    monkeypatch.setattr(CudaBackend, "verify_grouped_templated_async",
                        broken)


@pytest.mark.card
@pytest.mark.parametrize("fault", [unchecked_all, unchecked_first_half,
                                   unchecked_second_half])
@pytest.mark.parametrize("cell", sorted(SECONDS))
def test_a_broken_k1_is_not_correct(card, cell, fault, monkeypatch):
    break_k1(monkeypatch, fault)
    for seed in SEEDS:
        out = harness.run(cell, seed, SECONDS[cell], False,
                          t_start=time.perf_counter())
        print(json.dumps({"fault": fault.__name__, "cell": cell,
                          "seed": seed, "correct": out["correct"],
                          "attempted": out["attempted"],
                          "checks": out["checks"]}), flush=True)
        assert out["correct"] is False
