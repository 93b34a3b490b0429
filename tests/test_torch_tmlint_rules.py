"""Golden fixture tests for each rule of the port's tmlint
(`tendermint_tpu_torch/analysis/`), mirroring `tests/test_tmlint_rules.py`:
every rule must catch a seeded violation and stay quiet on the
compliant twin.  For the rules both packages share (lock discipline,
route and span/metric conventions, scenario budgets, the bench loop)
both linters run on the same fixture source and must give equal
(rule, line, col, message, fingerprint) sets.  The JAX hot-path cases
become their torch forms (`torch-host-sync`, `torch-launch-bucket`);
`jax-static-argnums` has none.  `batchplane-producer` runs on the
fixtures with the port's module path, and also on backend objects, the
way the port passes its backends."""

import os
import textwrap

import pytest

from tendermint_tpu.analysis import lint_paths as jax_lint_paths
from tendermint_tpu_torch.analysis import lint_paths

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SHARED = {"lock-order", "unlocked-write", "route-gating",
          "route-write-containment", "span-category", "metric-name",
          "scenario-budget", "bench-scalar-loop"}


def _key(f):
    return (f.rule, f.line, f.col, f.message, f.fingerprint)


def lint_src(tmp_path, src, relpath="mod.py"):
    """Lint one fixture source with the port's linter; the shared rules'
    findings must equal the JAX linter's on the same file.  Returns the
    port's findings."""
    p = tmp_path / relpath
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(src))
    res = lint_paths([str(tmp_path)], root=str(tmp_path))
    assert not res.errors, res.errors
    jres = jax_lint_paths([str(tmp_path)], root=str(tmp_path))
    mine = {_key(f) for f in res.findings if f.rule in SHARED}
    theirs = {_key(f) for f in jres.findings if f.rule in SHARED}
    assert mine == theirs
    return res.findings


def rules_of(findings):
    return {f.rule for f in findings}


# -- lock discipline --------------------------------------------------------


def test_lock_order_cycle_across_classes(tmp_path):
    findings = lint_src(tmp_path, """
        import threading

        class A:
            def __init__(self, b):
                self._lock = threading.Lock()
                self.b = b

            def step(self):
                with self._lock:
                    self.b.poke()

        class B:
            def __init__(self, a):
                self._lock = threading.Lock()
                self.a = a

            def poke(self):
                with self._lock:
                    pass

            def reverse(self):
                with self._lock:
                    self.a.step()
        """)
    cycles = [f for f in findings if f.rule == "lock-order"]
    assert cycles, findings
    assert "A._lock" in cycles[0].message and "B._lock" in cycles[0].message


def test_lock_order_quiet_on_consistent_order(tmp_path):
    findings = lint_src(tmp_path, """
        import threading

        class A:
            def __init__(self, b):
                self._lock = threading.Lock()
                self.b = b

            def step(self):
                with self._lock:
                    self.b.poke()

        class B:
            def __init__(self):
                self._lock = threading.Lock()

            def poke(self):
                with self._lock:
                    pass
        """)
    assert "lock-order" not in rules_of(findings)


def test_lock_order_sees_witness_locks(tmp_path):
    """`new_lock` (the witness's constructor) builds a lock both rules
    see, as `threading.Lock` does."""
    findings = lint_src(tmp_path, """
        from tendermint_tpu_torch.utils import lockwitness

        class A:
            def __init__(self, b):
                self._guard = lockwitness.new_lock("a.guard")
                self.b = b

            def step(self):
                with self._guard:
                    self.b.poke()

        class B:
            def __init__(self, a):
                self._guard = lockwitness.new_lock("b.guard")
                self.a = a

            def poke(self):
                with self._guard:
                    pass

            def reverse(self):
                with self._guard:
                    self.a.step()
        """)
    cycles = [f for f in findings if f.rule == "lock-order"]
    assert cycles and "A._guard" in cycles[0].message, findings


def test_unlocked_write_flagged_and_locked_twin_quiet(tmp_path):
    findings = lint_src(tmp_path, """
        import threading

        class Pool:
            def __init__(self):
                self._lock = threading.Lock()
                self._items = []

            def add(self, x):
                with self._lock:
                    self._items.append(x)

            def clear(self):
                self._items = []     # seeded violation

        class CleanPool:
            def __init__(self):
                self._lock = threading.Lock()
                self._items = []

            def add(self, x):
                with self._lock:
                    self._items.append(x)

            def clear(self):
                with self._lock:
                    self._items = []
        """)
    bad = [f for f in findings if f.rule == "unlocked-write"]
    assert len(bad) == 1
    assert bad[0].symbol == "Pool.clear"


def test_unlocked_write_allows_init_and_private_helper(tmp_path):
    findings = lint_src(tmp_path, """
        import threading

        class Meter:
            def __init__(self):
                self._lock = threading.Lock()
                self._total = 0
                self._load()

            def update(self, n):
                with self._lock:
                    self._total += n
                    self._roll()

            def _roll(self):
                self._total = min(self._total, 100)

            def _load(self):
                self._total = 0
        """)
    assert "unlocked-write" not in rules_of(findings)


# -- torch hot-path hygiene (the JAX package's jax-* cases) -----------------


def test_host_sync_item_flagged_on_hot_path(tmp_path):
    findings = lint_src(tmp_path, """
        import torch

        def count(xs):
            s = torch.sum(xs)
            return s.item()     # seeded violation
        """, relpath="ops/agg.py")
    syncs = [f for f in findings if f.rule == "torch-host-sync"]
    assert syncs and syncs[0].symbol == "count"


def test_host_sync_quiet_off_hot_path(tmp_path):
    findings = lint_src(tmp_path, """
        import torch

        def count(xs):
            return torch.sum(xs).item()
        """, relpath="rpc/agg.py")
    assert "torch-host-sync" not in rules_of(findings)


def test_host_sync_int_of_tainted_value(tmp_path):
    findings = lint_src(tmp_path, """
        import torch

        def total(xs):
            s = torch.sum(xs)
            return int(s)       # seeded violation
        """, relpath="crypto/agg.py")
    assert "torch-host-sync" in rules_of(findings)


@pytest.mark.parametrize("line,what", [
    ("return out.cpu()", ".cpu()"),
    ("return out.numpy()", ".numpy()"),
    ("return out.tolist()", ".tolist()"),
    ("return bool(out.any())", "bool()"),
    ("torch.cuda.synchronize()", "torch.cuda.synchronize()"),
    ("torch.cuda.current_stream().synchronize()", "synchronize()"),
])
@pytest.mark.parametrize("where", ["ops", "crypto", "parallel"])
def test_host_sync_fires_on_each_sync_form(tmp_path, line, what, where):
    """Each sync form in each hot-path directory, on a kernel wrapper's
    output (a call through the port's `ops` package)."""
    findings = lint_src(tmp_path, f"""
        import torch
        from tendermint_tpu_torch.ops import ed25519 as ed

        def run(a, b):
            out = ed.verify_batch(a, b)
            {line}
        """, relpath=f"{where}/mod.py")
    syncs = [f for f in findings if f.rule == "torch-host-sync"]
    assert len(syncs) == 1, findings
    assert what in syncs[0].message or what == "synchronize()"


def test_host_sync_quiet_on_numpy_and_host_facts(tmp_path):
    """numpy values, shapes, lengths and device checks are host facts."""
    findings = lint_src(tmp_path, """
        import numpy as np
        import torch

        def host(a, lanes):
            x = np.asarray(lanes)
            n = int(x.sum())
            t = torch.zeros(4)
            if t.shape[0] > n or len(t) == 0 or t.numel() < 2:
                return x.tolist()
            if torch.cuda.is_available() and t.device.type == "cuda":
                return n
            return int(t.shape[0])
        """, relpath="ops/host.py")
    assert "torch-host-sync" not in rules_of(findings)


def test_host_sync_if_on_a_tensor_value(tmp_path):
    """The torch form of jax-retrace's branch on a traced value: an
    implicit bool() that waits for the device."""
    findings = lint_src(tmp_path, """
        import torch

        def f(x):
            y = torch.relu(x)
            if y.sum() > 0:          # implicit bool() of a device value
                return y
            return -y
        """, relpath="ops/g.py")
    assert "torch-host-sync" in rules_of(findings)


def test_host_sync_quiet_on_shape_branch(tmp_path):
    findings = lint_src(tmp_path, """
        import torch

        def f(x):
            y = torch.relu(x)
            if y.shape[0] > 4:       # a host fact
                return y
            return -y
        """, relpath="ops/h.py")
    assert "torch-host-sync" not in rules_of(findings)


def test_host_sync_allowlist_is_function_scoped(tmp_path):
    """A sync inside an allowed function of `crypto/backend.py` is quiet;
    the same sync in another function of that file fires."""
    findings = lint_src(tmp_path, """
        import torch
        from tendermint_tpu_torch.ops import ed25519 as ed

        class CudaBackend:
            def verify_batch(self, a, b):
                return ed.verify_batch(a, b).cpu().numpy()

            def helper(self, a, b):
                return ed.verify_batch(a, b).cpu().numpy()
        """, relpath="crypto/backend.py")
    syncs = [f for f in findings if f.rule == "torch-host-sync"]
    assert {f.symbol for f in syncs} == {"CudaBackend.helper"}


def test_launch_bucket_flags_unpadded_signature(tmp_path):
    """The torch form of a retrace: a launch signature that follows the
    batch size."""
    findings = lint_src(tmp_path, """
        import numpy as np

        def verify(lanes):
            x = np.asarray(lanes)
            first = _note_dispatch("verify_batch", x)
            return first
        """, relpath="crypto/be.py")
    hits = [f for f in findings if f.rule == "torch-launch-bucket"]
    assert len(hits) == 1 and "'x'" in hits[0].message, findings


def test_launch_bucket_quiet_on_padded_lanes(tmp_path):
    findings = lint_src(tmp_path, """
        import numpy as np

        def verify(self, lanes, templates):
            b = _bucket(len(lanes))
            padded = tuple(_pad_rows(a, b) for a in lanes)
            args = self.sign_args(lanes, templates)
            _note_dispatch("verify_batch", *padded)
            _note_dispatch("sign", *args[3:6], self._templates(templates))
        """, relpath="crypto/be.py")
    assert "torch-launch-bucket" not in rules_of(findings)


def test_no_static_argnums_counterpart(tmp_path):
    """`jax-static-argnums` has no torch form (no static_argnums): the
    JAX linter flags the fixture, the port reports nothing on it."""
    src = """
        from functools import partial
        import jax

        @partial(jax.jit, static_argnums=[0])
        def f(n, x):
            return x * n
        """
    findings = lint_src(tmp_path, src, relpath="ops/s.py")
    assert findings == []
    jres = jax_lint_paths([str(tmp_path)], root=str(tmp_path))
    assert "jax-static-argnums" in {f.rule for f in jres.findings}


# -- route gating / write containment ----------------------------------------


def test_route_gating_flags_ungated_debug_route(tmp_path):
    findings = lint_src(tmp_path, """
        class Routes:
            def __init__(self, node, config):
                self.table = {
                    "status": self.status,
                    "debug_stacks": self.debug_stacks,   # outside gate
                }
                if getattr(config.rpc, "unsafe", False):
                    self.table.update({
                        "unsafe_flush": self.unsafe_flush,
                    })

            def status(self):
                return {}

            def debug_stacks(self):
                return {}

            def unsafe_flush(self):
                return {}
        """)
    gated = [f for f in findings if f.rule == "route-gating"]
    assert len(gated) == 1
    assert "debug_stacks" in gated[0].message


def test_route_write_containment(tmp_path):
    findings = lint_src(tmp_path, """
        import os

        class Routes:
            def __init__(self, config):
                self.table = {}
                if getattr(config.rpc, "unsafe", False):
                    self.table.update({
                        "debug_dump": self.debug_dump,
                        "debug_dump_safe": self.debug_dump_safe,
                    })

            def debug_dump(self, path):
                with open(path, "w") as f:    # uncontained write
                    f.write("x")

            def debug_dump_safe(self, path):
                real = os.path.realpath(path)
                with open(real, "w") as f:
                    f.write("x")
        """)
    writes = [f for f in findings if f.rule == "route-write-containment"]
    assert len(writes) == 1
    assert "debug_dump" in writes[0].message


# -- span / metric conventions -----------------------------------------------


def test_span_category_unknown_prefix_flagged(tmp_path):
    findings = lint_src(tmp_path, """
        from tendermint_tpu_torch.utils import tracing

        def work():
            with tracing.span("mystery.phase"):
                pass

        def fine():
            with tracing.span("verify.dispatch", lanes=8):
                pass

        def also_fine():
            with tracing.span("mystery.other", cat=tracing.CAT_NONE):
                pass
        """)
    spans = [f for f in findings if f.rule == "span-category"]
    assert len(spans) == 1
    assert "mystery.phase" in spans[0].message


def test_span_category_covers_timeline_prefixes(tmp_path):
    findings = lint_src(tmp_path, """
        from tendermint_tpu_torch.utils import tracing

        def lifecycle():
            with tracing.span("consensus.stage.propose"):
                pass
            with tracing.span("consensus.height"):
                pass

        def collector():
            with tracing.span("telemetry.merge"):
                pass

        def typo():
            with tracing.span("consenus.stage.propose"):
                pass
        """)
    spans = [f for f in findings if f.rule == "span-category"]
    assert len(spans) == 1
    assert "consenus.stage.propose" in spans[0].message


def test_span_category_reads_the_ports_table(tmp_path):
    """The port's table maps `kernel.` to the compile category: its
    `kernel.firstcall` and `kernel.build` spans are categorized (the JAX
    rule, reading the JAX table, would flag both)."""
    p = tmp_path / "mod.py"
    p.write_text(textwrap.dedent("""
        from tendermint_tpu_torch.utils import tracing

        def launch():
            with tracing.span("kernel.firstcall", entry="verify_batch"):
                pass
            with tracing.span("kernel.build", sources=7):
                pass
        """))
    res = lint_paths([str(tmp_path)], root=str(tmp_path),
                     rules=["span-category"])
    assert res.findings == []
    jres = jax_lint_paths([str(tmp_path)], root=str(tmp_path),
                          rules=["span-category"])
    assert len(jres.findings) == 2


def test_metric_name_series_collision_and_bad_label(tmp_path):
    findings = lint_src(tmp_path, """
        class Registry:
            def __init__(self):
                self.rpc_s = Histogram()        # generates rpc_s_count
                self.rpc_s_count = Counter()    # collides
                self.peers = GaugeVec("le")     # reserved label
        """)
    msgs = [f.message for f in findings if f.rule == "metric-name"]
    assert any("collides" in m for m in msgs), findings
    assert any("reserved" in m for m in msgs), findings


def test_bench_scalar_loop_flags_loop_in_prep_span(tmp_path):
    findings = lint_src(tmp_path, """
        from tendermint_tpu_torch.utils import tracing

        def prep(blocks):
            with tracing.span("bench.prep", blocks=len(blocks)):
                lanes = []
                for b in blocks:
                    lanes.append(b.lanes())
            return lanes

        def apply(items):
            with tracing.span("bench.apply", blocks=len(items)):
                while items:
                    items.pop()
        """)
    loops = [f for f in findings if f.rule == "bench-scalar-loop"]
    assert len(loops) == 2, findings
    assert "bench.prep" in loops[0].message
    assert "bench.apply" in loops[1].message


def test_bench_scalar_loop_quiet_on_vectorized_and_other_spans(tmp_path):
    findings = lint_src(tmp_path, """
        from tendermint_tpu_torch.utils import tracing

        def prep(blocks, window_commit_lanes, pool):
            with tracing.span("bench.prep", blocks=len(blocks)):
                parts = list(pool.map(hash, blocks))          # executor
                items = [(b, p) for b, p in zip(blocks, parts)]
                lanes = window_commit_lanes(items)            # one pass

        def dispatch(items):
            with tracing.span("bench.dispatch", blocks=len(items)):
                for it in items:
                    it.upload()

        def fastsync_apply(items, apply_window):
            with tracing.span("fastsync.apply", blocks=len(items)):
                for it in items:
                    it.go()

        def helper_defined_inside(items):
            with tracing.span("bench.apply", blocks=len(items)):
                def later():
                    for it in items:    # runs elsewhere, not in-span
                        it.go()
                return later
        """)
    assert [f for f in findings if f.rule == "bench-scalar-loop"] == []


def test_scenario_budget_flags_stress_without_budgets(tmp_path):
    findings = lint_src(tmp_path, """
        from tendermint_tpu_torch.scenarios.engine import register

        def _safety(ctx, obs):
            pass

        @register("storm-a", "a storm", safety=[("s", _safety)],
                  liveness=[("l", _safety)], budget_s=60.0)
        def storm_a(ctx):
            return {}

        @register("storm-b", "b storm", safety=[("s", _safety)],
                  liveness=[("l", _safety)], smoke=False, budgets={})
        def storm_b(ctx):
            return {}
        """)
    hits = [f for f in findings if f.rule == "scenario-budget"]
    assert len(hits) == 2, findings
    assert "storm-a" in hits[0].message
    assert "storm-b" in hits[1].message


def test_scenario_budget_quiet_on_smoke_and_budgeted(tmp_path):
    findings = lint_src(tmp_path, """
        from tendermint_tpu_torch.scenarios.engine import register

        def _safety(ctx, obs):
            pass

        @register("quick", "a smoke", safety=[("s", _safety)],
                  liveness=[("l", _safety)], smoke=True)
        def quick(ctx):
            return {}

        @register("storm", "a storm", safety=[("s", _safety)],
                  liveness=[("l", _safety)], smoke=False,
                  budgets={"commit_latency_p99": {"max": 30.0}})
        def storm(ctx):
            return {}

        def register_other(cls):
            return cls

        table = register_other(dict)
        """)
    assert [f for f in findings if f.rule == "scenario-budget"] == []


def test_scenario_budget_statesync_registration_shapes(tmp_path):
    findings = lint_src(tmp_path, """
        from tendermint_tpu_torch.scenarios.engine import register

        def _safety(ctx, obs):
            pass

        @register("snapshot-join-twin", "rejoin from snapshot",
                  safety=[("restore-parity", _safety)],
                  liveness=[("victim-synced", _safety)],
                  smoke=False, budget_s=420.0,
                  budgets={"catchup_speedup_x": {"min": 10.0}})
        def join_twin(ctx):
            return {}

        @register("snapshot-tamper-twin", "reject corrupted chunks",
                  safety=[("no-silent-acceptance", _safety)],
                  liveness=[("restored", _safety)],
                  smoke=False, budget_s=120.0,
                  budgets={"tamper_restore_s": {"max": 30.0},
                           "tamper_chunks_rejected": {"min": 1.0}})
        def tamper_twin(ctx):
            return {}

        @register("snapshot-torn-tail-twin", "recover past torn tail",
                  safety=[("torn-discarded", _safety)],
                  liveness=[("replayed", _safety)], smoke=True)
        def torn_twin(ctx):
            return {}

        @register("snapshot-join-naked", "stress rig, no budgets",
                  safety=[("s", _safety)], liveness=[("l", _safety)],
                  smoke=False, budget_s=420.0)
        def join_naked(ctx):
            return {}
        """)
    hits = [f for f in findings if f.rule == "scenario-budget"]
    assert len(hits) == 1, findings
    assert "snapshot-join-naked" in hits[0].message


def test_scenario_budget_mempool_registration_shapes(tmp_path):
    findings = lint_src(tmp_path, """
        from tendermint_tpu_torch.scenarios.engine import register

        def _safety(ctx, obs):
            pass

        @register("mempool-flood-twin", "100k tx/s ingress flood",
                  safety=[("zero-silent-drops", _safety)],
                  liveness=[("rig-commits-through-flood", _safety)],
                  smoke=False, budget_s=420.0, backend="rig",
                  budgets={"offered_per_sec": {"min": 100000.0},
                           "admit_p50_s": {"max": 0.001},
                           "admit_p99_s": {"max": 0.25},
                           "commit_latency_p99": {"max": 30.0}})
        def flood_twin(ctx):
            return {}

        @register("eviction-storm-twin", "priority eviction audit",
                  safety=[("no-priority-inversion", _safety)],
                  liveness=[("storm-reached-overload", _safety)],
                  smoke=True, budget_s=180.0,
                  budgets={"priority_inversions": {"max": 0.0},
                           "unaccounted_rejections": {"max": 0.0}})
        def storm_twin(ctx):
            return {}

        @register("mempool-flood-naked", "flood without budgets",
                  safety=[("s", _safety)], liveness=[("l", _safety)],
                  smoke=False, budget_s=420.0, backend="rig")
        def flood_naked(ctx):
            return {}
        """)
    hits = [f for f in findings if f.rule == "scenario-budget"]
    assert len(hits) == 1, findings
    assert "mempool-flood-naked" in hits[0].message


# -- batch-plane producer discipline ---------------------------------------


def _batchplane_both(tmp_path, src, relpath):
    """The port's findings on `src` (the port's module path), and the JAX
    linter's on the same source with the JAX module path: equal on
    (rule, line, col, symbol)."""
    p = tmp_path / "port" / relpath
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(src))
    j = tmp_path / "jax" / relpath
    j.parent.mkdir(parents=True, exist_ok=True)
    j.write_text(textwrap.dedent(src).replace("tendermint_tpu_torch",
                                              "tendermint_tpu"))
    mine = lint_paths([str(p.parent.parent if "/" in relpath else p.parent)],
                      root=str(tmp_path / "port"),
                      rules=["batchplane-producer"]).findings
    theirs = jax_lint_paths([str(tmp_path / "jax")],
                            root=str(tmp_path / "jax"),
                            rules=["batchplane-producer"]).findings
    assert [(f.rule, f.line, f.col, f.symbol) for f in mine] == \
        [(f.rule, f.line, f.col, f.symbol) for f in theirs]
    return mine


def test_batchplane_flags_direct_backend_call_in_producer(tmp_path):
    hits = _batchplane_both(tmp_path, """
        from tendermint_tpu_torch.crypto import backend as cb

        def verify_commit_any(new_set, idxs, msgs, sigs):
            return cb.verify_grouped(new_set.set_key(),
                                     new_set.pubs_matrix(), idxs,
                                     msgs, sigs)
        """, "light/client.py")
    assert len(hits) == 1, hits
    assert "cb.verify_grouped" in hits[0].message


def test_batchplane_flags_from_import_alias(tmp_path):
    hits = _batchplane_both(tmp_path, """
        from tendermint_tpu_torch.crypto.backend import verify_batch as vb

        def check_sigs(pubs, msgs, sigs):
            return vb(pubs, msgs, sigs)
        """, "mempool/mempool.py")
    assert len(hits) == 1, hits


def test_batchplane_quiet_on_plane_submission_twin(tmp_path):
    hits = _batchplane_both(tmp_path, """
        from tendermint_tpu_torch import batchplane

        def verify_commit_any(new_set, idxs, msgs, sigs):
            return batchplane.verify_grouped(
                new_set.set_key(), new_set.pubs_matrix(), idxs, msgs,
                sigs, producer="light", klass=batchplane.CLASS_LIGHT)
        """, "light/client.py")
    assert hits == []


def test_batchplane_allows_scheduler_and_bench_direct_calls(tmp_path):
    src = """
        from tendermint_tpu_torch.crypto import backend as cb

        def _run_grouped(set_key, val_pubs, idx, msgs, sigs, backend):
            backend.verify_batch(val_pubs, msgs, sigs)
            return cb.verify_grouped(set_key, val_pubs, idx, msgs, sigs)
        """
    for rel in ("batchplane/scheduler.py", "crypto/supervised.py",
                "bench.py"):
        findings = lint_src(tmp_path, src, relpath=rel)
        assert not [f for f in findings
                    if f.rule == "batchplane-producer"], rel


def test_batchplane_flags_backend_objects(tmp_path):
    """The port passes backends as objects: their verify methods in a
    producer directory are direct calls, a plane's are not."""
    findings = lint_src(tmp_path, """
        from tendermint_tpu_torch.crypto.backend import CudaBackend

        class Syncer:
            def __init__(self, backend, plane):
                self.backend = backend
                self.plane = plane

            def window(self, k, p, i, t, tm, s):
                self.backend.verify_grouped_templated(k, p, i, t, tm, s)
                return self.plane.verify_grouped_templated(k, p, i, t,
                                                           tm, s)

        def commit(vals, be, plane, pubs, msgs, sigs):
            be.verify_batch(pubs, msgs, sigs)
            CudaBackend("cpu").verify_batch(pubs, msgs, sigs)
            plane.verify_batch(pubs, msgs, sigs)
            return vals.verify_grouped(pubs, msgs, sigs)
        """, relpath="blockchain/sync.py")
    hits = sorted((f.line, f.message.split("'")[1]) for f in findings
                  if f.rule == "batchplane-producer")
    assert [h[1] for h in hits] == [
        "self.backend.verify_grouped_templated", "be.verify_batch",
        "CudaBackend(...).verify_batch"], hits


def test_batchplane_port_direct_sites_carry_their_reason():
    """The port's four deliberate direct sites are suppressed inline, and
    the plane's own calls stay quiet."""
    pkg = os.path.join(ROOT, "tendermint_tpu_torch")
    files = [os.path.join(pkg, p) for p in (
        "blockchain/replay.py", "blockchain/reactor.py",
        "types/validator.py", "consensus/state.py", "light/client.py",
        "mempool/mempool.py", "types/vote.py")]
    res = lint_paths(files, root=ROOT, rules=["batchplane-producer"])
    assert res.findings == [] and res.suppressed == 4


def test_rule_catalog_covers_all_families():
    from tendermint_tpu_torch.analysis import all_rules
    names = {n for n, _ in all_rules()}
    assert names == {"lock-order", "unlocked-write", "torch-host-sync",
                     "torch-launch-bucket", "route-gating",
                     "route-write-containment", "span-category",
                     "bench-scalar-loop", "metric-name", "scenario-budget",
                     "batchplane-producer"}
