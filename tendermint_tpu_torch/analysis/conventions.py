"""tmlint convention rules: RPC route gating, span categories, metric
names.

- **route-gating**: any RPC route literally named ``unsafe_*`` or
  ``debug_*`` must be registered only inside the ``config.rpc.unsafe``
  branch (reference `rpc/core/routes.go:30-46` AddUnsafeRoutes).  A
  debug route outside the gate ships the profiler/filesystem surface to
  every client.

- **route-write-containment**: a route handler that writes to the
  filesystem must contain its target path the same way
  ``debug_trace_start`` does — ``os.path.realpath`` + a parent check —
  because route params are attacker-controlled strings.

- **span-category**: a ``span("name")`` literal must either resolve to
  a category via `utils/tracing.default_category` (name-prefix table)
  or carry an explicit ``cat=`` keyword (including
  ``cat=tracing.CAT_NONE`` for deliberately-uncategorized bookkeeping
  spans).  An uncategorized span silently drops out of the attribution
  partition and its wall clock reads as device_idle in the doctor.
  The prefix table covers the consensus timeline plane too:
  ``consensus.*`` and ``telemetry.*`` spans resolve to the
  CAT_CONSENSUS / CAT_TELEMETRY flight-recorder categories.

- **metric-name**: instrument attributes on a metrics registry render
  as ``tendermint_<attr>`` in the Prometheus 0.0.4 exposition; names
  and Vec label names must match the Prometheus grammar, label names
  must not shadow reserved ones, and the generated ``_bucket``/``_sum``
  /``_count`` series must not collide across instruments (a collision
  corrupts the whole scrape).

- **scenario-budget**: every stress-tier scenario registration (a
  ``register(...)`` call carrying ``safety=``/``liveness=`` where
  ``smoke`` is absent or not literally ``True``) must declare at least
  one metric budget via ``budgets={...}``.  A stress rig without a
  budgeted metric only fails on outright invariant violations — a
  fault-path latency regression sails through green, which is exactly
  what the chaos ledger exists to catch.

Copy of `tendermint_tpu/analysis/conventions.py`.  Every rule reads the
port's tables: `span-category` resolves names through the port's
`utils/tracing.default_category`, whose prefix table also maps
``kernel.`` (the kernel library's build and each entry's first launch)
to the compile category.
"""

from __future__ import annotations

import ast
import re

from tendermint_tpu_torch.analysis.core import (FileCtx, Rule, call_name,
                                          register)

_GATED_PREFIXES = ("unsafe_", "debug_")

_METRIC_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_NAME_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")
_RESERVED_LABELS = {"le", "quantile", "__name__"}

_INSTRUMENT_CTORS = {
    "Counter": (),
    "Gauge": (),
    "Summary": ("_count",),
    "Histogram": ("_bucket", "_sum", "_count"),
    "CounterVec": (),
    "GaugeVec": (),
    "HistogramVec": ("_bucket", "_sum", "_count"),
}

_WRITE_CALLS = {"os.replace", "os.remove", "os.unlink", "os.rename",
                "os.makedirs", "os.mkdir", "os.rmdir", "shutil.rmtree",
                "shutil.copy", "shutil.copyfile", "shutil.move"}


def _str_const(node: ast.AST) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


# ---------------------------------------------------------------------------
# route gating
# ---------------------------------------------------------------------------


def _route_registrations(tree: ast.AST):
    """Yield (route_name, key_node, handler_node) for every string key
    of a dict literal that maps route names to handlers — i.e. whose
    values are `self.<method>` attributes (the Routes.table shape)."""
    for node in ast.walk(tree):
        if not isinstance(node, ast.Dict):
            continue
        pairs = [(k, v) for k, v in zip(node.keys, node.values)
                 if _str_const(k) is not None]
        if not pairs:
            continue
        # route tables map names to bound methods; a dict of string ->
        # string (headers, JSON payloads) is not a route table
        if not all(isinstance(v, ast.Attribute) for _, v in pairs):
            continue
        for k, v in pairs:
            yield _str_const(k), k, v


def _inside_unsafe_branch(node: ast.AST) -> bool:
    """Lexically inside an `if` whose test mentions 'unsafe'."""
    cur = getattr(node, "_tmlint_parent", None)
    while cur is not None:
        if isinstance(cur, ast.If):
            try:
                test_src = ast.unparse(cur.test)
            except Exception:  # pragma: no cover - unparse is total on 3.9+
                test_src = ""
            if "unsafe" in test_src:
                return True
        cur = getattr(cur, "_tmlint_parent", None)
    return False


@register
class RouteGatingRule(Rule):
    name = "route-gating"
    description = ("unsafe_*/debug_* RPC routes must be registered only "
                   "inside the config.rpc.unsafe branch")

    def visit_file(self, ctx: FileCtx):
        for route, key_node, _handler in _route_registrations(ctx.tree):
            if not route.startswith(_GATED_PREFIXES):
                continue
            if not _inside_unsafe_branch(key_node):
                yield ctx.finding(
                    self.name, key_node,
                    f"route '{route}' is named as operator-only but is "
                    f"registered outside the config.rpc.unsafe branch")


@register
class RouteWriteContainmentRule(Rule):
    name = "route-write-containment"
    description = ("route handlers that write files must contain the "
                   "target path (os.path.realpath + parent check), "
                   "since route params are attacker-controlled")

    def visit_file(self, ctx: FileCtx):
        # handler method names referenced from any route table
        handlers: dict[str, ast.AST] = {}
        for _route, key_node, handler in _route_registrations(ctx.tree):
            if (isinstance(handler, ast.Attribute)
                    and isinstance(handler.value, ast.Name)
                    and handler.value.id == "self"):
                handlers.setdefault(handler.attr, key_node)
        if not handlers:
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.FunctionDef):
                continue
            if node.name not in handlers:
                continue
            writes = self._write_sites(node)
            if not writes:
                continue
            calls = {call_name(c) for c in ast.walk(node)
                     if isinstance(c, ast.Call)}
            if "os.path.realpath" in calls:
                continue
            for w in writes:
                yield ctx.finding(
                    self.name, w,
                    f"route handler '{node.name}' writes to the "
                    f"filesystem without os.path.realpath containment "
                    f"of the target path")

    @staticmethod
    def _write_sites(fn: ast.AST) -> list:
        out = []
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node)
            if name in _WRITE_CALLS:
                out.append(node)
            elif name in ("open", "io.open"):
                mode = None
                if len(node.args) >= 2:
                    mode = _str_const(node.args[1])
                for kw in node.keywords:
                    if kw.arg == "mode":
                        mode = _str_const(kw.value)
                if mode and any(c in mode for c in "wax+"):
                    out.append(node)
        return out


# ---------------------------------------------------------------------------
# span categories
# ---------------------------------------------------------------------------


@register
class SpanCategoryRule(Rule):
    name = "span-category"
    description = ("span(\"name\") literals must resolve to a "
                   "flight-recorder category (known name prefix, "
                   "including consensus./telemetry.) or carry an "
                   "explicit cat= keyword")

    def visit_file(self, ctx: FileCtx):
        from tendermint_tpu_torch.utils.tracing import default_category
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            is_span = ((isinstance(func, ast.Name) and func.id == "span")
                       or (isinstance(func, ast.Attribute)
                           and func.attr == "span"))
            if not is_span or not node.args:
                continue
            name = _str_const(node.args[0])
            if name is None:
                continue            # dynamic names can't be checked here
            if any(kw.arg == "cat" for kw in node.keywords):
                continue
            if default_category(name) is None:
                yield ctx.finding(
                    self.name, node,
                    f"span '{name}' has no category: its wall clock "
                    f"reads as device_idle in the doctor — use a prefix "
                    f"known to utils/attribution.py or pass cat= "
                    f"(cat=tracing.CAT_NONE for bookkeeping spans)")


# ---------------------------------------------------------------------------
# metric names
# ---------------------------------------------------------------------------


@register
class MetricNameRule(Rule):
    name = "metric-name"
    description = ("registry instruments must render to valid, "
                   "non-colliding Prometheus series names; Vec labels "
                   "must be valid non-reserved label names")

    def visit_file(self, ctx: FileCtx):
        for cls in ast.walk(ctx.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            series: dict[str, ast.AST] = {}
            for node in ast.walk(cls):
                if not isinstance(node, ast.Assign):
                    continue
                if not isinstance(node.value, ast.Call):
                    continue
                ctor = call_name(node.value).rsplit(".", 1)[-1]
                if ctor not in _INSTRUMENT_CTORS:
                    continue
                for tgt in node.targets:
                    if not (isinstance(tgt, ast.Attribute)
                            and isinstance(tgt.value, ast.Name)
                            and tgt.value.id == "self"):
                        continue
                    yield from self._check_instrument(
                        ctx, tgt.attr, ctor, node.value, series)

    def _check_instrument(self, ctx, attr, ctor, call, series):
        name = f"tendermint_{attr}"
        if not _METRIC_NAME_RE.match(name):
            yield ctx.finding(
                self.name, call,
                f"metric '{name}' is not a valid Prometheus metric name")
        for suffix in ("",) + _INSTRUMENT_CTORS[ctor]:
            full = name + suffix
            if full in series:
                yield ctx.finding(
                    self.name, call,
                    f"metric series '{full}' collides with the one "
                    f"generated by another instrument (corrupts the "
                    f"scrape)")
            series[full] = call
        if ctor in ("CounterVec", "GaugeVec", "HistogramVec") and call.args:
            label = _str_const(call.args[0])
            if label is not None:
                if not _LABEL_NAME_RE.match(label):
                    yield ctx.finding(
                        self.name, call,
                        f"label '{label}' is not a valid Prometheus "
                        f"label name")
                elif label in _RESERVED_LABELS or \
                        label.startswith("__"):
                    yield ctx.finding(
                        self.name, call,
                        f"label '{label}' is reserved in the Prometheus "
                        f"exposition format")


# ---------------------------------------------------------------------------
# scenario metric budgets
# ---------------------------------------------------------------------------


@register
class ScenarioBudgetRule(Rule):
    name = "scenario-budget"
    description = ("stress-tier scenario registrations must declare at "
                   "least one metric budget (budgets={...})")

    def visit_file(self, ctx: FileCtx):
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            if call_name(node).rsplit(".", 1)[-1] != "register":
                continue
            kwargs = {kw.arg: kw.value for kw in node.keywords if kw.arg}
            # scenario registrations carry both invariant lists — that
            # shape separates them from the analysis-rule @register
            # decorator and any other register() in the tree
            if "safety" not in kwargs or "liveness" not in kwargs:
                continue
            smoke = kwargs.get("smoke")
            if isinstance(smoke, ast.Constant) and smoke.value is True:
                continue                    # smoke tier: budgets optional
            budgets = kwargs.get("budgets")
            empty = (budgets is None
                     or (isinstance(budgets, ast.Constant)
                         and budgets.value is None)
                     or (isinstance(budgets, ast.Dict)
                         and not budgets.keys))
            if empty:
                sc_name = (_str_const(node.args[0])
                           if node.args else None) or "<dynamic>"
                yield ctx.finding(
                    self.name, node,
                    f"stress scenario '{sc_name}' declares no metric "
                    f"budgets: without a budgeted metric a fault-path "
                    f"latency regression reads as green — declare "
                    f"budgets={{\"<metric>\": {{\"max\": ...}}}} and "
                    f"report it in the body's budget_metrics")
