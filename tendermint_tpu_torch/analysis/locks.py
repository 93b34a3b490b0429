"""tmlint lock-discipline rules.

The reference implementation leans on Go's race detector to keep its ~30
goroutine-heavy modules honest; the Python port lost that, and the two
bug classes it would have caught here are:

- **lock-order**: a cycle in the static lock-acquisition graph — class A
  acquires its lock and, while holding it, calls into something that
  acquires lock B, while another path acquires B then A.  Two threads on
  the two paths deadlock.  The graph is built per class from
  ``with self._lock:`` blocks (and ``.acquire()`` calls), following
  method calls on ``self`` and on member objects whose class is known
  (``self.pool = BlockPool(...)`` in ``__init__``), transitively.

- **unlocked-write**: an instance attribute written both inside and
  outside the owning class's ``with self._lock:`` blocks (``__init__``
  excluded — construction is single-threaded).  This is the bug class
  behind the `/validators` accum fix: a reader snapshotting state
  under the lock can interleave with the unlocked writer.  Container
  mutations (``self.x.append(...)``) count as writes.

Single-writer designs that deliberately write without the lock should
say so with an inline ``# tmlint: disable=unlocked-write`` at the write
site — the suppression comment is the documentation.

Copy of `tendermint_tpu/analysis/locks.py`.  `_LOCK_CTORS` keeps
`new_lock` and `WitnessLock`, so the port's witness-built locks
(`utils/lockwitness.py`) stay visible to both rules.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field

from tendermint_tpu_torch.analysis.core import (FileCtx, Finding, Rule,
                                          dotted_name, register)

# attribute names that look like locks even when the assignment of a
# threading ctor isn't in view (helper-constructed locks)
_LOCKNAME_RE = re.compile(r"lock|mtx|mutex|cv|cond", re.I)

_LOCK_CTORS = {"Lock", "RLock", "Condition", "Semaphore",
               "BoundedSemaphore", "new_lock", "WitnessLock"}

# method names on `self.<attr>` treated as mutations of <attr>
_MUTATORS = {"append", "extend", "add", "discard", "remove", "pop",
             "popleft", "append_left", "appendleft", "clear", "update",
             "insert", "setdefault"}

# method names too generic for unique-definer call resolution: a
# `self._data.get(k)` is a dict, not whichever scanned class happens to
# define get() — resolving it would invent lock edges out of thin air
_GENERIC_METHS = _MUTATORS | {
    "get", "items", "keys", "values", "popitem", "copy", "count",
    "index", "sort", "join", "split", "strip", "encode", "decode",
    "format", "read", "write", "close", "open", "flush", "send",
    "recv", "put", "get_nowait", "put_nowait", "start", "stop",
    "wait", "notify", "notify_all", "acquire", "release", "set",
    "is_set",
}


def _self_attr(node: ast.AST) -> str | None:
    """'x' for `self.x`, else None."""
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


@dataclass
class _Site:
    path: str
    line: int
    col: int
    symbol: str


@dataclass
class _MethodInfo:
    name: str = ""
    acquires: set = field(default_factory=set)       # lock attrs
    calls: list = field(default_factory=list)  # (kind, attr, meth, locked)
    # (held_frozenset, lock_attr, site): lock acquired while holding
    nested_acquires: list = field(default_factory=list)
    # (held_frozenset, kind, attr, meth, site)
    held_calls: list = field(default_factory=list)
    writes: list = field(default_factory=list)       # (attr, locked, site)


@dataclass
class _ClassInfo:
    name: str
    path: str
    lock_attrs: set = field(default_factory=set)
    members: dict = field(default_factory=dict)      # attr -> class name
    methods: dict = field(default_factory=dict)      # name -> _MethodInfo


class _LockScanBase(Rule):
    """Shared per-class scan; subclasses report from `self._classes`."""

    def __init__(self):
        self._classes: dict[str, _ClassInfo] = {}    # "path::Class"
        self._by_name: dict[str, list[str]] = {}     # Class -> [keys]

    # -- per-file collection --------------------------------------------
    def visit_file(self, ctx: FileCtx):
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ClassDef):
                self._scan_class(ctx, node)
        return ()

    def _scan_class(self, ctx: FileCtx, cls: ast.ClassDef) -> None:
        info = _ClassInfo(name=cls.name, path=ctx.path)
        # pass 1: lock attrs + member objects from assignments
        for node in ast.walk(cls):
            if not isinstance(node, ast.Assign):
                continue
            for tgt in node.targets:
                attr = _self_attr(tgt)
                if attr is None:
                    continue
                if isinstance(node.value, ast.Call):
                    ctor = dotted_name(node.value.func).rsplit(".", 1)[-1]
                    if ctor in _LOCK_CTORS:
                        info.lock_attrs.add(attr)
                    elif ctor[:1].isupper():
                        info.members[attr] = ctor
        # pass 2: `with self.x:` on a lock-looking name counts as a lock
        for node in ast.walk(cls):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    attr = _self_attr(item.context_expr)
                    if attr and _LOCKNAME_RE.search(attr):
                        info.lock_attrs.add(attr)
        # pass 3: per-method event scan (__init__ included: its writes
        # are construction and never reported, but its CALLS classify
        # private helpers as construction-only, see UnlockedWriteRule)
        for st in cls.body:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
                mi = _MethodInfo(name=st.name)
                self._scan_block(ctx, info, mi, st.body, ())
                info.methods[st.name] = mi
        if not (info.lock_attrs or info.members):
            return
        key = f"{ctx.path}::{cls.name}"
        self._classes[key] = info
        self._by_name.setdefault(cls.name, []).append(key)

    def _scan_block(self, ctx, info, mi, stmts, held) -> None:
        held = tuple(held)
        for st in stmts:
            if isinstance(st, (ast.With, ast.AsyncWith)):
                entered = list(held)
                for item in st.items:
                    self._scan_expr(ctx, info, mi, item.context_expr,
                                    tuple(entered))
                    attr = _self_attr(item.context_expr)
                    if attr in info.lock_attrs:
                        self._note_acquire(ctx, mi, attr, tuple(entered),
                                           item.context_expr)
                        entered.append(attr)
                self._scan_block(ctx, info, mi, st.body, tuple(entered))
            elif isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # nested def: runs later (thread target / callback), so
                # locks held *here* are not held *there*
                self._scan_block(ctx, info, mi, st.body, ())
            elif isinstance(st, ast.ClassDef):
                continue
            elif isinstance(st, (ast.If, ast.While)):
                self._scan_expr(ctx, info, mi, st.test, held)
                self._scan_block(ctx, info, mi, st.body, held)
                self._scan_block(ctx, info, mi, st.orelse, held)
            elif isinstance(st, (ast.For, ast.AsyncFor)):
                self._scan_expr(ctx, info, mi, st.iter, held)
                self._scan_write_target(ctx, info, mi, st.target, held)
                self._scan_block(ctx, info, mi, st.body, held)
                self._scan_block(ctx, info, mi, st.orelse, held)
            elif isinstance(st, ast.Try):
                self._scan_block(ctx, info, mi, st.body, held)
                for h in st.handlers:
                    self._scan_block(ctx, info, mi, h.body, held)
                self._scan_block(ctx, info, mi, st.orelse, held)
                self._scan_block(ctx, info, mi, st.finalbody, held)
            else:
                # leaf statement: writes, calls, acquire()/release()
                self._scan_leaf(ctx, info, mi, st, held)
                held = self._apply_acquire_release(ctx, info, mi, st,
                                                  held)

    def _apply_acquire_release(self, ctx, info, mi, st, held):
        """`self.x.acquire()` holds for the rest of the current block;
        `release()` drops it."""
        for node in ast.walk(st):
            if not isinstance(node, ast.Call):
                continue
            if not isinstance(node.func, ast.Attribute):
                continue
            attr = _self_attr(node.func.value)
            if attr not in info.lock_attrs:
                continue
            if node.func.attr == "acquire":
                self._note_acquire(ctx, mi, attr, held, node)
                held = held + (attr,)
            elif node.func.attr == "release" and attr in held:
                idx = len(held) - 1 - held[::-1].index(attr)
                held = held[:idx] + held[idx + 1:]
        return held

    def _note_acquire(self, ctx, mi, attr, held, node) -> None:
        mi.acquires.add(attr)
        if held and attr not in held:       # re-entrant RLock: not an edge
            mi.nested_acquires.append(
                (frozenset(held), attr, self._site(ctx, node)))

    def _scan_leaf(self, ctx, info, mi, st, held) -> None:
        locked = bool(held)
        if isinstance(st, ast.Assign):
            for tgt in st.targets:
                self._scan_write_target(ctx, info, mi, tgt, held)
            self._scan_expr(ctx, info, mi, st.value, held)
        elif isinstance(st, (ast.AugAssign, ast.AnnAssign)):
            self._scan_write_target(ctx, info, mi, st.target, held)
            if st.value is not None:
                self._scan_expr(ctx, info, mi, st.value, held)
        elif isinstance(st, ast.Delete):
            for tgt in st.targets:
                self._scan_write_target(ctx, info, mi, tgt, held)
        else:
            self._scan_expr(ctx, info, mi, st, held)
        del locked

    def _scan_write_target(self, ctx, info, mi, tgt, held) -> None:
        if isinstance(tgt, (ast.Tuple, ast.List)):
            for el in tgt.elts:
                self._scan_write_target(ctx, info, mi, el, held)
            return
        node = tgt
        if isinstance(node, ast.Subscript):      # self.x[k] = v
            node = node.value
        attr = _self_attr(node)
        if attr is not None and attr not in info.lock_attrs:
            mi.writes.append((attr, bool(held), self._site(ctx, tgt)))

    def _scan_expr(self, ctx, info, mi, expr, held) -> None:
        """Collect calls (and mutator-call writes) from an expression
        tree; nested lambdas/comprehensions are included — they run
        inline."""
        for node in ast.walk(expr):
            if not isinstance(node, ast.Call):
                continue
            if not isinstance(node.func, ast.Attribute):
                continue
            meth = node.func.attr
            recv = node.func.value
            attr = _self_attr(recv)
            if attr is not None:
                if meth in _MUTATORS and attr not in info.lock_attrs:
                    mi.writes.append((attr, bool(held),
                                      self._site(ctx, node)))
                # record every `self.<attr>.<meth>()`; the target class
                # is resolved lazily in finalize (ctor-typed members
                # first, unique definer as fallback — most members are
                # injected via __init__ params, not constructed)
                mi.calls.append(("member", attr, meth, bool(held)))
                if held:
                    mi.held_calls.append(
                        (frozenset(held), "member", attr, meth,
                         self._site(ctx, node)))
            elif isinstance(recv, ast.Name) and recv.id == "self":
                mi.calls.append(("self", "", meth, bool(held)))
                if held:
                    mi.held_calls.append(
                        (frozenset(held), "self", "", meth,
                         self._site(ctx, node)))

    def _site(self, ctx: FileCtx, node: ast.AST) -> _Site:
        return _Site(ctx.path, getattr(node, "lineno", 0),
                     getattr(node, "col_offset", 0), ctx.qualname_at(node))

    # -- shared closure machinery ---------------------------------------
    def _resolve(self, cls_name: str) -> str | None:
        keys = self._by_name.get(cls_name) or ()
        return keys[0] if len(keys) == 1 else None

    def _resolve_call(self, info: _ClassInfo, attr: str,
                      meth: str) -> str | None:
        """Target class key for `self.<attr>.<meth>()`: the member's
        constructed class when `__init__` shows one, else the single
        scanned class defining <meth> (members are usually injected as
        ctor params, so the attr's type is invisible statically)."""
        tk = self._resolve(info.members.get(attr, ""))
        if tk is not None:
            return tk
        if meth in _GENERIC_METHS:
            return None
        cands = [k for k, ci in self._classes.items()
                 if meth in ci.methods and ci.name != info.name]
        return cands[0] if len(cands) == 1 else None

    def _closure(self, key: str, meth: str, memo: dict,
                 visiting: set) -> frozenset:
        """Lock NODES ("Class.attr") this method may acquire,
        transitively through self- and member-calls."""
        mk = (key, meth)
        if mk in memo:
            return memo[mk]
        if mk in visiting:
            return frozenset()
        visiting.add(mk)
        info = self._classes.get(key)
        out: set = set()
        mi = info.methods.get(meth) if info else None
        if mi is not None:
            out.update(f"{info.name}.{a}" for a in mi.acquires)
            for kind, attr, m, _locked in mi.calls:
                if kind == "self":
                    out |= self._closure(key, m, memo, visiting)
                else:
                    tk = self._resolve_call(info, attr, m)
                    if tk is not None:
                        out |= self._closure(tk, m, memo, visiting)
        visiting.discard(mk)
        memo[mk] = frozenset(out)
        return memo[mk]


@register
class LockOrderRule(_LockScanBase):
    name = "lock-order"
    description = ("cycle in the static lock-acquisition graph "
                   "(potential deadlock between two threads taking the "
                   "locks in opposite orders)")

    def finalize(self):
        # edges: holder lock node -> acquired lock node, with one sample
        # site per edge
        edges: dict[str, dict[str, _Site]] = {}

        def add_edge(a: str, b: str, site: _Site) -> None:
            if a != b:
                edges.setdefault(a, {}).setdefault(b, site)

        memo: dict = {}
        for key, info in self._classes.items():
            for mi in info.methods.values():
                if mi.name in ("__init__", "__new__"):
                    continue        # construction is single-threaded
                for held, attr, site in mi.nested_acquires:
                    for h in held:
                        add_edge(f"{info.name}.{h}", f"{info.name}.{attr}",
                                 site)
                for held, kind, attr, meth, site in mi.held_calls:
                    if kind == "self":
                        tgt = self._closure(key, meth, memo, set())
                    else:
                        tk = self._resolve_call(info, attr, meth)
                        tgt = (self._closure(tk, meth, memo, set())
                               if tk else frozenset())
                    for h in held:
                        hn = f"{info.name}.{h}"
                        for t in tgt:
                            add_edge(hn, t, site)
        return self._report_cycles(edges)

    def _report_cycles(self, edges):
        findings, seen = [], set()
        for a in sorted(edges):
            for b in sorted(edges[a]):
                path = self._find_path(edges, b, a)
                if path is None:
                    continue
                cycle = [a] + path               # a -> b -> ... -> a
                if frozenset(cycle) in seen:
                    continue
                seen.add(frozenset(cycle))
                site = edges[a][b]
                findings.append(Finding(
                    rule=self.name, path=site.path, line=site.line,
                    col=site.col, symbol=site.symbol,
                    message=("lock-order cycle: "
                             + " -> ".join(cycle + [a])
                             + f" (acquires {b} while holding {a})")))
        return findings

    @staticmethod
    def _find_path(edges, src, dst):
        """Node path src..dst following edges, or None."""
        stack, seen = [(src, [src])], {src}
        while stack:
            node, path = stack.pop()
            if node == dst:
                return path
            for nxt in sorted(edges.get(node, ())):
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None


@register
class UnlockedWriteRule(_LockScanBase):
    name = "unlocked-write"
    description = ("instance attribute written both inside and outside "
                   "the owning class's lock (torn-read hazard; the "
                   "/validators accum bug class)")

    def finalize(self):
        findings = []
        for key in sorted(self._classes):
            info = self._classes[key]
            if not info.lock_attrs:
                continue
            protected, skipped = self._classify_helpers(info)
            locked_attrs: set = set()
            for mi in info.methods.values():
                if mi.name in ("__init__", "__new__") or \
                        mi.name in skipped:
                    continue
                treat_locked = mi.name in protected
                locked_attrs.update(a for a, locked, _ in mi.writes
                                    if locked or treat_locked)
            for mi in info.methods.values():
                if mi.name in ("__init__", "__new__") or \
                        mi.name in protected or mi.name in skipped:
                    continue
                for attr, locked, site in mi.writes:
                    if locked or attr not in locked_attrs:
                        continue
                    findings.append(Finding(
                        rule=self.name, path=site.path, line=site.line,
                        col=site.col, symbol=site.symbol,
                        message=(f"attribute '{attr}' of class "
                                 f"{info.name} is written here without "
                                 f"the lock that guards its other "
                                 f"writes")))
        return findings

    @staticmethod
    def _classify_helpers(info: _ClassInfo) -> tuple[set, set]:
        """Private helpers whose intra-class call sites prove their
        locking context: `protected` = every caller holds a lock (or is
        construction) — writes count as locked; `skipped` = only ever
        called during construction — writes are single-threaded and not
        reported at all (the `self._load()`-from-`__init__` pattern)."""
        callers: dict[str, list] = {}     # meth -> [(caller, locked)]
        for mi in info.methods.values():
            for kind, _attr, meth, locked in mi.calls:
                if kind == "self":
                    callers.setdefault(meth, []).append((mi.name, locked))
        protected: set = set()
        skipped: set = set()
        for meth, sites in callers.items():
            mi = info.methods.get(meth)
            if mi is None or not meth.startswith("_") or \
                    meth.startswith("__"):
                continue                  # public API: callers unknown
            if all(c in ("__init__", "__new__") for c, _ in sites):
                skipped.add(meth)
            elif all(locked or c in ("__init__", "__new__")
                     for c, locked in sites):
                protected.add(meth)
        return protected, skipped
