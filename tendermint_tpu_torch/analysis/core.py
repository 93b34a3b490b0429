"""tmlint core: rule registry, per-file runner, suppressions, baseline.

A rule is a class with a `name`, a `description`, and two hooks:

- ``visit_file(ctx)`` -> findings for one parsed file;
- ``finalize()``      -> findings that need the whole project (the
  lock-order graph spans classes across modules, so cycles can only be
  reported after every file has been visited).

Rules are registered by class (`@register`); each `lint_paths()` call
instantiates them fresh, so a run never sees state from a prior run.

Findings carry a *fingerprint* that is stable across line shifts —
``rule | path | enclosing symbol | message`` hashed — which is what the
committed baseline stores: editing an unrelated part of a file must not
un-grandfather an old finding, and moving a grandfathered finding to a
different function is a new finding on purpose.

Copy of `tendermint_tpu/analysis/core.py`: the same `Finding`
fingerprint, suppression comments, baseline format and `SCHEMA`, so a
baseline or a `--json` document reads the same in both packages.
"""

from __future__ import annotations

import ast
import hashlib
import json
import os
import re
from dataclasses import dataclass, field

SCHEMA = "tmlint/1"

# ---------------------------------------------------------------------------
# findings
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str            # posix-style path relative to the lint root
    line: int
    col: int
    message: str
    symbol: str = ""     # enclosing `Class.method` / function qualname

    @property
    def fingerprint(self) -> str:
        key = f"{self.rule}|{self.path}|{self.symbol}|{self.message}"
        return hashlib.sha256(key.encode()).hexdigest()[:16]

    def to_dict(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "col": self.col, "message": self.message,
                "symbol": self.symbol, "fingerprint": self.fingerprint}

    @staticmethod
    def from_dict(d: dict) -> "Finding":
        return Finding(rule=d["rule"], path=d["path"],
                       line=int(d.get("line", 0)), col=int(d.get("col", 0)),
                       message=d["message"], symbol=d.get("symbol", ""))

    def render(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: [{self.rule}] "
                f"{self.message}"
                + (f"  ({self.symbol})" if self.symbol else ""))


# ---------------------------------------------------------------------------
# file context handed to rules
# ---------------------------------------------------------------------------


@dataclass
class FileCtx:
    path: str                 # relative, posix separators
    abspath: str
    tree: ast.AST
    lines: list[str]          # source lines (1-based access via line-1)

    def qualname_at(self, node: ast.AST) -> str:
        """Enclosing `Class.method`-style symbol for a node, computed
        from the parent map built at parse time."""
        parts = []
        cur = getattr(node, "_tmlint_parent", None)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.ClassDef)):
                parts.append(cur.name)
            cur = getattr(cur, "_tmlint_parent", None)
        return ".".join(reversed(parts))

    def finding(self, rule: str, node: ast.AST, message: str) -> Finding:
        return Finding(rule=rule, path=self.path,
                       line=getattr(node, "lineno", 0),
                       col=getattr(node, "col_offset", 0),
                       message=message, symbol=self.qualname_at(node))


def _link_parents(tree: ast.AST) -> None:
    for parent in ast.walk(tree):
        for child in ast.iter_child_nodes(parent):
            child._tmlint_parent = parent


# ---------------------------------------------------------------------------
# rule registry
# ---------------------------------------------------------------------------


class Rule:
    name = ""
    description = ""

    def visit_file(self, ctx: FileCtx):
        return ()

    def finalize(self):
        return ()


RULE_CLASSES: list[type] = []


def register(cls: type) -> type:
    if not cls.name:
        raise ValueError(f"rule class {cls.__name__} has no name")
    if any(c.name == cls.name for c in RULE_CLASSES):
        raise ValueError(f"duplicate rule name {cls.name!r}")
    RULE_CLASSES.append(cls)
    return cls


def all_rules() -> list[tuple[str, str]]:
    """(name, description) pairs, sorted — the `--list-rules` catalog."""
    return sorted((c.name, c.description) for c in RULE_CLASSES)


# ---------------------------------------------------------------------------
# suppressions: `# tmlint: disable=rule1,rule2` (or `all`) on the line
# ---------------------------------------------------------------------------

_SUPPRESS_RE = re.compile(r"#\s*tmlint:\s*disable=([A-Za-z0-9_,\- ]+)")


def suppressions(lines: list[str]) -> dict[int, set[str]]:
    """Per-line suppressed rule-name sets (1-based line numbers).  A
    comment on its own line also covers the NEXT line, so long findings
    can be suppressed without breaking the line-length budget."""
    out: dict[int, set[str]] = {}
    for i, line in enumerate(lines, start=1):
        m = _SUPPRESS_RE.search(line)
        if not m:
            continue
        rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
        out.setdefault(i, set()).update(rules)
        if line.lstrip().startswith("#"):       # comment-only line
            out.setdefault(i + 1, set()).update(rules)
    return out


def is_suppressed(finding: Finding, suppr: dict[int, set[str]]) -> bool:
    rules = suppr.get(finding.line)
    if not rules:
        return False
    return finding.rule in rules or "all" in rules


# ---------------------------------------------------------------------------
# baseline
# ---------------------------------------------------------------------------


def baseline_path() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "baseline.json")


def load_baseline(path: str | None = None) -> set[str]:
    """Fingerprints of grandfathered findings; missing file = empty."""
    p = path or baseline_path()
    if not os.path.exists(p):
        return set()
    with open(p) as f:
        doc = json.load(f)
    return {e["fingerprint"] for e in doc.get("findings", ())}


def save_baseline(findings, path: str | None = None) -> str:
    """Write the baseline for `findings` (sorted, with human-readable
    context next to each fingerprint so review diffs mean something)."""
    p = path or baseline_path()
    entries = sorted(
        ({"fingerprint": f.fingerprint, "rule": f.rule, "path": f.path,
          "symbol": f.symbol, "message": f.message} for f in findings),
        key=lambda e: (e["path"], e["rule"], e["fingerprint"]))
    doc = {"schema": SCHEMA, "findings": entries}
    tmp = p + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, p)
    return p


# ---------------------------------------------------------------------------
# the run over the files
# ---------------------------------------------------------------------------


@dataclass
class LintResult:
    findings: list[Finding] = field(default_factory=list)   # not suppressed
    suppressed: int = 0
    files: int = 0
    errors: list[str] = field(default_factory=list)   # unparseable files

    def fresh(self, baseline: set[str]) -> list[Finding]:
        """Findings not covered by the baseline — the ones that fail."""
        return [f for f in self.findings if f.fingerprint not in baseline]

    def to_dict(self, baseline: set[str] | None = None) -> dict:
        base = baseline or set()
        return {
            "schema": SCHEMA,
            "files": self.files,
            "suppressed": self.suppressed,
            "errors": self.errors,
            "findings": [{**f.to_dict(),
                          "baselined": f.fingerprint in base}
                         for f in self.findings],
            "fresh_count": len(self.fresh(base)),
        }


def iter_py_files(paths) -> list[str]:
    out = []
    for p in paths:
        if os.path.isfile(p):
            out.append(p)
            continue
        for dirpath, dirnames, filenames in os.walk(p):
            dirnames[:] = sorted(d for d in dirnames
                                 if d != "__pycache__"
                                 and not d.startswith("."))
            out.extend(os.path.join(dirpath, fn)
                       for fn in sorted(filenames) if fn.endswith(".py"))
    return out


def lint_paths(paths, root: str | None = None,
               rules: list[str] | None = None) -> LintResult:
    """Run every registered rule (or the named subset) over `paths`
    (files or directories).  Finding paths are stored relative to
    `root` (default: the common parent of `paths`)."""
    files = iter_py_files(paths)
    if root is None:
        root = (os.path.commonpath([os.path.abspath(p) for p in paths])
                if paths else os.getcwd())
        if os.path.isfile(root):
            root = os.path.dirname(root)
    insts = [cls() for cls in RULE_CLASSES
             if rules is None or cls.name in rules]
    result = LintResult()
    suppr_by_path: dict[str, dict[int, set[str]]] = {}
    raw: list[Finding] = []
    for abspath in files:
        rel = os.path.relpath(os.path.abspath(abspath),
                              root).replace(os.sep, "/")
        try:
            with open(abspath, encoding="utf-8") as f:
                src = f.read()
            tree = ast.parse(src, filename=abspath)
        except (SyntaxError, UnicodeDecodeError, OSError) as e:
            result.errors.append(f"{rel}: {type(e).__name__}: {e}")
            continue
        _link_parents(tree)
        lines = src.splitlines()
        ctx = FileCtx(path=rel, abspath=abspath, tree=tree, lines=lines)
        suppr_by_path[rel] = suppressions(lines)
        result.files += 1
        for rule in insts:
            raw.extend(rule.visit_file(ctx))
    for rule in insts:
        raw.extend(rule.finalize())
    for f in sorted(raw, key=lambda f: (f.path, f.line, f.col, f.rule)):
        if is_suppressed(f, suppr_by_path.get(f.path, {})):
            result.suppressed += 1
        else:
            result.findings.append(f)
    return result


# ---------------------------------------------------------------------------
# shared AST helpers for the rule modules
# ---------------------------------------------------------------------------


def dotted_name(node: ast.AST) -> str:
    """`a.b.c` for Name/Attribute chains, "" for anything else."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def call_name(node: ast.Call) -> str:
    return dotted_name(node.func)
