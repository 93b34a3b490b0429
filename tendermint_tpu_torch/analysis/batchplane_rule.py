"""tmlint rule: hot-path verify producers must ride the batch plane.

- **batchplane-producer**: modules on the verify hot path (``consensus/``,
  ``light/``, ``mempool/``, ``blockchain/``, ``types/``) must submit
  signature-verify work through the batch plane — never call a
  backend's ``verify_batch`` / ``verify_grouped`` /
  ``verify_grouped_templated[_async]`` directly.  A direct call bypasses
  the shared scheduler: its lanes cannot coalesce with concurrent
  producers, ignore priority classes (a light-client flood would no
  longer yield to consensus votes), and skip the plane's occupancy /
  wait-time accounting, so the doctor's half-full-batch attribution
  under-reports.  The scheduler itself (``batchplane/``), the backend
  ladder (``crypto/``), device layers (``ops/``, ``parallel/``) and the
  bench harness stay direct by design.

Copy of `tendermint_tpu/analysis/batchplane_rule.py`, keyed on
`tendermint_tpu_torch.crypto.backend`.  The port passes backends as
objects (ROADMAP "backends and the batch plane are passed explicitly"),
so a rule that only matched module aliases would see nothing: it also
flags those methods called on a backend object — a name or attribute
called ``backend``/``be`` (or ending ``_backend``), or a backend built
in place (``CudaBackend(...)``, ``make_backend(...)``).  A plane
(``plane``, ``self.plane``) is not a backend and stays quiet.  The
port's deliberate direct sites (fast-sync windows verified ahead on the
backend, a commit's one grouped call) carry an inline
``# tmlint: disable=batchplane-producer`` with their reason.
"""

from __future__ import annotations

import ast
import re

from tendermint_tpu_torch.analysis.core import (FileCtx, Rule, call_name,
                                                dotted_name, register)

# path prefixes (posix, package-relative) where the rule applies
_PRODUCER_PREFIXES = ("consensus/", "light/", "mempool/", "blockchain/",
                      "types/")

_VERIFY_METHODS = {"verify_batch", "verify_grouped",
                   "verify_grouped_templated",
                   "verify_grouped_templated_async"}

_BACKEND_MODULE = "tendermint_tpu_torch.crypto.backend"

# the last segment of a receiver that names a backend object
_BACKEND_OBJ_RE = re.compile(r"(^|_)(backend|be)$", re.I)
_BACKEND_CTORS = {"make_backend", "make_rung"}


def _backend_aliases(tree: ast.AST) -> tuple[set, set]:
    """(module_aliases, function_names) bound to crypto.backend in this
    file: ``from tendermint_tpu_torch.crypto import backend as cb`` binds
    the alias ``cb``; ``from tendermint_tpu_torch.crypto.backend import
    verify_grouped`` binds the bare function name."""
    mods: set[str] = set()
    fns: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == _BACKEND_MODULE:
                    mods.add(a.asname or a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom):
            if node.module == "tendermint_tpu_torch.crypto":
                for a in node.names:
                    if a.name == "backend":
                        mods.add(a.asname or "backend")
            elif node.module == _BACKEND_MODULE:
                for a in node.names:
                    if a.name in _VERIFY_METHODS:
                        fns.add(a.asname or a.name)
    return mods, fns


def _is_backend_object(recv: ast.AST, mods: set) -> bool:
    """A receiver that is a backend object: a name/attribute chain whose
    last segment names a backend (not a module alias of crypto.backend,
    matched apart), or a backend constructed in place."""
    if isinstance(recv, ast.Call):
        leaf = call_name(recv).rsplit(".", 1)[-1]
        return leaf.endswith("Backend") or leaf in _BACKEND_CTORS
    name = dotted_name(recv)
    if not name or name in mods:
        return False
    return bool(_BACKEND_OBJ_RE.search(name.rsplit(".", 1)[-1]))


@register
class BatchPlaneProducerRule(Rule):
    name = "batchplane-producer"
    description = ("hot-path producers (consensus/light/mempool/"
                   "blockchain/types) must submit verify work through "
                   "the batch plane, not crypto.backend or a backend "
                   "object directly")

    def visit_file(self, ctx: FileCtx):
        rel = ctx.path.replace("\\", "/")
        for pre in ("tendermint_tpu_torch/", "./"):
            if rel.startswith(pre):
                rel = rel[len(pre):]
        if not rel.startswith(_PRODUCER_PREFIXES):
            return
        mods, fns = _backend_aliases(ctx.tree)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node)
            hit = None
            if "." in name:
                base, meth = name.rsplit(".", 1)
                if base in mods and meth in _VERIFY_METHODS:
                    hit = name
            elif name in fns:
                hit = name
            if hit is None and isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _VERIFY_METHODS and \
                    _is_backend_object(node.func.value, mods):
                recv = node.func.value
                hit = name or (f"{call_name(recv)}(...).{node.func.attr}"
                               if isinstance(recv, ast.Call) else
                               f"<backend>.{node.func.attr}")
            if hit:
                yield ctx.finding(
                    self.name, node,
                    f"direct backend call '{hit}' bypasses the batch "
                    f"plane: lanes cannot coalesce with other producers "
                    f"and skip priority/fairness scheduling — submit via "
                    f"tendermint_tpu_torch.batchplane with an explicit "
                    f"producer= and klass=")
