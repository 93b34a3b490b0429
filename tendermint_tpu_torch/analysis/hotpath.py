"""tmlint torch hot-path hygiene rules.

The doctor (`utils/attribution.py`) can *observe* a host sync or a new
launch signature at run time, but only on paths a run happens to
exercise.  These rules catch the same hazards statically, in the modules
that are on the device hot path (``ops/``, ``crypto/``, ``parallel/``).
They are the torch counterparts of the JAX package's hot-path family
(`tendermint_tpu/analysis/hotpath.py`), rethought for eager PyTorch
launching hand-written CUDA kernels:

- **torch-host-sync** (for ``jax-host-sync``): an implicit device->host
  synchronization — ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``
  or ``int()/float()/bool()`` of a value that a ``torch.`` call, a tensor
  method or a kernel wrapper (a call through the port's ``ops`` or
  ``parallel`` modules) produced, an ``if``/``while`` on such a value (an
  implicit ``bool()``), and an explicit ``torch.cuda.synchronize()`` or
  ``Stream``/``Event.synchronize()``.  A launch returns before its kernel
  ends; each of these waits for it, so one inside a per-batch loop is
  the "scalar_tail" thief the doctor reports.  Deliberate sync points
  live in ``ALLOWED_SYNC_FUNCS`` (function-scope allowlist, stable
  across line shifts) or carry an inline
  ``# tmlint: disable=torch-host-sync``.

- **torch-launch-bucket** (for ``jax-retrace``): the nearest torch form
  of a retrace.  A hand-written kernel compiles once per source tree,
  whatever the shapes, so nothing retraces; what the JAX hazard costs
  there survives as a launch *signature* that follows the batch size.
  Every array whose signature ``_note_dispatch`` records must come from
  the bucketing helpers (``_bucket``/``_pad_rows`` and the backend's
  helpers built on them); an unpadded one makes every new batch size a
  new signature, which ``_note_dispatch`` counts as a recompile at run
  time (``xla_recompiles``).  The other half of ``jax-retrace`` — a
  traced function reading a mutable global — has no torch form here:
  the port traces nothing (no ``torch.compile``, no ``torch.jit``), and
  its branch-on-a-traced-value half is the implicit ``bool()`` that
  ``torch-host-sync`` flags.

- ``jax-static-argnums`` has no counterpart: torch has no
  ``static_argnums``.  A kernel's integer arguments pass by value to a
  kernel compiled once, so no argument can be marked static and no
  value recompiles anything.

- **bench-scalar-loop**: copied from the JAX package, with the port's
  span table; it applies to the port's benchmark file once one exists.
"""

from __future__ import annotations

import ast

from tendermint_tpu_torch.analysis.core import (FileCtx, Rule, call_name,
                                                register)

# path fragments (posix, relative) that put a file on the device hot path
HOT_PATH_DIRS = ("ops/", "crypto/", "parallel/")

# deliberate sync points: (path suffix, enclosing qualname).  These are
# the API boundary of the crypto plane: a verify or sign returns numpy to
# its consensus/fast-sync/mempool callers, so the copy back IS the
# contract; the table build waits for K2 so its time (and the on-disk
# cache write) covers the build, not its enqueue.  Function-scoped (not
# line-numbered) so edits inside the file don't rot the allowlist.
ALLOWED_SYNC_FUNCS = {
    # a lane array that lies on a device, copied back for the mesh route
    ("crypto/backend.py", "_host"),
    # K2 waited on: table_build_seconds and the .npz write need the tables
    ("crypto/backend.py", "CudaBackend._build"),
    # verify/sign API boundary: device lane-masks become numpy bools
    ("crypto/backend.py", "CudaBackend.verify_grouped_templated_async"),
    ("crypto/backend.py",
     "CudaBackend.verify_grouped_templated_async.wait"),
    ("crypto/backend.py", "CudaBackend.verify_grouped"),
    ("crypto/backend.py", "CudaBackend.verify_batch"),
    ("crypto/backend.py", "CudaBackend.sign_grouped_templated"),
    ("crypto/backend.py", "CudaBackend.leaf_hashes"),
    # the warmer exists to absorb the build and first launches
    ("crypto/warmcompile.py", "_warm_one"),
}

_HOST_CASTS = {"float", "int", "bool", "complex"}

# tensor methods that copy to the host or read a value back
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}

# methods only a torch tensor has: their result is a tensor whatever
# produced the receiver (numpy arrays have none of them)
_TENSOR_METHODS = {"cpu", "cuda", "to", "contiguous", "detach",
                   "pin_memory", "unsqueeze", "permute", "expand",
                   "masked_fill", "index_select", "narrow", "new_zeros",
                   "new_empty", "new_full", "float", "long",
                   "int", "bool", "byte", "half"}

# torch.* calls that return host objects (devices, counts, streams,
# flags), not tensors
_NON_TENSOR_TORCH_CALLS = {
    "torch.device", "torch.cuda.is_available", "torch.cuda.device_count",
    "torch.cuda.get_device_name", "torch.cuda.current_device",
    "torch.cuda.Stream", "torch.cuda.Event", "torch.cuda.stream",
    "torch.cuda.current_stream", "torch.cuda.synchronize",
    "torch.get_num_threads", "torch.set_num_threads",
    "torch.is_tensor", "torch.no_grad", "torch.inference_mode",
}

# the port's kernel-wrapper packages: a call through a module imported
# from them launches (or runs the plain version of) a kernel
_KERNEL_PACKAGES = ("tendermint_tpu_torch.ops", "tendermint_tpu_torch.parallel")


def on_hot_path(path: str) -> bool:
    return any(f"/{d}" in f"/{path}" for d in HOT_PATH_DIRS)


def _is_allowed_sync(ctx: FileCtx, node: ast.AST) -> bool:
    qn = ctx.qualname_at(node)
    for suffix, func in ALLOWED_SYNC_FUNCS:
        if ctx.path.endswith(suffix) and qn == func:
            return True
    return False


def _kernel_aliases(tree: ast.AST) -> set:
    """Names bound in this file to a module or function of the port's
    `ops`/`parallel` packages (absolute imports, or relative ones from a
    module inside them)."""
    out: set = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name.startswith(_KERNEL_PACKAGES):
                    out.add(a.asname or a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            if node.level or mod.startswith(_KERNEL_PACKAGES) or \
                    mod in ("tendermint_tpu_torch",):
                for a in node.names:
                    if node.level or mod != "tendermint_tpu_torch" or \
                            a.name in ("ops", "parallel"):
                        out.add(a.asname or a.name)
    return out


# ---------------------------------------------------------------------------
# taint: which local names hold tensors?
# ---------------------------------------------------------------------------


# attributes and calls that read host facts about a tensor, not its value
_STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda"}
_STATIC_CALLS = {"len", "isinstance", "getattr", "hasattr", "type"}
_STATIC_METHODS = {"numel", "dim", "size", "data_ptr", "element_size",
                   "nbytes"}


def _expr_is_tensor(node: ast.AST, tainted: set, kernels: set) -> bool:
    """True when the expression plausibly produces a tensor: rooted at
    torch., a tensor-only method, a kernel wrapper, or built from a
    tainted local.  Shape, dtype, device, len() and the like are host
    facts: nothing under them counts."""
    if isinstance(node, ast.Attribute) and node.attr in _STATIC_ATTRS:
        return False
    if isinstance(node, ast.Call):
        name = call_name(node)
        root = name.split(".", 1)[0]
        if name in _STATIC_CALLS or (isinstance(node.func, ast.Attribute)
                                     and node.func.attr in _STATIC_METHODS):
            return False
        if name not in _NON_TENSOR_TORCH_CALLS and (
                root == "torch" or (root in kernels and root != name)
                or name in kernels):
            return True
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr in _TENSOR_METHODS:
            return True
    elif isinstance(node, ast.Name):
        return node.id in tainted
    elif isinstance(node, ast.Compare) and all(
            isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
        return False
    return any(_expr_is_tensor(c, tainted, kernels)
               for c in ast.iter_child_nodes(node))


def _function_taint(fn: ast.AST, kernels: set) -> set:
    """Fixpoint over simple assignments: locals assigned from tensor-ish
    expressions.  Parameters are NOT tainted (a helper taking `lanes`
    may legitimately receive numpy) — only provenance visible inside
    the function counts."""
    tainted: set = set()
    for _ in range(4):                       # small fixpoint
        grew = False
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                targets = [node.target]
            elif isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    v = item.optional_vars
                    if isinstance(v, ast.Name) and v.id not in tainted \
                            and _expr_is_tensor(item.context_expr,
                                                tainted, kernels):
                        tainted.add(v.id)
                        grew = True
                continue
            else:
                continue
            value = getattr(node, "value", None)
            if value is None or not _expr_is_tensor(value, tainted,
                                                     kernels):
                continue
            for tgt in targets:
                els = tgt.elts if isinstance(tgt, (ast.Tuple,
                                                   ast.List)) else [tgt]
                for el in els:
                    if isinstance(el, ast.Starred):
                        el = el.value
                    if isinstance(el, ast.Name) and el.id not in tainted:
                        tainted.add(el.id)
                        grew = True
        if not grew:
            break
    return tainted


def _enclosing_functions(node: ast.AST):
    cur = getattr(node, "_tmlint_parent", None)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield cur
        cur = getattr(cur, "_tmlint_parent", None)


# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------


@register
class TorchHostSyncRule(Rule):
    name = "torch-host-sync"
    description = ("implicit device->host sync on the hot path (.item(), "
                   ".tolist(), .cpu(), .numpy(), int()/float()/bool() or "
                   "an if/while on a tensor, torch.cuda.synchronize(), "
                   "Stream/Event.synchronize()) outside the allowlist of "
                   "deliberate sync points")

    def visit_file(self, ctx: FileCtx):
        if not on_hot_path(ctx.path):
            return
        kernels = _kernel_aliases(ctx.tree)
        fns = [n for n in ast.walk(ctx.tree)
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        taint_by_fn = {id(fn): _function_taint(fn, kernels) for fn in fns}
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.If, ast.While)):
                tainted = self._taint_for(node, taint_by_fn)
                if _expr_is_tensor(node.test, tainted, kernels) and \
                        not _is_allowed_sync(ctx, node):
                    yield ctx.finding(
                        self.name, node,
                        f"Python {type(node).__name__.lower()} on a "
                        f"tensor's value is an implicit bool() that "
                        f"waits for the device")
                continue
            if not isinstance(node, ast.Call):
                continue
            if isinstance(node.func, ast.Attribute):
                meth = node.func.attr
                if meth == "synchronize":
                    if not _is_allowed_sync(ctx, node):
                        what = ("torch.cuda.synchronize()"
                                if call_name(node) == "torch.cuda."
                                "synchronize" else f"{meth}() on a CUDA "
                                "stream or event")
                        yield ctx.finding(
                            self.name, node,
                            f"{what} outside the allowlist of deliberate "
                            f"sync points (ALLOWED_SYNC_FUNCS in "
                            f"analysis/hotpath.py)")
                    continue
                if meth in _SYNC_METHODS:
                    tainted = self._taint_for(node, taint_by_fn)
                    if _expr_is_tensor(node.func.value, tainted, kernels) \
                            and not _is_allowed_sync(ctx, node):
                        yield ctx.finding(
                            self.name, node,
                            f".{meth}() of a tensor forces a "
                            f"device->host sync; keep the value on the "
                            f"device or move the read to a deliberate "
                            f"sync point")
                    continue
            name = call_name(node)
            if name not in _HOST_CASTS or not node.args:
                continue
            tainted = self._taint_for(node, taint_by_fn)
            if _expr_is_tensor(node.args[0], tainted, kernels) and \
                    not _is_allowed_sync(ctx, node):
                yield ctx.finding(
                    self.name, node,
                    f"{name}() on a tensor forces a device->host sync on "
                    f"the hot path")

    @staticmethod
    def _taint_for(node, taint_by_fn) -> set:
        """Tensor locals visible at `node`: its function's and those of
        every function enclosing it (a closure reads them)."""
        out: set = set()
        for fn in _enclosing_functions(node):
            out |= taint_by_fn.get(id(fn), set())
        return out


# calls whose result is padded to a power-of-two bucket: the helpers
# themselves and the backend methods built on them
_BUCKETING_CALLS = {"_bucket", "_pad_rows", "_templates", "templated_args",
                    "sign_args", "prefetch_grouped_lanes", "tables"}


def _bucketed_names(fn: ast.AST) -> set:
    """Locals whose value comes (flow-insensitively) from a bucketing
    call, directly or through another such local."""
    out: set = set()

    def bucketed(expr) -> bool:
        for n in ast.walk(expr):
            if isinstance(n, ast.Call) and \
                    call_name(n).rsplit(".", 1)[-1] in _BUCKETING_CALLS:
                return True
            if isinstance(n, ast.Name) and n.id in out:
                return True
        return False

    for _ in range(4):
        grew = False
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign):
                targets, value = node.targets, node.value
            elif isinstance(node, (ast.For, ast.comprehension)):
                targets, value = [node.target], node.iter
            else:
                continue
            if not bucketed(value):
                continue
            for tgt in targets:
                els = tgt.elts if isinstance(tgt, (ast.Tuple,
                                                   ast.List)) else [tgt]
                for el in els:
                    if isinstance(el, ast.Starred):
                        el = el.value
                    if isinstance(el, ast.Name) and el.id not in out:
                        out.add(el.id)
                        grew = True
        if not grew:
            break
    return out


@register
class TorchLaunchBucketRule(Rule):
    name = "torch-launch-bucket"
    description = ("a launch signature recorded by _note_dispatch from an "
                   "array not padded to a bucket (every batch size a new "
                   "signature, counted as a recompile)")

    def visit_file(self, ctx: FileCtx):
        if not on_hot_path(ctx.path):
            return
        for fn in ast.walk(ctx.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            calls = [n for n in ast.walk(fn) if isinstance(n, ast.Call)
                     and call_name(n).rsplit(".", 1)[-1] == "_note_dispatch"
                     and next(_enclosing_functions(n), None) is fn]
            if not calls:
                continue
            ok = _bucketed_names(fn)
            for call in calls:
                entry = (call.args[0].value if call.args and isinstance(
                    call.args[0], ast.Constant) else "<entry>")
                for arg in call.args[1:]:
                    base = arg.value if isinstance(arg, ast.Starred) \
                        else arg
                    while isinstance(base, (ast.Subscript, ast.Attribute)):
                        base = base.value
                    if isinstance(base, ast.Name) and base.id in ok:
                        continue
                    if isinstance(base, ast.Call) and call_name(
                            base).rsplit(".", 1)[-1] in _BUCKETING_CALLS:
                        continue
                    yield ctx.finding(
                        self.name, arg,
                        f"launch signature of '{entry}' takes "
                        f"'{ast.unparse(arg)}', which is not padded to a "
                        f"bucket (_bucket/_pad_rows): every new size is "
                        f"a new signature, counted as a recompile")


@register
class BenchScalarLoopRule(Rule):
    """The replay pipeline's host stages (bench.prep / bench.apply spans)
    overlap the device stage only while they hold the GIL briefly — a
    per-item Python loop inside one turns the stage back into the scalar
    tail the vectorization removed (window_commit_lanes / apply_window).
    Statement loops only: comprehensions and numpy/executor calls are the
    sanctioned idiom."""

    name = "bench-scalar-loop"
    description = ("per-item Python for/while inside a prep/apply-"
                   "categorized bench.* tracing span; vectorize the "
                   "window (window_commit_lanes, execution.apply_window) "
                   "instead")

    def visit_file(self, ctx: FileCtx):
        # deliberately NOT hot-path-dir-gated: the spans live in bench.py
        from tendermint_tpu_torch.utils.tracing import (CAT_APPLY, CAT_PREP,
                                                        default_category)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.With):
                continue
            span_name = self._span_name(node)
            if span_name is None or not span_name.startswith("bench."):
                continue
            if default_category(span_name) not in (CAT_PREP, CAT_APPLY):
                continue
            for loop in self._stmt_loops(node.body):
                yield ctx.finding(
                    self.name, loop,
                    f"per-item {type(loop).__name__.lower()} loop inside "
                    f"the {span_name!r} span serializes a pipeline host "
                    f"stage under the GIL; assemble the window in one "
                    f"vectorized pass (window_commit_lanes / "
                    f"execution.apply_window)")

    @staticmethod
    def _span_name(node: ast.With):
        """The string-constant name of a tracing span opened by this
        `with`, or None (dynamic names can't be categorized statically)."""
        for item in node.items:
            call = item.context_expr
            if not isinstance(call, ast.Call) or not call.args:
                continue
            fn = call.func
            if not ((isinstance(fn, ast.Name) and fn.id == "span")
                    or (isinstance(fn, ast.Attribute)
                        and fn.attr == "span")):
                continue
            arg0 = call.args[0]
            if isinstance(arg0, ast.Constant) and isinstance(arg0.value,
                                                             str):
                return arg0.value
        return None

    @staticmethod
    def _stmt_loops(stmts):
        """Outermost statement-level loops under `stmts`, not descending
        into nested function/lambda definitions (a helper DEFINED inside
        the span body runs elsewhere)."""
        out, stack = [], list(stmts)
        while stack:
            n = stack.pop()
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
                continue
            if isinstance(n, (ast.For, ast.AsyncFor, ast.While)):
                out.append(n)
                continue
            stack.extend(ast.iter_child_nodes(n))
        return sorted(out, key=lambda n: n.lineno)
