"""AST purity and determinism lint over the port's tick and launch path
(the JAX package's `analysis/lint.py`, with the port's rules).

The port's bit-identity with the JAX package, and a launch path that
never stalls the card on the host, rest on four source-level properties
of the modules in `DEFAULT_TARGETS`:

1. **Tagged randomness only** (`untagged-randomness`): every draw is a
   counter-based `utils.rng` / `utils.trng` TAG_* hash. A `torch.rand*`
   / `randint` / `randperm` / `bernoulli` / `multinomial` / `normal_` /
   `uniform_` draw, a `torch.Generator`, or any use of `random`,
   `np.random`, `secrets`, `uuid` or `os.urandom` is hidden state. The
   CUDA sources (`csrc/*.cu`) may not call `curand` or `rand(`.
2. **No host sync on a tensor's value** (`host-sync`, in place of the
   JAX package's traced-branch rule): an `if` / `while` / `assert` /
   conditional expression on a tensor, `bool()` / `int()` / `float()`
   of a tensor, `.item()` and `.tolist()` all wait for the card. A
   deliberate sync carries `# sync-ok` and its reason on its line (for
   example `kernel.check_ring_overflow`, which runs only in `kfinish`).
3. **The client workload transition is elementwise**
   (`non-elementwise-workload`): `client_update` and `submit_payloads`
   use no torch op that couples lanes (reductions, reshapes, gathers),
   so the one implementation serves every layout.
4. **No untagged widening of a State leaf** (`untagged-widening`) in
   `step.py`, `kernel.py` and `workload.py`: a leaf cast by
   `.to(torch.int32)` / `.to(I32)` / `.int()` / `.long()` re-declares a
   resident dtype that the narrow dials make a layout contract; a
   deliberate boundary cast carries `# widen-ok` and its reason. The
   three u32 digests, which the port holds as int64, are the documented
   exception: their casts are the wire boundary.

Tensor-ness is a small forward dataflow, seeded by annotations
(`State`, `Tensor`, ...), by `torch.*` and `trng.*` calls, and by a short
list of conventional parameter names. It can miss a sync on an
unannotated helper's result, but every rule is zero-noise on the real
modules (tests/test_torch_analysis.py), so a finding is worth reading.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Iterable

# The port's counterparts of the JAX package's lint surface.
DEFAULT_TARGETS = ("sim/step.py", "sim/kernel.py", "clients/workload.py",
                   "utils/trng.py", "nemesis/program.py",
                   "nemesis/search.py", "parallel/cohort.py",
                   "parallel/stream_sched.py", "parallel/kmesh.py",
                   "ops/quorum.py")
CUDA_TARGETS = ("csrc/fused_chunk.cu", "csrc/wire_codec.cu")

SYNC_TAG = "sync-ok"
WIDEN_TAG = "widen-ok"

# Annotations that make a parameter a tensor (or a tree of them).
ARRAY_TYPES = {"PerNode", "Mailbox", "State", "ClientState", "Metrics",
               "Flight", "Tensor", "GlobalMetrics", "GlobalKMetrics"}

# Conventional tensor-valued parameter names in the tick modules.
TENSOR_PARAM_NAMES = {"ns", "st", "nodes", "mailbox", "inbox", "outbox",
                      "ib", "met", "fl", "state", "clients", "alive_prev",
                      "alive_now", "wire", "acc", "leaves", "packed"}

# Attribute reads that are host values even on a tensor.
STATIC_ATTRS = {"shape", "dtype", "ndim", "device", "_fields", "is_cuda",
                "numel", "dim", "size", "element_size", "stride",
                "data_ptr", "is_pinned", "nbytes", "names", "is_contiguous",
                "is_floating_point", "storage_offset"}

# `torch.<name>` calls that return no tensor.
TORCH_HOST = {"device", "dtype", "cuda", "Size", "is_tensor", "no_grad",
              "inference_mode", "get_default_dtype", "iinfo", "finfo",
              "manual_seed", "Generator", "stack_trace"}
_TENSOR_ROOTS = ("torch", "trng")

# Draws a tagged hash must replace.
TORCH_DRAWS = {"rand", "rand_like", "randn", "randn_like", "randint",
               "randint_like", "randperm", "bernoulli", "multinomial",
               "normal", "poisson", "normal_", "uniform_", "exponential_",
               "geometric_", "cauchy_", "log_normal_", "random_",
               "bernoulli_", "Generator"}
FORBIDDEN_MODULES = {"random", "secrets", "uuid"}
FORBIDDEN_ATTR_CHAINS = (("np", "random"), ("numpy", "random"),
                         ("os", "urandom"), ("torch", "random"))
CUDA_DRAW = re.compile(r"\bcurand\w*|(?<![\w.])rand\s*\(")

# torch ops the workload transition may call: lane-local only.
ELEMENTWISE_TORCH = {
    "where", "minimum", "maximum", "abs", "clamp", "clip", "sign",
    "remainder", "fmod", "eq", "ne", "gt", "lt", "ge", "le",
    "logical_and", "logical_or", "logical_not", "logical_xor",
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
    "bitwise_left_shift", "bitwise_right_shift", "add", "sub", "mul",
    "floor_divide", "neg", "zeros_like", "ones_like", "full_like",
    "as_tensor", "tensor", "int32", "int64", "bool",
}
LANE_COUPLING = {"sum", "max", "min", "mean", "prod", "amax", "amin",
                 "reshape", "view", "transpose", "permute", "flatten",
                 "ravel", "cumsum", "cumprod", "sort", "argsort", "argmax",
                 "argmin", "gather", "scatter", "scatter_add",
                 "index_select", "take", "take_along_dim", "roll", "any",
                 "all", "flip", "unfold", "matmul", "dot", "einsum",
                 "nonzero", "unique", "squeeze", "unsqueeze", "expand",
                 "repeat", "cat", "stack"}
WORKLOAD_FNS = ("client_update", "submit_payloads")

WIDENING_TARGETS = ("step.py", "kernel.py", "workload.py")
_WIDE_DTYPES = {"I32", "I64", "int32", "int64", "int", "long"}
_DIGESTS = {"digest", "snap_digest", "is_req_snap_digest"}


@dataclasses.dataclass
class Finding:
    path: str
    line: int
    rule: str
    message: str

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


def _attr_chain(node) -> tuple:
    """('torch', 'cuda', 'Stream') for torch.cuda.Stream; () if the
    expression is not a plain dotted name."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return ()


def _is_tensor_call(node: ast.Call) -> bool:
    chain = _attr_chain(node.func)
    return (len(chain) >= 2 and chain[0] in _TENSOR_ROOTS
            and chain[1] not in TORCH_HOST)


def _tensor_fns(tree) -> set:
    """Module-level functions annotated to return a tensor: a call of
    one yields a tensor like a torch call does."""
    out = set()
    for fn in getattr(tree, "body", []):
        if isinstance(fn, ast.FunctionDef) and fn.returns is not None:
            names = {n.id for n in ast.walk(fn.returns)
                     if isinstance(n, ast.Name)}
            names |= {n.attr for n in ast.walk(fn.returns)
                      if isinstance(n, ast.Attribute)}
            if names & ARRAY_TYPES:
                out.add(fn.name)
    return out


class _TensorScope:
    """Forward dataflow of tensor-ness through one function body."""

    def __init__(self, fn: ast.FunctionDef, inherited: set,
                 tensor_fns: set = frozenset()):
        self.tensors = set(inherited)
        self.tensor_fns = tensor_fns
        for arg in list(fn.args.args) + list(fn.args.kwonlyargs):
            ann = arg.annotation
            names = set()
            if isinstance(ann, (ast.Name, ast.Attribute)):
                chain = _attr_chain(ann)
                if chain:
                    names.add(chain[-1])
            elif isinstance(ann, ast.BinOp):      # `State | None`
                names.update(n.id for n in ast.walk(ann)
                             if isinstance(n, ast.Name))
                names.update(n.attr for n in ast.walk(ann)
                             if isinstance(n, ast.Attribute))
            elif isinstance(ann, ast.Constant) and isinstance(ann.value,
                                                              str):
                names.update(ann.value.replace("|", " ").split())
            if names & ARRAY_TYPES or arg.arg in TENSOR_PARAM_NAMES:
                self.tensors.add(arg.arg)

    def is_tensor(self, node) -> bool:
        """Does `node` (an expression) hold a tensor's value, after the
        host exemptions (`.shape`/`.dtype`/..., `is` compares, constants,
        calls of unknown helpers)?"""
        if node is None or isinstance(node, ast.Constant):
            return False
        if isinstance(node, ast.Name):
            return node.id in self.tensors
        if isinstance(node, ast.Attribute):
            if node.attr in STATIC_ATTRS:
                return False
            return self.is_tensor(node.value)
        if isinstance(node, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for op in node.ops):
                return False
            return (self.is_tensor(node.left)
                    or any(self.is_tensor(c) for c in node.comparators))
        if isinstance(node, ast.Call):
            if _is_tensor_call(node) or (isinstance(node.func, ast.Name)
                                         and node.func.id in self.tensor_fns):
                return True
            # A call yields a tensor iff its callee is a tensor method
            # (or rooted at torch/trng, above); argument tensor-ness
            # does not flow through unknown helpers, which routinely
            # take tensors and return host values.
            return self.is_tensor(node.func)
        if isinstance(node, ast.Subscript):
            return self.is_tensor(node.value)
        if isinstance(node, ast.BoolOp):
            return any(self.is_tensor(v) for v in node.values)
        if isinstance(node, ast.BinOp):
            return self.is_tensor(node.left) or self.is_tensor(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.is_tensor(node.operand)
        if isinstance(node, ast.IfExp):
            return (self.is_tensor(node.test) or self.is_tensor(node.body)
                    or self.is_tensor(node.orelse))
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            return any(self.is_tensor(e) for e in node.elts)
        if isinstance(node, ast.Starred):
            return self.is_tensor(node.value)
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
            return self.is_tensor(node.elt)
        return False

    def _mark(self, target):
        if isinstance(target, ast.Name):
            self.tensors.add(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                self._mark(e)
        elif isinstance(target, ast.Starred):
            self._mark(target.value)

    def propagate(self, body: Iterable[ast.stmt]):
        """Two passes, so a use before a later assignment inside a loop
        still converges for this flat propagation."""
        for _ in range(2):
            for stmt in ast.walk(ast.Module(body=list(body),
                                            type_ignores=[])):
                if isinstance(stmt, ast.Assign):
                    if self.is_tensor(stmt.value):
                        for t in stmt.targets:
                            self._mark(t)
                elif isinstance(stmt, ast.AugAssign):
                    if self.is_tensor(stmt.value):
                        self._mark(stmt.target)
                elif isinstance(stmt, ast.AnnAssign) and stmt.value:
                    if self.is_tensor(stmt.value):
                        self._mark(stmt.target)
                elif isinstance(stmt, (ast.For, ast.comprehension)):
                    self._mark_loop(stmt.target, stmt.iter)

    def _mark_loop(self, target, it):
        """A loop over a literal of tuples marks, position by position,
        the targets some row puts a tensor in; any other tensor iterable
        marks the whole target."""
        rows = getattr(it, "elts", None) if isinstance(
            it, (ast.Tuple, ast.List)) else None
        if rows and isinstance(target, ast.Tuple) and all(
                isinstance(r, ast.Tuple) and len(r.elts) == len(target.elts)
                for r in rows):
            for i, t in enumerate(target.elts):
                if any(self.is_tensor(r.elts[i]) for r in rows):
                    self._mark(t)
        elif self.is_tensor(it):
            self._mark(target)


def _own_nodes(fn):
    """(fn's own nodes, its nested functions): a nested function is
    visited once, with the enclosing scope inherited."""
    own, nested, stack = [], [], list(fn.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            nested.append(node)
            continue
        own.append(node)
        stack.extend(ast.iter_child_nodes(node))
    return own, nested


def _functions(tree):
    """Module-level functions (classes are host-side mirrors, exempt
    from the value rules as the JAX package's lint exempts them)."""
    return [n for n in getattr(tree, "body", [])
            if isinstance(n, ast.FunctionDef)]


def _lint_randomness(tree: ast.AST, path: str) -> list[Finding]:
    out, seen = [], set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name.split(".")[0] in FORBIDDEN_MODULES \
                        or alias.name in ("numpy.random", "torch.random"):
                    out.append(Finding(
                        path, node.lineno, "untagged-randomness",
                        f"import of {alias.name!r} — every draw must be "
                        f"a utils.rng/trng TAG_* hash"))
        elif isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            if mod.split(".")[0] in FORBIDDEN_MODULES \
                    or mod in ("numpy.random", "torch.random") \
                    or (mod in ("numpy", "torch") and any(
                        a.name == "random" for a in node.names)):
                out.append(Finding(path, node.lineno, "untagged-randomness",
                                   f"import from {mod!r}"))
        elif isinstance(node, ast.Attribute):
            chain = _attr_chain(node)
            bad = None
            for ban in FORBIDDEN_ATTR_CHAINS:
                if chain[:len(ban)] == ban:
                    bad = ".".join(ban)
            if chain and chain[0] == "torch" and len(chain) == 2 \
                    and chain[1] in TORCH_DRAWS:
                bad = ".".join(chain)
            if bad is None and node.attr in TORCH_DRAWS \
                    and node.attr.endswith("_"):
                bad = f".{node.attr}()"   # an in-place draw on a tensor
            if bad is not None and (node.lineno, bad) not in seen:
                seen.add((node.lineno, bad))
                out.append(Finding(
                    path, node.lineno, "untagged-randomness",
                    f"use of {bad} — every draw must be a pure "
                    f"(seed, TAG_*, coords) hash via utils.rng/trng"))
    return out


def _tagged(src_lines: list, lineno: int, tag: str) -> bool:
    return 0 < lineno <= len(src_lines) and tag in src_lines[lineno - 1]


def _lint_host_sync(tree: ast.AST, path: str,
                    src_lines: list) -> list[Finding]:
    out = []
    fns = _tensor_fns(tree)

    def visit(fn, inherited: set):
        scope = _TensorScope(fn, inherited, fns)
        scope.propagate(fn.body)
        own, nested = _own_nodes(fn)
        for node in own:
            what = None
            if isinstance(node, (ast.If, ast.While)) \
                    and scope.is_tensor(node.test):
                what = f"Python-level {type(node).__name__.lower()} on a " \
                       f"tensor"
            elif isinstance(node, ast.IfExp) and scope.is_tensor(node.test):
                what = "conditional expression on a tensor"
            elif isinstance(node, ast.Assert) and scope.is_tensor(node.test):
                what = "assert on a tensor"
            elif isinstance(node, ast.Call):
                chain = _attr_chain(node.func)
                if len(chain) == 1 and chain[0] in ("bool", "int", "float") \
                        and any(scope.is_tensor(a) for a in node.args):
                    what = f"host {chain[0]}() of a tensor"
                elif isinstance(node.func, ast.Attribute) \
                        and node.func.attr in ("item", "tolist") \
                        and scope.is_tensor(node.func.value):
                    what = f".{node.func.attr}() of a tensor"
            if what and not _tagged(src_lines, node.lineno, SYNC_TAG):
                out.append(Finding(
                    path, node.lineno, "host-sync",
                    f"{what} in {fn.name}() waits for the card — keep "
                    f"values on the device, or tag a deliberate sync "
                    f"`# {SYNC_TAG}: <reason>`"))
        for sub in nested:
            visit(sub, scope.tensors)

    for fn in _functions(tree):
        visit(fn, set())
    return out


def _lint_workload_elementwise(tree: ast.AST, path: str) -> list[Finding]:
    out = []
    for node in _functions(tree):
        if node.name not in WORKLOAD_FNS:
            continue
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Call):
                continue
            chain = _attr_chain(sub.func)
            bad = None
            if len(chain) == 2 and chain[0] == "torch" \
                    and chain[1] not in ELEMENTWISE_TORCH:
                bad = f"torch.{chain[1]} is not in the elementwise allowlist"
            elif isinstance(sub.func, ast.Attribute) \
                    and sub.func.attr in LANE_COUPLING:
                bad = f"method .{sub.func.attr}() couples lanes"
            if bad is None and any(k.arg in ("dim", "axis")
                                   for k in sub.keywords):
                bad = (f"{'.'.join(chain) or ast.unparse(sub.func)} with "
                       f"a dim= argument reduces over an axis")
            if bad:
                out.append(Finding(
                    path, sub.lineno, "non-elementwise-workload",
                    f"{bad} inside {node.name}() — the client transition "
                    f"must stay elementwise, so one implementation "
                    f"serves every layout"))
    return out


def _is_leaf_chain(scope: _TensorScope, node) -> bool:
    """A State leaf read: an Attribute/Subscript chain of at least one
    link, none of them a static attribute, rooted at a tensor name —
    `ns.term`, `st.nodes.commit`. A call or an operator in the chain
    makes a derived value, not a leaf."""
    links = 0
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        if isinstance(node, ast.Attribute) and node.attr in STATIC_ATTRS:
            return False
        links += 1
        node = node.value
    return links > 0 and isinstance(node, ast.Name) \
        and node.id in scope.tensors


def _leaf_name(node) -> str:
    while isinstance(node, ast.Subscript):
        node = node.value
    return node.attr if isinstance(node, ast.Attribute) else ""


def _widening(node: ast.Call):
    """(the cast's operand, how) when `node` casts to a wide integer:
    `x.to(torch.int32)` / `x.to(I32)` / `x.int()` / `x.long()`."""
    if not isinstance(node.func, ast.Attribute):
        return None
    f = node.func
    if f.attr in ("int", "long") and not node.args:
        return f.value, f".{f.attr}()"
    if f.attr == "to" and node.args:
        chain = _attr_chain(node.args[0])
        if chain and chain[-1] in _WIDE_DTYPES:
            return f.value, f".to({'.'.join(chain)})"
    return None


def _lint_untagged_widening(tree: ast.AST, path: str,
                            src_lines: list) -> list[Finding]:
    out = []
    fns = _tensor_fns(tree)

    def visit(fn, inherited: set):
        scope = _TensorScope(fn, inherited, fns)
        scope.propagate(fn.body)
        own, nested = _own_nodes(fn)
        for node in own:
            if not isinstance(node, ast.Call):
                continue
            hit = _widening(node)
            if hit is None or not _is_leaf_chain(scope, hit[0]):
                continue
            if _leaf_name(hit[0]) in _DIGESTS:
                continue   # int64-held u32 digests: the documented cast
            if not _tagged(src_lines, node.lineno, WIDEN_TAG):
                leaf = ast.unparse(hit[0])
                out.append(Finding(
                    path, node.lineno, "untagged-widening",
                    f"{leaf}{hit[1]} in {fn.name}() re-declares a State "
                    f"leaf's dtype in the tick — under the narrow dials "
                    f"(config.NARROW_FIELDS) leaf dtypes are a layout "
                    f"contract; tag a deliberate boundary "
                    f"`# {WIDEN_TAG}: <reason>`"))
        for sub in nested:
            visit(sub, scope.tensors)

    for fn in _functions(tree):
        visit(fn, set())
    return out


def lint_source(src: str, path: str) -> list[Finding]:
    """Every rule over one Python source; the file's name picks the
    widening rule (step.py, kernel.py, workload.py) and the workload
    rule (workload.py)."""
    tree = ast.parse(src, filename=path)
    lines = src.splitlines()
    base = os.path.basename(path)
    out = _lint_randomness(tree, path)
    out += _lint_host_sync(tree, path, lines)
    if base in WIDENING_TARGETS:
        out += _lint_untagged_widening(tree, path, lines)
    if base == "workload.py":
        out += _lint_workload_elementwise(tree, path)
    return sorted(out, key=lambda f: (f.line, f.rule))


def lint_file(path: str) -> list[Finding]:
    """`lint_source` of a Python file, or the draw rule over a CUDA
    source (`.cu`)."""
    with open(path, "r", encoding="utf-8") as f:
        src = f.read()
    if path.endswith(".cu"):
        return lint_cuda(src, path)
    return lint_source(src, path)


def lint_cuda(src: str, path: str) -> list[Finding]:
    """The tagged-randomness rule over a CUDA source: no cuRAND, no
    `rand(`; comments are skipped."""
    out = []
    for i, line in enumerate(src.splitlines(), 1):
        code = line.split("//", 1)[0]
        m = CUDA_DRAW.search(code)
        if m:
            out.append(Finding(
                path, i, "untagged-randomness",
                f"{m.group(0).strip()} in a kernel — every draw must be "
                f"the counter-based hash the plain tick makes"))
    return out


def lint_default() -> list[Finding]:
    """Lint the port's contract surface: `DEFAULT_TARGETS` and the CUDA
    sources, resolved relative to the installed package."""
    import raft_tpu_torch
    root = os.path.dirname(os.path.abspath(raft_tpu_torch.__file__))
    out = []
    for rel in DEFAULT_TARGETS + CUDA_TARGETS:
        out += lint_file(os.path.join(root, rel))
    return out
