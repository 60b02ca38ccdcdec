"""reprolint rules for the port: AST checks of the failure modes that have
a meaning in PyTorch.

Port of ``repro/analysis/rules.py``, with the two of its five rules that
mean something without a tracer:

``host-sync``       ``.item()`` / ``.tolist()`` / ``.cpu()`` / ``.numpy()``
                    / ``float()`` / ``int()`` / ``bool()`` /
                    ``np.asarray()`` / ``np.array()`` on device values, and
                    ``torch.cuda.synchronize()``, inside the serving tick's
                    hot zones
``kernel-wrapper``  a kernel module (or the build module) imported anywhere
                    but ``kernels/`` (the wrapper ``kernels/ops.py`` owns the
                    dispatch by device and the input checks)

The reference's other three rules read JAX's semantics and have no twin
(:data:`JAX_ONLY`): ``key-reuse`` (torch draws from stateful generators,
so there is no key to consume twice), ``jit-branch`` (there is no tracer:
a Python branch on a tensor is an ordinary host read, which
``host-sync`` covers in the hot zones) and ``recompile-hazard`` (the port
compiles nothing at run time; ``analysis.retrace`` bounds what it does
build).  Nor has ``host-sync`` the reference's automatic zone, a loop that
dispatches to a jit-bound callable: the port has no jit.

All rules share one :class:`FileContext` that resolves import aliases
(``import torch.nn.functional as F`` -> ``torch.nn.functional.*``), so
matching is on canonical dotted names.
"""
from __future__ import annotations

import ast
import dataclasses

from .findings import Finding

# the reference's rules without a twin, and why
JAX_ONLY = {
    "key-reuse": "torch draws from stateful generators: there is no PRNG "
                 "key to consume twice",
    "jit-branch": "the port traces nothing: a Python branch on a tensor is "
                  "a host read (host-sync covers the hot zones)",
    "recompile-hazard": "the port compiles nothing at run time "
                        "(analysis.retrace bounds what it builds)",
}

# ---------------------------------------------------------------------------
# shared per-file context
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FileContext:
    path: str                       # repo-relative, posix
    source_lines: list[str]
    tree: ast.Module
    aliases: dict[str, str] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self.aliases = _collect_aliases(self.tree)

    def snippet(self, line: int) -> str:
        if 1 <= line <= len(self.source_lines):
            return self.source_lines[line - 1].strip()
        return ""

    def finding(self, rule: str, node: ast.AST, message: str) -> Finding:
        line = getattr(node, "lineno", 1)
        return Finding(rule=rule, path=self.path, line=line,
                       col=getattr(node, "col_offset", 0) + 1,
                       message=message, snippet=self.snippet(line))

    def dotted(self, node) -> str | None:
        """Canonical dotted name of an expression, alias-resolved
        (``F.softmax`` -> ``torch.nn.functional.softmax``), or None."""
        parts = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        parts.append(self.aliases.get(node.id, node.id))
        return ".".join(reversed(parts))


def _collect_aliases(tree: ast.Module) -> dict[str, str]:
    aliases: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                aliases[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                aliases[a.asname or a.name] = f"{node.module}.{a.name}"
    return aliases


def _func_defs(tree: ast.Module):
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


# ---------------------------------------------------------------------------
# rule: host-sync
# ---------------------------------------------------------------------------

# (path-suffix, function names): the serving tick and admission path, where
# one stray device->host read serializes every slot's decode step, and the
# telemetry read sites, which run inside sampled ticks of the same loop and
# must read only host state the engine already holds.  The reference's
# zones, in the port's files.
HOT_ZONES = (
    ("serving/engine.py", ("_step_continuous", "_step_sync",
                           "_admit_continuous", "_admit_sync",
                           "_solo_prefill", "_grow_blocks", "step")),
    ("obs/enginehooks.py", ("on_prefill", "on_decode_tick", "sample")),
)

_SYNC_WRAPPERS = ("float", "int", "bool", "numpy.asarray", "numpy.array")
_SYNC_METHODS = ("item", "tolist", "cpu", "numpy")
_ALWAYS_SYNC = ("torch.cuda.synchronize",)


def _device_producer(callee: str) -> bool:
    """A call whose result lives on the device: a ``torch.*`` function, or
    an entry point of the port's models or of ``kernels.ops``."""
    parts = callee.split(".")
    return (parts[0] == "torch" or "models" in parts[:-1]
            or ("kernels" in parts[:-1] and "ops" in parts[:-1]))


class HostSyncRule:
    name = "host-sync"
    description = (".item()/.cpu()/float()/np.asarray() on device values "
                   "inside the serving tick's hot zones")

    def _hot_functions(self, ctx: FileContext):
        for suffix, names in HOT_ZONES:
            if ctx.path.endswith(suffix):
                for fn in _func_defs(ctx.tree):
                    if fn.name in names:
                        yield fn, f"hot zone {suffix}:{fn.name}"

    def _device_expr(self, ctx, expr, tainted: set[str]) -> bool:
        for node in ast.walk(expr):
            if isinstance(node, ast.Name) and node.id in tainted:
                return True
            if isinstance(node, ast.Call):
                callee = ctx.dotted(node.func)
                if callee and _device_producer(callee):
                    return True
        return False

    def check(self, ctx: FileContext) -> list[Finding]:
        findings: list[Finding] = []
        reported: set[int] = set()
        for zone, where in self._hot_functions(ctx):
            tainted: set[str] = set()
            for node in ast.walk(zone):
                # taint: names assigned from torch ops / model dispatch
                if isinstance(node, ast.Assign):
                    is_dev = self._device_expr(ctx, node.value, tainted)
                    is_sync = self._sync_call(ctx, node.value, tainted)
                    for tgt in node.targets:
                        names = [tgt] if isinstance(tgt, ast.Name) else [
                            e for e in getattr(tgt, "elts", [])
                            if isinstance(e, ast.Name)]
                        for n in names:
                            if is_dev and not is_sync:
                                tainted.add(n.id)
                            else:
                                tainted.discard(n.id)
                if isinstance(node, ast.Call) and node.lineno not in reported:
                    if self._sync_call(ctx, node, tainted):
                        reported.add(node.lineno)
                        findings.append(ctx.finding(
                            self.name, node,
                            f"host-device sync "
                            f"('{ctx.snippet(node.lineno)[:48]}') inside "
                            f"{where}: forces the device queue to drain "
                            f"every tick"))
        return findings

    def _sync_call(self, ctx, expr, tainted) -> bool:
        """Is ``expr`` (or its outermost call) a blocking host read of a
        device value?"""
        if not isinstance(expr, ast.Call):
            return False
        func = expr.func
        callee = ctx.dotted(func)
        if callee in _ALWAYS_SYNC:
            return True
        if isinstance(func, ast.Attribute) and func.attr in _SYNC_METHODS:
            return self._device_expr(ctx, func.value, tainted)
        if callee in _SYNC_WRAPPERS and expr.args:
            return self._device_expr(ctx, expr.args[0], tainted)
        return False


# ---------------------------------------------------------------------------
# rule: kernel-wrapper
# ---------------------------------------------------------------------------

_KERNEL_MODULES = ("flash_attention", "decode_attention", "ssd_scan",
                   "rglru_scan", "partition_sweep", "_build")
# files that hold each kernel against its plain version, and so import the
# kernel modules on purpose: the smoke run on the card
_EXEMPT = ("chip_smoke.py",)


class KernelWrapperRule:
    name = "kernel-wrapper"
    description = ("kernels are reached through kernels/ops.py (it owns the "
                   "dispatch by device and the input checks); a kernel or "
                   "build module imported elsewhere is flagged")

    def check(self, ctx: FileContext) -> list[Finding]:
        if "kernels/" in ctx.path or ctx.path.endswith(_EXEMPT):
            return []
        findings = []
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                # ``from ..kernels import flash_attention`` names the
                # module among the imported names
                mods = [node.module] + [
                    f"{node.module}.{a.name}" for a in node.names
                    if node.module.rsplit(".", 1)[-1] == "kernels"]
            else:
                continue
            for mod in mods:
                parts = mod.split(".")
                tail = parts[-1]
                # a relative import of a kernel's name counts, as in the
                # reference's rule
                if tail in _KERNEL_MODULES and (
                        "kernels" in parts[:-1]
                        or len(parts) == 1 and node.level > 0):
                    findings.append(ctx.finding(
                        self.name, node,
                        f"kernel module '{tail}' imported directly: reach "
                        f"it through repro_torch.kernels.ops, which "
                        f"dispatches by device and checks the inputs"))
                    break
        return findings


RULES = {r.name: r for r in (HostSyncRule(), KernelWrapperRule())}
