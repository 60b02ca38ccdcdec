"""reprolint for the port: walk the linted tree, run the rules,
apply suppressions and the baseline.

Port of ``repro/analysis/linter.py``.  The linted surface is what ships
the port's behaviour -- ``src/repro_torch`` and ``chip_smoke.py`` -- but
not ``tests/`` (tests poke the failure modes the rules exist to flag).
The port keeps its own baseline, :data:`BASELINE_PATH`; the reference's
``analysis_baseline.json`` at the repository's root is the reference's
and is never written from here.
"""
from __future__ import annotations

import ast
import pathlib

from . import findings as F
from .rules import RULES, FileContext

DEFAULT_PATHS = ("src/repro_torch", "chip_smoke.py")
BASELINE_PATH = pathlib.Path(__file__).resolve().parent / "baseline.json"


def repo_root() -> pathlib.Path:
    """The repository root: three levels up from this package
    (src/repro_torch/analysis -> repo)."""
    return pathlib.Path(__file__).resolve().parents[3]


def iter_py_files(paths, root: pathlib.Path):
    for p in paths:
        p = (root / p) if not pathlib.Path(p).is_absolute() \
            else pathlib.Path(p)
        if p.is_file() and p.suffix == ".py":
            yield p
        elif p.is_dir():
            yield from sorted(p.rglob("*.py"))


def lint_source(source: str, path: str,
                rules=None) -> list[F.Finding]:
    """Lint one source string; ``path`` is the repo-relative label.
    Suppression comments apply; the baseline does not (caller's job)."""
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [F.Finding(rule="parse-error", path=path,
                          line=e.lineno or 1, col=e.offset or 1,
                          message=f"syntax error: {e.msg}")]
    lines = source.splitlines()
    ctx = FileContext(path=path, source_lines=lines, tree=tree)
    supp = F.suppressions(lines)
    out: list[F.Finding] = []
    for rule in (rules or RULES.values()):
        for f in rule.check(ctx):
            if not F.is_suppressed(f, supp):
                out.append(f)
    out.sort(key=lambda f: (f.line, f.col, f.rule))
    return out


def lint_paths(paths=DEFAULT_PATHS, root=None,
               rules=None) -> list[F.Finding]:
    root = pathlib.Path(root) if root else repo_root()
    selected = None
    if rules:
        selected = [RULES[name] for name in rules]
    out: list[F.Finding] = []
    for file in iter_py_files(paths, root):
        rel = file.relative_to(root).as_posix() \
            if file.is_relative_to(root) else file.as_posix()
        out.extend(lint_source(file.read_text(), rel, rules=selected))
    return out


def apply_baseline(found: list[F.Finding], baseline_path=None):
    """Returns (new_findings, grandfathered, baseline_dict) against the
    port's baseline, or the file at ``baseline_path``."""
    baseline = F.load_baseline(baseline_path or BASELINE_PATH)
    new, old = F.split_baselined(found, baseline)
    return new, old, baseline
