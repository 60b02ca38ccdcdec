"""Port parity: the analysis layer's findings, rules, baseline and CLI
(``repro_torch.analysis.{findings,rules,linter,__main__}``).

Findings fingerprint, render and parse suppressions exactly as the
reference's do, on a table of lines; the port's baseline loader reads the
reference's ``analysis_baseline.json`` as the reference does (read only).
The two rules with a torch meaning, ``host-sync`` and ``kernel-wrapper``,
flag their positive fixtures and pass their suppressed and near-miss
ones; the engine and telemetry hot zones apply by path.  The port's tree
is clean against its own baseline, whose notes are all written, and the
CLI keeps the reference's exit codes: ``python -m repro_torch.analysis
--check --device cpu`` exits 0 with the reference's report keys.
"""
import json
import pathlib
import textwrap

import pytest

from repro.analysis import findings as r_findings
from repro.analysis import linter as r_linter
from repro_torch.analysis import findings as p_findings
from repro_torch.analysis import linter as p_linter
from repro_torch.analysis import rules as p_rules
from repro_torch.analysis.__main__ import main as cli_main

ROOT = pathlib.Path(__file__).resolve().parents[1]


def lint(src, rules=None, path="src/repro_torch/fixture.py"):
    return p_linter.lint_source(textwrap.dedent(src), path, rules=rules)


def rules_of(found):
    return sorted({f.rule for f in found})


# ---------------------------------------------------------------------------
# findings, suppressions and the baseline, against the reference's
# ---------------------------------------------------------------------------

FINDINGS = [
    ("host-sync", "src/repro_torch/serving/engine.py", 520, 15,
     "host-device sync", "nxt = torch.argmax(logits, -1).cpu().numpy()"),
    ("kernel-wrapper", "src/repro_torch/core/sweep.py", 19, 1,
     "kernel module 'partition_sweep' imported directly",
     "from ..kernels.partition_sweep import check_scalar_rows"),
    ("pallas-wrapper", "src/repro/core/sweep.py", 3, 1, "direct import", ""),
    ("key-reuse", "benchmarks/x.py", 7, 5, "PRNG key 'k' reused",
     "b = jax.random.normal(k, (3,))"),
    ("parse-error", "a b/c.py", 1, 1, "syntax error: x", "def (:"),
]


@pytest.mark.parametrize("rule,path,line,col,message,snippet", FINDINGS)
def test_findings_fingerprint_and_render_as_the_reference(
        rule, path, line, col, message, snippet):
    got = p_findings.Finding(rule, path, line, col, message, snippet)
    want = r_findings.Finding(rule, path, line, col, message, snippet)
    assert got.fingerprint == want.fingerprint
    assert got.render() == want.render()
    # the line number is not part of the fingerprint
    moved = p_findings.Finding(rule, path, line + 40, col, message, snippet)
    assert moved.fingerprint == got.fingerprint


SUPPRESSION_LINES = [
    "x = 1",
    "x = t.item()  # reprolint: ignore[host-sync]",
    "x = t.item()  # reprolint: ignore",
    "x = 1  #reprolint:ignore[host-sync, kernel-wrapper]",
    "x = 1  # reprolint: ignore[host-sync] (the tick's one sync)",
    "x = 1  # reprolint: ignore[]",
    "x = 1  # reprolint ignore[host-sync]",
    "x = 1  # REPROLINT: ignore",
    "# reprolint: ignore[key-reuse,pallas-wrapper]",
]


@pytest.mark.parametrize("line", SUPPRESSION_LINES)
def test_suppressions_parse_as_the_reference(line):
    lines = ["a = 0", line, "b = 2"]
    got = p_findings.suppressions(lines)
    assert got == r_findings.suppressions(lines)
    for rule in ("host-sync", "kernel-wrapper", "key-reuse"):
        f = p_findings.Finding(rule, "p.py", 2, 1, "m", line.strip())
        rf = r_findings.Finding(rule, "p.py", 2, 1, "m", line.strip())
        assert p_findings.is_suppressed(f, got) == \
            r_findings.is_suppressed(rf, r_findings.suppressions(lines))


def test_reference_baseline_reads_as_the_reference(tmp_path):
    path = ROOT / "analysis_baseline.json"
    before = path.read_bytes()
    assert p_findings.load_baseline(path) == r_findings.load_baseline(path)
    assert p_findings.PLACEHOLDER_NOTE == r_findings.PLACEHOLDER_NOTE
    # a baseline with entries: the same split and the same stale notes
    found = [p_findings.Finding(*row) for row in FINDINGS]
    p_findings.write_baseline(tmp_path / "b.json", found[:3])
    data = json.loads((tmp_path / "b.json").read_text())
    data["findings"][0]["note"] = "the tick's one sync"
    (tmp_path / "b.json").write_text(json.dumps(data))
    got = p_findings.load_baseline(tmp_path / "b.json")
    want = r_findings.load_baseline(tmp_path / "b.json")
    assert got == want
    assert p_findings.placeholder_entries(got) == \
        r_findings.placeholder_entries(want)
    new, old = p_findings.split_baselined(found, got)
    r_new, r_old = r_findings.split_baselined(
        [r_findings.Finding(*row) for row in FINDINGS], want)
    assert [f.render() for f in new] == [f.render() for f in r_new]
    assert [f.render() for f in old] == [f.render() for f in r_old]
    assert path.read_bytes() == before
    assert p_findings.load_baseline(tmp_path / "nope.json") == {}
    (tmp_path / "v2.json").write_text('{"version": 2}')
    with pytest.raises(ValueError, match="version"):
        p_findings.load_baseline(tmp_path / "v2.json")


def test_same_source_same_findings_in_both_linters():
    """A source both trees would lint: the port's findings under its own
    rules, and the shared plumbing (parse errors, ordering) as the
    reference's."""
    bad = "def broken(:\n    pass\n"
    got = p_linter.lint_source(bad, "x.py")
    want = r_linter.lint_source(bad, "x.py")
    assert [f.render() for f in got] == [f.render() for f in want]
    assert [f.fingerprint for f in got] == [f.fingerprint for f in want]


# ---------------------------------------------------------------------------
# host-sync
# ---------------------------------------------------------------------------

ENGINE = "src/repro_torch/serving/engine.py"
HOOKS = "src/repro_torch/obs/enginehooks.py"

SYNCS = [
    "nxt = torch.argmax(logits, -1).cpu().numpy()",
    "nxt = int(torch.argmax(logits[0], -1))",
    "nxt = torch.argmax(logits, -1).item()",
    "nxt = torch.argmax(logits, -1).tolist()",
    "nxt = torch.argmax(logits, -1).cpu()",
    "nxt = float(logits.max())",
    "nxt = bool(torch.isfinite(logits).all())",
    "nxt = np.asarray(torch.argmax(logits, -1))",
    "nxt = np.array(logits)",
    "torch.cuda.synchronize()",
]


@pytest.mark.parametrize("line", SYNCS)
def test_host_sync_engine_hot_zone_by_path(line):
    src = f"""
        import numpy as np
        import torch
        from ..models import transformer

        class Engine:
            def _step_continuous(self):
                logits, self.state = transformer.decode_step_paged(
                    self.params, self.cfg, self.state, 0, 0, 0)
                {line}
                return nxt
    """
    assert rules_of(lint(src, path=ENGINE)) == ["host-sync"]
    # the same function outside the hot zones' files lints clean
    assert lint(src, path="src/repro_torch/serving/partitioned.py") == []
    # and so does the suppressed line
    assert lint(src.replace(line, line + "  # reprolint: ignore[host-sync]"),
                path=ENGINE) == []


def test_host_sync_kernel_entry_points_are_device_values():
    found = lint("""
        from ..kernels import ops

        class Engine:
            def _solo_prefill(self, q, k, v):
                out = ops.flash_attention(q, k, v)
                return out.sum().item()
    """, path=ENGINE)
    assert rules_of(found) == ["host-sync"]


def test_host_sync_host_data_is_clean():
    found = lint("""
        import numpy as np
        import torch

        class Engine:
            def _grow_blocks(self):
                bidx = int(self.seq_lens[0]) // self.kv_block
                counts = np.asarray([len(r) for r in self.owned])
                nxt = torch.argmax(self.logits, -1).cpu().numpy()  # reprolint: ignore[host-sync]
                return float(counts.sum()) + int(nxt[0]) + bidx
    """, path=ENGINE)
    assert found == []


def test_host_sync_obs_hot_zone_near_miss():
    found = lint("""
        import torch

        class EngineHooks:
            def on_decode_tick(self, engine, t0_us, live):
                toks = torch.argmax(engine.last_logits, -1)
                self.tokens_gauge.set(float(toks[0]))
    """, path=HOOKS)
    assert rules_of(found) == ["host-sync"]


def test_host_sync_obs_hot_zone_host_reads_clean():
    found = lint("""
        class EngineHooks:
            def on_decode_tick(self, engine, t0_us, live):
                self.decode_ticks.inc(engine.decode_steps)

            def sample(self, engine):
                self.queue_depth.set(len(engine.queue))
                self.pool_free.set(engine.allocator.n_free)
    """, path=HOOKS)
    assert found == []


def test_host_sync_real_engine_and_obs_modules():
    """The shipped hooks are clean with no suppression; the engine's
    syncs are the ones it documents, each suppressed on its line: the
    admission's token id and the tick's (slots,) token ids."""
    assert p_linter.lint_paths(paths=["src/repro_torch/obs"]) == []
    engine = (ROOT / ENGINE).read_text()
    bare = engine.replace("  # reprolint: ignore[host-sync]", "")
    found = p_linter.lint_source(bare, ENGINE)
    assert rules_of(found) == ["host-sync"]
    lines = bare.splitlines()
    assert [lines[f.line - 1].strip() for f in found] == [
        "nxt = int(torch.argmax(logits[0], -1))"] + [
        "nxt = torch.argmax(logits, -1).cpu().numpy()"] * 3
    assert p_linter.lint_source(engine, ENGINE) == []


# ---------------------------------------------------------------------------
# kernel-wrapper
# ---------------------------------------------------------------------------

KERNEL_IMPORTS = [
    "from ..kernels.partition_sweep import check_scalar_rows",
    "from ..kernels.flash_attention import HEAD_DIMS",
    "from repro_torch.kernels.decode_attention import decode_attention_cuda",
    "from repro_torch.kernels import ssd_scan",
    "from ..kernels import ops, rglru_scan",
    "import repro_torch.kernels.flash_attention",
    "from repro_torch.kernels import _build",
    "from ..kernels._build import all_libraries",
    "from .flash_attention import HEAD_DIMS",
]


@pytest.mark.parametrize("line", KERNEL_IMPORTS)
def test_kernel_wrapper_direct_import(line):
    assert rules_of(lint(line, path="src/repro_torch/core/sweep.py")) == \
        ["kernel-wrapper"]
    # inside kernels/ and in the smoke run (which holds each kernel
    # against its plain version) the same import is allowed
    assert lint(line, path="src/repro_torch/kernels/ops.py") == []
    assert lint(line, path="chip_smoke.py") == []
    assert lint(line + "  # reprolint: ignore[kernel-wrapper]",
                path="src/repro_torch/core/sweep.py") == []


def test_kernel_wrapper_ops_and_ref_allowed():
    found = lint("""
        from ..kernels import ops, ref
        from ..kernels.ops import HEAD_DIMS, all_libraries, check_scalar_rows
        from repro_torch.kernels.ref import attention_ref
        from ..models import attention
    """, path="src/repro_torch/launch/serve.py")
    assert found == []


# ---------------------------------------------------------------------------
# the tree and the CLI
# ---------------------------------------------------------------------------

def test_port_tree_is_lint_clean_against_its_baseline():
    found = p_linter.lint_paths()
    new, _, baseline = p_linter.apply_baseline(found)
    assert new == [], "\n".join(f.render() for f in new)
    assert p_findings.placeholder_entries(baseline) == []
    assert p_linter.BASELINE_PATH == \
        ROOT / "src/repro_torch/analysis/baseline.json"
    assert p_linter.DEFAULT_PATHS == ("src/repro_torch", "chip_smoke.py")


def test_cli_exits_nonzero_on_each_rule_fixture(tmp_path):
    empty = tmp_path / "empty.json"
    empty.write_text('{"version": 1, "findings": []}\n')
    kernels = tmp_path / "sweep.py"
    kernels.write_text("from repro_torch.kernels.flash_attention import "
                       "HEAD_DIMS\n")
    sync = tmp_path / "serving" / "engine.py"
    sync.parent.mkdir()
    sync.write_text(textwrap.dedent("""
        import torch

        def step(logits):
            return torch.argmax(logits, -1).item()
    """))
    for fx in (kernels, sync):
        assert cli_main(["--lint", "--paths", str(fx),
                         "--baseline", str(empty)]) == 1
        assert cli_main(["--lint", "--paths", str(fx), "--json",
                         "--baseline", str(empty)]) == 1
    assert cli_main(["--lint", "--paths", str(empty.parent / "none"),
                     "--baseline", str(empty)]) == 0


def test_cli_baseline_silences_and_stamps_placeholders(tmp_path):
    fx = tmp_path / "fx.py"
    fx.write_text("from repro_torch.kernels import ssd_scan\n")
    baseline = tmp_path / "baseline.json"
    assert cli_main(["--write-baseline", "--paths", str(fx),
                     "--baseline", str(baseline)]) == 0
    assert cli_main(["--lint", "--paths", str(fx),
                     "--baseline", str(baseline)]) == 0
    # the written notes are the placeholder, which --check reports as
    # never justified
    data = json.loads(baseline.read_text())
    assert data["findings"][0]["note"] == p_findings.PLACEHOLDER_NOTE
    assert len(p_findings.placeholder_entries(
        p_findings.load_baseline(baseline))) == 1


def test_cli_list_rules_and_refused_rules(capsys):
    assert cli_main(["--list-rules"]) == 0
    listed = [ln.split()[0] for ln in capsys.readouterr().out.splitlines()]
    assert listed == ["host-sync", "kernel-wrapper"] == sorted(p_rules.RULES)
    # every reference rule is ported or named JAX-only (pallas-wrapper's
    # twin is kernel-wrapper)
    from repro.analysis.rules import RULES as r_rules
    assert set(p_rules.JAX_ONLY) == set(r_rules) - {"host-sync",
                                                    "pallas-wrapper"}
    assert cli_main(["--lint", "--rules", "no-such-rule"]) == 2
    for rule in ("key-reuse", "jit-branch", "recompile-hazard"):
        assert cli_main(["--lint", "--rules", rule]) == 2
        assert "JAX-only" in capsys.readouterr().err


def test_write_baseline_never_writes_the_reference_baseline(
        tmp_path, monkeypatch):
    import repro_torch.analysis.__main__ as cli
    root = ROOT / "analysis_baseline.json"
    before = root.read_bytes()
    mine = tmp_path / "baseline.json"
    monkeypatch.setattr(cli, "BASELINE_PATH", mine)
    assert cli_main(["--write-baseline"]) == 0
    assert root.read_bytes() == before
    data = json.loads(mine.read_text())
    assert data == {"version": 1, "findings": []}


def test_cli_json_report_keys(capsys):
    assert cli_main(["--lint", "--json"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report == {"lint": {"new": [], "baselined": [],
                               "placeholder_notes": []}}


def test_cli_check_on_the_cpu(capsys):
    """The gate: every layer, the reference's report keys, exit 0."""
    assert cli_main(["--check", "--device", "cpu", "--json"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert sorted(report) == ["contracts", "lint", "retrace", "sanitize",
                              "shardcheck"]
    assert sorted(report["lint"]) == ["baselined", "new",
                                      "placeholder_notes"]
    for layer in ("contracts", "shardcheck"):
        assert sorted(report[layer]) == ["covered", "elapsed_s", "failures",
                                         "skipped"]
        assert report[layer]["failures"] == []
    assert report["contracts"]["covered"] == 54
    assert report["retrace"] == {"failures": []}
    assert sorted(report["sanitize"]) == [
        "block_churn", "elapsed_s", "failures", "preemptions", "requests",
        "ticks"]
