"""The port's repro-lint (``repro_torch.analysis``) against the reference's
(``repro.analysis``): the PF and LK passes give the same findings on the
reference's fixture corpus (tests/fixtures/lint, read only), the port's KN
rules fire on their torch-idiom fixtures (tests/fixtures/lint_torch) and
are silent on the clean ones, the CLI's exit codes and baseline round
trip, the gate clean on ``src/repro_torch``, and the two gate flips on the
port's serving tier (deleting the ledger charge or a lock guard)."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.analysis import analyze_file as ref_analyze_file

from repro_torch.analysis import (ALL_RULES, BASELINE, DEFAULT_ROOTS,
                                  Baseline, Finding, analyze_file,
                                  analyze_paths, analyze_source,
                                  iter_py_files, kernel_limits)

REPO = Path(__file__).resolve().parents[1]
REF_FIXTURES = REPO / "tests" / "fixtures" / "lint"
FIXTURES = REPO / "tests" / "fixtures" / "lint_torch"
CLI = [sys.executable, "-m", "repro_torch.analysis"]


def rule_lines(findings):
    return {(f.rule, f.line) for f in findings}


def fixture_findings(name):
    return analyze_file(str(FIXTURES / name), repo_root=str(REPO))


# ------------------------------------------------ the reference's fixtures
@pytest.mark.parametrize("name", [
    "privacy_violation.py", "privacy_clean.py", "charge_violation.py",
    "lock_violation.py", "lock_clean.py"])
def test_pf_lk_findings_equal_the_reference_analyzers(name):
    path = str(REF_FIXTURES / name)
    got = analyze_file(path, repo_root=str(REPO))
    want = ref_analyze_file(path, repo_root=str(REPO))
    assert rule_lines(got) == rule_lines(want)
    assert [f.fingerprint for f in got] == [f.fingerprint for f in want]
    if "violation" in name:
        assert got


def test_reference_kernel_fixture_keeps_only_the_noise_rule():
    """The reference's KN fixture is JAX code: of its rules only KN003 (a
    narrow chain beside jax.random.normal) has a counterpart that reads it;
    block_l, vmem_budget, jax.jit, pallas_call and BlockSpec are not the
    port's."""
    got = rule_lines(analyze_file(str(REF_FIXTURES / "kernel_violation.py")))
    assert got == {("KN003", 22)}
    assert analyze_file(str(REF_FIXTURES / "kernel_clean.py")) == []


# ------------------------------------------------- the port's KN fixtures
KN_EXPECTED = {
    "KN001": {("KN001", 9), ("KN001", 13), ("KN001", 17)},
    "KN002": {("KN002", 9), ("KN002", 14)},
    "KN003": {("KN003", 12), ("KN003", 17), ("KN003", 24)},
    "KN004": {("KN004", 12), ("KN004", 18), ("KN004", 22), ("KN004", 31),
              ("KN004", 38)},
}


@pytest.mark.parametrize("rule", sorted(KN_EXPECTED))
def test_kn_rule_fires_on_its_violation_fixture(rule):
    got = rule_lines(fixture_findings(f"{rule.lower()}_violation.py"))
    assert got == KN_EXPECTED[rule]


@pytest.mark.parametrize("rule", sorted(KN_EXPECTED))
def test_kn_rule_silent_on_its_clean_fixture(rule):
    assert fixture_findings(f"{rule.lower()}_clean.py") == []


def test_catalog_is_the_ports():
    assert set(KN_EXPECTED) < set(ALL_RULES)
    assert "KN005" not in ALL_RULES          # no lane quantum on the card
    findings = analyze_paths([str(FIXTURES), str(REF_FIXTURES)],
                             repo_root=str(REPO))
    assert {f.rule for f in findings} <= set(ALL_RULES)


def test_kernel_limits_bind_to_live_tables():
    from repro_torch.kernels.kron_matvec.fused import _OPERANDS, _SMEM_BUDGET
    from repro_torch.roofline.cost_model import DEVICE_TABLE
    lim = kernel_limits()
    assert lim.smem_limit == 232448 == _SMEM_BUDGET
    assert lim.smem_limit == max(s.smem_limit for s in DEVICE_TABLE.values()
                                 if not s.plain)
    assert lim.narrow_dtypes == {n for n, v in _OPERANDS.items() if v[1] < 4}
    assert lim.narrow_dtypes == {"bfloat16", "float16"}


def test_smem_budget_at_the_limit_is_clean_one_byte_over_fires():
    lim = kernel_limits().smem_limit
    ok = f"def f(s, d):\n    return plan_shapes(s, d, smem_budget={lim})\n"
    bad = f"def f(s, d):\n    return plan_shapes(s, d, smem_budget={lim + 1})\n"
    assert analyze_source(ok, "x/a.py") == []
    assert rule_lines(analyze_source(bad, "x/a.py")) == {("KN002", 2)}


def test_parse_error_yields_lint000(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("def broken(:\n")
    (finding,) = analyze_file(str(bad))
    assert finding.rule == "LINT000"


def test_inline_ignore_pragma():
    src = ("def f(fut, records):\n"
           "    h = exact_marginals_from_x(records)\n"
           "    fut.set_result(h)  # repro-lint: ignore[PF001]\n")
    assert analyze_source(src, "x/a.py") == []
    src = "def f(s, d):\n    return plan_chain(s, d, rows=0)  # repro-lint: ignore[KN001]\n"
    assert analyze_source(src, "x/a.py") == []


def test_scope_pragma_gates_serve_rules():
    text = (REF_FIXTURES / "charge_violation.py").read_text()
    no_pragma = "\n".join(text.splitlines()[1:])
    assert analyze_source(no_pragma, "tests/fixtures/lint/x.py") == []


# ------------------------------------------------------------------ baseline
def test_baseline_round_trip(tmp_path):
    findings = fixture_findings("kn004_violation.py")
    path = tmp_path / "baseline.json"
    Baseline.from_findings(findings, reason="fixture").save(str(path))
    loaded = Baseline.load(str(path))
    new, waived = loaded.split(findings)
    assert new == [] and len(waived) == len(findings)
    assert loaded.stale(findings) == []
    assert loaded.stale([]) == sorted(f.fingerprint for f in findings)


def test_fingerprint_is_line_independent():
    a = Finding("KN001", "p.py", 10, "f:plan_chain", "x")
    b = Finding("KN001", "p.py", 99, "f:plan_chain", "y")
    assert a.fingerprint == b.fingerprint


def test_baseline_version_mismatch(tmp_path):
    path = tmp_path / "baseline.json"
    path.write_text(json.dumps({"version": 999, "waivers": []}))
    with pytest.raises(ValueError):
        Baseline.load(str(path))


def test_checked_in_baseline_waives_nothing():
    assert DEFAULT_ROOTS == ("src/repro_torch",)
    assert Baseline.load(str(REPO / BASELINE)).waivers == {}


# ----------------------------------------------------------------------- CLI
def run_cli(*args):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    return subprocess.run(CLI + list(args), capture_output=True, text=True,
                          cwd=str(REPO), env=env, timeout=300)


def test_cli_gate_clean_on_the_port():
    proc = run_cli("--gate")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "clean" in proc.stdout


def test_analyzer_clean_on_the_port_in_process():
    assert analyze_paths([str(REPO / r) for r in DEFAULT_ROOTS],
                         repo_root=str(REPO)) == []


@pytest.mark.parametrize("name", [
    "lint/privacy_violation.py", "lint/charge_violation.py",
    "lint/lock_violation.py", "lint_torch/kn001_violation.py",
    "lint_torch/kn004_violation.py"])
def test_cli_gate_fails_each_violation_class(name):
    proc = run_cli("--gate", str(REPO / "tests" / "fixtures" / name))
    assert proc.returncode == 1


def test_cli_no_such_path():
    assert run_cli("--gate", "definitely/not/here").returncode == 2


def test_cli_rules_lists_catalog():
    proc = run_cli("--rules")
    assert proc.returncode == 0
    for rule in ALL_RULES:
        assert rule in proc.stdout
    assert "KN005" not in proc.stdout


def test_cli_json_output():
    proc = run_cli("--json", str(REF_FIXTURES / "lock_violation.py"))
    assert proc.returncode == 1
    blob = json.loads(proc.stdout)
    assert {f["rule"] for f in blob} == {"LK001", "LK002"}
    assert all("fingerprint" in f for f in blob)


def test_cli_write_baseline_then_gate(tmp_path):
    base = tmp_path / "b.json"
    target = str(FIXTURES / "kn003_violation.py")
    proc = run_cli("--write-baseline", "--baseline", str(base), target)
    assert proc.returncode == 0 and base.exists()
    assert run_cli("--gate", "--baseline", str(base), target).returncode == 0


# ----------------------------------------------------------------- gate flip
def test_deleting_ledger_charge_flips_gate():
    path = "src/repro_torch/serve/server.py"
    text = (REPO / path).read_text()
    mutated = text.replace("self.ledger.charge(", "self._audit(")
    assert mutated != text
    assert "PF002" in {f.rule for f in analyze_source(mutated, path)}
    assert analyze_source(text, path) == []


def test_deleting_lock_guard_flips_gate():
    path = "src/repro_torch/serve/pool.py"
    text = (REPO / path).read_text()
    mutated = text.replace(
        "        with self._lock:\n            eng = self.cache.get",
        "        if True:\n            eng = self.cache.get")
    assert mutated != text
    assert "LK001" in {f.rule for f in analyze_source(mutated, path)}
    assert analyze_source(text, path) == []


def test_iter_py_files_skips_pycache(tmp_path):
    (tmp_path / "__pycache__").mkdir()
    (tmp_path / "__pycache__" / "x.py").write_text("")
    (tmp_path / "a.py").write_text("")
    names = [os.path.basename(p) for p in iter_py_files(str(tmp_path))]
    assert names == ["a.py"]
