"""The port's benchmark ledger (``repro_torch.obs.ledger`` and the
``python -m repro_torch.obs ledger`` CLI) against the reference's.

Every case of ``tests/test_ledger.py`` runs against both packages: the
case's module globals ``ledger`` and ``obs_main`` are pointed at one
package's, so each case is one parametrised test per package and both must
pass.  Then one sequence of records and comparisons gives equal documents and
equal reports in both.
"""

import importlib.util
import json
from pathlib import Path

import pytest

from repro.obs import ledger as jledger
from repro.obs.__main__ import main as jobs_main
from repro_torch.obs import ledger as tledger
from repro_torch.obs.__main__ import main as tobs_main

_SPEC = importlib.util.spec_from_file_location("_reference_ledger_cases", Path(__file__).with_name("test_ledger.py"))
CASES = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(CASES)
CASE_NAMES = sorted(name for name in vars(CASES) if name.startswith("test_"))
PACKAGES = {"repro": (jledger, jobs_main), "repro_torch": (tledger, tobs_main)}


def test_every_reference_case_is_listed():
    assert len(CASE_NAMES) >= 12 and "test_ledger_cli_round_trip" in CASE_NAMES


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
@pytest.mark.parametrize("case", CASE_NAMES)
def test_reference_ledger_case(case, pkg, tmp_path, capsys, monkeypatch):
    led, main = PACKAGES[pkg]
    monkeypatch.setattr(CASES, "ledger", led)
    monkeypatch.setattr(CASES, "obs_main", main)
    fn = getattr(CASES, case)
    fixtures = {"tmp_path": tmp_path, "capsys": capsys}
    fn(**{name: fixtures[name] for name in fn.__code__.co_varnames[:fn.__code__.co_argcount]})


def _session(led, main, path):
    """One sequence of records and comparisons; what it leaves behind."""
    lg = led.Ledger(path)
    lg.record("serve", {"policy": "gang", "tok_per_s": 50.0, "p99_step_ms": 2.0}, chip="h100", sha="a")
    lg.record("serve", {"policy": "gang", "tok_per_s": 40.0, "p99_step_ms": 1.0}, chip="h100", sha="b")
    rows = ['BENCH {"bench": "serve", "policy": "continuous", "tok_per_s": 20.0, "decode_mfu": 0.01}', "noise"]
    n = led.record_bench_rows(lg, "serve", rows, chip="h100", sha="c")
    results = led.compare_latest(lg, threshold=0.05)
    rc = main(["ledger", "compare", "--ledger", str(path)])
    entries, bad = lg.entries()
    for e in entries:
        e.pop("unix_time")
    return n, [(r.key, r.ok, [d.name for d in r.regressions]) for r in results], led.format_compare(results), rc, \
        entries, bad


def test_one_session_gives_equal_ledgers_and_reports(tmp_path, capsys):
    got = _session(tledger, tobs_main, tmp_path / "port.jsonl")
    want = _session(jledger, jobs_main, tmp_path / "reference.jsonl")
    assert [r[1:] for r in got[1]] == [r[1:] for r in want[1]] and got[1][0][0].ident() == want[1][0][0].ident()
    assert (got[0], got[2], got[3], got[5]) == (want[0], want[2], want[3], want[5]) == (1, got[2], 1, 0)
    assert json.dumps(got[4], sort_keys=True) == json.dumps(want[4], sort_keys=True)
    capsys.readouterr()


def test_git_sha_reads_unknown_outside_a_repository(tmp_path):
    assert tledger.git_sha(cwd=str(tmp_path)) == "unknown" == jledger.git_sha(cwd=str(tmp_path))
    assert tledger.Ledger(tmp_path / "l.jsonl").record("serve", {"tok_per_s": 1.0}, sha="x")["chip"] == "h100"
