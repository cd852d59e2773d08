"""suite_times.py, the tier-1 run's per-file report, on a junit XML and a
`-v -v` log written here: each file's busy seconds are the sum of its tests'
junit times, and a file's start is what its worker ran before it."""

import importlib.util
from pathlib import Path

import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent

JUNIT = """<?xml version="1.0" encoding="utf-8"?><testsuites><testsuite name="pytest" tests="4">
<testcase classname="tests.test_a" name="test_one" time="2.0" />
<testcase classname="tests.test_a" name="test_two[x-1]" time="3.0" />
<testcase classname="tests.test_b" name="test_three" time="7.5" />
<testcase classname="tests.test_c" name="test_four" time="1.0" />
</testsuite></testsuites>
"""

LOG = """tests/test_a.py::test_one
[gw0] [ 25%] PASSED tests/test_a.py::test_one
tests/test_b.py::test_three
[gw1] [ 50%] PASSED tests/test_b.py::test_three
[gw0] [ 75%] PASSED tests/test_a.py::test_two[x-1]
[gw0] [100%] SKIPPED tests/test_c.py::test_four sys:1: ResourceWarning: unclosed file
"""


def _suite_times():
    spec = importlib.util.spec_from_file_location("suite_times", ROOT / "suite_times.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_report_sums_files_and_orders_workers(tmp_path, capsys):
    st = _suite_times()
    (tmp_path / "junit.xml").write_text(JUNIT)
    (tmp_path / "log.txt").write_text(LOG)
    assert st.junit_key("tests/test_a.py::test_two[x-1]") == ("tests.test_a", "test_two[x-1]")
    assert st.worker_order(tmp_path / "log.txt") == [
        ("gw0", "tests/test_a.py::test_one"), ("gw1", "tests/test_b.py::test_three"),
        ("gw0", "tests/test_a.py::test_two[x-1]"), ("gw0", "tests/test_c.py::test_four")]
    st.report(tmp_path / "junit.xml", tmp_path / "log.txt")
    lines = capsys.readouterr().out.splitlines()
    assert lines[1].split() == ["test_b.py", "1", "8", "gw1", "0"]
    assert lines[2].split() == ["test_a.py", "2", "5", "gw0", "0"]
    assert lines[3].split() == ["test_c.py", "1", "1", "gw0", "5"]
    assert "busy seconds in all: 14; tests of the junit XML not in the log: 0" in lines
    assert "gw0: ends at 6 s: test_a.py@0, test_c.py@5" in lines
    st.report(tmp_path / "junit.xml")  # no log: busy seconds only
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].split() == ["file", "tests", "busy", "s"]
    assert [line.split()[:3] for line in lines[1:4]] == [["test_b.py", "1", "8"], ["test_a.py", "2", "5"],
                                                        ["test_c.py", "1", "1"]]


def test_report_names_the_file_that_ended_last(tmp_path, capsys):
    """The last line names the critical path: the file whose worker reached
    its end last (not the busiest file), with its worker, start and end."""
    st = _suite_times()
    (tmp_path / "junit.xml").write_text(JUNIT)
    (tmp_path / "log.txt").write_text(LOG)
    st.report(tmp_path / "junit.xml", tmp_path / "log.txt")
    assert capsys.readouterr().out.splitlines()[-1] == "ended last: test_b.py on gw1, start 0 s, end 8 s"
    (tmp_path / "log.txt").write_text(LOG.replace("[gw1]", "[gw0]"))  # one worker runs all
    st.report(tmp_path / "junit.xml", tmp_path / "log.txt")
    lines = capsys.readouterr().out.splitlines()
    assert "gw0: ends at 14 s: test_a.py@0, test_b.py@2, test_c.py@12" in lines  # 13.5 s
    assert lines[-1] == "ended last: test_c.py on gw0, start 12 s, end 14 s"


def test_report_counts_the_files_dealt_before_the_critical_path(tmp_path, capsys):
    """The line before the last: the files xdist's loadfile scheduler deals
    before the critical-path file (more tests, or as many and earlier in
    path order), their count and summed busy seconds; --critical names
    another file."""
    st = _suite_times()
    (tmp_path / "junit.xml").write_text(JUNIT)
    (tmp_path / "log.txt").write_text(LOG)
    st.report(tmp_path / "junit.xml", tmp_path / "log.txt")
    lines = capsys.readouterr().out.splitlines()
    assert lines[-2] == "dealt before test_b.py (1 tests): 1 files, busy 5 s: test_a.py (2)"
    st.report(tmp_path / "junit.xml", tmp_path / "log.txt", critical="test_c.py")
    lines = capsys.readouterr().out.splitlines()
    assert lines[-2] == "dealt before test_c.py (1 tests): 2 files, busy 12 s: test_a.py (2), test_b.py (1)"
    assert lines[-1] == "ended last: test_b.py on gw1, start 0 s, end 8 s"
    (tmp_path / "log.txt").write_text(LOG + "tests/test_c.py::test_five\n")  # started, then cut
    assert st.test_counts(tmp_path / "log.txt") == {"test_a.py": 2, "test_b.py": 1, "test_c.py": 2}
    st.report(tmp_path / "junit.xml", tmp_path / "log.txt", critical="test_c.py")
    assert capsys.readouterr().out.splitlines()[-2] == "dealt before test_c.py (2 tests): 1 files, busy 5 s: test_a.py (2)"
    counts = {"test_x.py": 3, "test_p.py": 11, "test_a.py": 11, "test_t.py": 12}
    assert st.dealt_before(counts, "test_p.py") == ["test_a.py", "test_t.py"]
