"""Per-file and per-worker seconds of a tier-1 run, read from what pytest writes.

    python suite_times.py <junit.xml> [<log>] [--critical FILE]

The junit XML of a tier-1 run (ROADMAP.md, "Tier-1 verify") gives each
test's seconds (setup, call and teardown). With `-v -v` added to the command
and its output saved as <log>, the log's `[gwN] [ NN%] PASSED
tests/<file>::<test>` lines give the xdist worker that ran each test, in
order; a worker runs its tests one after another, so a file's start is the
sum of the seconds of the tests its worker ran before it (gaps between tests
are not counted). Prints one line a file, the busiest first: tests, busy
seconds and, with a log, worker and start; then each worker's files in
order and its end; then the files xdist's `--dist loadfile` deals before the
critical-path file (FILE, by default the file that ended last): those with
more tests, or as many and earlier in collection (path) order, as its
scheduler deals files, most tests first; their count and summed busy
seconds; and last the critical path: the file that ended last, its worker,
its start and its end. A file's tests are those the log reports (a test a
run never reached is not counted; one a cut stopped is).
"""

import argparse
import re
import xml.etree.ElementTree as ET
from collections import Counter, defaultdict

START = re.compile(r"^(tests/\S+\.py::\S+)")
LINE = re.compile(r"^\[(gw\d+)\] \[\s*\d+%\] (?:PASSED|FAILED|SKIPPED|ERROR|XFAIL|XPASS) (\S+\.py::\S+)")


def junit_seconds(path):
    """{(classname, name): seconds} of every testcase in the junit XML."""
    return {(case.get("classname"), case.get("name")): float(case.get("time", 0))
            for case in ET.parse(path).getroot().iter("testcase")}


def junit_key(nodeid):
    """The junit (classname, name) of a pytest node id."""
    path, *parts = nodeid.split("::")
    return ".".join([path[:-3].replace("/", ".")] + parts[:-1]), parts[-1]


def worker_order(log):
    """[(worker, nodeid)] in the order the log reports them, each test once."""
    seen, order = set(), []
    with open(log, errors="replace") as f:
        for line in f:
            m = LINE.match(line)
            if m and m.group(2) not in seen:
                seen.add(m.group(2))
                order.append((m.group(1), m.group(2)))
    return order


def test_counts(log) -> dict:
    """{file: its tests the log names}: each test's line as it starts (`-v -v`)
    or ends, so a test that a cut stopped counts too."""
    nodeids = set()
    with open(log, errors="replace") as f:
        for line in f:
            m = LINE.match(line) or START.match(line)
            if m:
                nodeids.add(m.group(m.lastindex))
    return Counter(nodeid.split("::")[0].rsplit("/", 1)[-1] for nodeid in nodeids)


def dealt_before(counts: dict, critical: str) -> list:
    """The files of `counts` ({file: tests}) that xdist's loadfile scheduler
    deals before `critical`: more tests, or as many and earlier in path
    order."""
    n = counts[critical]
    return [name for name in sorted(counts) if counts[name] > n or (counts[name] == n and name < critical)]


def report(junit, log=None, critical=None):
    seconds = junit_seconds(junit)
    if log:  # (worker, file, junit key) in the order each worker ran them
        order = [(w, nodeid.split("::")[0].rsplit("/", 1)[-1], junit_key(nodeid)) for w, nodeid in worker_order(log)]
    else:  # no worker tags: every test of the junit XML, on no known worker
        order = [(None, key[0].split(".")[1] + ".py", key) for key in seconds]
    clock = defaultdict(float)  # worker -> seconds so far
    files = {}  # file -> [worker, start, busy, tests]
    for worker, name, key in order:
        entry = files.setdefault(name, [worker, clock[worker], 0.0, 0])
        took = seconds.get(key, 0.0)
        entry[2] += took
        entry[3] += 1
        clock[worker] += took
    print(f"{'file':44} {'tests':>5} {'busy s':>8}" + (f" {'worker':>6} {'start s':>8}" if log else ""))
    for name, (worker, start, busy, n) in sorted(files.items(), key=lambda kv: -kv[1][2]):
        print(f"{name:44} {n:5d} {busy:8.0f}" + (f" {worker:>6} {start:8.0f}" if log else ""))
    missing = len(seconds.keys() - {key for _, _, key in order})
    print(f"busy seconds in all: {sum(e[2] for e in files.values()):.0f}; "
          f"tests of the junit XML not in the log: {missing}")
    for worker in sorted(clock, key=lambda w: int(w[2:])) if log else ():
        ran = sorted((e[1], n) for n, e in files.items() if e[0] == worker)
        print(f"{worker}: ends at {clock[worker]:.0f} s: " + ", ".join(f"{n}@{s:.0f}" for s, n in ran))
    if log and files:
        name, (worker, start, busy, _) = max(files.items(), key=lambda kv: kv[1][1] + kv[1][2])
        target, counts = critical or name, test_counts(log)
        ahead = dealt_before(counts, target)
        print(f"dealt before {target} ({counts[target]} tests): {len(ahead)} files, "
              f"busy {sum(files[n][2] for n in ahead if n in files):.0f} s: "
              + ", ".join(f"{n} ({counts[n]})" for n in ahead))
        print(f"ended last: {name} on {worker}, start {start:.0f} s, end {start + busy:.0f} s")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("junit")
    ap.add_argument("log", nargs="?")
    ap.add_argument("--critical", help="the critical-path file (default: the file that ended last)")
    args = ap.parse_args()
    report(args.junit, args.log, args.critical)
