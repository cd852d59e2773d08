"""Per-file and per-worker seconds of a tier-1 run, read from what pytest writes.

    python suite_times.py <junit.xml> [<log>]

The junit XML of a tier-1 run (ROADMAP.md, "Tier-1 verify") gives each
test's seconds (setup, call and teardown). With `-v -v` added to the command
and its output saved as <log>, the log's `[gwN] [ NN%] PASSED
tests/<file>::<test>` lines give the xdist worker that ran each test, in
order; a worker runs its tests one after another, so a file's start is the
sum of the seconds of the tests its worker ran before it (gaps between tests
are not counted). Prints one line a file, the busiest first: tests, busy
seconds and, with a log, worker and start; then each worker's files in
order and its end, and the critical path: the file that ended last, its
worker, its start and its end.
"""

import re
import sys
import xml.etree.ElementTree as ET
from collections import defaultdict

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


def report(junit, log=None):
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
        print(f"ended last: {name} on {worker}, start {start:.0f} s, end {start + busy:.0f} s")


if __name__ == "__main__":
    if len(sys.argv) not in (2, 3):
        sys.exit(__doc__)
    report(*sys.argv[1:])
