"""Each port test file's own cost: CPU and wall seconds of the file run alone.

    python file_cpu_times.py [--root DIR] [--jobs 3] [--out times.json] [FILE ...]

Runs every `tests/test_torch_*.py` of the checkout at DIR (or the FILEs
named) in its own pytest process, without xdist and with the tier-1 marker
filter (`-m 'not slow'`), JOBS files at a time. Each process gets a new empty
HOME and TMPDIR, so the JAX package's persistent compilation cache (under
HOME, tests/conftest.py) starts cold. The CPU seconds are the process tree's
user + system time from `os.wait4`. Prints one line a file, the costliest
first, then the totals; `--out` writes the same as JSON.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path


def start(root: Path, test_file: str, scratch: Path):
    home = Path(tempfile.mkdtemp(prefix="home-", dir=scratch))
    tmp = home / "tmp"
    tmp.mkdir()
    env = dict(os.environ, HOME=str(home), TMPDIR=str(tmp), JAX_PLATFORMS="cpu", ALLOW_MULTIPLE_LIBTPU_LOAD="1")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    cmd = [sys.executable, "-m", "pytest", test_file, "-q", "-m", "not slow", "-p", "no:xdist",
           "-p", "no:cacheprovider", "-p", "no:randomly"]
    log = open(home / "log.txt", "w")
    proc = subprocess.Popen(cmd, cwd=root, env=env, stdout=log, stderr=subprocess.STDOUT)
    return proc, home, log, time.monotonic()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=".")
    ap.add_argument("--jobs", type=int, default=3)
    ap.add_argument("--out")
    ap.add_argument("files", nargs="*")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    files = args.files or sorted(str(p.relative_to(root)) for p in (root / "tests").glob("test_torch_*.py"))
    scratch = Path(tempfile.mkdtemp(prefix="file_cpu_times-"))
    pending, running, rows = list(files), {}, {}
    while pending or running:
        while pending and len(running) < args.jobs:
            f = pending.pop(0)
            proc, home, log, t0 = start(root, f, scratch)
            running[proc.pid] = (f, proc, home, log, t0)
        pid, status, usage = os.wait4(-1, 0)
        if pid not in running:
            continue
        f, proc, home, log, t0 = running.pop(pid)
        log.close()
        tail = (home / "log.txt").read_text().strip().splitlines()
        rows[f] = {"cpu_s": round(usage.ru_utime + usage.ru_stime, 1), "wall_s": round(time.monotonic() - t0, 1),
                   "rc": os.waitstatus_to_exitcode(status), "summary": tail[-1] if tail else ""}
        shutil.rmtree(home, ignore_errors=True)
    shutil.rmtree(scratch, ignore_errors=True)
    for f, r in sorted(rows.items(), key=lambda kv: -kv[1]["cpu_s"]):
        print(f"{r['cpu_s']:8.1f} CPU-s {r['wall_s']:8.1f} s  rc {r['rc']}  {f}  ({r['summary']})")
    print(f"{sum(r['cpu_s'] for r in rows.values()):8.1f} CPU-s {sum(r['wall_s'] for r in rows.values()):8.1f} s"
          f"  all {len(rows)} files")
    if args.out:
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0 if all(r["rc"] in (0, 5) for r in rows.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
