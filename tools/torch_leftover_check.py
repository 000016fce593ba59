"""Run a command and report every process it left running.

    python tools/torch_leftover_check.py [--log FILE] [--json FILE] -- CMD...

The command runs in a session of its own, its output to ``--log`` (or
this process's stdout). While it runs, /proc is sampled every 0.25 s
and every new process is recorded (pid, parent, state, first and last
seen, command line). After the command exits, the processes that were
not there before it started are listed at +0, +1, +5 and +15 s, then
killed. Exit code: the command's own when nothing was left, else 3.

`chip_smoke.py` stops what it starts (`stop_descendants()`); this
script checks that from the outside, e.g.::

    python tools/torch_leftover_check.py --log smoke.log -- \\
        python3 chip_smoke.py
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import threading
import time


def processes():
    """{pid: info} of every process /proc shows."""
    out = {}
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                stat = f.read()
            with open(f"/proc/{name}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(
                    errors="replace")
        except OSError:
            continue
        fields = stat[stat.rfind(")") + 2:].split()
        out[int(name)] = {"state": fields[0], "ppid": int(fields[1]),
                          "sid": int(fields[3]), "start": int(fields[19]),
                          "comm": stat[stat.find("(") + 1:stat.rfind(")")],
                          "cmd": cmd.strip()[:300]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--log", help="the command's stdout and stderr")
    ap.add_argument("--json", help="every process seen, and those left")
    ap.add_argument("cmd", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    cmd = args.cmd[1:] if args.cmd[:1] == ["--"] else args.cmd
    if not cmd:
        ap.error("no command")
    before = set(processes())
    me = os.getpid()
    seen = {}
    t0 = time.monotonic()
    out = open(args.log, "w") if args.log else None
    proc = subprocess.Popen(cmd, stdout=out, stderr=subprocess.STDOUT
                            if out else None, start_new_session=True)
    done = threading.Event()

    def sample():
        while not done.is_set():
            now = round(time.monotonic() - t0, 2)
            for pid, info in processes().items():
                if pid in before or pid == me:
                    continue
                row = seen.setdefault((pid, info["start"]),
                                      dict(info, pid=pid, first=now))
                row.update(last=now, state=info["state"],
                           ppid=info["ppid"])
            time.sleep(0.25)

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    rc = proc.wait()
    ended = round(time.monotonic() - t0, 2)
    done.set()
    sampler.join()
    left, at = {}, 0
    for delay in (0, 1, 4, 10):
        time.sleep(delay)
        at += delay
        left[at] = [dict(info, pid=pid) for pid, info in processes().items()
                    if pid not in before and pid != me]
    first, last = left[0], left[at]
    named = {info["pid"]: info for info in first + last}
    print(f"command exit {rc} at {ended} s; {len(seen)} processes seen; "
          "left after it: " + ", ".join(
              f"+{t} s {len(v)}" for t, v in left.items()))
    for info in named.values():
        print(f"  left: {info['pid']} ({info['state']}, parent "
              f"{info['ppid']}) {info['cmd']}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"exit": rc, "ended_s": ended,
                       "seen": list(seen.values()),
                       "left": {f"+{t} s": v for t, v in left.items()}}, f,
                      indent=1)
    for info in named.values():
        try:
            os.kill(info["pid"], signal.SIGKILL)
        except OSError:
            pass
    return 3 if named else rc


if __name__ == "__main__":
    sys.exit(main())
