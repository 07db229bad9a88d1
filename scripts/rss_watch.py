"""Run a command and sample the resident memory of its process tree.

    python3 scripts/rss_watch.py --out <file.jsonl> [--every 0.5] -- \
        <command> [arguments]

Every ``--every`` seconds it sums ``VmRSS`` over the command's process and
its descendants (from ``/proc``) and appends ``{"t": seconds since start,
"rss_bytes": ...}`` to ``--out``. When the command ends it prints one line
to standard error, ``[rss_watch] peak <bytes> at <t> s``, and exits with
the command's exit code; the command's own output passes through.
"""
import argparse
import json
import subprocess
import sys
import time


def children(pid: int) -> list:
    try:
        with open(f"/proc/{pid}/task/{pid}/children") as f:
            return [int(c) for c in f.read().split()]
    except OSError:
        return []


def rss(pid: int) -> int:
    """VmRSS of ``pid`` and its descendants, in bytes."""
    total, todo = 0, [pid]
    while todo:
        p = todo.pop()
        todo += children(p)
        try:
            with open(f"/proc/{p}/status") as f:
                total += sum(int(line.split()[1]) * 1024 for line in f
                             if line.startswith("VmRSS:"))
        except OSError:
            pass
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--every", type=float, default=0.5)
    ap.add_argument("command", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    cmd = args.command[1:] if args.command[:1] == ["--"] else args.command
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd)
    peak, peak_t = 0, 0.0
    with open(args.out, "w") as out:
        while proc.poll() is None:
            t, r = time.perf_counter() - t0, rss(proc.pid)
            out.write(json.dumps({"t": round(t, 3), "rss_bytes": r}) + "\n")
            if r > peak:
                peak, peak_t = r, t
            time.sleep(args.every)
    print(f"[rss_watch] peak {peak} at {peak_t:.1f} s", file=sys.stderr,
          flush=True)
    return proc.returncode


if __name__ == "__main__":
    sys.exit(main())
