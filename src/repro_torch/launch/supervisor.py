"""Single-host stand-in for the cluster job manager (port of
``repro.launch.supervisor``): run a worker command, restart it on
failure (bounded retries), rely on checkpoint/restart for state. With
``--heartbeat-timeout``, a worker that stops producing output is treated
as a straggler or a hang and is killed and restarted, the same policy a
1000-node deployment applies per worker. Pure Python: the worker may be
any command, and its output is passed through line by line.

    python -m repro_torch.launch.supervisor --retries 3 -- \\
        python -m repro_torch.launch.train --ckpt-dir /tmp/run --fail-at 12
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import threading
import time


def run_once(cmd: list[str], heartbeat_timeout: float | None) -> int:
    """Run ``cmd`` to its end, echoing its output; -9 if it was killed for
    printing nothing for ``heartbeat_timeout`` seconds."""
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    last_beat = [time.time()]

    def pump():
        for line in proc.stdout:
            sys.stdout.write(line)
            sys.stdout.flush()
            last_beat[0] = time.time()

    t = threading.Thread(target=pump, daemon=True)
    t.start()
    while proc.poll() is None:
        time.sleep(0.5)
        if heartbeat_timeout and time.time() - last_beat[0] > heartbeat_timeout:
            print(f"[supervisor] no heartbeat for {heartbeat_timeout}s — "
                  "killing straggler", flush=True)
            proc.kill()
            proc.wait()
            return -9
    t.join(timeout=5)
    return proc.returncode


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--retries", type=int, default=3)
    ap.add_argument("--heartbeat-timeout", type=float, default=None)
    ap.add_argument("cmd", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    cmd = args.cmd[1:] if args.cmd and args.cmd[0] == "--" else args.cmd
    assert cmd, "no worker command given"

    for attempt in range(args.retries + 1):
        code = run_once(cmd, args.heartbeat_timeout)
        if code == 0:
            print(f"[supervisor] worker finished (attempt {attempt})", flush=True)
            return 0
        print(f"[supervisor] worker exited {code}; "
              f"{'restarting' if attempt < args.retries else 'giving up'}",
              flush=True)
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
