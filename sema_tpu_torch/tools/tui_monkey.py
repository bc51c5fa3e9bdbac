# Copy of tools/tui_monkey.py with the port's command line; tests/test_torch_imports.py checks it for drift.
"""TUI robustness monkey: drive `sema-tpu tui` through a pty with random
key/mouse mashing, then assert a real keyword search still works and the
app quits cleanly.

The curses stack is the one layer unit tests can't execute (events/
render logic is tested headless through the engine seam); this drives
the REAL terminal path — SS3 arrows, SGR-1006 mouse, unicode input,
pathological escape fragments — the way the verify skill's
recipe describes. Exit code 0 = survived N random inputs + a search +
clean quit.

Usage: python tools/tui_monkey.py <directory> [--steps 300] [--seed 42]
(state isolation via SEMA_TPU_HOME/SEMA_TPU_DATA is the caller's job.)
"""

import argparse
import os
import pty
import random
import select
import sys
import time


def pump(fd, t):
    end = time.time() + t
    while time.time() < end:
        r, _, _ = select.select([fd], [], [], 0.1)
        if r:
            try:
                os.read(fd, 65536)
            except OSError:
                return


KEYS = [b"a", b"z", b"1", b" ", b"\x7f", b"\t", b"\x1b", b"\r",
        b"\x1bOA", b"\x1bOB", b"\x1bOC", b"\x1bOD",        # SS3 arrows
        b"\x1b[5~", b"\x1b[6~",                            # pgup/pgdn
        "émoji🔥".encode(), b"'", b"\x01", b"\x05",
        b"\x1b[<0;12;5M", b"\x1b[<0;12;5m",                # SGR mouse
        b"\x1b[<64;40;10M",                                # wheel
        b"\x1b[", b"\x1bO"]                                # torn escapes


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("directory")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--probe-query", default="'the",
                    help="keyword query typed after the mashing; the app "
                         "must execute it without dying")
    args = ap.parse_args()

    env = dict(os.environ, TERM="xterm-256color",
               COLUMNS="100", LINES="30")
    pid, fd = pty.fork()
    if pid == 0:
        os.execvpe(sys.executable,
                   [sys.executable, "-m", "sema_tpu_torch", "tui",
                    args.directory], env)

    def alive():
        done, _ = os.waitpid(pid, os.WNOHANG)
        return done == 0

    pump(fd, 30)  # startup: crawl + index + warm-up
    if not alive():
        print("FAIL: died during startup")
        return 1

    rng = random.Random(args.seed)
    for step in range(args.steps):
        os.write(fd, rng.choice(KEYS))
        if step % 25 == 0:
            pump(fd, 0.4)
            if not alive():
                print(f"FAIL: died at monkey step {step}")
                return 1
        else:
            time.sleep(0.01)
    pump(fd, 3)
    if not alive():
        print("FAIL: died during monkey run")
        return 1

    # recover to a known state and run a real search
    os.write(fd, b"\x1b")
    pump(fd, 0.5)
    for _ in range(80):
        os.write(fd, b"\x7f")
    pump(fd, 0.5)
    os.write(fd, args.probe_query.encode() + b"\r")
    pump(fd, 10)
    if not alive():
        print("FAIL: died executing a search after the monkey run")
        return 1

    # quit: Esc to input mode, then Ctrl-C (quits in every mode,
    # ≙ events.rs q/Ctrl-C handling)
    os.write(fd, b"\x1b")
    pump(fd, 0.5)
    os.write(fd, b"\x03")
    deadline = time.time() + 15
    while time.time() < deadline:
        done, status = os.waitpid(pid, os.WNOHANG)
        if done:
            print(f"OK: survived {args.steps} random inputs + search; "
                  f"exit status {status}")
            return 0
        pump(fd, 0.3)
    os.kill(pid, 15)
    os.waitpid(pid, 0)
    print("FAIL: Ctrl-C did not quit within 15s")
    return 1


if __name__ == "__main__":
    sys.exit(main())
