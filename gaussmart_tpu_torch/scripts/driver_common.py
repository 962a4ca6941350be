"""Shared helpers of the benchmark drivers (counterpart of
scripts/driver_common.py).

Scenes are independent jobs run by a plain process pool;
GAUSSMART_PARALLEL_JOBS sets how many run at once (default 1: one card).
Each driver builds its chain as `commands(args)`, a list of stages, each a
list of shell commands that run together; `run_stages` runs them in order
and returns 1 when any job failed, so a failed job fails the driver. The
children find this package from any working directory: PYTHONPATH leads
with its parent directory.
"""
from __future__ import annotations

import os
import subprocess
import sys
from argparse import ArgumentParser, ArgumentTypeError
from concurrent.futures import ThreadPoolExecutor
from typing import List

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def sh(cmd: str) -> int:
    print(cmd, flush=True)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    return subprocess.call(cmd, shell=True, env=env)


def run_jobs(cmds, max_workers: int | None = None) -> List[str]:
    """Run `cmds`, GAUSSMART_PARALLEL_JOBS at a time; returns the failed
    ones, each also reported on stderr."""
    max_workers = max_workers or int(os.environ.get("GAUSSMART_PARALLEL_JOBS", 1))
    if max_workers <= 1:
        rcs = [sh(c) for c in cmds]
    else:
        with ThreadPoolExecutor(max_workers=max_workers) as ex:
            rcs = list(ex.map(sh, cmds))
    failed = []
    for c, rc in zip(cmds, rcs):
        if rc != 0:
            print(f"[driver] job failed (rc={rc}): {c}", file=sys.stderr, flush=True)
            failed.append(c)
    return failed


def run_stages(stages) -> int:
    """Run each stage's jobs in turn (a failed job does not stop the chain,
    as in the JAX drivers); 1 if any job failed, else 0."""
    failed = [c for stage in stages for c in run_jobs(stage)]
    if failed:
        print(f"[driver] {len(failed)} job(s) failed", file=sys.stderr, flush=True)
    return 1 if failed else 0


def add_port_args(parser: ArgumentParser, scenes):
    """The three flags the port's drivers add to the JAX drivers'."""
    parser.add_argument("--device", choices=["cuda", "cpu"], default=None,
                        help="passed to every CLI that runs on a device (train, "
                             "render_cli, metrics_cli) when given")
    parser.add_argument("--iterations", type=int, default=30000,
                        help="training iterations, and the iteration rendered "
                             "and scored")
    def subset(text):
        names = text.split(",")
        unknown = [s for s in names if s not in scenes]
        if unknown:
            raise ArgumentTypeError(f"unknown scenes {unknown}; choose from {list(scenes)}")
        return names
    parser.add_argument("--scenes", type=subset, default=list(scenes),
                        help="comma-separated subset of the scenes (default: all)")


def require(value, message: str):
    """The JAX drivers' `assert value`: a missing dataset root stops the driver."""
    if not value:
        raise SystemExit(message)


def train_extra(args) -> str:
    """What the port's flags add to a train command."""
    return ((f" --iterations {args.iterations}" if args.iterations != 30000 else "")
            + device_arg(args))


def device_arg(args) -> str:
    return f" --device {args.device}" if args.device else ""
