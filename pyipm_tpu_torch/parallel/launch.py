"""Launching the ranks (counterpart of ``pyipm_tpu/parallel/launch.py``).

* **Cluster mode** (one command per host or per rank)::

      python -m pyipm_tpu_torch.parallel.launch \
          --coordinator host0:29500 --num-processes 4 --process-id $I \
          script.py [args...]

  sets the ``PYIPM_*`` rendezvous variables and runs ``script.py`` in
  THIS process; its ``distributed.initialize()`` reads them.

* **Local mode**::

      python -m pyipm_tpu_torch.parallel.launch --spawn 2 script.py [args...]

  starts N copies of ``script.py`` on this machine with a free localhost
  port (the launcher's working directory first on their ``PYTHONPATH``,
  as ``python -m`` has it on its own path), streams rank 0's output and
  **fails fast**: the first worker that
  dies takes the others down (killed by PID, never by pattern: a rank
  waiting in a collective would otherwise wait forever), and the exit
  code is the failing worker's.

Recovery is a relaunch at the same world size from the last checkpoint
(``utils/checkpoint.py``; the solver resumes exactly).  ``torchrun`` is
not wrapped.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import time
from typing import Optional, Sequence

ENV_COORD = "PYIPM_COORDINATOR"
ENV_NPROC = "PYIPM_NUM_PROCESSES"
ENV_PROC_ID = "PYIPM_PROCESS_ID"


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rendezvous_env(coordinator: str, num_processes: int,
                   process_id: int) -> dict:
    """The environment block a worker needs to join the group."""
    return {ENV_COORD: coordinator, ENV_NPROC: str(num_processes),
            ENV_PROC_ID: str(process_id)}


def spawn_local(num_processes: int, argv: Sequence[str], *,
                timeout: Optional[float] = None) -> int:
    """Run ``num_processes`` copies of ``python argv...`` on localhost and
    wait.  Returns 0 iff every worker exited 0; on the first failure the
    others are killed by PID and the failing worker's exit code is
    returned (124 when ``timeout`` seconds pass first)."""
    coord = f"localhost:{_free_port()}"
    path = os.pathsep.join(p for p in (os.getcwd(),
                                       os.environ.get("PYTHONPATH")) if p)
    procs = []
    for i in range(num_processes):
        env = dict(os.environ, PYTHONPATH=path)
        env.update(rendezvous_env(coord, num_processes, i))
        procs.append(subprocess.Popen(
            [sys.executable, *argv], env=env,
            stdout=None if i == 0 else subprocess.DEVNULL, stderr=None))
    code = 0
    timed_out = False
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        live = list(procs)
        while live and code == 0:
            for p in list(live):
                rc = p.poll()
                if rc is None:
                    continue
                live.remove(p)
                if rc != 0:
                    code = rc
                    break
            if deadline is not None and time.monotonic() > deadline:
                code, timed_out = 124, True
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    if timed_out:
        print(f"[launch] FAILED: timed out after {timeout}s; workers "
              f"terminated (exit {code})", file=sys.stderr)
    elif code != 0:
        failed = [i for i, p in enumerate(procs)
                  if p.returncode not in (0, None, -9)]
        print(f"[launch] FAILED: worker(s) {failed} exited nonzero; job "
              f"terminated (exit {code})", file=sys.stderr)
    return code


def main(args: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m pyipm_tpu_torch.parallel.launch",
        description="Launch a pyipm_tpu_torch program across processes.")
    ap.add_argument("--spawn", type=int, metavar="N",
                    help="local mode: start N workers on this machine")
    ap.add_argument("--coordinator", metavar="HOST:PORT",
                    help="cluster mode: rendezvous address (rank 0's)")
    ap.add_argument("--num-processes", type=int,
                    help="cluster mode: number of ranks")
    ap.add_argument("--process-id", type=int,
                    help="cluster mode: this process's rank")
    ap.add_argument("--timeout", type=float, default=None,
                    help="local mode: wall-clock limit of the job (s)")
    ap.add_argument("script", help="python script to run")
    ap.add_argument("script_args", nargs=argparse.REMAINDER,
                    help="arguments passed on to the script")
    ns = ap.parse_args(args)

    if ns.spawn is not None:
        if ns.coordinator or ns.num_processes or ns.process_id is not None:
            ap.error("--spawn is exclusive with cluster-mode flags")
        if ns.spawn < 1:
            ap.error("--spawn needs N >= 1")
        return spawn_local(ns.spawn, [ns.script, *ns.script_args],
                           timeout=ns.timeout)
    if (ns.coordinator is None or ns.num_processes is None
            or ns.process_id is None):
        ap.error("cluster mode needs --coordinator, --num-processes and "
                 "--process-id (or use --spawn N)")
    os.environ.update(rendezvous_env(ns.coordinator, ns.num_processes,
                                     ns.process_id))
    # run the script in this process so that its initialize() sees the
    # rendezvous environment
    sys.argv = [ns.script, *ns.script_args]
    with open(ns.script) as f:
        code = compile(f.read(), ns.script, "exec")
    exec(code, {"__name__": "__main__", "__file__": ns.script})
    return 0


if __name__ == "__main__":
    sys.exit(main())
