"""Run one cell of the benchmark once on the card(s) of this machine.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Prints the check's numbers beside their limits as the last lines of
standard error, and one JSON object as the last line of standard output:
``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, and ``check`` last.  Exits non-zero, with no
result, where no card is found, where fewer cards than the cell asks for
are present, or where ``jax``, ``jaxlib``, ``flax`` or the JAX package is
loaded once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")
# one process with few threads: the host's other cores stay free, so the
# host loop's pace varies less from run to run
os.environ.setdefault("OMP_NUM_THREADS", "1")

FORBIDDEN = ("jax", "jaxlib", "flax", "pyipm_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is one of
    ``FORBIDDEN``."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit_w():
    """The card's power limit in W as ``nvidia-smi`` reads it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import harness, registry
    registry.set_cache_env()
    import torch
    torch.set_num_threads(1)

    spec = registry.cell(args.workload)
    chips = int(spec.get("chips", 1))
    if not torch.cuda.is_available():
        print("portbench: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"portbench: the cell asks for {chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    device = torch.device("cuda:0")
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips}
    line, lines = harness.run_cell(args.workload, args.seed, args.seconds,
                                    bool(args.trace), device, T_START,
                                    device_info=info)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: loaded after the window: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    line["device"]["power_limit_w"] = power_limit_w()
    sys.stdout.flush()
    for ln in lines:
        print(ln, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
