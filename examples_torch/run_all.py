"""Run every example of this directory as its own script and time it.

    python3 examples_torch/run_all.py [name ...]

Each example runs as ``python3 examples_torch/<name>.py`` (its full
depth) in a process of its own, one after another, so no example's time
includes another's.  The device comes from
``LISP_MCMC_PLATFORM`` as in every example (unset: the GPU).  Writes one
JSON object to ``chiprun_out/examples_full.json`` (each example's output
beside it, in ``chiprun_out/example_<name>.log``):
the card (``nvidia-smi``, where there is one) and for each
example its exit code, seconds, each phase's seconds (from the
``<< label done (s)`` lines of ``_common.phase``) and the last lines of
its output; and prints it.  Exits non-zero if any example failed.
"""

import argparse
import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
EXAMPLES = ("reference_journey", "baseline_configs", "modern_workflow",
            "informative_priors", "robust_fitting", "hard_geometry",
            "scan_model_comparison", "hierarchical_scan", "hierarchical_calibration")
_PHASE = re.compile(r"<< (.*) (done|FAILED) \((\d+\.\d+)s\)$")


def card() -> str | None:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None


def run(name: str, log_dir: str, args=()) -> dict:
    log = os.path.join(log_dir, f"example_{name}.log")
    t0 = time.perf_counter()
    with open(log, "w") as f:
        rc = subprocess.call([sys.executable, os.path.join(HERE, f"{name}.py"), *args],
                             cwd=ROOT, stdout=f, stderr=subprocess.STDOUT)
    secs = time.perf_counter() - t0
    lines = open(log).read().splitlines()
    phases = [{"phase": m.group(1), "status": m.group(2), "seconds": float(m.group(3))}
              for m in map(_PHASE.search, lines) if m]
    return {"name": name, "rc": rc, "seconds": secs, "phases": phases, "log": log,
            "tail": lines[-12:]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("names", nargs="*", default=list(EXAMPLES))
    a = ap.parse_args(argv)
    log_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(log_dir, exist_ok=True)
    # the journey reads a data file: it gets the synthetic one, written here
    sys.path.insert(0, ROOT)
    from examples_torch.reference_journey import write_journey_data

    journey = write_journey_data(os.path.join(log_dir, "examples_journey.xls"))
    args = {"reference_journey": (journey,)}
    t0 = time.perf_counter()
    results = [run(n, log_dir, args.get(n, ())) for n in a.names]
    report = {"card": card(), "seconds": time.perf_counter() - t0, "examples": results}
    with open(os.path.join(log_dir, "examples_full.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report))
    return 0 if all(r["rc"] == 0 for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
