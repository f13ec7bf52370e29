"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``voge_tpu_torch``, on a machine
with an NVIDIA GPU.  Prints the lines of the run, then on standard error
each number the check compared beside its limit, and as the last line of
standard output one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (with ``--trace 0`` the cell's end-to-end metrics, with
``--trace 1`` its per-layer ones), ``device``, ``breakdown`` (traced runs)
and ``checks``.  Exits with 2 and prints no result without a card, and
with 1 where the program cannot be imported or the process holds a module
of JAX or of ``voge_tpu`` once the window has closed.
"""
import os
import sys
import time


def process_start() -> float:
    """The process's start on ``time.time()``'s clock (Linux's /proc)."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/stat") as f:
        boot = next(int(line.split()[1]) for line in f if line.startswith("btime"))
    return boot + ticks / os.sysconf("SC_CLK_TCK")


T_START = process_start()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# one host thread for PyTorch's CPU work: the cells' host path is one
# thread, and idle worker threads that spin take cores from it
os.environ["OMP_NUM_THREADS"] = "1"
# every build and kernel cache inside the checkout, at fixed paths
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(ROOT, "build", "portbench", sub)
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    import torch

    torch.set_num_threads(1)
    bench = json.loads(open(os.path.join(ROOT, "BENCHMARK.json")).read())
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}[a.workload]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {a.workload} needs {chips} CUDA device(s); nothing is measured",
              file=sys.stderr)
        return 2
    print(f"imports: {time.time() - T_START:.3f} s after the process started", flush=True)
    try:
        import voge_tpu_torch  # noqa: F401  (the program under test)
    except ImportError as e:
        print(f"portbench: the program cannot be imported: {e}", file=sys.stderr)
        return 1
    from portbench import harness

    res = harness.run(a.workload, a.seed, a.seconds, bool(a.trace), T_START,
                      log=lambda s: print(s, flush=True))
    if a.trace:
        smi = harness.smi_line()
        print(f"card: {smi} (roofline shares against the H100 SXM's published peaks)")
    for k, c in res["checks"].items():
        print(f"check {k} = {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
