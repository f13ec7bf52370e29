"""The readings a cell's limits are set from: for each seed, the numbers the
check compares for the program (its outputs against the float64
reference) and for the control (the reference in TF32 put in the
program's place, against the float64 reference), at the cell's own size.

    python3 portbench/control.py --workload <cell> --seeds 11 12 13 [--calls 8] [--no-control]
        [--fault half_batch] [--detail]

One process for every seed: set-up, ``--calls`` calls of the window's own
entry (enough for the check's sample), the check, the control.  On a card;
with ``--device cpu`` it runs the cell as it stands on the CPU.  Prints a
line a seed and one JSON line of every reading.  ``--fault`` plants one
of ``portbench/faults.py``'s faults in the program (its numbers are then the
fault's readings); ``--detail`` adds each leaf's or each answer's gap.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def detail(obj, got, ref) -> dict:
    """Each leaf's norms (fit) or each answer's gap (score)."""
    import torch

    if isinstance(got, tuple):
        n = lambda v: float(torch.linalg.norm(v.double()))
        return {f"{what}.{k}": [n(a[k]), n(b[k])] for what, a, b in
                (("grad", got[1], ref[1]), ("change", got[2], ref[2])) for k in a}
    return {"score": [(a - b.double()).abs().tolist() for a, b in zip(got, ref[0])]}


def readings(name: str, seeds, calls: int, control: bool, device: str = "cuda", files=None,
             fault=None, details=False):
    """[{seed, program: numbers, control: numbers or None}] for ``seeds``."""
    import torch

    from portbench import harness
    from portbench.faults import planted
    from portbench.entries import Spans
    from portbench.reference.render import CONTROL, REF

    if files is None:
        _, wl, cfg = harness.cell(name)
    else:
        _, wl, cfg = files
    out = []
    for seed in seeds:
        t0 = time.perf_counter()
        with planted(wl["entry"], fault):
            obj = harness.entry_class(wl["entry"])(cfg, wl, seed, device, Spans(False))
            for _ in range(calls):
                obj.step()
        obj.release()
        ref = obj.follow(REF)
        row = {"seed": seed, "program": obj.compare(obj.outputs(), ref), "control": None}
        if details:
            row["detail"] = detail(obj, obj.outputs(), ref)
        if control:
            got = obj.follow(CONTROL)
            row["control"] = obj.compare(got[:3] if wl["entry"] == "fit" else got[0], ref)
        row["seconds"] = time.perf_counter() - t0
        out.append(row)
        del obj
        if device == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--calls", type=int, default=8)
    ap.add_argument("--no-control", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fault")
    ap.add_argument("--detail", action="store_true")
    a = ap.parse_args(argv)
    rows = readings(a.workload, a.seeds, a.calls, not a.no_control, a.device, fault=a.fault,
                    details=a.detail)
    for r in rows:
        print(f"{a.workload} seed {r['seed']}{' fault ' + a.fault if a.fault else ''}: program "
              f"{r['program']} control {r['control']} ({r['seconds']:.1f} s)"
              + (f" detail {r['detail']}" if a.detail else ""), flush=True)
    print(json.dumps({"workload": a.workload, "readings": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
