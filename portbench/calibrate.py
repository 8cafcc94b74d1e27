"""The readings that the limits of ``correct`` are set from, on the card.

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,3 --seconds <s> [--out f.jsonl]

Runs the cell once a seed in one process, as ``run.py`` does, and judges
on the same sequences both the program's served tokens (the lower reading:
the largest mean gap over the seeds) and the control's, the reference at
the precision below the configuration's put in the program's place and
judged by the same comparison against the cell's limits (the upper
reading: the smallest over the seeds). One JSON line a seed, then the two
readings. The benchmark's own runs never run the control.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main(argv) -> int:
    ap = argparse.ArgumentParser(prog="portbench/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    import torch
    from portbench.harness import runner, spec
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    lows, highs = [], []
    for seed in (int(s) for s in args.seeds.split(",")):
        result, read = runner.run_cell(cell, seed, args.seconds, False, t0=time.time(),
                                       control=True)
        low = read["control"]
        line = {"workload": cell.name, "seed": seed, "correct": result["correct"],
                "control_correct": low["correct"], "gap_mean": read["gap_mean"],
                "control_gap_mean": low["gap_mean"], "gap": read["gap"],
                "control_gap": low["gap"], "gaps": read["gaps"], "control_gaps": low["gaps"],
                "positions": read["positions"], "reference_s": read["reference_s"],
                "metrics": result["metrics"], "device": result["device"]}
        print(json.dumps(line), flush=True)
        if args.out:
            with args.out.open("a") as f:
                f.write(json.dumps(line) + "\n")
        lows.append(read["gap_mean"])
        highs.append(low["gap_mean"])
    print(json.dumps({"workload": cell.name, "lower": max(lows), "upper": min(highs),
                      "seeds": len(lows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
