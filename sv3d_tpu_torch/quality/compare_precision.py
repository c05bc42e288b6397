"""What --precision 16 costs in mesh quality: quality.overfit at precision 32
and at precision 16 on the same synthetic scene, from the same seed, one
after the other, into one results JSON beside the card's name and power
limit.

    python -m sv3d_tpu_torch.quality.compare_precision --steps 3000 \\
        --out QUALITY_TORCH_PRECISION_r1.json -- --use_unet

Arguments after "--" go to both quality.overfit runs (not --precision,
--steps, --exp or --out, which this tool sets).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="quality.overfit at precision 32 and 16")
    p.add_argument("--steps", type=int, default=3000)
    p.add_argument("--exp", default="runs/quality_precision",
                   help="experiment directory prefix: <exp>_p32 and <exp>_p16")
    p.add_argument("--out", default="quality_precision.json")
    p.add_argument("overfit_args", nargs="*", help="flags for both quality.overfit runs")
    args = p.parse_args(argv)

    from sv3d_tpu_torch.quality import overfit

    runs = {}
    for precision in ("32", "16"):
        runs[precision] = overfit.main([
            *args.overfit_args, "--steps", str(args.steps), "--precision", precision,
            "--exp", f"{args.exp}_p{precision}"])
    smi = None
    if runs["16"]["device"] != "cpu":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip()
    result = {
        "what": "quality.overfit at precision 32 and 16, the same synthetic scene and seed",
        "command": "python -m sv3d_tpu_torch.quality.compare_precision "
                   + " ".join(sys.argv[1:] if argv is None else argv),
        "device": runs["16"]["device"],
        "nvidia_smi_name_power_limit": smi,
        "steps": args.steps,
        "protocol": runs["16"]["protocol"],
        "runs": runs,
        "iou_16_minus_32": round(runs["16"]["iou"] - runs["32"]["iou"], 4),
    }
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=2))
    print(json.dumps({k: v for k, v in result.items() if k != "runs"}), flush=True)
    return result


if __name__ == "__main__":
    main()
