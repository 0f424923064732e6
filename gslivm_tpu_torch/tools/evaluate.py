"""Offline evaluation CLI (counterpart of gslivm_tpu/tools/evaluate.py;
python/evaluate_image.py, evaluate_no_split.py, see_depth_l1.py parity)
over saved render artifacts, on the card unless `--device cpu` is given.

  python -m gslivm_tpu_torch.tools.evaluate split RENDER_DIR
  python -m gslivm_tpu_torch.tools.evaluate dirs RENDER_DIR GT_DIR
  python -m gslivm_tpu_torch.tools.evaluate depth DEPTH_A.npy DEPTH_B.npy

Prints one JSON object.
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def main(argv=None):
    from ..utils import metrics

    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--device", default="cuda",
                        help="torch device of the metrics (default cuda; cpu on request)")
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("split", parents=[common])
    p.add_argument("dir")
    p.add_argument("--lpips", action="store_true",
                   help="require LPIPS (errors out if the optional `lpips` "
                        "torch package + pretrained weights are unavailable; "
                        "without this flag mean_lpips reports null)")
    p = sub.add_parser("dirs", parents=[common])
    p.add_argument("render_dir")
    p.add_argument("gt_dir")
    p.add_argument("--lpips", action="store_true",
                   help="require LPIPS (errors out if unavailable)")
    p = sub.add_parser("depth", parents=[common])
    p.add_argument("a")
    p.add_argument("b")
    args = ap.parse_args(argv)

    if args.cmd == "split":
        out = metrics.evaluate_dir(args.dir, lpips_required=args.lpips,
                                   device=args.device)
    elif args.cmd == "dirs":
        out = metrics.evaluate_dirs(args.render_dir, args.gt_dir,
                                    lpips_required=args.lpips, device=args.device)
    else:
        out = {"inverse_depth_l1": metrics.inverse_depth_l1(
            np.load(args.a), np.load(args.b), device=args.device)}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
