"""detect-shots CLI: populate the shots table for a project's videos.

The reference delegates shot detection to a separate TransNetV2 repo
(docs/Shot-Detection.md); here it is built in
(wise_tpu_torch/pipeline/shots.py, the scores on the card).

    python -m wise_tpu_torch.cli.shots --project-dir P [--threshold 0.2]

Copy of ``wise_tpu/cli/shots.py``, with its imports bound to wise_tpu_torch.
"""

from __future__ import annotations

import argparse
import logging
import sys

from ..pipeline.shots import detect_shots_for_project


def build_parser():
    p = argparse.ArgumentParser(prog="detect-shots", description=__doc__)
    p.add_argument("--project-dir", required=True)
    p.add_argument("--threshold", type=float, default=0.2,
                   help="minimum frame-change score for a boundary")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    n = detect_shots_for_project(args.project_dir, threshold=args.threshold)
    print(f"wrote {n} shots")
    return 0


if __name__ == "__main__":
    sys.exit(main())
