"""The benchmark of ``longcallr_tpu_torch``: one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted`` (passes in the window), ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and last ``check``: each
number compared with the reference beside its limit, which also end
standard error. ``--control`` puts in the program's place the reference
with the preset's strand-bias filter switched, to show that the check
catches it (it runs no pass and measures nothing). Exits non-zero with no result where there is no card, or
fewer cards than the cell asks for, or where a module of JAX or of the JAX
package was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)

    sys.path[:0] = [HERE, os.path.dirname(HERE)]
    from harness import cell, manifest

    chips = manifest.workload(manifest.load(), args.workload)["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA card(s); this machine "
              f"has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result = cell.run(args.workload, args.seed, args.seconds, bool(args.trace),
                      control=args.control)
    loaded = cell.forbidden_modules()
    if loaded:
        print(f"perfbench: modules that no run may load were loaded: {loaded}",
              file=sys.stderr)
        return 4
    for k, v in result["check"].items():
        print(f"check {k}: {v['value']} (limit {v['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
