"""Writes a cell's input, in a process of its own so that the generator's
memory never counts in the run's: ``python generate.py <traffic file's
JSON> <seed> <directory>`` writes ``<directory>/in.bam`` (with its BAI) and
``<directory>/in.fa`` (with its FAI), and prints the generator's counts as
one JSON line."""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from harness import manifest  # noqa: E402


def main(spec: dict, seed: int, directory: str) -> None:
    gen = manifest.generator(spec["generator"])
    counts = gen.generate(os.path.join(directory, "in.bam"),
                          os.path.join(directory, "in.fa"), seed,
                          **spec["params"])
    print(json.dumps(counts))


if __name__ == "__main__":
    main(json.loads(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
