"""ASJ TSV → BED converter for IGV (port of
``longcallR/allele_specific/asj_to_bed.py``; p-value threshold default 1e-10).

Copied from ``longcallr_tpu/analysis/asj_to_bed.py``: the torch port
imports nothing of that package and keeps its own copy of what it needs.
The code is unchanged.
"""

from __future__ import annotations

import sys
from typing import Iterable, Optional, TextIO


def convert_asj_to_bed(input_tsv: str, pval_threshold: float = 1e-10,
                       out: Optional[TextIO] = None) -> None:
    out = out or sys.stdout
    with open(input_tsv) as infile:
        header = infile.readline().strip().split("\t")
        for line in infile:
            cols = line.strip().split("\t")
            rd = dict(zip(header, cols))
            pvalue = float(rd["P_value"])
            if pvalue >= pval_threshold:
                continue
            junction = rd["#Junction"]  # "chr:start-end", 1-based inclusive
            chrom, positions = junction.split(":")
            start, end = positions.split("-")
            start = str(int(start) - 1)  # BED is 0-based
            extra = ";".join(f"{h}={v}" for h, v in zip(header, cols))
            out.write(f"{chrom}\t{start}\t{end}\t{rd['Gene_name']}\t{pvalue}\t"
                      f"{rd['Strand']}\t{extra}\n")


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv or argv[0] in ("-h", "--help"):
        print("Usage: longcallr-tpu-asj-to-bed <input_tsv> [p_value_threshold]")
        return 0
    thr = float(argv[1]) if len(argv) > 1 else 1e-10
    convert_asj_to_bed(argv[0], thr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
