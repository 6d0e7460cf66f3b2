"""Command-line interface of the torch port: the JAX package's flags
(``longcallr_tpu.cli.build_parser``), run on the per-region path of
``pipeline/caller.py``.

    python -m longcallr_tpu_torch.cli -b in.bam -f ref.fa -o out -p hifi-masseq
        [--platform cuda|cpu]

``--platform`` defaults to ``cuda`` and raises when no CUDA device is
available. ``--get-blocks`` lists the regions and exits (host only).
Flags of paths this slice does not port (``--batched``, ``--stream``,
``--resume``, the pod flags, ``--profile-dir``) raise
``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import logging
import sys
from typing import List, Optional

from longcallr_tpu.cli import build_parser, config_from_args

# CallerOutputs of the last run through main() (read by chip_smoke.py)
LAST_RUN = None

_PORT_ITEM = "ROADMAP.md torch port queue"


def _unported(args) -> Optional[str]:
    if args.batched:
        return f"--batched ({_PORT_ITEM}: batched bucket programs)"
    if args.stream:
        return f"--stream ({_PORT_ITEM}: --stream and --resume)"
    if args.resume:
        return f"--resume ({_PORT_ITEM}: --stream and --resume)"
    if any(f is not None for f in (args.coordinator, args.num_processes,
                                   args.process_id)):
        return f"pod mode ({_PORT_ITEM}: giant regions and multihost)"
    if args.profile_dir:
        return f"--profile-dir ({_PORT_ITEM}: bench and PERF.md metrics)"
    return None


def main(argv: Optional[List[str]] = None) -> int:
    parser = build_parser()
    parser.prog = "longcallr-tpu-torch"
    args = parser.parse_args(argv)
    logging.basicConfig(level=args.log_level,
                        format="%(asctime)s %(levelname)s %(message)s")
    missing = _unported(args)
    if missing:
        raise NotImplementedError(f"not ported to the torch package: {missing}")
    from longcallr_tpu.utils import malloc_tune
    malloc_tune.tune()
    cfg = config_from_args(args)
    print(f"Preset: {args.preset}")

    from longcallr_tpu.io.bam import BamFile
    from longcallr_tpu.io.fasta import FastaFile

    from .pipeline.caller import build_regions, run

    if args.get_blocks:
        bam = BamFile(args.bam_path, threads=max(1, cfg.threads))
        fasta = FastaFile(args.ref_path)
        regions, _ = build_regions(bam, fasta, cfg, args.region, args.contigs,
                                   args.annotation)
        for reg in regions:
            if reg.gene_id is None:
                print(f"{reg.chr}:{reg.start}-{reg.end} {reg.max_coverage}")
            else:
                print(f'{reg.chr}:{reg.start}-{reg.end} {reg.max_coverage} '
                      f'"{reg.gene_id}"')
        return 0

    if cfg.exon_only and not args.annotation:
        print("error: exon_only is set, but annotation file is not provided",
              file=sys.stderr)
        return 2

    from .utils.device import resolve_device
    global LAST_RUN
    device = resolve_device(args.platform)
    out = LAST_RUN = run(args.bam_path, args.ref_path, args.output, cfg,
              input_vcf=args.input_vcf, input_region=args.region,
              contigs=args.contigs, anno_path=args.annotation,
              device=device)
    print(f"wrote {out.n_records} records to {out.vcf_path} "
          f"({out.n_phased_sites} phased sites, {out.n_candidates} candidates, "
          f"{out.n_assigned_reads}/{out.n_fragments} reads haplotagged) "
          f"on {device}")
    if out.phased_bam_path:
        print(f"wrote phased BAM to {out.phased_bam_path}")
        if args.index_output:
            from longcallr_tpu.io.bai import build_bai
            print(f"wrote index to {build_bai(out.phased_bam_path)}")
    print(f"split-mode regions kept: {out.n_split_kept}, "
          f"recomputed in f64: {out.n_f64_reruns}")
    for k, v in out.stage_seconds.items():
        print(f"  stage {k}: {v:.2f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
