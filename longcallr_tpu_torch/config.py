"""Caller configuration and platform presets.

TPU-native re-design of the reference CLI/preset layer
(``longcallR/src/main.rs:39-185`` args, ``main.rs:272-396`` preset tables).
Instead of threading ~33 positional parameters through the pipeline, every knob
lives in one frozen dataclass that is hashable (usable as a static jit arg) and
echoed into output headers for provenance.

Copied from ``longcallr_tpu/config.py``: the torch port
imports nothing of that package and keeps its own copy of what it needs.
The code is unchanged.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

# Base quality cap applied everywhere quals are consumed
# (reference: src/main.rs:20 `MAX_BASE_QUALITY`).
MAX_BASE_QUALITY = 30

VALID_ALLELES = frozenset("ACGTacgt")


@dataclass(frozen=True)
class CallerConfig:
    """All tunable parameters of the SNP-calling / phasing engine.

    Field defaults correspond to the shared defaults of the reference presets
    (src/main.rs:272-396); use :func:`preset` for platform-resolved configs.
    """

    platform: str = "hifi"  # "hifi" | "ont"
    # -- candidate selection --
    min_depth: int = 6
    max_depth: int = 50_000
    min_allele_freq: float = 0.15
    min_allele_freq_include_intron: float = 0.0
    low_allele_frac_cutoff: float = 0.05
    low_allele_cnt_cutoff: int = 10
    min_qual: int = 2
    min_baseq: int = 10
    strand_bias: bool = False
    dense_win_size: int = 100
    min_dense_cnt: int = 5
    # -- read QC --
    min_mapq: int = 20
    min_read_length: int = 500
    divergence: float = 0.5
    distance_to_read_end: int = 40
    polya_tail_length: int = 5
    # -- phasing --
    min_linkers: int = 1
    max_enum_snps: int = 10
    min_phase_score: float = 11.0
    min_read_assignment_diff: float = 0.0
    # -- coverage control --
    truncation: bool = False
    truncation_coverage: int = 200_000
    downsample: bool = False
    downsample_depth: int = 10_000
    # -- modes --
    exon_only: bool = False
    no_bam_output: bool = False
    # BGZF deflate level of the phased BAM (htslib-compatible at any level;
    # 6 matches htslib's default, 1 is ~3x faster to write and ~15% larger)
    bam_compression_level: int = 6
    # somatic-by-het detection (the reference ships this disabled,
    # thread.rs:187; opt-in here)
    somatic: bool = False
    somatic_purity: float = 0.3
    # -- engine --
    threads: int = 1
    seed: int = 2025  # reference seeds downsampling with 2025 (src/thread.rs:149)

    def replace(self, **kw) -> "CallerConfig":
        return dataclasses.replace(self, **kw)

    @property
    def is_ont(self) -> bool:
        return self.platform == "ont"


# Preset parameter matrix, resolved from code not docs
# (reference: src/main.rs:272-396; see SURVEY.md section 2 for the
# doc-vs-code discrepancies replicated here, e.g. divergence=0.5 not 0.05
# and dense_win_size=100 not 500).
_PRESETS = {
    "ont-cdna": dict(
        platform="ont", min_depth=10, min_phase_score=13.0, min_allele_freq=0.20,
        distance_to_read_end=20, strand_bias=True,
    ),
    "ont-drna": dict(
        platform="ont", min_depth=10, min_phase_score=13.0, min_allele_freq=0.20,
        distance_to_read_end=20, strand_bias=False,
    ),
    "hifi-isoseq": dict(
        platform="hifi", min_depth=6, min_phase_score=11.0, min_allele_freq=0.15,
        distance_to_read_end=40, strand_bias=True,
    ),
    "hifi-masseq": dict(
        platform="hifi", min_depth=6, min_phase_score=11.0, min_allele_freq=0.15,
        distance_to_read_end=40, strand_bias=False,
    ),
}

PRESET_NAMES: Tuple[str, ...] = tuple(_PRESETS)


def preset(name: str, **overrides) -> CallerConfig:
    """Resolve a platform preset to a full config.

    ``overrides`` mirror explicit CLI flags, which win over preset defaults
    (reference: ``arg.X.unwrap_or(preset_default)`` in src/main.rs:272-396).
    """
    try:
        base = _PRESETS[name]
    except KeyError:
        raise ValueError(f"unknown preset {name!r}; choose from {PRESET_NAMES}")
    merged = {**base, **{k: v for k, v in overrides.items() if v is not None}}
    return CallerConfig(**merged)
