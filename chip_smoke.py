"""Smoke run of the torch port on one CUDA card.

    python3 chip_smoke.py

Drives the port's main path (longcallr_tpu_torch; no JAX, nothing of the JAX
package) and fails on the first check that does not hold:

  1. build   — compiles the hand-written CUDA kernels from csrc/ (nvcc) and
               the host decoders from native/decode.cpp (g++);
  2. kernels — each kernel against its plain PyTorch version at the main
               path's shapes and at unaligned ones (max relative error
               <= 1e-12, two launches bit-identical); matvec_cols also with
               every third σ zero, with σ all zero, and on the scalar path
               (I not a multiple of 4; a table that is not 16-byte
               aligned); then 4 host threads call matvec_cols at once, two
               on the default stream and two on streams of their own.
               Both kernels also member by member: a member's result among
               the g members of its table must equal its result alone on
               that table bit for bit. One checked shape is 64 tables of
               (8, 16) with 1,024 members each, 65,536 members, more than
               the second or third dimension of a grid holds (not timed).
               At the main-path shapes — deep (1, 4096, 512), a deep bucket
               (4, 4096, 512: four tables, one member each), the bucket of
               a default wave of the deep input (2, 4096, 512), and the
               enumeration shapes that the workloads of phase 6 launch: a
               6-SNP bucket (4 tables of (512, 8), 64 members each) and one
               such region (1 table, 64 members), a 10-SNP bucket as the
               batched path chunks it (4 tables of (512, 16), 512 members each)
               and one such region (1 table, 1,024 members), 12 tables of
               (64, 8) with 16 members each and 16 members on one (64, 8)
               table, and what the transcriptome input of phase 20
               launches most: 6 tables of (1024, 16) with 128 members
               each, 1,024 members on one (1024, 16) table and 8 on one
               (64, 8) table — and at one member per table with I <= 32
               (iterative regions of 11 to 32 SNPs: one (4096, 16) table,
               5 of (2048, 32), one of (4096, 32)), each kernel
               is timed beside its plain version and
               the one library call that computes the same function
               (torch.matmul / torch.bmm on the f64 tables, the widening
               not counted): the host time of a wrapper
               call and the median time of one call between CUDA events
               (both before the profiler first runs), then the device time
               per call from torch.profiler with the table warm in L2 and
               cold (256 MB written and read back between calls); where
               matvec_cols takes the walk (I <= 32), also the strip that
               served those shapes before it, on the same inputs.
               The bound is the larger of bytes / 3.35 TB/s (each input
               read once, rows with σ = 0 not counted, the result written
               once) and f64 operations / 33.5 TFLOP/s (half the card's
               float32 rate outside the tensor cores). The share of that
               bound is stated for the cold time; for the warm time only
               where those bytes exceed the 50 MB L2 (else the warm time is
               a time "in L2" and has no share of a device-memory bound).
               The round draws of the perturbation schedule
               (phasing/cuda_draws.py, csrc/round_draws.cu) against their
               plain version bit for bit (torch.equal, and two launches
               equal), and against rng.py's host draws for one key, at one
               deep region (keys [2], 129 rounds, I 512, K 4096), a default
               wave (2 keys), the deep bucket (4), a stream wave (5 keys, 65
               rounds, 256, 2048) and a bucket of mixed round counts (4 keys,
               77 of its 129 rounds); timed there: host time of a wrapper
               call, one call between CUDA events, the plain version, and
               the host path it replaces (rng.predraw_rounds per region, the
               copy to the card); device time warm and cold beside the
               bound, the larger of bytes / 3.35 TB/s and int32 operations /
               16.7 T/s (DRAW_OPS a value); once more bit for bit at 65,536
               keys of 2 rounds, more keys than a grid dimension holds. The
               set-condition kernel of the device programs' WHILE nodes
               (csrc/graph_program.cu) against its plain version, the host's
               read of the loop flag: a loop of 0, 1, 7 and 1,000 turns as a
               device program and by the plain executor, the same count and
               body runs; a turn's device time over 20,000 turns in one
               launch, the plain executor's, and the kernel's own from
               torch.profiler where it traces inside the program;
  3. tables  — the split-table build on a bucket of four deep regions
               against the build of each region alone;
  4. goldens — the four simulated preset workloads of the JAX package's
               golden tests through caller.run on the card, as the caller
               resolves them and once more with batched=True, records and
               HP/PS tags byte-equal to tests/golden/preset_*;
  5. deep    — the deep workload (4 loci x 80 kb, 150x, 3 kb reads) through
               the CLI's main() with --no-batched (the per-region loop);
               launch counts of both kernels and of the round draws are
               reset just before and read just after, and must be > 0;
               then once more with the device programs off
               (``_program_off_leg``): the same bytes, tags, launch census
               and draws, and as many host flag reads as the programs'
               set-condition launches;
  6. batched — (a) the same input with no --batched flag: it must take the
               batched pipeline, launch both kernels, and write the VCF
               bytes and phased-BAM payload of the per-region run, and
               launch the round draws, and once more with the programs off
               as in 5; the
               stage counters and the bucket census are printed; (d) the
               genome workload (3 contigs, 8 loci, one 300x locus) batched
               and --no-batched: equal, with the device peak and the bytes
               its programs held, batched with the programs off as in 5,
               and batched with a budget of one byte for
               the programs held (each freed after its shape's call):
               equal, programs freed; (e) the deep input cut into >= 3
               waves (LONGCALLR_WAVE_CELLS) with the write overlap on:
               equal to (a); (f) the deep input as one wave, its four
               regions in one bucket: equal to (a), with the peak of the
               device memory, and with the programs off as in 5; (h) the
               same with the finalize fan-out on
               (LONGCALLR_FINALIZE_MT_CELLS): equal to (a); (g) twelve
               small loci of four SNPs each, which phase as enumeration
               buckets (regions x configs on the members-per-table form of
               the kernels), batched and --no-batched: equal, and both once
               more in forced split mode, where no region is recomputed in
               f64: equal, and equal to the JAX package's digests, and
               batched once more with the programs off as in 5; (i)
               four loci of 6 SNPs and four of 10 SNPs at 432 and 510 reads
               each (tables of (512, 8) with 64 configs, of (512, 16) with
               1,024), run the four ways of (g): equal, equal to its
               digests, with at least one enumeration bucket and both
               kernels launched. Every run that the kernel summary counts must
               have launched the kernels only at shapes that phase 2
               checked;
  7. split vs f64 — (c) the deep input with LONGCALLR_F32_KERNELS=0 (f64
               path on the card), batched and --no-batched, each in a
               fresh process (both in one): byte-identical to the split
               runs, device programs run (the staged chain's ascent and
               schedule) and no loop flag read on the host (the child
               prints its program counters);
  8. stream  — the stream input of the JAX package's bench (5 contigs x 13
               loci of 40 kb at 120x, SNP spacing 200: 104,000 reads of 3 kb)
               through the CLI's main() with --stream and with --no-stream
               (resident, batched), 8 threads each: VCF bytes and phased-BAM
               payload equal, both kernels and the round draws launched on
               both, the matvec kernels only at shapes
               that phase 2 checked ((5, 2048, 256) and (3, 2048, 256)
               tables, one member each), every bucket placed on the card
               at the default thresholds; wall, reads/s, the stream's
               stages, the host RSS peak of each leg and the peak of device
               memory per contig are printed; the resident leg once more
               with the programs off as in 5;
  9. resume  — the genome workload through the CLI with --resume, resident
               and --stream: a second run skips every region and launches
               no kernel, a third on a checkpoint cut to its header and
               first half recomputes the rest; all write the same bytes;
 10. placement — experiments/torch_placement_sweep.py --quick (host against
               card by size: the crossing points beside the defaults of
               utils/device.py); then the enumeration workload (g) and the
               preset goldens with the router at its default, off
               (threshold 0) and all-host (2^62: iterative problems on the
               host, enumeration ones in float64 on the card): bytes equal,
               the counts of problems placed on the host, on the card and
               in float64 on the card printed;
 11. analysis — ASE and ASJ on a simulated phased BAM in this process,
               where CUDA is initialised: the fork gate is closed, the
               tables are written with threads=4 and equal threads=1's;
 12. pod     — (run right after phase 8, on its input) the stream input
               through the CLI's pod branch with --stream: 2 processes of 4
               threads on the one card (torch.distributed, gloo on
               localhost), then 1 process of 8 threads; process 0's VCF
               bytes and sorted HP/PS tags equal phase 8's stream run, every
               worker launches both kernels, at shapes phase 2 checked (its
               share of a contig as one bucket of 1 to 13 tables); wall,
               reads/s and the 1-process/2-process ratio are printed;
 13. pod_resident — the genome workload through the pod branch with
               --no-stream, 2 processes: byte-equal to a single run; the pod
               flags given in part return 2;
 14. giant   — the reads-sharded ascent driven directly (one card gives
               reads_devices no second device), a group of device programs
               of one shard each (phasing/graphs.py, Group) that meet at the
               exchange kernel (csrc/shard_exchange.cu): first, in a child
               process, a group of which one shard is never launched must
               raise within the exchange's bounded wait (WAIT_NS), not
               hang; one stream region (K 2048, I 256, 50 rounds) through
               phase_region_sharded with the card twice and four times as
               the "reads" axis, device programs on and off, and with 2 CPU
               shards: equal states (bit-equal on against off); one sharded
               ascent on each: equal decisions, prob within 1e-9 relative
               of the CPU's and bit-equal on against off;
               read_sharded_snp_sums on the card against the CPU at 1e-12;
               then the giant locus (make_deep_workload(n_regions=1,
               coverage=2500): 66,667 reads, K 131,072 x I 512 padded cells
               = 2^26, the routing threshold): the exchange kernel against
               its plain version (sum_in_order) bit for bit for 2, 4 and 8
               shards at the widths the ascent exchanges there, and its
               time; phase_region_sharded on [card] x 2 with programs on
               and off (bit-equal states) and on [card] x 4 with programs
               on, each leg's wall, seconds in the ascents, builds, capture
               and instantiate seconds, bytes held, device peaks, group
               launches, barrier turns counted on the device, exchange
               launches and host flag reads (0 with programs on); no
               split-matvec kernel launched (f64 matmul); walls beside
               phase_region's on the same inputs (recorded, not judged);
 15. stats   — perturbation_phase_stats on one deep region in split mode:
               state and prob equal perturbation_phase's, ascent trips > 0,
               both kernels and the round draws launched;
 16. profile — the genome workload with --profile-dir: the torch.profiler
               trace holds both hand kernels' device kernels, and the bytes
               equal a run without the flag;
 17. imports — neither jax nor any longcallr_tpu module was imported;
 18. mesh    — (run right after phase 12) the regions axis of the mesh:
               caller.run(batched=True, mesh=...) with the CLI's
               configuration, the card repeated along "regions" (one card),
               and once more over every card (make_mesh()) where there are
               several: (a) the deep input at the default waves on a (2, 1)
               mesh and as one wave of 4 on a (4, 1) mesh, byte-equal to
               phase 6 (a) and (f); (b) the enumeration workload (i) on a
               (4, 1) mesh, byte-equal to phase 6 (i), with enumeration
               buckets on the mesh; (c) the first 2 of the stream input's 5
               contigs resident with 8 threads on a (4, 1) mesh, byte-equal
               to those contigs of phase 8's resident run; (d)
               batched_perturbation_phase_stats on the deep bucket of four
               (its first 25 rounds) with and without a (4, 1) mesh: states
               and trips equal, probs within 1e-12 relative. A mesh that
               repeats one card is slower than the bucket (PERF.md,
               Findings): (c) and (d) are cut to stay in the script's time.
               Every row launches both kernels (cuda_kernels.
               LAUNCHES_BY_ROW), only at shapes phase 2 checked; the round
               draws are launched on every leg but (b), each launch counted
               for a row of the mesh (cuda_draws.DRAW_LAUNCHES_BY_ROW), on
               every row in (d);
               region_phase, phase_fused and walls are printed beside
               phases 6 and 8;
 19. graphs  — (run right after phase 8) the fused bucket phase and the
               perturbation schedule as device programs (phasing/graphs.py:
               CUDA graphs with conditional WHILE nodes, composed by
               csrc/graph_program.cu) against the plain executor of the same
               pieces (graphs.ENABLED off, then on): each wrapper alone
               under capture gives a graph of one kernel node whose replay
               equals the eager call bit for bit (the CLI runs of the deep
               input per region, at the default waves and as one wave of
               4, of the genome, the stream input resident and (g), (i)
               have their program-off twins in phases 5, 6 and 8: bytes,
               sorted HP/PS tags, the launch census and the draws equal,
               the JAX package's digests, no program off, as many host
               flag reads off as set-condition launches on, and on one
               build per distinct shape, both kernels launched through the
               programs and no program cached after the run);
               batched_perturbation_phase of a bucket of each input's
               shapes (a default wave of 2, the deep bucket of 4, a stream
               wave of 5), program off and on, equal; one deep region
               through phase_region the same way, with builds, captures,
               capture and instantiate seconds and device bytes held; the
               wall from launch to sync of each
               schedule above, and with the device's idle share that of one
               bucket's fused phase (the deep bucket of 4) and of the
               region's schedule, program off and on, each after a first
               call that builds its program: the idle share from
               torch.profiler (kernel rows; only where the
               profiler counts every hand kernel that the census counts),
               and its lower bound from the device clock read before and
               after every piece (gp_stamp): the share of the call's span
               outside the pieces. Then the ascent program
               (optimize._ascent) alone, off and on, at the
               shapes it runs at (equal results and census, set-condition
               launches on equal to the flag reads off): the staged chain's
               first ascent of a default wave in f64, one deep region's
               first ascent, and enumeration chunks of (g), (i) and the
               transcriptome input (a bucket chunk and a region of 1,024
               configs alone);
 20. transcriptome — (run right after phase 19) a sample's many small genes
               (utils/goldens.ENUM_INPUTS: 8 contigs of 40 loci of 1.8 to
               9 kb, a SNP every 900 bp, 15x to 120x of 1.5 kb reads:
               62,028 reads) through the CLI with 8 threads, batched and
               --no-batched, program off and on, every problem on the card:
               bytes equal across the four legs and equal to the JAX
               package's digests, the
               census of phase 19's CLI legs, at least 80 % of the regions
               on the enumeration path; each kernel held against its plain
               version at every shape these runs launched it at; the three
               shapes it launched at most are those phase 2 timed (a
               bucket chunk of 6 regions of (1024, 16) x 128 configs, one
               such region's 1,024 configs, 8 configs on a (64, 8) table).

Every CLI run with the device programs on whose phase problems all went
to the card (all but the placement phase's host legs) must read no loop
flag on the host: every ascent and schedule runs as a device program.

The deep input (per region, default waves, one wave), the genome workload,
the stream input (both legs) and the enumeration inputs are held to the
frozen digests of the JAX package's output (tests/golden/reference_digests.json,
experiments/reference_digests.py) wherever the card runs them through the
CLI.

Every phase runs with the device programs on (the default) but the off
legs of phases 19 and 20.

The goldens of phase 4 and the enumeration workloads of phases 6, 19 and 20
run with the placement off (everything on the card, as before there was one): at its
default their regions are of host size. Every other run has the default.

Each phase prints one JSON line (``script_seconds``: the script's time when
the phase ended). Then the kernel summary line (``ms``,
``plain_ms`` and ``library_ms`` are device times per call with the tables
warm in L2, at the shape the default batched run of the deep input
launches: the bucket of two regions that a default wave makes; ``shapes``
holds the same numbers for every timed shape, among them ``deep_bucket``,
the four deep regions in one wave; ``launches`` counts the default batched
deep run, ``launches_per_region`` the per-region one,
``launches_one_wave`` the run of (f), ``launches_enum`` and
``launches_enum_per_region`` the two runs of (g), ``launches_enum_deep`` and
``launches_enum_deep_per_region`` the two of (i), ``launches_stream`` and
``launches_stream_resident`` the two legs of phase 8,
``launches_pod_2p_p0``, ``launches_pod_2p_p1`` and ``launches_pod_1p_p0``
the workers of phase 12, ``launches_stats`` phase 15, ``launches_graphs_*``
the runs with graphs of phase 19, ``launches_transcriptome_*`` those of
phase 20 (whose three most launched shapes are ``tx_chunk``, ``tx_region``
and ``tx_small_region`` under ``shapes``), ``launches_mesh``
(a)'s run on the (2, 1) mesh and ``launches_mesh_*`` the other runs of
phase 18 (``_cards``: over every card); each timed shape lists
under ``launched_by`` the runs that launched the kernel there; the entry of
``round_draws`` has its times at the default wave (2 keys, 129 rounds),
its launches on the default batched deep run, ``launches_<run>`` for every
other run that counted them, its times at every shape of phase 2 under
``shapes`` and, under ``checked_at_launched_shapes``, every shape the runs
launched it at, each held against the plain version once more after the
runs; the entry of ``set_condition`` its launches on the default batched
deep run and ``launches_<run>`` for the other CLI runs, from the program
counters; the entry of ``shard_exchange`` its launches on the giant locus
through [card] x 2 with programs, the barrier turns of that region's
ascents, and ``launches_<leg>`` for the other giant legs), the card's name
and power limit (nvidia-smi), and last the result line.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
START = time.monotonic()

REL_TOL = 1e-12
N_TIMED = 50
# the card's published peaks (NVIDIA H100 SXM data sheet): device memory
# rate, and f64 outside the tensor cores as half of the float32 rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_F64_FLOPS = 67e12 / 2
# written between two calls to push the table out of the 50 MB L2
L2_BYTES = 50e6
FLUSH_BYTES = 256 << 20

# names of the kernels that flush the L2 between two timed calls (zero_ and
# sum of a float32 buffer); left out of a cold timing, and of nothing else:
# cuBLAS has a "splitKreduce_kernel" of its own
_FLUSH_KERNELS = ("FillFunctor", "Memset", "at::native::reduce_kernel")

# (B, K, I, shared Dp[, members per table]): B operands over one shared
# table, or B tables with one member each, or B tables with C members each
DEEP = (1, 4096, 512, True)
DEEP_BUCKET = (4, 4096, 512, False)
DEEP_WAVE = (2, 4096, 512, False)
# what the enumeration workload of phase_batched (i) launches: the bucket of
# its four 6-SNP regions (I = 8, 64 configs) and one such region on the
# per-region loop; the bucket of its four 10-SNP regions as the batched path
# chunks the 1,024 configs (512 a launch) and one such region (all 1,024)
ENUM6_BUCKET = (4, 512, 8, False, 64)
ENUM6_REGION = (64, 512, 8, True)
ENUM10_BUCKET = (4, 512, 16, False, 512)
ENUM10_REGION = (1024, 512, 16, True)
# what a row of a regions mesh launches on (i)'s buckets cut into rows of
# one region (phase mesh, one card), and of two (a mesh of two or three
# cards): the 10-SNP chunk of 512 configs keeps the whole bucket's size
ENUM10_MESH_ROW = (512, 512, 16, True)
ENUM_MESH_PAIRS = [(2, 512, 8, False, 64), (2, 512, 16, False, 512)]
# what the enumeration workload of phase_batched (g) launches: its bucket of
# 12 regions x 16 configs, and one region's 16 configs on the per-region loop
ENUM_RUN_BUCKET = (12, 64, 8, False, 16)
ENUM_RUN_REGION = (16, 64, 8, True)
# what the transcriptome input of phase transcriptome launches most: its
# bucket chunk of 6 regions of (1024, 16) with 128 configs each, one such
# region's 1,024 configs alone, and one small region's 8 configs on a
# (64, 8) table (phase transcriptome checks that its runs launch them)
TX_CHUNK = (6, 1024, 16, False, 128)
TX_REGION = (1024, 1024, 16, True)
TX_SMALL = (8, 64, 8, True)
# one member per table at I <= 32, which the cols walk's direct form
# serves: iterative regions of 11 to 32 SNPs (I padded to 16 or 32), alone
# or in a bucket of five, with many reads
ITER16_REGION = (1, 4096, 16, False)
ITER32_BUCKET = (5, 2048, 32, False)
ITER32_REGION = (1, 4096, 32, False)
# 64 regions of 10 SNPs with at most 8 reads each in one bucket: 65,536
# members in one launch (checked, not timed)
ENUM_LIMIT = (64, 8, 16, False, 1024)
# what the stream input launches: a contig's 13 loci of 1,600 reads x 198
# SNPs go in waves of 5, 5 and 3 regions, one bucket each (the resident run
# of the same input: waves of 5)
STREAM_WAVE = (5, 2048, 256, False)
STREAM_TAIL = (3, 2048, 256, False)
# what a pod worker launches on the stream input (phase pod): its share of a
# contig's 13 loci as one bucket, of 1 to 13 tables; a region phased alone
# (phase giant, and a shard's per-region fallback) is the bucket of 1
STREAM_SHARES = [(b, 2048, 256, False) for b in range(1, 14)
                 if b not in (STREAM_WAVE[0], STREAM_TAIL[0])]
# rows of σ that carry a read at the deep and stream shapes (the rest is
# padding, σ = 0)
ACTIVE_ROWS = {DEEP: 4000, DEEP_BUCKET: 4000, DEEP_WAVE: 4000,
               STREAM_WAVE: 1600, STREAM_TAIL: 1600}
TIMED = {DEEP: "deep", DEEP_BUCKET: "deep_bucket", DEEP_WAVE: "deep_wave",
         STREAM_WAVE: "stream_wave", STREAM_TAIL: "stream_tail",
         ENUM6_BUCKET: "enum6_bucket", ENUM6_REGION: "enum6_region",
         ENUM10_BUCKET: "enum10_bucket", ENUM10_REGION: "enum10_region",
         ENUM10_MESH_ROW: "enum10_mesh_row",
         ENUM_RUN_BUCKET: "enum_run_bucket",
         ENUM_RUN_REGION: "enum_run_region", TX_CHUNK: "tx_chunk",
         TX_REGION: "tx_region", TX_SMALL: "tx_small_region",
         ITER16_REGION: "iter16_region", ITER32_BUCKET: "iter32_bucket",
         ITER32_REGION: "iter32_region"}
# every shape phase_kernels holds against the plain versions: the main-path
# shapes first, then unaligned ones
CHECKED_SHAPES = [DEEP, DEEP_BUCKET, DEEP_WAVE, STREAM_WAVE, STREAM_TAIL,
                  *STREAM_SHARES, ENUM6_BUCKET, ENUM6_REGION,
                  ENUM10_BUCKET, ENUM10_REGION, ENUM10_MESH_ROW,
                  *ENUM_MESH_PAIRS, ENUM_RUN_BUCKET, ENUM_RUN_REGION,
                  TX_CHUNK, TX_REGION, TX_SMALL, ITER16_REGION,
                  ITER32_BUCKET, ITER32_REGION, ENUM_LIMIT,
                  (1, 37, 300, False), (1, 1025, 129, False),
                  (1, 513, 700, False), (1, 4096, 510, False),
                  (5, 300, 64, False), (3, 200, 24, False, 5),
                  # rows in registers, I below the register count, with and
                  # without 16-byte loads; 32 cells a thread
                  (7, 100, 12, False, 3), (3, 50, 5, False, 9),
                  (2, 300, 32, False, 6), (5, 64, 30, True),
                  # a warp per row with more than one member: rows in
                  # shared memory (under and over 48 KB), and too wide for it
                  (2, 40, 600, False, 70), (2, 24, 2000, False, 300),
                  (140, 8, 4000, True), (2, 24, 30000, False, 3),
                  # the cols walk: one member per table (the direct form,
                  # a cluster splitting K; many rounds of it), odd K (4- and
                  # 8-byte copies, an odd last row) in the direct form and
                  # in the staged walk, a stage of K itself, many stages
                  (4, 1024, 16, False), (1, 100000, 16, False),
                  (2, 1025, 8, False), (3, 37, 12, False, 4),
                  (2, 1025, 8, False, 100), (3, 37, 12, False, 50),
                  (2, 2048, 32, False, 24), (2, 8, 4, False, 3000)]
KERNEL_NAMES = ("dual_matvec_rows", "matvec_cols")


def _launch_key(shape) -> tuple:
    """A shape of CHECKED_SHAPES as the wrappers record a launch: (tables,
    K, I, members per table)."""
    B, K, I, shared = shape[:4]
    if shared:
        return (1, K, I, B)
    return (B, K, I, shape[4] if len(shape) > 4 else 1)


# the summary stats of phase kernels (max errors by kernel, times by shape),
# which the later checks and timings add to
KERNEL_STATS: dict = {}
# launch shapes held against the plain versions after a run launched them
# (_check_shapes)
CHECKED_LATER: set = set()


def _launched_shapes(what: str, seen=None, check_at=None) -> dict:
    """The shapes the run just made launched the kernels at, by kernel (or
    ``seen``: those another process reported). Fails if one of them is a
    shape that phase_kernels did not hold against the plain version, or,
    with ``check_at`` (a card), holds the kernels against their plain
    versions at each such shape there now (``_check_shapes``)."""
    from longcallr_tpu_torch.phasing import cuda_kernels as CK

    if seen is None:
        seen = {n: sorted(CK.LAUNCH_SHAPES[n]) for n in KERNEL_NAMES}
    seen = {n: sorted(tuple(s) for s in seen[n]) for n in KERNEL_NAMES}
    for n, shapes in seen.items():
        checked = {_launch_key(s) for s in CHECKED_SHAPES} | CHECKED_LATER
        missing = [s for s in shapes if s not in checked]
        if missing and check_at is not None:
            _check_shapes(check_at, missing)
            missing = []
        if missing:
            raise AssertionError(f"{what}: {n} was launched at {missing} "
                                 f"(tables, K, I, members per table), which "
                                 f"the kernels phase did not check")
    return {n: [list(s) for s in shapes] for n, shapes in seen.items()}


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0].strip()


def _emit(phase: str, card: str, **kw) -> None:
    print(json.dumps({"phase": phase, "card": card, **kw,
                      "script_seconds": time.monotonic() - START}),
          flush=True)


def _median_ms(fn, n: int = N_TIMED) -> float:
    """Median over n calls of the time between two CUDA events around one
    call: the device work and the host work of the call."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _host_ms(fn, n: int = 400) -> float:
    """Host time of one call (ms): n calls enqueued back to back, then one
    synchronise outside the timed span."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt * 1e3 / n


# how _device_ms read its times; "cuda events" once the profiler traced
# nothing on this machine
DEVICE_TIMER = {"by": "torch.profiler"}


def _events_ms(fn, flush, n: int) -> float:
    """Time per call (ms) between CUDA events: warm, n calls enqueued back
    to back between one pair of events; cold, the median over n calls of a
    pair of events around each call, the flush before it."""
    if flush is None:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / n
    times = []
    for _ in range(n):
        flush.zero_()
        flush.sum()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _device_ms(fn, flush=None, n: int = 20) -> float:
    """Device time per call (ms) from torch.profiler: the sum of every
    kernel's device time over n calls, divided by n. With ``flush`` (a
    buffer larger than the L2) the buffer is zeroed and summed before every
    call, so that the call finds its inputs in device memory, and the time
    of those two kernels is left out. Where the profiler traces no kernel
    (a machine that keeps CUPTI from it), the times come from CUDA events
    (``_events_ms``) for the rest of the run, and DEVICE_TIMER says so."""
    if DEVICE_TIMER["by"] != "torch.profiler":
        fn()
        torch.cuda.synchronize()
        return _events_ms(fn, flush, n)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    total_us = 0.0
    for attempt in range(6):        # a profile now and then traces no kernel
        time.sleep(0.2 * attempt)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                if flush is not None:
                    flush.zero_()   # written, then read back: the L2 ends
                    flush.sum()     # up full of lines it can drop at once
                fn()
            torch.cuda.synchronize()
        # kernel rows only
        total_us = sum(e.self_device_time_total for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA
                       and not (flush is not None
                                and any(w in e.key for w in _FLUSH_KERNELS)))
        if total_us > 0:
            break
    if not total_us > 0:
        print("chip_smoke: torch.profiler traced no kernel; device times "
              "are taken between CUDA events", file=sys.stderr)
        DEVICE_TIMER["by"] = "cuda events"
        return _events_ms(fn, flush, n)
    return total_us / 1e3 / n


def _split_dp(rng, shape, dev, misalign: bool = False):
    dp = rng.normal(size=shape) * rng.integers(0, 2, size=shape)
    hi = dp.astype(np.float32)
    lo = (dp - hi.astype(np.float64)).astype(np.float32)
    if not misalign:
        return (torch.as_tensor(hi, device=dev),
                torch.as_tensor(lo, device=dev))
    # the same table one float past a 16-byte boundary
    out = []
    for a in (hi, lo):
        buf = torch.empty(a.size + 1, dtype=torch.float32, device=dev)
        buf[1:] = torch.as_tensor(a.reshape(-1), device=dev)
        out.append(buf[1:].view(*shape))
    return tuple(out)


def _check(name, row, kern, plain, hi, lo, op, stats):
    got = kern(hi, lo, op)
    again = kern(hi, lo, op)
    want = plain(hi, lo, op)
    torch.cuda.synchronize()
    if got.shape != want.shape:
        raise AssertionError(f"{name} {row}: shape {tuple(got.shape)}"
                             f" != {tuple(want.shape)}")
    if not torch.equal(got, again):
        raise AssertionError(f"{name} {row}: two launches differ")
    abs_err = float((got - want).abs().max())
    rel = abs_err / max(float(want.abs().max()), 1e-300)
    if not rel <= REL_TOL:
        raise AssertionError(f"{name} {row}: relative error {rel} "
                             f"> {REL_TOL}")
    st = stats[name]
    st["max_abs_err"] = max(st["max_abs_err"], abs_err)
    st["max_rel_err"] = max(st["max_rel_err"], rel)
    return {"max_abs_err": abs_err, "max_rel_err": rel}


def _bound(name: str, hi, op, out_numel: int):
    """(bound ms, bound by, bytes, f64 operations) of one call on these
    inputs: hi and lo read once (for matvec_cols only the rows that some
    member of the table's σ needs), the operand read once, the result
    written once; per cell one widening add and one multiply-add per
    operand column."""
    K, I = hi.shape[-2], hi.shape[-1]
    tables = hi.shape[0] if hi.dim() == 3 else 1
    if name == "matvec_cols":
        s = op.reshape(tables, -1, K)           # [tables, members each, K]
        cells_read = int((s != 0).any(dim=1).sum()) * I
        flops = int((s != 0).sum()) * I * 3
    else:
        cells_read = tables * K * I
        flops = (op.numel() // (I * 2)) * K * I * 5
    nbytes = cells_read * 8 + op.numel() * 8 + out_numel * 8
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F64_FLOPS * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes, flops)


def _library_call(name, hi, lo, op):
    """The one PyTorch call that computes the same function: a matmul (a
    bmm for a batch of tables) on the f64 tables, which are widened here,
    outside what is timed. Returns (the call, a function that brings its
    result into the kernel's layout)."""
    dpd = hi.double() + lo.double()
    same = lambda r: r
    if dpd.dim() == 2:
        if name == "matvec_cols":
            return (lambda: torch.matmul(op, dpd)), same
        if op.dim() == 2:
            return (lambda: torch.matmul(dpd, op)), same
        K, I = dpd.shape                        # members side by side
        xr = op.permute(1, 0, 2).reshape(I, -1).contiguous()
        return ((lambda: torch.matmul(dpd, xr)),
                lambda r: r.reshape(K, -1, 2).permute(1, 0, 2))
    B, K, I = dpd.shape
    if name == "matvec_cols":
        if op.dim() == 3:                       # [B,C,K] @ [B,K,I]
            return (lambda: torch.bmm(op, dpd)), same
        sb = op[:, None, :].contiguous()
        return (lambda: torch.bmm(sb, dpd)), lambda r: r[:, 0]
    if op.dim() == 3:                           # [B,K,I] @ [B,I,2]
        return (lambda: torch.bmm(dpd, op)), same
    C = op.shape[1]                             # members side by side
    xr = op.permute(0, 2, 1, 3).reshape(B, I, C * 2).contiguous()
    return ((lambda: torch.bmm(dpd, xr)),
            lambda r: r.reshape(B, K, C, 2).permute(0, 2, 1, 3))


def _time_host(name, kern, plain, hi, lo, op) -> dict:
    """Per-call times that include host work (ms). Taken before the
    profiler first runs in the process, so that no hook of it can sit in
    the launch path."""
    lib, as_out = _library_call(name, hi, lo, op)
    out, want = kern(hi, lo, op), as_out(lib())
    torch.cuda.synchronize()
    rel = float((out - want).abs().max()) / max(float(want.abs().max()), 1e-300)
    if not rel <= REL_TOL:
        raise AssertionError(f"{name}: library call differs by {rel}")
    k = lambda: kern(hi, lo, op)
    return {"wrapper_ms": _host_ms(k), "call_ms": _median_ms(k),
            "plain_call_ms": _median_ms(lambda: plain(hi, lo, op)),
            "library_call_ms": _median_ms(lib)}


def _time_device(name, kern, plain, hi, lo, op, flush) -> dict:
    """Device times of one kernel at one shape beside its bound (ms)."""
    lib, _ = _library_call(name, hi, lo, op)
    bound_ms, bound_by, nbytes, flops = _bound(name, hi, op,
                                               kern(hi, lo, op).numel())
    k = lambda: kern(hi, lo, op)
    p = lambda: plain(hi, lo, op)
    t = {"ms": _device_ms(k), "cold_ms": _device_ms(k, flush),
         "ms_by": DEVICE_TIMER["by"],
         "plain_ms": _device_ms(p), "plain_cold_ms": _device_ms(p, flush),
         "library_ms": _device_ms(lib),
         "library_cold_ms": _device_ms(lib, flush),
         "bound_ms": bound_ms, "bound_by": bound_by, "bound_bytes": nbytes,
         "bound_f64_operations": flops}
    # a working set that fits the L2 is served from there when warm: its
    # warm time has no share of a device-memory bound
    t["warm_in_l2"] = nbytes <= L2_BYTES
    t["share_of_bound"] = None if t["warm_in_l2"] else bound_ms / t["ms"]
    t["share_of_bound_cold"] = bound_ms / t["cold_ms"]
    # the kernel's time over the library call's: below 1, the kernel leads
    t["vs_library"] = t["ms"] / t["library_ms"]
    t["vs_library_cold"] = t["cold_ms"] / t["library_cold_ms"]
    if name == "matvec_cols":
        from longcallr_tpu_torch.phasing import cuda_kernels as CK
        K, I = hi.shape[-2], hi.shape[-1]
        t["path"] = CK.cols_path(I)
        if t["path"] == "walk":
            tables = hi.shape[0] if hi.dim() == 3 else 1
            g = op.numel() // (K * tables)
            t["path_plan"] = list(CK.cols_walk_plan(
                tables, K, I, g, CK._sm_count(hi.device)))
            # the strip, which served these shapes before the walk, on the
            # same inputs (held to the plain version first)
            strip = lambda: CK.cols_strip(hi, lo, op)
            _check(name, "strip", CK.cols_strip, plain, hi, lo, op,
                   {name: {"max_abs_err": 0.0, "max_rel_err": 0.0}})
            t["strip_ms"] = _device_ms(strip)
            t["strip_cold_ms"] = _device_ms(strip, flush)
            # below 1, the walk leads
            t["vs_strip"] = t["ms"] / t["strip_ms"]
            t["vs_strip_cold"] = t["cold_ms"] / t["strip_cold_ms"]
    return t


def _launch_operands(rng, shape, dev):
    """Random split tables and operands of one launch shape (tables, K, I,
    members per table), as the wrappers take them: tables [K,I] for one
    table, else [tables, K, I]; x [..., I, 2] and σ [..., K] with the
    members' axes the wrappers infer that shape from."""
    tables, K, I, g = shape
    hi, lo = _split_dp(rng, (K, I) if tables == 1 else (tables, K, I), dev)
    lead = (() if g == 1 else (g,)) if tables == 1 else \
        ((tables,) if g == 1 else (tables, g))
    on = lambda a: torch.as_tensor(a, device=dev)
    x = on(rng.integers(-1, 2, size=lead + (I, 2)).astype(np.float64))
    s = on(rng.integers(-1, 2, size=lead + (K,)).astype(np.float64))
    return hi, lo, {"dual_matvec_rows": x, "matvec_cols": s}


def _check_shapes(dev, shapes) -> None:
    """Each kernel against its plain version at launch shapes that a run
    launched and phase_kernels did not check (random tables and operands,
    ``_check``'s tolerance), and where members share a table a member
    among them against itself alone (``_members_alone``); they join
    CHECKED_LATER."""
    from longcallr_tpu_torch.phasing import cuda_kernels as CK

    rng = np.random.default_rng(20261018)
    kerns = {"dual_matvec_rows": (CK.dual_matvec_rows,
                                  CK.dual_matvec_rows_plain),
             "matvec_cols": (CK.matvec_cols, CK.matvec_cols_plain)}
    for shape in shapes:
        hi, lo, ops = _launch_operands(rng, tuple(shape), dev)
        row = {"launch_shape": list(shape)}
        for name, (kern, plain) in kerns.items():
            _check(name, row, kern, plain, hi, lo, ops[name], KERNEL_STATS)
            if shape[3] > 1:                # members that share a table
                _members_alone(name, row, kern, hi, lo, ops[name])
        CHECKED_LATER.add(tuple(shape))


def _members_alone(name, row, kern, hi, lo, x) -> int:
    """A member among the g members of its table against the same member
    alone on that table, bit for bit, for members at both ends of a table
    and of the batch (x: the rows kernel's [.., I, 2] or the cols kernel's
    σ [.., K]). Returns the members compared."""
    both = kern(hi, lo, x)
    if hi.dim() == 2:                       # one table, members [B, I, 2]
        pick = sorted({(0, m) for m in (0, 1, x.shape[0] // 2,
                                        x.shape[0] - 1)})
        alone = lambda t, m: (kern(hi, lo, x[m]), both[m])
    else:                                   # [B, C, I, 2] over [B, K, I]
        B, C = x.shape[:2]
        pick = sorted({(t, m) for t in (0, B // 2, B - 1)
                       for m in (0, C // 2, C - 1)})
        alone = lambda t, m: (kern(hi[t], lo[t], x[t, m]), both[t, m])
    for t, m in pick:
        one, among = alone(t, m)
        if not torch.equal(one, among):
            raise AssertionError(f"{name} {row}: member {m} of table {t} "
                                 f"differs from its result alone")
    return len(pick)


def _threads_check(CK, rng, dev) -> dict:
    """4 host threads call matvec_cols at once on one card, each on its own
    input: threads 0 and 1 on the default stream (they share a workspace),
    2 and 3 on streams of their own. Every result must equal its plain
    version and the thread's first result bit for bit."""
    K, I, reps = 2048, 512, 40
    inputs = []
    for _ in range(4):
        hi, lo = _split_dp(rng, (K, I), dev)
        s = torch.as_tensor(rng.integers(-1, 2, size=K).astype(np.float64),
                            device=dev)
        inputs.append((hi, lo, s, CK.matvec_cols_plain(hi, lo, s)))
    torch.cuda.synchronize()
    errors = []
    start = threading.Barrier(4)

    def work(t: int) -> None:
        try:
            hi, lo, s, want = inputs[t]
            own = torch.cuda.Stream(dev) if t >= 2 else None
            with torch.cuda.stream(own):
                start.wait(timeout=60)
                outs = [CK.matvec_cols(hi, lo, s) for _ in range(reps)]
                torch.cuda.current_stream(dev).synchronize()
            scale = max(float(want.abs().max()), 1e-300)
            for o in outs:
                if not torch.equal(o, outs[0]):
                    raise AssertionError(f"thread {t}: launches differ")
            rel = float((outs[0] - want).abs().max()) / scale
            if not rel <= REL_TOL:
                raise AssertionError(f"thread {t}: relative error {rel}")
        except Exception as e:              # reported by the caller
            errors.append(f"{type(e).__name__}: {e}")

    threads = [threading.Thread(target=work, args=(t,)) for t in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    if any(th.is_alive() for th in threads):
        raise AssertionError("matvec_cols threads did not finish")
    if errors:
        raise AssertionError("; ".join(errors))
    return {"threads": 4, "calls_each": reps, "K": K, "I": I,
            "workspaces": len(CK._WORKSPACES)}


# the round draws of the perturbation schedule (phasing/cuda_draws.py),
# checked and timed at the main path's shapes: (keys, rounds, I, K) with
# keys None for the one-region form (keys [2]); the rounds are the JAX
# package's I // 4 + 1, and the mixed bucket's loop stops short of them
DRAW_SHAPES = {"deep_region": (None, 129, 512, 4096),
               "deep_wave": (2, 129, 512, 4096),
               "deep_bucket": (4, 129, 512, 4096),
               "stream_wave": (5, 65, 256, 2048),
               "mixed_rounds": (4, 77, 512, 4096)}
# int32 operations a second outside the tensor cores: 64 INT32 lanes per
# SM (the Hopper white paper), 132 SMs, 1.98 GHz (the clock of the data
# sheet's 67 TFLOP/s float32 on 128 lanes)
PEAK_INT32_OPS = 132 * 64 * 1.98e9
# 32-bit operations of one threefry2x32 (2 key adds, then 5 groups of 4
# add-rotate-xor steps and 3 adds of key injection), and of one draw: its
# hash and 4 to make the double
THREEFRY_OPS = 2 + 5 * (4 * 3 + 3)
DRAW_OPS = THREEFRY_OPS + 4
# round_draws by run: {"launches", "shapes", "by_row"}, read just after the
# run (cuda_draws.DRAW_LAUNCHES, cleared with cuda_kernels.reset_launches)
DRAW_RUNS: dict = {}


def _draws_read(run: str, must: bool = False) -> int:
    """Record the round draws of the run just made under ``run``; with
    ``must``, fail if it launched none."""
    from longcallr_tpu_torch.phasing import cuda_draws as CD

    n = CD.DRAW_LAUNCHES["round_draws"]
    DRAW_RUNS[run] = {"launches": n,
                      "shapes": sorted(list(s) for s in CD.DRAW_LAUNCH_SHAPES),
                      "by_row": dict(CD.DRAW_LAUNCHES_BY_ROW)}
    if must and n <= 0:
        raise AssertionError(f"{run}: round_draws was not launched")
    return n


def _draw_keys(B, seed: int = 20261017):
    """Key words of B regions (the edge seeds first), int64 [B, 2] on the
    host; B None: one region's [2]."""
    from longcallr_tpu_torch.phasing import cuda_draws as CD
    from longcallr_tpu_torch.phasing import rng as R

    g = np.random.default_rng(seed)
    n = 1 if B is None else B
    seeds = [0, 2 ** 32 - 1, 2 ** 63 - 1] + [
        int(v) for v in g.integers(0, 2 ** 63 - 1, size=n, dtype=np.int64)]
    keys = [R.prng_key(s) for s in seeds[:n]]
    return CD.key_words(keys[0] if B is None else keys, "cpu")


def _draws_equal(what: str, kw, n_rounds: int, I: int, K: int) -> float:
    """round_draws against round_draws_plain on the card (and two launches
    against each other), bit for bit. Returns the largest difference."""
    from longcallr_tpu_torch.phasing import cuda_draws as CD

    got, again = CD.round_draws(kw, n_rounds, I, K), \
        CD.round_draws(kw, n_rounds, I, K)
    want = CD.round_draws_plain(kw, n_rounds, I, K)
    torch.cuda.synchronize()
    for g, a, w in zip(got, again, want):
        if g.shape != w.shape or not (torch.equal(g, w) and torch.equal(g, a)):
            raise AssertionError(f"round_draws {what}: the kernel differs "
                                 f"from the plain version or from itself")
    return max(float((g - w).abs().max()) if g.numel() else 0.0
               for g, w in zip(got, want))


def _draws_bound(B, n_rounds: int, I: int, K: int):
    """(bound ms, bound by, bytes, int32 operations) of one call: the keys
    read once, the draws written once; DRAW_OPS a value, and the key
    derivation (3 hashes) per (region, round)."""
    b = 1 if B is None else B
    values = n_rounds * b * (I + K)
    nbytes = values * 8 + b * 16
    ops = values * DRAW_OPS + n_rounds * b * 3 * THREEFRY_OPS
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_INT32_OPS * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes, ops)


def _host_path(kw, n_rounds: int, I: int, K: int, dev):
    """What the card's draws replace: rng.predraw_rounds per region on the
    host, the rounds the loop runs stacked round first, copied to the
    card."""
    from longcallr_tpu_torch.phasing import rng as R

    keys = kw.numpy().reshape(-1, 2).astype(np.uint32)

    def run():
        d = [R.predraw_rounds(k, K, I) for k in keys]
        rg = torch.as_tensor(np.stack([x[0][:n_rounds] for x in d], axis=1),
                             device=dev)
        fl = torch.as_tensor(np.stack([x[1][:n_rounds] for x in d], axis=1),
                             device=dev)
        torch.cuda.synchronize()
        return rg, fl
    return run


def _draws_host_phase(dev) -> dict:
    """round_draws at DRAW_SHAPES: the kernel against its plain version and
    the host reference (rng.py, one key of each shape), bit for bit; the
    host times of a wrapper call, of a call between CUDA events, of the
    plain version, and of the host path it replaces. Run before the
    profiler first runs in the process. Returns the rows by shape label."""
    from longcallr_tpu_torch.phasing import cuda_draws as CD
    from longcallr_tpu_torch.phasing import rng as R

    rows = {}
    for label, (B, n_rounds, I, K) in DRAW_SHAPES.items():
        kw = _draw_keys(B)
        kd = kw.to(dev)
        err = _draws_equal(label, kd, n_rounds, I, K)
        rg, fl = CD.round_draws(kd, n_rounds, I, K)
        ref = R.predraw_rounds(kw.numpy().reshape(-1, 2)[0].astype(np.uint32),
                               K, I)
        first = (lambda a: a) if B is None else (lambda a: a[:, 0])
        if not (np.array_equal(first(rg).cpu().numpy(), ref[0][:n_rounds])
                and np.array_equal(first(fl).cpu().numpy(),
                                   ref[1][:n_rounds])):
            raise AssertionError(f"round_draws {label}: differs from rng.py")
        host = _host_path(kw, n_rounds, I, K, dev)
        h = host()
        if not (torch.equal(h[0].reshape(rg.shape), rg)
                and torch.equal(h[1].reshape(fl.shape), fl)):
            raise AssertionError(f"round_draws {label}: the host path "
                                 f"differs")
        call = lambda: CD.round_draws(kd, n_rounds, I, K)
        rows[label] = {
            "keys": B, "rounds": n_rounds, "I": I, "K": K,
            "max_abs_err": err, "bit_equal": True,
            "wrapper_ms": _host_ms(call), "call_ms": _median_ms(call),
            "plain_call_ms": _median_ms(
                lambda: CD.round_draws_plain(kd, n_rounds, I, K), n=10),
            "host_path_ms": _median_ms(host, n=5)}
    return rows


def _draws_device_phase(dev, rows: dict, flush) -> None:
    """Device times of round_draws at DRAW_SHAPES beside its bound: warm,
    cold (the L2 flushed before each call), and the plain version's."""
    from longcallr_tpu_torch.phasing import cuda_draws as CD

    for label, (B, n_rounds, I, K) in DRAW_SHAPES.items():
        kd = _draw_keys(B).to(dev)
        k = lambda: CD.round_draws(kd, n_rounds, I, K)
        bound_ms, bound_by, nbytes, ops = _draws_bound(B, n_rounds, I, K)
        t = {"ms": _device_ms(k), "cold_ms": _device_ms(k, flush),
             "ms_by": DEVICE_TIMER["by"],
             "plain_ms": _device_ms(
                 lambda: CD.round_draws_plain(kd, n_rounds, I, K), n=5),
             "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
             "bound_bytes": nbytes, "bound_int32_operations": ops}
        t["share_of_bound"] = bound_ms / t["ms"]
        t["share_of_bound_cold"] = bound_ms / t["cold_ms"]
        rows[label].update(t)


def _draws_at_launched_shapes(dev) -> list:
    """round_draws against its plain version at every shape the runs of
    DRAW_RUNS launched it at (after their counts were read). Returns the
    shapes."""
    shapes = sorted({tuple(s) for r in DRAW_RUNS.values()
                     for s in r["shapes"]})
    for B, n_rounds, I, K in shapes:
        _draws_equal(f"launched at {(B, n_rounds, I, K)}",
                     _draw_keys(B, seed=B * 7919 + n_rounds).to(dev),
                     n_rounds, I, K)
    return [list(s) for s in shapes]


# the set-condition kernel of csrc/graph_program.cu (the device side of a
# conditional WHILE node), checked and timed in phase kernels; its launches
# on the default batched deep run are read from the program counters
SET_CONDITION: dict = {}
SET_TURNS = 20000
# bytes a turn of a loop moves through the set-condition kernel: the flag
# read, the body-run counter and the count of its own launches each read
# and written
SET_BYTES = 1 + 8 + 8 + 8 + 8
# the device programs' counters (cuda_kernels.GRAPHS) by run, read just
# after the run
PROGRAM_RUNS: dict = {}


def _turn_program(dev):
    """A device program of one loop: its body adds 1 to a counter until the
    counter reaches the input ``n``."""
    from longcallr_tpu_torch.phasing import graphs as G

    x = torch.zeros((), dtype=torch.int64, device=dev)
    n = torch.zeros((), dtype=torch.int64, device=dev)
    flag = torch.zeros((), dtype=torch.bool, device=dev)

    def start():
        x.zero_()
        flag.copy_(x < n)

    def turn():
        x.add_(1)
        flag.copy_(x < n)

    return G.Program(dev, {"n": n}, (G.Piece("start", start), G.While(
        flag, (G.Piece("turn", turn),))), (x,))


def _set_condition(dev) -> dict:
    """The set-condition kernel against its plain version, the host's read
    of the loop flag (the plain executor): the loop of ``_turn_program``
    for 0, 1, 7 and 1,000 turns, as a device program and plainly, must
    count the same and run its body as often; then the device time of a
    turn between CUDA events over SET_TURNS turns in one launch (the
    kernel, the body's two small kernels and the WHILE node's own), the
    plain executor's time of a turn, and the kernel's own device time from
    torch.profiler where it traces inside the program."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from longcallr_tpu_torch.phasing import cuda_kernels as CK
    from longcallr_tpu_torch.phasing import graphs as G

    make = lambda: _turn_program(dev)
    err = 0
    for n in (0, 1, 7, 1000):
        got = {}
        for on in (False, True):
            G.ENABLED = on
            try:
                CK.reset_launches()
                got[on] = (int(G.run(("turns",), dev, make, {"n": n})[0]),
                           CK.GRAPHS["body_runs"], CK.GRAPHS["flag_reads"],
                           CK.GRAPHS["condition_sets"])
            finally:
                G.ENABLED = True
        off, on = got[False], got[True]
        err = max(err, abs(off[0] - on[0]))
        if off[0] != n or on[0] != n or on[1] != n or on[3] != off[2]:
            raise AssertionError(f"set_condition, {n} turns: plain {off}, "
                                 f"program {on}")

    def per_turn(on: bool, n: int) -> float:
        G.ENABLED = on
        try:
            G.run(("turns",), dev, make, {"n": n})
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            a.record()
            G.run(("turns",), dev, make, {"n": n})
            b.record()
            b.synchronize()
        finally:
            G.ENABLED = True
        return a.elapsed_time(b) / n

    ms, plain_ms = per_turn(True, SET_TURNS), per_turn(False, 200)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        G.run(("turns",), dev, make, {"n": 1000})
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and "set_condition" in e.key]
    G.free_all()
    bound_ms = SET_BYTES / PEAK_BYTES_PER_S * 1e3
    SET_CONDITION.update(
        max_abs_err=float(err), turns_timed=SET_TURNS, ms=ms,
        plain_ms=plain_ms,
        kernel_ms_traced=(sum(e.self_device_time_total for e in rows)
                          / max(1, sum(e.count for e in rows)) / 1e3
                          if rows else None),
        kernel_launches_traced=sum(e.count for e in rows),
        bound_ms=bound_ms, bound_by="bytes", bound_bytes=SET_BYTES,
        library_ms=None)
    return dict(SET_CONDITION)


def phase_kernels(card: str, dev):
    """Kernel vs plain at the listed shapes, the σ and alignment cases of
    matvec_cols, the threaded calls, and the timings at the two main-path
    shapes. Returns the summary stats by kernel name."""
    from longcallr_tpu_torch.phasing import cuda_kernels as CK

    rng = np.random.default_rng(20261016)
    kerns = {"dual_matvec_rows": (CK.dual_matvec_rows,
                                  CK.dual_matvec_rows_plain),
             "matvec_cols": (CK.matvec_cols, CK.matvec_cols_plain)}
    stats = {n: {"max_abs_err": 0.0, "max_rel_err": 0.0}
             for n in KERNEL_NAMES}
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    draws = _draws_host_phase(dev)
    rows, timed = [], []
    for shape in CHECKED_SHAPES:
        B, K, I, shared = shape[:4]
        C = shape[4] if len(shape) > 4 else None
        hl_shape = (K, I) if (shared or B == 1) else (B, K, I)
        hi, lo = _split_dp(rng, hl_shape, dev)
        lead = () if B == 1 else ((B,) if C is None else (B, C))
        x = torch.as_tensor(
            rng.integers(-1, 2, size=lead + (I, 2)).astype(np.float64),
            device=dev)
        s = torch.as_tensor(
            rng.integers(-1, 2, size=lead + (K,)).astype(np.float64),
            device=dev)
        if shape in ACTIVE_ROWS:
            # a deep region's σ: every read on a haplotype, the padded tail 0
            s = torch.as_tensor(rng.choice([-1.0, 1.0], size=lead + (K,)),
                                device=dev)
            s[..., ACTIVE_ROWS[shape]:] = 0.0
        row = {"B": B, "K": K, "I": I, "shared_dp": shared,
               "members_per_table": C}
        for name, op in (("dual_matvec_rows", x), ("matvec_cols", s)):
            kern, plain = kerns[name]
            row[name] = _check(name, row, kern, plain, hi, lo, op, stats)
            if shape in TIMED:
                row[name].update(_time_host(name, kern, plain, hi, lo, op))
                stats[name][TIMED[shape]] = row[name]
                timed.append((name, row[name], hi, lo, op))
        if C is not None or (shared and B > 1):
            for name, op in (("dual_matvec_rows", x), ("matvec_cols", s)):
                row[name]["members_equal_alone"] = _members_alone(
                    name, row, kerns[name][0], hi, lo, op)
        if C is not None:
            # the same members named flat, with the wrapper's argument
            for name, op, nd in (("dual_matvec_rows", x, 2),
                                 ("matvec_cols", s, 1)):
                kern = kerns[name][0]
                flat = kern(hi, lo, op.reshape(B * C, *op.shape[-nd:]),
                            members_per_table=C)
                if not torch.equal(flat.reshape(kern(hi, lo, op).shape),
                                   kern(hi, lo, op)):
                    raise AssertionError(f"{name} {row}: members_per_table "
                                         f"gives another result")
        rows.append(row)
    for name, res, hi, lo, op in timed:
        res.update(_time_device(name, *kerns[name], hi, lo, op, flush))
    _draws_device_phase(dev, draws, flush)
    stats["round_draws"] = draws
    # more keys than a grid dimension holds: the kernel folds them
    many = {"keys": 65536, "rounds": 2, "I": 8, "K": 16, "bit_equal": True}
    many["max_abs_err"] = _draws_equal("65,536 keys", _draw_keys(
        65536).to(dev), 2, 8, 16)
    stats["set_condition"] = _set_condition(dev)

    # matvec_cols: σ patterns and the scalar path at the deep size
    kern, plain = kerns["matvec_cols"]
    hi, lo = _split_dp(rng, (4096, 512), dev)
    s_full = rng.choice([-1.0, 1.0], size=4096)
    s_third = s_full.copy()
    s_third[::3] = 0.0                      # every third read inactive
    cases = []
    for label, sv in (("third_zero", s_third),
                      ("all_zero", np.zeros(4096))):
        st = torch.as_tensor(sv, device=dev)
        res = _check("matvec_cols", label, kern, plain, hi, lo, st, stats)
        if label == "all_zero" and float(kern(hi, lo, st).abs().max()) != 0.0:
            raise AssertionError("matvec_cols: σ = 0 gave a non-zero result")
        b_ms, _, nbytes, _ = _bound("matvec_cols", hi, st, 512)
        res.update(case=label, bound_ms=b_ms, bound_bytes=nbytes,
                   ms=_device_ms(lambda: kern(hi, lo, st)),
                   cold_ms=_device_ms(lambda: kern(hi, lo, st), flush))
        cases.append(res)
    hi_m, lo_m = _split_dp(rng, (1024, 256), dev, misalign=True)
    if hi_m.data_ptr() % 16 == 0:
        raise AssertionError("the misaligned table is aligned")
    s_m = torch.as_tensor(rng.integers(-1, 2, size=1024).astype(np.float64),
                          device=dev)
    for name, op in (("matvec_cols", s_m), ("dual_matvec_rows", torch.as_tensor(
            rng.integers(-1, 2, size=(256, 2)).astype(np.float64),
            device=dev))):
        k2, p2 = kerns[name]
        res = _check(name, "misaligned", k2, p2, hi_m, lo_m, op, stats)
        res.update(case=f"misaligned_{name}")
        cases.append(res)
    # the walk on a misaligned table and σ (no bulk copies): 512 members
    # of one table (the staged walk), and one member alone (the direct form)
    hi_w, lo_w = _split_dp(rng, (512, 16), dev, misalign=True)
    s_buf = torch.as_tensor(rng.integers(-1, 2, size=512 * 512 + 1).astype(
        np.float64), device=dev)
    s_w = s_buf[1:].view(512, 512)
    if (hi_w.data_ptr() % 16 == 0) or (s_w.data_ptr() % 16 == 0):
        raise AssertionError("the misaligned walk operands are aligned")
    res = _check("matvec_cols", "misaligned walk", kern, plain, hi_w, lo_w,
                 s_w, stats)
    res.update(case="misaligned_walk", members_equal_alone=_members_alone(
        "matvec_cols", "misaligned walk", kern, hi_w, lo_w, s_w))
    cases.append(res)

    threaded = _threads_check(CK, rng, dev)
    KERNEL_STATS.update(stats)
    _emit("kernels", card, rel_tol=REL_TOL, device_ms_by=DEVICE_TIMER["by"],
          shapes=rows, cols_cases=cases, threaded=threaded, draws=draws,
          draws_65536_keys=many, set_condition=stats["set_condition"])
    return stats


def phase_tables(card: str, dev) -> None:
    """The split-table build on a bucket of four deep regions ([4, 4096,
    512] cells) against the build of each region alone: Dp must be equal
    bit for bit, the vectors to 1e-9 (whether they are bit-identical too is
    reported)."""
    from longcallr_tpu_torch.phasing import kernels_fast as KF
    from longcallr_tpu_torch.phasing.kernels import CompactCells

    rng = np.random.default_rng(20261017)
    B, K, I = DEEP_BUCKET[:3]
    p = torch.as_tensor(rng.choice([-1, 0, 1], size=(B, K, I),
                                   p=[0.35, 0.3, 0.35]).astype(np.int8),
                        device=dev)
    q = torch.as_tensor(rng.integers(3, 31, size=(B, K, I)).astype(np.uint8),
                        device=dev)
    rm = torch.as_tensor(rng.random((B, K)) < 0.97, device=dev)
    sm = torch.as_tensor(rng.random((B, I)) < 0.95, device=dev)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    ft = KF.fast_tables32_from_compact(CompactCells(p, q), rm, sm)
    torch.cuda.synchronize()
    build_s = time.monotonic() - t0
    worst, identical = 0.0, True
    for b in range(B):
        one = KF.fast_tables32_from_compact(CompactCells(p[b], q[b]), rm[b],
                                            sm[b])
        if not torch.equal(ft.dp2[:, b], one.dp2):
            raise AssertionError(f"tables: Dp of member {b} differs")
        for name, a, w in zip(ft._fields[1:], ft[1:], one[1:]):
            if not torch.equal(a[b], w):
                identical = False
                d = float((a[b].double() - w.double()).abs().max())
                worst = max(worst, d)
                if not d <= 1e-9:
                    raise AssertionError(f"tables: {name} of member {b} "
                                         f"differs by {d}")
    _emit("tables", card, shape=[B, K, I], build_seconds=build_s,
          dp_bit_identical=True, vectors_bit_identical=identical,
          vectors_max_abs_diff=worst,
          peak_bytes=torch.cuda.max_memory_allocated(dev))


def phase_goldens(card: str, dev, tmp: str) -> None:
    """The preset goldens through caller.run on ``dev``, byte for byte."""
    from longcallr_tpu_torch.config import preset
    from longcallr_tpu_torch.pipeline.caller import run
    from longcallr_tpu_torch.utils import demo, goldens

    done = []
    for name in goldens.GOLDEN_NAMES:
        for batched in (None, True):
            t0 = time.monotonic()
            bam, fa, cfg, anno = goldens.golden_workload(name, tmp)
            with _router(0):
                out = run(bam, fa, os.path.join(tmp, f"out_{name}_{batched}"),
                          cfg, anno_path=anno, batched=batched, device=dev)
            recs, tags = goldens.records_and_tags(out.vcf_path,
                                                  out.phased_bam_path)
            want_recs, want_tags = goldens.golden(name)
            if recs != want_recs or tags != want_tags:
                raise AssertionError(f"golden {name} (batched={batched}): "
                                     f"records equal {recs == want_recs}, "
                                     f"tags equal {tags == want_tags}")
            done.append({"workload": name, "batched": batched,
                         "regions": out.n_regions, "records": len(recs),
                         "tags": len(tags), "byte_equal": True,
                         "seconds": time.monotonic() - t0})

    if not os.path.exists(demo.DEMO_BAM):
        done.append({"workload": "demo_chr20", "skipped": True,
                     "reason": "LONGCALLR_DEMO_BAM names no file"})
        _emit("goldens", card, workloads=done)
        return
    ref_fa = os.path.join(tmp, "demo_chr20_consensus.fa")
    demo.make_consensus_reference(demo.DEMO_BAM, ref_fa)
    with _router(0):
        out = run(demo.DEMO_BAM, ref_fa, os.path.join(tmp, "demo"),
                  preset("hifi-masseq").replace(threads=2), device=dev)
    recs, tags = goldens.records_and_tags(out.vcf_path, out.phased_bam_path)
    base = os.path.join(goldens.GOLDEN_DIR, "demo_chr20")
    with open(base + "_records.vcf") as f:
        want_recs = f.readlines()
    with open(base + "_tags.tsv") as f:
        want_tags = [l + "\n" for l in f.read().splitlines()]
    if recs != want_recs or tags != want_tags:
        raise AssertionError("golden demo_chr20 differs")
    done.append({"workload": "demo_chr20", "records": len(recs),
                 "byte_equal": True})
    _emit("goldens", card, workloads=done)


def _payloads(prefix: str):
    """(VCF bytes, BGZF payload of the phased BAM) of one run."""
    from longcallr_tpu_torch.io.bgzf import decompress_file

    with open(prefix + ".vcf", "rb") as f:
        vcf = f.read()
    return vcf, bytes(decompress_file(prefix + ".phased.bam"))


def _census(stage: dict) -> dict:
    keys = ("phase_buckets", "phase_enum_buckets", "phase_single_regions",
            "phase_fused_refused", "phase_blockflip_exact",
            "phase_safety_recompute")
    return {k: int(stage.get(k, 0)) for k in keys}


def phase_deep(card: str, tmp: str):
    """The deep workload through the CLI's main() on the card, on the
    per-region loop (--no-batched), then once more with the device
    programs off (``_program_off_leg``)."""
    from longcallr_tpu_torch.utils.bench_workload import make_deep_workload

    bam = os.path.join(tmp, "deep.bam")
    fa = os.path.join(tmp, "deep.fa")
    t0 = time.monotonic()
    params = make_deep_workload(bam, fa)
    gen_s = time.monotonic() - t0
    prefix, out, launches, wall = _cli_run(tmp, "per_region", bam, fa,
                                           extra=["--no-batched"])
    draws = _draws_read("per_region", must=True)
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched by the "
                                 f"main path")
    shapes = _launched_shapes("deep input, per-region loop")
    if out.n_records <= 0:
        raise AssertionError("deep run wrote no records")
    if out.n_split_kept <= 0:
        raise AssertionError("every region needed the f64 rerun")
    reference = _hold_to_reference("deep input, per-region loop", "deep",
                                   prefix)
    off = _program_off_leg(tmp, "per_region", bam, fa, ["--no-batched"],
                           None, (prefix, launches, shapes), "deep")
    _emit("deep", card, reads=params["n_reads"], regions=out.n_regions,
          programs=PROGRAM_RUNS["per_region"], program_off=off,
          placed=_all_on_card("deep input, per-region loop", out),
          records=out.n_records, phased_sites=out.n_phased_sites,
          generate_seconds=gen_s, wall_seconds=wall,
          reads_per_second=params["n_reads"] / wall,
          stage_seconds=out.stage_seconds, launches=launches,
          launch_shapes=shapes, draw_launches=draws,
          split_regions_kept=out.n_split_kept, f64_reruns=out.n_f64_reruns,
          reference=reference)
    return bam, fa, out, (launches, shapes), params["n_reads"]


@contextlib.contextmanager
def _environ(env):
    """``env`` (or nothing) set in os.environ for the runs inside."""
    saved = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _cli_run(tmp: str, label: str, bam: str, fa: str, extra=(), env=None):
    """One run through the CLI's main() in this process, the launch counts
    set to 0 just before and read just after (the round draws' into
    DRAW_RUNS[label], the programs' counters, the distinct shapes built, the
    programs cached after the run and the launches made through programs
    into PROGRAM_RUNS[label]).
    With the device programs on, a run that placed every phase problem on
    the card must read no loop flag on the host (``_no_flag_reads``).
    Returns (prefix, CallerOutputs, launches, wall seconds)."""
    from longcallr_tpu_torch import cli
    from longcallr_tpu_torch.phasing import cuda_kernels as CK
    from longcallr_tpu_torch.phasing import graphs as G

    prefix = os.path.join(tmp, label)
    argv = ["-b", bam, "-f", fa, "-o", prefix, "-p", "hifi-masseq",
            "--platform", "cuda", *extra]
    with _environ(env):
        CK.reset_launches()
        G.reset_builds()
        t0 = time.monotonic()
        rc = cli.main(argv)
        wall = time.monotonic() - t0
        launches = dict(CK.LAUNCHES)
        PROGRAM_RUNS[label] = {
            **CK.GRAPHS, "distinct_shapes": len({b["key"] for b in G.BUILDS}),
            "cached_after_run": G.cached(),
            "graph_launches": dict(CK.GRAPH_LAUNCHES)}
        _draws_read(label)
    if rc != 0:
        raise AssertionError(f"{label}: cli.main returned {rc}")
    if G.ENABLED:
        _no_flag_reads(label, PROGRAM_RUNS[label], _placed(cli.LAST_RUN))
    return prefix, cli.LAST_RUN, launches, wall


def _no_flag_reads(label: str, programs: dict, placed: dict) -> None:
    """A run with the device programs on that placed no phase problem on
    the host read no loop flag on the host: every ascent and schedule ran
    as a device program (the giant path's reads-sharded ascent, which no
    CLI run on one card takes, would count its reads here too)."""
    if not placed["host"] and programs["flag_reads"]:
        raise AssertionError(f"{label}: {programs['flag_reads']} host flag "
                             f"reads with the device programs on")


def _program_off_leg(tmp: str, label: str, bam: str, fa: str, extra, env,
                     on, reference: str, check_at=None) -> dict:
    """The run ``label`` of _cli_run (``on``: its prefix, launches and
    launch shapes) once more with the device programs off: the same
    bytes, tags, launch census and draws, held to the JAX package's
    digests of ``reference``; no program ran, and its host flag reads
    equal the set-condition launches the programs made in the run with
    them (PROGRAM_RUNS[label]). That run must have built one program per
    distinct shape, freed them all at its end and launched both kernels
    through them. Returns the off run's numbers."""
    from longcallr_tpu_torch.phasing import graphs as G

    G.ENABLED = False
    try:
        prefix, out, launches, wall = _cli_run(tmp, f"{label}_off", bam, fa,
                                               extra, env)
    finally:
        G.ENABLED = True
    shapes = _launched_shapes(f"{label}, programs off", check_at=check_at)
    _must_equal(f"{label}: programs off vs on", _payloads(prefix),
                _payloads(on[0]))
    if _records_and_tags(prefix) != _records_and_tags(on[0]):
        raise AssertionError(f"{label}: records or tags differ off vs on")
    a, b = PROGRAM_RUNS[f"{label}_off"], PROGRAM_RUNS[label]
    if (launches, shapes) != tuple(on[1:]) or \
            DRAW_RUNS[f"{label}_off"] != DRAW_RUNS[label] or \
            a["launches"] or a["builds"] or not b["condition_sets"] or \
            a["flag_reads"] != b["condition_sets"] or \
            b["builds"] != b["distinct_shapes"] or b["cached_after_run"] or \
            not all(b["graph_launches"][n] > 0 for n in KERNEL_NAMES):
        raise AssertionError(f"{label}: programs off {a}, launches "
                             f"{launches}; on {b}, launches {on[1]}")
    return {"wall_seconds": wall,
            "region_phase": out.stage_seconds.get("region_phase"),
            "flag_reads": a["flag_reads"], "equal": True,
            "reference": _hold_to_reference(f"{label}, programs off",
                                            reference, prefix)}


def _must_equal(what: str, a, b) -> None:
    if a != b:
        raise AssertionError(f"{what}: VCF bytes equal {a[0] == b[0]}, "
                             f"phased-BAM payload equal {a[1] == b[1]}")


ALL_HOST = 1 << 62


@contextlib.contextmanager
def _router(threshold):
    """The placement thresholds of utils/device.py set for the runs inside:
    0 places everything on the run's device, ALL_HOST every candidate call
    and iterative phase problem on the host and every enumeration phase
    problem in float64 on the card, None leaves the defaults."""
    from longcallr_tpu_torch.utils import device as D

    saved = D.MIN_ACCEL_PHASE_WORK, D.MIN_ACCEL_CELLS
    if threshold is not None:
        D.MIN_ACCEL_PHASE_WORK = D.MIN_ACCEL_CELLS = threshold
    try:
        yield
    finally:
        D.MIN_ACCEL_PHASE_WORK, D.MIN_ACCEL_CELLS = saved


def _placed(out) -> dict:
    """Phase problems of one run by where the router placed them."""
    return {"host": int(out.stage_seconds.get("phase_host_placed", 0)),
            "card": int(out.stage_seconds.get("phase_card_placed", 0)),
            "card_f64": int(out.stage_seconds.get("phase_card_f64_placed", 0)),
            "degraded": out.n_degraded_placements}


def _all_on_card(what: str, out) -> dict:
    placed = _placed(out)
    if placed["host"] or placed["card"] <= 0:
        raise AssertionError(f"{what}: with the default thresholds every "
                             f"phase problem belongs on the card: {placed}")
    return placed


@contextlib.contextmanager
def _forced_split():
    """Split mode forced, as LONGCALLR_F32_KERNELS=1 sets it when the
    package is imported. The safety net then recomputes nothing."""
    from longcallr_tpu_torch.phasing import optimize as O

    saved = O.USE_F32_KERNELS
    O.USE_F32_KERNELS = True
    try:
        yield
    finally:
        O.USE_F32_KERNELS = saved


def _enum_input(tmp: str, label: str):
    """The enumeration input ``label`` of goldens.ENUM_INPUTS ("enum": run
    (g), twelve loci of four SNPs; "enum_deep": run (i); "transcriptome"):
    (bam, fasta, the generator's parameters)."""
    from longcallr_tpu_torch.utils.bench_workload import make_genome_workload
    from longcallr_tpu_torch.utils.goldens import ENUM_INPUTS

    bam = os.path.join(tmp, f"{label}.bam")
    fa = os.path.join(tmp, f"{label}.fa")
    return bam, fa, make_genome_workload(bam, fa, **ENUM_INPUTS[label])


def _enum_workload(tmp: str, tag: str, label: str):
    """An enumeration workload four ways: batched and --no-batched, as the
    caller resolves the mode and in forced split mode (where no region is
    recomputed in f64, so the bytes are those of the kernels'
    members-per-table form). All four must write the same bytes, the JAX
    package's digests of ``label``, at least one enumeration bucket must
    form, and both kernels must be launched, at shapes that phase_kernels
    checked. Returns (the result for the phase line, [(launches, launch
    shapes) batched, the same per region])."""
    ebam, efa, eparams = _enum_input(tmp, label)
    np_, nout, nlaunch, nwall = _cli_run(tmp, f"{label}_batched", ebam, efa)
    nshapes = _launched_shapes(f"{tag} enumeration workload, batched")
    np2, nout2, nlaunch2, nwall2 = _cli_run(tmp, f"{label}_per_region", ebam,
                                            efa, extra=["--no-batched"])
    nshapes2 = _launched_shapes(f"{tag} enumeration workload, per-region loop")
    ncensus = _census(nout.stage_seconds)
    if ncensus["phase_enum_buckets"] < 1:
        raise AssertionError(f"{tag} no enumeration bucket: {ncensus}")
    for name in KERNEL_NAMES:
        if nlaunch[name] <= 0 or nlaunch2[name] <= 0:
            raise AssertionError(f"{tag} kernel {name} was not launched")
    _must_equal(f"{tag} enumeration workload, batched vs --no-batched",
                _payloads(np_), _payloads(np2))
    reference = _hold_to_reference(f"{tag} enumeration workload", label, np_)
    off = _program_off_leg(tmp, f"{label}_batched", ebam, efa, (), None,
                           (np_, nlaunch, nshapes), label)
    with _forced_split():
        sp, sout, slaunch, _ = _cli_run(tmp, f"{label}_batched_split", ebam,
                                        efa)
        sshapes = _launched_shapes(f"{tag} forced split, batched")
        sp2, sout2, slaunch2, _ = _cli_run(tmp, f"{label}_per_region_split",
                                           ebam, efa, extra=["--no-batched"])
        _launched_shapes(f"{tag} forced split, per-region loop")
    scensus = _census(sout.stage_seconds)
    if (scensus["phase_enum_buckets"] < 1 or scensus["phase_safety_recompute"]
            or sout.n_f64_reruns or sout2.n_f64_reruns):
        raise AssertionError(f"{tag} forced split mode recomputed in f64 or "
                             f"made no enumeration bucket: {scensus}, "
                             f"{sout.n_f64_reruns}, {sout2.n_f64_reruns}")
    for name in KERNEL_NAMES:
        if slaunch[name] <= 0 or slaunch2[name] <= 0:
            raise AssertionError(f"{tag} forced split: {name} not launched")
    _must_equal(f"{tag} forced split mode, batched vs --no-batched",
                _payloads(sp), _payloads(sp2))
    res = {
        "reads": eparams["n_reads"], "regions": nout.n_regions,
        "records": nout.n_records, "equal": True, "census": ncensus,
        "reference": reference,
        "batched": {"wall_seconds": nwall, "launches": nlaunch,
                    "launch_shapes": nshapes,
                    "region_phase": nout.stage_seconds.get("region_phase"),
                    "programs": PROGRAM_RUNS[f"{label}_batched"]},
        "batched_program_off": off,
        "per_region": {"wall_seconds": nwall2, "launches": nlaunch2,
                       "launch_shapes": nshapes2,
                       "region_phase":
                           nout2.stage_seconds.get("region_phase")},
        "forced_split": {"equal": True, "census": scensus,
                         "launches": slaunch, "launch_shapes": sshapes,
                         "launches_per_region": slaunch2,
                         "f64_reruns": sout.n_f64_reruns,
                         "equal_to_default_mode":
                             _payloads(sp) == _payloads(np_)}}
    return res, [(nlaunch, nshapes), (nlaunch2, nshapes2)]


def _phase_times(wall: float, out) -> dict:
    """What phase mesh prints beside a run: its wall, region_phase and
    phase_fused."""
    return {"wall_seconds": wall,
            "region_phase": out.stage_seconds.get("region_phase"),
            "phase_fused": out.stage_seconds.get("phase_fused")}


def phase_batched(card: str, tmp: str, bam: str, fa: str, per_region_out,
                  n_reads: int, notes: dict):
    """The batched pipeline on the card: (a) the deep input with no
    --batched flag, held against the per-region run (b) of phase_deep;
    (d) the genome workload both ways, with the device peak and the bytes
    its programs held, and batched once more with every program but the
    last freed after each call (a budget of one byte), byte-equal; (e) the
    deep input in >= 3 waves
    with the write overlap on; (f) the deep input as one wave, with the
    peak of the device memory; (h) the same with the finalize fan-out on;
    (g) and (i) two enumeration workloads (``_enum_workload``). After each
    run whose launches the kernel summary reports, the shapes of those
    launches must be shapes that phase_kernels checked. Returns (launch
    counts, launch shapes) by run; ``notes`` gets the times of (a), (f)
    and (i) for phase mesh."""
    from longcallr_tpu_torch.phasing import graphs as G
    from longcallr_tpu_torch.utils.bench_workload import make_genome_workload

    # (a) AUTO resolves to the batched pipeline for the deep input's regions
    prefix, out, launches, wall = _cli_run(tmp, "deep_batched", bam, fa)
    shapes = _launched_shapes("(a) deep input, batched")
    stage = out.stage_seconds
    census = _census(stage)
    if census["phase_buckets"] + census["phase_enum_buckets"] <= 0:
        raise AssertionError("the default CLI run did not take the batched "
                             "pipeline")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched by the "
                                 f"batched main path")
    _draws_read("deep_batched", must=True)
    if PROGRAM_RUNS["deep_batched"]["condition_sets"] <= 0:
        raise AssertionError("the batched main path ran no device program")
    want = _payloads(per_region_out.vcf_path[:-len(".vcf")])
    got = _payloads(prefix)
    _must_equal("(b) batched vs --no-batched, deep input", got, want)
    a_off = _program_off_leg(tmp, "deep_batched", bam, fa, (), None,
                             (prefix, launches, shapes), "deep")
    res = {"a_deep_batched": {
        "regions": out.n_regions, "records": out.n_records,
        "wall_seconds": wall, "reads_per_second": n_reads / wall,
        "launches": launches, "launch_shapes": shapes, "census": census,
        "draws": DRAW_RUNS["deep_batched"],
        "placed": _all_on_card("(a) deep input, batched", out),
        "stage_seconds": stage, "split_regions_kept": out.n_split_kept,
        "f64_reruns": out.n_f64_reruns,
        "reference": _hold_to_reference("(a) deep input, batched", "deep",
                                        prefix), "program_off": a_off},
        "b_equal_to_per_region": True}
    notes["a"] = _phase_times(wall, out)

    # (d) the genome workload: 3 contigs, 8 loci, one 300x locus
    gbam, gfa = os.path.join(tmp, "genome.bam"), os.path.join(tmp, "genome.fa")
    gparams = make_genome_workload(gbam, gfa)
    G.reset_builds()
    torch.cuda.synchronize()
    gheld = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    gp, gout, glaunch, gwall = _cli_run(tmp, "genome_batched", gbam, gfa)
    gpeak = torch.cuda.max_memory_allocated() - gheld
    gprograms = _program_counts()
    cuda = torch.device("cuda", torch.cuda.current_device())
    gshapes = _launched_shapes("(d) genome workload", check_at=cuda)
    goff = _program_off_leg(tmp, "genome_batched", gbam, gfa, (), None,
                            (gp, glaunch, gshapes), "genome", cuda)
    # the same with a budget of one byte for the programs held: every other
    # program is freed after each call (graphs._trim), and the next call of
    # its shape builds it anew
    budget = G._budget
    G._budget = lambda: 1
    try:
        ep_, eout_, _, ewall_ = _cli_run(tmp, "genome_evicting", gbam, gfa)
    finally:
        G._budget = budget
    evicting = dict(PROGRAM_RUNS["genome_evicting"])
    _must_equal("(d) genome workload, programs freed beyond a budget",
                _payloads(ep_), _payloads(gp))
    if gprograms["evicted"] or (gprograms["distinct_shapes"] > 1
                                and evicting["evicted"] <= 0):
        raise AssertionError(f"(d) evictions: {gprograms}, {evicting}")
    gp2, gout2, glaunch2, gwall2 = _cli_run(tmp, "genome_per_region", gbam,
                                            gfa, extra=["--no-batched"])
    _must_equal("(d) genome workload, batched vs --no-batched",
                _payloads(gp), _payloads(gp2))
    if gout.n_records <= 0:
        raise AssertionError("the genome run wrote no records")
    res["d_genome"] = {
        "reads": gparams["n_reads"], "regions": gout.n_regions,
        "records": gout.n_records, "equal": True,
        "reference": _hold_to_reference("(d) genome workload", "genome", gp),
        "batched": {"wall_seconds": gwall, "launches": glaunch,
                    "census": _census(gout.stage_seconds),
                    "region_phase": gout.stage_seconds.get("region_phase"),
                    "peak_device_bytes": gpeak, "programs": gprograms},
        "batched_program_off": goff,
        "programs_beyond_a_budget_of_one_byte": {
            "wall_seconds": ewall_, "equal": True, "programs": evicting,
            "region_phase": eout_.stage_seconds.get("region_phase")},
        "per_region": {"wall_seconds": gwall2, "launches": glaunch2,
                       "region_phase":
                           gout2.stage_seconds.get("region_phase")}}

    # (e) the deep input in waves of one region, write overlap on
    ep, eout, elaunch, ewall = _cli_run(
        tmp, "deep_waves", bam, fa,
        env={"LONGCALLR_WAVE_CELLS": "1", "LONGCALLR_WAVE_OVERLAP": "1",
             "LONGCALLR_RESIDENT_WRITE_OVERLAP": "1"})
    ecensus = _census(eout.stage_seconds)
    if ecensus["phase_buckets"] < 3:
        raise AssertionError(f"(e) expected >= 3 waves, got "
                             f"{ecensus['phase_buckets']} buckets")
    if "phased_bam_bg" not in eout.stage_seconds:
        raise AssertionError("(e) the write overlap did not run")
    _must_equal("(e) deep input in waves vs one wave", _payloads(ep), got)
    res["e_deep_waves"] = {"waves": ecensus["phase_buckets"],
                           "wall_seconds": ewall, "launches": elaunch,
                           "stage_seconds": eout.stage_seconds,
                           "equal": True}

    # (f) the deep input as one wave: its four regions share one bucket;
    # the peak of the device memory over the whole run bounds the bucket's
    one_wave = {"LONGCALLR_WAVE_CELLS": str(1 << 40)}
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fp, fout, flaunch, fwall = _cli_run(tmp, "deep_one_wave", bam, fa,
                                        env=one_wave)
    peak = torch.cuda.max_memory_allocated() - held
    fshapes = _launched_shapes("(f) deep input, one wave")
    fcensus = _census(fout.stage_seconds)
    if fcensus["phase_buckets"] != 1:
        raise AssertionError(f"(f) expected one bucket, got {fcensus}")
    _must_equal("(f) deep input as one wave vs default waves", _payloads(fp),
                got)
    f_off = _program_off_leg(tmp, "deep_one_wave", bam, fa, (), one_wave,
                             (fp, flaunch, fshapes), "deep_one_wave")
    notes["f"] = _phase_times(fwall, fout)
    cells = DEEP_BUCKET[0] * DEEP_BUCKET[1] * DEEP_BUCKET[2]
    res["f_deep_one_wave"] = {"wall_seconds": fwall, "launches": flaunch,
                              "launch_shapes": fshapes, "census": fcensus,
                              "stage_seconds": fout.stage_seconds,
                              "peak_device_bytes": peak,
                              "bucket_cells": cells,
                              "peak_bytes_per_cell": peak / cells,
                              "reference": _hold_to_reference(
                                  "(f) deep input, one wave",
                                  "deep_one_wave", fp),
                              "program_off": f_off, "equal": True}

    # (h) the same wave with the finalize of its four regions on threads
    hp, hout, hlaunch, hwall = _cli_run(
        tmp, "deep_fan_out", bam, fa,
        env=dict(one_wave, LONGCALLR_FINALIZE_MT_CELLS="1"))
    _must_equal("(h) finalize fan-out vs serial finalize", _payloads(hp), got)
    res["h_deep_finalize_fan_out"] = {"wall_seconds": hwall,
                                      "stage_seconds": hout.stage_seconds,
                                      "equal": True}

    # (g) twelve loci of four SNPs: enumeration buckets, regions x configs
    # (with the placement off: at its default (g)'s bucket and (i)'s 6-SNP
    # regions are of host size; phase_placement runs (g) at the default)
    with _router(0):
        res["g_enum"], enum_runs = _enum_workload(tmp, "(g)", "enum")
        # (i) four loci of 6 SNPs and four of 10 SNPs, 432 and 510 reads
        # each: tables of (512, 8) with 64 configs, of (512, 16) with 1,024
        res["i_enum_deep"], enum_deep_runs = _enum_workload(
            tmp, "(i)", "enum_deep")
    for shape in (ENUM6_BUCKET, ENUM10_BUCKET):
        if list(_launch_key(shape)) not in enum_deep_runs[0][1][
                "dual_matvec_rows"]:
            raise AssertionError(f"(i) the batched run did not launch at "
                                 f"{_launch_key(shape)}")
    notes["i"] = {k: res["i_enum_deep"]["batched"][k]
                  for k in ("wall_seconds", "region_phase")}
    _emit("batched", card, **res)
    return {"batched": (launches, shapes),
            "one_wave": (flaunch, fshapes), "enum": enum_runs[0],
            "enum_per_region": enum_runs[1], "enum_deep": enum_deep_runs[0],
            "enum_deep_per_region": enum_deep_runs[1]}


# runs of the CLI in one fresh process (argv: a JSON list of [label, CLI
# arguments]); after each it prints a line with its label, return code,
# wall, stage seconds and device programs' counters
_F64_CLI = """
import json, sys, time
from longcallr_tpu_torch import cli
from longcallr_tpu_torch.phasing import cuda_kernels as CK
for label, argv in json.loads(sys.argv[1]):
    CK.reset_launches()
    t0 = time.monotonic()
    rc = cli.main(argv)
    print(json.dumps({"leg": label, "rc": rc,
                      "wall_seconds": time.monotonic() - t0,
                      "stage_seconds": cli.LAST_RUN.stage_seconds,
                      "programs": dict(CK.GRAPHS)}), flush=True)
"""


def phase_split_vs_f64(card: str, tmp: str, bam: str, fa: str,
                       per_region_prefix: str):
    """(c) the deep input with LONGCALLR_F32_KERNELS=0 (f64 on the card),
    both runs in one fresh process (the mode is read at import): the
    batched pipeline, and the per-region loop (--no-batched), which is also
    the path every safety-net recompute takes. Both must write the bytes of
    the per-region split run, which the batched split run (a) was held to,
    run their ascents and schedules as device programs (the staged chain's
    in the batched run) and read no loop flag on the host."""
    env = dict(os.environ, LONGCALLR_F32_KERNELS="0")
    want = _payloads(per_region_prefix)
    legs = [[label, ["-b", bam, "-f", fa, "-o",
                     os.path.join(tmp, f"deep_f64_{label}"), "-p",
                     "hifi-masseq", "--platform", "cuda", *extra]]
            for label, extra in (("batched", []),
                                 ("per_region", ["--no-batched"]))]
    t0 = time.monotonic()
    res = subprocess.run([sys.executable, "-c", _F64_CLI, json.dumps(legs)],
                         cwd=HERE, env=env, capture_output=True, text=True,
                         timeout=900)
    reports = [json.loads(l) for l in res.stdout.splitlines()
               if l.startswith('{"leg"')]
    if res.returncode != 0 or len(reports) != len(legs) or \
            any(r["rc"] for r in reports):
        raise AssertionError(f"f64 runs failed ({res.returncode}):\n"
                             f"{res.stderr[-3000:]}")
    done = {"process_seconds": time.monotonic() - t0}
    for (label, argv), rep in zip(legs, reports):
        _must_equal(f"(c) split vs f64, {label}", _payloads(argv[5]), want)
        st = rep["stage_seconds"]
        placed = {"host": int(st.get("phase_host_placed", 0)),
                  "card": int(st.get("phase_card_placed", 0))}
        _no_flag_reads(f"(c) f64, {label}", rep["programs"], placed)
        if not rep["programs"]["condition_sets"]:
            raise AssertionError(f"(c) f64, {label}: no device program ran")
        done[label] = {"byte_equal": True, "placed": placed,
                       **{k: rep[k] for k in ("wall_seconds", "programs",
                                              "stage_seconds")}}
    _emit("split_vs_f64", card, **done)


class _RssPeak:
    """Peak of this process's resident set while the block runs (bytes),
    sampled every 20 ms from /proc/self/statm, beside the value at entry."""

    def __enter__(self):
        self._page = os.sysconf("SC_PAGE_SIZE")
        self.start = self.peak = self._now()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._watch, daemon=True)
        self._thread.start()
        return self

    def _now(self) -> int:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * self._page

    def _watch(self) -> None:
        while not self._stop.wait(0.02):
            self.peak = max(self.peak, self._now())

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=10)
        self.peak = max(self.peak, self._now())


@contextlib.contextmanager
def _device_peak_per_contig(peaks: list):
    """Appends to ``peaks`` the peak of allocated device memory over each
    contig of a stream: run_streaming ends every contig with
    malloc_tune.trim(), where the peak is read and reset."""
    from longcallr_tpu_torch.utils import malloc_tune

    orig = malloc_tune.trim

    def trim_and_read():
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        return orig()

    malloc_tune.trim = trim_and_read
    try:
        yield
    finally:
        malloc_tune.trim = orig


# loci per contig of the stream input (the JAX package's bench: 13)
STREAM_LOCI = 13
STREAM_STAGES = ("window_load", "discovery", "bam_emit", "bam_write_drain")


def phase_stream(card: str, tmp: str, notes: dict):
    """The bench's stream input through the CLI with --stream and with
    --no-stream, at the default placement thresholds. ``notes`` gets the
    resident leg's wall and reads/s for phase mesh."""
    from longcallr_tpu_torch.utils import malloc_tune
    from longcallr_tpu_torch.utils.bench_workload import make_genome_workload

    bam = os.path.join(tmp, "stream.bam")
    fa = os.path.join(tmp, "stream.fa")
    spec = [(f"chr{i + 1}", [(40_000, 120, 200)] * STREAM_LOCI)
            for i in range(5)]
    t0 = time.monotonic()
    params = make_genome_workload(bam, fa, contigs=spec)
    gen_s = time.monotonic() - t0
    legs, runs = {}, {}
    for label, flag in (("stream", "--stream"), ("resident", "--no-stream")):
        gc.collect()
        malloc_tune.trim()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        peaks = []
        with _RssPeak() as rss, _device_peak_per_contig(peaks):
            prefix, out, launches, wall = _cli_run(
                tmp, f"stream_{label}", bam, fa, extra=[flag, "-t", "8"])
        run_peak = torch.cuda.max_memory_allocated()
        shapes = _launched_shapes(f"stream input, {flag}")
        for name, n in launches.items():
            if n <= 0:
                raise AssertionError(f"stream input, {flag}: kernel {name} "
                                     f"was not launched")
        _draws_read(f"stream_{label}", must=True)
        if out.n_records <= 0 or out.n_regions != 5 * STREAM_LOCI:
            raise AssertionError(f"stream input, {flag}: {out.n_regions} "
                                 f"regions, {out.n_records} records")
        st = out.stage_seconds
        streamed = all(k in st for k in STREAM_STAGES[:3])
        if streamed != (label == "stream"):
            raise AssertionError(f"{flag}: the stream's stages are "
                                 f"{'missing' if label == 'stream' else 'there'}")
        legs[label] = {
            "wall_seconds": wall, "reads_per_second": params["n_reads"] / wall,
            "regions": out.n_regions, "records": out.n_records,
            "launches": launches, "launch_shapes": shapes,
            "draws": DRAW_RUNS[f"stream_{label}"], "census": _census(st),
            "placed": _all_on_card(f"stream input, {flag}", out),
            "stage_seconds": st, "split_regions_kept": out.n_split_kept,
            "f64_reruns": out.n_f64_reruns,
            "host_rss_start_bytes": rss.start, "host_rss_peak_bytes": rss.peak,
            "host_rss_growth_bytes": rss.peak - rss.start,
            "device_bytes_held_before": held,
            "device_peak_bytes": max(peaks + [run_peak]),
            "reference": _hold_to_reference(f"stream input, {flag}",
                                            "stream", prefix)}
        if label == "stream":
            if len(peaks) != 5:
                raise AssertionError(f"expected 5 contigs, saw {len(peaks)}")
            legs[label]["device_peak_bytes_per_contig"] = peaks
            # a contig's peak is its largest bucket plus whatever the next
            # wave has prepared meanwhile; growth with the contigs would
            # show as a multiple
            if max(peaks) > 2 * min(peaks):
                raise AssertionError(f"the device peak grows with the "
                                     f"contigs: {peaks}")
        runs[label] = (prefix, (launches, shapes))
        if label == "resident":
            legs[label]["program_off"] = _program_off_leg(
                tmp, "stream_resident", bam, fa, ["--no-stream", "-t", "8"],
                None, (prefix, launches, shapes), "stream")
    _must_equal("stream vs resident, stream input",
                _payloads(runs["stream"][0]), _payloads(runs["resident"][0]))
    for shape in (STREAM_WAVE, STREAM_TAIL):
        if list(_launch_key(shape)) not in runs["stream"][1][1][
                "dual_matvec_rows"]:
            raise AssertionError(f"the stream did not launch at "
                                 f"{_launch_key(shape)}")
    notes["stream_resident"] = {
        k: legs["resident"][k] for k in ("wall_seconds", "reads_per_second")}
    _emit("stream", card, reads=params["n_reads"], contigs=5,
          loci_per_contig=STREAM_LOCI, threads=8, generate_seconds=gen_s,
          equal=True, **legs)
    return ({"stream": runs["stream"][1],
             "stream_resident": runs["resident"][1]},
            (bam, fa, params["n_reads"], runs["stream"][0]))


def phase_resume(card: str, tmp: str) -> None:
    """--resume through the CLI on the genome workload, resident and
    --stream: first run, rerun (every region skipped, no kernel launched),
    rerun on a checkpoint cut to its header and first half (the rest is
    recomputed). All write the bytes of a run without a checkpoint."""
    from longcallr_tpu_torch.utils.bench_workload import make_genome_workload

    gbam, gfa = os.path.join(tmp, "genome.bam"), os.path.join(tmp, "genome.fa")
    make_genome_workload(gbam, gfa)
    want = _payloads(_cli_run(tmp, "resume_none", gbam, gfa)[0])
    done = {}
    for mode, flags in (("resident", ["--resume"]),
                        ("stream", ["--resume", "--stream"])):
        label = f"resume_{mode}"
        ckpt = os.path.join(tmp, label + ".regions.ckpt")
        steps = []
        for step in ("first", "rerun", "cut"):
            if step == "cut":
                with open(ckpt) as f:
                    lines = f.readlines()
                keep = 1 + (len(lines) - 1) // 2
                with open(ckpt, "w") as f:
                    f.writelines(lines[:keep])
            prefix, out, launches, wall = _cli_run(tmp, label, gbam, gfa,
                                                   extra=flags)
            _must_equal(f"--resume {mode}, {step}", _payloads(prefix), want)
            placed = _placed(out)
            n_placed = placed["host"] + placed["card"] + placed["card_f64"]
            if step == "rerun" and (any(launches.values()) or n_placed):
                raise AssertionError(f"--resume {mode}: the rerun recomputed "
                                     f"({launches}, {placed})")
            if step != "rerun" and not n_placed or \
                    step == "first" and not all(launches.values()):
                raise AssertionError(f"--resume {mode}, {step}: nothing was "
                                     f"computed ({launches}, {placed})")
            with open(ckpt) as f:
                n_lines = len(f.readlines())
            if n_lines != 1 + out.n_regions:
                raise AssertionError(f"--resume {mode}, {step}: checkpoint "
                                     f"has {n_lines} lines for "
                                     f"{out.n_regions} regions")
            steps.append({"step": step, "wall_seconds": wall,
                          "launches": launches, "placed": placed,
                          "regions": out.n_regions,
                          "checkpoint_lines": n_lines})
        n_of = lambda st: sum(st["placed"][k] for k in ("host", "card",
                                                          "card_f64"))
        if not n_of(steps[2]) < n_of(steps[0]):
            raise AssertionError(f"--resume {mode}: the cut checkpoint's run "
                                 f"recomputed everything: {steps}")
        done[mode] = steps
    _emit("resume", card, equal=True, **done)


def phase_placement(card: str, dev, tmp: str) -> None:
    """The sweep's crossing points beside the defaults; then the
    enumeration workload (g) and the preset goldens with the router at its
    default, off and all-host: the same bytes each way."""
    from longcallr_tpu_torch.pipeline.caller import run
    from longcallr_tpu_torch.utils import device as D
    from longcallr_tpu_torch.utils import goldens

    t0 = time.monotonic()
    res = subprocess.run(
        [sys.executable, os.path.join(HERE, "experiments",
                                      "torch_placement_sweep.py"), "--quick"],
        cwd=HERE, capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise AssertionError(f"the placement sweep failed "
                             f"({res.returncode}):\n{res.stderr[-3000:]}")
    rows = [json.loads(l) for l in res.stdout.splitlines() if l.startswith("{")]
    sweep = {"seconds": time.monotonic() - t0,
             "crossings": rows[-1]["crossings"],
             "rows": [{k: r[k] for k in ("family", "label", "size", "card_s",
                                         "host_s")} for r in rows[:-1]]}

    settings = (("default", None), ("off", 0), ("all_host", ALL_HOST))
    ebam, efa, _ = _enum_input(tmp, "enum")
    enum, first = {}, None
    for name, value in settings:
        with _router(value):
            prefix, out, launches, wall = _cli_run(tmp, f"placed_{name}",
                                                   ebam, efa)
        got = _payloads(prefix)
        first = first or got
        _must_equal(f"enumeration workload, router {name} vs default", got,
                    first)
        enum[name] = {"placed": _placed(out), "launches": launches,
                      "wall_seconds": wall, "census": _census(out.stage_seconds),
                      "region_phase": out.stage_seconds.get("region_phase")}
    # all-host: the enumeration workload's problems run in float64 on the
    # card, which launches no hand kernel
    if any(enum["all_host"]["launches"].values()) \
            or enum["all_host"]["placed"]["card"] \
            or enum["all_host"]["placed"]["host"] \
            or not enum["all_host"]["placed"]["card_f64"]:
        raise AssertionError(f"all-host launched a kernel or left the "
                             f"float64 route: {enum['all_host']}")
    if not all(enum["off"]["launches"].values()) \
            or enum["off"]["placed"]["host"]:
        raise AssertionError(f"router off left the card: {enum['off']}")

    golden = []
    for gname in goldens.GOLDEN_NAMES:
        for name, value in settings:
            bam, fa, cfg, anno = goldens.golden_workload(gname, tmp)
            with _router(value):
                out = run(bam, fa, os.path.join(tmp, f"placed_{gname}_{name}"),
                          cfg, anno_path=anno, device=dev)
            if goldens.records_and_tags(out.vcf_path, out.phased_bam_path) \
                    != goldens.golden(gname):
                raise AssertionError(f"golden {gname} differs with the router "
                                     f"{name}")
            golden.append({"workload": gname, "router": name,
                           "byte_equal": True, "placed": _placed(out)})
    _emit("placement", card, min_phase_work=D.MIN_ACCEL_PHASE_WORK,
          min_cells=D.MIN_ACCEL_CELLS, sweep=sweep, enum_workload=enum,
          goldens=golden)


def phase_analysis(card: str, dev, tmp: str) -> None:
    """ASE and ASJ in this process, after CUDA is initialised: the fork gate
    is closed, the tables are written with threads=4 and equal the tables
    of threads=1."""
    from longcallr_tpu_torch.analysis import ase, asj
    from longcallr_tpu_torch.config import preset
    from longcallr_tpu_torch.pipeline.caller import run
    from longcallr_tpu_torch.utils.simulate import (make_reference, plant_snps,
                                                    simulate_bam)

    if not torch.cuda.is_initialized():
        raise AssertionError("CUDA is not initialised in this process")
    if ase.FORK_POOL is not None or ase._fork_pool_ok():
        raise AssertionError("the fork gate is open with CUDA initialised")
    rng = np.random.default_rng(20261018)
    ref = make_reference(rng, 12000)
    truth = plant_snps(rng, ref, n_het=14, n_hom=2, min_gap=500)
    bam = os.path.join(tmp, "analysis.bam")
    simulate_bam(bam, rng, ref, truth, n_reads=240, read_len=3000,
                 err_rate=0.01, with_introns=True)
    fa = bam.replace(".bam", ".fa")
    out = run(bam, fa, os.path.join(tmp, "analysis"),
              preset("hifi-masseq").replace(min_read_length=100), device=dev)
    gtf = os.path.join(tmp, "analysis.gtf")
    with open(gtf, "w") as f:
        for gid, s, e, exons in (("G1", 1, 6000, [(1, 2000), (2600, 6000)]),
                                 ("G2", 6001, 12000, [(6001, 12000)])):
            attrs = (f'gene_id "{gid}"; gene_type "protein_coding"; '
                     f'gene_name "GENE{gid[1:]}";')
            f.write(f"chrS\thv\tgene\t{s}\t{e}\t.\t+\t.\t{attrs}\n")
            for es, ee in exons:
                f.write(f'chrS\thv\texon\t{es}\t{ee}\t.\t+\t.\t{attrs} '
                        f'transcript_id "{gid}.t1";\n')
    saved, ase.ASE_CHUNK_MIN = ase.ASE_CHUNK_MIN, 8   # several chunks at 4
    tables = {}
    try:
        for threads in (4, 1):
            prefix = os.path.join(tmp, f"analysis_t{threads}")
            ase.analyze_ase_genes(gtf, out.phased_bam_path,
                                  prefix + ".ase.tsv", threads,
                                  {"protein_coding"}, 5, 0.001)
            # min_count 1: the simulator draws every read's intron anew
            asj.analyze(gtf, out.phased_bam_path, fa, prefix, 1,
                        {"protein_coding"}, threads, False, 0)
            tables[threads] = {}
            for ext in (".ase.tsv", ".asj.tsv", ".asj_gene.tsv",
                        ".gene_coverage.tsv"):
                with open(prefix + ext) as f:
                    tables[threads][ext] = f.read()
    finally:
        ase.ASE_CHUNK_MIN = saved
    if tables[4] != tables[1]:
        raise AssertionError("the tables of threads=4 differ from threads=1")
    n_rows = {ext: t.count("\n") - 1 for ext, t in tables[1].items()}
    if min(n_rows.values()) < 1:
        raise AssertionError(f"empty analysis tables: {n_rows}")
    _emit("analysis", card, fork_pool_ok=False, cuda_initialized=True,
          reads_tagged=out.n_reads_tagged, rows=n_rows,
          equal_to_threads_1=True)


# one process of a pod on the card: the CLI's pod branch with the launch
# counts set to 0 just before and reported just after, as a JSON line
_POD_WORKER = r"""
import json, sys, time
port, pid, n, bam, fa, out, threads, mode = sys.argv[1:9]
from longcallr_tpu_torch import cli
from longcallr_tpu_torch.phasing import cuda_kernels as CK
argv = ["-b", bam, "-f", fa, "-o", out, "-p", "hifi-masseq", "--platform",
        "cuda", "-t", threads, mode, "--coordinator", f"localhost:{port}",
        "--num-processes", n, "--process-id", pid]
CK.reset_launches()
t0 = time.monotonic()
rc = cli.main(argv)
wall = time.monotonic() - t0
res = cli.LAST_RUN
if not isinstance(res, dict):
    res = {"n_records": res.n_records, "n_regions": res.n_regions,
           "stage_seconds": res.stage_seconds}
print(json.dumps({"worker": int(pid), "rc": rc, "caller_wall_seconds": wall,
                  "launches": dict(CK.LAUNCHES),
                  "launch_shapes": {k: sorted(v) for k, v in
                                    CK.LAUNCH_SHAPES.items()},
                  "programs": dict(CK.GRAPHS), "summary": res}), flush=True)
"""


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _pod(tmp: str, label: str, n: int, bam: str, fa: str, threads: int,
         mode: str) -> tuple:
    """``n`` processes of one pod on the card (gloo on localhost), each in
    a fresh interpreter. Returns (wall seconds from the first start to the
    last exit, the workers' JSON reports by process id). Every worker must
    exit 0 within 600 s; one that does not is killed and fails the phase."""
    port = _free_port()
    prefix = os.path.join(tmp, label)
    procs, logs = [], []
    t0 = time.monotonic()
    try:
        for pid in range(n):
            log = open(os.path.join(tmp, f"{label}_{pid}.log"), "w+")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _POD_WORKER, str(port), str(pid),
                 str(n), bam, fa, prefix, str(threads), mode],
                cwd=HERE, stdout=log, stderr=subprocess.STDOUT))
        for p in procs:
            p.wait(timeout=600)
        wall = time.monotonic() - t0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    reports = []
    for pid, (p, log) in enumerate(zip(procs, logs)):
        log.seek(0)
        text = log.read()
        log.close()
        lines = [l for l in text.splitlines() if l.startswith('{"worker"')]
        if p.returncode != 0 or not lines:
            raise AssertionError(f"{label}: process {pid} exited "
                                 f"{p.returncode}:\n{text[-3000:]}")
        rep = json.loads(lines[-1])
        if rep["rc"] != 0:
            raise AssertionError(f"{label}: process {pid}: cli.main "
                                 f"returned {rep['rc']}")
        st = rep["summary"].get("stage_seconds") or {}
        _no_flag_reads(f"{label}: process {pid}", rep["programs"],
                       {"host": int(st.get("phase_host_placed", 0))})
        reports.append(rep)
    return wall, prefix, reports


def _records_and_tags(prefix: str):
    from longcallr_tpu_torch.utils import goldens

    return goldens.records_and_tags(prefix + ".vcf", prefix + ".phased.bam")


def phase_pod(card: str, tmp: str, stream_input) -> dict:
    """The pod on the card: the stream input through the CLI's pod branch
    with --stream, 2 processes of 4 threads sharing the one card, then 1
    process of 8 threads. Process 0's VCF bytes and sorted HP/PS tags must
    equal phase stream's single-process run; every worker must launch both
    kernels, at shapes that phase_kernels checked. Returns (launch counts,
    launch shapes) by worker."""
    bam, fa, n_reads, stream_prefix = stream_input
    with open(stream_prefix + ".vcf", "rb") as f:
        want_vcf = f.read()
    want = _records_and_tags(stream_prefix)
    legs, runs = {}, {}
    for n, threads in ((2, 4), (1, 8)):
        label = f"pod_{n}p"
        wall, prefix, reports = _pod(tmp, label, n, bam, fa, threads,
                                     "--stream")
        with open(prefix + ".vcf", "rb") as f:
            if f.read() != want_vcf:
                raise AssertionError(f"{label}: VCF bytes differ from the "
                                     f"single-process stream run")
        if _records_and_tags(prefix) != want:
            raise AssertionError(f"{label}: HP/PS tags differ")
        workers = []
        for rep in reports:
            pid = rep["worker"]
            for name in KERNEL_NAMES:
                if rep["launches"][name] <= 0:
                    raise AssertionError(f"{label}: process {pid} did not "
                                         f"launch {name}")
            shapes = _launched_shapes(f"{label}, process {pid}",
                                      rep["launch_shapes"])
            runs[f"{label}_p{pid}"] = (rep["launches"], shapes)
            workers.append({"process": pid, "threads": threads,
                            "caller_wall_seconds": rep["caller_wall_seconds"],
                            "launches": rep["launches"],
                            "launch_shapes": shapes,
                            "summary": rep["summary"]})
        if n > 1 and reports[0]["summary"].get("n_retried"):
            raise AssertionError(f"{label}: regions were retried: "
                                 f"{reports[0]['summary']}")
        caller = max(w["caller_wall_seconds"] for w in workers)
        legs[label] = {"processes": n, "wall_seconds": wall,
                       "reads_per_second": n_reads / wall,
                       "caller_wall_seconds": caller,
                       "caller_reads_per_second": n_reads / caller,
                       "workers": workers, "equal_to_stream_run": True}
    ratio = {"wall_1p_over_2p": legs["pod_1p"]["wall_seconds"]
             / legs["pod_2p"]["wall_seconds"],
             "caller_wall_1p_over_2p": legs["pod_1p"]["caller_wall_seconds"]
             / legs["pod_2p"]["caller_wall_seconds"]}
    _emit("pod", card, reads=n_reads, input="stream", scaling=ratio, **legs)
    return runs


def phase_pod_resident(card: str, tmp: str) -> None:
    """The genome workload through the pod branch resident (--no-stream), 2
    processes on the card, byte-equal to a single-process run of it; and
    the pod flags given in part return 2."""
    from longcallr_tpu_torch import cli
    from longcallr_tpu_torch.utils.bench_workload import make_genome_workload

    gbam, gfa = os.path.join(tmp, "genome.bam"), os.path.join(tmp, "genome.fa")
    params = make_genome_workload(gbam, gfa)
    want = _payloads(_cli_run(tmp, "pod_resident_single", gbam, gfa,
                              extra=["--no-stream"])[0])
    wall, prefix, reports = _pod(tmp, "pod_resident", 2, gbam, gfa, 4,
                                 "--no-stream")
    _must_equal("pod, resident, vs a single process", _payloads(prefix), want)
    partial = {}
    for flags in (["--coordinator", "localhost:1"], ["--num-processes", "2"],
                  ["--process-id", "0", "--num-processes", "2"]):
        rc = cli.main(["-b", gbam, "-f", gfa, "-o", prefix + "_partial",
                       "-p", "hifi-masseq", "--platform", "cuda", *flags])
        if rc != 2:
            raise AssertionError(f"pod flags {flags} in part: rc {rc}")
        partial[" ".join(flags)] = rc
    _emit("pod_resident", card, reads=params["n_reads"], processes=2,
          wall_seconds=wall, equal_to_single=True,
          workers=[{k: r[k] for k in ("worker", "caller_wall_seconds",
                                      "launches", "summary")}
                   for r in reports],
          partial_flags_rc=partial)


def _stream_region(bam: str, fa: str, dev, contig: str = "chr1"):
    """The first region of one contig of the stream input, prepared on
    ``dev``: (cfg, region, cands, frags, apply_ds)."""
    from longcallr_tpu_torch.config import preset
    from longcallr_tpu_torch.io.bam import BamFile
    from longcallr_tpu_torch.io.fasta import FastaFile
    from longcallr_tpu_torch.pipeline.caller import build_regions
    from longcallr_tpu_torch.pipeline.engine import prepare_region

    cfg = preset("hifi-masseq")
    fasta = FastaFile(fa)
    clen = dict(fasta.contig_lengths)[contig]
    win = BamFile(bam, threads=4, region=(contig, 0, clen))
    reg = build_regions(win, fasta, cfg, contigs=[contig])[0][0]
    cands, frags, apply_ds = prepare_region(win, reg, fasta.fetch(contig),
                                            cfg, dev)
    return cfg, reg, cands, frags, apply_ds


# the exchange of the reads-sharded ascent (csrc/shard_exchange.cu): its
# check and times (``_exchange_kernel``), read by the kernel summary
EXCHANGE: dict = {}
# the giant locus' legs by label (``_sharded_leg``), for the summary
GIANT_RUNS: dict = {}
# the giant locus: the deep workload's locus shape at 2,500x, whose padded
# cells (K 131,072 x I 512 = 2^26) reach LONGCALLR_GIANT_CELLS
GIANT_COVERAGE = 2500
EXCHANGE_TIMED = 400


def _exchange_widths(I: int) -> dict:
    """The partials the sharded ascent exchanges at I SNP columns: (f64
    words, int64 words) of the prologue's column sums, a trip's dpᵀσ and
    flip count, and the objective."""
    return {"columns": (3 * I, I), "trip": (I, 1), "objective": (1, 0)}


def _exchange_round(CX, box, streams, parts, totals) -> None:
    """Every shard's side of one exchange, each on its own stream."""
    for s, st in enumerate(streams):
        with torch.cuda.stream(st):
            CX.exchange(box, s, *parts[s], *totals[s])


def _exchange_kernel(dev, I: int) -> dict:
    """The exchange kernel against its plain version (``sum_in_order``),
    bit for bit, for 2, 4 and 8 shards on the card at the widths the
    ascent exchanges at I columns (random f64 partials of mixed magnitudes
    and int64 counts; 3 exchanges in a row, so both halves of the buffers
    serve); then the time of one trip's exchange of 2 shards (all shards'
    launches between CUDA events over EXCHANGE_TIMED exchanges), the plain
    sum's, and the bound: bytes / 3.35 TB/s (each shard reads its partial
    once, writes it into every shard's slot, reads every slot once and
    writes its total; the flags written and read)."""
    from longcallr_tpu_torch.phasing import cuda_exchange as CX
    from longcallr_tpu_torch.phasing import cuda_kernels as CK

    rng = np.random.default_rng(20261021)
    err, checked = 0.0, []
    for n in (2, 4, 8):
        for name, (wf, wi) in _exchange_widths(I).items():
            box = CX.ShardExchange([dev] * n, 4 * I)
            streams = [torch.cuda.Stream(dev) for _ in range(n)]
            for _ in range(3):
                parts = [(torch.as_tensor(rng.standard_normal(wf) * 10.0 **
                                          rng.integers(-8, 9, wf),
                                          device=dev),
                          torch.as_tensor(rng.integers(-2**40, 2**40, wi),
                                          device=dev) if wi else None)
                         for _ in range(n)]
                totals = [tuple(None if p is None else torch.empty_like(p)
                                for p in pt) for pt in parts]
                for st in streams:
                    st.wait_stream(torch.cuda.current_stream(dev))
                _exchange_round(CX, box, streams, parts, totals)
                for st in streams:
                    torch.cuda.current_stream(dev).wait_stream(st)
                for k in range(2 if wi else 1):
                    want = CX.sum_in_order([pt[k] for pt in parts], dev)
                    for tot in totals:
                        if not torch.equal(tot[k], want):
                            raise AssertionError(
                                f"shard_exchange {n} shards, {name}: a "
                                f"total differs from sum_in_order")
                        err = max(err, float((tot[k] - want).abs().max()))
            turns = [int(st[1]) for st in box.state]
            if turns != [3] * n:
                raise AssertionError(f"shard_exchange: barrier turns {turns}")
            checked.append([n, name, wf, wi])
    # the time of a trip's exchange of two shards
    n, (wf, wi) = 2, _exchange_widths(I)["trip"]
    box = CX.ShardExchange([dev] * n, 4 * I)
    streams = [torch.cuda.Stream(dev) for _ in range(n)]
    parts = [(torch.randn(wf, dtype=torch.float64, device=dev),
              torch.ones(wi, dtype=torch.int64, device=dev))
             for _ in range(n)]
    totals = [tuple(torch.empty_like(p) for p in pt) for pt in parts]

    def timed(work, reps: int, captured: bool) -> float:
        """Per-turn ms of ``work`` ((stream, fn) pairs, run at once, one
        a stream) between CUDA events; captured (``reps`` calls of fn in
        one graph a stream) it is the device's time, else the host's
        launches are in it."""
        cur = torch.cuda.current_stream(dev)

        def run(go):
            for st, _ in work:
                st.wait_stream(cur)
            for st, x in zip((st for st, _ in work), go):
                with torch.cuda.stream(st):
                    x()
            for st, _ in work:
                cur.wait_stream(st)

        if captured:
            graphs = []
            with CK.recording():            # not launches of the main path
                for st, fn in work:
                    g = torch.cuda.CUDAGraph()
                    st.wait_stream(cur)
                    with torch.cuda.stream(st):
                        g.capture_begin()
                        for _ in range(reps):
                            fn()
                        g.capture_end()
                    graphs.append(g)
            go, calls = [g.replay for g in graphs], 1
        else:
            go, calls = [fn for _, fn in work], reps
        run(go)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        for _ in range(calls):
            run(go)
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps

    sides = [(st, lambda s=s: CX.exchange(box, s, *parts[s], *totals[s]))
             for s, st in enumerate(streams)]
    plain = [(streams[0], lambda: [CX.sum_in_order(
        [pt[k] for pt in parts], dev) for k in range(2)])]
    turn_ms = timed(sides, EXCHANGE_TIMED, captured=False)
    ms = timed(sides, EXCHANGE_TIMED, captured=True)
    plain_ms = timed(plain, EXCHANGE_TIMED, captured=True)
    w = wf + wi
    bound_bytes = n * (w * 8 * (2 + 2 * n) + 2 * n * 8)
    EXCHANGE.update(max_abs_err=err, checked=checked, shards_timed=n,
                    width_timed=[wf, wi], ms=ms, ms_by="CUDA events over "
                    f"{EXCHANGE_TIMED} exchanges captured in one graph a "
                    "shard, the shards' graphs run at once",
                    turn_ms=turn_ms, turn_ms_by="the same launched one by "
                    "one through the wrapper", plain_ms=plain_ms,
                    plain_ms_by="the plain sums of a turn, captured the "
                    "same way", bound_bytes=bound_bytes,
                    bound_ms=bound_bytes / PEAK_BYTES_PER_S * 1e3,
                    bound_by="bytes", library_ms=None)
    return dict(EXCHANGE)


_BOUNDED_WAIT = r"""
import json, os, time
import numpy as np, torch
from longcallr_tpu_torch import _build
from longcallr_tpu_torch.parallel import mesh as M
from longcallr_tpu_torch.phasing import cuda_exchange as CX
from longcallr_tpu_torch.phasing import graphs as G
dev = torch.device("cuda", 0)
r = np.random.default_rng(1)
K, I = 256, 16
p8 = r.choice([-1, 0, 1], size=(K, I)).astype(np.int8)
q8 = r.integers(3, 31, size=(K, I)).astype(np.uint8)
rb, sm = np.ones(K, bool), np.ones(I, bool)
sh = M.shard_cells([dev, dev], p8, q8, rb, sm)
M.sharded_ascent(sh, np.where(r.random(K) < .5, -1., 1.), np.ones(I),
                 np.zeros(I), sm, np.zeros(I, bool), False, True)
group = next(s.prog for k, s in G._CACHE.items() if k[0] == "sharded")
stream = group.streams[0]
out = {"wait_ns": CX.WAIT_NS}
t0 = time.monotonic()
try:
    # shard 0's program alone: shard 1 never arrives at the exchange
    err = _build.load().gp_launch(group.progs[0]._exec, 0,
                                  stream.cuda_stream)
    out["launch_error"] = err
    stream.synchronize()
    out["raised"] = False
except RuntimeError as e:
    out.update(raised=True, error=str(e).splitlines()[0][:200])
out["seconds"] = time.monotonic() - t0
print(json.dumps(out), flush=True)
os._exit(0)
"""


def _bounded_wait() -> dict:
    """A group of which one shard is never launched, in a child process:
    the other shard's exchange waits CX.WAIT_NS of the device clock and
    traps; the child's sync raises, well within the bound plus a margin,
    and the parent reads the error (a hang would meet the parent's
    timeout, and fail)."""
    from longcallr_tpu_torch.phasing import cuda_exchange as CX

    bound_s = CX.WAIT_NS / 1e9
    t0 = time.monotonic()
    res = subprocess.run([sys.executable, "-c", _BOUNDED_WAIT], cwd=HERE,
                         capture_output=True, text=True,
                         timeout=bound_s + 120)
    wall = time.monotonic() - t0
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("{")]
    if not lines:
        raise AssertionError(f"bounded wait: the child printed nothing "
                             f"(rc {res.returncode}): {res.stderr[-800:]}")
    out = json.loads(lines[-1])
    if not out.get("raised") or not out["seconds"] < bound_s + 20:
        raise AssertionError(f"bounded wait: {out}")
    out.update(child_wall_seconds=wall, child_rc=res.returncode)
    return out


def _giant_locus(tmp: str, dev):
    """The giant locus (make_deep_workload(n_regions=1, coverage=2,500))
    prepared on the card: (cfg, region, cands, frags, apply_ds, seconds to
    generate, seconds to prepare)."""
    from longcallr_tpu_torch.utils.bench_workload import make_deep_workload

    bam = os.path.join(tmp, "giant.bam")
    fa = os.path.join(tmp, "giant.fa")
    t0 = time.monotonic()
    params = make_deep_workload(bam, fa, n_regions=1,
                                coverage=GIANT_COVERAGE)
    t1 = time.monotonic()
    locus = _stream_region(bam, fa, dev, contig=params["contig"])
    return (*locus, t1 - t0, time.monotonic() - t1)


def _sharded_leg(label: str, locus, devs, programs: bool):
    """phase_region_sharded of ``locus`` over ``devs`` with the device
    programs on or off: (the state, the leg's numbers). The counters are
    reset just before and read just after; the seconds of the ascents are
    the host's time in sharded_ascent (launch to sync, as region_phase
    counts a region's programs)."""
    from longcallr_tpu_torch.parallel import giant, mesh as M
    from longcallr_tpu_torch.phasing import cuda_exchange as CX
    from longcallr_tpu_torch.phasing import cuda_kernels as CK
    from longcallr_tpu_torch.phasing import graphs as G

    cfg, reg, cands, frags, apply_ds = locus[:5]
    orig, spent = M.sharded_ascent, []

    def timed(*a, **kw):
        t = time.monotonic()
        try:
            return orig(*a, **kw)
        finally:
            spent.append(time.monotonic() - t)

    dev = devs[0]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    CK.reset_launches()
    G.reset_builds()
    G.ENABLED = programs
    M.sharded_ascent = timed
    try:
        t0 = time.monotonic()
        st = giant.phase_region_sharded(frags, cands, cfg, reg.start,
                                        apply_ds, devs)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    finally:
        M.sharded_ascent = orig
        G.ENABLED = True
    n = len(devs)
    leg = dict(shards=n, programs=programs, wall_seconds=wall,
               ascents=len(spent), ascent_seconds=sum(spent),
               builds=CK.GRAPHS["builds"],
               capture_seconds=CK.GRAPHS["capture_seconds"],
               instantiate_seconds=CK.GRAPHS["instantiate_seconds"],
               bytes_held=CK.GRAPHS["bytes_held"],
               device_peak_bytes=torch.cuda.max_memory_allocated(dev),
               device_peak_above_start=torch.cuda.max_memory_allocated(dev)
               - base,
               group_launches=CK.GROUPS["launches"],
               barrier_turns=CK.GROUPS["barrier_turns"],
               exchange_launches=CX.EXCHANGE_LAUNCHES["shard_exchange"],
               body_runs=CK.GRAPHS["body_runs"],
               condition_sets=CK.GRAPHS["condition_sets"],
               flag_reads=CK.GRAPHS["flag_reads"],
               hand_kernel_launches=dict(CK.LAUNCHES),
               cached_after=sum(k[0] == "sharded" for k in G._CACHE))
    if any(CK.LAUNCHES.values()):
        raise AssertionError(f"giant {label}: the sharded ascent launched a "
                             f"hand kernel: {CK.LAUNCHES}")
    if leg["exchange_launches"] <= 0 or leg["cached_after"]:
        raise AssertionError(f"giant {label}: {leg}")
    if programs:
        # no host flag read; each shard's trips in its WHILE node, its
        # barrier turns (checked against its body runs at every launch)
        # as many as its exchange launches
        if (leg["flag_reads"] or leg["group_launches"] != len(spent)
                or leg["builds"] != 2
                or leg["barrier_turns"] != leg["exchange_launches"]
                or leg["condition_sets"] != leg["body_runs"] + n * len(spent)):
            raise AssertionError(f"giant {label}: {leg}")
    elif leg["group_launches"] or leg["builds"] or leg["flag_reads"] <= 0:
        raise AssertionError(f"giant {label}: {leg}")
    return st, leg


def _states_equal(what: str, a, b) -> None:
    for x, y, f in zip(a, b, ("sigma", "delta", "eta")):
        if not np.array_equal(np.asarray(x), np.asarray(y)):
            raise AssertionError(f"{what}: {f} differs")


def phase_giant(card: str, dev, tmp: str, stream_input) -> None:
    """The reads-sharded ascent of giant regions, driven directly (one card
    gives reads_devices no second device), a group of device programs, one
    per shard. The exchange kernel against its plain version
    (``_exchange_kernel``) and the bounded wait (``_bounded_wait``). One
    region of the stream input through phase_region_sharded with [card] x 2
    and x 4 as the "reads" axis, programs on and off, and with 2 CPU
    shards: the same states (bit-equal on against off). One ascent of it
    through sharded_cross_optimize on those meshes: the same decisions,
    prob within 1e-9 relative of the CPU's and bit-equal on against off;
    read_sharded_snp_sums on the card against its CPU run at 1e-12
    relative. The giant locus (K 131,072 x I 512 padded cells = 2^26)
    through phase_region_sharded on [card] x 2 with programs on and off
    (bit-equal states) and on [card] x 4 with programs on, each leg's
    numbers (``_sharded_leg``). The sharded path launches no hand kernel
    (f64 matmul, as in the JAX package). Walls stand beside phase_region's
    on the same inputs (recorded, not judged)."""
    from longcallr_tpu_torch.parallel import giant, mesh as M
    from longcallr_tpu_torch.phasing import cuda_kernels as CK
    from longcallr_tpu_torch.phasing import graphs as G
    from longcallr_tpu_torch.phasing import optimize as O
    from longcallr_tpu_torch.phasing.kernels import make_cell_tables_np

    bound = _bounded_wait()
    bam, fa = stream_input[:2]
    locus = _stream_region(bam, fa, dev)
    cfg, reg, cands, frags, apply_ds = locus
    K0, I0 = frags.p.shape
    K, I_pad = O._bucket(K0), O._bucket(I0)
    cpu = torch.device("cpu")
    meshes = {"card_x2": [dev] * 2, "card_x4": [dev] * 4, "cpu_x2": [cpu] * 2}
    states, walls, legs = {}, {}, {}
    for name, devs in meshes.items():
        on_card = devs[0].type == "cuda"
        for programs in ((True, False) if on_card else (True,)):
            label = name if programs else f"{name}_off"
            if on_card:
                states[label], legs[label] = _sharded_leg(
                    f"stream region {label}", locus, devs, programs)
                walls[label] = legs[label]["wall_seconds"]
                continue
            t0 = time.monotonic()
            states[label] = giant.phase_region_sharded(
                frags, cands, cfg, reg.start, apply_ds, devs)
            walls[label] = time.monotonic() - t0
    for name in ("card_x2", "card_x4"):
        _states_equal(f"giant {name}, programs on against off",
                      states[name], states[f"{name}_off"])
        _states_equal(f"giant {name} against the CPU shards", states[name],
                      states["cpu_x2"])

    # one ascent, with its objective, on each mesh (programs on and off)
    rng = np.random.default_rng(20261019)
    p8 = np.zeros((K, I_pad), np.int8)
    q8 = np.zeros((K, I_pad), np.uint8)
    p8[:K0, :I0], q8[:K0, :I0] = frags.p, frags.baseq
    rb = np.zeros(K, bool)
    rb[:K0] = frags.for_phasing
    sm = np.zeros(I_pad, bool)
    sm[:I0] = cands.for_phasing
    sigma0 = np.where(rb, rng.choice([-1.0, 1.0], K), 0.0)
    delta0 = rng.choice([-1.0, 1.0], I_pad)
    eta0 = np.zeros(I_pad)
    cons = np.zeros(I_pad, bool)
    asc = {}
    for label in states:
        G.ENABLED = not label.endswith("_off")
        try:
            fn = M.sharded_cross_optimize(meshes[label.replace("_off", "")],
                                          with_genotype=False,
                                          keep_conserved=True)
            asc[label] = [t.cpu() for t in fn(p8, q8, sigma0, delta0, eta0,
                                              rb, sm, cons)]
        finally:
            G.ENABLED = True
    ref = asc["cpu_x2"]
    worst_prob = 0.0
    for name in ("card_x2", "card_x4"):
        for a, b in zip(asc[name][:3], ref[:3]):
            if not torch.equal(a, b):
                raise AssertionError(f"sharded_cross_optimize {name}: "
                                     f"decisions differ from the CPU shards")
        for a, b in zip(asc[name], asc[f"{name}_off"]):
            if not torch.equal(a, b):
                raise AssertionError(f"sharded_cross_optimize {name}: "
                                     f"programs on and off differ")
        rel = abs(float(asc[name][3]) - float(ref[3])) / abs(float(ref[3]))
        worst_prob = max(worst_prob, rel)
        if not rel <= 1e-9:
            raise AssertionError(f"sharded_cross_optimize {name}: prob "
                                 f"differs by {rel} relative")

    # per-SNP sums with the reads on 4 card shards against 2 CPU shards
    ct = make_cell_tables_np(p8, q8)
    sums_args = (ct.p, ct.lerr, ct.l1m, sigma0, rb, sm, delta0)
    on_card = M.read_sharded_snp_sums([dev] * 4)(*sums_args)
    on_cpu = M.read_sharded_snp_sums([cpu] * 2)(*sums_args)
    worst_sums = 0.0
    for a, b in zip(on_card[:4], on_cpu[:4]):
        a, b = a.cpu().double(), b.double()
        rel = float(((a - b).abs() / b.abs().clamp(min=1e-300)).max())
        worst_sums = max(worst_sums, rel)
    if not worst_sums <= REL_TOL or not torch.equal(on_card[4].cpu(),
                                                    on_cpu[4]):
        raise AssertionError(f"read_sharded_snp_sums: card vs CPU "
                             f"{worst_sums} relative")

    # the same region on the normal path of a one-card run
    CK.reset_launches()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    O.phase_region(frags, cands, cfg, reg.start, apply_ds, device=dev)
    torch.cuda.synchronize()
    region_wall = time.monotonic() - t0
    stream_shapes = _launched_shapes("giant, stream region by phase_region",
                                     check_at=dev)

    # the giant locus
    glocus = _giant_locus(tmp, dev)
    gK0, gI0 = glocus[3].p.shape
    gK, gI = O._bucket(gK0), O._bucket(gI0)
    if gK * gI < giant.GIANT_CELLS:
        raise AssertionError(f"the giant locus has {gK} x {gI} padded cells, "
                             f"below {giant.GIANT_CELLS}")
    exchange = _exchange_kernel(dev, gI)
    gstates, glegs = {}, {}
    for label, devs, programs in (("card_x2", [dev] * 2, True),
                                  ("card_x2_off", [dev] * 2, False),
                                  ("card_x4", [dev] * 4, True)):
        gstates[label], glegs[label] = _sharded_leg(
            f"giant locus {label}", glocus, devs, programs)
    GIANT_RUNS.update(glegs)
    _states_equal("giant locus [card] x 2, programs on against off",
                  gstates["card_x2"], gstates["card_x2_off"])
    x4_equal = all(np.array_equal(a, b) for a, b in
                   zip(gstates["card_x4"], gstates["card_x2"]))
    CK.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.monotonic()
    O.phase_region(glocus[3], glocus[2], glocus[0], glocus[1].start,
                   glocus[4], device=dev)
    torch.cuda.synchronize()
    giant_region_wall = time.monotonic() - t0
    giant_region_peak = torch.cuda.max_memory_allocated(dev)
    giant_shapes = _launched_shapes("giant locus by phase_region",
                                    check_at=dev)
    G.free_all()
    _emit("giant", card, region=str(reg), K=K, I=I_pad, reads=K0, snps=I0,
          rounds=I0 // 4 + 1, reads_devices_here=giant.reads_devices(dev),
          states_equal=True, sharded_wall_seconds=walls, stream_legs=legs,
          phase_region_wall_seconds=region_wall,
          phase_region_launch_shapes=stream_shapes,
          ascent_prob_max_rel_diff=worst_prob,
          snp_sums_max_rel_diff=worst_sums, hand_kernel_launches=0,
          giant_locus=dict(region=str(glocus[1]), K=gK, I=gI, reads=gK0,
                           snps=gI0, padded_cells=gK * gI,
                           rounds=gI0 // 4 + 1, coverage=GIANT_COVERAGE,
                           generate_seconds=glocus[5],
                           prepare_seconds=glocus[6], legs=glegs,
                           states_equal_on_off=True,
                           states_equal_x4_x2=x4_equal,
                           phase_region_wall_seconds=giant_region_wall,
                           phase_region_device_peak_bytes=giant_region_peak,
                           phase_region_launch_shapes=giant_shapes),
          exchange=exchange, bounded_wait=bound)


def _region_schedule(dev, deep_input):
    """The first region of the deep input after its first ascent on the
    card in split mode, as phase_region brings it to the perturbation
    schedule: (region, K, I padded, rounds, the arguments of
    optimize.perturbation_phase, a callable of that first ascent)."""
    from longcallr_tpu_torch.config import preset
    from longcallr_tpu_torch.io.bam import BamFile
    from longcallr_tpu_torch.io.fasta import FastaFile
    from longcallr_tpu_torch.phasing import optimize as O
    from longcallr_tpu_torch.phasing import rng as R
    from longcallr_tpu_torch.phasing.kernels import CompactCells
    from longcallr_tpu_torch.pipeline.caller import build_regions
    from longcallr_tpu_torch.pipeline.engine import prepare_region

    bam_path, fa = deep_input
    cfg = preset("hifi-masseq")
    bam, fasta = BamFile(bam_path, threads=4), FastaFile(fa)
    reg = build_regions(bam, fasta, cfg)[0][0]
    cands, frags, _ = prepare_region(bam, reg, fasta.fetch(reg.chr), cfg, dev)
    K0, I0 = frags.p.shape
    K, I_pad = O._bucket(K0), O._bucket(I0)
    rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, reg.start]))
    p8 = np.zeros((K, I_pad), np.int8)
    q8 = np.zeros((K, I_pad), np.uint8)
    p8[:K0, :I0], q8[:K0, :I0] = frags.p, frags.baseq
    rb = np.zeros(K, bool)
    rb[:K0] = frags.for_phasing
    sm = np.zeros(I_pad, bool)
    sm[:I0] = cands.for_phasing
    ld = O.compute_ld_blocks(cands, frags)
    d0, c0 = O.init_haplotypes_ld(cands, ld, rng)
    delta0, cons = np.ones(I_pad), np.zeros(I_pad, bool)
    delta0[:I0], cons[:I0] = d0, c0
    eta0 = np.ones(I_pad)
    eta0[:I0] = O.init_genotype(cands)
    sigma0 = np.where(rb, np.where(rng.random(K) < 0.5, -1.0, 1.0), 0.0)
    on = lambda a: torch.as_tensor(a, device=dev)
    ct = CompactCells.from_numpy(p8, q8, dev)
    st0 = O.PhaseState.from_numpy(sigma0, delta0, eta0, dev)
    first = lambda: O.cross_optimize(ct, st0, on(rb), on(sm), on(cons),
                                     False, True, split=True)
    st1, prob1 = first()
    n_rounds = I0 // 4 + 1
    key = R.prng_key(int(rng.integers(0, np.iinfo(np.int64).max,
                                      dtype=np.int64)))
    args = (ct, st1, st1, prob1, on(rb), on(sm), on(cons), n_rounds, key,
            True)
    return reg, K, I_pad, n_rounds, args, first


def phase_stats(card: str, dev, deep_input) -> dict:
    """perturbation_phase_stats on one deep region on the card in split
    mode: its state and prob equal perturbation_phase's on the same inputs,
    it counts > 0 ascent trips, and it launches both kernels (at shapes
    phase_kernels checked). Returns (launch counts, launch shapes)."""
    from longcallr_tpu_torch.phasing import cuda_kernels as CK
    from longcallr_tpu_torch.phasing import optimize as O

    reg, K, I_pad, n_rounds, args, _ = _region_schedule(dev, deep_input)
    res, walls = {}, {}
    for name, fn in (("plain_schedule", O.perturbation_phase),
                     ("stats", O.perturbation_phase_stats)):
        CK.reset_launches()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        res[name] = fn(*args)
        torch.cuda.synchronize()
        walls[name] = time.monotonic() - t0
    launches = dict(CK.LAUNCHES)
    shapes = _launched_shapes("stats, one deep region")
    draws = _draws_read("stats", must=True)
    (b1, p1), (b2, p2, iters) = res["plain_schedule"], res["stats"]
    if float(p1) != float(p2) or not all(torch.equal(a, b)
                                         for a, b in zip(b1, b2)):
        raise AssertionError("perturbation_phase_stats differs from "
                             "perturbation_phase")
    if iters <= 0 or not all(n > 0 for n in launches.values()):
        raise AssertionError(f"stats: {iters} trips, launches {launches}")
    # each trip reads the split Dp (8 bytes a padded cell) twice: rows, cols
    moved = 2 * iters * K * I_pad * 8
    _emit("stats", card, region=str(reg), K=K, I=I_pad, rounds=n_rounds,
          ascent_trips=iters, wall_seconds=walls, launches=launches,
          launch_shapes=shapes, draw_launches=draws,
          split_dp_bytes_moved=moved,
          split_dp_bytes_per_second=moved / walls["stats"],
          equal_to_perturbation_phase=True)
    return launches, shapes


def _trace_kernels(trace_dir: str) -> dict:
    """Device kernels of the one torch.profiler trace in ``trace_dir``, by
    the hand kernel they belong to: {"rows": n, "cols": n}."""
    files = [f for f in os.listdir(trace_dir) if f.endswith(".pt.trace.json")]
    if len(files) != 1:
        raise AssertionError(f"profile: expected one trace, found {files}")
    with open(os.path.join(trace_dir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    return {"rows": sum("rows_" in n for n in names),
            "cols": sum("cols_kernel" in n for n in names),
            "kernels": len(names),
            "trace_bytes": os.path.getsize(os.path.join(trace_dir, files[0]))}


def phase_profile(card: str, tmp: str) -> None:
    """--profile-dir on the genome workload: a torch.profiler trace is
    written, it holds the device kernels of both hand kernels (split_*
    wrappers: rows_*_kernel and cols_kernel), and the outputs are those of
    a run without the flag. A session whose trace holds no kernel is tried
    again, at most three times in all (torch.profiler has traced no kernel
    in some sessions on this machine)."""
    from longcallr_tpu_torch.utils.bench_workload import make_genome_workload

    gbam, gfa = os.path.join(tmp, "genome.bam"), os.path.join(tmp, "genome.fa")
    make_genome_workload(gbam, gfa)
    want = _payloads(_cli_run(tmp, "profile_off", gbam, gfa)[0])
    tries = []
    for attempt in range(3):
        trace_dir = os.path.join(tmp, f"profile_trace_{attempt}")
        prefix, out, launches, wall = _cli_run(
            tmp, f"profile_on_{attempt}", gbam, gfa,
            extra=["--profile-dir", trace_dir])
        _must_equal("--profile-dir vs no profile", _payloads(prefix), want)
        found = _trace_kernels(trace_dir)
        tries.append({"wall_seconds": wall, "launches": launches, **found})
        if found["rows"] and found["cols"]:
            break
    else:
        raise AssertionError(f"profile: no trace named both kernels: {tries}")
    _emit("profile", card, byte_equal=True, attempts=tries)


def _mesh_run(tmp: str, label: str, bam: str, fa: str, dev, mesh, extra=(),
              env=None, contigs=None):
    """caller.run(batched=True, mesh=mesh, contigs=contigs) with the
    configuration the CLI builds for the same arguments, the launch counts
    set to 0 just before and read just after (the round draws' into
    DRAW_RUNS[label]). Returns (prefix,
    CallerOutputs, launches, launches by mesh row, wall seconds)."""
    from longcallr_tpu_torch import cli
    from longcallr_tpu_torch.phasing import cuda_kernels as CK
    from longcallr_tpu_torch.pipeline.caller import run

    prefix = os.path.join(tmp, label)
    cfg = cli.config_from_args(cli.build_parser().parse_args(
        ["-b", bam, "-f", fa, "-o", prefix, "-p", "hifi-masseq", *extra]))
    with _environ(env):
        CK.reset_launches()
        t0 = time.monotonic()
        out = run(bam, fa, prefix, cfg, contigs=contigs, batched=True,
                  device=dev, mesh=mesh)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        _draws_read(label)
        _no_flag_reads(label, dict(CK.GRAPHS), {"host": 0})
    return (prefix, out, dict(CK.LAUNCHES),
            {r: dict(v) for r, v in CK.LAUNCHES_BY_ROW.items()}, wall)


def _records_on(bam, contigs) -> int:
    """Records of a coordinate-sorted BamFile on ``contigs``."""
    return sum(hi - lo for lo, hi in map(bam.contig_record_range, contigs))


def _contigs_of(prefix: str, contigs) -> tuple:
    """What a run restricted to ``contigs`` (the first contigs of the
    reference, in order) must write, from the whole run at ``prefix``: the
    VCF header and those contigs' records, and (the phased BAM being
    written region by region in contig order) the payload's prefix that
    ends with those contigs' records. Returns (VCF bytes, the number of
    phased-BAM records, the whole payload)."""
    from longcallr_tpu_torch.io.bam import BamFile

    with open(prefix + ".vcf", "rb") as f:
        lines = f.read().splitlines(keepends=True)
    vcf = b"".join(l for l in lines if l.startswith(b"#")
                   or l.split(b"\t", 1)[0].decode() in contigs)
    n = _records_on(BamFile(prefix + ".phased.bam"), contigs)
    return vcf, n, _payloads(prefix)[1]


def _equal_on_contigs(what: str, prefix: str, whole: str, contigs) -> None:
    """The run at ``prefix`` (restricted to ``contigs``) wrote those
    contigs' share of the run at ``whole``: the same VCF lines, and a
    phased-BAM payload that is the whole one's prefix with the same
    number of records."""
    from longcallr_tpu_torch.io.bam import BamFile

    vcf, n, payload = _contigs_of(whole, contigs)
    got_vcf, got = _payloads(prefix)
    got_n = BamFile(prefix + ".phased.bam").n_records
    if got_vcf != vcf or payload[:len(got)] != got or got_n != n:
        raise AssertionError(f"{what}: VCF equal {got_vcf == vcf}, payload "
                             f"a prefix {payload[:len(got)] == got}, records "
                             f"{got_n} against {n}")


def _rows_launched(what: str, mesh, by_row: dict, bucket: int) -> dict:
    """Both kernels launched in each row that launched, and in at least as
    many rows as the smallest bucket of the run fills (every row of a mesh
    of that many rows or fewer). Returns the counts by row."""
    want = min(mesh.shape[0], bucket)
    both = [r for r, c in by_row.items()
            if all(c.get(n, 0) > 0 for n in KERNEL_NAMES)]
    if len(both) < want or len(both) != len(by_row):
        raise AssertionError(f"{what}: launches by row {by_row}, expected "
                             f"both kernels in at least {want} rows of "
                             f"{mesh.shape}")
    return {str(r): by_row[r] for r in sorted(by_row)}


def _rows_drew(what: str, mesh, rows_needed: int = 0) -> dict:
    """The round draws of the mesh run ``what`` (DRAW_RUNS): launched,
    every launch counted for a row of ``mesh``, and in at least
    ``rows_needed`` rows. Returns the counts by row."""
    d = DRAW_RUNS[what]
    by_row = d["by_row"]
    if d["launches"] <= 0 or sum(by_row.values()) != d["launches"] or \
            not set(by_row) <= set(range(mesh.shape[0])) or \
            len(by_row) < rows_needed:
        raise AssertionError(f"{what}: round_draws {d['launches']} "
                             f"launches, by row {by_row}, on {mesh.shape}")
    return {str(r): by_row[r] for r in sorted(by_row)}


def _deep_bucket(dev, deep_input, contig=None, n=None, blocks=False):
    """The deep input's four regions as one bucket (or the first ``n``
    regions of ``contig`` of another input), each region's arrays and
    random stream as phase_regions_batched makes them: (BatchedRegions on
    ``dev``, σ0, δ0, η0 (numpy), round counts, threefry keys), and with
    ``blocks`` the regions' LD block ids [B, I] (numpy, −1 = none)."""
    from longcallr_tpu_torch.config import preset
    from longcallr_tpu_torch.io.bam import BamFile
    from longcallr_tpu_torch.io.fasta import FastaFile
    from longcallr_tpu_torch.parallel import mesh as M
    from longcallr_tpu_torch.phasing import optimize as O
    from longcallr_tpu_torch.phasing import rng as R
    from longcallr_tpu_torch.pipeline.caller import build_regions
    from longcallr_tpu_torch.pipeline.engine import prepare_region

    bam_path, fa = deep_input
    cfg = preset("hifi-masseq")
    fasta = FastaFile(fa)
    if contig is None:
        bam = BamFile(bam_path, threads=4)
        regs = build_regions(bam, fasta, cfg)[0]
    else:
        clen = dict(fasta.contig_lengths)[contig]
        bam = BamFile(bam_path, threads=4, region=(contig, 0, clen))
        regs = build_regions(bam, fasta, cfg, contigs=[contig])[0][:n]
    preps = [(reg,) + prepare_region(bam, reg, fasta.fetch(reg.chr), cfg,
                                     dev)[:2] for reg in regs]
    B = len(preps)
    K = O._bucket(max(f.p.shape[0] for _, _, f in preps))
    I = O._bucket(max(f.p.shape[1] for _, _, f in preps))
    p, q = np.zeros((B, K, I), np.int8), np.zeros((B, K, I), np.uint8)
    rb, sm, cons = (np.zeros((B, K), bool), np.zeros((B, I), bool),
                    np.zeros((B, I), bool))
    sigma0, delta0, eta0 = np.zeros((B, K)), np.ones((B, I)), np.ones((B, I))
    rounds, keys = np.zeros(B, np.int64), []
    bid = np.full((B, I), -1, np.int32)
    for b, (reg, cands, frags) in enumerate(preps):
        K0, I0 = frags.p.shape
        p[b, :K0, :I0], q[b, :K0, :I0] = frags.p, frags.baseq
        rb[b, :K0], sm[b, :I0] = frags.for_phasing, cands.for_phasing
        rng = np.random.default_rng(np.random.SeedSequence([cfg.seed,
                                                            reg.start]))
        ld = O.compute_ld_blocks(cands, frags)
        bid[b, :ld.block_id.shape[0]] = ld.block_id
        d0, c0 = O.init_haplotypes_ld(cands, ld, rng)
        delta0[b, :I0], cons[b, :I0] = d0, c0
        eta0[b, :I0] = O.init_genotype(cands)
        sigma0[b] = np.where(rb[b], np.where(rng.random(K) < 0.5, -1.0, 1.0),
                             0.0)
        rounds[b] = I0 // 4 + 1
        keys.append(R.prng_key(int(rng.integers(0, np.iinfo(np.int64).max,
                                                dtype=np.int64))))
    batch = M.BatchedRegions.from_numpy(p, q, rb, sm, cons, dev)
    out = (batch, (sigma0, delta0, eta0), rounds, keys)
    return out + (bid,) if blocks else out


# the rounds of (d) and the stream contigs of (c) in phase mesh
MESH_STATS_ROUNDS = 25
MESH_STREAM_CONTIGS = ("chr1", "chr2")


def _mesh_stats(dev, bucket, mesh) -> dict:
    """(d): batched_perturbation_phase_stats on the deep bucket in split
    mode, its first MESH_STATS_ROUNDS rounds, without a mesh and on
    ``mesh``: the same states and trips, probs within REL_TOL."""
    from longcallr_tpu_torch.parallel import mesh as M
    from longcallr_tpu_torch.phasing import cuda_kernels as CK

    batch, states, rounds, keys = bucket
    rounds = np.minimum(rounds, MESH_STATS_ROUNDS)
    on = lambda a: torch.as_tensor(a, device=dev)
    sg, dl, et, pr = M.batched_cross_optimize(batch, *map(on, states),
                                              keep_conserved=True, split=True)
    res, walls, counts = {}, {}, {}
    for label, m in (("bucket", None), ("mesh", mesh)):
        CK.reset_launches()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        res[label] = M.batched_perturbation_phase_stats(
            batch, sg, dl, et, pr, rounds, keys, split=True, mesh=m)
        torch.cuda.synchronize()
        walls[label] = time.monotonic() - t0
        counts[label] = (dict(CK.LAUNCHES),
                         _launched_shapes(f"(d) stats, {label}"),
                         {r: dict(v) for r, v in CK.LAUNCHES_BY_ROW.items()})
        _draws_read(f"mesh_stats_{label}", must=True)
    (a, b) = res["bucket"], res["mesh"]
    if not all(torch.equal(x, y) for x, y in zip(a[:3], b[:3])):
        raise AssertionError("(d) stats: the mesh's states differ")
    rel = float(((a[3] - b[3]).abs() / a[3].abs()).max())
    if not rel <= REL_TOL or a[4] != b[4] or a[4] <= 0:
        raise AssertionError(f"(d) stats: probs {rel} apart, trips "
                             f"{a[4]} / {b[4]}")
    return {"mesh": list(mesh.shape), "rounds": int(rounds.max()),
            "ascent_trips": a[4], "prob_max_rel_diff": rel,
            "wall_seconds": walls, "launches": counts["bucket"][0],
            "launches_mesh": counts["mesh"][0],
            "launches_by_row": _rows_launched("(d) stats", mesh,
                                              counts["mesh"][2], 4),
            "draws_by_row": _rows_drew("mesh_stats_mesh", mesh, 4),
            "launch_shapes_mesh": counts["mesh"][1], "equal": True}, \
        (counts["mesh"][0], counts["mesh"][1])


def phase_mesh(card: str, dev, tmp: str, deep_input, stream_input,
               notes: dict) -> dict:
    """The regions axis of the mesh through caller.run and the stats
    schedule (legs (a) to (d) of the module docstring), on one card with
    the card repeated along "regions" and, where this process sees more
    than one card, once more over every card. Returns (launch counts,
    launch shapes) by run."""
    from longcallr_tpu_torch.parallel.mesh import make_mesh

    from longcallr_tpu_torch.io.bam import BamFile

    bam, fa = deep_input
    sbam, sfa, _, _ = stream_input
    s_reads = _records_on(BamFile(sbam), MESH_STREAM_CONTIGS)
    meshes = [("", lambda n: make_mesh(n, 1, [dev] * n))]
    if torch.cuda.device_count() > 1:
        meshes.append(("_cards", lambda n: make_mesh()))
    bucket = _deep_bucket(dev, deep_input)
    one_wave = {"LONGCALLR_WAVE_CELLS": str(1 << 40)}
    res, runs = {}, {}
    for tag, mk in meshes:
        # (label, rows, input, extra CLI arguments, env, contigs, bytes to
        # equal, smallest bucket, phase 6 or 8 numbers beside)
        legs = [("mesh", 2, (bam, fa), (), None, None, "deep_batched", 2,
                 "a"),
                ("mesh_one_wave", 4, (bam, fa), (), one_wave, None,
                 "deep_one_wave", 4, "f"),
                ("mesh_enum", 4, (os.path.join(tmp, "enum_deep.bam"),
                                  os.path.join(tmp, "enum_deep.fa")), (),
                 None, None, "enum_deep_batched", 4, "i"),
                ("mesh_stream", 4, (sbam, sfa), ("-t", "8"), None,
                 MESH_STREAM_CONTIGS, "stream_resident", 5,
                 "stream_resident")]
        for (label, n, (ibam, ifa), extra, env, contigs, want, smallest,
             beside) in legs:
            mesh = mk(n)
            name = label + tag
            with _router(0 if label == "mesh_enum" else None):
                prefix, out, launches, by_row, wall = _mesh_run(
                    tmp, name, ibam, ifa, dev, mesh, extra, env, contigs)
            shapes = _launched_shapes(name)
            if contigs is None:
                _must_equal(f"{name} vs {want}", _payloads(prefix),
                            _payloads(os.path.join(tmp, want)))
            else:
                _equal_on_contigs(name, prefix, os.path.join(tmp, want),
                                  contigs)
            census = _census(out.stage_seconds)
            kind = "phase_enum_buckets" if label == "mesh_enum" else \
                "phase_buckets"
            if census[kind] < 1:
                raise AssertionError(f"{name}: no bucket on the mesh: "
                                     f"{census}")
            if label != "mesh_enum":        # enumeration draws nothing
                drew = _rows_drew(name, mesh)
            res[name] = {"mesh": list(mesh.shape), "census": census,
                         "launches": launches,
                         "draws_by_row": (None if label == "mesh_enum"
                                          else drew),
                         "launches_by_row": _rows_launched(name, mesh, by_row,
                                                           smallest),
                         "launch_shapes": shapes, **_phase_times(wall, out),
                         "beside": notes[beside], "equal": True}
            if contigs is not None:
                res[name].update(contigs=list(contigs), reads=s_reads,
                                 reads_per_second=s_reads / wall)
            runs[name] = (launches, shapes)
        res["mesh_stats" + tag], runs["mesh_stats" + tag] = _mesh_stats(
            dev, bucket, mk(4))
    _emit("mesh", card, cards=torch.cuda.device_count(), **res)
    return runs


def _graph_nodes(dev) -> dict:
    """Each hand kernel's wrapper called alone under CUDA graph capture, at
    the deep bucket's shape: the graph holds one kernel node (a launch of
    this package's library, which links its own CUDA runtime, became a node
    of PyTorch's capture), the capture recorded one launch, and a replay
    writes the eager call's result bit for bit."""
    import ctypes

    from longcallr_tpu_torch import _build
    from longcallr_tpu_torch.phasing import cuda_kernels as CK

    rng = np.random.default_rng(19)
    B, K, I = DEEP_BUCKET[:3]
    hi, lo = _split_dp(rng, (B, K, I), dev)
    x = torch.as_tensor(rng.choice([-1.0, 0.0, 1.0], size=(B, I, 2)),
                        device=dev)
    sg = torch.as_tensor(rng.choice([-1.0, 0.0, 1.0], size=(B, K)),
                         device=dev)
    side = torch.cuda.Stream(dev)
    res = {}
    for name, call in (("dual_matvec_rows",
                        lambda: CK.dual_matvec_rows(hi, lo, x)),
                       ("matvec_cols", lambda: CK.matvec_cols(hi, lo, sg))):
        with torch.cuda.stream(side):
            want = call()   # eager on the capture's stream: its workspace
            side.synchronize()
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            with CK.recording() as launches:
                graph.capture_begin(capture_error_mode="thread_local")
                out = call()
                graph.capture_end()
            n = ctypes.c_int(-1)
            err = _build.load().graph_kernel_nodes(graph.raw_cuda_graph(),
                                                   ctypes.byref(n))
            graph.instantiate()
            out.zero_()
            graph.replay()
        torch.cuda.synchronize()
        if err or n.value != 1 or len(launches) != 1 \
                or not torch.equal(out, want):
            raise AssertionError(f"{name} under capture: error {err}, "
                                 f"{n.value} kernel nodes, {len(launches)} "
                                 f"launches recorded, replay equal "
                                 f"{torch.equal(out, want)}")
        res[name] = {"kernel_nodes": n.value, "replay_equal": True}
        del graph
    CK.take_workspaces(dev, side.cuda_stream)
    return res


def _hand_kernels_traced(prof) -> int:
    """Device kernels of the two hand kernels in a torch.profiler session
    (split_* wrappers: rows_*_kernel and cols_kernel)."""
    from torch.autograd import DeviceType

    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and ("rows_" in e.key or "cols_kernel" in e.key))


# slots of the device clock's stamps in one call of a stamped program
STAMP_SLOTS = 1 << 15


def _stamped_run(dev):
    """A stand-in for graphs.run that builds every program with a stamp of
    the device clock (csrc/graph_program.cu, gp_stamp) before and after
    each piece, under a key of its own; and the stamps' buffers (times,
    the next slot)."""
    from longcallr_tpu_torch._build import load
    from longcallr_tpu_torch.phasing import graphs as G

    lib = load()
    times = torch.zeros(STAMP_SLOTS, dtype=torch.int64, device=dev)
    nxt = torch.zeros(1, dtype=torch.int32, device=dev)
    real = G.run

    def stamp():
        err = lib.gp_stamp(torch.cuda.current_stream(dev).cuda_stream,
                           times.data_ptr(), nxt.data_ptr(), STAMP_SLOTS)
        if err:
            raise RuntimeError(f"gp_stamp: cudaError {err}")

    def stamped(make):
        def make_stamped():
            prog = make()
            memo = {}

            def piece(p):
                if id(p) not in memo:
                    def fn(f=p.fn):
                        stamp()
                        f()
                        stamp()
                    memo[id(p)] = G.Piece(p.name, fn)
                return memo[id(p)]

            def nodes(ns):
                return tuple(piece(n) if isinstance(n, G.Piece)
                             else G.While(n.flag, nodes(n.body)) for n in ns)

            return G.Program(prog.device, prog.inputs, nodes(prog.nodes),
                             prog.outputs)
        return make_stamped

    def run(kind, device, make, values, capture=True):
        return real(kind + ("stamped",), device, stamped(make), values,
                    capture)

    return run, times, nxt


def _where_time_goes(run, dev) -> dict:
    """One call of ``run`` with every program stamped (``_stamped_run``;
    a first call builds the stamped program): the device's span of the call
    between CUDA events, the time inside the pieces (their kernels and the
    gaps between a piece's kernels), and the share of the span outside
    every piece: the loops' control (set-condition kernels and WHILE nodes
    on the card, host flag reads and launches with the program off), the
    input copies, the stamps. The device is idle at least that share of the
    call; the gaps inside the pieces are not separable from their kernels
    without a tracer."""
    from longcallr_tpu_torch.phasing import graphs as G

    stamped, times, nxt = _stamped_run(dev)
    real = G.run
    G.run = stamped
    try:
        run()
        nxt.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a.record()
        run()
        b.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        G.run = real
    n = int(nxt.item())
    if n % 2 or n > STAMP_SLOTS or n == 0:
        raise AssertionError(f"stamps: {n} of {STAMP_SLOTS}")
    t = times[:n].cpu().numpy().astype(np.float64) / 1e9
    inside = float((t[1::2] - t[0::2]).sum())
    span = a.elapsed_time(b) / 1e3
    return {"stamped_wall_seconds": wall, "stamped_span_seconds": span,
            "piece_runs": n // 2, "in_pieces_seconds": inside,
            "first_to_last_stamp_seconds": float(t[-1] - t[0]),
            "idle_share_at_least": 1.0 - inside / span}


def _idle_share(run, graphs_on: bool, traced: bool = True) -> tuple:
    """``run`` (a phase program) with the device program on or off: a first
    call (with the program on, it builds the program of the shape), then
    one call timed from launch to sync (host clock, ending in a
    synchronise) and between CUDA events on its stream (the device's span
    of the call), then, where ``traced``, one under torch.profiler for the
    device time of its kernels (DeviceType.CUDA rows only) and the device's
    idle share, 1 − busy / wall. The profiler's count of the hand kernels is held
    against the census of the timed call: where it sees fewer (kernels
    inside conditional nodes not attributed), no idle share is taken from
    it; the device clock's stamps around the pieces give its lower bound
    (``_where_time_goes``). Returns (the timed call's result, the
    numbers)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from longcallr_tpu_torch.phasing import cuda_kernels as CK
    from longcallr_tpu_torch.phasing import graphs as G

    saved = G.ENABLED
    G.ENABLED = graphs_on
    try:
        run()
        torch.cuda.synchronize()
        CK.reset_launches()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        out = run()
        b.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        span = a.elapsed_time(b) / 1e3
        counted = sum(CK.LAUNCHES.values())
        census = dict(CK.LAUNCHES)
        programs = dict(CK.GRAPHS)
        if not traced:
            return out, {"wall_seconds": wall, "device_span_seconds": span,
                         "census": census,
                         "program_launches": programs["launches"],
                         "flag_reads": programs["flag_reads"],
                         "condition_sets": programs["condition_sets"]}
        busy_us, seen = 0.0, 0
        for attempt in range(4):    # a profile now and then traces nothing
            time.sleep(0.2 * attempt)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                run()
                torch.cuda.synchronize()
            busy_us = sum(e.self_device_time_total
                          for e in prof.key_averages()
                          if e.device_type == DeviceType.CUDA)
            seen = _hand_kernels_traced(prof)
            if busy_us > 0:
                break
        stamps = _where_time_goes(run, torch.device(
            "cuda", torch.cuda.current_device()))
    finally:
        G.ENABLED = saved
    busy = busy_us / 1e6
    sees_all = seen == counted
    return out, {"wall_seconds": wall, "device_span_seconds": span,
                 "device_busy_seconds": busy,
                 "hand_kernels_counted": counted,
                 "hand_kernels_traced": seen,
                 "profiler_sees_every_kernel": sees_all,
                 "idle_share": (1.0 - busy / wall
                                if busy > 0 and sees_all else None),
                 **stamps, "census": census,
                 "program_launches": programs["launches"],
                 "flag_reads": programs["flag_reads"],
                 "condition_sets": programs["condition_sets"]}


def _bucket_schedule(dev, bucket, n=None):
    """batched_perturbation_phase of ``bucket`` (its first ``n`` regions)
    after a first ascent, split mode: a callable for _idle_share."""
    from longcallr_tpu_torch.parallel import mesh as M

    batch, states, rounds, keys = _first(bucket, n)[:4]
    on = lambda a: torch.as_tensor(a, device=dev)
    sg, dl, et, pr = M.batched_cross_optimize(batch, *map(on, states),
                                              keep_conserved=True, split=True)
    return lambda: M.batched_perturbation_phase(batch, sg, dl, et, pr,
                                                rounds, keys, split=True)


def _bucket_fused(dev, bucket, n=None):
    """batched_phase_fused of ``bucket`` (its first ``n`` regions; made by
    _deep_bucket with its block ids): a callable for _idle_share."""
    from longcallr_tpu_torch.parallel import mesh as M

    batch, states, rounds, keys, bid = _first(bucket, n)
    on = lambda a: torch.as_tensor(a, device=dev)
    args = (*map(on, states), on(bid))
    return lambda: M.batched_phase_fused(batch, *args, rounds, keys,
                                         split=True)


def _first(bucket, n):
    """A bucket of _deep_bucket cut to its first ``n`` regions."""
    from longcallr_tpu_torch.parallel import mesh as M

    if n is None:
        return bucket
    batch, states, rounds, keys, *rest = bucket
    return (M.BatchedRegions(*(a[:n] for a in batch)),
            [a[:n] for a in states], rounds[:n], keys[:n],
            *(a[:n] for a in rest))


def _schedule_ab(what: str, run, traced: bool = True) -> dict:
    """The program ``run`` with the device program off and on: the same
    result, launch census and loop turns, and each one's wall; where
    ``traced``, also the device busy time and idle share; where the
    profiler does not see inside the program, the idle share of the
    program's call from the busy time of the same kernels launched
    eagerly (``idle_share_by_eager_busy``)."""
    a, off = _idle_share(run, False, traced)
    b, on = _idle_share(run, True, traced)
    if not all(torch.equal(x, y) for x, y in zip(_flat(a), _flat(b))):
        raise AssertionError(f"{what}: the program differs from the plain "
                             f"executor")
    if on["flag_reads"] or not on["program_launches"] \
            or on["census"] != off["census"] \
            or on["condition_sets"] != off["flag_reads"]:
        raise AssertionError(f"{what}: program off {off}, on {on}")
    if traced:
        on["idle_share_by_eager_busy"] = 1.0 - off["device_busy_seconds"] / \
            on["wall_seconds"]
    return {"program_off": off, "program_on": on}


def _enum_chunk(dev, B: int, K: int, I: int, I0: int, C: int, seed: int):
    """One call of an enumeration chunk on the card in split mode: B
    planted regions of K reads and I0 SNPs (padded to I), each with the
    first C of its 2^I0 configs, through batched_enum_cross_optimize; with
    B = 0 one such region alone through cross_optimize, its C configs over
    one table (the per-region path). A callable for _idle_share."""
    from longcallr_tpu_torch.parallel import mesh as M
    from longcallr_tpu_torch.phasing import optimize as O
    from longcallr_tpu_torch.phasing.kernels import CompactCells

    rng = np.random.default_rng(seed)
    n = max(B, 1)
    hap = rng.choice([-1, 1], size=(n, K, 1))
    p = hap * rng.choice([-1, 1], size=(n, 1, I))
    p = np.where(rng.random((n, K, I)) < 0.03, -p, p)
    p = np.where((rng.random((n, K, I)) < 0.7)
                 & (np.arange(I) < I0), p, 0).astype(np.int8)
    q = rng.integers(10, 31, size=(n, K, I)).astype(np.uint8)
    rb = rng.random((n, K)) < 0.95
    sm = np.broadcast_to(np.arange(I) < I0, (n, I)).copy()
    configs = np.pad(O.enumeration_order(I0)[:C].astype(np.float64),
                     ((0, 0), (0, I - I0)), constant_values=1.0)
    sig0 = np.where(rb[:, None, :], rng.choice([-1.0, 1.0], size=(n, C, K)),
                    0.0)
    on = lambda a: torch.as_tensor(a, device=dev)
    if B:
        batch = M.BatchedRegions.from_numpy(p, q, rb, sm, np.zeros_like(sm),
                                            dev)
        args = (on(sig0), on(configs), on(np.ones((B, I))))
        return lambda: M.batched_enum_cross_optimize(batch, *args,
                                                     split=True)
    ct = CompactCells.from_numpy(p[0], q[0], dev)
    st = O.PhaseState(on(sig0[0]), on(configs), on(np.ones((C, I))))
    masks = (on(rb[0]), on(sm[0]), on(np.zeros(I, bool)))
    return lambda: O.cross_optimize(ct, st, *masks, True, False, split=True)


def _flat(out) -> list:
    return [t for o in out for t in (o if isinstance(o, tuple) else (o,))]


def _program_counts() -> dict:
    """The device programs' counters (cuda_kernels.GRAPHS) and, per program
    built, its shape's key, instantiate seconds and device bytes held
    (graphs.BUILDS)."""
    from longcallr_tpu_torch.phasing import cuda_kernels as CK
    from longcallr_tpu_torch.phasing import graphs as G

    builds = [dict(b) for b in G.BUILDS]
    return {**CK.GRAPHS, "distinct_shapes": len({b["key"] for b in builds}),
            "builds_by_shape": builds}


def _hold_to_reference(what: str, label: str, prefix: str) -> dict:
    """A run's VCF records and sorted HP/PS tags against the frozen digests
    of the JAX package's run of input ``label``."""
    from longcallr_tpu_torch.utils import goldens

    got = goldens.digests(prefix + ".vcf", prefix + ".phased.bam")
    want = goldens.reference_digests()[label]
    if not want.get("ok"):
        return {"reference": label, "held": False,
                "why": "the reference run did not finish"}
    if any(got[k] != want[k] for k in got):
        raise AssertionError(f"{what}: records or tags differ from the JAX "
                             f"package's digests of {label}: {got} vs "
                             f"{want}")
    return {"reference": label, "held": True, **got}


@contextlib.contextmanager
def _counting_programs():
    """Counts the phase programs called inside (graphs.run, any thread) by
    kind; an ascent whose state has a members' axis (the enumeration
    configs) counts as "ascent_members"."""
    from longcallr_tpu_torch.phasing import graphs as G

    calls, lock, real = {}, threading.Lock(), G.run

    def run(kind, device, make, values, capture=True):
        name = kind[0]
        if name == "ascent" and \
                values["sigma"].dim() - 1 > values["cell_p"].dim() - 2:
            name = "ascent_members"
        with lock:
            calls[name] = calls.get(name, 0) + 1
        return real(kind, device, make, values, capture)

    G.run = run
    try:
        yield calls
    finally:
        G.run = real


def _graphs_cli_ab(tmp: str, label: str, bam: str, fa: str, extra=(),
                   env=None, reference=None, check_at=None) -> dict:
    """One input through the CLI's main() with the device program off, then
    on: VCF bytes, phased-BAM payload and sorted HP/PS tags equal (and
    equal to the JAX package's digests of ``reference``), the launch census
    (counts and shapes) equal; with the program on, program launches, no
    host flag read, as many set-condition launches (the device's count) as
    the program-off run's host flag reads, one build per distinct shape,
    and both kernels
    launched through the programs' runs; the peak of allocated device
    memory of each run above what was allocated before it, the programs
    called by kind and the launches at each shape. ``check_at``: a card on
    which launch shapes that phase_kernels did not check are checked after
    the run (``_launched_shapes``). Returns the two runs' numbers and
    (launches, shapes) of the run with the program."""
    from longcallr_tpu_torch.phasing import cuda_kernels as CK
    from longcallr_tpu_torch.phasing import graphs as G

    legs = {}
    for on in (False, True):
        G.ENABLED = on
        G.reset_builds()
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        try:
            with _counting_programs() as calls:
                prefix, out, launches, wall = _cli_run(
                    tmp, f"graphs_{label}_{'on' if on else 'off'}", bam, fa,
                    extra, env)
        finally:
            G.ENABLED = True
        legs[on] = {"prefix": prefix, "launches": launches,
                    "peak_device_bytes": torch.cuda.max_memory_allocated()
                    - held,
                    "launches_by_shape": [
                        [n, list(sh), k] for (n, sh), k in
                        sorted(CK.LAUNCHES_BY_SHAPE.items())],
                    "program_calls": calls,
                    "shapes": _launched_shapes(f"graphs {label} {on}",
                                               check_at=check_at),
                    "programs": _program_counts(),
                    "programs_cached_after_run": G.cached(),
                    "graph_launches": dict(CK.GRAPH_LAUNCHES),
                    "census": _census(out.stage_seconds),
                    **_phase_times(wall, out)}
        if reference is not None:
            legs[on]["reference"] = _hold_to_reference(
                f"graphs {label} {on}", reference, prefix)
    a, b = legs[False], legs[True]
    _must_equal(f"graphs {label}: off vs on", _payloads(a["prefix"]),
                _payloads(b["prefix"]))
    if _records_and_tags(a["prefix"]) != _records_and_tags(b["prefix"]):
        raise AssertionError(f"graphs {label}: records or tags differ")
    if (a["launches"], a["shapes"]) != (b["launches"], b["shapes"]) or \
            DRAW_RUNS[f"graphs_{label}_off"] != DRAW_RUNS[f"graphs_{label}_on"]:
        raise AssertionError(f"graphs {label}: launch census off "
                             f"{a['launches']} vs on {b['launches']}, draws "
                             f"{DRAW_RUNS[f'graphs_{label}_off']} vs "
                             f"{DRAW_RUNS[f'graphs_{label}_on']}")
    pa, pb = a["programs"], b["programs"]
    if pa["launches"] or pa["builds"] or not pa["flag_reads"] \
            or not pb["launches"] or pb["flag_reads"] \
            or pb["condition_sets"] != pa["flag_reads"] \
            or pb["builds"] != pb["distinct_shapes"] \
            or b["programs_cached_after_run"] or not pb["body_runs"] \
            or not all(b["graph_launches"][n] > 0 and b["launches"][n] > 0
                       for n in KERNEL_NAMES):
        raise AssertionError(f"graphs {label}: programs off {pa}, on {pb}, "
                             f"kernels in programs {b['graph_launches']}")
    res = {("program_on" if on else "program_off"):
           {k: v for k, v in leg.items() if k not in ("prefix", "shapes")}
           for on, leg in legs.items()}
    res["equal"] = True
    return res, (b["launches"], b["shapes"])


def phase_graphs(card: str, dev, tmp: str, deep_input, stream_input) -> dict:
    """The phase programs as device programs (phasing/graphs.py: CUDA graphs
    with conditional WHILE nodes, csrc/graph_program.cu) against the plain
    executor of the same pieces (graphs.ENABLED off, then on): first each
    wrapper alone under capture (``_graph_nodes``) and the set-condition
    kernel against its plain version (``_set_condition``); then
    batched_perturbation_phase (the staged chain's schedule) of a bucket of
    the deep and stream inputs' shapes (a default wave of 2, the deep
    bucket of 4, a stream wave of 5) with the program off and on, equal
    (the CLI runs of those inputs have their program-off twins in phases
    batched and stream, ``_program_off_leg``); one deep region through
    phase_region; the wall from launch to sync and the device's idle share
    of one bucket's fused phase (the deep bucket of 4) and of the region's
    schedule, each after a first call that builds its program. Returns
    (launch counts, launch shapes) by run."""
    from longcallr_tpu_torch.parallel import mesh as M
    from longcallr_tpu_torch.phasing import cuda_kernels as CK
    from longcallr_tpu_torch.phasing import graphs as G
    from longcallr_tpu_torch.phasing import optimize as O
    from longcallr_tpu_torch.config import preset
    from longcallr_tpu_torch.io.bam import BamFile
    from longcallr_tpu_torch.io.fasta import FastaFile
    from longcallr_tpu_torch.pipeline.caller import build_regions
    from longcallr_tpu_torch.pipeline.engine import prepare_region

    bam, fa = deep_input
    sbam, sfa = stream_input[:2]
    res = {"capture": _graph_nodes(dev), "set_condition": SET_CONDITION}
    runs = {}
    deep = _deep_bucket(dev, deep_input, blocks=True)
    for label, sched in (
            ("deep", _bucket_schedule(dev, deep, 2)),
            ("deep_one_wave", _bucket_schedule(dev, deep)),
            ("stream_resident", _bucket_schedule(dev, _deep_bucket(
                dev, (sbam, sfa), contig="chr1", n=5)))):
        res[label] = {"schedule": _schedule_ab(f"{label} schedule", sched,
                                               traced=False)}
    res["fused_bucket"] = _schedule_ab("fused bucket", _bucket_fused(
        dev, deep))


    # the ascent program off and on at the shapes it runs at: the staged
    # chain's first ascent of a default wave in f64 (LONGCALLR_F32_KERNELS=0
    # takes the staged chain for every bucket), one deep region's first
    # ascent, and enumeration chunks: run (g)'s bucket of 12 x 16 configs,
    # run (i)'s 6-SNP bucket (4 x 64) and 10-SNP chunk (4 x 512), the
    # transcriptome input's most frequent bucket chunk (6 regions of
    # (1024, 16) x 128 configs) and its region of 1,024 configs alone
    wave, states = _first(deep, 2)[:2]
    sts = tuple(torch.as_tensor(a, device=dev) for a in states)
    ascents = {"staged_f64_wave": lambda: M.batched_cross_optimize(
        wave, *sts, keep_conserved=True, split=False)}
    del deep
    for name, args in (("enum_g_bucket", (12, 64, 8, 4, 16)),
                       ("enum_i6_bucket", (4, 512, 8, 6, 64)),
                       ("enum_i10_chunk", (4, 512, 16, 10, 512)),
                       ("enum_transcriptome_chunk", (6, 1024, 16, 10, 128)),
                       ("enum_transcriptome_region", (0, 1024, 16, 10, 1024))):
        ascents[name] = _enum_chunk(dev, *args, seed=len(ascents))
    res["ascent"] = {name: _schedule_ab(f"ascent {name}", run, traced=False)
                     for name, run in ascents.items()}
    del ascents, wave, sts

    # one deep region through phase_region, and its schedule alone
    cfg = preset("hifi-masseq")
    dbam, fasta = BamFile(bam, threads=4), FastaFile(fa)
    reg = build_regions(dbam, fasta, cfg)[0][0]
    cands, frags, apply_ds = prepare_region(dbam, reg, fasta.fetch(reg.chr),
                                            cfg, dev)
    legs = {}
    for on in (False, True):
        G.ENABLED = on
        try:
            CK.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st = O.phase_region(frags, cands, cfg, reg.start, apply_ds, dev)
            wall = time.perf_counter() - t0
        finally:
            G.ENABLED = True
        legs[on] = {"state": st, "launches": dict(CK.LAUNCHES),
                    "shapes": _launched_shapes(f"graphs region {on}"),
                    "programs": dict(CK.GRAPHS),
                    "graph_launches": dict(CK.GRAPH_LAUNCHES),
                    "wall_seconds": wall}
    a, b = legs[False], legs[True]
    if not all(np.array_equal(x, y) for x, y in zip(a["state"], b["state"])):
        raise AssertionError("graphs region: phase_region differs")
    if (a["launches"], a["shapes"]) != (b["launches"], b["shapes"]) or \
            not b["programs"]["launches"] or a["programs"]["launches"] or \
            b["programs"]["flag_reads"] or b["programs"]["condition_sets"] \
            != a["programs"]["flag_reads"] or \
            not all(b["graph_launches"][n] > 0 for n in KERNEL_NAMES):
        raise AssertionError(f"graphs region: census off {a['launches']}, "
                             f"on {b['launches']}, programs {b['programs']}")
    runs["graphs_region"] = (b["launches"], b["shapes"])
    *_, sargs, first_ascent = _region_schedule(dev, deep_input)
    res["ascent"]["deep_region_first"] = _schedule_ab(
        "ascent, a deep region's first", first_ascent, traced=False)
    res["region"] = {
        "region": str(reg), "equal": True,
        **{("program_on" if on else "program_off"):
           {k: v for k, v in leg.items() if k not in ("state", "shapes")}
           for on, leg in legs.items()},
        "schedule": _schedule_ab("region", lambda: O.perturbation_phase(
            *sargs))}
    res["programs_freed"] = G.free_all()
    _emit("graphs", card, **res)
    return runs


def phase_transcriptome(card: str, dev, tmp: str) -> dict:
    """The transcriptome-scale enumeration input (goldens.ENUM_INPUTS:
    320 loci of 1 to 10 SNPs, 62,028 reads) through the CLI with 8
    threads, batched and --no-batched, each with the device programs off
    and on (``_graphs_cli_ab``), every phase problem on the card: bytes
    equal across the four legs and equal to the JAX package's digests, no
    host flag read with
    the programs on, set-condition launches equal to the flag reads off,
    one build per distinct shape; each kernel held against its plain
    version at every launch shape the runs made; the three shapes each
    kernel launched at most must be TX_CHUNK, TX_REGION and TX_SMALL,
    which phase kernels timed beside their bound. The census:
    regions, the share that took the enumeration path (enumeration
    ascents against perturbation schedules on the per-region loop),
    enumeration buckets, regions phased alone and distinct shapes.
    Returns (launch counts, launch shapes) by run."""
    bam, fa, params = _enum_input(tmp, "transcriptome")
    res, runs = {"reads": params["n_reads"], "snps": params["n_snps"]}, {}
    with _router(0):
        for label, extra in (("batched", ()),
                             ("per_region", ("--no-batched",))):
            res[label], runs[f"transcriptome_{label}"] = _graphs_cli_ab(
                tmp, f"transcriptome_{label}", bam, fa,
                ("-t", "8") + extra, reference="transcriptome", check_at=dev)
    # the four legs write one VCF and one phased-BAM payload (off and on
    # were held equal within each leg)
    _must_equal("transcriptome: batched vs --no-batched",
                _payloads(os.path.join(tmp, "graphs_transcriptome_batched_on")),
                _payloads(os.path.join(tmp,
                                       "graphs_transcriptome_per_region_on")))
    res["equal_across_legs"] = True
    calls = res["per_region"]["program_on"]["program_calls"]
    enum = calls.get("ascent_members", 0)
    iterative = calls.get("schedule", 0)
    census = res["batched"]["program_on"]["census"]
    res["census"] = {
        **census, "regions_enumeration": enum,
        "regions_iterative": iterative,
        "enumeration_share": enum / max(1, enum + iterative),
        "distinct_program_shapes": {
            leg: res[leg]["program_on"]["programs"]["distinct_shapes"]
            for leg in ("batched", "per_region")}}
    if enum + iterative <= 0 or enum / (enum + iterative) < 0.8:
        raise AssertionError(f"transcriptome: {enum} enumeration regions of "
                             f"{enum + iterative}")
    # the shapes each kernel launched at most, over both legs: those
    # phase kernels timed
    count = {}
    for leg in ("batched", "per_region"):
        for name, shape, n in res[leg]["program_on"]["launches_by_shape"]:
            count[name, tuple(shape)] = count.get((name, tuple(shape)), 0) + n
    timed = {_launch_key(s) for s in (TX_CHUNK, TX_REGION, TX_SMALL)}
    res["most_launched"] = {}
    for name in KERNEL_NAMES:
        top = sorted(((n, sh) for (k, sh), n in count.items() if k == name),
                     reverse=True)[:len(timed)]
        res["most_launched"][name] = [[list(sh), n] for n, sh in top]
        if {sh for _, sh in top} != timed:
            raise AssertionError(f"transcriptome: {name} launched most at "
                                 f"{top}, phase kernels timed {timed}")
    _emit("transcriptome", card, **res)
    return runs


def phase_imports(card: str) -> None:
    """The run imported neither jax nor any module of the JAX package."""
    bad = sorted(m for m in sys.modules
                 if m in ("jax", "jaxlib", "longcallr_tpu")
                 or m.startswith(("jax.", "jaxlib.", "longcallr_tpu.")))
    if bad:
        raise AssertionError(f"imported: {bad[:8]}")
    _emit("imports", card, jax=False, longcallr_tpu=False)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from longcallr_tpu_torch import _build, native
    from longcallr_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda")
    card = _card()
    t0 = time.monotonic()
    _build.load()
    t1 = time.monotonic()
    if not native.available():
        raise AssertionError("native/decode.cpp did not build")
    _emit("build", card, nvcc_seconds=t1 - t0,
          gxx_seconds=time.monotonic() - t1)
    stats = phase_kernels(card, dev)
    phase_tables(card, dev)
    with tempfile.TemporaryDirectory() as tmp:
        phase_goldens(card, dev, tmp)
        bam, fa, out, per_region, n_reads = phase_deep(card, tmp)
        notes = {}
        runs = phase_batched(card, tmp, bam, fa, out, n_reads, notes)
        phase_split_vs_f64(card, tmp, bam, fa,
                           out.vcf_path[:-len(".vcf")])
        stream_runs, stream_input = phase_stream(card, tmp, notes)
        runs.update(stream_runs)
        runs.update(phase_graphs(card, dev, tmp, (bam, fa), stream_input))
        runs.update(phase_transcriptome(card, dev, tmp))
        runs.update(phase_pod(card, tmp, stream_input))
        runs.update(phase_mesh(card, dev, tmp, (bam, fa), stream_input,
                               notes))
        phase_resume(card, tmp)
        phase_placement(card, dev, tmp)
        phase_analysis(card, dev, tmp)
        phase_pod_resident(card, tmp)
        phase_giant(card, dev, tmp, stream_input)
        runs["stats"] = phase_stats(card, dev, (bam, fa))
        phase_profile(card, tmp)
    draws_launched_at = _draws_at_launched_shapes(dev)
    phase_imports(card)
    runs["per_region"] = per_region
    replaces = {
        "dual_matvec_rows": "longcallr_tpu/phasing/pallas_kernels.py:190",
        "matvec_cols": "longcallr_tpu/phasing/pallas_kernels.py:230",
    }
    keep = lambda d: {f: d[f] for f in d if f.endswith("ms")
                      or f.startswith(("bound", "share", "warm", "path",
                                       "vs_library", "vs_strip"))}
    shape_of = {label: list(_launch_key(shape))
                for shape, label in TIMED.items()}
    kernels = []
    for n in KERNEL_NAMES:
        # the default batched run of the deep input launches the bucket of
        # a default wave (two tables); as one wave, the deep bucket of four.
        # Every shape is (tables, K, I, members per table); a timed shape
        # names the runs that launched the kernel there.
        k = {"name": n, "route": "cuda",
             "source": "longcallr_tpu_torch/csrc/split_matvec.cu",
             "replaces": replaces[n], "launches": runs["batched"][0][n],
             "max_abs_err": stats[n]["max_abs_err"],
             "device_ms_by": DEVICE_TIMER["by"],
             "shape": shape_of["deep_wave"]}
        k.update(keep(stats[n]["deep_wave"]))
        for run, (count, _) in runs.items():
            if run != "batched":
                k[f"launches_{run}"] = count[n]
        k["shapes"] = {
            label: dict(shape=shape_of[label],
                        launched_by=[run for run, (_, at) in runs.items()
                                     if shape_of[label] in at[n]],
                        **keep(stats[n][label]))
            for label in TIMED.values()}
        kernels.append(k)
    # the round draws: the default batched run of the deep input launches
    # them once a wave of two regions; timed at the JAX package's 129
    # rounds, checked also at every shape the runs launched
    d = stats["round_draws"]
    k = {"name": "round_draws", "route": "cuda",
         "source": "longcallr_tpu_torch/csrc/round_draws.cu",
         "replaces": "longcallr_tpu/parallel/mesh.py:224",
         "launches": DRAW_RUNS["deep_batched"]["launches"],
         "max_abs_err": max(r["max_abs_err"] for r in d.values()),
         "device_ms_by": DEVICE_TIMER["by"],
         "shape": list(DRAW_SHAPES["deep_wave"])}
    k.update({f: v for f, v in d["deep_wave"].items()
              if f.endswith("ms") or f.startswith(("bound", "share"))})
    k.update({f"launches_{run}": r["launches"] for run, r in DRAW_RUNS.items()
              if run != "deep_batched"})
    k["shapes"] = d
    k["checked_at_launched_shapes"] = draws_launched_at
    kernels.append(k)
    # the set-condition kernel of the device programs' WHILE nodes: its
    # launches on the default batched deep run; its time is the kernel's
    # own where torch.profiler traced it, else a loop turn's
    sc = stats["set_condition"]
    traced = sc["kernel_ms_traced"] is not None
    k = {"name": "set_condition", "route": "cuda",
         "source": "longcallr_tpu_torch/csrc/graph_program.cu",
         "replaces": "longcallr_tpu/phasing/optimize.py:232",
         "launches": PROGRAM_RUNS["deep_batched"]["condition_sets"],
         "max_abs_err": sc["max_abs_err"],
         "ms": sc["kernel_ms_traced"] if traced else sc["ms"],
         "ms_by": "torch.profiler, the kernel" if traced else
         "CUDA events, a loop turn", "turn_ms": sc["ms"],
         "plain_ms": sc["plain_ms"], "bound_ms": sc["bound_ms"],
         "bound_by": sc["bound_by"], "library_ms": None}
    k.update({f"launches_{run}": r["condition_sets"]
              for run, r in PROGRAM_RUNS.items() if run != "deep_batched"})
    kernels.append(k)
    # the exchange of the reads-sharded ascent: its launches on the giant
    # locus through [card] x 2 with programs (the barrier turns of the
    # region's ascents), its time at a trip's widths
    ex = EXCHANGE
    k = {"name": "shard_exchange", "route": "cuda",
         "source": "longcallr_tpu_torch/csrc/shard_exchange.cu",
         "replaces": "longcallr_tpu/parallel/mesh.py:554",
         "launches": GIANT_RUNS["card_x2"]["exchange_launches"],
         "max_abs_err": ex["max_abs_err"], "ms": ex["ms"],
         "ms_by": ex["ms_by"], "plain_ms": ex["plain_ms"],
         "bound_ms": ex["bound_ms"], "bound_by": ex["bound_by"],
         "library_ms": None, "shards_timed": ex["shards_timed"],
         "width_timed": ex["width_timed"], "checked": ex["checked"]}
    k.update({f"launches_{run}": r["exchange_launches"]
              for run, r in GIANT_RUNS.items() if run != "card_x2"})
    kernels.append(k)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
