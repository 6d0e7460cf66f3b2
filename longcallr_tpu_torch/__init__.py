"""longcallR-TPU on PyTorch + CUDA.

The calling and phasing paths of ``longcallr_tpu`` that one card runs (BAM →
regions → pileup → candidates → fragments → phasing → assignment → VCF +
phased BAM; resident per region or in batched waves, or streamed contig by
contig; with region checkpoints) with the device stages in PyTorch and the
phasing ascent's two emission-matrix contractions as hand-written CUDA
kernels for Hopper (``csrc/split_matvec.cu``), and the ASE/ASJ tools
(``analysis/``).

The package stands alone: it imports ``torch``, never ``jax`` and nothing of
``longcallr_tpu``. The host modules it needs (config, BAM/FASTA/VCF I/O,
native decoders, region discovery, pileup, annotation, somatic, resume,
intervals, stats, the workload generators) are its own copies, each naming
its source. Every
device stage runs on the ``torch.device`` it is given; there is no ambient
default device.
"""

__version__ = "0.1.0"
