"""Copied from ``longcallr_tpu/io/__init__.py``: the torch port
imports nothing of that package and keeps its own copy of what it needs.
The code is unchanged.
"""

from . import bam, bgzf, fasta  # noqa: F401
