"""hash10x-tpu-torch: the PyTorch + CUDA port of ``hash10x_tpu``.

The same sketch-and-cluster engine for 10x linked reads (seqhash
sketching, the k-mer x barcode count table, the count band, the incidence,
friend, capped-friend and pair clustering, split, report and the crib truth
evaluation), written as eager torch code on an explicit device, with the
sketch and friend clustering's label propagation as hand-written CUDA
kernels (``csrc/minimizer.cu``, ``csrc/union_find.cu``).  It never imports
JAX; the JAX package is the reference the tests hold it against.

Key convention: canonical hashes are below 2^(2k) <= 2^62, so keys are int64
tensors with ``INT64_MAX`` as the pad (torch's uint64 lacks ``>>``, ``<`` and
``searchsorted``).  Host files and the JAX package use U64MAX; ``convert.py``
maps between the two.
"""

from .hashspec import HashSpec, U64MAX

INT64_MAX = (1 << 63) - 1

__version__ = "0.1.0"
__all__ = ["HashSpec", "U64MAX", "INT64_MAX"]
