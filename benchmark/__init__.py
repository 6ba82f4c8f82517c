"""The benchmark of ``hash10x_tpu_torch``: lanes of 10x linked reads turned
into molecules on one CUDA card.  ``python3 -m benchmark.run --help``."""
