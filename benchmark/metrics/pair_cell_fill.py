"""pair_cell_fill: the share of pair clustering's (K, K) support cells that
are not padding, over a pass: 100 x the sum of n_c^2 over the barcodes (n_c
a barcode's k-mers) / the B * K * K cells of the batches (the program's
counters ``cluster.pair_real_cells`` and ``cluster.pair_cells`` in
``cluster/cooccur.py``, ``Engine.stats``), over the window's passes."""

from benchmark.readers import stat_mean


def read(ctx):
    real = stat_mean(ctx, "cluster.pair_real_cells")
    cells = stat_mean(ctx, "cluster.pair_cells")
    if real is None or not cells:
        return None
    return 100.0 * real / cells
