"""capped_cell_fill: the share of capped-friend clustering's (K, F)
membership cells that are not padding, over a pass: 100 x the sum of
n_c * f_c over the barcodes (n_c a barcode's k-mers, f_c the friends in
its row) / the B * K * F cells of the batches (the program's counters
``cluster.capped_real_cells`` and ``cluster.capped_cells`` in
``cluster/cooccur.py``, ``Engine.stats``), over the window's passes."""

from benchmark.readers import stat_mean


def read(ctx):
    real = stat_mean(ctx, "cluster.capped_real_cells")
    cells = stat_mean(ctx, "cluster.capped_cells")
    if real is None or not cells:
        return None
    return 100.0 * real / cells
