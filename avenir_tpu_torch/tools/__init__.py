"""Command-line tools of the port: `kernel_check` and `knn_sweep`."""
