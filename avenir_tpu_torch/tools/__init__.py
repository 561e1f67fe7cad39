"""Command-line tools of the port: `kernel_check`, `knn_sweep`, `bench` and
`knn_ab`."""
