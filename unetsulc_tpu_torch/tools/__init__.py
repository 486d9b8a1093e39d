"""Command-line tools of the port: the matrix-unit probe."""
