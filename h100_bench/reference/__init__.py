"""The plain references of the benchmark's cells and the comparison that
decides `correct`."""
