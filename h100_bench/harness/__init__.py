"""What every cell shares: finding a cell's files, seeds, weights and
index rows, the traffic generator, the table of peaks and the work
arithmetic, the host spans and the reduction of the device trace, and the
comparison that decides ``correct``."""
