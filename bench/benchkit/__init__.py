"""The yardstick of the port's benchmark: weights and traffic from the
seed, the cell drivers, the arithmetic of FLOPs, bytes and peaks, the
reduction of traces and spans, and the comparison that decides
``correct``.  It reaches the program only through ``port`` and the
drivers."""
