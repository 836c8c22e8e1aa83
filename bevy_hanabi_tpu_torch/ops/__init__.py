"""PCG random numbers, compaction and exact small-matrix math."""
