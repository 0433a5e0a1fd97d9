"""The general part of the benchmark: finding a cell's pieces by name,
the cache directories, the dataset, host spans, the profiler's window and
its reduction, and the result line."""
