"""The benchmark's own machinery: finding a cell's files, making its inputs
and traffic, counting work, reading the profiler and judging a run."""
