"""The benchmark's general machinery: finding a cell's files by name,
running its window, reducing the profiler's trace, and the yardstick of
peaks and least times.  Nothing here names a configuration, a traffic mix
or a metric: those are files of their own, found from ``BENCHMARK.json``.
"""
