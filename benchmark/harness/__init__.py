"""The benchmark's own code: finding a cell's files by name, the weights
and inputs made from the seed, the yardstick (peaks, operations and
bytes from the shapes), the profiler's reduction and the check that
decides ``correct``. Nothing here imports the program at module level.
"""
