"""Device operations per hybrid tick (kernels, copies and sets): the sum
of the profiled slice's counts by name over its ticks.  Read from the device
trace, so a CUDA graph's replayed kernels count too."""


def read(run):
    sl = run.slice
    if sl is None or not sl.ticks or not sl.ops:
        return None
    return sum(n for _, n in sl.ops.values()) / sl.ticks
