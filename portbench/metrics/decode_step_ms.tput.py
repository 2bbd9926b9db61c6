"""Host ms of one decode step (the scheduler's ``_decode``, synchronised),
mean over the window of a throughput cell."""
from portbench.readers import host_ms


def read(run):
    return host_ms(run, "pb.decode")
