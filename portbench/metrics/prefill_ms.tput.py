"""Host ms of a wave's prefill (the scheduler's ``_prefill``, synchronised),
mean over the window of a throughput cell."""
from portbench.readers import host_ms


def read(run):
    return host_ms(run, "pb.prefill")
