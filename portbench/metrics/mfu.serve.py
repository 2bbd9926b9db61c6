"""Model FLOPs of the requests served in the window (real prompt tokens and
generated tokens, no padding) over the traced window, as a share of the
H100's bf16 peak, in %."""
from portbench.readers import mfu_pct


def read(run):
    return mfu_pct(run)
