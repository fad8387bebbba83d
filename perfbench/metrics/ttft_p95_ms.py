"""95th percentile of the time to first token over every request submitted
in the window (one still waiting at the close counts its wait so far)."""
import numpy as np


def read(m):
    t = m.rec["ttft_s"]
    return float(np.percentile(t, 95)) * 1e3 if t else None
