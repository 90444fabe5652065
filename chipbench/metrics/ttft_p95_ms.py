"""ttft_p95_ms: the 95th percentile, over every request of the window,
of the time from its batch's dispatch to its first token on the host."""
import numpy as np


def read(rec: dict):
    t = rec["window"]["ttft_s"]
    return 1e3 * float(np.percentile(t, 95)) if t else None
