"""route_mfu: the traced routes' operations (workcounts, float32) over
the traced window times the TF32 peak, in percent."""
from chipbench import workcounts


def read(rec: dict):
    tr = rec["trace"]
    ops = tr["work"].get("ops", 0)
    if not ops:
        return None
    return 100.0 * ops / (tr["window_s"] * workcounts.PEAK_TF32)
