"""decode_mfu: the traced decode steps' operations (workcounts) over the
traced window times the peak of the model's dtype, in percent."""
from chipbench import workcounts


def read(rec: dict):
    tr = rec["trace"]
    if not tr.get("decode_steps"):
        return None
    peak = workcounts.peak_ops(rec["config"]["dtype"])
    return 100.0 * tr["work"]["ops"] / (tr["window_s"] * peak)
