"""prefill_mfu: the traced prefills' operations (workcounts) over their
time (each from dispatch to first token on the host) times the peak of
the model's dtype, in percent."""
from chipbench import workcounts


def read(rec: dict):
    tr = rec["trace"]
    if not tr.get("prefills"):
        return None
    B, T = rec["traffic"]["batch"], rec["traffic"]["prompt_len"]
    ops = tr["prefills"] * workcounts.zamba2_prefill_ops(rec["config"], B, T)
    peak = workcounts.peak_ops(rec["config"]["dtype"])
    return 100.0 * ops / (sum(tr["prefill_s"]) * peak)
