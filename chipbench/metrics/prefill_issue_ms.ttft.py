"""prefill_issue_ms.ttft: the traced prefills' mean model.prefill span,
in ms: the host's time to issue a prefill, set against its dispatch to
first token."""
from chipbench.port_spans import seconds, window


def read(rec: dict):
    units = window(rec, "model.prefill")
    if not units:
        return None
    return 1e3 * sum(seconds(u) for u in units) / len(units)
