"""replay_copy_mb.route: megabytes a traced route copies into its
captured graphs' static inputs and clones out of their static outputs
(the port's capture.copy_in_bytes and capture.clone_bytes counters)."""
from chipbench.port_spans import replay_copy_mb


def read(rec: dict):
    return replay_copy_mb(rec, "orchestrator.execute")
