"""replay_copy_mb.tpot: megabytes a traced decode step copies into its
captured graph's static inputs and clones out of its static outputs
(the port's capture.copy_in_bytes and capture.clone_bytes counters)."""
from chipbench.port_spans import replay_copy_mb


def read(rec: dict):
    return replay_copy_mb(rec, "engine.decode_step")
