"""step_host_share.tpot: the share of the traced decode steps'
engine.decode_step spans outside their capture.graph spans (the graph's
launch), in percent: the engine's own host work in a step."""
from chipbench.port_spans import host_share


def read(rec: dict):
    return host_share(rec, "engine.decode_step")
