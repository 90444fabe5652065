"""execute_host_share.route: the share of the traced routes'
orchestrator.execute spans outside their capture.graph spans (the
graph's launch), in percent: the port's own host work in a route."""
from chipbench.port_spans import host_share


def read(rec: dict):
    return host_share(rec, "orchestrator.execute")
