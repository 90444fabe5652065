"""route_ms: the window over the plan executions completed in it, input
staging and the wait for each included."""


def read(rec: dict):
    w = rec["window"]
    return 1e3 * w["seconds"] / w["units"] if w["units"] else None
