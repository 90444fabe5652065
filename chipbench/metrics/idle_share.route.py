"""The share of the traced window in which no operation ran on the
device, in percent."""
from chipbench.metrics_common import idle_share


def read(rec: dict):
    return idle_share(rec)
