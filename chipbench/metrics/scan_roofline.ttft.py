"""scan_roofline.ttft: the SSD scan's bound per call (workcounts, from
its shapes) over its device time per call (the trace's time of
csrc/ssd_scan.cu's kernels over the launches counted), in percent."""
from chipbench.metrics_common import roofline


def read(rec: dict):
    return roofline(rec, "ssd_scan")
