"""glu_roofline.route: the expert GLU's bound per call (workcounts, from
the routes' kept (token, expert) pairs) over its device time per call
(the trace's time of csrc/expert_glu.cu's kernels over the launches
counted), in percent."""
from chipbench.metrics_common import roofline


def read(rec: dict):
    return roofline(rec, "expert_glu")
