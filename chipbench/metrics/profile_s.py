"""profile_s: seconds of MeasuredProfiler.profile in set-up (every op on
every lane), by the host clock around the call."""


def read(rec: dict):
    return rec["spans"].get("profile_s")
