"""decode_kernels: device kernels in the traced window over the decode
steps it holds (copies and sets not counted)."""


def read(rec: dict):
    tr = rec["trace"]
    if not tr.get("decode_steps"):
        return None
    return tr["n_kernels"] / tr["decode_steps"]
