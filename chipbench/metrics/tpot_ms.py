"""tpot_ms: all the window's decode time (each batch's steps, the argmax
and the host's loop, from its first token on the host to its last) over
all its decode steps."""


def read(rec: dict):
    w = rec["window"]
    return 1e3 * w["decode_s"] / w["decode_steps"] if w["decode_steps"] \
        else None
