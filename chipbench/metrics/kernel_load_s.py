"""kernel_load_s: seconds of set-up spent building the port's CUDA
kernels (a checkout's first run) or loading them from its build
directory (every later run), by the host clock around the load."""


def read(rec: dict):
    return rec["spans"].get("kernels_s")
