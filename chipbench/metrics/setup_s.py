"""setup_s: seconds from the process's start to the measured window:
imports, weights, building and loading kernels, profiling and planning,
compiling and warming every shape the traffic uses."""


def read(rec: dict):
    return rec["setup_s"]
