"""``setup_s``: seconds from the process's start to the window's start:
imports, the kernels' build or load, the weight draw, the boot prewarm and
the traffic before the window. Host clock."""


def read(run):
    return run.setup_s
