"""setup_s: seconds from the start of the run to the start of the window
(imports, the plan, the warm-up, and in a checkout's first run the
build of the kernels), by the host's clock."""


def read(rec):
    return rec["setup_s"]
