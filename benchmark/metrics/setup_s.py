"""``setup_s``: seconds from the process's start to the window's start
(generation, the simulated API server and its mirror, the planner, the
kernels' load or build, the warm-up calls)."""


def read(run, name):
    return run.setup_s
