"""Process start to the window's start: CUDA, the corpus, the build,
the warm-up (and, in a checkout's first run, the kernels' build)."""


def read(run):
    return run.setup_s
