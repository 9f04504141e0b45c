"""setup_s: seconds from the process's start to the window's: imports,
inputs made from the seed, the program's state, kernel builds where a
checkout has none yet, and the warm-up (host clock)."""


def read(run):
    return run.setup_s
