"""``setup_s``: seconds from the process's start to the end of set-up (the
program's objects, the seed's weights, every shape's warm-up), host clock."""


def read(run):
    return run.setup_s
