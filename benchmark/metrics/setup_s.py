"""setup_s: process start to the first timed episode (host clock): the
imports, the build, the warm stages, the saved state and the episode run
outside the window that captures and builds what the episodes use."""


def read(run):
    return run["setup_s"]
