"""setup_s: process start to the first timed request (imports, kernel
load or build, corpus, engine build and upload, warm-up)."""


def read(run):
    return run.setup_s
