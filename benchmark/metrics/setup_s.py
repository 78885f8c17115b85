"""setup_s (s, host clock): from the process's start to the first timed
request: imports, CUDA, weights, the program's build and warm-up."""


def read(rec):
    return rec["setup_s"]
