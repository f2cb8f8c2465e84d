"""setup_s: from the start of the run's process to the end of the warm-up
job (loading, input generation, weights, kernel builds and loads)."""


def read(rec):
    return rec["setup_s"]
