"""setup_s: seconds from the start of the run's process (before torch is
imported) to the opening of the measured window: import, kernel build or
load, weights, warm-up, and for serving the filling of every slot."""


def read(record):
    return record["setup_s"]
