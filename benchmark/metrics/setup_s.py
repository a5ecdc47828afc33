"""Process start to the window's first measured record, seconds."""


def read(job):
    return job.setup_s
