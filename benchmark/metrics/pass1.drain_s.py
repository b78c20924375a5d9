"""pass1.drain_s: seconds a job waits, after pass 1's last chunk, for the
quality, accumulate and render workers to finish their backlog (the
program's ``pass1.drain`` span); the mean over the window's jobs."""

from benchmark import program_spans


def read(trace):
    return program_spans.mean_job_seconds(trace, "pass1.drain")
