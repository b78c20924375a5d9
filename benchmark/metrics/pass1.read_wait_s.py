"""pass1.read_wait_s: seconds a job's main thread waits in pass 1 for the
next chunk from the readers (the program's ``pass1.read`` spans); the
mean over the window's jobs."""

from benchmark import program_spans


def read(trace):
    return program_spans.mean_job_seconds(trace, "pass1.read")
