"""pass3.writer_wait_s: seconds a job's pass 3 waits on its writer thread:
a full output queue, and the drain of the queue and the compressors at
its end (the program's ``pass3.writer_wait`` spans); the mean over the
window's jobs."""

from benchmark import program_spans


def read(trace):
    return program_spans.mean_job_seconds(trace, "pass3.writer_wait")
