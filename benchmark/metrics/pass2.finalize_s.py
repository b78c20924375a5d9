"""pass2.finalize_s: seconds a job spends turning pass 1's key
accumulator into the key tables (export, grouping by length, releases;
the program's ``pass2.finalize`` span); the mean over the window's
jobs.  ``pass1_s`` holds this time too."""

from benchmark import program_spans


def read(trace):
    return program_spans.mean_job_seconds(trace, "pass2.finalize")
