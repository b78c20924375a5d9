"""pairs.edit_verify_s: seconds a job spends verifying the edit route's
candidate pairs (the program's ``pairs.edit_verify`` span: the host's
join of the key matrix's upload thread, then kernel 4's batches of index pairs and
their results); the mean over the window's jobs.  Nothing where no job
took the edit route."""

from benchmark import program_spans


def read(trace):
    return program_spans.mean_job_seconds(trace, "pairs.edit_verify")
