"""pairs.edit_candidates_s: seconds a job spends generating the edit
route's candidate pairs on the host (``ops/bucket.edit_candidate_pairs``,
the program's ``pairs.candidates`` span), while the key matrix goes to
the card; the mean over the window's jobs.  Nothing where no job took
the edit route."""

from benchmark import program_spans


def read(trace):
    return program_spans.mean_job_seconds(trace, "pairs.candidates")
