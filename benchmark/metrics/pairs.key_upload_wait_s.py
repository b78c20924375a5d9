"""pairs.key_upload_wait_s: seconds of a job's edit verification spent
in the host's join of the upload thread, which enqueued the key matrix's
copy during candidate generation (the program's ``pairs.key_upload_wait``
span, inside ``pairs.edit_verify``); the mean over the window's jobs.
A part of the copy still in flight on the card is paid later, inside the
first verification batch's device wait.  Nothing where the program has
no such span or no job took the edit route on the card."""

from benchmark import program_spans


def read(trace):
    return program_spans.mean_job_seconds(trace, "pairs.key_upload_wait")
