"""pass3_s: seconds a job spends in the pass-3 writer
(``_write_from_record_store`` or ``_filter_and_write``); the mean over
the window's jobs."""


def read(trace):
    jobs = trace.job_layers()
    if not jobs:
        return None
    return sum(j["pass3"][1] - j["pass3"][0] for j in jobs) / len(jobs) / 1e9
