"""pass1_s: seconds a job spends in pass 1 (ingest, quality filter, key
counting), from the job's start to its call of ``build_partition_groups``;
the mean over the window's jobs."""


def read(trace):
    jobs = trace.job_layers()
    if not jobs:
        return None
    return sum(j["pass1"][1] - j["pass1"][0] for j in jobs) / len(jobs) / 1e9
