"""pairs_s: seconds a job spends in ``engine.build_partition_groups``
(candidate pairs, their verification on the host or the card, labels);
the mean over the window's jobs."""


def read(trace):
    jobs = trace.job_layers()
    if not jobs:
        return None
    return sum(j["pairs"][1] - j["pairs"][0] for j in jobs) / len(jobs) / 1e9
