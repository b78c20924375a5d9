"""dissect_s: seconds a job spends between the return of
``build_partition_groups`` and the call of the pass-3 writer (clustering
and dissection, pass 2's loop); the mean over the window's jobs."""


def read(trace):
    jobs = trace.job_layers()
    if not jobs:
        return None
    return sum(j["dissect"][1] - j["dissect"][0]
               for j in jobs) / len(jobs) / 1e9
