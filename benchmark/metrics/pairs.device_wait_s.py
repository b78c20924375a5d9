"""pairs.device_wait_s: seconds a job's pair generation holds the host
on the card: the program's ``device.wait`` spans (an event or device
synchronize) that lie inside its ``pairs`` span; the mean over the
window's jobs.  Nothing where no such wait was recorded."""

from benchmark import program_spans


def read(trace):
    jobs = program_spans.per_job(trace)
    if not jobs:
        return None
    waited, found = 0, False
    for job in jobs:
        pairs = [(s.start, s.end) for s in job if s.name == "pairs"]
        for s in job:
            if s.name == "device.wait" and any(
                    lo <= s.start and s.end <= hi for lo, hi in pairs):
                waited += s.end - s.start
                found = True
    return waited / len(jobs) / 1e9 if found else None
