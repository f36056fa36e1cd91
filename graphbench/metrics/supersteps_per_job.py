"""Mean supersteps a job of the window was pushed in before its poll
found it converged (the session's per-job iteration counts)."""


def read(rec):
    xs = rec["job_supersteps"]
    return sum(xs) / len(xs) if xs else None
