"""Host ms a completed job spends in the session's lifecycle calls:
submit, detach and the poll's unconverged_counts, over the measured
window, in which no profiler runs."""


def read(rec):
    sp = rec["spans"]
    if not rec["jobs_done"]:
        return None
    tot = sum(sp.get(k, [0.0, 0])[0] for k in ("submit", "detach", "poll"))
    return 1e3 * tot / rec["jobs_done"]
