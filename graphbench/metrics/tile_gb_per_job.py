"""GB of pair tiles staged a completed job over the window:
tile_pair_loads x Vb^2 x 4 B over the jobs done (the paper's sharing
claim: one staging serves every job with work on the block)."""


def read(rec):
    if not rec["jobs_done"]:
        return None
    return (rec["tile_pair_loads"] * rec["vb"] ** 2 * 4 / 1e9
            / rec["jobs_done"])
