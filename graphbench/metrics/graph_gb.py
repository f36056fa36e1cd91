"""GB the session holds after set-up: the views' tiles, their pair
tiles and the job slots (device memory allocated across set-up)."""


def read(rec):
    return rec["graph_bytes"] / 1e9 if rec["graph_bytes"] else None
