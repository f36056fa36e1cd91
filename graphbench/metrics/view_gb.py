"""GB one graph view holds on the card after set-up: the session's bytes
(`graph_bytes`, device memory allocated across set-up: the views' tiles
and job slots) over its views, the number that sets the largest graph
one card holds."""


def read(rec):
    if not rec["graph_bytes"] or not rec["semirings"]:
        return None
    return rec["graph_bytes"] / len(rec["semirings"]) / 1e9
