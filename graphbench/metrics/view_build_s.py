"""Seconds of set-up's view-building submits (the host builds each
view's block-ELL tiles and moves them to the device)."""


def read(rec):
    return rec["view_build_s"]
