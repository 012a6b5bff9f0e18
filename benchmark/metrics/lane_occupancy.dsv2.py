"""Rows the window's requests generated over the engine's steps times its
lanes (ContinuousBatcher.stats), as a percentage."""


def read(res):
    return res.readings.get("lane_occupancy")
