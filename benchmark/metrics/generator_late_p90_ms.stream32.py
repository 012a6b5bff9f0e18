"""The 90th percentile of how late the generator submitted a request after
it was due (it submits from the engine's callbacks, between bursts)."""


def read(res):
    return res.readings.get("generator_late_p90_ms")
