"""Audio seconds of the requests finished inside the window over the
window: reads the offered rate below the knee."""


def read(res):
    return res.readings.get("served_audio_s_per_s")
