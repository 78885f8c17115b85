"""audio_s_per_s (audio_s/s, host clock): seconds of audio transcribed
in the window over the window's wall seconds (an offline job's cost)."""


def read(rec):
    if not rec.get("audio_s"):
        return None
    return rec["audio_s"] / rec["window_s"]
