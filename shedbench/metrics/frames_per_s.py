"""frames_per_s: every frame decided in the window over the window's
host-clock seconds (a closed loop, so this is the card's capacity)."""


def read(rec):
    return rec.window.frames / rec.window.window_s
