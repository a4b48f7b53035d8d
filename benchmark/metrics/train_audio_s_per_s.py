"""``train_audio_s_per_s``: seconds of real (unpadded) audio of every update
the window completed, over the window's wall seconds (host clock, the device
waited for at the end)."""


def read(ctx):
    if not ctx.window or ctx.window_s <= 0:
        return None
    return sum(s.audio_s for s in ctx.window) / ctx.window_s
