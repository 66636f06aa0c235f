"""Real-time beams the card sustains from blocks already in its memory:
stream seconds of the window's blocks per wall second."""

from . import realtime


def read(ctx):
    return realtime(ctx)
