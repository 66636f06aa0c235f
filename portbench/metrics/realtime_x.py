"""Real-time beams the card sustains through the host path: stream seconds
of the window's blocks, summed over beams, per wall second."""

from . import realtime


def read(ctx):
    return realtime(ctx)
