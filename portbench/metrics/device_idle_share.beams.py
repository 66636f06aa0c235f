"""Percent of the traced window with no kernel and no copy on the card."""

from . import idle_share


def read(ctx):
    return idle_share(ctx)
