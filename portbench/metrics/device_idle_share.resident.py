"""Percent of the traced window with no kernel and no copy on the card;
here the gaps are the step's host dispatch."""

from . import idle_share


def read(ctx):
    return idle_share(ctx)
