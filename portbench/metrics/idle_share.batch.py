"""The share of the traced window in which no kernel, copy or memset ran
on the card, in percent."""
from portbench.lib import readout


def read(run):
    return readout.idle_percent(run)
