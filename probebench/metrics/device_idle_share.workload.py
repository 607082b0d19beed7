"""device_idle_share.workload: % of the traced rounds' wall with the cards
idle, the mean over the round's four cards.

Read as ``device_idle_share.emitter`` reads it, one formula in that file,
over the window's rounds of the four-card workload cell.
"""

from probebench.core import load_reader

read = load_reader("device_idle_share.emitter")
