"""frames_roofline.bulk: the frames kernel's share of its roofline, %: the
larger of its bytes over the card's memory rate and its integer operations
over the card's int32 rate (counts frozen in counts/, peaks in peaks.json),
over its mean device time a launch in the traced window."""
from aecm_bench import trace as T


def read(run):
    return T.frames_roofline(run)
