"""K1's share of its roofline in the traced stretch: the least time of
every K1 launch (its bytes over the HBM peak, ``portbench/bytes.py``)
over their device time, in %."""

from portbench.bytes import roofline_percent


def read(record):
    return roofline_percent(record, pair=False)
