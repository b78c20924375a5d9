"""banded_within_edit_distance_roofline: percent of its bound that the
edit-distance kernel (kernel 4) reaches in the window: the problem's
bytes of every launch (each distinct key once at 2 bits a base and its
length in 1 byte, one result byte a pair; ``benchmark/roofline.py``)
over 3.35 TB/s, against the kernel's summed device time.  Nothing where
it did not run."""

from benchmark import roofline


def read(trace):
    return roofline.window_share(trace, "banded_within_edit_distance")
