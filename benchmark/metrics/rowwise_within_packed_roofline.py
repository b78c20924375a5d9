"""rowwise_within_packed_roofline: percent of its bound that the pair-list
kernel (kernel 3) reaches in the window: the problem's bytes of every
launch (each distinct key once at 2 bits a base, one result byte a
pair; ``benchmark/roofline.py``) over 3.35 TB/s, against the kernel's
summed device time.  Nothing where it did not run."""

from benchmark import roofline


def read(trace):
    return roofline.window_share(trace, "rowwise_within_packed")
