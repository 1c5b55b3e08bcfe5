"""Percent of its roofline that ``sorted_segment_sum`` (``segsum_csr`` and
``segsum_long``) reached in the traced window."""

import pb_roofline


def read(run):
    return pb_roofline.segsum_share(run) if run.trace else None
