"""Percent of its roofline that ``tcg_step`` (``tcg_step_kernel<.., false>``,
the split variant) reached in the traced window."""

import pb_roofline


def read(run):
    return pb_roofline.tcg_share(run, dense=False) if run.trace else None
