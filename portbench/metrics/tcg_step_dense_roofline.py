"""Percent of its roofline that ``tcg_step_dense``
(``tcg_step_kernel<.., true>``, the product inside) reached in the traced
window."""

import pb_roofline


def read(run):
    return pb_roofline.tcg_share(run, dense=True) if run.trace else None
