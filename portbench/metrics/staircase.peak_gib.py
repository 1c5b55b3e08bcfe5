"""The solve's own device memory in GiB: the largest, over the traced
solutions and their ranks, of the card's peak allocation at the end of the
rank's trust region or certificate (``peak_bytes``, ``cert_peak_bytes``)
less what was allocated as the solve started (``mem_base_bytes``)."""

import pb_spans


def read(run):
    peaks = [max(st.get("peak_bytes", 0), st.get("cert_peak_bytes", 0))
             - st["mem_base_bytes"]
             for st in pb_spans.stage_counters(run, "mem_base_bytes")]
    return max(peaks) / 2**30 if peaks else None
